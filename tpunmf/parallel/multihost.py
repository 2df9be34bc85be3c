"""Multi-host bring-up and host-sharded data ingestion.

The reference is strictly single-process (SURVEY §2C); this is the
multi-host layer per BASELINE config[4] (1M x 100k on N>=2
hosts): ``jax.distributed`` initialization, a global mesh spanning all
hosts, and per-host ingestion where each host materializes only its own
column panel of V before assembling the global sharded array.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import build_mesh


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Bring up the jax.distributed runtime (no-op when single-process).

    Must run before any other JAX call (anything that touches devices —
    even ``jax.process_count()`` — initializes the XLA backend and makes
    distributed bring-up impossible, so no such probe happens here).
    Where no cluster environment announces them, pass them explicitly
    (e.g. ``coordinator_address='localhost:<port>'``).  Calling twice is
    tolerated.
    """
    if coordinator_address is None and num_processes in (None, 1):
        return  # single-process run: nothing to do
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" in str(e).lower():
            return  # idempotent: someone initialized earlier
        raise


def assert_collective_consistency(value, *, rtol: float = 0.0) -> None:
    """Assert every host computed the same (replicated) scalar.

    The multi-host analog of a race detector for this workload (SURVEY §5):
    any divergence in collective results or nondeterministic reduction
    shows up as hosts disagreeing on the global objective.  No-op guard on
    single-process runs.
    """
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    gathered = np.asarray(multihost_utils.process_allgather(
        jax.numpy.asarray(value)))
    ref = gathered.reshape(jax.process_count(), -1)[0]
    for p in range(1, jax.process_count()):
        other = gathered.reshape(jax.process_count(), -1)[p]
        if not np.allclose(ref, other, rtol=rtol, atol=0.0):
            raise AssertionError(
                f"host 0 and host {p} disagree on collective value: "
                f"{ref} vs {other}"
            )


def global_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("rows", "cols")) -> Mesh:
    """Mesh over ALL devices across hosts (jax.devices() is global)."""
    return build_mesh(shape=shape, axis_names=axis_names, devices=jax.devices())


def host_local_column_range(mesh: Mesh, n: int) -> tuple[int, int]:
    """The [start, stop) slice of the item axis this host's devices own.

    With H/V column-sharded over 'cols', each host only ever needs its own
    column panel of the data — the ingestion side of cross-host sharding.
    """
    if "cols" not in mesh.axis_names:
        return 0, n
    n_shards = mesh.shape["cols"]
    if n % n_shards:
        raise ValueError(f"n={n} not divisible by cols={n_shards}")
    shard = n // n_shards
    cols_axis = list(mesh.axis_names).index("cols")
    local_ids = sorted(
        {
            int(np.argwhere(np.asarray(mesh.devices) == d).ravel()[cols_axis])
            for d in mesh.local_devices
        }
    )
    return local_ids[0] * shard, (local_ids[-1] + 1) * shard


def assemble_global_columns(mesh: Mesh, local_block: np.ndarray, n: int):
    """Build a globally column-sharded array from per-host column panels.

    Each process passes only the columns in its ``host_local_column_range``;
    the result is a global jax.Array sharded P(None, 'cols') that no single
    host ever fully materializes.
    """
    sharding = NamedSharding(mesh, P(None, "cols"))
    m = local_block.shape[0]
    global_shape = (m, n)
    start, stop = host_local_column_range(mesh, n)
    if local_block.shape[1] != stop - start:
        raise ValueError(
            f"local block has {local_block.shape[1]} cols, host range is "
            f"[{start}, {stop})"
        )
    shard = n // mesh.shape["cols"]

    def cb(index):
        col_slice = index[1]
        lo = 0 if col_slice.start is None else col_slice.start
        return local_block[:, lo - start : (lo - start) + shard]

    return jax.make_array_from_callback(global_shape, sharding, cb)
