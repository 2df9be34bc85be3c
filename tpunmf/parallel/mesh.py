"""Device-mesh construction and canonical sharding layouts.

The reference is single-process numpy with zero parallelism (SURVEY §2C);
everything here is new capability.  Canonical layout per the
north star (BASELINE.json): V and H sharded over the item/column axis, W
replicated (or row-sharded over a 'rows' data-parallel axis on 2-D
meshes); the per-iteration partial products ``X @ H^T`` / ``W^T @ X``
contract over the sharded axis, so XLA inserts psum/reduce-scatter
collectives over the device links automatically under GSPMD.

Axes:
  'rows' — data-parallel axis over V's row (user/sample) blocks;
  'cols' — tensor/sequence-parallel axis over V's column (item) blocks.
Rank ('expert'-style) sharding for very large k is a planned extension.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def build_mesh(shape: Optional[Sequence[int]] = None,
               axis_names: Sequence[str] = ("rows", "cols"),
               devices=None) -> Mesh:
    """Build a device mesh.

    Default: all local devices on a 2-D ('rows', 'cols') mesh with a
    near-square factorization (rows <= cols, power-of-two split).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        rows = 2 ** (int(math.log2(n)) // 2) if n & (n - 1) == 0 else 1
        shape = (rows, n // rows)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    dev_array = mesh_utils.create_device_mesh(shape, devices=devices)
    return Mesh(dev_array, axis_names=tuple(axis_names[: len(shape)]))


def nmf_shardings(mesh: Mesh):
    """Canonical NMF shardings for (V, W, H) on a mesh.

    V: P(rows, cols)  — both axes blocked;
    W: P(rows, None)  — row-sharded with V's rows, replicated over cols;
    H: P(None, cols)  — column-sharded with V's cols, replicated over rows.

    On a 1-D ('cols',) mesh this degrades to the north-star layout
    (V, H column-sharded; W fully replicated).
    """
    names = mesh.axis_names
    rows = "rows" if "rows" in names else None
    cols = "cols" if "cols" in names else None
    return dict(
        v=NamedSharding(mesh, P(rows, cols)),
        w=NamedSharding(mesh, P(rows, None)),
        h=NamedSharding(mesh, P(None, cols)),
        replicated=NamedSharding(mesh, P()),
    )


def rank_shardings(mesh: Mesh):
    """Rank-sharded ('expert-parallel' analog) layout for very large k.

    Each device owns a slice of the k components: W P(None, 'rank'),
    H P('rank', None); the reconstruction W @ H contracts over the sharded
    rank axis (psum), while V stays replicated or row-sharded.  Useful when
    k is large enough that replicating both factors everywhere wastes HBM
    (SURVEY §2C 'EP').  Requires a mesh with a 'rank' axis.
    """
    if "rank" not in mesh.axis_names:
        raise ValueError("rank_shardings needs a mesh with a 'rank' axis")
    rows = "rows" if "rows" in mesh.axis_names else None
    return dict(
        v=NamedSharding(mesh, P(rows, None)),
        w=NamedSharding(mesh, P(rows, "rank")),
        h=NamedSharding(mesh, P("rank", None)),
        replicated=NamedSharding(mesh, P()),
    )


def shard_problem(mesh: Mesh, v, w=None, h=None):
    """Place (v, w, h) on the mesh with the canonical layouts."""
    sh = nmf_shardings(mesh)
    v = jax.device_put(v, sh["v"])
    out = [v]
    if w is not None:
        out.append(jax.device_put(w, sh["w"]))
    if h is not None:
        out.append(jax.device_put(h, sh["h"]))
    return tuple(out) if len(out) > 1 else v
