"""Worker process for the two-process jax.distributed CPU test.

Launched by tests/test_multiprocess.py as
``python _distributed_worker.py <process_id> <num_processes> <port>``.
Each process owns 4 emulated CPU devices (8 global), initializes the
distributed runtime, and exercises the full multi-host surface:
initialize_multihost, global_mesh, host_local_column_range,
assemble_global_columns, mur_streaming_sharded (incl. its
process_allgather tail), and assert_collective_consistency.
"""
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "").replace(
        "--xla_force_host_platform_device_count=8", ""
    ).strip()
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, repo)

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from tpunmf.parallel import (  # noqa: E402
    assemble_global_columns,
    assert_collective_consistency,
    global_mesh,
    host_local_column_range,
    initialize_multihost,
)

initialize_multihost(
    coordinator_address=f"localhost:{port}", num_processes=nproc,
    process_id=pid,
)
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == 4 * nproc
assert len(jax.local_devices()) == 4

mesh = global_mesh(shape=(4 * nproc,), axis_names=("cols",))

m, n, k = 40, 96, 4
rng = np.random.default_rng(0)
dense = rng.random((m, n))
dense[dense < 0.5] = 0.0
w0 = np.random.default_rng(1).random((m, k)) + 0.1
h0 = np.random.default_rng(2).random((k, n)) + 0.1

# per-host ingestion: materialize only this host's column panel
start, stop = host_local_column_range(mesh, n)
expected_width = n // nproc
assert stop - start == expected_width, (start, stop)
local = np.ascontiguousarray(dense[:, start:stop])
xg = assemble_global_columns(mesh, local, n)
assert xg.shape == (m, n)
# every host's local shards hold exactly its own columns
col_shard = n // (4 * nproc)
for s in xg.addressable_shards:
    c0 = s.index[1].start or 0
    np.testing.assert_array_equal(
        np.asarray(s.data), dense[:, c0:c0 + col_shard]
    )

# the config[4] solver path end-to-end across processes
from tpunmf.solvers.streaming_sharded import mur_streaming_sharded  # noqa: E402

res = mur_streaming_sharded(
    sp.csr_matrix(dense), k, mesh, w_init=w0, h_init=h0, row_block=16,
    min_iter=2, max_iter=5, tol1=0.0, tol2=0.0, dtype=np.float64,
)
assert res.h.shape == (k, n)  # process_allgather tail re-assembled H

# multi-host race-detector analog: all hosts agree on the objective
assert_collective_consistency(res.obj_history[-1])

# also verify the consistency assert FAILS on divergent values
try:
    assert_collective_consistency(float(pid))
    raise SystemExit("assert_collective_consistency missed a divergence")
except AssertionError:
    pass

print(f"FINAL_OBJ {res.obj_history[-1]!r}")
print(f"RANGE {start} {stop}")

# ---- round-4: the mesh_2d schedule with the PROCESS boundary crossing
# the 'rows' axis (each process owns one mesh row of 4 devices — the
# cross-host layout of collective_model's weak-scaling scenarios)
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from tpunmf.parallel import nmf_shardings  # noqa: E402
from tpunmf.solvers import mur  # noqa: E402

mesh2 = global_mesh(shape=(nproc, 4), axis_names=("rows", "cols"))
row_procs = {
    d.process_index for d in np.asarray(mesh2.devices)[pid, :]
}
assert row_procs == {pid}, (
    f"process boundary must cross 'rows': row {pid} owned by {row_procs}")

xg2 = jax.make_array_from_callback(
    dense.shape, NamedSharding(mesh2, P("rows", "cols")),
    lambda idx: dense[idx])
res2 = mur(xg2, k, distance_type="eu", w_init=w0, h_init=h0,
           objective="gram", min_iter=2, max_iter=5, tol1=0.0, tol2=0.0)
assert_collective_consistency(res2.obj_history[-1])
print(f"MESH2D_OBJ {float(res2.obj_history[-1])!r}")

# cross-check the weak-scaling model's mesh_2d byte inventory against
# the collectives this 2-process mesh actually compiles
import importlib.util  # noqa: E402
import re  # noqa: E402

from tpunmf.parallel import gram_w, wtx_psum  # noqa: E402

spec = importlib.util.spec_from_file_location(
    "collective_model",
    os.path.join(repo, "benchmarks", "collective_model.py"))
cm = importlib.util.module_from_spec(spec)
sys.modules[spec.name] = cm
spec.loader.exec_module(cm)

wg = jax.make_array_from_callback(
    (m, k), NamedSharding(mesh2, P("rows", None)), lambda idx: w0[idx])
coll_re = re.compile(
    r"=\s*(?:\(?)(\w+)\[([\d,]*)\][^ ]*\s+(all-reduce)(?:-start)?\(")
got = []
for fn, args in ((lambda a, b: wtx_psum(mesh2, a, b), (wg, xg2)),
                 (lambda a: gram_w(mesh2, a), (wg,))):
    txt = jax.jit(fn).lower(*args).compile().as_text()
    for _, dims, _ in coll_re.findall(txt):
        got.append(int(np.prod([int(v) for v in dims.split(",") if v])))
plan = cm.schedule_collectives("mesh_2d", m, n, k, rows=nproc, cols=4,
                               elem=8)  # f64 run
want = sorted(int(c.operand_bytes // 8) for c in plan
              if c.kind == "psum" and c.fabric == "rows")
assert sorted(got) == want, (sorted(got), want)
print("MESH2D_BYTES_OK")

# ---- round-4: a non-MUR solver's Results tail across processes — the
# factors span non-addressable devices, so Results construction must go
# through host_array (np.asarray raised here before the round-4 fix)
from tpunmf.solvers import anls  # noqa: E402

res_a = anls(xg2, k, w_init=w0, h_init=h0, min_iter=2, max_iter=4,
             tol1=0.0, tol2=0.0)
assert isinstance(res_a.w, np.ndarray) and res_a.w.shape == (m, k)
assert isinstance(res_a.h, np.ndarray) and res_a.h.shape == (k, n)
assert_collective_consistency(res_a.obj_history[-1])
print(f"ANLS_OBJ {float(res_a.obj_history[-1])!r}")

# ---- round-4: sharded NTF across the process boundary
from tpunmf.parallel import ntf_sharded  # noqa: E402

rng3 = np.random.default_rng(7)
shape3 = (16, 12, 10)
kk3 = 3
f_init = [rng3.random((s, kk3)) + 0.1 for s in shape3]
x3 = np.einsum("ir,jr,kr->ijk", *f_init) + 0.01 * rng3.random(shape3)
res3 = ntf_sharded(mesh2, x3, kk3, axis="rows", distance_type="eu",
                   update="mur", min_iter=3, max_iter=6, tol1=0.0,
                   tol2=0.0, factors_init=f_init)
assert_collective_consistency(res3.obj_history[-1])
print(f"NTF_OBJ {float(res3.obj_history[-1])!r}")

print("WORKER_OK")
