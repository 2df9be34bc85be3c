"""Out-of-core sharded streaming throughput at a scaled config[4] shape.

Usage:
  python benchmarks/bench_streaming.py            # the default device
  python benchmarks/bench_streaming.py cpu8       # 8 emulated CPU devices
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if len(sys.argv) > 1 and sys.argv[1] == "cpu8":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") +
        " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import numpy as np
import scipy.sparse as sp

from tpunmf.parallel import build_mesh
from tpunmf.solvers.streaming_sharded import mur_streaming_sharded


def make_sparse(m, n, density, seed=0):
    rng = np.random.default_rng(seed)
    nnz = int(m * n * density)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.random(nnz).astype(np.float32) + 0.1
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()


def run(m=100_000, n=10_000, k=128, density=0.01, iters=5, row_block=16384,
        distance_type="eu", objective="exact", prefetch=True,
        transfer_dtype=None):
    import jax.numpy as jnp

    x = make_sparse(m, n, density)
    n_dev = len(jax.devices())
    mesh = build_mesh(shape=(n_dev,), axis_names=("cols",))
    kw = dict(distance_type=distance_type, row_block=row_block,
              tol1=0.0, tol2=0.0, prefetch=prefetch,
              transfer_dtype=transfer_dtype)
    if distance_type == "kl":
        kw["objective"] = objective

    # warm: compile all block kernels with 1 iteration
    t0 = time.perf_counter()
    mur_streaming_sharded(x, k, mesh, min_iter=0, max_iter=1, **kw)
    warm = time.perf_counter() - t0
    # timed
    t0 = time.perf_counter()
    res = mur_streaming_sharded(x, k, mesh, min_iter=iters, max_iter=iters, **kw)
    dt = time.perf_counter() - t0
    it_s = iters / dt
    gb_per_iter = m * n * 4 / 1e9 * (1 if distance_type == "eu" else
                                     (1 if objective == "lagged" else 2))
    tname = "bf16" if transfer_dtype is not None else "f32"
    print(f"{distance_type}/{objective} prefetch={prefetch} "
          f"transfer={tname}: "
          f"{it_s:.3f} it/s  ({dt/iters*1e3:.0f} ms/iter, warm-up {warm:.1f}s, "
          f"{gb_per_iter*it_s:.1f} GB/s effective dense-equivalent stream, "
          f"{n_dev} device(s), nnz={x.nnz})")
    assert np.all(np.isfinite(res.obj_history))


if __name__ == "__main__":
    # 20k x 10k keeps config[4]'s (100k x 10k) blocks-per-iteration
    # structure at ~1 GB/pass
    scale = 0.2
    if len(sys.argv) > 1 and sys.argv[1] == "cpu8":
        scale = 0.1  # smaller on emulated CPU
    import jax.numpy as _jnp

    m = int(100_000 * scale)
    run(m=m, iters=3, row_block=8192, distance_type="eu", prefetch=False)
    run(m=m, iters=3, row_block=8192, distance_type="eu", prefetch=False,
        transfer_dtype=_jnp.bfloat16)
    if len(sys.argv) > 1 and sys.argv[1] == "cpu8":
        run(m=m, iters=3, row_block=8192, distance_type="eu", prefetch=True)
    run(m=m, iters=3, row_block=8192, distance_type="kl", objective="lagged")
    run(m=m, iters=3, row_block=8192, distance_type="kl", objective="lagged",
        transfer_dtype=_jnp.bfloat16)
