"""Sharded out-of-core MUR: the BASELINE config[4] shape
(recommender-scale V, H column-sharded across the mesh, V streamed).

Layout per the north star: H lives column-sharded P(None, 'cols') across
the mesh and never gathers; W is replicated; V is streamed from host CSR
in ROW BLOCKS, where each block is assembled directly as a column-sharded
global array via ``jax.make_array_from_callback`` — every device (and on
multi-host, every host) densifies ONLY its own column range of the block
through the native panelizer.  The per-iteration partial products
``X_block @ H^T`` and ``W_block^T @ X_block`` contract over the sharded
column axis, so XLA reduces them with psum over the device links, exactly as in the
in-core sharded path.

KL support mirrors the in-core KL-MUR: the ratio X/(WH+eps) is formed
per row block against the sharded H (elementwise on the sharded columns),
its products reduce the same way, and the masked KL objective accumulates
per block.

Euclidean per iteration — ONE streamed pass (each block densified once):
  G_h = H H^T                       (sharded Gram, psum)
  for each row block i:
      X_i       <- prefetched (next block densifies on a worker thread
                   while the device chews on this one)
      numer_i   =  X_i @ H^T        (psum over 'cols', replicated out)
      W_i       <- W_i * numer_i / (W_i G_h + lw W_i + eps)
                   (the MUR W-update is row-wise independent, so each
                   row block updates from its own numerator alone)
      WtX      +=  W_i^T X_i        (with the FRESH W_i; stays sharded)
  H <- mur update (sharded elementwise)
  obj via the Gram trick (free, exact reductions in f32)

This is iterate-for-iterate identical to the two-pass schedule (the
W-update consumes only block-local numerators; WtX uses the updated W
either way) at half the densify/transfer traffic.  KL needs the exact
objective's own pass (2 streams/iter) unless ``objective='lagged'``,
which folds the iteration-t objective into iteration t+1's ratio pass
(1 stream/iter, trajectory shifted by one iteration — the same opt-in
as the in-core fused KL solver).

Memory: device holds H shard (k x n/p), W (m x k, replicated), one
row-block shard (row_block x n/p) — V itself never resident.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.convergence import convergence_check
from ..core.types import MurExperiment, Results
from ..data.sparse_panels import PanelStream
from ..init import random_init

_EPS = 1e-9


# one canonical copy of the MUR update/accumulation math lives in
# streaming.py (and the Gram objective in core.losses) — reused here so
# the sharded solver cannot drift from the in-core semantics
from ..core.losses import eu_objective_gram as _eu_objective_gram
from .streaming import (
    _acc_kl_obj as _acc_block_kl_obj,
    _acc_kl_wtr as _acc_block_kl_wtr,
    _mur_h_update_eu as _h_update,
    _mur_h_update_kl as _h_update_kl,
    _mur_w_update_eu as _w_update,
    _mur_w_update_kl as _w_update_kl,
)


@jax.jit
def _gram_h(h):
    return h @ h.T


@jax.jit
def _block_xht(x_block, h):
    return x_block @ h.T  # contracts sharded cols -> psum, replicated out


@partial(jax.jit, donate_argnums=(0,))
def _acc_block_wtx(wtx, w_block, x_block):
    return wtx + w_block.T @ x_block  # stays column-sharded like wtx


@jax.jit
def _gram_obj(xsq, wtx, gram_w, h):
    return _eu_objective_gram(xsq, wtx, gram_w, h)


@jax.jit
def _block_kl_rht(x_block, w_block, h):
    """(x/(wh+eps)) @ h^T for one row block; psum over sharded cols."""
    r = x_block / (w_block @ h + _EPS)
    return r @ h.T


@jax.jit
def _block_kl_rht_obj(x_block, w_block, h):
    """KL ratio numerator AND the masked KL objective contribution of the
    incoming (w_block, h) — the wh tiles are already formed for the
    ratio, so the lagged objective costs nothing extra."""
    from ..core.losses import kl_elementwise_sum

    wh = w_block @ h
    r = x_block / (wh + _EPS)
    return r @ h.T, kl_elementwise_sum(x_block, wh)


def mur_streaming_sharded(
    x_sparse,
    k: int,
    mesh: Mesh,
    *,
    distance_type: str = "eu",
    min_iter: int = 10,
    max_iter: int = 200,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    row_block: int = 8192,
    key=None,
    w_init=None,
    h_init=None,
    dtype=jnp.float32,
    objective: str = "exact",
    prefetch: bool = False,
    transfer_dtype=None,
    verbose: bool = False,
) -> Results:
    """MUR (EU or KL) with column-sharded H and row-block-streamed V.

    Args:
      x_sparse: scipy sparse matrix (any format; duplicate COO entries are
        summed).  NOTE: panels are densified in float32 by the host
        panelizer regardless of ``dtype`` — ``dtype`` governs the factors
        and accumulators only.
      mesh: mesh with a 'cols' axis; n must divide by its size.
      objective: KL only — 'exact' evaluates KL(w, h) after each iteration
        (its own streamed pass); 'lagged' folds iteration t's objective
        into iteration t+1's ratio pass (1 streamed pass per iteration,
        obj_history/convergence shifted one iteration, as in mur()).
      prefetch: densify + stage block i+1 on a worker thread while the
        device processes block i.  Default OFF: measured SLOWER on the
        emulated-CPU mesh (the worker steals XLA host threads); on a GPU
        host not measured.  Worth enabling only where host densification
        is the genuine bottleneck.  Note the thread-free loop already
        overlaps: block dispatches are async, so block i+1's densify
        runs on the host while the device processes block i.
      transfer_dtype: ``jnp.bfloat16`` densifies blocks straight to bf16
        in the native panelizer (RNE), halving host->device bytes on the
        transfer-bound path.  Device accumulation stays in ``dtype``;
        objectives are then those of the bf16-rounded data.
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if "cols" not in mesh.axis_names:
        raise ValueError("mesh must have a 'cols' axis")
    m, n = x_sparse.shape
    n_shards = mesh.shape["cols"]
    if n % n_shards:
        raise ValueError(f"n={n} must divide the 'cols' mesh size {n_shards}")
    col_shard = n // n_shards

    h_sharding = NamedSharding(mesh, P(None, "cols"))
    x_sharding = NamedSharding(mesh, P(None, "cols"))
    replicated = NamedSharding(mesh, P())

    stream = PanelStream(x_sparse, row_block=row_block, col_panel=col_shard)
    row_block = stream.row_block  # PanelStream clamps to m; use its value
    rb = stream.grid[0]

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None:
        w = jax.device_put(jnp.asarray(w_init, dtype=dtype), replicated)
        h = jax.device_put(jnp.asarray(h_init, dtype=dtype), h_sharding)
    else:
        w0, h0 = random_init(
            key if key is not None else jax.random.PRNGKey(0),
            m, n, k, kind="abs_normal", dtype=dtype,
        )
        w = jax.device_put(w0, replicated)
        h = jax.device_put(h0, h_sharding)

    experiment = MurExperiment(
        method="mur", components=k, distance_type=distance_type,
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=lambda_w, lambda_h=lambda_h,
    )
    # xsq from the CSR the panels come from: duplicate COO coordinates are
    # summed there, so summing raw input data**2 would disagree.  With
    # bf16 transfer the fitted matrix is the bf16-ROUNDED data — ||X||^2
    # must match it (see solvers/streaming.py)
    if transfer_dtype == jnp.bfloat16:
        import ml_dtypes

        _rounded = np.asarray(stream.csr.data, dtype=np.float32).astype(
            ml_dtypes.bfloat16).astype(np.float64)
        xsq = float(np.sum(_rounded ** 2))
    else:
        xsq = float(np.sum(
            np.asarray(stream.csr.data, dtype=np.float64) ** 2))

    def x_block(i):
        """Row block i as a column-sharded global array; the callback runs
        once per addressable shard and densifies only that column range."""
        r0 = i * row_block
        rows = min(row_block, m - r0)

        def cb(index):
            col_sl = index[1]
            c0 = 0 if col_sl.start is None else col_sl.start
            j = c0 // col_shard
            if transfer_dtype == jnp.bfloat16:
                out = stream.panel_bf16(i, j)
            else:
                out = stream.panel(i, j)
            if rows < row_block:
                out = out.copy()  # panel() zero-pads already; keep explicit
            return out

        return jax.make_array_from_callback(
            (row_block, n), x_sharding, cb
        )

    def w_block_of(w, i):
        r0 = i * row_block
        rows = min(row_block, m - r0)
        wb = w[r0:r0 + rows]
        if rows < row_block:
            wb = jnp.pad(wb, ((0, row_block - rows), (0, 0)))
        return wb

    # --- block prefetch: densify + stage block i+1 on a worker thread
    # while the device processes block i (the panelizer's C loop releases
    # the GIL, so the overlap is real)
    import concurrent.futures as _cf

    pool = _cf.ThreadPoolExecutor(max_workers=1) if prefetch else None

    def blocks_prefetched():
        fut = pool.submit(x_block, 0) if pool else None
        for i in range(rb):
            xb = fut.result() if pool else x_block(i)
            if pool and i + 1 < rb:
                fut = pool.submit(x_block, i + 1)
            yield i, xb

    def fused_pass_eu(w, h):
        """ONE streamed pass: per-block W update + WtX accumulation.

        The EU W-update is row-wise independent (each W row consumes only
        its own numerator row), so each block's update completes before
        the next block loads — iterate-for-iterate identical to the
        two-pass schedule at half the stream traffic."""
        gram_h = _gram_h(h)
        wtx = jax.device_put(jnp.zeros((k, n), dtype=dtype), h_sharding)
        new_blocks = []
        for i, xb in blocks_prefetched():
            nb = _block_xht(xb, h)
            wb = _w_update(w_block_of(w, i), nb, gram_h, lambda_w)
            wtx = _acc_block_wtx(wtx, wb, xb)
            rows = min(row_block, m - i * row_block)
            new_blocks.append(wb[:rows])
        return jnp.concatenate(new_blocks, axis=0), wtx

    def fused_pass_kl(w, h, want_lagged_obj):
        """ONE streamed pass: per-block KL W update + W^T(ratio)
        accumulation (+ the incoming iterate's KL objective for free)."""
        wtr = jax.device_put(jnp.zeros((k, n), dtype=dtype), h_sharding)
        obj_in = jnp.zeros((), dtype=dtype)
        new_blocks = []
        for i, xb in blocks_prefetched():
            wb_old = w_block_of(w, i)
            if want_lagged_obj:
                nb, ob = _block_kl_rht_obj(xb, wb_old, h)
                obj_in = obj_in + ob
            else:
                nb = _block_kl_rht(xb, wb_old, h)
            wb = _w_update_kl(wb_old, nb, h, lambda_w)
            wtr = _acc_block_kl_wtr(wtr, xb, wb, h)
            rows = min(row_block, m - i * row_block)
            new_blocks.append(wb[:rows])
        return jnp.concatenate(new_blocks, axis=0), wtr, obj_in

    def kl_objective(w, h):
        obj = jnp.zeros((), dtype=dtype)
        for i, xb in blocks_prefetched():
            obj = _acc_block_kl_obj(obj, xb, w_block_of(w, i), h)
        return float(obj)

    try:
        if distance_type == "eu":
            # the Gram objective needs W^T X of the initial factors: one
            # streamed accumulation pass
            wtx0 = jax.device_put(jnp.zeros((k, n), dtype=dtype), h_sharding)
            for i, xb in blocks_prefetched():
                wtx0 = _acc_block_wtx(wtx0, w_block_of(w, i), xb)
            obj_history = [float(_gram_obj(xsq, wtx0, w.T @ w, h))]
        elif objective == "lagged":
            obj_history = []  # filled by each iteration's ratio pass
        else:
            obj_history = [kl_objective(w, h)]

        i = 0
        for i in range(max_iter):
            if distance_type == "eu":
                w, wtx = fused_pass_eu(w, h)
                gram_w = w.T @ w
                h = _h_update(h, wtx, gram_w, lambda_h)
                obj_history.append(float(_gram_obj(xsq, wtx, gram_w, h)))
            else:
                w, wtr, obj_in = fused_pass_kl(w, h, objective == "lagged")
                h = _h_update_kl(h, wtr, w, lambda_h)
                if objective == "lagged":
                    # obj_in is KL of the factors as of the END of the
                    # previous iteration — record it there
                    obj_history.append(float(obj_in))
                else:
                    obj_history.append(kl_objective(w, h))
            if verbose:
                print(f"[{i}]: {obj_history[-1]}")
            if i > min_iter and len(obj_history) >= 2 and convergence_check(
                obj_history[-1], obj_history[-2], tol1, tol2
            ):
                break
    finally:
        if pool:
            pool.shutdown(wait=True)

    if jax.process_count() > 1:
        # h spans non-addressable devices on multi-host runs
        from jax.experimental import multihost_utils

        h_np = np.asarray(multihost_utils.process_allgather(h, tiled=True))
    else:
        h_np = np.asarray(h)
    return Results(
        w=np.asarray(w), h=h_np, i=i, obj_history=obj_history,
        experiment=experiment,
    )
