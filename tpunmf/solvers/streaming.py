"""Out-of-core MUR: factorize matrices larger than device memory.

The reference holds all of V as one resident ndarray — its scaling story
is "buy more RAM" (SURVEY §5 'Long-context').  This solver streams V
through the device as dense panels (host CSR -> native panelizer ->
device), keeping only W, H, one panel, and k x k Grams resident:

  per iteration (Euclidean):
    G_h = H H^T                         (device, k x k)
    numer_W = sum_j X[:, j] @ H[:, j]^T (streamed panel pass 1)
    W <- W * numer_W / (W G_h + lw*W + eps)
    numer_H = W^T X                     (streamed panel pass 2)
    G_w = W^T W
    H <- H * numer_H / (G_w H + lh*H + eps)
    obj = 0.5*(||X||^2 - 2<H, numer_H> + tr(G_w (H H^T)))   (free)

  KL needs the panel-wise ratio against W@H: two streamed numerator
  passes plus a full-grid objective pass (all-zero panels still
  contribute sum(wh) to the KL objective, so they can only be skipped in
  the numerator passes, where x = 0 -> ratio = 0 exactly).

Zero-padding of ragged edge tiles is exact: padded W rows / H columns are
zero, so padded wh is zero and every padded KL cell is 0*log(0/0) -> NaN
-> masked (same masking as nmf/utils.py:23-26), contributing nothing.

Convergence semantics are identical to the in-core solvers
(reference nmf/utils.py:4-15 via core.convergence).  The host drives the
panel schedule; per-panel device work is jitted, and the PanelStream's
double buffering lets densification overlap device compute.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.convergence import convergence_check
from ..core.types import MurExperiment, Results
from ..data.sparse_panels import PanelStream
from ..init import random_init

_EPS = 1e-9


@partial(jax.jit, donate_argnums=(0,))
def _acc_xht(acc, x_panel, h_panel):
    return acc + x_panel @ h_panel.T


@partial(jax.jit, donate_argnums=(0,))
def _acc_wtx(acc, w_block, x_panel):
    return acc + w_block.T @ x_panel


@partial(jax.jit, donate_argnums=(0,))
def _acc_kl_rht(acc, x_panel, w_block, h_panel):
    """acc += (x/(wh+eps)) @ h^T — W-update numerator contribution."""
    r = x_panel / (w_block @ h_panel + _EPS)
    return acc + r @ h_panel.T


@partial(jax.jit, donate_argnums=(0,))
def _acc_kl_wtr(acc, x_panel, w_block, h_panel):
    """acc += w^T (x/(wh+eps)) — H-update numerator contribution."""
    r = x_panel / (w_block @ h_panel + _EPS)
    return acc + w_block.T @ r


@partial(jax.jit, donate_argnums=(0,))
def _acc_kl_obj(obj, x_panel, w_block, h_panel):
    """Masked KL objective contribution of one tile (nmf/utils.py:21-26)."""
    wh = w_block @ h_panel
    val = x_panel * jnp.log(x_panel / wh)
    val = jnp.where(val == jnp.inf, 0.0, val)
    val = jnp.where(jnp.isnan(val), 0.0, val)
    return obj + jnp.sum(val - x_panel + wh)


@jax.jit
def _mur_w_update_eu(w, numer, gram_h, lambda_w):
    return w * numer / (w @ gram_h + lambda_w * w + _EPS)


@jax.jit
def _mur_h_update_eu(h, numer, gram_w, lambda_h):
    return h * numer / (gram_w @ h + lambda_h * h + _EPS)


@jax.jit
def _mur_w_update_kl(w, numer, h, lambda_w):
    b = jnp.sum(h, axis=1)[None, :]
    a = w * numer
    return 2.0 * a / (b + jnp.sqrt(b * b + 4.0 * lambda_w * a))


@jax.jit
def _mur_h_update_kl(h, numer, w, lambda_h):
    d = jnp.sum(w, axis=0)[:, None]
    c = h * numer
    return 2.0 * c / (d + jnp.sqrt(d * d + 4.0 * lambda_h * c))


class _Panels:
    """Panel access with zero-padded factor blocks and nnz-based skipping."""

    def __init__(self, x_sparse, row_block, col_panel, skip_empty,
                 transfer_dtype=None):
        self.stream = PanelStream(x_sparse, row_block=row_block,
                                  col_panel=col_panel)
        self.m, self.n = self.stream.m, self.stream.n
        self.rb, self.cb = self.stream.grid
        self.row_block, self.col_panel = self.stream.row_block, self.stream.col_panel
        self.transfer_bf16 = transfer_dtype == jnp.bfloat16
        self.nonempty = {
            (i, j)
            for i in range(self.rb)
            for j in range(self.cb)
            if not skip_empty or self.stream.panel_nnz(i, j) > 0
        }

    def host_panel(self, i, j):
        # fresh host array per panel: device transfers can be asynchronous
        # and zero-copy on the CPU backend, so a reused buffer would let
        # the next densify clobber an in-flight panel (observed as flaky
        # trajectory divergence)
        if self.transfer_bf16:
            # transfer compression: bf16 panels halve host->device bytes
            # on the transfer-bound path; device math accumulates f32
            return self.stream.panel_bf16(i, j)
        return self.stream.panel(i, j)

    def pipelined(self, sched):
        """Yield (i, j, device_panel) over ``sched`` with one panel of
        lookahead: the next tile's densify + device_put are issued while
        the device still runs the current tile's (async-dispatched)
        accumulate — compute/transfer overlap with NO worker thread (a
        thread-based prefetch contends with XLA's host threads)."""
        if not sched:
            return
        pending = jax.device_put(self.host_panel(*sched[0]))
        for t, (i, j) in enumerate(sched):
            cur = pending
            if t + 1 < len(sched):
                pending = jax.device_put(self.host_panel(*sched[t + 1]))
            yield i, j, cur

    def rows(self, i):
        return min(self.row_block, self.m - i * self.row_block)

    def cols(self, j):
        return min(self.col_panel, self.n - j * self.col_panel)

    # factors are padded ONCE per pass (pad_w/pad_h), then per-tile access
    # is a cheap slice — not a full-matrix re-pad per tile

    def pad_w(self, w):
        return jnp.pad(w, ((0, self.rb * self.row_block - self.m), (0, 0)))

    def pad_h(self, h):
        return jnp.pad(h, ((0, 0), (0, self.cb * self.col_panel - self.n)))

    def w_block(self, w_padded, i):
        return jax.lax.dynamic_slice_in_dim(
            w_padded, i * self.row_block, self.row_block, axis=0
        )

    def h_panel(self, h_padded, j):
        return jax.lax.dynamic_slice_in_dim(
            h_padded, j * self.col_panel, self.col_panel, axis=1
        )


def mur_streaming(
    x_sparse,
    k: int,
    *,
    distance_type: str = "eu",
    min_iter: int = 10,
    max_iter: int = 200,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    row_block: int = 4096,
    col_panel: int = 4096,
    key=None,
    w_init=None,
    h_init=None,
    dtype=jnp.float32,
    skip_empty_panels: bool = True,
    transfer_dtype=None,
    verbose: bool = False,
) -> Results:
    """MUR on a scipy sparse matrix streamed through the device in panels.

    Same update mathematics and convergence semantics as ``mur``; designed
    for V beyond device HBM (only W, H, one panel, and k x k Grams are
    resident on device).  Panels are densified in float32 by the host
    panelizer regardless of ``dtype`` (which governs factors/accumulators);
    ``transfer_dtype=jnp.bfloat16`` densifies straight to bf16 in the
    native panelizer, halving host->device bytes on the transfer-bound
    path (device accumulation stays in ``dtype``; the recorded objective
    is then the objective of the bf16-rounded data).
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if transfer_dtype not in (None, jnp.float32, jnp.bfloat16):
        raise ValueError("transfer_dtype must be None/float32/bfloat16")

    p = _Panels(x_sparse, row_block, col_panel, skip_empty_panels,
                transfer_dtype=transfer_dtype)
    m, n = p.m, p.n

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None and h_init is not None:
        w = jnp.asarray(w_init, dtype=dtype)
        h = jnp.asarray(h_init, dtype=dtype)
    else:
        w, h = random_init(
            key if key is not None else jax.random.PRNGKey(0),
            m, n, k, kind="abs_normal", dtype=dtype,
        )

    experiment = MurExperiment(
        method="mur", components=k, distance_type=distance_type,
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=lambda_w, lambda_h=lambda_h,
    )

    # from the deduplicated CSR (COO duplicate coordinates sum there).
    # With bf16 transfer the matrix the device actually fits is the
    # bf16-ROUNDED data, so ||X||^2 must use the rounded values too —
    # otherwise the objective mixes iterates of two different matrices
    # (a constant offset that perturbs the absolute tol2 stop test)
    if transfer_dtype == jnp.bfloat16:
        import ml_dtypes

        rounded = np.asarray(p.stream.csr.data, dtype=np.float32).astype(
            ml_dtypes.bfloat16).astype(np.float64)
        xsq = float(np.sum(rounded ** 2))
    else:
        xsq = float(np.sum(
            np.asarray(p.stream.csr.data, dtype=np.float64) ** 2))

    def streamed_xht(h, kl_with_w=None):
        """sum_j X_panel @ h_panel^T per row block (EU), or the KL ratio
        version when ``kl_with_w`` is the current W.  One pipelined pass
        over the nonempty tiles (transfer overlaps compute)."""
        hp = p.pad_h(h)
        wp = None if kl_with_w is None else p.pad_w(kl_with_w)
        accs = [jnp.zeros((p.row_block, k), dtype=dtype) for _ in range(p.rb)]
        sched = [(i, j) for i in range(p.rb) for j in range(p.cb)
                 if (i, j) in p.nonempty]
        for i, j, xpan in p.pipelined(sched):
            if wp is None:
                accs[i] = _acc_xht(accs[i], xpan, p.h_panel(hp, j))
            else:
                accs[i] = _acc_kl_rht(accs[i], xpan, p.w_block(wp, i),
                                      p.h_panel(hp, j))
        return jnp.concatenate(
            [acc[: p.rows(i)] for i, acc in enumerate(accs)], axis=0)

    def streamed_wtx(w, kl_with_h=None):
        wp = p.pad_w(w)
        hp = None if kl_with_h is None else p.pad_h(kl_with_h)
        accs = [jnp.zeros((k, p.col_panel), dtype=dtype) for _ in range(p.cb)]
        sched = [(i, j) for j in range(p.cb) for i in range(p.rb)
                 if (i, j) in p.nonempty]
        for i, j, xpan in p.pipelined(sched):
            if hp is None:
                accs[j] = _acc_wtx(accs[j], p.w_block(wp, i), xpan)
            else:
                accs[j] = _acc_kl_wtr(accs[j], xpan, p.w_block(wp, i),
                                      p.h_panel(hp, j))
        return jnp.concatenate(
            [acc[:, : p.cols(j)] for j, acc in enumerate(accs)], axis=1)

    def kl_objective(w, h):
        """Masked KL objective.

        Only nonempty tiles need their data: an all-zero tile contributes
        exactly ``sum(wh_tile) = <colsum(W_block), rowsum(H_panel)>``
        (the x*log and -x terms vanish, and the reference's masking zeroes
        the 0*log(0) cells — nmf/utils.py:23-26), so empty panels cost two
        k-vector dot products instead of a dense pass.
        """
        obj = jnp.zeros((), dtype=dtype)
        wp, hp = p.pad_w(w), p.pad_h(h)
        w_colsums = [jnp.sum(p.w_block(wp, i), axis=0) for i in range(p.rb)]
        h_rowsums = [jnp.sum(p.h_panel(hp, j), axis=1) for j in range(p.cb)]
        sched = [(i, j) for i in range(p.rb) for j in range(p.cb)
                 if (i, j) in p.nonempty]
        for i, j, xpan in p.pipelined(sched):
            obj = _acc_kl_obj(obj, xpan, p.w_block(wp, i), p.h_panel(hp, j))
        for i in range(p.rb):
            for j in range(p.cb):
                if (i, j) not in p.nonempty:
                    obj = obj + jnp.dot(w_colsums[i], h_rowsums[j])
        return float(obj)

    def eu_objective(wtx, gram_w, h):
        cross = jnp.vdot(h, wtx)
        quad = jnp.vdot(gram_w, h @ h.T)
        return float(0.5 * (xsq - 2.0 * cross + quad))

    if distance_type == "eu":
        obj_history = [eu_objective(streamed_wtx(w), w.T @ w, h)]
    else:
        obj_history = [kl_objective(w, h)]

    i = 0
    for i in range(max_iter):
        if distance_type == "eu":
            gram_h = h @ h.T
            w = _mur_w_update_eu(w, streamed_xht(h), gram_h, lambda_w)
            numer_h = streamed_wtx(w)
            gram_w = w.T @ w
            h = _mur_h_update_eu(h, numer_h, gram_w, lambda_h)
            obj_history.append(eu_objective(numer_h, gram_w, h))
        else:
            w = _mur_w_update_kl(w, streamed_xht(h, kl_with_w=w), h, lambda_w)
            h = _mur_h_update_kl(h, streamed_wtx(w, kl_with_h=h), w, lambda_h)
            obj_history.append(kl_objective(w, h))

        if verbose:
            print(f"[{i}]: {obj_history[-1]}")
        if i > min_iter and convergence_check(
            obj_history[-1], obj_history[-2], tol1, tol2
        ):
            break

    return Results(
        w=np.asarray(w), h=np.asarray(h), i=i, obj_history=obj_history,
        experiment=experiment,
    )
