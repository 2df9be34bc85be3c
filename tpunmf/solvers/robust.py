"""Robust NMF — the l2,1-norm objective (outlier-resistant columns).

Beyond-reference capability: minimizes the *un-squared* sum of column
residual norms

    obj = sum_j || x_j - W h_j ||_2     (the l2,1 norm of X - WH),

so a corrupted column contributes linearly instead of quadratically and
cannot dominate the fit — the robust analog of Euclidean NMF (Kong, Ding
& Huang, CIKM 2011).  Multiplicative updates with per-column weights
``d_j = 1 / ||x_j - W h_j||``:

    H <- H * (W^T X D) / (W^T W H D),   W <- W * (X D H^T) / (W H D H^T),

which are exactly the Lee-Seung rules on the column-reweighted problem;
the paper proves monotone non-increase of the l2,1 objective under the
alternating scheme.

Device mapping: D is diagonal over columns, so ``X D`` / ``H D`` are
elementwise row-broadcast scalings fused into the surrounding GEMMs by
XLA.  The residual column norms never materialize ``W @ H``:

    ||x_j - W h_j||^2 = ||x_j||^2 - 2 h_j.(W^T x_j) + h_j.(W^T W) h_j,

using the (k, n) cross-product and k x k Gram the updates already need —
per-iteration cost is the same ~3 m*n*k GEMM passes as plain MUR.
Driver semantics (convergence, history, checkpointing) are shared with
every other solver via solvers/common.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from .common import LoopCarry, finalize_history, init_carry, run_loop, while_block

_EPS = 1e-9


def _column_residual_norms(xsq_cols, wtx, gram_w, h):
    """(n,) residual norms ||x_j - W h_j|| without forming W @ H."""
    quad = jnp.sum(h * (gram_w @ h), axis=0)
    cross = jnp.sum(h * wtx, axis=0)
    sq = jnp.maximum(xsq_cols - 2.0 * cross + quad, 0.0)
    return jnp.sqrt(sq)


@partial(jax.jit, static_argnames=("min_iter", "max_iter", "verbose"))
def _robust_block(x, xsq_cols, carry: LoopCarry, stop_i, tol1, tol2, *,
                  min_iter: int, max_iter: int, verbose: bool):
    def step(inner, i):
        w, h = inner
        # weights from the CURRENT iterate's residuals
        gram_w = w.T @ w
        wtx = w.T @ x
        d = 1.0 / (_column_residual_norms(xsq_cols, wtx, gram_w, h) + _EPS)

        # H update on the reweighted problem (D broadcasts over columns)
        h = h * (wtx * d[None, :]) / (gram_w @ (h * d[None, :]) + _EPS)

        # W update with the fresh H (Gauss-Seidel like reference MUR,
        # nmf/mur.py:122-124)
        hd = h * d[None, :]
        w = w * (x @ hd.T) / (w @ (h @ hd.T) + _EPS)

        gram_w = w.T @ w
        wtx = w.T @ x
        obj = jnp.sum(_column_residual_norms(xsq_cols, wtx, gram_w, h))
        return (w, h), obj

    return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                       max_iter=max_iter, verbose=verbose)


def robust_nmf(
    x,
    k: int,
    *,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    nndsvd_init: tuple = (True, "zero"),
    w_init=None,
    h_init=None,
    key=None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """l2,1-norm robust NMF (Kong-Ding-Huang multiplicative updates).

    Same call/result conventions as :func:`tpunmf.solvers.mur`; the
    objective history records the l2,1 norm (sum of column residual
    norms), not the squared Frobenius norm.
    """
    x = jnp.asarray(x)
    if bool(jnp.any(x < 0)):
        raise ValueError("x must be non-negative")
    m, n = x.shape

    if w_init is not None or h_init is not None:
        if w_init is None or h_init is None:
            raise ValueError("provide both w_init and h_init or neither")
        w = jnp.asarray(w_init, dtype=x.dtype)
        h = jnp.asarray(h_init, dtype=x.dtype)
    elif nndsvd_init[0]:
        w, h = nndsvd(x, k, variant=nndsvd_init[1])
        # multiplicative updates cannot leave zero cells: nudge exact
        # zeros like the beta solver does for its NNDSVD inits
        w = jnp.maximum(w, 1e-6)
        h = jnp.maximum(h, 1e-6)
    else:
        kk = key if key is not None else jax.random.PRNGKey(42)
        w, h = random_init(kk, m, n, k, dtype=x.dtype)

    experiment = MurExperiment(
        method="robust", components=k, distance_type="l21",
        nndsvd_init=tuple(nndsvd_init), max_iter=max_iter, tol1=tol1,
        tol2=tol2, lambda_w=0.0, lambda_h=0.0,
    )

    xsq_cols = jnp.sum(x * x, axis=0)
    obj0 = jnp.sum(
        _column_residual_norms(xsq_cols, w.T @ x, w.T @ w, h))
    carry = init_carry(obj0, max_iter, (w, h))
    run = lambda c, stop: _robust_block(
        x, xsq_cols, c, stop, tol1, tol2, min_iter=min_iter,
        max_iter=max_iter, verbose=verbose,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + "|robust",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=np.asarray(w), h=np.asarray(h), i=i,
                   obj_history=obj_history, experiment=experiment)
