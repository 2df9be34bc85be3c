"""Orthogonal NMF — one factor constrained to (near-)orthogonal rows.

Beyond-reference capability: minimizes ``0.5 ||X - W H||_F^2`` with
``H H^T = I, H >= 0`` (or symmetrically ``W^T W = I``) via the
multiplicative updates of Ding, Li, Peng & Park, "Orthogonal nonnegative
matrix tri-factorizations for clustering" (SIGKDD 2006, §3):

    W <- W * (X H^T) / (W (H H^T))                (unconstrained half)
    H <- H * sqrt( (W^T X) / ((W^T X H^T) H) )    (orthogonal half)

An orthogonal nonnegative H has at most one positive entry per column,
so ONMF is a soft k-means on the columns of X — the clustering member
of the NMF family.  The orthogonal-W variant is the row-clustering
mirror (applied by transposition).

Design notes: the denominator is grouped as ``((W^T X) H^T) H`` — two
k x k-bounded GEMMs instead of the n x n Gram the textbook ordering
implies; everything else is the same GEMM traffic as one EU-MUR
iteration.  ``obj_history`` records the EU objective; the orthogonality
residual ``||H H^T - diag(H H^T)||_F`` is returned separately since the
Ding updates trade reconstruction for orthogonality (the EU objective
alone is NOT monotone for ONMF).
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


def orthogonality_residual(h) -> jnp.ndarray:
    """||H H^T - diag(H H^T)||_F / ||H H^T||_F (0 = exactly orthogonal)."""
    g = h @ h.T
    off = g - jnp.diag(jnp.diag(g))
    return jnp.linalg.norm(off) / (jnp.linalg.norm(g) + _EPS)


@partial(
    jax.jit,
    static_argnames=("min_iter", "max_iter", "verbose"),
)
def _onmf_block(x, carry: LoopCarry, stop_i, tol1, tol2, *,
                min_iter: int, max_iter: int, verbose: bool):
    def step(inner, i):
        w, h = inner
        # unconstrained W half (Lee-Seung EU)
        w = w * (x @ h.T) / (w @ (h @ h.T) + _EPS)
        # orthogonal H half (Ding et al. 2006 eq. 28, transposed frame)
        wtx = w.T @ x                                  # (k, n)
        denom = (wtx @ h.T) @ h + _EPS                 # k x k grouping
        h = h * jnp.sqrt(wtx / denom)
        d = x - w @ h
        return (w, h), 0.5 * jnp.sum(d * d)

    return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                       max_iter=max_iter, verbose=verbose)


def onmf(
    x,
    k: int,
    *,
    orthogonal: str = "h",
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    nndsvd_init=(False, "zero"),
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
    """Orthogonal NMF (Ding et al. 2006 multiplicative updates).

    Args:
      orthogonal: 'h' constrains H's rows (column clustering, default);
        'w' constrains W's columns (row clustering, via transposition).

    Returns a ``Results`` record; ``experiment.distance_type`` is tagged
    ``'eu-onmf'``.  Check :func:`orthogonality_residual` on the returned
    factor to monitor the constraint.
    """
    if orthogonal not in ("h", "w"):
        raise ValueError("orthogonal must be 'h' or 'w'")
    if orthogonal == "w":
        res = onmf(jnp.asarray(x).T, k, orthogonal="h", min_iter=min_iter,
                   max_iter=max_iter, tol1=tol1, tol2=tol2,
                   nndsvd_init=nndsvd_init, key=key,
                   w_init=None if h_init is None else jnp.asarray(h_init).T,
                   h_init=None if w_init is None else jnp.asarray(w_init).T,
                   verbose=verbose, block_size=block_size,
                   on_block_end=on_block_end,
                   checkpoint_path=checkpoint_path,
                   checkpoint_every=checkpoint_every, resume=resume)
        return Results(w=res.h.T, h=res.w.T, i=res.i,
                       obj_history=res.obj_history,
                       experiment=res.experiment)

    x = jnp.asarray(x)
    x = x + jnp.maximum(-jnp.min(x), jnp.asarray(0.0, dtype=x.dtype))

    experiment = MurExperiment(
        method="onmf", components=k, distance_type="eu-onmf",
        nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=0.0, lambda_h=0.0,
    )

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None:
        w = jnp.asarray(w_init, dtype=x.dtype)
        h = jnp.asarray(h_init, dtype=x.dtype)
    elif nndsvd_init[0]:
        w, h = nndsvd(x, k, variant=nndsvd_init[1], key=key)
        # the sqrt update freezes exact zeros; nudge generated inits
        w = jnp.maximum(w, 1e-6)
        h = jnp.maximum(h, 1e-6)
    else:
        w, h = random_init(
            key if key is not None else jax.random.PRNGKey(0),
            x.shape[0], x.shape[1], k, kind="abs_normal", dtype=x.dtype,
        )

    d0 = x - w @ h
    carry = init_carry(0.5 * jnp.sum(d0 * d0), max_iter, (w, h))
    run = lambda c, stop: _onmf_block(
        x, c, stop, tol1, tol2, min_iter=min_iter, max_iter=max_iter,
        verbose=verbose,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + "|onmf",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=np.asarray(w), h=np.asarray(h), i=i,
                   obj_history=obj_history, experiment=experiment)
