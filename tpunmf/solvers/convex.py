"""Convex NMF — basis vectors constrained to convex combinations of data.

Beyond-reference capability, after Ding, Li & Jordan, "Convex and
Semi-Nonnegative Matrix Factorizations" (TPAMI 2010, §IV): factorize
``X ~ (X W) G^T`` with ``W >= 0 (n x k)``, ``G >= 0 (n x k)`` — each
basis vector ``(X W)_l`` is a nonnegative combination of actual data
columns, which makes the factors directly interpretable as (soft)
cluster centroids, and X itself MAY BE MIXED-SIGN.

Multiplicative updates (their eqs. 26-27) on the Gram K = X^T X with the
positive/negative split ``K = K+ - K-``:

    G <- G * sqrt( (K+ W + G W^T K- W) / (K- W + G W^T K+ W) )
    W <- W * sqrt( (K+ G + K- W G^T G) / (K- G + K+ W G^T G) )

Both are monotone for the objective ``||X - X W G^T||_F^2`` (their
Thms 5-6).  Device mapping: everything runs on the (n, n) Gram — computed
once — so per-iteration cost is a handful of (n, k)-shaped GEMMs; the
m axis is touched only at the end to emit the basis ``X W``.  Dense
(n, n) K bounds practical n to ~20-40k columns (the regime convex NMF
is used in).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import MurExperiment, Results
from .common import LoopCarry, finalize_history, init_carry, run_loop, while_block

_EPS = 1e-9


def _convex_obj(trk, kp, km, w, g):
    """||X - X W G^T||^2 via the Gram: Tr K - 2 Tr(G^T K W) + ..."""
    k_mat = kp - km
    kw = k_mat @ w
    cross = jnp.vdot(g, kw)
    quad = jnp.vdot(w.T @ kw, g.T @ g)
    return trk - 2.0 * cross + quad


@partial(
    jax.jit,
    static_argnames=("min_iter", "max_iter", "verbose"),
)
def _convex_block(kp, km, trk, carry: LoopCarry, stop_i, tol1, tol2, *,
                  min_iter: int, max_iter: int, verbose: bool):
    def step(inner, i):
        w, g = inner
        kpw = kp @ w
        kmw = km @ w
        g = g * jnp.sqrt((kpw + g @ (w.T @ kmw) + _EPS)
                         / (kmw + g @ (w.T @ kpw) + _EPS))
        gtg = g.T @ g
        kpg = kp @ g
        kmg = km @ g
        w = w * jnp.sqrt((kpg + km @ (w @ gtg) + _EPS)
                         / (kmg + kp @ (w @ gtg) + _EPS))
        return (w, g), _convex_obj(trk, kp, km, w, g)

    return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                       max_iter=max_iter, verbose=verbose)


def convex_nmf(
    x,
    k: int,
    *,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    w_init=None,
    g_init=None,
    key=None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """Convex NMF (Ding-Li-Jordan 2010).  X may be mixed-sign.

    Returns ``Results`` with ``w = X @ W`` (the m x k data-convex basis)
    and ``h = G^T`` (k x n).  The raw (n, k) combination weights are not
    returned; recover them as needed from a custom run.
    """
    x = jnp.asarray(x)
    n = x.shape[1]
    if not 0 < k <= n:
        raise ValueError(f"need 0 < k <= n; got k={k}, n={n}")

    k_mat = x.T @ x
    kp = 0.5 * (jnp.abs(k_mat) + k_mat)
    km = 0.5 * (jnp.abs(k_mat) - k_mat)
    trk = jnp.trace(k_mat)

    experiment = MurExperiment(
        method="convex_nmf", components=k, distance_type="eu-convex",
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1,
        tol2=tol2, lambda_w=0.0, lambda_h=0.0,
    )

    if (w_init is None) != (g_init is None):
        raise ValueError("pass both w_init and g_init, or neither")
    if w_init is not None:
        w = jnp.asarray(w_init, dtype=x.dtype)
        g = jnp.asarray(g_init, dtype=x.dtype)
        if w.shape != (n, k) or g.shape != (n, k):
            raise ValueError(f"w_init/g_init must be ({n}, {k})")
    else:
        kk = key if key is not None else jax.random.PRNGKey(0)
        # paper §IV-C: cluster-indicator-like init smoothed by +0.2
        g = jnp.abs(jax.random.normal(kk, (n, k), dtype=x.dtype)) + 0.2
        # W starts as (column-normalized) G so X W begins at the G-weighted
        # column centroids (the paper's W0 = G0 D^-1)
        w = g / (jnp.sum(g, axis=0, keepdims=True) + _EPS)

    carry = init_carry(_convex_obj(trk, kp, km, w, g), max_iter, (w, g))
    run = lambda c, stop: _convex_block(
        kp, km, trk, c, stop, tol1, tol2, min_iter=min_iter,
        max_iter=max_iter, verbose=verbose,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + "|convex",
    )
    w, g = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=np.asarray(x @ w), h=np.asarray(g.T), i=i,
                   obj_history=obj_history, experiment=experiment)
