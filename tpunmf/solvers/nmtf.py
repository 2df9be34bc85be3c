"""Nonnegative matrix tri-factorization (co-clustering).

Beyond-reference capability, after Ding, Li, Peng & Park (SIGKDD 2006,
§5): ``X ~ F S G^T`` with ``F (m x kr) >= 0``, ``S (kr x kc) >= 0``,
``G (n x kc) >= 0`` and F, G (approximately) column-orthogonal — the
bi-orthogonal tri-factorization that clusters ROWS (via F) and COLUMNS
(via G) simultaneously, with S the cluster-association core.

Multiplicative updates (their eqs. 31-33; each monotone for the
orthogonality-penalized objective):

    G <- G * sqrt( (X^T F S)   / (G G^T X^T F S) )
    F <- F * sqrt( (X G S^T)   / (F F^T X G S^T) )
    S <- S * sqrt( (F^T X G)   / (F^T F S G^T G) )

Device mapping: numerators are two m*n*k-class GEMMs per factor; the
orthogonality denominators are grouped k-first (``G (G^T N)`` etc.) so
nothing n x n or m x m is ever formed.
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


def _kmeans_indicator(xt, k, key, iters: int = 20):
    """(points, dims) -> smoothed (points, k) cluster-indicator matrix.

    Small Lloyd's k-means (k-means++-free: distinct random points as
    seeds) — the init Ding et al. 2006 §5 prescribe for the
    tri-factorization; the +0.2 smoothing is theirs."""
    npts = xt.shape[0]
    idx = jax.random.choice(key, npts, (k,), replace=False)
    centers = xt[idx]

    def step(t, centers):
        d2 = jnp.sum((xt[:, None, :] - centers[None, :, :]) ** 2, axis=2)
        assign = jnp.argmin(d2, axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=xt.dtype)   # (npts, k)
        counts = jnp.sum(onehot, axis=0)[:, None]
        sums = onehot.T @ xt
        return jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0),
                         centers)

    centers = jax.lax.fori_loop(0, iters, step, centers)
    d2 = jnp.sum((xt[:, None, :] - centers[None, :, :]) ** 2, axis=2)
    onehot = jax.nn.one_hot(jnp.argmin(d2, axis=1), k, dtype=xt.dtype)
    return onehot + 0.2


@partial(
    jax.jit,
    static_argnames=("min_iter", "max_iter", "verbose"),
)
def _nmtf_block(x, carry: LoopCarry, stop_i, tol1, tol2, *,
                min_iter: int, max_iter: int, verbose: bool):
    def step(inner, i):
        f, s, g = inner
        # G update (columns)
        n_g = x.T @ (f @ s)                             # (n, kc)
        g = g * jnp.sqrt(n_g / (g @ (g.T @ n_g) + _EPS))
        # F update (rows)
        n_f = x @ (g @ s.T)                             # (m, kr)
        f = f * jnp.sqrt(n_f / (f @ (f.T @ n_f) + _EPS))
        # S update (core)
        n_s = f.T @ x @ g                               # (kr, kc)
        s = s * jnp.sqrt(n_s / ((f.T @ f) @ s @ (g.T @ g) + _EPS))
        d = x - f @ s @ g.T
        return (f, s, g), 0.5 * jnp.sum(d * d)

    return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                       max_iter=max_iter, verbose=verbose)


def nmtf(
    x,
    k_row: int,
    k_col: int,
    *,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    f_init=None,
    s_init=None,
    g_init=None,
    key=None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
):
    """Bi-orthogonal NMTF (Ding et al. 2006) for co-clustering.

    Returns ``(Results, s)``: ``Results.w`` is F (m x k_row, row
    clusters), ``Results.h`` is G^T (k_col x n, column clusters), and
    ``s`` is the (k_row x k_col) association core.  Row/column cluster
    labels are ``F.argmax(1)`` / ``G^T.argmax(0)``.
    """
    x = jnp.asarray(x)
    x = x + jnp.maximum(-jnp.min(x), jnp.asarray(0.0, dtype=x.dtype))
    m, n = x.shape

    inits = (f_init is None, s_init is None, g_init is None)
    if len(set(inits)) != 1:
        raise ValueError("pass all of f_init/s_init/g_init, or none")
    if f_init is not None:
        f = jnp.asarray(f_init, dtype=x.dtype)
        s = jnp.asarray(s_init, dtype=x.dtype)
        g = jnp.asarray(g_init, dtype=x.dtype)
    else:
        # Ding et al. §5 init: k-means indicators on rows/columns
        # (+0.2 smoothing), S from the closed form F^T X G
        kk = key if key is not None else jax.random.PRNGKey(0)
        k1, k2 = jax.random.split(kk)
        f = _kmeans_indicator(x, k_row, k1)
        g = _kmeans_indicator(x.T, k_col, k2)
        s = f.T @ x @ g / (jnp.sum(f, axis=0)[:, None]
                           * jnp.sum(g, axis=0)[None, :])

    experiment = MurExperiment(
        method="nmtf", components=k_row, distance_type="eu-triortho",
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1,
        tol2=tol2, lambda_w=0.0, lambda_h=float(k_col),
    )

    d0 = x - f @ s @ g.T
    carry = init_carry(0.5 * jnp.sum(d0 * d0), max_iter, (f, s, g))
    run = lambda c, stop: _nmtf_block(
        x, c, stop, tol1, tol2, min_iter=min_iter, max_iter=max_iter,
        verbose=verbose,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + f"|nmtf:{k_row}x{k_col}",
    )
    f, s, g = carry.inner
    i, obj_history = finalize_history(carry)
    res = Results(w=np.asarray(f), h=np.asarray(g.T), i=i,
                  obj_history=obj_history, experiment=experiment)
    return res, np.asarray(s)
