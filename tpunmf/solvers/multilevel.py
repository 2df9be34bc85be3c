"""Multilevel NMF: coarsen -> solve -> prolongate -> refine.

Beyond-reference capability, after Gillis & Glineur, "A Multilevel
Approach for Nonnegative Matrix Factorization" (arXiv:1009.0881): NMF
restricted to a coarsened data matrix is a much cheaper problem whose
solution prolongates into an excellent warm start for the fine problem,
cutting total time-to-objective — most iterations happen at a fraction
of the full problem's cost.

Device mapping: the restriction operator is plain column aggregation
— ``X_c[:, j] = sum of a group of `factor` adjacent columns`` — which is
one reshape+sum (bandwidth-bound, single pass); prolongation spreads
each coarse H column uniformly over its group (``repeat / factor``).
Since ``X_c = X @ P`` with P the nonnegative aggregation matrix,
``X ~ W H`` implies ``X_c ~ W (H P)``: the coarse W is directly a fine
W, and the coarse H is the aggregated fine H — both inits are exact in
the rank-k model class, so no information is lost beyond within-group
column variation.

Columns are aggregated (the item/sample axis n, usually the long one);
set ``axis=0`` to coarsen rows instead (applied by transposition).  Any
solver with the shared (w_init/h_init, min_iter/max_iter, tol1/tol2)
surface works as the inner engine ('mur', 'hals', ...).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.types import Results


def _get_solver(method: str):
    from . import hals, mur

    table = {"mur": mur, "hals": hals}
    if method not in table:
        raise KeyError(f"multilevel supports {sorted(table)}; got {method!r}")
    return table[method]


def coarsen_columns(x, factor: int):
    """Aggregate groups of ``factor`` adjacent columns by summation.

    Ragged tails are zero-padded (zero columns prolongate to near-zero
    H entries — harmless for an init)."""
    m, n = x.shape
    pad = (-n) % factor
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad)))
    return x.reshape(m, (n + pad) // factor, factor).sum(axis=2)


def prolongate_h(h_c, factor: int, n: int):
    """Spread each coarse H column uniformly over its fine group."""
    h = jnp.repeat(h_c / factor, factor, axis=1)
    return h[:, :n]


def multilevel(
    x,
    k: int,
    *,
    method: str = "hals",
    levels: int = 2,
    factor: int = 4,
    coarse_iters: int = 200,
    axis: int = 1,
    key=None,
    **params,
) -> Results:
    """NMF with a multilevel warm start (arXiv:1009.0881 scheme).

    Args:
      method: inner solver ('mur' or 'hals'); ``params`` go to it
        verbatim at the finest level (distance_type, tolerances, ...).
      levels: coarsening depth; level L solves an
        ``n / factor**L``-column problem.
      factor: column-aggregation width per level.
      coarse_iters: max iterations at each coarse level (tolerances are
        inherited from ``params``; coarse levels converge fast).
      axis: 1 coarsens columns (default), 0 coarsens rows (via
        transposition — factors are transposed back).

    Returns the finest-level ``Results`` (its obj_history covers the
    fine solve only; coarse work is the warm start).
    """
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if factor < 2:
        raise ValueError("factor must be >= 2")
    if axis == 0:
        # transposition swaps the factor roles, so the per-factor
        # regularizers swap too (remove-then-reinsert: a lone lambda_w
        # must become lambda_h, not apply to both)
        sw = dict(params)
        lw = sw.pop("lambda_w", None)
        lh = sw.pop("lambda_h", None)
        if lh is not None:
            sw["lambda_w"] = lh
        if lw is not None:
            sw["lambda_h"] = lw
        res = multilevel(
            jnp.asarray(x).T, k, method=method, levels=levels,
            factor=factor, coarse_iters=coarse_iters, axis=1, key=key,
            **sw,
        )
        exp = res.experiment
        return Results(w=res.h.T, h=res.w.T, i=res.i,
                       obj_history=res.obj_history, experiment=exp)

    solver = _get_solver(method)
    x = jnp.asarray(x)
    n = x.shape[1]

    # build the pyramid (fine -> coarse), stopping early if a level
    # would drop below ~4k columns of rank headroom
    pyramid = [x]
    for _ in range(levels):
        nxt = coarsen_columns(pyramid[-1], factor)
        if nxt.shape[1] < max(2 * k, 8):
            break
        pyramid.append(nxt)

    # coarsest solve from the solver's own default init
    coarse_params = {kk: v for kk, v in params.items()
                     if kk not in ("min_iter", "max_iter", "w_init",
                                   "h_init", "verbose")}
    res_c = solver(pyramid[-1], k, max_iter=coarse_iters, key=key,
                   **coarse_params)
    w, h_c = jnp.asarray(res_c.w), jnp.asarray(res_c.h)

    # prolongate + refine up the pyramid
    for lvl in range(len(pyramid) - 2, 0, -1):
        h0 = prolongate_h(h_c, factor, pyramid[lvl].shape[1])
        res_mid = solver(pyramid[lvl], k, w_init=w, h_init=h0,
                         max_iter=coarse_iters, **coarse_params)
        w, h_c = jnp.asarray(res_mid.w), jnp.asarray(res_mid.h)

    h0 = prolongate_h(h_c, factor, n)
    return solver(x, k, w_init=w, h_init=h0, **params)


def mur_multilevel(x, k, **kw) -> Results:
    """Convenience: multilevel(…, method='mur')."""
    return multilevel(x, k, method="mur", **kw)
