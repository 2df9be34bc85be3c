"""Proximal-operator library.

One canonical implementation of the operators the reference duplicates
across three files (reference: nmf/admm.py:117-213, nmf/ao_admm.py:104-198,
nmf/ao_admm_local_sparsity.py:221-321):

  nn     : projection onto the non-negative orthant
  l1n    : l1 shrink-then-project (lasso with non-negativity)
  l2n    : Tikhonov second-difference smoothing + projection
  l1inf  : row-wise l1,inf-ball "local sparsity" projection
  l1inf_transpose : column-wise variant

Redesign:
  * ``l1inf``'s per-row Python loop with an inner linear scan
    (nmf/admm.py:164-182) becomes a fully vectorized
    sort + cumsum + first-negative-index water-filling — one fused pass,
    no data-dependent control flow.
  * ``l2n``'s sparse SuperLU solve (nmf/admm.py:150-152) becomes a dense
    k x k solve: the operator is only ever applied along the rank axis
    (k <= a few hundred), where a dense solve is faster on accelerators
    than any sparse path.

Parity notes (kept or fixed deliberately):
  * ``l1inf`` reproduces the reference's exact arithmetic, including its
    ``mat_aux + dual`` / ``mat_aux - dual`` sign mix (nmf/admm.py:161,170)
    and the ``val[:index_count+1]`` inclusive sum (nmf/admm.py:179) so
    golden tests agree bit-for-bit in float64.
  * ``l1inf_transpose`` fixes the reference's ``dual[:, 1]`` column-index
    bug (nmf/admm.py:196 — ``dual[:, i]`` is clearly meant) and keeps its
    ``theta = max(theta, 0)`` clamp (nmf/admm.py:206).
"""
from __future__ import annotations

import jax.numpy as jnp


def prox_nn(mat_aux, dual):
    """Non-negativity projection (nmf/admm.py:126-131)."""
    diff = mat_aux - dual
    return jnp.where(diff < 0, 0.0, diff)


def prox_l1n(mat_aux, dual, *, rho, lambda_):
    """l1 shrinkage then non-negativity projection (nmf/admm.py:133-139)."""
    mat = mat_aux - dual - lambda_ / rho
    return jnp.where(mat < 0, 0.0, mat)


def prox_l2n(mat_aux, dual, *, rho, lambda_):
    """Tikhonov-smoothing prox (nmf/admm.py:141-156).

    Solves (1/rho)(lambda*T^T T + rho*I) X = (mat_aux - dual) where T is the
    tridiagonal second-difference operator over the leading (rank) axis,
    then projects to the non-negative orthant.  Dense k x k solve instead of
    the reference's SuperLU ``spsolve``.
    """
    n = mat_aux.shape[0]
    t = (
        2.0 * jnp.eye(n, dtype=mat_aux.dtype)
        - jnp.eye(n, k=1, dtype=mat_aux.dtype)
        - jnp.eye(n, k=-1, dtype=mat_aux.dtype)
    )
    a = (lambda_ * (t.T @ t) + rho * jnp.eye(n, dtype=mat_aux.dtype)) / rho
    mat = jnp.linalg.solve(a, mat_aux - dual)
    return jnp.where(mat < 0, 0.0, mat)


def _l1inf_rows(mat_aux, dual, *, rho, lambda_, upper_bound, clamp_theta):
    """Vectorized row-wise l1,inf water-filling (nmf/admm.py:158-183).

    Per row: if the shifted positive part already fits the l1 budget, keep
    it; otherwise find the water level theta by descending sort + cumsum and
    shrink.  ``first-negative`` index selection replaces the reference's
    sequential scan (nmf/admm.py:171-177).
    """
    n = mat_aux.shape[1]
    lam_over_rho = lambda_ / rho

    pos = mat_aux + dual - lam_over_rho
    pos = jnp.where(pos < 0, 0.0, pos)
    fits = jnp.sum(pos, axis=1, keepdims=True) <= upper_bound

    val = -jnp.sort(-(mat_aux - dual), axis=1)  # descending
    cums = jnp.cumsum(val, axis=1)
    j = jnp.arange(1, n + 1, dtype=mat_aux.dtype)[None, :]
    test = rho * val + lambda_ - (rho / j) * (cums + lam_over_rho - upper_bound)

    neg = test < 0
    any_neg = jnp.any(neg, axis=1)
    first = jnp.argmax(neg, axis=1)  # 0-based == reference's j-1
    index_count = jnp.where(any_neg, first, n + 1)

    # sum of val[:index_count+1] with numpy's clamping slice semantics
    sum_sel = jnp.take_along_axis(
        cums, jnp.clip(index_count, 0, n - 1)[:, None], axis=1
    )[:, 0]
    ic = jnp.maximum(index_count, 1).astype(mat_aux.dtype)
    theta = rho / ic * (sum_sel + lam_over_rho - upper_bound)
    if clamp_theta:
        theta = jnp.maximum(theta, 0.0)

    shrink = mat_aux + dual - lam_over_rho - theta[:, None] / rho
    shrink = jnp.where(shrink < 0, 0.0, shrink)
    return jnp.where(fits, pos, shrink)


def prox_l1inf(mat_aux, dual, *, rho, lambda_, upper_bound=1.0):
    """Row-wise l1,inf projection, reference-exact semantics."""
    return _l1inf_rows(
        mat_aux, dual, rho=rho, lambda_=lambda_, upper_bound=upper_bound,
        clamp_theta=False,
    )


def prox_l1inf_transpose(mat_aux, dual, *, rho, lambda_, upper_bound=1.0):
    """Column-wise l1,inf projection.

    Fixes the reference's ``dual[:, 1]`` indexing bug (nmf/admm.py:196) by
    using each column's own dual, and keeps its theta >= 0 clamp
    (nmf/admm.py:206).
    """
    return _l1inf_rows(
        mat_aux.T, dual.T, rho=rho, lambda_=lambda_, upper_bound=upper_bound,
        clamp_theta=True,
    ).T


def prox_l1inf_ball(z, *, rho, lambda_, upper_bound=1.0):
    """Correct row-wise prox of ``lambda ||x||_1 + i{x >= 0, sum(x) <= ub}``
    at point ``z`` (penalty rho): ``x = max(z - lambda/rho - theta/rho, 0)``
    with the water level theta chosen so each over-budget row lands exactly
    on the l1 ball.

    This is the self-consistent re-derivation of the reference's
    ``local_sparsity`` water-filling (nmf/ao_admm_local_sparsity.py:159-186)
    used by the coupled local-sparsity solver — unlike :func:`prox_l1inf`
    it evaluates every term at the same point ``z`` (the reference mixes
    ``mat_aux + dual`` and ``mat_aux - dual``, a preserved parity bug) and
    its theta is exact, so the output is always bounded by the budget.
    """
    n = z.shape[1]
    lam = lambda_ / rho

    pos = jnp.maximum(z - lam, 0.0)
    fits = jnp.sum(pos, axis=1, keepdims=True) <= upper_bound

    val = -jnp.sort(-z, axis=1)  # descending
    cums = jnp.cumsum(val, axis=1)
    j = jnp.arange(1, n + 1, dtype=z.dtype)[None, :]
    # theta_j solves sum_{i<=j} (val_i - lam - theta/rho) = ub
    theta_j = (rho * (cums - upper_bound) - j * lambda_) / j
    active = val - lam - theta_j / rho > 0  # true on a prefix
    jstar = jnp.maximum(jnp.sum(active, axis=1), 1)  # >= 1 for non-fit rows
    theta = jnp.take_along_axis(theta_j, (jstar - 1)[:, None], axis=1)
    theta = jnp.maximum(theta, 0.0)

    shrink = jnp.maximum(z - lam - theta / rho, 0.0)
    return jnp.where(fits, pos, shrink)


def prox(prox_type: str, mat_aux, dual, *, rho=None, lambda_=None, upper_bound=1.0):
    """String-dispatched proximal operator (reference signature,
    nmf/admm.py:117).  ``prox_type`` must be static under jit."""
    if prox_type == "nn":
        return prox_nn(mat_aux, dual)
    if prox_type == "l1n":
        return prox_l1n(mat_aux, dual, rho=rho, lambda_=lambda_)
    if prox_type == "l2n":
        return prox_l2n(mat_aux, dual, rho=rho, lambda_=lambda_)
    if prox_type == "l1inf":
        return prox_l1inf(mat_aux, dual, rho=rho, lambda_=lambda_,
                          upper_bound=upper_bound)
    if prox_type == "l1inf_transpose":
        return prox_l1inf_transpose(mat_aux, dual, rho=rho, lambda_=lambda_,
                                    upper_bound=upper_bound)
    raise TypeError("Unknown prox_type.")
