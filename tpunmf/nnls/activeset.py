"""Batched masked active-set NNLS (FCNNLS re-derived for XLA).

Solves ``min_{K >= 0} ||C K - A||_F`` given the normal-equation inputs
``CtC = C.T @ C`` and ``CtA = C.T @ A``, for all right-hand-side columns
simultaneously.

The reference implements Van Benthem & Keenan's fast combinatorial NNLS
with shrinking numpy index sets and a data-dependent ``while`` loop
(reference: nmf/fcnnls.py:55-136); its column-grouping trick (``cssls``,
nmf/fcnnls.py:14-52) exists to batch LAPACK calls on CPU and its int64
set-encoding overflows for rank > 62 (nmf/fcnnls.py:28).  None of that maps
to an accelerator, so this is a ground-up re-derivation (the algorithm from the
paper, not the reference's code — whose inner line search is itself buggy,
``alpha.flat[min_idx]`` at nmf/fcnnls.py:105-106 flat-indexes with row
indices):

  * passive sets are boolean masks of static shape (l, p);
  * the per-unique-passive-set grouped solves become ONE batched masked
    solve: for each column, ``(CtC ⊙ m m^T + diag(~m)) k = CtA ⊙ m`` —
    entries outside the passive set solve to exactly 0, so no gathers;
  * the feasibility line search (alpha step) is vectorized across columns;
  * the outer/inner loops are ``lax.while_loop``s over the whole batch with
    per-column done-masks freezing converged columns.

The fixed point is the unique NNLS optimum (CtC SPD), so results agree
with per-column Lawson-Hanson (scipy.optimize.nnls) to solver precision —
both of the reference's ANLS paths (nmf/anls.py:24-29) are served by this
one kernel.
"""
from __future__ import annotations

import contextlib
from functools import partial

import jax
import jax.numpy as jnp


def _prec_ctx(precision):
    """Trace-time matmul-precision scope (None = caller's default)."""
    if precision is None:
        return contextlib.nullcontext()
    return jax.default_matmul_precision(precision)


# cap on the (p, l, l) batched-system temporary built per solve
_MASKED_SOLVE_BYTES_BUDGET = 512 * 1024 * 1024


def _masked_solve_block(ct_c, ct_a_t, m):
    """(chunk, l) rhs/masks -> (chunk, l) solutions.

    Each masked system is SPD (principal submatrix of an SPD Gram plus
    identity padding), so batched Cholesky applies — faster than LU.
    """
    dtype = ct_a_t.dtype
    pair = m[:, :, None] * m[:, None, :]           # (chunk, l, l)
    eye = jnp.eye(ct_c.shape[0], dtype=dtype)
    mats = ct_c[None, :, :] * pair + eye[None, :, :] * (1.0 - m)[:, :, None]
    rhs = (ct_a_t * m)[:, :, None]
    chol = jnp.linalg.cholesky(mats)
    sol = jax.scipy.linalg.solve_triangular(chol, rhs, lower=True)
    sol = jax.scipy.linalg.solve_triangular(
        chol, sol, lower=True, trans="T"
    )
    return sol[:, :, 0]


def masked_solve(ct_c, ct_a, p_set, *, x0=None):
    """Batched solve of per-column passive-set subsystems.

    For column j with passive mask m: solves
    ``(CtC ⊙ m m^T + diag(~m)) k_j = CtA_j ⊙ m``.
    Rows outside the passive set reduce to ``1 * k_i = 0``, so k_i == 0
    exactly — equivalent to the reference's gathered subsystem solves
    (nmf/fcnnls.py:38-50) but fixed-shape and batched.  When the batched
    (p, l, l) systems would exceed a fixed memory budget the columns are
    processed in sequential chunks via ``lax.map``.

    Args:
      ct_c: (l, l); ct_a: (l, p); p_set: (l, p) bool.
      x0: ignored (direct solve) — accepted so call sites can pass a
        warm start uniformly to either solve method.
    Returns: (l, p) solution with zeros outside the passive sets.
    """
    del x0
    dtype = ct_a.dtype
    l, p = ct_a.shape
    m = p_set.T.astype(dtype)                      # (p, l)
    ct_a_t = ct_a.T                                # (p, l)

    bytes_needed = p * l * l * jnp.dtype(dtype).itemsize
    if bytes_needed <= _MASKED_SOLVE_BYTES_BUDGET:
        return _masked_solve_block(ct_c, ct_a_t, m).T

    chunk = max(1, _MASKED_SOLVE_BYTES_BUDGET // (l * l * jnp.dtype(dtype).itemsize))
    pad = (-p) % chunk
    if pad:
        ct_a_t = jnp.pad(ct_a_t, ((0, pad), (0, 0)))
        m = jnp.pad(m, ((0, pad), (0, 0)))
    nb = ct_a_t.shape[0] // chunk
    sol = jax.lax.map(
        lambda args: _masked_solve_block(ct_c, *args),
        (ct_a_t.reshape(nb, chunk, l), m.reshape(nb, chunk, l)),
    ).reshape(nb * chunk, l)
    return sol[:p].T


def masked_solve_cg(ct_c, ct_a, p_set, *, iters: int = 0, x0=None,
                    precision: str | None = None):
    """Masked per-column solves via Jacobi-preconditioned CG.

    Key identity: the masked matvec for EVERY column at once,
    ``A_j v_j = m_j ⊙ (CtC @ (m_j ⊙ v_j)) + (1-m_j) ⊙ v_j``, is a single
    dense (l, l) @ (l, p) GEMM plus elementwise masks — GEMM-shaped,
    unlike batched small Cholesky.  CG over SPD systems is exact after l
    steps in exact arithmetic; ``iters`` defaults to l (+8 slack), giving
    agreement with the direct solve to solver precision in f64 and ~1e-5
    in f32.

    ``x0`` warm-starts the iteration (masked onto the passive set) at the
    cost of one extra matvec for the initial residual.  Inside ANLS the
    previous iterate's solution is a near-solution of the new system, so
    the initial residual is small and far fewer steps reach the same
    accuracy at a reduced ``cg_iters``.

    Same signature/semantics as :func:`masked_solve`.
    """
    with _prec_ctx(precision):
        return _masked_solve_cg_body(ct_c, ct_a, p_set, iters=iters, x0=x0)


def _masked_solve_cg_body(ct_c, ct_a, p_set, *, iters, x0):
    l, p = ct_a.shape
    if iters == 0:
        iters = l + 8
    dtype = ct_a.dtype
    m = p_set.astype(dtype)                       # (l, p)
    b = m * ct_a
    diag = m * jnp.diag(ct_c)[:, None] + (1.0 - m)  # Jacobi preconditioner
    diag = jnp.where(diag <= 0.0, 1.0, diag)        # singular-Gram guard

    def matvec(v):
        return m * (ct_c @ (m * v)) + (1.0 - m) * v

    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = m * x0.astype(dtype)
        r = b - matvec(x)
    z = r / diag
    pvec = z
    rz = jnp.sum(r * z, axis=0)                   # (p,)

    def body(t, carry):
        x, r, pvec, rz = carry
        ap = matvec(pvec)
        denom = jnp.sum(pvec * ap, axis=0)
        alpha = rz / jnp.where(denom == 0.0, 1.0, denom)
        x = x + alpha[None, :] * pvec
        r = r - alpha[None, :] * ap
        z = r / diag
        rz_new = jnp.sum(r * z, axis=0)
        beta = rz_new / jnp.where(rz == 0.0, 1.0, rz)
        pvec = z + beta[None, :] * pvec
        return (x, r, pvec, rz_new)

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, pvec, rz))
    return x


def _one_hot_cols(idx, l):
    """(p,) indices -> (l, p) bool one-hot."""
    return jax.nn.one_hot(idx, l, dtype=bool, axis=0)


@partial(jax.jit, static_argnames=("max_outer", "inner_cap", "solve_method",
                                   "opt_tol_ulps", "freeze_stalled",
                                   "cg_iters", "precision"))
def nnls_activeset(ct_c, ct_a, p_set0=None, k0=None, *, max_outer: int = 0,
                   inner_cap: int = 0, solve_method: str = "chol",
                   opt_tol_ulps: float = 100.0,
                   freeze_stalled: bool = True, cg_iters: int = 0,
                   precision: str | None = None):
    """Batched NNLS via masked active sets.

    Args:
      ct_c: (l, l) Gram matrix (SPD; add a ridge upstream if rank-deficient).
      ct_a: (l, p) cross-products, one column per right-hand side.
      p_set0: optional (l, p) bool warm-start passive sets (e.g. the
        support of the previous ANLS iterate).  The fixed point is the
        unique NNLS optimum either way — warm starts change only the
        iteration count, not the answer.
      k0: optional (l, p) warm-start VALUES (the previous iterate itself;
        requires p_set0).  CG solves start from the masked k0 instead of
        zero — strictly more accurate at the same step count, and the
        basis for reducing ``cg_iters``.  Ignored by 'chol'.
      max_outer: bound on outer optimality iterations (default 5*l + 10).
      inner_cap: shared feasibility-restoration budget, like the reference's
        ``iter_max = 3 * l_var`` (nmf/fcnnls.py:10); default 3*l.
      solve_method: 'chol' (batched Cholesky, exact) or 'cg'
        (GEMM-shaped CG, see masked_solve_cg).
      opt_tol_ulps: CG-path dual optimality slack in units of dtype ulps
        (exact solves use a zero tolerance regardless).
      cg_iters: CG step count per solve (0 = the exact-arithmetic bound
        l + 8).  With k0 warm starts a much smaller count reaches the
        same objective (per-backend default: core/backend.py).
      precision: matmul precision for the rank-sized internals (duals
        ``ct_c @ k`` and the CG matvecs) — e.g. 'highest' on a GPU, whose
        default TF32 products leave ~1e-3 relative noise on the duals and
        make columns cycle on noise.  These ops are k-sized — the cost
        is small next to the X-sized products, which keep the caller's
        precision.
      freeze_stalled: anti-cycling guard — a column whose NNLS objective
        fails to decrease by more than ~64 ulps (relative) across an
        exchange is at its numerical optimum and is retired.  The exact
        active-set method decreases the objective strictly at every
        exchange, so this never fires on the mathematical path; it only
        stops columns cycling on solver-precision noise (which otherwise
        re-solve until max_outer).

    Returns: (l, p) non-negative minimizer.
    """
    if solve_method == "chol":
        _solve = masked_solve
    else:
        _solve = partial(masked_solve_cg, iters=cg_iters,
                         precision=precision)
    l, p = ct_a.shape
    if k0 is not None and p_set0 is None:
        raise ValueError("k0 warm-start values require p_set0")
    if max_outer == 0:
        max_outer = 5 * l + 10
    if inner_cap == 0:
        inner_cap = 3 * l

    # dead components: CtC_ll == 0 means column l of C is identically zero
    # (CtC is PSD, so the whole row/col is zero too) — e.g. an all-zero
    # NNDSVD-init factor row.  Their exact NNLS coefficient is 0; without
    # this the unconstrained seed solve hits a singular system and NaNs
    # the whole batch.
    dead = jnp.diag(ct_c) <= 0.0
    ct_c = ct_c + jnp.diag(jnp.where(dead, 1.0, 0.0))
    ct_a = jnp.where(dead[:, None], 0.0, ct_a)

    if p_set0 is None:
        # unconstrained seed + initial passive sets (fcnnls steps 4-7)
        from ..core.linalg import spd_solve

        k0 = spd_solve(ct_c, ct_a, method=solve_method)
        p_set = k0 > 0
        k = jnp.where(p_set, k0, 0.0)
        d = k
        f_mask = ~jnp.all(p_set, axis=0)  # columns still active (step 6)
    else:
        p_set = p_set0
        k = _solve(ct_c, ct_a, p_set, x0=k0)
        d = jnp.maximum(k, 0.0)
        f_mask = jnp.ones((p,), dtype=bool)  # let optimality decide
    warm = p_set0 is not None

    def inner_cond(c):
        _, _, _, h_mask, it = c
        return jnp.logical_and(jnp.any(h_mask), it < inner_cap)

    def inner_body(c):
        k, d, p_set, h_mask, it = c
        # alpha step toward feasibility for negative passive variables
        neg = jnp.logical_and(p_set, k < 0)
        alpha = jnp.where(neg, d / (d - k), jnp.inf)
        alpha_min = jnp.min(alpha, axis=0)                   # (p,)
        min_idx = jnp.argmin(alpha, axis=0)                  # (p,)
        d_new = d - alpha_min[None, :] * (d - k)
        hit = jnp.logical_and(_one_hot_cols(min_idx, l), h_mask[None, :])
        d_new = jnp.where(hit, 0.0, d_new)
        d = jnp.where(h_mask[None, :], d_new, d)
        p_set = jnp.logical_and(p_set, jnp.logical_not(hit))
        k_new = _solve(ct_c, ct_a, p_set, x0=k)
        k = jnp.where(h_mask[None, :], k_new, k)
        h_mask = jnp.any(k < 0, axis=0)
        return (k, d, p_set, h_mask, it + 1)

    def outer_cond(c):
        _, _, _, f_mask, _, it, _ = c
        return jnp.logical_and(jnp.any(f_mask), it < max_outer)

    def outer_body(c):
        k, d, p_set, f_mask, inner_it, it, q_prev = c
        if warm:
            # warm start: iteration 0's solve already happened at init
            # (p_set unchanged) — skip the redundant batched solve
            k_new = jax.lax.cond(
                it == 0, lambda: k, lambda: _solve(ct_c, ct_a, p_set, x0=k)
            )
        else:
            k_new = _solve(ct_c, ct_a, p_set, x0=k)
        k = jnp.where(f_mask[None, :], k_new, k)

        # feasibility restoration (inner loop, fcnnls steps 10-13)
        h_mask = jnp.logical_and(f_mask, jnp.any(k < 0, axis=0))
        k, d, p_set, _, inner_it = jax.lax.while_loop(
            inner_cond, inner_body, (k, d, p_set, h_mask, inner_it)
        )

        # optimality via dual w = CtA - CtC @ K (fcnnls step, nmf/fcnnls.py:124-127).
        # The exact <= 0 test matches the reference's LAPACK-exact solves;
        # the CG path carries ~solver-tolerance noise in the duals, so
        # degenerate (~0) duals need a scale-relative epsilon or columns
        # cycle until max_outer.
        with _prec_ctx(precision):
            w_grad = ct_a - ct_c @ k
        grad_off = jnp.where(p_set, 0.0, w_grad)
        if solve_method == "cg":
            # ~100 ulps at the working precision: f32 gets ~1e-5 relative
            # slack (CG noise floor), f64 stays effectively exact
            eps = jnp.finfo(ct_a.dtype).eps
            opt_tol = opt_tol_ulps * eps * (jnp.max(jnp.abs(ct_a), axis=0) + 1e-30)
        else:
            opt_tol = jnp.zeros((p,), dtype=ct_a.dtype)
        optimal = jnp.all(grad_off <= opt_tol[None, :], axis=0)
        f_mask = jnp.logical_and(f_mask, jnp.logical_not(optimal))

        if freeze_stalled:
            # per-column NNLS objective (up to the constant ||a_j||^2):
            # q_j = 0.5 k^T CtC k - k^T cta = -0.5 * sum(k * (cta + w_grad))
            # — strictly decreasing for exact exchanges, so no decrease
            # means the column is at its numerical optimum (cycling on
            # solver noise); retire it
            q = -0.5 * jnp.sum(jnp.maximum(k, 0.0) * (ct_a + w_grad), axis=0)
            tol = 64.0 * jnp.finfo(ct_a.dtype).eps * (jnp.abs(q_prev) + 1e-30)
            stalled = q >= q_prev - tol
            f_mask = jnp.logical_and(
                f_mask, jnp.logical_or(it == 0, jnp.logical_not(stalled)))
            q_prev = jnp.where(f_mask, q, q_prev)

        # grow passive set with the steepest off-set gradient per column
        grad_neg_inf = jnp.where(p_set, -jnp.inf, w_grad)
        mx_idx = jnp.argmax(grad_neg_inf, axis=0)
        grow = jnp.logical_and(_one_hot_cols(mx_idx, l), f_mask[None, :])
        p_set = jnp.logical_or(p_set, grow)
        d = jnp.where(f_mask[None, :], k, d)
        return (k, d, p_set, f_mask, inner_it, it + 1, q_prev)

    q0 = jnp.full((p,), jnp.inf, dtype=ct_a.dtype)
    k, _, _, _, _, _, _ = jax.lax.while_loop(
        outer_cond,
        outer_body,
        (k, d, p_set, f_mask, jnp.asarray(0, jnp.int32),
         jnp.asarray(0, jnp.int32), q0),
    )
    return jnp.maximum(k, 0.0)


def nnls(c, a, **kw):
    """Convenience wrapper from raw (C, A): forms the normal equations."""
    return nnls_activeset(c.T @ c, c.T @ a, **kw)
