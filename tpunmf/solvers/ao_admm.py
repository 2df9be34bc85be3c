"""AO-ADMM — alternating optimization with inner ADMM subproblem solves.

Behavioral contract matches the reference solver (reference:
nmf/ao_admm.py:201-311): per-subproblem adaptive ``rho = trace(W^T W)/k``
(nmf/ao_admm.py:54), one Cholesky of ``G + rho*I`` reused across inner
iterations (nmf/ao_admm.py:55-59), inner early termination on relative
primal/dual residuals with tol=1e-2 (nmf/ao_admm.py:33-43), the KL
data-term split (nmf/ao_admm.py:71-101), and the W-subproblem solved by
transposition (nmf/ao_admm.py:265-285).

Design notes: the inner ADMM loop is a ``lax.while_loop`` whose
predicate fuses the iteration bound with the residual test (the
reference's data-dependent ``break``); the m*n GEMMs (``w.T @ y``,
``w @ h_aux``) are the collective points under sharding, everything else
is k x k replicated algebra.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.losses import distance
from ..core.types import AoAdmmExperiment, Results
from ..init import nndsvd, random_init
from ..core.backend import defaults, use_kernels
from ..ops.fused import eu_residual_obj, kl_obj
from ..prox import prox
from .common import (  # noqa: F401
    verbose_precision,
    host_array,
    LoopCarry,
    finalize_history,
    init_carry,
    inner_loop,
    run_loop,
    while_block,
)

_INNER_TOL = 1e-2


def _chol(g, rho):
    k = g.shape[0]
    return jax.scipy.linalg.cholesky(g + rho * jnp.eye(k, dtype=g.dtype), lower=True)


def _subproblem_solve(g, rho, cho, b, method):
    """Inner normal-equation solve: reuse the Cholesky ('chol', the
    reference's structure, nmf/ao_admm.py:55-59) or GEMM-shaped CG ('cg',
    core/linalg.py)."""
    if method == "chol":
        return jax.scipy.linalg.cho_solve((cho, True), b)
    from ..core.linalg import spd_solve

    k = g.shape[0]
    return spd_solve(g + rho * jnp.eye(k, dtype=g.dtype), b, method="cg")


def _inner_prox(prox_type, mat_aux, dual, *, rho, lambda_, upper_bound):
    """Prox step for the inner ADMM updates.

    ``l1inf``/``l1inf_transpose`` route to the self-consistent exact
    water-filling prox (prox/operators.prox_l1inf_ball) at the ADMM point
    ``mat_aux - dual``: the reference-parity ``prox_l1inf`` preserves the
    reference's mat_aux+dual / mat_aux-dual sign mix and its unclamped
    water level, whose unbounded output diverges within a few AO-ADMM
    outer iterations once duals grow (the reference's own AO-ADMM would
    NaN identically; flat ADMM keeps the parity version for its golden
    tests, where it is stable).
    """
    if prox_type in ("l1inf", "l1inf_transpose"):
        from ..prox.operators import prox_l1inf_ball

        z = mat_aux - dual
        if prox_type == "l1inf_transpose":
            return prox_l1inf_ball(z.T, rho=rho, lambda_=lambda_,
                                   upper_bound=upper_bound).T
        return prox_l1inf_ball(z, rho=rho, lambda_=lambda_,
                               upper_bound=upper_bound)
    return prox(prox_type, mat_aux, dual, rho=rho, lambda_=lambda_,
                upper_bound=upper_bound)


def _terminated(h, h_prev, h_aux, dual):
    """Reference terminate() (nmf/ao_admm.py:33-43): relative primal/dual
    residuals both below 1e-2.  Zero-norm duals give inf/nan -> False,
    matching numpy semantics."""
    r = jnp.linalg.norm(h - h_aux) / jnp.linalg.norm(h)
    s = jnp.linalg.norm(h - h_prev) / jnp.linalg.norm(dual)
    return jnp.logical_and(r < _INNER_TOL, s < _INNER_TOL)


def _admm_ls_update(y, w, h, dual, k, prox_type, admm_iter, lambda_,
                    spd_solver="chol", upper_bound=1.0,
                    loop_style="while"):
    """Least-squares inner ADMM (nmf/ao_admm.py:46-68), jit-friendly."""
    g = w.T @ w
    rho = jnp.trace(g) / k
    cho = _chol(g, rho) if spd_solver == "chol" else None
    wty = w.T @ y

    def body(state):
        h, dual = state
        h_aux = _subproblem_solve(g, rho, cho, wty + rho * (h + dual), spd_solver)
        h_prev = h
        h = _inner_prox(prox_type, h_aux, dual, rho=rho, lambda_=lambda_,
                        upper_bound=upper_bound)
        dual = dual + h - h_aux
        return (h, dual), _terminated(h, h_prev, h_aux, dual)

    h, dual = inner_loop(body, (h, dual), admm_iter, loop_style)
    return h, dual


def _admm_kl_update(v, v_aux, dual_v, w, h, dual_h, k, prox_type, admm_iter,
                    lambda_, spd_solver="chol", upper_bound=1.0,
                    loop_style="while"):
    """KL inner ADMM with data-term split (nmf/ao_admm.py:71-101)."""
    g = w.T @ w
    rho = jnp.trace(g) / k
    cho = _chol(g, rho) if spd_solver == "chol" else None

    def body(state):
        h, dual_h, v_aux, dual_v = state
        h_aux = _subproblem_solve(
            g, rho, cho, w.T @ (v_aux + dual_v) + rho * (h + dual_h), spd_solver
        )
        h_prev = h
        h = _inner_prox(prox_type, h_aux, dual_h, rho=rho, lambda_=lambda_,
                        upper_bound=upper_bound)

        wh_aux = w @ h_aux
        v_bar = wh_aux - dual_v
        v_aux = 0.5 * ((v_bar - 1.0) + jnp.sqrt((v_bar - 1.0) ** 2 + 4.0 * v))

        dual_h = dual_h + h - h_aux
        dual_v = dual_v + v_aux - wh_aux
        return ((h, dual_h, v_aux, dual_v),
                _terminated(h, h_prev, h_aux, dual_h))

    h, dual_h, v_aux, dual_v = inner_loop(
        body, (h, dual_h, v_aux, dual_v), admm_iter, loop_style)
    return h, dual_h, v_aux, dual_v


@partial(
    jax.jit,
    static_argnames=(
        "k",
        "distance_type",
        "prox_w",
        "prox_h",
        "rho_mode",
        "local_sparsity",
        "spd_solver",
        "min_iter",
        "max_iter",
        "admm_iter",
        "use_pallas",
        "verbose",
        "loop_style",
    ),
)
def _ao_admm_block(
    v,
    carry: LoopCarry,
    stop_i,
    tol1,
    tol2,
    lambda_w,
    lambda_h,
    tau,
    eta,
    upper_bound,
    *,
    k: int,
    distance_type: str,
    prox_w: str,
    prox_h: str,
    rho_mode: str,
    local_sparsity: bool,
    spd_solver: str,
    min_iter: int,
    max_iter: int,
    admm_iter: int,
    use_pallas: bool,
    verbose: bool,
    loop_style: str = "while",
):
    adaptive = rho_mode == "adaptive"

    def ls_update(y, w, h, dual):
        if adaptive:
            from .ao_admm_local import admm_ls_update_adaptive

            return admm_ls_update_adaptive(
                y, w, h, dual, k, prox_h, admm_iter, lambda_h, spd_solver,
                tau, eta, upper_bound, loop_style=loop_style,
            )
        return _admm_ls_update(y, w, h, dual, k, prox_h, admm_iter, lambda_h,
                               spd_solver, upper_bound, loop_style=loop_style)

    def ls_update_w(y, hh, w, dual, ptype, lam):
        if adaptive:
            from .ao_admm_local import admm_ls_update_adaptive

            return admm_ls_update_adaptive(
                y, hh, w, dual, k, ptype, admm_iter, lam, spd_solver, tau,
                eta, upper_bound, loop_style=loop_style,
            )
        return _admm_ls_update(y, hh, w, dual, k, ptype, admm_iter, lam,
                               spd_solver, upper_bound, loop_style=loop_style)

    def kl_update(vv, v_aux, dual_v, w, h, dual_h, ptype, lam):
        if adaptive:
            from .ao_admm_local import admm_kl_update_adaptive

            return admm_kl_update_adaptive(
                vv, v_aux, dual_v, w, h, dual_h, k, ptype, admm_iter, lam,
                spd_solver, tau, eta, upper_bound, loop_style=loop_style,
            )
        return _admm_kl_update(vv, v_aux, dual_v, w, h, dual_h, k, ptype,
                               admm_iter, lam, spd_solver, upper_bound,
                               loop_style=loop_style)

    def step_eu(inner, i):
        w, h, dual_w, dual_h = inner
        h, dual_h = ls_update(v, w, h, dual_h)
        wt, dual_wt = ls_update_w(v.T, h.T, w.T, dual_w.T, prox_w, lambda_w)
        w, dual_w = wt.T, dual_wt.T
        obj = eu_residual_obj(v, w, h, use_pallas=use_pallas)
        return (w, h, dual_w, dual_h), obj

    def step_kl(inner, i):
        w, h, dual_w, dual_h, v_aux, dual_v = inner
        h, dual_h, v_aux, dual_v = kl_update(
            v, v_aux, dual_v, w, h, dual_h, prox_h, lambda_h
        )
        wt, dual_wt, v_auxt, dual_vt = kl_update(
            v.T, v_aux.T, dual_v.T, h.T, w.T, dual_w.T, prox_w, lambda_w
        )
        w, dual_w, v_aux, dual_v = wt.T, dual_wt.T, v_auxt.T, dual_vt.T
        obj = kl_obj(v, w, h, use_pallas=use_pallas)
        return (w, h, dual_w, dual_h, v_aux, dual_v), obj

    def step_local_eu(inner, i):
        # local-sparsity variant (nmf/ao_admm_local_sparsity.py:368-376):
        # standard inner ADMM on H, coupled two-block l1inf update on W
        # (the W-update re-initializes its own data split each entry —
        # see ao_admm_local.admm_local_sparsity_update)
        from .ao_admm_local import admm_local_sparsity_update

        w, h, w_aux, dual_w, dual_h = inner
        h, dual_h = ls_update(v, w, h, dual_h)
        w, w_aux, dual_w = admm_local_sparsity_update(
            v, w, w_aux, dual_w, h, k, admm_iter, lambda_w,
            upper_bound, adaptive, tau, eta, spd_solver,
            loop_style=loop_style,
        )
        obj = eu_residual_obj(v, w, h, use_pallas=use_pallas)
        return (w, h, w_aux, dual_w, dual_h), obj

    def step_local_kl(inner, i):
        # KL: H via the data-split inner ADMM (its own v_aux/dual_v), W
        # via the coupled update (nmf/ao_admm_local_sparsity.py:378-385)
        from .ao_admm_local import admm_local_sparsity_update

        w, h, w_aux, dual_w, dual_h, v_aux, dual_v = inner
        h, dual_h, v_aux, dual_v = kl_update(
            v, v_aux, dual_v, w, h, dual_h, prox_h, lambda_h
        )
        w, w_aux, dual_w = admm_local_sparsity_update(
            v, w, w_aux, dual_w, h, k, admm_iter, lambda_w,
            upper_bound, adaptive, tau, eta, spd_solver,
            loop_style=loop_style,
        )
        obj = kl_obj(v, w, h, use_pallas=use_pallas)
        return (w, h, w_aux, dual_w, dual_h, v_aux, dual_v), obj

    if local_sparsity:
        step = step_local_kl if distance_type == "kl" else step_local_eu
    else:
        step = step_kl if distance_type == "kl" else step_eu
    return while_block(
        step, carry, stop_i, tol1, tol2,
        min_iter=min_iter, max_iter=max_iter, verbose=verbose,
    )


def ao_admm(
    v,
    k: int,
    *,
    distance_type: str = "eu",
    reg_w=(0, "nn"),
    reg_h=(0, "l2n"),
    min_iter: int = 10,
    max_iter: int = 100000,
    admm_iter: int = 10,
    tol1: float = 1e-3,
    tol2: float = 1e-3,
    nndsvd_init=(True, "zero"),
    save_dir: str = "./results/",
    # --- extensions beyond the reference surface ---
    rho_mode: str = "fixed",
    rho_tau: float = 2.0,
    # eta follows Boyd §3.4.1 (mu=10); the reference's eta=1
    # (nmf/ao_admm_local_sparsity.py:122) triggers a rho move on any
    # imbalance and demonstrably diverges
    rho_eta: float = 10.0,
    upper_bound: float = 1.0,
    spd_solver=None,
    w_init=None,
    h_init=None,
    key=None,
    use_pallas: Optional[bool] = None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """AO-ADMM NMF (Huang-Sidiropoulos-Liavas framework).

    Reference-compatible keyword surface (nmf/ao_admm.py:201-203) plus
    explicit init, PRNG key, Pallas toggle and blocked execution.

    ``rho_mode='adaptive'`` enables residual-balancing rho adaptation
    inside the inner ADMM loops; combined with ``reg_w=(lambda, 'l1inf')``
    it selects the local-sparsity variant — the coupled two-block
    W-subproblem with adaptive rho1/rho2 balancing re-derived from the
    reference's broken nmf/ao_admm_local_sparsity.py (see
    solvers/ao_admm_local.py for the derivation and deliberate repairs).
    """
    if distance_type not in ("eu", "kl"):
        raise TypeError("Unknown loss function type.")
    if rho_mode not in ("fixed", "adaptive"):
        raise ValueError("rho_mode must be 'fixed' or 'adaptive'")
    # the coupled local-sparsity W-update engages for l1inf-on-W under
    # adaptive rho (the reference variant always adapts); plain-prox
    # l1inf under fixed rho keeps round-1 behavior
    local_sparsity = rho_mode == "adaptive" and reg_w[1] == "l1inf"
    row = defaults()
    loop_style = row.inner_loop
    if spd_solver is None:
        spd_solver = row.spd_solver
    if spd_solver not in ("chol", "cg"):
        raise ValueError("spd_solver must be 'chol' or 'cg'")

    v = jnp.asarray(v)
    use_pallas = use_kernels(v, k, use_pallas)

    experiment = AoAdmmExperiment(
        method="ao_admm",
        components=k,
        distance_type=distance_type,
        nndsvd_init=nndsvd_init,
        min_iter=min_iter,
        max_iter=max_iter,
        admm_iter=admm_iter,
        tol1=tol1,
        tol2=tol2,
        lambda_w=reg_w[0],
        prox_w=reg_w[1],
        lambda_h=reg_h[0],
        prox_h=reg_h[1],
    )

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None and h_init is not None:
        w = jnp.asarray(w_init, dtype=v.dtype)
        h = jnp.asarray(h_init, dtype=v.dtype)
    elif nndsvd_init[0]:
        w, h = nndsvd(v, k, variant=nndsvd_init[1], key=key)
    else:
        w, h = random_init(
            key if key is not None else jax.random.PRNGKey(0),
            v.shape[0], v.shape[1], k, kind="abs_normal", dtype=v.dtype,
        )

    if local_sparsity and distance_type == "kl":
        inner = (w, h, w, jnp.zeros_like(w), jnp.zeros_like(h),
                 jnp.zeros_like(v), jnp.zeros_like(v))
    elif local_sparsity:
        # w_aux seeded at w, dual at zero; the coupled W-update owns its
        # data-split state internally
        inner = (w, h, w, jnp.zeros_like(w), jnp.zeros_like(h))
    elif distance_type == "kl":
        inner = (w, h, jnp.zeros_like(w), jnp.zeros_like(h),
                 jnp.zeros_like(v), jnp.zeros_like(v))
    else:
        inner = (w, h, jnp.zeros_like(w), jnp.zeros_like(h))

    obj0 = distance(v, w @ h, distance_type)
    carry = init_carry(obj0, max_iter, inner)

    run = lambda c, stop: _ao_admm_block(
        v, c, stop, tol1, tol2, reg_w[0], reg_h[0],
        jnp.asarray(rho_tau, dtype=v.dtype),
        jnp.asarray(rho_eta, dtype=v.dtype),
        jnp.asarray(upper_bound, dtype=v.dtype),
        k=k,
        distance_type=distance_type,
        prox_w=reg_w[1],
        prox_h=reg_h[1],
        rho_mode=rho_mode,
        local_sparsity=local_sparsity,
        spd_solver=spd_solver,
        min_iter=min_iter,
        max_iter=max_iter,
        admm_iter=admm_iter,
        use_pallas=use_pallas,
        verbose=verbose_precision(verbose, tol1, tol2),
        loop_style=loop_style,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        # rho_mode changes the carried state shape/meaning but is not part
        # of the reference-compatible Experiment record — append it to the
        # checkpoint tag so fixed/adaptive checkpoints can't cross-resume
        config_tag=repr(experiment) + (
            f"+rho_mode={rho_mode}" if rho_mode != "fixed" else ""),
    )

    w, h = carry.inner[0], carry.inner[1]
    i, obj_history = finalize_history(carry)
    return Results(
        w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
        experiment=experiment,
    )
