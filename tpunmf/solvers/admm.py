"""ADMM — full-splitting alternating direction method of multipliers.

Behavioral contract matches the reference solver (reference:
nmf/admm.py:233-345): fixed user rho, auxiliary-variable least-squares
updates (nmf/admm.py:216-230), prox steps on W and H, the KL data-term
split with the closed-form ``v_aux = 0.5*((v_bar-1)+sqrt((v_bar-1)^2+4v))``
(nmf/admm.py:312-313), dual ascent, defaults and convergence semantics.

Design notes:
  * the k x k normal-equation solves ``(G + rho*I) X = B`` use an on-device
    Cholesky (SPD by construction) instead of the reference's LAPACK
    ``gesv`` general solve — tiny replicated algebra, while the m*n-sized
    GEMMs (``w_aux.T @ v``, ``h_aux @ v.T``, ``w_aux @ h_aux``) are the
    shardable collective points (SURVEY §3.4);
  * the whole iteration is one jitted ``lax.while_loop`` body via
    solvers/common.py, with the objective evaluated by the same fused
    pass used everywhere else;
  * ``rho_mode='adaptive'`` adds residual-balancing rho damping — the
    capability sketched by the reference's broken local-sparsity file
    (nmf/ao_admm_local_sparsity.py:189-218, tau=2 increase/decrease),
    re-derived as standard Boyd §3.4.1 balancing: rho *= tau when the
    primal residual dominates (r > mu*s), rho /= tau when the dual one
    does, with the scaled duals rescaled by rho_old/rho_new on change.
    rho lives in the carried state, so checkpoints resume it.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.losses import distance
from ..core.types import AdmmExperiment, Results
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
    run_loop,
    while_block,
)


def _spd_solve(g, rho, b, method="chol"):
    """Solve (g + rho*I) x = b; g is k x k PSD (core/linalg.spd_solve)."""
    from ..core.linalg import spd_solve

    k = g.shape[0]
    a = g + rho * jnp.eye(k, dtype=g.dtype)
    return spd_solve(a, b, method=method)


def _objective(v, w, h, distance_type, use_pallas):
    if distance_type == "kl":
        return kl_obj(v, w, h, use_pallas=use_pallas)
    return eu_residual_obj(v, w, h, use_pallas=use_pallas)


@partial(
    jax.jit,
    static_argnames=(
        "distance_type",
        "prox_w",
        "prox_h",
        "rho_mode",
        "spd_solver",
        "min_iter",
        "max_iter",
        "use_pallas",
        "verbose",
    ),
)
def _admm_block(
    v,
    carry: LoopCarry,
    stop_i,
    tol1,
    tol2,
    lambda_w,
    lambda_h,
    tau,
    mu,
    *,
    distance_type: str,
    prox_w: str,
    prox_h: str,
    rho_mode: str,
    spd_solver: str,
    min_iter: int,
    max_iter: int,
    use_pallas: bool,
    verbose: bool,
):
    def _balance(rho, r, sres, duals):
        """Residual balancing: returns (rho_new, rescaled duals)."""
        if rho_mode != "adaptive":
            return rho, duals
        rho_new = jnp.where(r > mu * sres, rho * tau,
                            jnp.where(sres > mu * r, rho / tau, rho))
        scale = rho / rho_new
        return rho_new, tuple(d * scale for d in duals)
    def step_eu(inner, i):
        w, h, w_aux, h_aux, dual_w, dual_h, rho = inner
        w_prev, h_prev = w, h
        # aux updates (nmf/admm.py:216-230,294-297)
        h_aux = _spd_solve(w_aux.T @ w_aux, rho, w_aux.T @ v + rho * (h + dual_h), spd_solver)
        w_aux = _spd_solve(
            h_aux @ h_aux.T, rho, h_aux @ v.T + rho * (w.T + dual_w.T),
            spd_solver,
        ).T
        # prox steps (nmf/admm.py:299-301)
        h = prox(prox_h, h_aux, dual_h, rho=rho, lambda_=lambda_h)
        w = prox(prox_w, w_aux.T, dual_w.T, rho=rho, lambda_=lambda_w).T
        # dual ascent (nmf/admm.py:320-321)
        dual_h = dual_h + h - h_aux
        dual_w = dual_w + w - w_aux
        r = jnp.sqrt(jnp.sum((h - h_aux) ** 2) + jnp.sum((w - w_aux) ** 2))
        sres = rho * jnp.sqrt(
            jnp.sum((h - h_prev) ** 2) + jnp.sum((w - w_prev) ** 2)
        )
        rho, (dual_w, dual_h) = _balance(rho, r, sres, (dual_w, dual_h))
        obj = _objective(v, w, h, "eu", use_pallas)
        return (w, h, w_aux, h_aux, dual_w, dual_h, rho), obj

    def step_kl(inner, i):
        w, h, w_aux, h_aux, dual_w, dual_h, v_aux, dual_v, rho = inner
        w_prev, h_prev = w, h
        # aux updates against the split data term (nmf/admm.py:303-306)
        vd = v_aux + dual_v
        h_aux = _spd_solve(w_aux.T @ w_aux, rho, w_aux.T @ vd + rho * (h + dual_h), spd_solver)
        w_aux = _spd_solve(
            h_aux @ h_aux.T, rho, h_aux @ vd.T + rho * (w.T + dual_w.T),
            spd_solver,
        ).T
        h = prox(prox_h, h_aux, dual_h, rho=rho, lambda_=lambda_h)
        w = prox(prox_w, w_aux.T, dual_w.T, rho=rho, lambda_=lambda_w).T
        # KL data-term closed form (nmf/admm.py:312-315)
        wh_aux = w_aux @ h_aux
        v_bar = wh_aux - dual_v
        v_aux = 0.5 * ((v_bar - 1.0) + jnp.sqrt((v_bar - 1.0) ** 2 + 4.0 * v))
        dual_v = dual_v + v_aux - wh_aux
        dual_h = dual_h + h - h_aux
        dual_w = dual_w + w - w_aux
        r = jnp.sqrt(jnp.sum((h - h_aux) ** 2) + jnp.sum((w - w_aux) ** 2))
        sres = rho * jnp.sqrt(
            jnp.sum((h - h_prev) ** 2) + jnp.sum((w - w_prev) ** 2)
        )
        # dual_v is NOT rescaled: the v-split prox (above) carries a unit
        # penalty independent of rho (nmf/admm.py:312-313), so its scaled
        # dual does not change coordinates when rho does
        rho, (dual_w, dual_h) = _balance(rho, r, sres, (dual_w, dual_h))
        obj = _objective(v, w, h, "kl", use_pallas)
        return (w, h, w_aux, h_aux, dual_w, dual_h, v_aux, dual_v, rho), obj

    step = step_kl if distance_type == "kl" else step_eu
    return while_block(
        step, carry, stop_i, tol1, tol2,
        min_iter=min_iter, max_iter=max_iter, verbose=verbose,
    )


def admm(
    v,
    k: int,
    *,
    rho: float = 1.0,
    distance_type: str = "eu",
    reg_w=(0, "nn"),
    reg_h=(0, "l2n"),
    min_iter: int = 10,
    max_iter: int = 100000,
    tol1: float = 1e-3,
    tol2: float = 1e-3,
    nndsvd_init=(True, "zero"),
    save_dir: str = "./results/",
    # --- extensions beyond the reference surface ---
    rho_mode: str = "fixed",
    rho_tau: float = 2.0,
    rho_mu: float = 10.0,
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
    """Full-splitting ADMM NMF (Huang-Sidiropoulos-Liavas framework).

    Reference-compatible keyword surface (nmf/admm.py:233-235) plus explicit
    init, PRNG key, Pallas toggle and blocked execution (see mur()).
    """
    if distance_type not in ("eu", "kl"):
        raise TypeError("Unknown loss type.")
    if rho_mode not in ("fixed", "adaptive"):
        raise ValueError("rho_mode must be 'fixed' or 'adaptive'")
    if spd_solver is None:
        spd_solver = defaults().spd_solver
    if spd_solver not in ("chol", "cg"):
        raise ValueError("spd_solver must be 'chol' or 'cg'")

    v = jnp.asarray(v)
    use_pallas = use_kernels(v, k, use_pallas)

    experiment = AdmmExperiment(
        method="admm",
        components=k,
        rho=rho,
        distance_type=distance_type,
        nndsvd_init=nndsvd_init,
        min_iter=min_iter,
        max_iter=max_iter,
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

    # aux start as copies, duals at zero (nmf/admm.py:26-35); rho is
    # carried in the state so adaptive damping survives checkpoints
    rho0 = jnp.asarray(rho, dtype=v.dtype)
    zeros_wh = (jnp.zeros_like(w), jnp.zeros_like(h))
    if distance_type == "kl":
        inner = (w, h, w, h, *zeros_wh, jnp.zeros_like(v), jnp.zeros_like(v), rho0)
    else:
        inner = (w, h, w, h, *zeros_wh, rho0)

    obj0 = distance(v, w @ h, distance_type)
    carry = init_carry(obj0, max_iter, inner)

    run = lambda c, stop: _admm_block(
        v, c, stop, tol1, tol2, reg_w[0], reg_h[0], rho_tau, rho_mu,
        distance_type=distance_type,
        prox_w=reg_w[1],
        prox_h=reg_h[1],
        rho_mode=rho_mode,
        spd_solver=spd_solver,
        min_iter=min_iter,
        max_iter=max_iter,
        use_pallas=use_pallas,
        verbose=verbose_precision(verbose, tol1, tol2),
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment),
    )

    w, h = carry.inner[0], carry.inner[1]
    i, obj_history = finalize_history(carry)
    return Results(
        w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
        experiment=experiment,
    )
