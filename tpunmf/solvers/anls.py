"""ANLS — alternating non-negative least squares (Kim & Park).

Behavioral contract matches the reference solver (reference:
nmf/anls.py:50-135): each half-problem is the Tikhonov-augmented NNLS
``min ||[H^T; sqrt(2*lambda_w) I] W^T - [X^T; 0]||`` (nmf/anls.py:21-22),
defaults, NNDSVD-by-default init, convergence semantics, and the quirk
that ``distance_type='kl'`` only changes the *reported* objective — the
updates are always least-squares (nmf/anls.py:108,114-115).

Redesign:
  * the augmented stacking is folded into the normal equations —
    ``CtC = H H^T + 2*lambda*I`` and ``CtA = H X^T`` — so no (n+k) x k
    concatenated matrices are ever built;
  * both of the reference's NNLS paths (per-column Fortran Lawson-Hanson at
    nmf/anls.py:28-29 and FCNNLS at nmf/anls.py:25) are served by batched
    fixed-shape masked solvers (see tpunmf/nnls/): ``use_fcnnls`` is
    accepted for API compatibility and maps to the same active-set kernel
    (identical fixed point); ``nnls_solver='bpp'`` selects block principal
    pivoting, the working version of the reference's dead nmf/bpp.py.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.losses import distance
from ..core.types import AnlsExperiment, Results
from ..init import nndsvd, random_init
from ..nnls import nnls_activeset, nnls_bpp
from ..core.backend import defaults, use_kernels
from ..ops.fused import eu_residual_obj, kl_obj
from .common import (  # noqa: F401
    verbose_precision,
    host_array,
    LoopCarry,
    finalize_history,
    init_carry,
    run_loop,
    while_block,
)


def _make_solve(nnls_solver: str, solve_method: str, nnls_opts_t: tuple):
    """Uniform half-problem solve: (ct_c, ct_a, prev) -> solution.

    ``prev`` is the previous iterate for this half — its support becomes
    the warm-start passive set (both kernels) and, for the active-set/CG
    path, its values become the CG starting point.
    """
    if nnls_solver == "bpp":
        base = partial(nnls_bpp, solve_method=solve_method)
        return lambda ct_c, ct_a, prev: base(ct_c, ct_a, prev > 0)
    base = partial(nnls_activeset, solve_method=solve_method,
                   **dict(nnls_opts_t))
    return lambda ct_c, ct_a, prev: base(ct_c, ct_a, prev > 0, prev)


@partial(
    jax.jit,
    static_argnames=(
        "k",
        "distance_type",
        "nnls_solver",
        "solve_method",
        "nnls_opts_t",
        "min_iter",
        "max_iter",
        "use_pallas",
        "verbose",
    ),
)
def _anls_block(
    x,
    carry: LoopCarry,
    stop_i,
    tol1,
    tol2,
    lambda_w,
    lambda_h,
    *,
    k: int,
    distance_type: str,
    nnls_solver: str,
    solve_method: str,
    nnls_opts_t: tuple = (),
    min_iter: int,
    max_iter: int,
    use_pallas: bool,
    verbose: bool,
):
    solve = _make_solve(nnls_solver, solve_method, nnls_opts_t)
    eye = jnp.eye(k, dtype=x.dtype)

    def step(inner, i):
        w, h = inner
        # W update: normal equations of [h.T; sqrt(2*lw) I] vs [x.T; 0]
        # (nmf/anls.py:18-31 folded: CtC = h h^T + 2*lw*I, CtA = h x^T);
        # warm-started from the previous iterate's support AND values (the
        # fixed point is the exact NNLS optimum, so trajectories are
        # unchanged; CG solves start from the masked previous solution)
        ct_c = h @ h.T + 2.0 * lambda_w * eye
        w = solve(ct_c, h @ x.T, w.T).T
        # H update (nmf/anls.py:34-47)
        ct_c = w.T @ w + 2.0 * lambda_h * eye
        h = solve(ct_c, w.T @ x, h)

        if distance_type == "kl":
            obj = kl_obj(x, w, h, use_pallas=use_pallas)
        else:
            obj = eu_residual_obj(x, w, h, use_pallas=use_pallas)
        return (w, h), obj

    return while_block(
        step, carry, stop_i, tol1, tol2,
        min_iter=min_iter, max_iter=max_iter, verbose=verbose,
    )


@partial(
    jax.jit,
    static_argnames=("k", "distance_type", "nnls_solver", "solve_method",
                     "nnls_opts_t", "use_pallas"),
)
def _anls_iter(
    x, w, h, lambda_w, lambda_h, *, k: int, distance_type: str,
    nnls_solver: str, solve_method: str, nnls_opts_t: tuple = (),
    use_pallas: bool,
):
    """One ANLS iteration as a standalone jit (host-driven loop,
    ``device_loop=False``): each call nests the NNLS while_loops 2 deep
    instead of 3 inside the solver's own loop."""
    solve = _make_solve(nnls_solver, solve_method, nnls_opts_t)
    eye = jnp.eye(k, dtype=x.dtype)
    ct_c = h @ h.T + 2.0 * lambda_w * eye
    w = solve(ct_c, h @ x.T, w.T).T
    ct_c = w.T @ w + 2.0 * lambda_h * eye
    h = solve(ct_c, w.T @ x, h)
    if distance_type == "kl":
        obj = kl_obj(x, w, h, use_pallas=use_pallas)
    else:
        obj = eu_residual_obj(x, w, h, use_pallas=use_pallas)
    return w, h, obj


def anls(
    x,
    k: int,
    *,
    distance_type: str = "eu",
    use_fcnnls: bool = False,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    min_iter: int = 10,
    max_iter: int = 1000,
    tol1: float = 1e-3,
    tol2: float = 1e-3,
    nndsvd_init=(True, "zero"),
    save_dir: str = "./results/",
    # --- extensions beyond the reference surface ---
    nnls_solver: str = "activeset",
    masked_solver: Optional[str] = None,
    nnls_opts: Optional[dict] = None,
    w_init=None,
    h_init=None,
    key=None,
    use_pallas: Optional[bool] = None,
    device_loop: bool = True,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """NMF via alternating non-negative least squares.

    Reference-compatible keyword surface (nmf/anls.py:50-52) plus
    ``nnls_solver`` in {'activeset', 'bpp'} and the usual extensions.

    ``nnls_opts`` (activeset only) tunes the inner NNLS throughput/quality
    trade-off: ``max_outer`` (default 5k+10, exact), ``inner_cap``,
    ``opt_tol_ulps`` (CG dual tolerance; default 100).  A handful of
    degenerate columns can cycle on CG-noise duals until the bound;
    ``dict(max_outer=16, opt_tol_ulps=1000.0)`` stops them early at a
    small cost in objective.
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if nnls_solver not in ("activeset", "bpp"):
        raise ValueError("nnls_solver must be 'activeset' or 'bpp'")
    row = defaults()
    if masked_solver is None:
        masked_solver = row.spd_solver
    if masked_solver not in ("chol", "cg"):
        raise ValueError("masked_solver must be 'chol' or 'cg'")
    nnls_opts = dict(nnls_opts or {})
    if nnls_opts and nnls_solver == "bpp":
        raise ValueError(
            "nnls_opts applies to the active-set solver only; it would be "
            "silently ignored with nnls_solver='bpp'")
    if nnls_solver == "activeset":
        if masked_solver == "cg":
            nnls_opts.setdefault("cg_iters", row.cg_iters)
        if row.nnls_precision is not None:
            nnls_opts.setdefault("precision", row.nnls_precision)
    nnls_opts_t = tuple(sorted(nnls_opts.items()))

    x = jnp.asarray(x)
    use_pallas = use_kernels(x, k, use_pallas)

    experiment = AnlsExperiment(
        method="anls",
        components=k,
        distance_type=distance_type,
        nndsvd_init=nndsvd_init,
        max_iter=max_iter,
        tol1=tol1,
        tol2=tol2,
        lambda_w=lambda_w,
        lambda_h=lambda_h,
        fcnnls=use_fcnnls,
    )

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None and h_init is not None:
        w = jnp.asarray(w_init, dtype=x.dtype)
        h = jnp.asarray(h_init, dtype=x.dtype)
    elif nndsvd_init[0]:
        w, h = nndsvd(x, k, variant=nndsvd_init[1], key=key)
    else:
        # reference uses U[0,1) for ANLS (nmf/anls.py:104-105)
        w, h = random_init(
            key if key is not None else jax.random.PRNGKey(0),
            x.shape[0], x.shape[1], k, kind="uniform", dtype=x.dtype,
        )

    obj0 = distance(x, w @ h, distance_type)
    carry = init_carry(obj0, max_iter, (w, h))

    if device_loop:
        run = lambda c, stop: _anls_block(
            x, c, stop, tol1, tol2, lambda_w, lambda_h,
            k=k,
            distance_type=distance_type,
            nnls_solver=nnls_solver,
            solve_method=masked_solver,
            nnls_opts_t=nnls_opts_t,
            min_iter=min_iter,
            max_iter=max_iter,
            use_pallas=use_pallas,
            verbose=verbose_precision(verbose, tol1, tol2),
        )
    else:
        # host-driven block with while_block-identical semantics: one
        # _anls_iter dispatch per iteration, same LoopCarry in/out, so
        # run_loop's checkpoint/resume/callback machinery is shared with
        # every other solver instead of a duplicated driver
        from ..core.convergence import convergence_check

        def run(c: LoopCarry, stop) -> LoopCarry:
            w, h = c.inner
            i = int(c.i)
            obj_buf = np.asarray(c.obj_buf).copy()
            obj_prev = float(c.obj)
            conv = bool(c.converged)
            while i < min(int(stop), max_iter) and not conv:
                w, h, obj = _anls_iter(
                    x, w, h, lambda_w, lambda_h, k=k,
                    distance_type=distance_type, nnls_solver=nnls_solver,
                    solve_method=masked_solver, nnls_opts_t=nnls_opts_t,
                    use_pallas=use_pallas,
                )
                obj = float(obj)
                obj_buf[i + 1] = obj
                conv = i > min_iter and bool(
                    convergence_check(obj, obj_prev, tol1, tol2)
                )
                if verbose:
                    prec = verbose_precision(True, tol1, tol2)
                    print(f"[{i}]: {obj:.{prec}f}")
                obj_prev = obj
                i += 1
            return LoopCarry(
                i=jnp.asarray(i, jnp.int32),
                obj=jnp.asarray(obj_prev, dtype=c.obj.dtype),
                converged=jnp.asarray(conv),
                obj_buf=jnp.asarray(obj_buf),
                inner=(w, h),
            )

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        # nnls_solver / nnls_opts / masked_solver change the optimization
        # trajectory but aren't Experiment fields — include them so a
        # checkpoint from a different NNLS configuration is rejected
        config_tag=repr(experiment)
        + f"|nnls={nnls_solver},{masked_solver},{nnls_opts_t}",
    )

    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(
        w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
        experiment=experiment,
    )
