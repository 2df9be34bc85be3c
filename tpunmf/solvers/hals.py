"""HALS — hierarchical alternating least squares (accelerated).

Beyond-reference capability: the reference package has no HALS solver
(its families are MUR/ANLS/ADMM/AO-ADMM, nmf/nmf.py:48-80), but HALS is
the standard fast first-order NMF method — per sweep it solves every
rank-1 subproblem in closed form,

    W[:, l] <- max(0, W[:, l] + (XHt[:, l] - W @ HHt[:, l]) / HHt[l, l]),

and converges in far fewer sweeps than MUR on the Euclidean objective.
Implemented after Cichocki-Phan HALS with the Gillis-Glineur
acceleration (arXiv:1107.5194): the expensive cross-products
``XHt = X @ H^T`` (m*n*k FLOPs) and the k x k Gram are computed ONCE per
outer iteration, then the cheap column sweep (m*k^2 FLOPs) is repeated
``inner_sweeps`` times against them — at rank << n the sweeps are nearly
free, so each extra sweep buys convergence at ~zero HBM cost (the
accelerated regime the paper derives as rho = 1 + mn/(m k + n)).

Device mapping: the column sweep is a ``lax.fori_loop`` over k with
dynamic-slice column reads and rank-1 updates — a chain of k dependent
(m, k) @ (k,) matvecs; the two m*n*k GEMMs per iteration read X once
each, so HALS costs the same device-memory traffic per outer iteration
as EU-MUR while decreasing the objective faster.

Euclidean objective only (HALS is a least-squares coordinate method;
use MUR/ADMM for KL).  Driver semantics (convergence, history,
checkpointing) are identical to the other solvers via solvers/common.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.losses import eu_objective_gram
from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from ..ops.fused import eu_residual_obj
from .common import (LoopCarry, finalize_history, host_array,
                     init_carry, run_loop, while_block)

_EPS = 1e-16


def _hals_sweep_w(w, xht, hht, lam, unroll=1):
    """One HALS sweep over W's columns (rank-1 closed forms).

    The sweep is a Gauss-Seidel chain of k dependent small matvecs, so
    at large m it is LATENCY-bound, not FLOP-bound; ``unroll`` trades
    compile time for fewer loop-step dispatches."""
    k = w.shape[1]

    def col(l, w):
        # rank-1 closed form: the cross-product against all OTHER
        # components, (XHt_l - W @ HHt_l + w_l HHt_ll), over (HHt_ll + lam)
        denom = hht[l, l] + lam + _EPS
        numer = xht[:, l] - w @ hht[:, l] + w[:, l] * hht[l, l]
        return w.at[:, l].set(jnp.maximum(numer / denom, 0.0))

    return jax.lax.fori_loop(0, k, col, w, unroll=unroll)


def _hals_sweep_h(h, wtx, wtw, lam, unroll=1):
    """One HALS sweep over H's rows."""
    k = h.shape[0]

    def row(l, h):
        denom = wtw[l, l] + lam + _EPS
        numer = wtx[l, :] - wtw[l, :] @ h + wtw[l, l] * h[l, :]
        return h.at[l, :].set(jnp.maximum(numer / denom, 0.0))

    return jax.lax.fori_loop(0, k, row, h, unroll=unroll)


@partial(
    jax.jit,
    static_argnames=("min_iter", "max_iter", "inner_sweeps", "objective",
                     "verbose", "sweep_unroll"),
)
def _hals_block(x, xsq, carry: LoopCarry, stop_i, tol1, tol2, lambda_w,
                lambda_h, *, min_iter: int, max_iter: int, inner_sweeps: int,
                objective: str, verbose: bool, sweep_unroll: int = 1):
    def step(inner, i):
        w, h = inner
        # --- W half: one m*n*k GEMM + k x k Gram, then cheap sweeps
        xht = x @ h.T
        hht = h @ h.T
        w = jax.lax.fori_loop(
            0, inner_sweeps,
            lambda t, w: _hals_sweep_w(w, xht, hht, lambda_w, sweep_unroll), w
        )
        # --- H half (mirror)
        wtx = w.T @ x
        wtw = w.T @ w
        h = jax.lax.fori_loop(
            0, inner_sweeps,
            lambda t, h: _hals_sweep_h(h, wtx, wtw, lambda_h, sweep_unroll), h
        )
        if objective == "gram":
            obj = eu_objective_gram(xsq, wtx, wtw, h)
        else:
            obj = eu_residual_obj(x, w, h)
        return (w, h), obj

    return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                       max_iter=max_iter, verbose=verbose)


def hals(
    x,
    k: int,
    *,
    distance_type: str = "eu",
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    nndsvd_init=(True, "zero"),
    inner_sweeps: int = 2,
    sweep_unroll: int = 8,
    w_init=None,
    h_init=None,
    key=None,
    objective: str = "exact",
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """NMF via accelerated hierarchical ALS (Euclidean objective).

    Solver kwargs mirror the shared surface (min/max_iter, tol1/tol2,
    lambda_w/lambda_h as Tikhonov weights, nndsvd_init, w_init/h_init,
    checkpointing); ``inner_sweeps`` repeats the cheap column sweep per
    cross-product computation (Gillis-Glineur acceleration).
    """
    if distance_type != "eu":
        raise KeyError("HALS is Euclidean-only; use mur/admm for 'kl'.")
    if inner_sweeps < 1:
        raise ValueError("inner_sweeps must be >= 1")

    x = jnp.asarray(x)
    x = x + jnp.maximum(-jnp.min(x), jnp.asarray(0.0, dtype=x.dtype))

    experiment = MurExperiment(
        method="hals", components=k, distance_type="eu",
        nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=lambda_w, lambda_h=lambda_h,
    )

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None:
        w = jnp.asarray(w_init, dtype=x.dtype)
        h = jnp.asarray(h_init, dtype=x.dtype)
    else:
        if nndsvd_init[0]:
            w, h = nndsvd(x, k, variant=nndsvd_init[1], key=key)
        else:
            w, h = random_init(
                key if key is not None else jax.random.PRNGKey(0),
                x.shape[0], x.shape[1], k, kind="abs_normal", dtype=x.dtype,
            )
        # HALS divides by Gram diagonals: an all-zero H row (NNDSVD 'zero'
        # fill) would freeze its component forever; nudge generated inits
        # to a tiny positive (explicit w_init/h_init are left untouched)
        w = jnp.maximum(w, _EPS)
        h = jnp.maximum(h, _EPS)

    if objective == "gram":
        xf = x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x
        xsq = jnp.sum(xf * xf)
    else:
        xsq = jnp.zeros((), dtype=x.dtype)  # unused by the exact objective
    obj0 = eu_residual_obj(x, w, h)
    carry = init_carry(obj0, max_iter, (w, h))

    run = lambda c, stop: _hals_block(
        x, xsq, c, stop, tol1, tol2, lambda_w, lambda_h, min_iter=min_iter,
        max_iter=max_iter, inner_sweeps=inner_sweeps, objective=objective,
        sweep_unroll=sweep_unroll, verbose=verbose,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment)
        + f"|hals:sweeps={inner_sweeps},obj={objective}",
    )

    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i,
                   obj_history=obj_history, experiment=experiment)
