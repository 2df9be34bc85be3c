"""Semi-NMF (Ding-Li-Jordan 2010).

Beyond-reference capability: every reference solver requires (or forces,
via elevation — nmf/mur.py:99-102) non-negative data.  Semi-NMF
factorizes MIXED-SIGN X as ``W @ H`` with W unconstrained and H >= 0 —
the principled treatment of centered/standardized data, where elevation
distorts the geometry:

    W-update (exact least squares, free sign):
        W = X H^T (H H^T)^{-1}
    H-update (multiplicative, provably monotone for 0.5 exponent):
        H <- H ⊙ sqrt( ((W^T X)^+ + (W^T W)^- H) /
                       ((W^T X)^- + (W^T W)^+ H + eps) )
    with A^+ = (|A| + A)/2, A^- = (|A| - A)/2.

Per iteration: 2 m*n*k GEMMs + one k x k solve — same GEMM shape as
EU-MUR.  Driver semantics (convergence, history, checkpointing) are the
shared solvers/common machinery.
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


def _pos(a):
    return (jnp.abs(a) + a) * 0.5


def _neg(a):
    return (jnp.abs(a) - a) * 0.5


@partial(jax.jit, static_argnames=("min_iter", "max_iter", "verbose"))
def _semi_block(x, carry: LoopCarry, stop_i, tol1, tol2, lambda_h, *,
                min_iter: int, max_iter: int, verbose: bool):
    k = carry.inner[1].shape[0]

    def step(inner, i):
        w, h = inner
        # --- W: exact least squares against the current H (free sign);
        # ridge keeps the k x k Gram SPD when H rows are degenerate
        gram_h = h @ h.T + 1e-10 * jnp.eye(k, dtype=h.dtype)
        w = jax.scipy.linalg.solve(gram_h, (x @ h.T).T, assume_a="pos").T
        # --- H: split-sign multiplicative update with the sqrt exponent
        wtx = w.T @ x
        wtw = w.T @ w
        numer = _pos(wtx) + _neg(wtw) @ h
        denom = _neg(wtx) + _pos(wtw) @ h + lambda_h * h + _EPS
        h = h * jnp.sqrt(numer / denom)
        d = x - w @ h
        return (w, h), 0.5 * jnp.sum(d * d)

    return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                       max_iter=max_iter, verbose=verbose)


def semi_nmf(
    x,
    k: int,
    *,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_h: float = 0.0,
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
    """Semi-NMF: ``x ~ w @ h`` with w FREE-SIGN and h >= 0.

    Accepts mixed-sign data directly (no elevation).  ``lambda_h`` adds a
    Tikhonov term on H's update denominator.  Other kwargs mirror the
    shared solver surface.  Init defaults to k-means-free random: h from
    |N(0,1)| and w from one exact LS solve against it.
    """
    x = jnp.asarray(x)
    m, n = x.shape

    experiment = MurExperiment(
        method="semi_nmf", components=k, distance_type="eu",
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1,
        tol2=tol2, lambda_w=0.0, lambda_h=lambda_h,
    )

    if (w_init is None) != (h_init is None) and w_init is not None:
        raise ValueError("pass h_init when passing w_init")
    if h_init is not None:
        h = jnp.asarray(h_init, dtype=x.dtype)
        w = (jnp.asarray(w_init, dtype=x.dtype) if w_init is not None
             else jnp.linalg.lstsq(h.T, x.T)[0].T)
    else:
        h = jnp.abs(jax.random.normal(
            key if key is not None else jax.random.PRNGKey(0),
            (k, n), dtype=x.dtype))
        w = jnp.linalg.lstsq(h.T, x.T)[0].T

    d = x - w @ h
    obj0 = 0.5 * jnp.sum(d * d)
    carry = init_carry(obj0, max_iter, (w, h))
    run = lambda c, stop: _semi_block(
        x, c, stop, tol1, tol2, lambda_h, min_iter=min_iter,
        max_iter=max_iter, verbose=verbose,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + "|semi",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=np.asarray(w), h=np.asarray(h), i=i,
                   obj_history=obj_history, experiment=experiment)
