"""Masked (weighted) MUR — factorize only the OBSERVED entries of X.

Beyond-reference capability: the reference always fits every cell of a
dense X (nmf/mur.py), which is wrong for recommender-style data where
absent entries are unobserved, not zero.  With a binary (or weight)
mask M, the objectives become

    EU:  0.5 * || M ⊙ (X - WH) ||_F^2
    KL:  sum over observed cells of  x log(x / wh) - x + wh

and the Lee-Seung updates keep their multiplicative form with M folded
into the numerator/denominator cross-products (Zhang et al., "weighted
NMF"):

    EU:  W <- W ⊙ ((M⊙X) Hᵀ) / ((M⊙(WH)) Hᵀ + λW + eps)
    KL:  W <- 2a / (b + sqrt(b² + 4 λ a)),  a = W ⊙ ((M⊙X/(WH+eps)) Hᵀ),
         b = M Hᵀ   (the mask replaces ones_like(x) in nmf/mur.py:26)

Monotonicity of the masked objective follows from the same
majorize-minimize argument as unmasked MUR (the mask only re-weights
each cell's convex term).  With M = ones this reduces exactly to
solvers/mur.py's updates.  M⊙(WH) forces one extra m x n elementwise
pass per half-update — 4 GEMM+mask passes per iteration; XLA fuses the
mask products into the GEMM operands.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from .common import LoopCarry, finalize_history, init_carry, run_loop, while_block

_EPS = 1e-9


def _masked_eu_obj(x, mask, w, h):
    d = mask * (x - w @ h)
    return 0.5 * jnp.sum(d * d)


def _masked_kl_obj(x, mask, w, h):
    # reference masking semantics (nmf/utils.py:21-26) restricted to the
    # observed cells: unobserved cells contribute nothing at all
    wh = w @ h
    val = x * jnp.log(x / wh)
    val = jnp.where(val == jnp.inf, 0.0, val)
    val = jnp.where(jnp.isnan(val), 0.0, val)
    return jnp.sum(mask * (val - x + wh))


@partial(
    jax.jit,
    static_argnames=("distance_type", "min_iter", "max_iter", "verbose"),
)
def _mur_masked_block(x, mask, carry: LoopCarry, stop_i, tol1, tol2,
                      lambda_w, lambda_h, *, distance_type: str,
                      min_iter: int, max_iter: int, verbose: bool):
    def step_eu(inner, i):
        w, h = inner
        mx_ht = (mask * x) @ h.T               # constant per W-update
        w = w * mx_ht / ((mask * (w @ h)) @ h.T + lambda_w * w + _EPS)
        wt_mx = w.T @ (mask * x)
        h = h * wt_mx / (w.T @ (mask * (w @ h)) + lambda_h * h + _EPS)
        return (w, h), _masked_eu_obj(x, mask, w, h)

    def step_kl(inner, i):
        # fully-unobserved rows/columns (cold users/items) zero both the
        # numerator and denominator — any value is optimal there, so the
        # factor entry is left unchanged instead of 0/0 -> NaN
        w, h = inner
        r = mask * x / (w @ h + _EPS)
        a = w * (r @ h.T)
        b = mask @ h.T                         # replaces ones @ h.T
        den = b + jnp.sqrt(b * b + 4.0 * lambda_w * a)
        w = jnp.where(den > 0, 2.0 * a / jnp.where(den > 0, den, 1.0), w)
        r2 = mask * x / (w @ h + _EPS)
        c = h * (w.T @ r2)
        d = w.T @ mask                         # replaces w.T @ ones
        den = d + jnp.sqrt(d * d + 4.0 * lambda_h * c)
        h = jnp.where(den > 0, 2.0 * c / jnp.where(den > 0, den, 1.0), h)
        return (w, h), _masked_kl_obj(x, mask, w, h)

    step = step_kl if distance_type == "kl" else step_eu
    return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                       max_iter=max_iter, verbose=verbose)


def mur_masked(
    x,
    mask,
    k: int,
    *,
    distance_type: str = "kl",
    min_iter: int = 100,
    max_iter: int = 100000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    nndsvd_init=(False, "zero"),
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
    """Weighted/masked MUR: fit W @ H to the observed cells of x only.

    ``mask`` is an (m, n) array — boolean observation indicator or
    non-negative per-cell weights.  Unobserved cells of ``x`` may hold
    any FINITE filler (0 is conventional) — they are multiplied out, but
    NaN/inf fillers would poison the masked products.  All other kwargs
    match :func:`tpunmf.solvers.mur`.  With an all-ones mask the
    iterates equal the unmasked solver's exactly.
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    x = jnp.asarray(x)
    if mask is None:
        raise ValueError("mur_masked requires a mask; use mur() without one")
    mask = jnp.asarray(mask, dtype=x.dtype)
    if mask.shape != x.shape:
        raise ValueError(f"mask shape {mask.shape} != data shape {x.shape}")

    # negative-data elevation over the OBSERVED cells only
    xmin = jnp.min(jnp.where(mask > 0, x, jnp.inf))
    x = x + jnp.maximum(-xmin, jnp.asarray(0.0, dtype=x.dtype))

    experiment = MurExperiment(
        method="mur", components=k, distance_type=distance_type,
        nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=lambda_w, lambda_h=lambda_h,
    )

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None:
        w = jnp.asarray(w_init, dtype=x.dtype)
        h = jnp.asarray(h_init, dtype=x.dtype)
    elif nndsvd_init[0]:
        # NNDSVD on the zero-filled observed matrix (the standard choice)
        w, h = nndsvd(x * mask, k, variant=nndsvd_init[1], key=key)
    else:
        w, h = random_init(
            key if key is not None else jax.random.PRNGKey(0),
            x.shape[0], x.shape[1], k, kind="abs_normal", dtype=x.dtype,
        )

    obj0 = (_masked_kl_obj if distance_type == "kl" else _masked_eu_obj)(
        x, mask, w, h)
    carry = init_carry(obj0, max_iter, (w, h))
    run = lambda c, stop: _mur_masked_block(
        x, mask, c, stop, tol1, tol2, lambda_w, lambda_h,
        distance_type=distance_type, min_iter=min_iter, max_iter=max_iter,
        verbose=verbose,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + "|masked",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=np.asarray(w), h=np.asarray(h), i=i,
                   obj_history=obj_history, experiment=experiment)
