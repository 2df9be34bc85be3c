"""Generalized beta-divergence MUR (Fevotte-Idier).

Beyond-reference capability: the reference offers only Euclidean (beta=2)
and KL (beta=1) objectives (nmf/utils.py:18-33).  The beta-divergence
family interpolates and extends them — beta=0 is Itakura-Saito (the
standard audio/spectrogram objective, scale-invariant):

    d_beta(x|y) = x/y - log(x/y) - 1                          (beta = 0)
                  x log(x/y) - x + y                          (beta = 1)
                  (x^b + (b-1) y^b - b x y^(b-1)) / (b(b-1))  (otherwise)

Updates are the majorize-minimize multiplicative rules with the
Fevotte-Idier convergence exponent gamma(beta) (gamma=1 on [1,2],
1/(2-beta) below 1, 1/(beta-1) above 2) applied to the update ratio:

    H <- H ⊙ ( W^T((WH)^(beta-2) ⊙ X) / (W^T (WH)^(beta-1)) )^gamma

At beta=2 and beta=1 (lambda=0) this reproduces the reference EU/KL MUR
iterates up to epsilon-guard placement and float reassociation (the
dedicated solvers use the Gram trick / closed forms), which the tests
pin to ~1e-6.  lambda_w /
lambda_h are ridge terms added to the denominators — the same heuristic
form the reference uses for EU (nmf/mur.py:29); exact closed-form
regularization exists only for beta in {1, 2} (use solvers/mur.py).

Device mapping: per iteration, 2 elementwise powers over the m x n
reconstruction + 4 GEMMs, all XLA-fused; the loop is the shared jitted
while_loop driver.
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


def beta_divergence(x, wh, beta: float):
    """Elementwise-summed beta-divergence with the package's masking
    semantics (non-finite log terms at x=0 contribute zero, matching the
    KL convention of nmf/utils.py:21-26)."""
    x = jnp.asarray(x)
    wh = jnp.asarray(wh)
    if beta == 1.0:
        val = x * jnp.log(x / wh)
        val = jnp.where(val == jnp.inf, 0.0, val)
        val = jnp.where(jnp.isnan(val), 0.0, val)
        return jnp.sum(val - x + wh)
    if beta == 2.0:
        d = x - wh
        return 0.5 * jnp.sum(d * d)
    if beta == 0.0:
        r = x / wh
        val = r - jnp.log(r) - 1.0
        return jnp.sum(jnp.where(x > 0, val, 0.0))
    b = beta
    return jnp.sum(
        (x ** b + (b - 1.0) * wh ** b - b * x * wh ** (b - 1.0))
        / (b * (b - 1.0)))


def _gamma(beta: float) -> float:
    if beta < 1.0:
        return 1.0 / (2.0 - beta)
    if beta > 2.0:
        return 1.0 / (beta - 1.0)
    return 1.0


@partial(
    jax.jit,
    static_argnames=("beta", "min_iter", "max_iter", "verbose"),
)
def _mur_beta_block(x, carry: LoopCarry, stop_i, tol1, tol2, lambda_w,
                    lambda_h, *, beta: float, min_iter: int, max_iter: int,
                    verbose: bool):
    g = _gamma(beta)

    def ratio_parts(wh):
        # (WH)^(beta-2) ⊙ X and (WH)^(beta-1), with the eps guard keeping
        # negative powers finite at wh ~ 0
        whs = wh + _EPS
        return whs ** (beta - 2.0) * x, whs ** (beta - 1.0)

    def step(inner, i):
        w, h = inner
        num, den = ratio_parts(w @ h)
        ratio_w = (num @ h.T) / (den @ h.T + lambda_w * w + _EPS)
        w = w * (ratio_w ** g if g != 1.0 else ratio_w)
        num, den = ratio_parts(w @ h)
        ratio_h = (w.T @ num) / (w.T @ den + lambda_h * h + _EPS)
        h = h * (ratio_h ** g if g != 1.0 else ratio_h)
        return (w, h), beta_divergence(x, w @ h, beta)

    return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                       max_iter=max_iter, verbose=verbose)


def mur_beta(
    x,
    k: int,
    *,
    beta: float = 1.0,
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
    """NMF minimizing the beta-divergence (beta=0 Itakura-Saito,
    1 KL, 2 Euclidean, any real in between/beyond).

    Kwargs mirror :func:`tpunmf.solvers.mur`.  Itakura-Saito (and any
    beta < 1) requires strictly positive reconstructions; data zeros are
    fine (masked in the objective) but all-zero rows/columns should be
    filtered upstream.  Generated (NNDSVD) inits are nudged to strictly
    positive automatically when beta < 1; an explicit ``w_init/h_init``
    whose reconstruction has zero cells is rejected up front (negative
    powers of those cells would NaN the very first update).
    """
    x = jnp.asarray(x)
    beta = float(beta)
    x = x + jnp.maximum(-jnp.min(x), jnp.asarray(0.0, dtype=x.dtype))

    dist_tag = {0.0: "is", 1.0: "kl", 2.0: "eu"}.get(beta, f"beta{beta:g}")
    experiment = MurExperiment(
        method="mur", components=k, distance_type=dist_tag,
        nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=lambda_w, lambda_h=lambda_h,
    )

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None:
        w = jnp.asarray(w_init, dtype=x.dtype)
        h = jnp.asarray(h_init, dtype=x.dtype)
        if beta < 1.0 and float(jnp.min(w @ h)) <= 0.0:
            raise ValueError(
                "beta < 1 needs a strictly positive init reconstruction: "
                "min(w_init @ h_init) <= 0 would raise zero cells to a "
                "negative power and NaN the run. Nudge the inits to a "
                "small positive floor (e.g. jnp.maximum(w, 1e-6)).")
    elif nndsvd_init[0]:
        w, h = nndsvd(x, k, variant=nndsvd_init[1], key=key)
        if beta < 1.0:
            # negative powers of WH: zero cells in the init reconstruction
            # would overwhelm the eps guard — nudge like HALS does
            w = jnp.maximum(w, 1e-6)
            h = jnp.maximum(h, 1e-6)
    else:
        w, h = random_init(
            key if key is not None else jax.random.PRNGKey(0),
            x.shape[0], x.shape[1], k, kind="abs_normal", dtype=x.dtype,
        )

    obj0 = beta_divergence(x, w @ h, beta)
    carry = init_carry(obj0, max_iter, (w, h))
    run = lambda c, stop: _mur_beta_block(
        x, c, stop, tol1, tol2, lambda_w, lambda_h, beta=beta,
        min_iter=min_iter, max_iter=max_iter, verbose=verbose,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + f"|beta={beta:g}",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=np.asarray(w), h=np.asarray(h), i=i,
                   obj_history=obj_history, experiment=experiment)
