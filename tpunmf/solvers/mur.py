"""MUR — Lee-Seung multiplicative update rules.

Behavioral contract matches the reference solver (reference: nmf/mur.py:52-146):
same update formulas (nmf/mur.py:20-49) including the regularized KL closed
form ``2a / (b + sqrt(b^2 + 4*lambda*a))``, the 1e-9 guards, negative-data
elevation (nmf/mur.py:99-102), defaults, convergence semantics and the
``Results`` record.

Redesigned, not translated — per-iteration cost drops from the
reference's ~10 m*n*k-equivalent GEMM passes to 2 (EU) / 3 (KL) passes
over X:

  * EU denominators use the Gram trick: ``(W@H)@H.T == W@(H@H.T)`` and
    ``W.T@(W@H) == (W.T@W)@H`` — k x k Grams instead of m*n intermediates.
  * KL's ``ones_like(x) @ h.T`` (nmf/mur.py:26) is just a broadcast row-sum
    of H (and ``w.T @ ones`` a column-sum of W) — no m*n GEMM at all.
  * KL on the GPU runs as three fused passes (W update, H update,
    objective; ops/fused.py) that never write the m x n ratio to device
    memory.  The XLA step instead carries the ratio ``x / (wh + 1e-9)``
    for the *next* W-update out of the pass that evaluates the objective.
  * The whole loop body is jitted and driven by ``lax.while_loop`` with the
    convergence predicate fused in (see solvers/common.py).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.losses import eu_elementwise_sum, eu_objective_gram, kl_elementwise_sum
from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from ..core.backend import use_kernels
from ..ops.fused import (eu_residual_obj, kl_h_update, kl_obj, kl_ratio,
                         kl_ratio_and_obj, kl_w_update)
from .common import (  # noqa: F401
    verbose_precision,
    LoopCarry,
    finalize_history,
    host_array,
    init_carry,
    run_loop,
    while_block,
)

_EPS = 1e-9


@partial(
    jax.jit,
    static_argnames=(
        "distance_type",
        "min_iter",
        "max_iter",
        "objective",
        "use_pallas",
        "objective_every",
        "verbose",
    ),
)
def _mur_block(
    x,
    xsq,
    carry: LoopCarry,
    stop_i,
    tol1,
    tol2,
    lambda_w,
    lambda_h,
    *,
    distance_type: str,
    min_iter: int,
    max_iter: int,
    objective: str,
    use_pallas: bool,
    objective_every: int = 1,
    verbose: bool,
):
    # Objective cadence (opt-in, objective_every > 1): the objective is
    # computed/recorded only on refresh iterations — every N-th, plus the
    # run's last possible iteration (the static max_iter bound) so the
    # final entry is real whenever the budget runs out.  The gate is
    # deliberately NOT the per-block stop_i: blocked execution
    # (block_size / checkpoint_path) must record the same trace and stop
    # at the same iteration as a single-dispatch run (common.py's
    # invariant), so block boundaries add no extra real objectives.
    # Convergence stops record a real objective by construction (the
    # check only fires on real values), preserving the
    # final-entry-is-real guarantee on every exit path OF THE PUBLIC
    # mur() DRIVER (whose terminal block's stop bound is max_iter).  A
    # direct _mur_block caller whose terminal stop_i < max_iter sees the
    # raw cadence trace — its last entry may be NaN; carry.obj still
    # holds the last real objective (while_block's NaN-hold).  Skipped
    # iterations record NaN, which while_block treats as "no
    # observation" (the convergence comparison holds the last real
    # value).  For KL this removes the elementwise log pass from skipped
    # iterations.
    obj_dtype = carry.obj.dtype
    _nan = jnp.full((), jnp.nan, dtype=obj_dtype)

    def _refresh(i):
        return jnp.logical_or((i + 1) % objective_every == 0,
                              i + 1 >= max_iter)

    def cadence_obj(i, fn):
        """fn() -> scalar objective; skipped (-> NaN) off-cadence."""
        if objective_every == 1:
            return fn().astype(obj_dtype)
        return jax.lax.cond(
            _refresh(i),
            lambda _: fn().astype(obj_dtype),
            lambda _: _nan,
            operand=None,
        )
    def step_kl_fused(inner, i):
        """KL iteration as 3 fused passes over x (2 with the lagged
        objective); the ratio is formed tile-wise in-kernel, never
        written to device memory (ops/fused.py).

        objective='lagged': the W pass emits KL of the incoming iterate
        for free, so the trailing objective pass is dropped — the
        recorded objective (and hence the convergence stop) lags one
        iteration.
        """
        w, h = inner
        if objective == "lagged":
            if objective_every == 1:
                with jax.named_scope("mur_w_update"):
                    w, obj_prev = kl_w_update(x, w, h, lambda_w, with_obj=True)
            else:
                # off-cadence W passes run the objective-free kernel,
                # which drops the elementwise log from skipped iterations
                def _w_with_obj(wh):
                    wn, o = kl_w_update(x, wh[0], wh[1], lambda_w,
                                        with_obj=True)
                    return wn, o.astype(obj_dtype)

                def _w_skip_obj(wh):
                    return kl_w_update(x, wh[0], wh[1], lambda_w), _nan

                with jax.named_scope("mur_w_update"):
                    w, obj_prev = jax.lax.cond(
                        _refresh(i), _w_with_obj, _w_skip_obj, (w, h))
            with jax.named_scope("mur_h_update"):
                h = kl_h_update(x, w, h, lambda_h)
            return (w, h), obj_prev
        with jax.named_scope("mur_w_update"):
            w = kl_w_update(x, w, h, lambda_w)
        with jax.named_scope("mur_h_update"):
            h = kl_h_update(x, w, h, lambda_h)
        with jax.named_scope("objective"):
            obj = cadence_obj(i, lambda: kl_obj(x, w, h, use_pallas=True))
        return (w, h), obj

    def step_eu(inner, i):
        w, h = inner
        gram_h = h @ h.T
        w = w * (x @ h.T) / (w @ gram_h + lambda_w * w + _EPS)
        wtx = w.T @ x
        gram_w = w.T @ w
        h = h * wtx / (gram_w @ h + lambda_h * h + _EPS)
        if objective == "gram":
            obj = cadence_obj(i, lambda: eu_objective_gram(xsq, wtx, gram_w, h))
        else:
            obj = cadence_obj(i, lambda: eu_residual_obj(
                x, w, h, use_pallas=use_pallas))
        return (w, h), obj

    def step_kl(inner, i):
        w, h, r = inner  # r = x / (w@h + eps) from the previous trailing pass
        a = w * (r @ h.T)
        b = jnp.sum(h, axis=1)  # == row of ones_like(x) @ h.T (nmf/mur.py:26)
        w = 2.0 * a / (b[None, :] + jnp.sqrt(b[None, :] ** 2 + 4.0 * lambda_w * a))
        r2 = kl_ratio(x, w, h, eps=_EPS)
        c = h * (w.T @ r2)
        d = jnp.sum(w, axis=0)[:, None]  # == column of w.T @ ones_like(x)
        h = 2.0 * c / (d + jnp.sqrt(d * d + 4.0 * lambda_h * c))
        if objective_every == 1:
            r, obj = kl_ratio_and_obj(x, w, h, eps=_EPS)
        else:
            # off-cadence trailing passes skip the log term of the
            # objective (the ratio itself is still needed by the next
            # W-update)
            r, obj = jax.lax.cond(
                _refresh(i),
                lambda wh: (lambda ro: (ro[0], ro[1].astype(obj_dtype)))(
                    kl_ratio_and_obj(x, wh[0], wh[1], eps=_EPS)),
                lambda wh: (kl_ratio(x, wh[0], wh[1], eps=_EPS), _nan),
                (w, h),
            )
        return (w, h, r), obj

    if distance_type == "eu":
        step = step_eu
    else:
        step = step_kl_fused if use_pallas else step_kl
    return while_block(
        step,
        carry,
        stop_i,
        tol1,
        tol2,
        min_iter=min_iter,
        max_iter=max_iter,
        verbose=verbose,
    )


def mur(
    x,
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
    save_dir: str = "./results/",
    # --- extensions beyond the reference surface ---
    w_init=None,
    h_init=None,
    key=None,
    objective: str = "exact",
    objective_every: int = 1,
    data_dtype=None,
    use_pallas: Optional[bool] = None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """Non-negative matrix factorization via multiplicative update rules.

    Reference-compatible keyword surface (nmf/mur.py:52-53) plus:
      w_init/h_init: explicit initial factors (for parity/benchmark runs).
      key: jax PRNG key for random init (reference used global numpy RNG).
      objective: 'exact' (elementwise residual; robust at f32), 'gram'
        (Gram-trick EU objective — no extra m*n pass, use for speed) or
        'lagged' (KL on the kernel path: the W pass records the
        objective of the incoming iterate, dropping the objective pass).
      objective_every: compute/record the objective only every N-th
        iteration (plus the final one); skipped iterations record NaN in
        obj_history and the convergence check compares across the gap
        (so tol2 applies per CHECK, i.e. per N iterations — an opt-in
        semantic relaxation).  For KL this removes the objective's
        elementwise log from skipped iterations.  Default 1 = reference
        semantics.
      data_dtype: optional storage dtype for x (e.g. jnp.bfloat16 — halves
        HBM traffic per pass; factors stay float32).
      use_pallas: force the fused Pallas passes (ops/fused.py) on or off;
        default: the backend's row in core/backend.py.  True on a
        backend without the kernels raises.  A sharded x always takes
        the XLA step.
      block_size/on_block_end: blocked execution for checkpoint callbacks.
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    objective_every = int(objective_every)
    if objective_every < 1:
        raise ValueError("objective_every must be >= 1")

    x = jnp.asarray(x)

    experiment = MurExperiment(
        method="mur",
        components=k,
        distance_type=distance_type,
        nndsvd_init=nndsvd_init,
        max_iter=max_iter,
        tol1=tol1,
        tol2=tol2,
        lambda_w=lambda_w,
        lambda_h=lambda_h,
    )

    # data elevation for slightly-negative inputs (nmf/mur.py:99-102),
    # computed on device: max(-min(x), 0) is the shift, 0 when x >= 0, so
    # no host round-trip is needed
    x = x + jnp.maximum(-jnp.min(x), jnp.asarray(0.0, dtype=x.dtype))
    if data_dtype is not None:
        x = x.astype(data_dtype)
    factor_dtype = jnp.float32 if x.dtype == jnp.bfloat16 else x.dtype
    use_pallas = use_kernels(x, k, use_pallas)

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None and h_init is not None:
        w = jnp.asarray(w_init, dtype=factor_dtype)
        h = jnp.asarray(h_init, dtype=factor_dtype)
    elif nndsvd_init[0]:
        w, h = nndsvd(x.astype(factor_dtype), k, variant=nndsvd_init[1], key=key)
    else:
        w, h = random_init(
            key if key is not None else jax.random.PRNGKey(0),
            x.shape[0],
            x.shape[1],
            k,
            kind="abs_normal",
            dtype=factor_dtype,
        )

    if distance_type == "eu" and objective == "gram":
        xf = x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x
        xsq = jnp.sum(xf * xf)
    else:
        xsq = jnp.zeros((), dtype=factor_dtype)

    if distance_type == "kl":
        if use_pallas:
            obj0 = kl_obj(x, w, h, use_pallas=True)
            inner = (w, h)
        else:
            r0, obj0 = kl_ratio_and_obj(x, w, h, eps=_EPS)
            inner = (w, h, r0)
    else:
        obj0 = eu_residual_obj(x, w, h, use_pallas=use_pallas)
        inner = (w, h)

    carry = init_carry(obj0, max_iter, inner)

    run = lambda c, stop: _mur_block(
        x,
        xsq,
        c,
        stop,
        tol1,
        tol2,
        lambda_w,
        lambda_h,
        distance_type=distance_type,
        min_iter=min_iter,
        max_iter=max_iter,
        objective=objective,
        use_pallas=use_pallas,
        objective_every=objective_every,
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
        experiment=experiment
    )
