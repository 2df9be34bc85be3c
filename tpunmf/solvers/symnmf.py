"""Symmetric NMF — factorize a similarity/affinity matrix as H H^T.

Beyond-reference capability: minimizes ``||A - H H^T||_F^2`` with
``H >= 0`` for a symmetric non-negative A (kernel/affinity/adjacency) —
the graph-clustering member of the NMF family (equivalent to a relaxed
kernel k-means; Ding, He & Simon SDM 2005).  Update rule after Kuang,
Yun & Park ("SymNMF", J. Glob. Optim. 2015, eq. 9), the damped
multiplicative rule with the 1/2-mixing that guarantees non-increase:

    H <- H * ( (1 - beta) + beta * (A H) / (H (H^T H)) ),  beta = 1/2

Device mapping: one (n, n) @ (n, k) GEMM plus k x k algebra per iteration;
the denominator groups as ``H (H^T H)`` so nothing n x n beyond A is
formed.  Compose with :func:`tpunmf.solvers.knn_graph` to cluster raw
data columns.
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


@partial(
    jax.jit,
    static_argnames=("min_iter", "max_iter", "verbose"),
)
def _symnmf_block(a, asq, carry: LoopCarry, stop_i, tol1, tol2, beta, *,
                  min_iter: int, max_iter: int, verbose: bool):
    def step(inner, i):
        (h,) = inner
        ah = a @ h
        denom = h @ (h.T @ h) + _EPS
        h = h * ((1.0 - beta) + beta * ah / denom)
        # ||A - H H^T||^2 via Grams: ||A||^2 - 2 <H, AH> + ||H^T H||^2
        g = h.T @ h
        obj = asq - 2.0 * jnp.vdot(h, a @ h) + jnp.vdot(g, g)
        return (h,), obj

    return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                       max_iter=max_iter, verbose=verbose)


def symnmf(
    a,
    k: int,
    *,
    beta: float = 0.5,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    h_init=None,
    key=None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """Symmetric NMF ``A ~ H H^T`` (Kuang-Yun-Park damped rule).

    Args:
      a: (n, n) symmetric non-negative similarity matrix.
      beta: damping in (0, 1]; 1/2 is the provably non-increasing choice.

    Returns ``Results`` with ``w = H`` (n x k) and ``h = H^T`` — cluster
    labels are ``H.argmax(1)``.
    """
    a = jnp.asarray(a)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"A must be square; got {a.shape}")
    if not 0.0 < beta <= 1.0:
        raise ValueError("beta must be in (0, 1]")
    if bool(jnp.any(a < 0)):
        raise ValueError("A must be non-negative")

    if h_init is not None:
        h = jnp.asarray(h_init, dtype=a.dtype)
        if h.shape != (n, k):
            raise ValueError(f"h_init must be ({n}, {k})")
    else:
        kk = key if key is not None else jax.random.PRNGKey(0)
        # Kuang et al. §5 init: uniform on [0, sqrt(mean(A)/k)]
        scale = jnp.sqrt(jnp.mean(a) / k)
        h = jax.random.uniform(kk, (n, k), dtype=a.dtype) * scale

    experiment = MurExperiment(
        method="symnmf", components=k, distance_type="eu-sym",
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1,
        tol2=tol2, lambda_w=float(beta), lambda_h=0.0,
    )

    asq = jnp.vdot(a, a)
    g0 = h.T @ h
    obj0 = asq - 2.0 * jnp.vdot(h, a @ h) + jnp.vdot(g0, g0)
    carry = init_carry(obj0, max_iter, (h,))
    run = lambda c, stop: _symnmf_block(
        a, asq, c, stop, tol1, tol2, jnp.asarray(beta, dtype=a.dtype),
        min_iter=min_iter, max_iter=max_iter, verbose=verbose,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + f"|symnmf:beta={beta:g}",
    )
    (h,) = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=np.asarray(h), h=np.asarray(h.T), i=i,
                   obj_history=obj_history, experiment=experiment)
