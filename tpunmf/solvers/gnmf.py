"""Graph-regularized NMF (GNMF) — manifold smoothness on the encodings.

Beyond-reference capability, after Cai, He, Han & Huang, "Graph
Regularized Non-negative Matrix Factorization for Data Representation"
(TPAMI 2011): minimizes

    0.5 ||X - W H||_F^2 + 0.5 * lambda_g * Tr(H L H^T),   L = D - A,

where A is a symmetric non-negative affinity over the n data columns
(e.g. a kNN heat-kernel graph) and D its degree diagonal — encodings of
similar columns are pulled together.  Multiplicative updates (their
eq. 14/15) keep the objective monotonically non-increasing:

    W <- W * (X H^T) / (W (H H^T))
    H <- H * (W^T X + lambda_g * H A) / ((W^T W) H + lambda_g * H D)

Device mapping: ``H A`` is one (k, n) @ (n, n) GEMM per iteration —
A is kept dense (a GEMM in place of a gather-heavy SpMM);
``H D`` is an elementwise row scale.  With ``lambda_g = 0`` the updates
reduce exactly to plain EU MUR.
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


def knn_graph(x, n_neighbors: int = 5, *, mode: str = "heat",
              sigma: float | None = None):
    """Symmetric kNN affinity over the COLUMNS of x (dense (n, n)).

    mode 'heat': exp(-||xi - xj||^2 / sigma) (sigma defaults to the mean
    squared neighbor distance); 'binary': 0/1 adjacency.  The graph is
    symmetrized with max(A, A^T); the diagonal is zeroed.
    """
    x = jnp.asarray(x)
    n = x.shape[1]
    if not 0 < n_neighbors < n:
        raise ValueError("need 0 < n_neighbors < n")
    sq = jnp.sum(x * x, axis=0)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x.T @ x)
    d2 = jnp.maximum(d2, 0.0)
    d2 = d2 + jnp.diag(jnp.full((n,), jnp.inf))      # exclude self
    # keep the n_neighbors smallest distances per row
    thresh = -jax.lax.top_k(-d2, n_neighbors)[0][:, -1]
    keep = d2 <= thresh[:, None]
    if mode == "binary":
        a = keep.astype(x.dtype)
    elif mode == "heat":
        if sigma is None:
            neigh = jnp.where(keep, d2, jnp.nan)
            sigma = jnp.nanmean(neigh)
        a = jnp.where(keep, jnp.exp(-d2 / sigma), 0.0).astype(x.dtype)
    else:
        raise ValueError("mode must be 'heat' or 'binary'")
    a = jnp.maximum(a, a.T)                          # symmetrize
    return a * (1.0 - jnp.eye(n, dtype=x.dtype))


def _gnmf_obj(x, w, h, a, deg, lam):
    d = x - w @ h
    # Tr(H L H^T) = sum_j deg_j ||h_j||^2 - sum_ij A_ij <h_i, h_j>
    smooth = jnp.sum(deg * jnp.sum(h * h, axis=0)) - jnp.vdot(h @ a, h)
    return 0.5 * jnp.sum(d * d) + 0.5 * lam * smooth


@partial(
    jax.jit,
    static_argnames=("min_iter", "max_iter", "verbose"),
)
def _gnmf_block(x, a, deg, carry: LoopCarry, stop_i, tol1, tol2, lam, *,
                min_iter: int, max_iter: int, verbose: bool):
    def step(inner, i):
        w, h = inner
        w = w * (x @ h.T) / (w @ (h @ h.T) + _EPS)
        numer = w.T @ x + lam * (h @ a)
        denom = (w.T @ w) @ h + lam * (h * deg[None, :]) + _EPS
        h = h * numer / denom
        return (w, h), _gnmf_obj(x, w, h, a, deg, lam)

    return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                       max_iter=max_iter, verbose=verbose)


def gnmf(
    x,
    k: int,
    adjacency,
    *,
    lambda_g: float = 1.0,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
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
    """Graph-regularized NMF (Cai et al. 2011 multiplicative updates).

    Args:
      adjacency: (n, n) symmetric non-negative affinity over the columns
        of x (dense array or scipy sparse — densified on device; build
        one from data with :func:`knn_graph`).
      lambda_g: graph regularization weight (0 reduces to EU MUR).

    ``obj_history`` records the full regularized objective.
    """
    x = jnp.asarray(x)
    x = x + jnp.maximum(-jnp.min(x), jnp.asarray(0.0, dtype=x.dtype))
    n = x.shape[1]
    if hasattr(adjacency, "toarray"):
        adjacency = adjacency.toarray()
    a = jnp.asarray(adjacency, dtype=x.dtype)
    if a.shape != (n, n):
        raise ValueError(f"adjacency must be ({n}, {n}); got {a.shape}")
    if lambda_g < 0:
        raise ValueError("lambda_g must be >= 0")
    deg = jnp.sum(a, axis=1)

    experiment = MurExperiment(
        method="gnmf", components=k, distance_type="eu-graph",
        nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=0.0, lambda_h=lambda_g,
    )

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None:
        w = jnp.asarray(w_init, dtype=x.dtype)
        h = jnp.asarray(h_init, dtype=x.dtype)
    elif nndsvd_init[0]:
        w, h = nndsvd(x, k, variant=nndsvd_init[1], key=key)
        w = jnp.maximum(w, 1e-6)
        h = jnp.maximum(h, 1e-6)
    else:
        w, h = random_init(
            key if key is not None else jax.random.PRNGKey(0),
            x.shape[0], n, k, kind="abs_normal", dtype=x.dtype,
        )

    lam = jnp.asarray(lambda_g, dtype=x.dtype)
    carry = init_carry(_gnmf_obj(x, w, h, a, deg, lam), max_iter, (w, h))
    run = lambda c, stop: _gnmf_block(
        x, a, deg, c, stop, tol1, tol2, lam, min_iter=min_iter,
        max_iter=max_iter, verbose=verbose,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + f"|gnmf:lam={lambda_g:g}",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=np.asarray(w), h=np.asarray(h), i=i,
                   obj_history=obj_history, experiment=experiment)
