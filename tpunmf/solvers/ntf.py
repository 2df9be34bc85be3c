"""NTF — non-negative tensor (CP/PARAFAC) factorization.

Beyond-reference capability with a direct lineage: the reference's legacy
CLI ingests 3-D photoacoustic (MSOT) stacks and *flattens* them to 2-D in
Fortran order before factorizing (reference: nmf/nmf_old.py:40-42) — the
tensor structure is destroyed.  This module factorizes the tensor
natively: an N-way non-negative ``X`` is approximated by a rank-``k``
CP/PARAFAC model

    X[i1..iN]  ~=  sum_r  F1[i1, r] * F2[i2, r] * ... * FN[iN, r],

with every factor ``Fd >= 0``.  Two update families:

  * ``update='mur'`` — multiplicative updates (the Lee-Seung rule
    generalized to CP, cf. Welling & Weber 2001 / Shashua & Hazan 2005),
    Euclidean and KL objectives, monotone non-increasing.
  * ``update='hals'`` — per-component Gauss-Seidel closed forms
    (CP-HALS, Cichocki & Phan 2009), Euclidean only; fewer sweeps to a
    given objective, same per-iteration GEMM cost.

Device mapping.  All heavy lifting is MTTKRP (matricized-tensor times
Khatri-Rao product), expressed as one ``einsum`` per mode —
``einsum('abc,bz,cz->az', X, B, C)`` for mode 0 of a 3-way tensor —
which XLA contracts as a chain of dense GEMMs without ever
materializing the Khatri-Rao matrix or an unfolded copy of ``X``.  The
k x k mode Grams are Hadamard products of per-factor Grams, so the
Euclidean objective needs NO reconstruction:

    ||X - Xhat||^2 = ||X||^2 - 2 <MTTKRP_N, FN> + 1' (o_d Fd'Fd) 1.

Only the KL objective materializes ``Xhat`` (its elementwise log term is
irreducible).  The iteration loop is the shared jitted
``while_block`` driver (solvers/common.py) with identical convergence /
history / checkpoint semantics to every 2-D solver; for N == 2 the model
reduces exactly to NMF (mode-0 factor = W, mode-1 factor = H^T).
"""
from __future__ import annotations

import string
from collections import namedtuple
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.losses import kl_elementwise_sum
from .common import LoopCarry, finalize_history, init_carry, run_loop, while_block

_EPS = 1e-9
_HALS_EPS = 1e-16

NtfExperiment = namedtuple(
    "Experiment",
    "method components distance_type update max_iter tol1 tol2 lambdas",
)

NtfResults = namedtuple("NtfResults", "factors i obj_history experiment")


def _axes(n: int) -> str:
    if n > 20:
        raise ValueError(f"tensors beyond 20 modes are unsupported (got {n})")
    return string.ascii_lowercase[:n]


def mttkrp(x, factors, mode: int):
    """MTTKRP for one mode as a single einsum (no unfolding, no KR matrix).

    ``mttkrp(X, (A, B, C), 0) == X_(0) @ khatri_rao(C, B)`` but contracted
    directly: ``einsum('abc,bz,cz->az', X, B, C)``.
    """
    ax = _axes(x.ndim)
    ins = [ax] + [ax[e] + "z" for e in range(x.ndim) if e != mode]
    args = [x] + [factors[e] for e in range(x.ndim) if e != mode]
    return jnp.einsum(",".join(ins) + "->" + ax[mode] + "z", *args)


def cp_reconstruct(factors):
    """Materialize the CP model ``sum_r outer(F1[:,r], ..., FN[:,r])``."""
    n = len(factors)
    ax = _axes(n)
    spec = ",".join(a + "z" for a in ax) + "->" + ax
    return jnp.einsum(spec, *factors)


def _gram_except(grams, mode: int):
    """Hadamard product of all per-factor Grams except ``mode``'s."""
    out = None
    for e, g in enumerate(grams):
        if e == mode:
            continue
        out = g if out is None else out * g
    return out


def _normalize_columns(factors):
    """Equilibrate per-component column norms across modes.

    The CP model is invariant to per-component rescaling across factors;
    spreading each component's total magnitude geometrically over the
    modes keeps every factor O(1) and stops MUR denominators from
    under/overflowing on long runs.  Reconstruction is unchanged
    (exactly, up to rounding), so the objective trace is unaffected.
    """
    n = len(factors)
    norms = [jnp.linalg.norm(f, axis=0) + _HALS_EPS for f in factors]
    total = norms[0]
    for nm in norms[1:]:
        total = total * nm
    target = total ** (1.0 / n)
    return [f * (target / nm)[None, :] for f, nm in zip(factors, norms)]


def _make_masked_step(x, mask, distance_type: str, lambdas, normalize: bool):
    """Masked (tensor-completion) MUR steps: only observed cells drive the
    fit.  Each mode update needs the current reconstruction restricted to
    observed cells, so per iteration the model is materialized once per
    mode (the unavoidable cost of masking — the gram trick no longer
    applies because ``||M o Xhat||^2`` does not factor over the modes).

    EU:  F_d <- F_d * mttkrp(M o X) / (mttkrp(M o Xhat) + lam F_d)
    KL:  F_d <- F_d * mttkrp(M o X / Xhat) / mttkrp(M)

    Both are the Lee-Seung rules on the masked objective lifted to CP
    (the 2-D case reduces exactly to solvers/masked.py's updates).
    """
    ndim = x.ndim
    mx = mask * x

    def eu_step(inner, i):
        factors = list(inner)
        for d in range(ndim):
            xhat = cp_reconstruct(factors)
            numer = mttkrp(mx, factors, d)
            denom = (mttkrp(mask * xhat, factors, d)
                     + lambdas[d] * factors[d] + _EPS)
            factors[d] = factors[d] * (numer / denom)
        resid = mask * (x - cp_reconstruct(factors))
        obj = 0.5 * jnp.sum(resid * resid)
        if normalize:
            factors = _normalize_columns(factors)
        return tuple(factors), obj

    def kl_step(inner, i):
        factors = list(inner)
        for d in range(ndim):
            xhat = cp_reconstruct(factors)
            ratio = mask * (x / (xhat + _EPS))
            numer = mttkrp(ratio, factors, d)
            denom = mttkrp(mask, factors, d) + _EPS
            factors[d] = factors[d] * (numer / denom)
        xhat = cp_reconstruct(factors)
        obj = kl_elementwise_sum(mask * x, mask * xhat)
        if normalize:
            factors = _normalize_columns(factors)
        return tuple(factors), obj

    return eu_step if distance_type == "eu" else kl_step


def _make_step(x, xsq, distance_type: str, update: str, lambdas, normalize: bool):
    ndim = x.ndim

    def eu_step(inner, i):
        factors = list(inner)
        grams = [f.T @ f for f in factors]
        m_last = None
        for d in range(ndim):
            m = mttkrp(x, factors, d)
            g = _gram_except(grams, d)
            if update == "mur":
                denom = factors[d] @ g + lambdas[d] * factors[d] + _EPS
                factors[d] = factors[d] * (m / denom)
            else:  # hals: Gauss-Seidel over components
                lam = lambdas[d]

                def comp(r, f, m=m, g=g, lam=lam):
                    denom = g[r, r] + lam + _HALS_EPS
                    numer = m[:, r] - f @ g[:, r] + f[:, r] * g[r, r]
                    return f.at[:, r].set(jnp.maximum(numer / denom, 0.0))

                factors[d] = jax.lax.fori_loop(0, factors[d].shape[1], comp,
                                               factors[d])
            grams[d] = factors[d].T @ factors[d]
            m_last = m
        # <X, Xhat> = <MTTKRP_last(pre-update factors elsewhere current),
        #             F_last(new)>; ||Xhat||^2 via the Gram Hadamard
        full_gram = grams[0]
        for g in grams[1:]:
            full_gram = full_gram * g
        obj = 0.5 * (xsq - 2.0 * jnp.vdot(m_last, factors[ndim - 1])
                     + jnp.sum(full_gram))
        if normalize:
            factors = _normalize_columns(factors)
        return tuple(factors), obj

    def kl_step(inner, i):
        factors = list(inner)
        for d in range(ndim):
            xhat = cp_reconstruct(factors)
            ratio = x / (xhat + _EPS)
            numer = mttkrp(ratio, factors, d)
            # denominator: column sums of the Khatri-Rao product =
            # Hadamard of the other factors' column sums
            denom = None
            for e in range(ndim):
                if e == d:
                    continue
                s = jnp.sum(factors[e], axis=0)
                denom = s if denom is None else denom * s
            factors[d] = factors[d] * (numer / (denom[None, :] + _EPS))
        xhat = cp_reconstruct(factors)
        obj = kl_elementwise_sum(x, xhat)
        if normalize:
            factors = _normalize_columns(factors)
        return tuple(factors), obj

    return eu_step if distance_type == "eu" else kl_step


@partial(jax.jit, static_argnames=("distance_type", "update", "normalize",
                                   "min_iter", "max_iter", "verbose"))
def _ntf_block(x, mask, xsq, lambdas, carry: LoopCarry, stop_i, tol1, tol2, *,
               distance_type: str, update: str, normalize: bool,
               min_iter: int, max_iter: int, verbose: bool):
    if mask is None:
        step = _make_step(x, xsq, distance_type, update, lambdas, normalize)
    else:
        step = _make_masked_step(x, mask, distance_type, lambdas, normalize)
    return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                       max_iter=max_iter, verbose=verbose)


def ntf(
    x,
    k: int,
    *,
    distance_type: str = "eu",
    update: str = "mur",
    lambdas: Optional[Sequence[float]] = None,
    mask=None,
    min_iter: int = 10,
    max_iter: int = 500,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    factors_init: Optional[Sequence] = None,
    key=None,
    normalize: bool = True,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> NtfResults:
    """Non-negative CP/PARAFAC factorization of an N-way tensor.

    Args:
      x: non-negative N-way array (N >= 2; N == 2 reduces to NMF).
      k: CP rank (number of components).
      distance_type: 'eu' (Frobenius, both updates) or 'kl'
        (I-divergence, ``update='mur'`` only).
      update: 'mur' (multiplicative, monotone) or 'hals' (per-component
        closed forms, usually fewer sweeps to a given objective).
      lambdas: optional per-mode ridge (l2) strengths, length N
        (Euclidean only; default all zero).
      mask: optional non-negative observation weights, same shape as
        ``x`` (1/0 for observed/missing, or continuous weights) — tensor
        completion: only observed cells drive the fit (``update='mur'``
        only; each mode update then materializes the model once, since
        masking breaks the gram trick).  The 2-D case reduces to the
        masked matrix solver (solvers/masked.py).
      factors_init: optional explicit non-negative factor list, mode d of
        shape (x.shape[d], k).  Default |randn| init.
      normalize: equilibrate component norms across modes each iteration
        (reconstruction-invariant; keeps long MUR runs well-scaled).
        Note: with nonzero ``lambdas`` the rescale changes the ridge
        penalty term (the recorded data-fit objective is unaffected), so
        strict monotonicity of the REGULARIZED objective is only
        guaranteed with ``normalize=False``.

    Returns:
      NtfResults(factors, i, obj_history, experiment) — ``factors[d]`` is
      the (x.shape[d], k) non-negative mode-d factor.
    """
    x = jnp.asarray(x)
    ndim = x.ndim
    if ndim < 2:
        raise ValueError(f"x must be at least 2-way; got shape {x.shape}")
    if distance_type not in ("eu", "kl"):
        raise ValueError("distance_type must be 'eu' or 'kl'")
    if update not in ("mur", "hals"):
        raise ValueError("update must be 'mur' or 'hals'")
    if distance_type == "kl" and update == "hals":
        raise ValueError("HALS is least-squares only; use update='mur' for KL")
    if bool(jnp.any(x < 0)):
        raise ValueError("x must be non-negative")
    if mask is not None:
        if update != "mur":
            raise ValueError("mask= requires update='mur' (masked HALS "
                             "closed forms are not implemented)")
        mask = jnp.asarray(mask, dtype=x.dtype)
        if mask.shape != x.shape:
            raise ValueError(f"mask shape {mask.shape} != x shape {x.shape}")
        if bool(jnp.any(mask < 0)):
            raise ValueError("mask must be non-negative")

    if lambdas is None:
        lam = jnp.zeros((ndim,), dtype=x.dtype)
    else:
        if len(lambdas) != ndim:
            raise ValueError(f"lambdas must have length {ndim}")
        lam = jnp.asarray(list(lambdas), dtype=x.dtype)
        if distance_type == "kl" and bool(jnp.any(lam != 0)):
            raise ValueError("lambdas are Euclidean-only (KL MUR here is "
                             "unregularized)")

    if factors_init is not None:
        if len(factors_init) != ndim:
            raise ValueError(f"factors_init must have length {ndim}")
        factors = []
        for d, f in enumerate(factors_init):
            f = jnp.asarray(f, dtype=x.dtype)
            if f.shape != (x.shape[d], k):
                raise ValueError(
                    f"factors_init[{d}] must be {(x.shape[d], k)}; got {f.shape}")
            factors.append(f)
        if any(bool(jnp.any(f < 0)) for f in factors):
            raise ValueError("factors_init must be non-negative")
    else:
        kk = key if key is not None else jax.random.PRNGKey(42)
        keys = jax.random.split(kk, ndim)
        # scale so the rank-k sum matches the data's mean magnitude
        scale = (jnp.mean(x) / k + _EPS) ** (1.0 / ndim)
        factors = [
            jnp.abs(jax.random.normal(keys[d], (x.shape[d], k), dtype=x.dtype))
            * scale
            for d in range(ndim)
        ]

    experiment = NtfExperiment(
        method="ntf", components=k, distance_type=distance_type,
        update=update, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambdas=tuple(float(v) for v in np.asarray(lam)),
    )

    xsq = jnp.vdot(x, x)
    if mask is not None:
        if distance_type == "eu":
            resid = mask * (x - cp_reconstruct(factors))
            obj0 = 0.5 * jnp.sum(resid * resid)
        else:
            obj0 = kl_elementwise_sum(mask * x,
                                      mask * cp_reconstruct(factors))
    elif distance_type == "eu":
        grams = [f.T @ f for f in factors]
        full_gram = grams[0]
        for g in grams[1:]:
            full_gram = full_gram * g
        m_last = mttkrp(x, factors, ndim - 1)
        obj0 = 0.5 * (xsq - 2.0 * jnp.vdot(m_last, factors[ndim - 1])
                      + jnp.sum(full_gram))
    else:
        obj0 = kl_elementwise_sum(x, cp_reconstruct(factors))

    carry = init_carry(obj0, max_iter, tuple(factors))
    run = lambda c, stop: _ntf_block(
        x, mask, xsq, lam, c, stop, tol1, tol2, distance_type=distance_type,
        update=update, normalize=normalize, min_iter=min_iter,
        max_iter=max_iter, verbose=verbose,
    )
    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=(repr(experiment) + f"|ntf:shape={x.shape}"
                    + ("|masked" if mask is not None else "")),
    )
    factors = [np.asarray(f) for f in carry.inner]
    i, obj_history = finalize_history(carry)
    return NtfResults(factors=factors, i=i, obj_history=obj_history,
                      experiment=experiment)
