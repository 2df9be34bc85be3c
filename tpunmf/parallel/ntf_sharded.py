"""Sharded N-way CP/PARAFAC: mode-0 slab parallelism with psum'd MTTKRPs.

Extends the tensor solver (solvers/ntf.py) across a device mesh (the
reference has no tensor path and no parallelism at
all — SURVEY §2C):

  * the tensor is sharded along mode 0 (``P(axis, None, ..., None)``) —
    each device owns a contiguous slab of mode-0 rows;
  * the mode-0 factor is row-sharded the same way; every other factor is
    replicated (they are (dim_d, k) — small next to the tensor);
  * the mode-0 MTTKRP is embarrassingly slab-parallel (it contracts every
    axis EXCEPT the sharded one locally);
  * the other modes' MTTKRPs contract over the sharded axis, so each
    device computes a partial and one ``psum`` completes it — same
    pattern as the matrix solvers' ``W^T X`` psum (collectives.wtx_psum);
  * the mode-0 Gram needs a psum; all other Grams are local algebra.

Per iteration that is N-1 psums of (dim_d, k) partials plus one (k, k)
Gram psum — the same asymptotic collective volume per mode as the 2-D
explicit-collective solvers, while the tensor itself never moves.

EU supports 'mur' and 'hals' updates; KL ('mur') reconstructs only the
LOCAL slab per mode (the full tensor reconstruction is never global).
Iterates match the single-device ``ntf`` solver up to float
reassociation (tested on the 8-device CPU mesh).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.convergence import converged as _converged
from ..core.losses import kl_elementwise_sum as _local_kl_sum
from ..solvers.ntf import (
    NtfExperiment,
    NtfResults,
    _gram_except,
    cp_reconstruct,
    mttkrp,
)

_EPS = 1e-9
_HALS_EPS = 1e-16


@partial(jax.jit, static_argnames=("mesh", "axis", "min_iter", "max_iter",
                                   "distance_type", "update"))
def _ntf_sharded_jit(mesh, x, factors, tol1, tol2, *, axis,
                     min_iter: int, max_iter: int, distance_type: str,
                     update: str):
    ndim = x.ndim

    def f(x_loc, f0_loc, *rest):
        fs0 = [f0_loc] + list(rest)
        xsq = jax.lax.psum(jnp.vdot(x_loc, x_loc), axis)

        def all_grams(fs):
            g0 = jax.lax.psum(fs[0].T @ fs[0], axis)
            return [g0] + [fd.T @ fd for fd in fs[1:]]

        def eu_step(fs):
            fs = list(fs)
            grams = all_grams(fs)
            m_last = None
            for d in range(ndim):
                m = mttkrp(x_loc, fs, d)
                if d > 0:
                    m = jax.lax.psum(m, axis)  # partial over the slab axis
                g = _gram_except(grams, d)
                if update == "mur":
                    fs[d] = fs[d] * (m / (fs[d] @ g + _EPS))
                else:  # hals sweep over components

                    def comp(r, fd, m=m, g=g):
                        denom = g[r, r] + _HALS_EPS
                        numer = m[:, r] - fd @ g[:, r] + fd[:, r] * g[r, r]
                        return fd.at[:, r].set(jnp.maximum(numer / denom, 0.0))

                    fs[d] = jax.lax.fori_loop(0, fs[d].shape[1], comp, fs[d])
                gd = fs[d].T @ fs[d]
                grams[d] = jax.lax.psum(gd, axis) if d == 0 else gd
                m_last = m
            full = grams[0]
            for g in grams[1:]:
                full = full * g
            # mode N-1 >= 1 always (ndim >= 2), so m_last is already global
            obj = 0.5 * (xsq - 2.0 * jnp.vdot(m_last, fs[ndim - 1])
                         + jnp.sum(full))
            return tuple(fs), obj

        def kl_step(fs):
            fs = list(fs)
            for d in range(ndim):
                xhat = cp_reconstruct(fs)        # LOCAL slab only
                ratio = x_loc / (xhat + _EPS)
                numer = mttkrp(ratio, fs, d)
                if d > 0:
                    numer = jax.lax.psum(numer, axis)
                denom = None
                for e in range(ndim):
                    if e == d:
                        continue
                    s = jnp.sum(fs[e], axis=0)
                    if e == 0:
                        s = jax.lax.psum(s, axis)
                    denom = s if denom is None else denom * s
                fs[d] = fs[d] * (numer / (denom[None, :] + _EPS))
            obj = jax.lax.psum(_local_kl_sum(x_loc, cp_reconstruct(fs)), axis)
            return tuple(fs), obj

        step = eu_step if distance_type == "eu" else kl_step

        if distance_type == "eu":
            grams = all_grams(fs0)
            full = grams[0]
            for g in grams[1:]:
                full = full * g
            m_last = jax.lax.psum(mttkrp(x_loc, fs0, ndim - 1), axis)
            obj0 = 0.5 * (xsq - 2.0 * jnp.vdot(m_last, fs0[ndim - 1])
                          + jnp.sum(full))
        else:
            obj0 = jax.lax.psum(_local_kl_sum(x_loc, cp_reconstruct(fs0)), axis)

        buf = jnp.full((max_iter + 1,), jnp.nan,
                       dtype=obj0.dtype).at[0].set(obj0)
        c0 = (jnp.asarray(0, jnp.int32), tuple(fs0), obj0,
              jnp.asarray(False), buf)

        def cond(c):
            i, _, _, conv, _ = c
            return jnp.logical_and(i < max_iter, jnp.logical_not(conv))

        def body(c):
            i, fs, obj_prev, _, buf = c
            fs, obj = step(fs)
            buf = buf.at[i + 1].set(obj)
            conv = jnp.logical_and(i > min_iter,
                                   _converged(obj, obj_prev, tol1, tol2))
            return (i + 1, fs, obj, conv, buf)

        i, fs, _, _, buf = jax.lax.while_loop(cond, body, c0)
        return (*fs, i, buf)

    tensor_spec = P(axis, *([None] * (ndim - 1)))
    rep = P(None, None)
    in_specs = (tensor_spec, P(axis, None)) + tuple(rep for _ in range(ndim - 1))
    out_specs = (P(axis, None),) + tuple(rep for _ in range(ndim - 1)) + (P(), P())
    return shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)(x, *factors)


def ntf_sharded(
    mesh: Mesh,
    x,
    k: int,
    *,
    axis: str | None = None,
    distance_type: str = "eu",
    update: str = "mur",
    min_iter: int = 10,
    max_iter: int = 500,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    factors_init=None,
    key=None,
) -> NtfResults:
    """Mesh-sharded non-negative CP factorization (mode-0 slabs).

    Same conventions as :func:`tpunmf.solvers.ntf` (minus host-side
    checkpointing — the whole run is one device dispatch).  Mode 0 must
    divide the mesh axis size.  ``factors_init``, when given, must be the
    full (unsharded) factor list; outputs are gathered to host numpy.
    """
    x = jnp.asarray(x)
    ndim = x.ndim
    if ndim < 2:
        raise ValueError(f"x must be at least 2-way; got shape {x.shape}")
    axis = axis or mesh.axis_names[0]
    p = mesh.shape[axis]
    if x.shape[0] % p:
        raise ValueError(
            f"mesh axis size {p} must divide mode-0 dim {x.shape[0]}")
    if distance_type not in ("eu", "kl"):
        raise ValueError("distance_type must be 'eu' or 'kl'")
    if update not in ("mur", "hals"):
        raise ValueError("update must be 'mur' or 'hals'")
    if distance_type == "kl" and update == "hals":
        raise ValueError("HALS is least-squares only; use update='mur' for KL")
    if bool(jnp.any(x < 0)):
        raise ValueError("x must be non-negative")

    if factors_init is not None:
        if len(factors_init) != ndim:
            raise ValueError(f"factors_init must have length {ndim}")
        factors = []
        for d, fd in enumerate(factors_init):
            fd = jnp.asarray(fd, dtype=x.dtype)
            if fd.shape != (x.shape[d], k):
                raise ValueError(
                    f"factors_init[{d}] must be {(x.shape[d], k)}; "
                    f"got {fd.shape}")
            factors.append(fd)
        if any(bool(jnp.any(fd < 0)) for fd in factors):
            raise ValueError("factors_init must be non-negative")
    else:
        kk = key if key is not None else jax.random.PRNGKey(42)
        keys = jax.random.split(kk, ndim)
        scale = (jnp.mean(x) / k + _EPS) ** (1.0 / ndim)
        factors = [
            jnp.abs(jax.random.normal(keys[d], (x.shape[d], k), dtype=x.dtype))
            * scale
            for d in range(ndim)
        ]

    tensor_spec = P(axis, *([None] * (ndim - 1)))
    x = jax.device_put(x, NamedSharding(mesh, tensor_spec))
    factors = [
        jax.device_put(factors[0], NamedSharding(mesh, P(axis, None)))
    ] + [jax.device_put(fd, NamedSharding(mesh, P(None, None)))
         for fd in factors[1:]]

    out = _ntf_sharded_jit(
        mesh, x, tuple(factors), jnp.asarray(tol1, x.dtype),
        jnp.asarray(tol2, x.dtype), axis=axis, min_iter=min_iter,
        max_iter=max_iter, distance_type=distance_type, update=update)
    fs, i, buf = out[:ndim], int(out[ndim]), out[ndim + 1]
    experiment = NtfExperiment(
        method="ntf", components=k, distance_type=distance_type,
        update=update, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambdas=tuple(0.0 for _ in range(ndim)),
    )
    from ..solvers.common import host_array

    obj_history = list(host_array(buf)[: i + 1])
    return NtfResults(factors=[host_array(fd) for fd in fs], i=i - 1,
                      obj_history=obj_history, experiment=experiment)
