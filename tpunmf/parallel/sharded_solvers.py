"""End-to-end sharded MUR drivers for the two remaining parallelism
patterns from SURVEY §2C: the Ulysses-style all_to_all layout flip and
rank (expert-parallel analog) sharding.

Both are *explicit-collective* solvers (shard_map bodies, jitted once)
whose iterates match the single-device MUR step (solvers/mur.py
step_eu/step_kl) up to float reassociation — tested on the 8-device CPU
mesh (tests/test_sharding.py).

The reference has no parallelism of any kind (its loops are sequential
numpy, e.g. nmf/mur.py:119); these are new capability mandated
by BASELINE.json.

Why two layouts (Ulysses):
  * the W-update ``W *= (X H^T) / (W (H H^T))`` is embarrassingly row-
    parallel when X is ROW-sharded and H replicated;
  * the H-update ``H *= (W^T X) / ((W^T W) H)`` is column-parallel when X
    is COLUMN-sharded;
  * ``mur_ulysses`` therefore flips X between the two layouts with one
    ``all_to_all`` (hoisted before the loop — X is loop-invariant)
    instead of keeping X replicated or paying a psum over partial
    products.  Peak per-device X memory is TWO panels (both layouts stay
    live across the solve) vs p panels for replication — an IN-CORE
    layout optimization.  For V genuinely beyond aggregate HBM the
    answer is not this flip but the streaming path
    (solvers/streaming_sharded.py) and the rotate-H ring
    (collectives.ring_xht_rotate_h), where X never moves at all.

Why rank sharding (EP analog):
  * at very large k, replicating W (m x k) and H (k x n) everywhere
    wastes HBM; ``mur_rank_sharded`` keeps each device on a k/p slice of
    the components (W P(None, 'rank'), H P('rank', None)) and
    reconstructs ``W @ H`` with one psum per half-step — the factors
    themselves are never gathered (SURVEY §2C 'EP').
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core.convergence import converged as _converged
from ..solvers.streaming import (
    _mur_h_update_eu,
    _mur_h_update_kl,
    _mur_w_update_eu,
    _mur_w_update_kl,
)

_EPS = 1e-9


def _masked_kl_sum(x, wh):
    """Masked KL terms ``x log(x/wh) - x + wh`` (nmf/utils.py:23-26)."""
    val = x * jnp.log(x / wh)
    val = jnp.where(val == jnp.inf, 0.0, val)
    val = jnp.where(jnp.isnan(val), 0.0, val)
    return jnp.sum(val - x + wh)


def _converging_loop(step, obj_fn, w0, h0, *, min_iter, max_iter, tol1, tol2):
    """Shared while_loop driver for the explicit-collective solvers.

    ``step(w, h) -> (w, h, obj)`` runs one full iteration; ``obj_fn(w, h)``
    evaluates the objective of the INITIAL iterate (obj_buf[0]).  The
    predicate reproduces the reference's convergence semantics
    (nmf/mur.py:131-136 via core.convergence): checked only for
    ``i > min_iter``, stopping after the triggering iteration.  All
    quantities are replicated across the mesh (objectives come out of
    psums), so every device evaluates the same predicate.

    Returns (w, h, completed_iters, obj_buf[(max_iter+1,)]).
    """
    obj0 = obj_fn(w0, h0)
    buf = jnp.full((max_iter + 1,), jnp.nan, dtype=obj0.dtype).at[0].set(obj0)
    c0 = (jnp.asarray(0, jnp.int32), w0, h0, obj0, jnp.asarray(False), buf)

    def cond(c):
        i, _, _, _, conv, _ = c
        return jnp.logical_and(i < max_iter, jnp.logical_not(conv))

    def body(c):
        i, w, h, obj_prev, _, buf = c
        w, h, obj = step(w, h)
        buf = buf.at[i + 1].set(obj)
        conv = jnp.logical_and(i > min_iter,
                               _converged(obj, obj_prev, tol1, tol2))
        return (i + 1, w, h, obj, conv, buf)

    i, w, h, _, _, buf = jax.lax.while_loop(cond, body, c0)
    return w, h, i, buf


# ---------------------------------------------------------------------------
# Ulysses-style alternating-layout MUR
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("mesh", "axis", "min_iter", "max_iter",
                                   "distance_type"))
def _mur_ulysses_jit(mesh, x_rows, w, h, lambda_w, lambda_h, tol1, tol2, *,
                     axis, min_iter, max_iter, distance_type="eu"):
    p = mesh.shape[axis]

    def f(x_loc, w_loc, h_rep):
        n = x_loc.shape[1]
        n_loc = n // p
        idx = jax.lax.axis_index(axis)
        # X is loop-invariant, so the rows->cols flip happens ONCE before
        # the loop (XLA cannot hoist a collective out of a while loop);
        # per iteration only the small W gather + H gather move.  Peak
        # per-device X memory is two panels either way (both layouts are
        # live during a flip).
        x_cols = jax.lax.all_to_all(x_loc, axis, split_axis=1,
                                    concat_axis=0, tiled=True)

        def h_block(h):
            return jax.lax.dynamic_slice_in_dim(h, idx * n_loc, n_loc, axis=1)

        def step_eu(w_loc, h):
            # --- W half: X row-sharded, H replicated — fully local
            # (update math = the canonical copy in solvers/streaming.py)
            w_loc = _mur_w_update_eu(w_loc, x_loc @ h.T, h @ h.T, lambda_w)
            # --- layout switch (Ulysses): W gathered for the column half
            w_full = jax.lax.all_gather(w_loc, axis, axis=0, tiled=True)
            # --- H half: each device updates its own column block
            h_blk = _mur_h_update_eu(h_block(h), w_full.T @ x_cols,
                                     w_full.T @ w_full, lambda_h)
            h = jax.lax.all_gather(h_blk, axis, axis=1, tiled=True)
            # objective from the column panels (exact EU residual)
            d = x_cols - w_full @ h_blk
            obj = 0.5 * jax.lax.psum(jnp.sum(d * d), axis)
            return (w_loc, h, obj)

        def step_kl(w_loc, h):
            # regularized KL closed forms (nmf/mur.py:25-27,41-45); the
            # W half is local on the row panel (H replicated, so its row
            # sums are global), the H half on the column panel after the
            # layout switch
            r = x_loc / (w_loc @ h + _EPS)
            w_loc = _mur_w_update_kl(w_loc, r @ h.T, h, lambda_w)
            w_full = jax.lax.all_gather(w_loc, axis, axis=0, tiled=True)
            h_blk = h_block(h)
            r2 = x_cols / (w_full @ h_blk + _EPS)
            h_blk = _mur_h_update_kl(h_blk, w_full.T @ r2, w_full, lambda_h)
            h = jax.lax.all_gather(h_blk, axis, axis=1, tiled=True)
            obj = jax.lax.psum(_masked_kl_sum(x_cols, w_full @ h_blk), axis)
            return (w_loc, h, obj)

        def obj_fn(w_loc, h):
            w_full = jax.lax.all_gather(w_loc, axis, axis=0, tiled=True)
            wh = w_full @ h_block(h)
            if distance_type == "kl":
                return jax.lax.psum(_masked_kl_sum(x_cols, wh), axis)
            d = x_cols - wh
            return 0.5 * jax.lax.psum(jnp.sum(d * d), axis)

        step = step_kl if distance_type == "kl" else step_eu
        return _converging_loop(step, obj_fn, w_loc, h_rep,
                                min_iter=min_iter, max_iter=max_iter,
                                tol1=tol1, tol2=tol2)

    return shard_map(
        f, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(None, None)),
        out_specs=(P(axis, None), P(None, None), P(), P()),
        check_vma=False,
    )(x_rows, w, h)


def mur_ulysses(mesh: Mesh, x, w, h, *, n_iter: int, lambda_w=0.0,
                lambda_h=0.0, axis: str | None = None,
                distance_type: str = "eu"):
    """Run ``n_iter`` MUR iterations (EU or KL) with the
    alternating-layout (all_to_all) schedule.  Requires m and n divisible
    by the mesh axis size.  Returns (w, h, final_objective); w comes back
    row-sharded, h replicated.
    """
    axis = axis or mesh.axis_names[0]
    p = mesh.shape[axis]
    m, n = x.shape
    if m % p or n % p:
        raise ValueError(f"m={m} and n={n} must divide the mesh axis ({p})")
    if distance_type not in ("eu", "kl"):
        raise ValueError("distance_type must be 'eu' or 'kl'")
    x = jax.device_put(x, NamedSharding(mesh, P(axis, None)))
    w = jax.device_put(w, NamedSharding(mesh, P(axis, None)))
    h = jax.device_put(h, NamedSharding(mesh, P()))
    zero = jnp.zeros((), x.dtype)
    # fixed-iteration mode: min_iter = max_iter means the convergence
    # check never fires and exactly n_iter iterations run
    w, h, _, buf = _mur_ulysses_jit(
        mesh, x, w, h, jnp.asarray(lambda_w, x.dtype),
        jnp.asarray(lambda_h, x.dtype), zero, zero, axis=axis,
        min_iter=int(n_iter), max_iter=int(n_iter),
        distance_type=distance_type)
    return w, h, buf[int(n_iter)]


# ---------------------------------------------------------------------------
# Rank-sharded MUR (EP analog)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("mesh", "axis", "min_iter", "max_iter",
                                   "distance_type"))
def _mur_rank_jit(mesh, x, w, h, lambda_w, lambda_h, tol1, tol2, *, axis,
                  min_iter, max_iter, distance_type):
    def f(x_rep, w_loc, h_loc):
        def recon(wl, hl):
            return jax.lax.psum(wl @ hl, axis)

        def step_eu(w_loc, h_loc):
            wh = recon(w_loc, h_loc)
            # (W @ (H H^T))[:, slice] == (W H) @ H_slice^T — local given wh
            w_loc = w_loc * (x_rep @ h_loc.T) / (
                wh @ h_loc.T + lambda_w * w_loc + _EPS)
            wh = recon(w_loc, h_loc)
            # ((W^T W) H)[slice, :] == W_slice^T (W H) — local given wh
            h_loc = h_loc * (w_loc.T @ x_rep) / (
                w_loc.T @ wh + lambda_h * h_loc + _EPS)
            wh = recon(w_loc, h_loc)
            d = x_rep - wh
            obj = 0.5 * jnp.sum(d * d)
            return (w_loc, h_loc, obj)

        def step_kl(w_loc, h_loc):
            # regularized KL closed form (canonical copy in
            # solvers/streaming.py); row/col sums of the local factor
            # slice are exactly the slice of the full sums — fully local
            wh = recon(w_loc, h_loc)
            r = x_rep / (wh + _EPS)
            w_loc = _mur_w_update_kl(w_loc, r @ h_loc.T, h_loc, lambda_w)
            wh = recon(w_loc, h_loc)
            r2 = x_rep / (wh + _EPS)
            h_loc = _mur_h_update_kl(h_loc, w_loc.T @ r2, w_loc, lambda_h)
            wh = recon(w_loc, h_loc)
            from ..core.losses import kl_elementwise_sum

            obj = kl_elementwise_sum(x_rep, wh)
            return (w_loc, h_loc, obj)

        def obj_fn(w_loc, h_loc):
            wh = recon(w_loc, h_loc)
            if distance_type == "kl":
                from ..core.losses import kl_elementwise_sum

                return kl_elementwise_sum(x_rep, wh)
            d = x_rep - wh
            return 0.5 * jnp.sum(d * d)

        step = step_kl if distance_type == "kl" else step_eu
        return _converging_loop(step, obj_fn, w_loc, h_loc,
                                min_iter=min_iter, max_iter=max_iter,
                                tol1=tol1, tol2=tol2)

    return shard_map(
        f, mesh=mesh,
        in_specs=(P(None, None), P(None, axis), P(axis, None)),
        out_specs=(P(None, axis), P(axis, None), P(), P()),
        check_vma=False,
    )(x, w, h)


def mur_rank_sharded(mesh: Mesh, x, w, h, *, n_iter: int,
                     distance_type: str = "eu", lambda_w=0.0, lambda_h=0.0,
                     axis: str = "rank"):
    """Run ``n_iter`` MUR iterations with the k (component) axis sharded
    over ``axis`` — W P(None, 'rank'), H P('rank', None), X replicated.
    The factors are never gathered; each half-step reconstructs W @ H
    with one psum.  Requires k divisible by the mesh axis size.  Returns
    (w, h, final_objective) with factors still rank-sharded.
    """
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no '{axis}' axis")
    p = mesh.shape[axis]
    k = w.shape[1]
    if k % p:
        raise ValueError(f"rank k={k} must divide the mesh axis ({p})")
    if distance_type not in ("eu", "kl"):
        raise ValueError("distance_type must be 'eu' or 'kl'")
    x = jax.device_put(x, NamedSharding(mesh, P()))
    w = jax.device_put(w, NamedSharding(mesh, P(None, axis)))
    h = jax.device_put(h, NamedSharding(mesh, P(axis, None)))
    zero = jnp.zeros((), x.dtype)
    w, h, _, buf = _mur_rank_jit(
        mesh, x, w, h, jnp.asarray(lambda_w, x.dtype),
        jnp.asarray(lambda_h, x.dtype), zero, zero, axis=axis,
        min_iter=int(n_iter), max_iter=int(n_iter),
        distance_type=distance_type)
    return w, h, buf[int(n_iter)]


# ---------------------------------------------------------------------------
# Full solver driver (Results, convergence, init) over either schedule
# ---------------------------------------------------------------------------

def mur_sharded(
    x,
    k: int,
    mesh: Mesh,
    *,
    schedule: str = "ulysses",
    axis: str | None = None,
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
):
    """MUR with reference solver semantics over an explicit-collective
    schedule: ``schedule='ulysses'`` (X flipped between row- and
    column-sharded layouts with one all_to_all; W/H panel updates fully
    local) or ``schedule='rank'`` (the k axis sharded — EP analog; the
    factors are never gathered).

    Same convergence contract as ``solvers.mur`` (min_iter/max_iter,
    tol1/tol2 per nmf/utils.py:4-15, objective history, negative-data
    elevation per nmf/mur.py:99-102) — the GSPMD ``mur()`` path stays the
    default; this driver is for workloads that need the explicit layouts
    (two-panel in-core footprint, very large k).  For V beyond aggregate
    HBM use solvers/streaming_sharded.py.  Returns a ``Results`` record
    with gathered (host) factors.
    """
    import numpy as np

    from ..core.types import MurExperiment, Results
    from ..init import nndsvd as _nndsvd, random_init
    from ..solvers.common import host_array

    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if schedule not in ("ulysses", "rank"):
        raise ValueError("schedule must be 'ulysses' or 'rank'")
    axis = axis or mesh.axis_names[0]

    x = jnp.asarray(x)
    x = x + jnp.maximum(-jnp.min(x), jnp.asarray(0.0, dtype=x.dtype))

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None:
        w = jnp.asarray(w_init, dtype=x.dtype)
        h = jnp.asarray(h_init, dtype=x.dtype)
    elif nndsvd_init[0]:
        w, h = _nndsvd(x, k, variant=nndsvd_init[1], key=key)
    else:
        w, h = random_init(
            key if key is not None else jax.random.PRNGKey(0),
            x.shape[0], x.shape[1], k, kind="abs_normal", dtype=x.dtype,
        )

    p = mesh.shape[axis]
    zero_tols = (jnp.asarray(tol1, x.dtype), jnp.asarray(tol2, x.dtype))
    if schedule == "ulysses":
        m, n = x.shape
        if m % p or n % p:
            raise ValueError(
                f"m={m} and n={n} must divide the mesh axis ({p})")
        xd = jax.device_put(x, NamedSharding(mesh, P(axis, None)))
        wd = jax.device_put(w, NamedSharding(mesh, P(axis, None)))
        hd = jax.device_put(h, NamedSharding(mesh, P()))
        w, h, i, buf = _mur_ulysses_jit(
            mesh, xd, wd, hd, jnp.asarray(lambda_w, x.dtype),
            jnp.asarray(lambda_h, x.dtype), *zero_tols, axis=axis,
            min_iter=min_iter, max_iter=max_iter,
            distance_type=distance_type)
    else:
        if k % p:
            raise ValueError(f"rank k={k} must divide the mesh axis ({p})")
        xd = jax.device_put(x, NamedSharding(mesh, P()))
        wd = jax.device_put(w, NamedSharding(mesh, P(None, axis)))
        hd = jax.device_put(h, NamedSharding(mesh, P(axis, None)))
        w, h, i, buf = _mur_rank_jit(
            mesh, xd, wd, hd, jnp.asarray(lambda_w, x.dtype),
            jnp.asarray(lambda_h, x.dtype), *zero_tols, axis=axis,
            min_iter=min_iter, max_iter=max_iter,
            distance_type=distance_type)

    experiment = MurExperiment(
        method="mur", components=k, distance_type=distance_type,
        nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=lambda_w, lambda_h=lambda_h,
    )
    completed = int(i)
    obj_history = list(np.asarray(buf[: completed + 1]))
    return Results(
        w=host_array(w), h=host_array(h), i=completed - 1,
        obj_history=obj_history, experiment=experiment,
    )
