"""Experiment driver: parameter grid search over solver configurations.

Working replacement for the reference's broken legacy CLI
(reference: nmf/nmf_old.py — grid search over
``product(features, lambda_w, lambda_h)`` at nmf/nmf_old.py:52-54, data
loading at :28-42, parameter modules at :14-18).  Runs every combination,
optionally saves each result with the standard name grammar, and returns
the Results records.
"""
from __future__ import annotations

from itertools import product
from typing import Iterable, Sequence

from .api import NMF


def grid_search(
    data,
    *,
    method: str = "mur",
    features: Sequence[int] = (10,),
    lambda_w: Sequence[float] = (0.0,),
    lambda_h: Sequence[float] = (0.0,),
    save_dir: str | None = None,
    **fixed_params,
) -> list:
    """Run a factorization for every (k, lambda_w, lambda_h) combination.

    Mirrors the legacy CLI's loop (nmf/nmf_old.py:52-54) with the modern
    API; extra solver kwargs are passed through unchanged.  Returns a list
    of (params_dict, Results).
    """
    out = []
    for k, lw, lh in product(features, lambda_w, lambda_h):
        model = NMF(data, k)
        params = dict(lambda_w=lw, lambda_h=lh, **fixed_params)
        if method in ("admm", "ao_admm"):
            # map scalar lambdas onto the (value, type) reg tuples
            # fallback types match the solvers' own defaults
            # (admm/ao_admm: reg_w=(0,'nn'), reg_h=(0,'l2n'))
            reg_w = fixed_params.get("reg_w", (lw, "nn"))
            reg_h = fixed_params.get("reg_h", (lh, "l2n"))
            params = {k_: v for k_, v in fixed_params.items()
                      if k_ not in ("reg_w", "reg_h")}
            params.update(reg_w=(lw, reg_w[1]), reg_h=(lh, reg_h[1]))
        results = model.factorize(method=method, **params)
        if save_dir is not None:
            model.save_factorization(save_dir=save_dir)
        out.append((dict(k=k, lambda_w=lw, lambda_h=lh), results))
    return out


def mur_lambda_grid(
    data,
    k: int,
    *,
    lambda_w: Sequence[float] = (0.0,),
    lambda_h: Sequence[float] = (0.0,),
    distance_type: str = "eu",
    n_iter: int = 200,
    w_init=None,
    h_init=None,
    key=None,
    mesh=None,
    grid_axis: str | None = None,
):
    """Vectorized (vmapped) MUR over the full (lambda_w x lambda_h) grid.

    Batched hyperparameter search: ONE compile, every combination's
    iterations batched on device (the grid axis is a GEMM batch
    dimension), instead of `grid_search`'s one solver run per
    combination.  All runs share the init and execute exactly ``n_iter``
    iterations (no per-combination early stopping — pick winners from the
    returned objective trajectories).

    With ``mesh`` (and ``grid_axis`` naming one of its axes), the batch
    of combinations is additionally SHARDED across the mesh slices along
    that axis — each device slice runs its share of the grid
    concurrently, with X and the shared init replicated (embarrassingly
    parallel; no collectives needed).  The combination count must divide
    by the axis size; pad ``lambda_w``/``lambda_h`` if needed.

    Returns ``(combos, ws, hs, obj_hist)`` where combos is the list of
    (lambda_w, lambda_h) pairs in row-major grid order, ws is
    (B, m, k), hs is (B, k, n) and obj_hist is (B, n_iter).
    """
    import jax
    import jax.numpy as jnp

    from .init import random_init
    from .solvers.mur import _EPS

    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    x = jnp.asarray(data)
    m, n = x.shape
    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is None:
        w0, h0 = random_init(
            key if key is not None else jax.random.PRNGKey(0),
            m, n, k, kind="abs_normal", dtype=x.dtype,
        )
    else:
        w0 = jnp.asarray(w_init, dtype=x.dtype)
        h0 = jnp.asarray(h_init, dtype=x.dtype)

    combos = [(lw, lh) for lw in lambda_w for lh in lambda_h]
    lws = jnp.asarray([c[0] for c in combos], dtype=x.dtype)
    lhs = jnp.asarray([c[1] for c in combos], dtype=x.dtype)

    from .solvers.streaming import (
        _mur_h_update_eu,
        _mur_h_update_kl,
        _mur_w_update_eu,
        _mur_w_update_kl,
    )

    # x/w0/h0 are jit ARGUMENTS (closed-over arrays would be embedded in
    # the program as constants); the update math is the canonical copy in solvers/streaming.py
    def one(x, w0, h0, lw, lh):
        def step_eu(c, _):
            w, h = c
            w = _mur_w_update_eu(w, x @ h.T, h @ h.T, lw)
            h = _mur_h_update_eu(h, w.T @ x, w.T @ w, lh)
            obj = 0.5 * jnp.sum((x - w @ h) ** 2)
            return (w, h), obj

        def step_kl(c, _):
            w, h = c
            r = x / (w @ h + _EPS)
            w = _mur_w_update_kl(w, r @ h.T, h, lw)
            r2 = x / (w @ h + _EPS)
            h = _mur_h_update_kl(h, w.T @ r2, w, lh)
            wh = w @ h
            val = x * jnp.log(x / wh)
            val = jnp.where(val == jnp.inf, 0.0, val)
            val = jnp.where(jnp.isnan(val), 0.0, val)
            obj = jnp.sum(val - x + wh)
            return (w, h), obj

        step = step_kl if distance_type == "kl" else step_eu
        (w, h), objs = jax.lax.scan(step, (w0, h0), None, length=n_iter)
        return w, h, objs

    fn = jax.vmap(one, in_axes=(None, None, None, 0, 0))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        if grid_axis is None:
            grid_axis = mesh.axis_names[0]
        axis_size = mesh.shape[grid_axis]
        if len(combos) % axis_size:
            raise ValueError(
                f"{len(combos)} grid combinations do not divide across "
                f"mesh axis {grid_axis!r} of size {axis_size}"
            )
        batch_sh = NamedSharding(mesh, P(grid_axis))
        lws = jax.device_put(lws, batch_sh)
        lhs = jax.device_put(lhs, batch_sh)
        fn = jax.jit(
            fn,
            out_shardings=(
                NamedSharding(mesh, P(grid_axis, None, None)),
                NamedSharding(mesh, P(grid_axis, None, None)),
                NamedSharding(mesh, P(grid_axis, None)),
            ),
        )
    else:
        fn = jax.jit(fn)
    ws, hs, objs = fn(x, w0, h0, lws, lhs)
    return combos, ws, hs, objs


def rank_scan(
    data,
    ks: Sequence[int],
    *,
    n_seeds: int = 8,
    distance_type: str = "eu",
    n_iter: int = 200,
    key=None,
):
    """Consensus-based rank selection (Brunet et al. / Kim-Park).

    For each candidate rank k, runs ``n_seeds`` random-init MUR
    factorizations as ONE vmapped jit (seeds ride the batch axis), builds
    the sample consensus matrix C (how often two samples' dominant
    components coincide across seeds) and scores its stability with the
    dispersion coefficient ``rho = mean(4 (C - 1/2)^2)`` — rho == 1 iff
    every seed clusters the samples identically.  The elbow/maximum of
    rho over k is the standard rank choice.

    The consensus matrix is (n, n) per seed batch — O(n_seeds * n^2)
    device memory; subsample columns first for very wide data.

    Returns a list of dicts: {k, dispersion, mean_final_obj}.
    """
    import jax
    import jax.numpy as jnp

    from .init import random_init
    from .solvers.mur import _EPS

    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    x = jnp.asarray(data)
    m, n = x.shape
    base = key if key is not None else jax.random.PRNGKey(0)

    def one_k(k: int):
        # x is a jit ARGUMENT, not a closure constant: closed-over arrays
        # are embedded in the program, at exactly the data scales rank
        # selection is for
        from .solvers.streaming import (
            _mur_h_update_eu,
            _mur_h_update_kl,
            _mur_w_update_eu,
            _mur_w_update_kl,
        )

        def run(x, seed_key):
            w, h = random_init(seed_key, m, n, k, kind="abs_normal",
                               dtype=x.dtype)

            def step_eu(c, _):
                w, h = c
                w = _mur_w_update_eu(w, x @ h.T, h @ h.T, 0.0)
                h = _mur_h_update_eu(h, w.T @ x, w.T @ w, 0.0)
                return (w, h), None

            def step_kl(c, _):
                w, h = c
                r = x / (w @ h + _EPS)
                w = _mur_w_update_kl(w, r @ h.T, h, 0.0)
                r2 = x / (w @ h + _EPS)
                h = _mur_h_update_kl(h, w.T @ r2, w, 0.0)
                return (w, h), None

            step = step_kl if distance_type == "kl" else step_eu
            (w, h), _ = jax.lax.scan(step, (w, h), None, length=n_iter)
            labels = jnp.argmax(h, axis=0)                    # (n,)
            conn = (labels[:, None] == labels[None, :])       # (n, n)
            if distance_type == "kl":
                wh = w @ h
                val = x * jnp.log(x / wh)
                val = jnp.where(val == jnp.inf, 0.0, val)
                val = jnp.where(jnp.isnan(val), 0.0, val)
                obj = jnp.sum(val - x + wh)
            else:
                d = x - w @ h
                obj = 0.5 * jnp.sum(d * d)
            return conn.astype(x.dtype), obj

        keys = jax.random.split(jax.random.fold_in(base, k), n_seeds)
        conns, objs = jax.jit(jax.vmap(run, in_axes=(None, 0)))(x, keys)
        consensus = jnp.mean(conns, axis=0)
        dispersion = jnp.mean(4.0 * (consensus - 0.5) ** 2)
        return float(dispersion), float(jnp.mean(objs))

    out = []
    for k in ks:
        disp, obj = one_k(int(k))
        out.append({"k": int(k), "dispersion": disp, "mean_final_obj": obj})
    return out


def run_param_file(data, factors: int, param_module: str, method: str = "mur"):
    """Factorize using a parameter module exposing ``method_params``
    (the reference's param_file mechanism, nmf/nmf.py:38-45, actually
    applied here)."""
    model = NMF(data, factors, param_file=param_module)
    return model.factorize(method=method)


def corcondia(x, factors) -> float:
    """Core-consistency diagnostic for a CP model (Bro & Kiers 2003).

    Fits the unconstrained Tucker core G to the data given the CP
    factors (G = X contracted with each factor's pseudo-inverse) and
    scores how close G is to the superdiagonal identity the CP model
    implies:

        corcondia = 100 * (1 - ||G - I_sd||_F^2 / k)

    ~100 means the CP structure is appropriate at this rank; it collapses
    (often negative) once the rank over-fits — the standard tensor-rank
    diagnostic.  All contractions are einsum GEMMs (the pseudo-inverse is
    a k x k solve against each factor's Gram; X is contracted once).

    Args:
      x: the data tensor.
      factors: CP factor list (e.g. ``NtfResults.factors``).
    Returns: the diagnostic in (-inf, 100].
    """
    import string

    import jax.numpy as jnp
    import numpy as np

    x = jnp.asarray(x)
    fs = [jnp.asarray(f) for f in factors]
    ndim = x.ndim
    k = fs[0].shape[1]
    # pinv(F_d) = solve(F_d^T F_d, F_d^T): k x dim_d — tiny k x k algebra
    pinvs = [
        jnp.linalg.solve(f.T @ f + 1e-12 * jnp.eye(k, dtype=f.dtype), f.T)
        for f in fs
    ]
    ax = string.ascii_lowercase[:ndim]
    core_ax = string.ascii_lowercase[ndim:2 * ndim]  # fresh letters
    spec = (ax + "," + ",".join(c + a for c, a in zip(core_ax, ax))
            + "->" + core_ax)
    g = jnp.einsum(spec, x, *pinvs)                   # (k, ..., k) core
    ideal = jnp.zeros((k,) * ndim, dtype=g.dtype)
    idx = (jnp.arange(k),) * ndim
    ideal = ideal.at[idx].set(1.0)
    return float(100.0 * (1.0 - jnp.sum((g - ideal) ** 2) / k))


def ntf_rank_scan(
    x,
    ks: Sequence[int],
    *,
    update: str = "hals",
    n_iter: int = 200,
    key=None,
) -> list:
    """CP rank selection: fit + core consistency per candidate rank.

    Fits a CP model at each rank and reports the relative reconstruction
    error together with :func:`corcondia`.  The usual reading: pick the
    largest k whose core consistency stays high (~>50) before the
    collapse — fit alone decreases monotonically in k and cannot choose.

    Returns a list of dicts: {k, rel_err, corcondia, final_obj}.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .solvers import cp_reconstruct, ntf

    x = jnp.asarray(x)
    xnorm = float(jnp.linalg.norm(x))
    base = key if key is not None else jax.random.PRNGKey(0)
    out = []
    for i, k in enumerate(ks):
        res = ntf(x, int(k), update=update, max_iter=n_iter, min_iter=10,
                  tol1=1e-9, tol2=1e-9, key=jax.random.fold_in(base, i))
        xhat = cp_reconstruct([jnp.asarray(f) for f in res.factors])
        rel = float(jnp.linalg.norm(x - xhat)) / (xnorm + 1e-30)
        out.append({
            "k": int(k),
            "rel_err": rel,
            "corcondia": corcondia(x, res.factors),
            "final_obj": float(res.obj_history[-1]),
        })
    return out
