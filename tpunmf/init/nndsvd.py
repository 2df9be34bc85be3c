"""NNDSVD initialization (Boutsidis & Gallopoulos).

Behavioral contract matches the reference ``nndsvd`` (reference:
nmf/utils.py:36-93): leading singular triplet taken with absolute values,
every further component picks the positive- or negative-part pair with the
larger norm product, and the 'zero' / 'mean' / 'random' fill variants.

Design differences (a redesign, not a translation):
  * the per-component Python loop (nmf/utils.py:60-82) is fully vectorized
    over the rank axis — one batched positive/negative-part split, one
    batched norm computation, one ``where`` select;
  * the SVD can come from ``jnp.linalg.svd`` (exact, small/medium matrices)
    or from a sharded randomized range-finder SVD for matrices that do not
    fit one device (see :mod:`tpunmf.init.rsvd`).

NNDSVD is invariant to the SVD's per-column sign ambiguity: jointly flipping
(u_i, v_i) swaps the positive and negative parts *and* their norm products,
selecting the same (w_i, h_i).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _nndsvd_from_svd(u, s, vt, x_mean, rank, variant, key=None):
    """Build (w, h) from a truncated SVD. u:(m,r) s:(r,) vt:(r,n)."""
    m = u.shape[0]
    n = vt.shape[1]

    # components 1..rank-1: batched positive/negative part selection
    up = jnp.maximum(u, 0.0)          # (m, r)
    un = jnp.maximum(-u, 0.0)
    vp = jnp.maximum(vt, 0.0)         # (r, n)
    vn = jnp.maximum(-vt, 0.0)

    up_norm = jnp.linalg.norm(up, axis=0)      # (r,)
    un_norm = jnp.linalg.norm(un, axis=0)
    vp_norm = jnp.linalg.norm(vp, axis=1)
    vn_norm = jnp.linalg.norm(vn, axis=1)

    norm_pos = up_norm * vp_norm
    norm_neg = un_norm * vn_norm
    take_pos = norm_pos >= norm_neg            # (r,)

    # scale factors; guard 0/0 for all-zero parts (reference would emit nan)
    def _safe_div(a, b):
        return a / jnp.where(b == 0.0, 1.0, b)

    scale_w_pos = _safe_div(jnp.sqrt(s * norm_pos), up_norm)
    scale_w_neg = _safe_div(jnp.sqrt(s * norm_neg), un_norm)
    scale_h_pos = _safe_div(jnp.sqrt(s * norm_pos), vp_norm)
    scale_h_neg = _safe_div(jnp.sqrt(s * norm_neg), vn_norm)

    w = jnp.where(take_pos[None, :], scale_w_pos[None, :] * up,
                  scale_w_neg[None, :] * un)
    h = jnp.where(take_pos[:, None], scale_h_pos[:, None] * vp,
                  scale_h_neg[:, None] * vn)

    # leading triplet overrides component 0 (reference nmf/utils.py:55-56)
    w = w.at[:, 0].set(jnp.sqrt(s[0]) * jnp.abs(u[:, 0]))
    h = h.at[0, :].set(jnp.sqrt(s[0]) * jnp.abs(vt[0, :]))

    if variant == "mean":
        w = jnp.where(w == 0.0, x_mean, w)
        h = jnp.where(h == 0.0, x_mean, h)
    elif variant == "random":
        if key is None:
            key = jax.random.PRNGKey(0)
        kw, kh = jax.random.split(key)
        rw = x_mean * jax.random.uniform(kw, (m, rank), dtype=w.dtype) / 100.0
        rh = x_mean * jax.random.uniform(kh, (rank, n), dtype=h.dtype) / 100.0
        w = jnp.where(w == 0.0, rw, w)
        h = jnp.where(h == 0.0, rh, h)

    return w, h


def nndsvd(x, rank=None, variant: str = "zero", key=None, method: str = "auto",
           oversample: int = 10, power_iters: int = 2):
    """SVD-based NMF initialization.

    Args:
      x: (m, n) non-negative data.
      rank: number of components (defaults to n, like the reference).
      variant: 'zero' | 'mean' | 'random' fill for zero entries.
      key: PRNG key for the 'random' variant and randomized SVD.
      method: 'exact' (jnp.linalg.svd), 'randomized' (range-finder rSVD),
        or 'auto' — exact up to the backend's ``rsvd_threshold`` min-dim
        (core/backend.py), randomized beyond; exact SVD at recommender
        scale is the reference's scalability wall (nmf/utils.py:44).
      oversample, power_iters: randomized-SVD parameters.
    """
    x = jnp.asarray(x)
    if rank is None:
        rank = x.shape[1]

    if method == "auto":
        from ..core.backend import defaults

        threshold = defaults().rsvd_threshold
        method = "randomized" if min(x.shape) > threshold else "exact"

    if method == "randomized":
        from .rsvd import randomized_svd

        if key is None:
            key = jax.random.PRNGKey(0)
        u, s, vt = randomized_svd(x, rank, key=key, oversample=oversample,
                                  power_iters=power_iters)
    else:
        u, s, vt = jnp.linalg.svd(x, full_matrices=False)
        u = u[:, :rank]
        s = s[:rank]
        vt = vt[:rank, :]

    return _nndsvd_from_svd(u, s, vt, jnp.mean(x), rank, variant, key)
