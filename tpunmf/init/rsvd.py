"""Randomized SVD (Halko-Martinsson-Tropp range finder) for NNDSVD at scale.

The reference initializes with a full LAPACK ``gesdd`` SVD
(reference: nmf/utils.py:44), which is impossible at recommender scale
(1M x 100k).  Replacement: a sharded randomized range finder — the
only large operations are tall-skinny GEMMs (shardable
over the data's column axis with psum reductions under GSPMD), followed by
QR and an exact SVD of a small (rank+p) matrix.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def randomized_svd(x, rank: int, key, oversample: int = 10, power_iters: int = 2):
    """Approximate truncated SVD: returns (u, s, vt) with rank columns.

    All m*n-sized work is plain GEMM, so under a mesh with x column-sharded
    XLA turns the contractions into per-shard partials + psum.
    """
    m, n = x.shape
    l = min(rank + oversample, min(m, n))
    omega = jax.random.normal(key, (n, l), dtype=x.dtype)

    y = x @ omega                      # (m, l) sharded gemm
    q, _ = jnp.linalg.qr(y)
    # subspace (power) iteration for spectral accuracy on flat spectra
    for _ in range(power_iters):
        z = x.T @ q                    # (n, l)
        q, _ = jnp.linalg.qr(z)
        y = x @ q                      # (m, l)
        q, _ = jnp.linalg.qr(y)

    b = q.T @ x                        # (l, n) small x wide
    ub, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = q @ ub
    return u[:, :rank], s[:rank], vt[:rank, :]
