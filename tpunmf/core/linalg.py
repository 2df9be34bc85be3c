"""Small shared linear-algebra kernels.

``spd_solve`` solves (k x k SPD) @ X = B for wide right-hand sides.  Two
methods:
  'chol' — Cholesky + triangular solves: exact, the CPU/parity default
           (matches the reference's LAPACK path bit-for-bit-ish).
  'cg'   — Jacobi-preconditioned CG where each iteration's matvec is one
           dense (k, k) @ (k, p) GEMM, where a triangular solve is a
           sequential dependency chain; with iters = k + 8 the solution
           matches 'chol' to
           solver precision (CG is exact after k steps in exact
           arithmetic).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def spd_solve(a, b, *, method: str = "chol", cg_iters: int = 0):
    """Solve a @ x = b with a (k, k) SPD and b (k, p)."""
    if method == "chol":
        cho = jax.scipy.linalg.cholesky(a, lower=True)
        return jax.scipy.linalg.cho_solve((cho, True), b)

    k = a.shape[0]
    iters = cg_iters or (k + 8)
    diag = jnp.diag(a)[:, None]
    diag = jnp.where(diag <= 0.0, 1.0, diag)  # singular-Gram guard

    x = jnp.zeros_like(b)
    r = b
    z = r / diag
    p = z
    rz = jnp.sum(r * z, axis=0)

    def body(t, carry):
        x, r, p, rz = carry
        ap = a @ p
        denom = jnp.sum(p * ap, axis=0)
        alpha = rz / jnp.where(denom == 0.0, 1.0, denom)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        z = r / diag
        rz_new = jnp.sum(r * z, axis=0)
        beta = rz_new / jnp.where(rz == 0.0, 1.0, rz)
        p = z + beta[None, :] * p
        return (x, r, p, rz_new)

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, p, rz))
    return x
