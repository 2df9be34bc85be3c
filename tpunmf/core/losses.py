"""Objective (distance) functions for NMF: Euclidean and Kullback-Leibler.

Semantics match the reference implementation's ``distance`` function
(reference: nmf/utils.py:18-33), including its KL masking behavior
(nmf/utils.py:24-25): the elementwise term ``x * log(x / wh)`` is computed
first, then ``+inf`` entries are zeroed (x > 0, wh == 0), then NaN entries
are zeroed (x == 0 -> 0 * -inf), and only then is the linear correction
``- x + wh`` summed in.  This means cells where the log term was masked
still contribute ``wh - x`` to the objective.

Design notes: both objectives are also available in forms that avoid
materializing ``w @ h`` (see ``eu_objective_gram`` and the fused Pallas
kernels in :mod:`tpunmf.ops`).
"""
from __future__ import annotations

import jax.numpy as jnp


def kl_elementwise_sum(x, wh):
    """Masked KL sum matching reference nmf/utils.py:21-26."""
    value = x * jnp.log(x / wh)
    value = jnp.where(value == jnp.inf, 0.0, value)
    value = jnp.where(jnp.isnan(value), 0.0, value)
    return jnp.sum(value - x + wh)


def eu_elementwise_sum(x, wh):
    """Euclidean distance 0.5 * ||x - wh||_F^2 (reference nmf/utils.py:27-29)."""
    d = x - wh
    return 0.5 * jnp.sum(d * d)


def distance(x, wh, distance_type: str = "eu"):
    """Objective value for a given reconstruction ``wh``.

    Mirrors reference nmf/utils.py:18-33 (same name, same semantics) but is
    jit-friendly: ``distance_type`` must be a static Python string.
    """
    if distance_type == "kl":
        return kl_elementwise_sum(x, wh)
    if distance_type == "eu":
        return eu_elementwise_sum(x, wh)
    raise KeyError('Distance type unknown: use "kl" or "eu"')


def eu_objective_gram(xsq, wtx, gram_w, h):
    """Euclidean objective without materializing ``w @ h``.

    0.5*||X - WH||^2 = 0.5*(||X||^2 - 2<H, W^T X> + tr((W^T W)(H H^T))).

    Args:
      xsq: precomputed ``sum(x**2)`` (scalar).
      wtx: ``w.T @ x`` of shape (k, n) — typically already computed for the
        H update, making this objective nearly free (no extra m*n*k work).
      gram_w: ``w.T @ w`` of shape (k, k).
      h: factor of shape (k, n).
    """
    cross = jnp.vdot(h, wtx)
    gram_h = h @ h.T
    quad = jnp.vdot(gram_w, gram_h)
    return 0.5 * (xsq - 2.0 * cross + quad)
