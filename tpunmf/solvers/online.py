"""Online NMF — streaming minibatch learning with sufficient statistics.

Beyond-reference capability: every reference solver needs the whole
matrix resident (nmf/mur.py etc.); this learns W from an UNBOUNDED
stream of column minibatches in O(mk + k^2) state, after Mairal et al.'s
online dictionary learning (JMLR 2010) specialized to NMF:

per minibatch X_t (m, b):
  1. encode   H_t = argmin_{H>=0} ||X_t - W H||^2      (batched NNLS,
     the same kernel as ANLS/transform)
  2. accumulate sufficient statistics with forgetting factor rho:
         A <- rho A + H_t H_t^T          (k x k)
         B <- rho B + X_t H_t^T          (m x k)
  3. update W by HALS-style block coordinate descent on the surrogate
         f_t(W) = 1/2 tr(W A W^T) - tr(W^T B):
         w_l <- max(0, w_l + (B[:, l] - W A[:, l]) / A[l, l])
     — exactly the batch HALS column rule with (XHt, HHt) replaced by
     the running (B, A), so one epoch over a resident matrix with
     rho=1 reproduces a batch HALS-flavored pass.

The per-batch step is ONE jit (encode + stats + sweeps); state lives on
device between calls.  Euclidean objective only (the NNLS encode).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-12


@partial(jax.jit, static_argnames=("sweeps", "solve_method"))
def _online_step(w, a, b_stat, x_t, rho, *, sweeps: int = 2,
                 solve_method: str = "chol"):
    from ..nnls import nnls_activeset

    k = w.shape[1]
    gram = w.T @ w + _EPS * jnp.eye(k, dtype=w.dtype)
    h_t = nnls_activeset(gram, w.T @ x_t, solve_method=solve_method)

    a = rho * a + h_t @ h_t.T
    b_stat = rho * b_stat + x_t @ h_t.T

    # the surrogate's column update is exactly the batch HALS sweep with
    # (XHt, HHt) -> (B, A); reuse that kernel (incl. its unroll tuning)
    from .hals import _hals_sweep_w

    w = jax.lax.fori_loop(
        0, sweeps, lambda t, w: _hals_sweep_w(w, b_stat, a, 0.0, unroll=8), w)
    # per-batch EU diagnostic: post-sweep W against the PRE-sweep encode
    # h_t — a mixed-iterate value (re-encoding against the fresh W would
    # cost a second NNLS per batch), so it can tick up even on a
    # stationary stream; see the track_objective docstring
    d = x_t - w @ h_t
    return w, a, b_stat, h_t, 0.5 * jnp.sum(d * d)


class OnlineNMF:
    """Streaming NMF: ``partial_fit`` minibatches of columns, read ``.w``.

    Args:
      m: row count of the data (fixed across the stream).
      k: rank.
      rho: forgetting factor in (0, 1] — 1.0 accumulates all history
        (stationary streams); < 1 tracks drift.
      sweeps: HALS sweeps over W per minibatch.
      key: PRNG key for the random W init (|N(0,1)|).
      w_init: explicit (m, k) initial basis.
      track_objective: append each batch's EU objective to
        ``obj_history``.  Fetching that scalar forces a host<->device
        sync per minibatch; set False to keep the stream fully async
        (state stays on device between calls either way).  The value is
        a MIXED-ITERATE diagnostic — post-sweep W against the pre-sweep
        encode H_t — so it can increase even on a stationary stream;
        for a consistent objective re-encode with ``transform`` after
        the fact.
    """

    def __init__(self, m: int, k: int, *, rho: float = 1.0,
                 sweeps: int = 2, key=None, w_init=None,
                 dtype=jnp.float32, track_objective: bool = True):
        if not 0.0 < rho <= 1.0:
            raise ValueError("rho must be in (0, 1]")
        self.k = k
        self.rho = float(rho)
        self.sweeps = int(sweeps)
        if w_init is not None:
            w = jnp.asarray(w_init, dtype=dtype)
            if w.shape != (m, k):
                raise ValueError(f"w_init must be ({m}, {k}); got {w.shape}")
        else:
            w = jnp.abs(jax.random.normal(
                key if key is not None else jax.random.PRNGKey(0),
                (m, k), dtype=dtype))
        self._w = w
        self._a = jnp.zeros((k, k), dtype=dtype)
        self._b = jnp.zeros((m, k), dtype=dtype)
        self.n_batches = 0
        self.obj_history: list = []
        self.track_objective = bool(track_objective)
        self._batch_width = 0
        from ..core.backend import defaults

        self._solve_method = defaults().spd_solver

    @property
    def w(self):
        return np.asarray(self._w)

    def partial_fit(self, x_t):
        """Consume one (m, b) column minibatch; returns its encode H_t.

        Ragged batches are zero-padded up to the widest batch seen so
        far — zero columns encode to exactly h = 0, so the sufficient
        statistics are unchanged and the jitted step is not recompiled
        per distinct width (each fresh width otherwise recompiles).
        """
        x_t = jnp.asarray(x_t, dtype=self._w.dtype)
        if x_t.ndim != 2 or x_t.shape[0] != self._w.shape[0]:
            raise ValueError(
                f"minibatch must be ({self._w.shape[0]}, b); got {x_t.shape}")
        width = x_t.shape[1]
        if width < self._batch_width:
            x_t = jnp.pad(x_t, ((0, 0), (0, self._batch_width - width)))
        else:
            self._batch_width = width
        self._w, self._a, self._b, h_t, obj = _online_step(
            self._w, self._a, self._b, x_t,
            jnp.asarray(self.rho, self._w.dtype), sweeps=self.sweeps,
            solve_method=self._solve_method)
        self.n_batches += 1
        if self.track_objective:
            self.obj_history.append(float(obj))
        return h_t[:, :width]

    def transform(self, x_new, **opts):
        """Encode new columns against the current basis (default: exact
        EU NNLS; pass distance_type='kl' for the fixed-W KL encode)."""
        from .transform import transform as _transform

        opts.setdefault("distance_type", "eu")
        return _transform(self._w, x_new, **opts)


def online_nmf(batches, m: int, k: int, **kwargs) -> OnlineNMF:
    """Drive :class:`OnlineNMF` over an iterable of (m, b) minibatches."""
    model = OnlineNMF(m, k, **kwargs)
    for x_t in batches:
        model.partial_fit(x_t)
    return model
