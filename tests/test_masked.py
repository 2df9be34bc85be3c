"""Masked (weighted) MUR — missing-data factorization (beyond-reference).

Oracles: (a) all-ones mask must reproduce the unmasked solver exactly;
(b) a plain numpy implementation of the weighted updates; (c) matrix
completion — heldout entries of a low-rank matrix must be recovered far
better than the column-mean baseline.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tpunmf.solvers import mur, mur_masked


def _numpy_masked_eu_iter(x, m, w, h, lw=0.0, lh=0.0, eps=1e-9):
    w = w * ((m * x) @ h.T) / ((m * (w @ h)) @ h.T + lw * w + eps)
    h = h * (w.T @ (m * x)) / (w.T @ (m * (w @ h)) + lh * h + eps)
    return w, h


def _numpy_masked_kl_iter(x, m, w, h, lw=0.0, lh=0.0, eps=1e-9):
    r = m * x / (w @ h + eps)
    a = w * (r @ h.T)
    b = m @ h.T
    w = 2.0 * a / (b + np.sqrt(b * b + 4.0 * lw * a))
    r2 = m * x / (w @ h + eps)
    c = h * (w.T @ r2)
    d = w.T @ m
    h = 2.0 * c / (d + np.sqrt(d * d + 4.0 * lh * c))
    return w, h


@pytest.fixture
def masked_problem(rng):
    m, n, k = 48, 36, 4
    x = (rng.random((m, k)) @ rng.random((k, n))).astype(np.float64)
    mask = (rng.random((m, n)) < 0.6).astype(np.float64)
    w0 = rng.random((m, k)) + 0.1
    h0 = rng.random((k, n)) + 0.1
    return x, mask, w0, h0


@pytest.mark.parametrize("distance_type", ["eu", "kl"])
def test_all_ones_mask_equals_unmasked(masked_problem, distance_type):
    x, _, w0, h0 = masked_problem
    kw = dict(distance_type=distance_type, w_init=w0, h_init=h0,
              min_iter=8, max_iter=8, tol1=0.0, tol2=0.0)
    res_m = mur_masked(x, np.ones_like(x), 4, **kw)
    res = mur(x, 4, **kw)
    np.testing.assert_allclose(res_m.w, res.w, rtol=1e-10)
    np.testing.assert_allclose(res_m.h, res.h, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(res_m.obj_history),
                               np.asarray(res.obj_history), rtol=1e-10)


@pytest.mark.parametrize("distance_type,oracle", [
    ("eu", _numpy_masked_eu_iter), ("kl", _numpy_masked_kl_iter)])
def test_matches_numpy_oracle(masked_problem, distance_type, oracle):
    x, mask, w0, h0 = masked_problem
    res = mur_masked(x, mask, 4, distance_type=distance_type, w_init=w0,
                     h_init=h0, min_iter=5, max_iter=5, tol1=0.0, tol2=0.0)
    w, h = w0.copy(), h0.copy()
    for _ in range(5):
        w, h = oracle(x, mask, w, h)
    np.testing.assert_allclose(res.w, w, rtol=1e-8)
    np.testing.assert_allclose(res.h, h, rtol=1e-8)


def test_masked_objective_monotone(masked_problem):
    x, mask, w0, h0 = masked_problem
    res = mur_masked(x, mask, 4, distance_type="eu", w_init=w0, h_init=h0,
                     min_iter=2, max_iter=60, tol1=0.0, tol2=0.0)
    o = np.asarray(res.obj_history)
    assert np.all(np.isfinite(o))
    assert np.all(o[1:] <= o[:-1] + 1e-9 * np.abs(o[:-1]))


def test_matrix_completion_beats_mean_baseline(rng):
    """Recover heldout entries of an exactly rank-k matrix from 50% of
    its cells — the point of masked factorization."""
    m, n, k = 60, 50, 3
    truth = rng.random((m, k)) @ rng.random((k, n))
    mask = (rng.random((m, n)) < 0.5)
    res = mur_masked(truth, mask.astype(float), k, distance_type="eu",
                     min_iter=50, max_iter=3000, tol1=1e-14, tol2=1e-14,
                     key=None)
    pred = res.w @ res.h
    held = ~mask
    rmse = np.sqrt(np.mean((pred[held] - truth[held]) ** 2))
    col_mean = np.where(mask, truth, 0).sum(0) / np.maximum(mask.sum(0), 1)
    rmse_base = np.sqrt(np.mean((np.broadcast_to(col_mean, truth.shape)[held]
                                 - truth[held]) ** 2))
    assert rmse < 0.15 * rmse_base  # completion, not imputation-by-mean


def test_masked_weights_and_validation(masked_problem):
    x, mask, w0, h0 = masked_problem
    # non-binary weights are accepted (weighted NMF)
    res = mur_masked(x, 0.5 * mask, 4, distance_type="eu", w_init=w0,
                     h_init=h0, min_iter=3, max_iter=3, tol1=0.0, tol2=0.0)
    assert np.all(np.isfinite(res.obj_history))
    with pytest.raises(ValueError):
        mur_masked(x, mask[:, :-1], 4)
    with pytest.raises(ValueError):
        mur_masked(x, None, 4)


def test_masked_via_facade(masked_problem):
    from tpunmf import NMF

    x, mask, w0, h0 = masked_problem
    model = NMF(x, 4)
    res = model.factorize(method="mur", mask=mask, distance_type="eu",
                          min_iter=3, max_iter=20, tol1=0.0, tol2=0.0)
    assert model.w.shape == (x.shape[0], 4)
    assert len(res.obj_history) == 21


def test_masked_sharded_matches_single_device(masked_problem):
    import jax
    import jax.numpy as jnp
    import pytest as _pytest

    if jax.device_count() < 8:
        _pytest.skip("needs 8 devices")
    from tpunmf.parallel import build_mesh, nmf_shardings

    x, mask, w0, h0 = masked_problem
    kw = dict(distance_type="eu", w_init=w0, h_init=h0, min_iter=3,
              max_iter=20, tol1=0.0, tol2=0.0)
    single = mur_masked(x, mask, 4, **kw)
    mesh = build_mesh(shape=(2, 4), axis_names=("rows", "cols"))
    sh = nmf_shardings(mesh)["v"]
    sharded = mur_masked(jax.device_put(jnp.asarray(x), sh),
                         jax.device_put(jnp.asarray(mask), sh), 4, **kw)
    np.testing.assert_allclose(sharded.w, single.w, rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(sharded.obj_history), np.asarray(single.obj_history),
        rtol=1e-9)


def test_mask_with_schedule_raises(masked_problem):
    from tpunmf import NMF

    x, mask, _, _ = masked_problem
    with pytest.raises(ValueError):
        NMF(x, 4).factorize(method="mur", schedule="ulysses", mask=mask)


def test_masked_kl_cold_rows_and_columns(rng):
    """Fully-unobserved rows/columns (cold users/items) must not NaN the
    KL solver — their factor entries stay at the init value."""
    m, n, k = 20, 16, 3
    x = rng.random((m, n)) + 0.05
    mask = np.ones((m, n))
    mask[3, :] = 0.0   # cold row
    mask[:, 7] = 0.0   # cold column
    w0 = rng.random((m, k)) + 0.1
    h0 = rng.random((k, n)) + 0.1
    res = mur_masked(x, mask, k, distance_type="kl", w_init=w0, h_init=h0,
                     min_iter=3, max_iter=15, tol1=0.0, tol2=0.0)
    assert np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.h))
    assert np.all(np.isfinite(np.asarray(res.obj_history)))
    np.testing.assert_allclose(res.w[3], w0[3])   # untouched
    np.testing.assert_allclose(res.h[:, 7], h0[:, 7])


class TestMaskedStep:
    """The masked XLA step (solvers/masked.py) vs NumPy update formulas."""

    def _problem(self, m=32, n=24, k=4, frac=0.6, seed=2):
        rng = np.random.default_rng(seed)
        x = (rng.random((m, k)) @ rng.random((k, n)) + 0.05).astype(np.float32)
        mask = (rng.random((m, n)) < frac).astype(np.float32)
        mask[3, :] = 0.0  # cold row
        w = (rng.random((m, k)) + 0.1).astype(np.float32)
        h = (rng.random((k, n)) + 0.1).astype(np.float32)
        return x, mask, w, h

    def _np_step(self, x, mask, w, h, lam, dist):
        x, mask, w, h = (np.asarray(a, np.float64) for a in (x, mask, w, h))
        eps = 1e-9
        if dist == "eu":
            w = w * ((mask * x) @ h.T) / ((mask * (w @ h)) @ h.T + lam * w + eps)
            h = h * (w.T @ (mask * x)) / (w.T @ (mask * (w @ h)) + lam * h + eps)
            return w, h
        a = w * ((mask * x / (w @ h + eps)) @ h.T)
        b = mask @ h.T
        den = b + np.sqrt(b * b + 4.0 * lam * a)
        w = np.where(den > 0, 2.0 * a / np.where(den > 0, den, 1.0), w)
        c = h * (w.T @ (mask * x / (w @ h + eps)))
        d = w.T @ mask
        den = d + np.sqrt(d * d + 4.0 * lam * c)
        h = np.where(den > 0, 2.0 * c / np.where(den > 0, den, 1.0), h)
        return w, h

    def _run(self, x, mask, w, h, lam, dist, iters=1):
        return mur_masked(x, mask, w.shape[1], distance_type=dist,
                          w_init=w, h_init=h, lambda_w=lam, lambda_h=lam,
                          min_iter=iters, max_iter=iters, tol1=0.0, tol2=0.0)

    @pytest.mark.parametrize("dist", ["eu", "kl"])
    def test_w_update_matches_jnp(self, dist):
        x, mask, w, h = self._problem()
        res = self._run(x, mask, w, h, 0.05, dist)
        want_w, _ = self._np_step(x, mask, w, h, 0.05, dist)
        np.testing.assert_allclose(res.w, want_w, rtol=2e-5, atol=2e-6)

    @pytest.mark.parametrize("dist", ["eu", "kl"])
    def test_h_update_matches_jnp(self, dist):
        x, mask, w, h = self._problem()
        res = self._run(x, mask, w, h, 0.02, dist)
        _, want_h = self._np_step(x, mask, w, h, 0.02, dist)
        np.testing.assert_allclose(res.h, want_h, rtol=2e-5, atol=2e-6)

    def test_full_block_matches_numpy_iterates(self):
        """Three iterations of the solver block equal three NumPy steps,
        objective included."""
        x, mask, w, h = self._problem()
        res = self._run(x, mask, w, h, 0.1, "eu", iters=3)
        ww, hh = w, h
        for _ in range(3):
            ww, hh = self._np_step(x, mask, ww, hh, 0.1, "eu")
        np.testing.assert_allclose(res.w, ww, rtol=5e-5, atol=1e-5)
        d = mask * (x - ww @ hh)
        np.testing.assert_allclose(res.obj_history[-1], 0.5 * np.sum(d * d),
                                   rtol=1e-5)

    def test_weight_mask_scales_cells(self):
        """A real-valued weight mask re-weights cells: doubling every
        weight leaves the iterates unchanged (the update is homogeneous
        in M) and doubles the EU objective's mask factor squared."""
        x, mask, w, h = self._problem()
        a = self._run(x, mask, w, h, 0.0, "eu", iters=2)
        b = self._run(x, 2.0 * mask, w, h, 0.0, "eu", iters=2)
        np.testing.assert_allclose(a.w, b.w, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(b.obj_history[-1],
                                   4.0 * a.obj_history[-1], rtol=1e-4)
