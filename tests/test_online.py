"""Online NMF (streaming sufficient statistics, beyond-reference)."""
import numpy as np
import pytest

from tpunmf.solvers import OnlineNMF, online_nmf


@pytest.fixture
def stream_problem(rng):
    m, k_true, n = 40, 4, 240
    w_true = rng.random((m, k_true)) + 0.05
    h_true = rng.random((k_true, n))
    x = w_true @ h_true
    return x, w_true


def test_online_learns_basis(stream_problem, rng):
    """After streaming the columns (2 epochs), new data drawn from the
    same basis encodes with tiny residual."""
    x, w_true = stream_problem
    m, n = x.shape
    model = OnlineNMF(m, 4, key=None)
    for _ in range(4):
        for s in range(0, n, 24):
            model.partial_fit(x[:, s:s + 24])
    x_new = w_true @ np.random.default_rng(7).random((4, 30))
    h = np.asarray(model.transform(x_new))
    rel = np.linalg.norm(x_new - model.w @ h) / np.linalg.norm(x_new)
    assert rel < 0.05
    # per-batch objective trends down across epochs
    objs = model.obj_history
    assert np.mean(objs[-5:]) < np.mean(objs[:5])


def test_sufficient_stats_match_numpy(rng):
    """One partial_fit step reproduces a numpy transcription."""
    from tpunmf.nnls import nnls_activeset

    m, k, b = 20, 3, 8
    w0 = rng.random((m, k)) + 0.1
    x_t = rng.random((m, b))
    import jax.numpy as jnp
    model = OnlineNMF(m, k, w_init=w0, sweeps=1, dtype=jnp.float64)
    h_t = np.asarray(model.partial_fit(x_t))

    h_ref = np.asarray(nnls_activeset(
        w0.T @ w0 + 1e-12 * np.eye(k), w0.T @ x_t))
    np.testing.assert_allclose(h_t, h_ref, atol=1e-10)
    a = h_ref @ h_ref.T
    b_stat = x_t @ h_ref.T
    w = w0.copy()
    for l in range(k):
        upd = w[:, l] + (b_stat[:, l] - w @ a[:, l]) / (a[l, l] + 1e-12)
        w[:, l] = np.maximum(upd, 0.0)
    np.testing.assert_allclose(model.w, w, rtol=1e-6, atol=1e-10)


def test_forgetting_and_validation(rng):
    m = 16
    model = OnlineNMF(m, 3, rho=0.9)
    assert model._solve_method == "chol"  # the table's spd_solver
    model.partial_fit(rng.random((m, 5)))
    assert model.n_batches == 1
    with pytest.raises(ValueError):
        OnlineNMF(m, 3, rho=0.0)
    with pytest.raises(ValueError):
        model.partial_fit(rng.random((m + 1, 5)))
    with pytest.raises(ValueError):
        OnlineNMF(m, 3, w_init=rng.random((m, 4)))


def test_online_nmf_driver(stream_problem):
    x, _ = stream_problem
    m, n = x.shape
    batches = [x[:, s:s + 40] for s in range(0, n, 40)]
    model = online_nmf(batches, m, 4)
    assert model.n_batches == len(batches)
    assert model.w.shape == (m, 4) and np.all(model.w >= 0)


def test_ragged_batches_pad_exactly(rng):
    """Zero-padding ragged batches encodes pad columns to h=0, so the
    sufficient statistics (and W) match the unpadded sequence exactly."""
    import jax.numpy as jnp

    m, k = 18, 3
    w0 = rng.random((m, k)) + 0.1
    xa = rng.random((m, 8))
    xb = rng.random((m, 5))           # ragged tail
    model = OnlineNMF(m, k, w_init=w0, dtype=jnp.float64)
    model.partial_fit(xa)
    h_tail = model.partial_fit(xb)
    assert h_tail.shape == (k, 5)

    ref = OnlineNMF(m, k, w_init=w0, dtype=jnp.float64)
    ref.partial_fit(xa)
    ref.partial_fit(np.pad(xb, ((0, 0), (0, 3))))
    np.testing.assert_allclose(model.w, ref.w, rtol=1e-12)

    # transform accepts an explicit distance_type (was a TypeError)
    h = model.transform(xa[:, :2], distance_type="kl", n_iter=20)
    assert np.all(np.isfinite(np.asarray(h)))
