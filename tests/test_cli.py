"""CLI smoke tests (python -m tpunmf ...)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(args, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "tpunmf", *args],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=240,
    )


@pytest.fixture
def data_file(tmp_path, rng):
    path = tmp_path / "data.npy"
    np.save(path, (rng.random((60, 40)) ** 2).astype(np.float32))
    return str(path)


def test_factorize_command(tmp_path, data_file):
    r = _run_cli(
        ["factorize", data_file, "-k", "4", "-m", "mur", "--distance-type",
         "eu", "--min-iter", "3", "--max-iter", "20", "--tol1", "1e-6",
         "--tol2", "1e-6", "--nndsvd", "zero", "--save-dir", str(tmp_path / "out")],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    payload = json.loads(
        [l for l in r.stdout.splitlines() if l.startswith("{")][0]
    )
    assert payload["iterations"] == 19
    saved = os.listdir(tmp_path / "out")
    assert saved and saved[0].startswith("nmf_mur_4_eu")


def test_grid_command(tmp_path, data_file):
    r = _run_cli(
        ["grid", data_file, "-k", "4", "-m", "mur", "--features", "3,4",
         "--lambda-w", "0,0.1", "--distance-type", "eu", "--min-iter", "2",
         "--max-iter", "8", "--no-save"],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(l) for l in r.stdout.splitlines() if l.startswith("{")]
    assert len(rows) == 4
    assert {row["k"] for row in rows} == {3, 4}


def test_unknown_command(tmp_path, data_file):
    r = _run_cli(["explode"], tmp_path)
    assert r.returncode != 0


def test_mur_lambda_grid_matches_sequential(lowrank_data):
    """The vmapped lambda grid reproduces per-combination solver runs."""
    import numpy as np

    from tpunmf.experiments import mur_lambda_grid
    from tpunmf.solvers import mur

    rng = np.random.default_rng(0)
    w0 = rng.random((lowrank_data.shape[0], 4)) + 0.1
    h0 = rng.random((4, lowrank_data.shape[1])) + 0.1
    lws, lhs = (0.0, 0.1), (0.0, 0.05)
    combos, ws, hs, objs = mur_lambda_grid(
        lowrank_data, 4, lambda_w=lws, lambda_h=lhs, n_iter=15,
        w_init=w0, h_init=h0)
    assert len(combos) == 4 and ws.shape[0] == 4 and objs.shape == (4, 15)
    for b, (lw, lh) in enumerate(combos):
        ref = mur(lowrank_data, 4, distance_type="eu", lambda_w=lw,
                  lambda_h=lh, w_init=w0, h_init=h0, min_iter=15,
                  max_iter=15, tol1=0.0, tol2=0.0, objective="exact")
        np.testing.assert_allclose(np.asarray(ws[b]), ref.w, rtol=1e-9)
        np.testing.assert_allclose(
            np.asarray(objs[b]), np.asarray(ref.obj_history)[1:], rtol=1e-9)


def test_mur_lambda_grid_mesh_sharded(lowrank_data):
    """Sharding the grid's batch axis across a mesh matches the local run."""
    import numpy as np

    from tpunmf.experiments import mur_lambda_grid
    from tpunmf.parallel import build_mesh

    import jax

    mesh = build_mesh(shape=(4,), axis_names=("grid",),
                      devices=jax.devices()[:4])
    lws, lhs = (0.0, 0.1), (0.0, 0.05)
    rng = np.random.default_rng(1)
    w0 = rng.random((lowrank_data.shape[0], 4)) + 0.1
    h0 = rng.random((4, lowrank_data.shape[1])) + 0.1
    combos, ws, hs, objs = mur_lambda_grid(
        lowrank_data, 4, lambda_w=lws, lambda_h=lhs, n_iter=12,
        w_init=w0, h_init=h0, mesh=mesh, grid_axis="grid")
    combos2, ws2, hs2, objs2 = mur_lambda_grid(
        lowrank_data, 4, lambda_w=lws, lambda_h=lhs, n_iter=12,
        w_init=w0, h_init=h0)
    assert combos == combos2
    np.testing.assert_allclose(np.asarray(objs), np.asarray(objs2), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ws), np.asarray(ws2), rtol=1e-6)
    import pytest

    with pytest.raises(ValueError):
        mur_lambda_grid(lowrank_data, 4, lambda_w=(0.0, 0.1, 0.2),
                        n_iter=2, mesh=mesh, grid_axis="grid")


def test_mur_lambda_grid_kl(lowrank_data):
    import numpy as np

    from tpunmf.experiments import mur_lambda_grid

    combos, ws, hs, objs = mur_lambda_grid(
        lowrank_data + 0.05, 3, lambda_w=(0.0, 0.2), distance_type="kl",
        n_iter=10)
    assert np.all(np.isfinite(np.asarray(objs)))
    # objective decreases for every combination
    o = np.asarray(objs)
    assert np.all(o[:, -1] <= o[:, 0])


def test_rank_scan_finds_true_rank(rng):
    """Dispersion of the seed-consensus matrix peaks at the generative
    rank of a well-separated synthetic mixture."""
    from tpunmf.experiments import rank_scan

    m, n, k_true = 60, 48, 3
    # well-separated block structure: each column dominated by one component
    h = np.zeros((k_true, n))
    for j in range(n):
        h[j % k_true, j] = 1.0
    h += 0.02 * rng.random((k_true, n))
    w = rng.random((m, k_true)) + 0.1
    x = w @ h
    res = rank_scan(x, ks=(2, 3, 5), n_seeds=6, n_iter=150)
    by_k = {r["k"]: r["dispersion"] for r in res}
    assert by_k[3] > 0.95                     # stable at the true rank
    assert by_k[3] >= by_k[5] - 1e-9          # overfit rank is not better
    assert all(0.0 <= r["dispersion"] <= 1.0 + 1e-9 for r in res)


def test_grid_rejects_ntf_and_robust(tmp_path, data_file):
    for method in ("ntf", "robust"):
        r = _run_cli(["grid", data_file, "-k", "3", "-m", method,
                      "--no-save"], tmp_path)
        assert r.returncode == 2
        assert "grid does not support" in r.stderr
