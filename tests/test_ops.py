"""Fused Pallas kernels (Triton route, interpret mode on CPU) vs their
jnp forms, the per-backend table, and the choice of kernel or XLA step."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpunmf.core import backend
from tpunmf.ops import fused

EPS = 1e-9


def _kl_problem(rng, m=64, n=128, k=16, zeros=0.0):
    x = np.asarray(rng.random((m, n)), dtype=np.float32)
    x[x < zeros] = 0.0
    w = jnp.asarray(rng.random((m, k)) + 0.1, dtype=jnp.float32)
    h = jnp.asarray(rng.random((k, n)) + 0.1, dtype=jnp.float32)
    return jnp.asarray(x), w, h


def _kl_w_ref(x, w, h, lam):
    a = w * ((x / (w @ h + EPS)) @ h.T)
    b = jnp.sum(h, axis=1)[None, :]
    return 2.0 * a / (b + jnp.sqrt(b * b + 4.0 * lam * a))


def _kl_h_ref(x, w, h, lam):
    c = h * (w.T @ (x / (w @ h + EPS)))
    d = jnp.sum(w, axis=0)[:, None]
    return 2.0 * c / (d + jnp.sqrt(d * d + 4.0 * lam * c))


def test_tileable_picks_blocks():
    """kernel_fits: 2-D f32/bf16 X and a rank whose padded tile fits."""
    x = jnp.zeros((256, 512), jnp.float32)
    assert fused.kernel_fits(x, 16)
    assert fused.kernel_fits(x.astype(jnp.bfloat16), 50)
    assert fused.kernel_fits(x, fused.MAX_RANK)
    assert not fused.kernel_fits(x, fused.MAX_RANK + 1)
    assert not fused.kernel_fits(x.astype(jnp.float64), 16)
    assert not fused.kernel_fits(jnp.zeros((256,), jnp.float32), 16)


def test_rank_gate_follows_measurement():
    """The kernels take padded ranks up to 64 (config[1]'s rank 50 pads
    to 64) and leave rank 128 to XLA, where the H100 measurement had the
    XLA step faster."""
    x = jnp.zeros((64, 64), jnp.float32)
    assert fused.kernel_fits(x, 50) and fused.kernel_fits(x, 64)
    assert not fused.kernel_fits(x, 65) and not fused.kernel_fits(x, 128)


@pytest.mark.parametrize("k,padded", [(1, 16), (16, 16), (17, 32), (50, 64),
                                      (128, 128), (129, 256)])
def test_rank_padding(k, padded):
    """The rank pads to a power of two >= 16 (Triton's dot minimum) with
    zeros, which leaves W @ H unchanged."""
    assert fused._padded_rank(k) == padded
    w, h = jnp.ones((3, k)), jnp.ones((k, 5))
    wp, hp = fused._pad_factors(w, h)
    assert wp.shape == (3, padded) and hp.shape == (padded, 5)
    np.testing.assert_array_equal(np.asarray(wp @ hp), np.asarray(w @ h))


@pytest.mark.parametrize("shape", [(64, 128, 16), (200, 110, 5)])
def test_eu_obj_kernel_matches_fallback(rng, shape):
    x, w, h = _kl_problem(rng, *shape)
    ref = fused.eu_residual_obj(x, w, h, use_pallas=False)
    out = fused.eu_residual_obj(x, w, h, use_pallas=True, interpret=True)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


@pytest.mark.parametrize("shape", [(64, 128, 8), (200, 110, 5)])
def test_kl_obj_kernel_matches_fallback(rng, shape):
    x, w, h = _kl_problem(rng, *shape, zeros=0.1)
    ref = fused.kl_obj(x, w, h, use_pallas=False)
    out = fused.kl_obj(x, w, h, use_pallas=True, interpret=True)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-4)


def test_objective_kernels_zero_weight_rows(rng):
    """The reference's masking: x > 0 over wh == 0 is +inf -> 0, and
    x == 0 over wh == 0 is NaN -> 0 (nmf/utils.py:23-26)."""
    x, w, h = _kl_problem(rng, 48, 40, 4, zeros=0.3)
    w = w.at[5].set(0.0)
    ref = fused.kl_obj(x, w, h)
    out = fused.kl_obj(x, w, h, use_pallas=True, interpret=True)
    assert np.isfinite(float(out))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-4)


class TestMurFused:
    """KL W/H passes vs the jnp formulas (interpret mode)."""

    @pytest.mark.parametrize("lam", [0.0, 0.2])
    def test_w_update_kl(self, rng, lam):
        x, w, h = _kl_problem(rng)
        got = fused.kl_w_update(x, w, h, lam, interpret=True)
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(_kl_w_ref(x, w, h, lam)),
                                   rtol=2e-4)

    @pytest.mark.parametrize("lam", [0.0, 0.1])
    def test_h_update_kl(self, rng, lam):
        x, w, h = _kl_problem(rng)
        got = fused.kl_h_update(x, w, h, lam, interpret=True)
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(_kl_h_ref(x, w, h, lam)),
                                   rtol=2e-4)

    def test_output_shapes_and_dtypes(self, rng):
        x, w, h = _kl_problem(rng, 37, 150, 20)
        wn = fused.kl_w_update(x.astype(jnp.bfloat16), w, h, 0.0,
                               interpret=True)
        hn = fused.kl_h_update(x, w, h, 0.0, interpret=True)
        assert wn.shape == w.shape and wn.dtype == jnp.float32
        assert hn.shape == h.shape and hn.dtype == jnp.float32


def test_mur_fused_bf16_data(rng):
    """bf16 X storage with f32 factors: the W pass widens X in registers,
    so it equals the f32 formula on the bf16-rounded data."""
    x32, w, h = _kl_problem(rng)
    x16 = x32.astype(jnp.bfloat16)
    got = fused.kl_w_update(x16, w, h, 0.0, interpret=True)
    expect = _kl_w_ref(x16.astype(jnp.float32), w, h, 0.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                               rtol=2e-4)


def test_w_update_kl_lagged_obj(rng):
    """The lagged-objective KL W pass returns KL(x, w@h) of the incoming
    factors alongside the same updated W."""
    x, w, h = _kl_problem(rng, zeros=0.1)
    plain = fused.kl_w_update(x, w, h, 0.0, interpret=True)
    lagged_w, obj = fused.kl_w_update(x, w, h, 0.0, with_obj=True,
                                      interpret=True)
    np.testing.assert_allclose(np.asarray(lagged_w), np.asarray(plain),
                               rtol=1e-6)
    np.testing.assert_allclose(float(obj), float(fused.kl_obj(x, w, h)),
                               rtol=1e-4)


def _jaxpr_pallas_params(fn, *args):
    """Params of every pallas_call in fn's jaxpr."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                out.append(eqn.params)
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def test_kernels_name_route_and_stable_names(rng):
    """Every kernel names the Triton route explicitly (a call that names
    none gets Mosaic GPU in this JAX) and carries a stable name a trace
    can find."""
    x, w, h = _kl_problem(rng, 32, 32, 4)
    calls = {
        "mur_kl_w_pass": lambda x, w, h: fused.kl_w_update(x, w, h, 0.0),
        "mur_kl_w_pass_obj": lambda x, w, h: fused.kl_w_update(
            x, w, h, 0.0, with_obj=True),
        "mur_kl_h_pass": lambda x, w, h: fused.kl_h_update(x, w, h, 0.0),
        "kl_objective": lambda x, w, h: fused.kl_obj(x, w, h, use_pallas=True),
        "eu_objective": lambda x, w, h: fused.eu_residual_obj(
            x, w, h, use_pallas=True),
    }
    for name, fn in calls.items():
        (params,) = _jaxpr_pallas_params(fn, x, w, h)
        assert params["backend"] == "triton"
        assert params["name"] == name


def _kernel_dot_precisions(fn, *args):
    """precision of every dot_general inside fn's Pallas kernels."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    for params in _jaxpr_pallas_params(fn, *args):
        walk(params["jaxpr"])
    return out


def test_kernel_precision_follows_caller(rng):
    """The X-sized products inside the kernels take the caller's matmul
    precision: none pinned by default (TF32 on the H100), HIGHEST under
    jax.default_matmul_precision('highest')."""
    x, w, h = _kl_problem(rng, 32, 32, 4)
    f = lambda x, w, h: fused.kl_h_update(x, w, h, 0.0)
    default = _kernel_dot_precisions(f, x, w, h)
    assert len(default) == 2
    assert all(p is None for p in default)
    with jax.default_matmul_precision("highest"):
        highest = _kernel_dot_precisions(f, x, w, h)
    assert all(p == (jax.lax.Precision.HIGHEST,) * 2 for p in highest)


# ----------------------------------------------------- per-backend table


def test_backend_table_gpu_row():
    row = backend.defaults("gpu")
    assert row.pallas
    assert row.spd_solver == "chol" and row.cg_iters == 0
    assert row.nnls_precision == "highest"
    assert row.inner_loop == "while"
    assert row.rsvd_threshold == backend.defaults("cpu").rsvd_threshold


def test_backend_table_cpu_row():
    row = backend.defaults("cpu")
    assert not row.pallas
    assert row.spd_solver == "chol" and row.cg_iters == 0
    assert row.nnls_precision is None and row.inner_loop == "while"


def test_backend_table_unknown_backend_raises():
    with pytest.raises(ValueError, match="no per-backend defaults"):
        backend.defaults("metal")


def test_backend_table_default_is_current_backend():
    assert backend.defaults() is backend.defaults(jax.default_backend())


# ------------------------------------------------ kernel or XLA step


@pytest.fixture
def as_gpu(monkeypatch):
    """Make the table answer as on the GPU (the choice is pure Python)."""
    monkeypatch.setattr(backend.jax, "default_backend", lambda: "gpu")


def test_use_kernels_cpu_default_is_xla(rng):
    x = jnp.ones((64, 32), jnp.float32)
    assert backend.use_kernels(x, 8, None) is False
    assert backend.use_kernels(x, 8, False) is False


def test_use_pallas_true_on_cpu_raises():
    """No kernel on this backend: an explicit request is an error, never
    a silent fall back to the interpreter or to XLA."""
    x = jnp.ones((64, 32), jnp.float32)
    with pytest.raises(ValueError, match="no Pallas kernels"):
        backend.use_kernels(x, 8, True)


def test_mur_use_pallas_true_on_cpu_raises():
    from tpunmf.solvers import mur

    x = np.ones((16, 12), np.float32)
    with pytest.raises(ValueError, match="no Pallas kernels"):
        mur(x, 2, use_pallas=True, max_iter=2)


@pytest.mark.parametrize("dtype,k,want", [
    (jnp.float32, 8, True),
    (jnp.bfloat16, 50, True),
    (jnp.float64, 8, False),            # no f64 kernel: XLA step
    (jnp.float32, fused.MAX_RANK + 1, False),
])
def test_use_kernels_shapes_and_dtypes(as_gpu, dtype, k, want):
    x = jnp.ones((64, 32), dtype)
    assert backend.use_kernels(x, k, None) is want
    assert backend.use_kernels(x, k, False) is False


def test_use_kernels_sharded_x_takes_xla(as_gpu):
    """A pallas_call is not partitioned, so a sharded X would be gathered
    whole onto every device: sharded inputs take the XLA step."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices()[:4])
    if devs.size < 2:
        pytest.fail("conftest provides 8 CPU devices")
    mesh = Mesh(devs, ("cols",))
    x = jax.device_put(jnp.ones((16, 64), jnp.float32),
                       NamedSharding(mesh, P(None, "cols")))
    assert backend.use_kernels(x, 8, None) is False
    assert backend.use_kernels(x, 8, True) is False
    one = jax.device_put(jnp.ones((16, 64), jnp.float32), jax.devices()[0])
    assert backend.use_kernels(one, 8, None) is True


def _interpret_kernels(monkeypatch):
    """Route mur's kernel calls through interpret mode (CPU stand-in for
    the compiled kernels) so the whole solver step can be checked."""
    import importlib

    mur_mod = importlib.import_module("tpunmf.solvers.mur")
    for name in ("kl_w_update", "kl_h_update"):
        monkeypatch.setattr(mur_mod, name, functools.partial(
            getattr(fused, name), interpret=True))
    monkeypatch.setattr(mur_mod, "kl_obj", functools.partial(
        fused.kl_obj, interpret=True))
    return mur_mod


@pytest.mark.parametrize("objective_every", [1, 3])
def test_kernel_step_matches_xla_step(monkeypatch, rng, objective_every):
    """The solver's kernel step (3 fused passes) equals its XLA step
    (ratio carried between passes) over several iterations."""
    mur_mod = _interpret_kernels(monkeypatch)
    x, w, h = _kl_problem(rng, 40, 56, 4, zeros=0.2)
    kw = dict(distance_type="kl", min_iter=6, max_iter=6, tol1=0.0,
              tol2=0.0, w_init=w, h_init=h, objective_every=objective_every)
    monkeypatch.setattr(mur_mod, "use_kernels", lambda x, k, up: True)
    got = mur_mod.mur(x, 4, **kw)
    monkeypatch.setattr(mur_mod, "use_kernels", lambda x, k, up: False)
    ref = mur_mod.mur(x, 4, **kw)
    np.testing.assert_allclose(got.w, ref.w, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.h, ref.h, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.obj_history),
                               np.asarray(ref.obj_history), rtol=1e-4)


def test_kernel_step_lagged_objective(monkeypatch, rng):
    """objective='lagged' records KL of the incoming iterate from the W
    pass: entry i+1 of the lagged trace is entry i of the exact one."""
    mur_mod = _interpret_kernels(monkeypatch)
    monkeypatch.setattr(mur_mod, "use_kernels", lambda x, k, up: True)
    x, w, h = _kl_problem(rng, 40, 56, 4, zeros=0.2)
    kw = dict(distance_type="kl", min_iter=5, max_iter=5, tol1=0.0,
              tol2=0.0, w_init=w, h_init=h)
    exact = mur_mod.mur(x, 4, objective="exact", **kw)
    lagged = mur_mod.mur(x, 4, objective="lagged", **kw)
    np.testing.assert_allclose(lagged.w, exact.w, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(lagged.obj_history)[1:],
                               np.asarray(exact.obj_history)[:-1], rtol=1e-4)
