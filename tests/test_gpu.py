"""The Pallas kernels as compiled for the GPU (Triton route), against
the jnp forms on the same card.  Marked ``gpu``: they skip without a
card (see conftest.py for the command that runs them on one)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpunmf.ops import fused

pytestmark = pytest.mark.gpu


def _problem(m, n, k, dtype, seed=0):
    kx, kz, kw, kh = jax.random.split(jax.random.PRNGKey(seed), 4)
    x = jax.random.uniform(kx, (m, n)) * (jax.random.uniform(kz, (m, n)) < 0.1)
    w = jax.random.uniform(kw, (m, k)) + 0.1
    h = jax.random.uniform(kh, (k, n)) + 0.1
    return x.astype(dtype), w, h


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_kl_passes_match_jnp_on_gpu(gpu, dtype):
    """Ragged 2003 x 1101 at rank 50 (padded to 64), 'highest' on both
    sides: the compiled passes agree with the jnp formulas to f32
    summation order."""
    x, w, h = _problem(2003, 1101, 50, dtype)
    xf = x.astype(jnp.float32)
    with jax.default_matmul_precision("highest"):
        r = xf / (w @ h + 1e-9)
        w_ref = w * (r @ h.T) / jnp.sum(h, axis=1)[None, :]
        h_ref = h * (w.T @ r) / jnp.sum(w, axis=0)[:, None]
        w_got, obj = fused.kl_w_update(x, w, h, 0.0, with_obj=True)
        h_got = fused.kl_h_update(x, w, h, 0.0)
        obj_ref = fused.kl_obj(xf, w, h)
        kl_got = fused.kl_obj(x, w, h, use_pallas=True)
        eu_got = fused.eu_residual_obj(x, w, h, use_pallas=True)
        eu_ref = fused.eu_residual_obj(xf, w, h)
    np.testing.assert_allclose(np.asarray(w_got), np.asarray(w_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(h_got), np.asarray(h_ref), rtol=1e-5)
    for got, ref in ((obj, obj_ref), (kl_got, obj_ref), (eu_got, eu_ref)):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_mur_kernel_path_matches_xla_on_gpu(gpu):
    from tpunmf.solvers import mur

    x, w, h = _problem(1500, 900, 32, jnp.float32, seed=1)
    kw = dict(distance_type="kl", min_iter=10, max_iter=10, tol1=0.0,
              tol2=0.0, w_init=w, h_init=h)
    with jax.default_matmul_precision("highest"):
        a = mur(x, 32, use_pallas=True, **kw)
        b = mur(x, 32, use_pallas=False, **kw)
    np.testing.assert_allclose(np.asarray(a.obj_history),
                               np.asarray(b.obj_history), rtol=1e-5)
