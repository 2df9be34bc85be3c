"""Shape fuzz tier: the Triton-route Pallas kernels in interpret mode
across dtype x (m, n, k) x tile-boundary combinations, and the XLA steps
that run everywhere else, each against the jnp / NumPy step formulas.

Interpret mode validates the math and the indexing (ragged-edge masks,
the rank padding, the per-program partial sums); what only the GPU's
compiler enforces (shared memory, registers) is checked on the card by
the ``gpu``-marked tests and chip_smoke.py.

Reference math: nmf/mur.py:20-49 (updates), nmf/utils.py (objectives);
masked variants per solvers/masked.py's formulas; HALS per the rank-1
closed form in solvers/hals.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpunmf.ops import fused

EPS = 1e-9


def _problem(seed, m, n, k, zeros=False):
    rng = np.random.default_rng(seed)
    x = (rng.random((m, n)) + 0.05).astype(np.float32)
    if zeros:
        x[x < 0.3] = 0.0
    w = (rng.random((m, k)) + 0.1).astype(np.float32)
    h = (rng.random((k, n)) + 0.1).astype(np.float32)
    return jnp.asarray(x), jnp.asarray(w), jnp.asarray(h)


def _np_kl_w(x, w, h, lam):
    a = w * ((x / (w @ h + EPS)) @ h.T)
    b = np.sum(h, axis=1)[None, :]
    return 2.0 * a / (b + np.sqrt(b * b + 4.0 * lam * a))


def _np_kl_h(x, w, h, lam):
    c = h * (w.T @ (x / (w @ h + EPS)))
    d = np.sum(w, axis=0)[:, None]
    return 2.0 * c / (d + np.sqrt(d * d + 4.0 * lam * c))


def _np_kl_obj(x, w, h):
    wh = w @ h
    with np.errstate(divide="ignore", invalid="ignore"):
        val = x * np.log(x / wh)
    val[~np.isfinite(val)] = 0.0
    return np.sum(val - x + wh)


def _f64(*a):
    return [np.asarray(jnp.asarray(v).astype(jnp.float32), np.float64)
            for v in a]


# (m, n, k, bm, bn) — single tile, exact multiples, ragged edges on each
# axis (the config[1] case: no power-of-two tile divides m or n), m or n
# below one tile, ranks that pad (1, 5, 20, 33) and one that does not
KERNEL_SHAPES = [
    (16, 16, 4, 16, 16),       # one tile, rank pads 4 -> 16
    (64, 128, 8, 16, 32),      # 4 x 4 tiles
    (200, 110, 5, 64, 64),     # ragged both axes
    (37, 150, 20, 16, 64),     # ragged, rank 20 -> 32
    (128, 64, 16, 32, 32),     # exact multiples, rank 16 unpadded
    (96, 300, 12, 32, 64),     # ragged columns
    (20, 1000, 1, 16, 128),    # rank 1, wide
    (130, 70, 33, 64, 16),     # rank 33 -> 64
    (10, 12, 3, 16, 16),       # smaller than one tile
]
IDS = [f"{m}x{n}x{k}" for m, n, k, _, _ in KERNEL_SHAPES]


@pytest.mark.parametrize("dist", ["f32", "bf16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=IDS)
@pytest.mark.parametrize("lam", [0.0, 0.15])
def test_w_update_fuzz(shape, dist, lam):
    """KL W pass for f32 and bf16 X (parameter ``dist`` is X's dtype)."""
    m, n, k, bm, bn = shape
    x, w, h = _problem(m * 1000 + n + k, m, n, k)
    if dist == "bf16":
        x = x.astype(jnp.bfloat16)
    got = fused.kl_w_update(x, w, h, lam, tiles=(bm, bn, 4, 2),
                            interpret=True)
    assert got.shape == (m, k)
    np.testing.assert_allclose(np.asarray(got), _np_kl_w(*_f64(x, w, h), lam),
                               rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("dist", ["f32", "bf16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES[:6], ids=IDS[:6])
def test_h_update_fuzz(shape, dist):
    m, n, k, bm, bn = shape
    lam = 0.05
    x, w, h = _problem(m + n * 31 + k, m, n, k)
    if dist == "bf16":
        x = x.astype(jnp.bfloat16)
    got = fused.kl_h_update(x, w, h, lam, tiles=(bm, bn, 4, 2),
                            interpret=True)
    assert got.shape == (k, n)
    np.testing.assert_allclose(np.asarray(got), _np_kl_h(*_f64(x, w, h), lam),
                               rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=IDS)
def test_objective_fuzz(shape, dist):
    """Objective kernels: per-program partial sums over ragged tiles."""
    m, n, k, bm, bn = shape
    x, w, h = _problem(m * 7 + n + k, m, n, k, zeros=dist == "kl")
    tiles = (bm, bn, 4, 2)
    xn, wn, hn = _f64(x, w, h)
    if dist == "kl":
        got = fused.kl_obj(x, w, h, use_pallas=True, tiles=tiles,
                           interpret=True)
        want = _np_kl_obj(xn, wn, hn)
    else:
        got = fused.eu_residual_obj(x, w, h, use_pallas=True, tiles=tiles,
                                    interpret=True)
        want = 0.5 * np.sum((xn - wn @ hn) ** 2)
    np.testing.assert_allclose(float(got), want, rtol=1e-4)


@pytest.mark.parametrize("shape", KERNEL_SHAPES[:5], ids=IDS[:5])
def test_w_update_lagged_obj_fuzz(shape):
    m, n, k, bm, bn = shape
    x, w, h = _problem(m + n + k * 13, m, n, k, zeros=True)
    w1, obj = fused.kl_w_update(x, w, h, 0.2, with_obj=True,
                                tiles=(bm, bn, 4, 2), interpret=True)
    xn, wn, hn = _f64(x, w, h)
    np.testing.assert_allclose(np.asarray(w1), _np_kl_w(xn, wn, hn, 0.2),
                               rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(float(obj), _np_kl_obj(xn, wn, hn),
                               rtol=1e-4)


# ------------------------------------------- the XLA steps, vs NumPy

# (m, n, k): full-m strip, multi-strip, k % 8 != 0
STEP_SHAPES = [
    (32, 128, 8),
    (64, 128, 8),
    (96, 256, 16),
    (128, 384, 12),
    (48, 128, 24),
    (256, 128, 8),
]


def _one_mur_iteration(x, w, h, dist, lam=0.0):
    from tpunmf.solvers import mur

    return mur(x, w.shape[1], distance_type=dist, min_iter=1, max_iter=1,
               tol1=0.0, tol2=0.0, lambda_w=lam, lambda_h=lam,
               w_init=w, h_init=h, use_pallas=False)


@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", STEP_SHAPES,
                         ids=[f"{m}x{n}x{k}" for m, n, k in STEP_SHAPES])
def test_step_eu_fuzz(shape, xdtype):
    """One EU-MUR iteration of the XLA step (Gram-trick denominators),
    incl. bf16 X with f32 factors, vs the NumPy update formulas."""
    m, n, k = shape
    lam = 0.1
    x, w, h = _problem(m * 7 + n + k, m, n, k)
    if xdtype == "bf16":
        x = x.astype(jnp.bfloat16)
    res = _one_mur_iteration(x, w, h, "eu", lam)
    xn, wn, hn = _f64(x, w, h)
    w1 = wn * (xn @ hn.T) / (wn @ (hn @ hn.T) + lam * wn + EPS)
    h1 = hn * (w1.T @ xn) / ((w1.T @ w1) @ hn + lam * hn + EPS)
    np.testing.assert_allclose(res.w, w1, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(res.h, h1, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(res.obj_history[-1],
                               0.5 * np.sum((xn - w1 @ h1) ** 2), rtol=1e-4)


@pytest.mark.parametrize("shape", STEP_SHAPES[:5],
                         ids=[f"{m}x{n}x{k}" for m, n, k in STEP_SHAPES[:5]])
def test_step_kl_fuzz(shape):
    """One KL-MUR iteration of the XLA step (ratio carried between
    passes) vs the NumPy closed forms, with exact zeros in X."""
    m, n, k = shape
    lam = 0.2
    x, w, h = _problem(m + n + k * 13, m, n, k, zeros=True)
    res = _one_mur_iteration(x, w, h, "kl", lam)
    xn, wn, hn = _f64(x, w, h)
    w1 = _np_kl_w(xn, wn, hn, lam)
    h1 = _np_kl_h(xn, w1, hn, lam)
    np.testing.assert_allclose(res.w, w1, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(res.h, h1, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(res.obj_history[-1], _np_kl_obj(xn, w1, h1),
                               rtol=1e-4)


MASKED_SHAPES = [
    (8, 128, 4),
    (32, 256, 8),
    (24, 384, 12),
    (64, 128, 16),
]


@pytest.mark.parametrize("mask_kind", ["binary", "weights"])
@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("shape", MASKED_SHAPES,
                         ids=[f"{m}x{n}x{k}" for m, n, k in MASKED_SHAPES])
def test_masked_updates_fuzz(shape, dist, mask_kind):
    """One masked-MUR iteration (the XLA step) with binary masks and
    real-valued weight masks, cold row included, vs NumPy."""
    from tpunmf.solvers import mur_masked

    m, n, k = shape
    lam = 0.05
    rng = np.random.default_rng(m * 31 + n + k)
    x, w, h = _problem(m + n + k, m, n, k)
    mask = (rng.random((m, n)) < 0.6).astype(np.float32)
    mask[min(3, m - 1), :] = 0.0  # cold row
    if mask_kind == "weights":
        mask *= (0.5 + rng.random((m, n))).astype(np.float32)
    res = mur_masked(x, mask, k, distance_type=dist, min_iter=1, max_iter=1,
                     tol1=0.0, tol2=0.0, lambda_w=lam, lambda_h=lam,
                     w_init=w, h_init=h)
    xn, wn, hn = _f64(x, w, h)
    mf = mask.astype(np.float64)
    if dist == "eu":
        w1 = wn * ((mf * xn) @ hn.T) / ((mf * (wn @ hn)) @ hn.T + lam * wn + EPS)
        h1 = hn * (w1.T @ (mf * xn)) / (w1.T @ (mf * (w1 @ hn)) + lam * hn + EPS)
    else:
        a = wn * ((mf * xn / (wn @ hn + EPS)) @ hn.T)
        b = mf @ hn.T
        den = b + np.sqrt(b * b + 4.0 * lam * a)
        w1 = np.where(den > 0, 2.0 * a / np.where(den > 0, den, 1.0), wn)
        c = hn * (w1.T @ (mf * xn / (w1 @ hn + EPS)))
        d = w1.T @ mf
        den = d + np.sqrt(d * d + 4.0 * lam * c)
        h1 = np.where(den > 0, 2.0 * c / np.where(den > 0, den, 1.0), hn)
    np.testing.assert_allclose(res.w, w1, rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(res.h, h1, rtol=3e-4, atol=3e-5)


def _np_hals_sweep(v, cross, gram, lam):
    """Gauss-Seidel rank-1 sweep over the columns of v (NumPy oracle)."""
    v = v.copy()
    for l in range(v.shape[1]):
        numer = cross[:, l] - v @ gram[:, l] + v[:, l] * gram[l, l]
        v[:, l] = np.maximum(numer / (gram[l, l] + lam + 1e-16), 0.0)
    return v


HALS_SHAPES = [(32, 128, 8), (64, 256, 8), (96, 128, 16), (64, 384, 24)]


@pytest.mark.parametrize("nsweeps", [1, 2])
@pytest.mark.parametrize("shape", HALS_SHAPES,
                         ids=[f"{m}x{n}x{k}" for m, n, k in HALS_SHAPES])
def test_hals_sweep_w_fuzz(shape, nsweeps):
    from tpunmf.solvers.hals import _hals_sweep_w

    m, n, k = shape
    lam = 0.05
    x, w, h = _problem(m * 3 + n + k, m, n, k)
    xht, hht = x @ h.T, h @ h.T
    got = w
    for _ in range(nsweeps):
        got = _hals_sweep_w(got, xht, hht, lam)
    want = np.asarray(w, np.float64)
    for _ in range(nsweeps):
        want = _np_hals_sweep(want, *_f64(xht, hht), lam)
    np.testing.assert_allclose(np.asarray(got), want, rtol=3e-4, atol=3e-4)


GS_SHAPES = [(16, 8), (32, 8), (64, 16), (48, 24)]


@pytest.mark.parametrize("unroll", [1, 8])
@pytest.mark.parametrize("shape", GS_SHAPES,
                         ids=[f"n{n}k{k}" for n, k in GS_SHAPES])
def test_hals_sweep_h_fuzz(shape, unroll):
    from tpunmf.solvers.hals import _hals_sweep_h

    n, k = shape
    m = 40
    x, w, h = _problem(n * 5 + k, m, n, k)
    wtx, wtw = w.T @ x, w.T @ w
    got = _hals_sweep_h(h, wtx, wtw, 0.1, unroll=unroll)
    wtx_n, wtw_n = _f64(wtx, wtw)
    want = _np_hals_sweep(np.asarray(h, np.float64).T, wtx_n.T, wtw_n, 0.1).T
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-4)


def test_fuzz_combo_count():
    """The tier sweeps >= 50 distinct shape combinations."""
    count = (len(KERNEL_SHAPES) * 2 * 2        # W pass: dtype x lam
             + 6 * 2                           # H pass: dtype
             + len(KERNEL_SHAPES) * 2          # objectives
             + 5                               # lagged W pass
             + len(STEP_SHAPES) * 2 + 5        # XLA EU / KL steps
             + len(MASKED_SHAPES) * 2 * 2      # dist x mask kind
             + len(HALS_SHAPES) * 2            # nsweeps
             + len(GS_SHAPES) * 2)             # unroll
    assert count >= 50, count


# (b, n, dtype): exact multiples of the 128-wide block, ragged tails just
# above and below, odd batches, bf16 — the block-max producer behind the
# serving exact top-k (serve/topk.py)
BLOCKMAX_SHAPES = [
    (1, 16384, "f32"),
    (4, 16383, "f32"),
    (4, 16385, "f32"),
    (3, 32768, "f32"),
    (7, 50000, "f32"),
    (8, 131072, "bf16"),
    (5, 99999, "bf16"),
]


@pytest.mark.parametrize("shape", BLOCKMAX_SHAPES,
                         ids=[f"{b}x{n}-{d}" for b, n, d in BLOCKMAX_SHAPES])
def test_blockmax_relayout_fuzz(shape):
    from tpunmf.serve.topk import _exact_topk, blockmax_relayout

    b, n, d = shape
    dtype = jnp.bfloat16 if d == "bf16" else jnp.float32
    rng = np.random.default_rng(b * 100000 + n)
    s = jnp.asarray(rng.standard_normal((b, n)).astype(np.float32)).astype(dtype)
    bmax, s3 = blockmax_relayout(s)
    sn = np.asarray(s, np.float32)
    nb = -(-n // 128)
    assert s3.shape == (b, nb, 128) and bmax.shape == (b, nb)
    lo = float(jnp.finfo(dtype).min)
    # tail fill is finfo.min, never -inf (0 * -inf NaN-poisons consumers)
    padded = np.concatenate([sn, np.full((b, nb * 128 - n), lo, np.float32)],
                            axis=1).reshape(b, nb, 128)
    np.testing.assert_array_equal(np.asarray(s3, np.float32), padded)
    np.testing.assert_array_equal(np.asarray(bmax, np.float32),
                                  padded.max(axis=-1))
    k = 10
    v, i = _exact_topk(s, k, block=128)
    v_ref, i_ref = jax.lax.top_k(s, k)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
