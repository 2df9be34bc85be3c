"""Serving path: sharded top-k retrieval vs dense oracle."""
import jax
import numpy as np
import pytest

from tpunmf.parallel import build_mesh, nmf_shardings
from tpunmf.serve import recall_at_k, topk_retrieval, topk_scores_dense


@pytest.fixture
def factors(rng):
    b, r, n = 6, 8, 64
    w = rng.random((b, r))
    h = rng.random((r, n))
    return w, h


def test_dense_topk_matches_numpy(factors):
    w, h = factors
    vals, idx = topk_scores_dense(w, h, 5)
    scores = w @ h
    expect_idx = np.argsort(-scores, axis=1)[:, :5]
    np.testing.assert_allclose(
        np.asarray(vals), np.take_along_axis(scores, expect_idx, axis=1),
        rtol=1e-9,
    )


def test_sharded_topk_matches_dense(factors):
    w, h = factors
    mesh = build_mesh(shape=(8,), axis_names=("cols",))
    dense_vals, dense_idx = topk_scores_dense(w, h, 5)
    vals, idx = topk_retrieval(mesh, w, h, 5)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(dense_vals), rtol=1e-9)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(dense_idx))


def test_sharded_topk_with_exclusions(factors, rng):
    w, h = factors
    mesh = build_mesh(shape=(8,), axis_names=("cols",))
    exclude = rng.random((w.shape[0], h.shape[1])) < 0.3
    vals, idx = topk_retrieval(mesh, w, h, 5, exclude=exclude)
    excl = np.asarray(exclude)
    for b in range(w.shape[0]):
        assert not excl[b, np.asarray(idx)[b]].any()


def test_recall_at_k():
    pred = np.array([[1, 2, 3], [4, 5, 6]])
    true = np.array([[1, 9], [4, 5]])
    assert np.isclose(recall_at_k(pred, true), (0.5 + 1.0) / 2)


def test_sharded_topk_on_2d_mesh(factors):
    """Serving straight off the training mesh (rows x cols): H stays
    column-sharded, the rows axis is just replication for retrieval."""
    w, h = factors
    mesh = build_mesh(shape=(2, 4), axis_names=("rows", "cols"))
    dense_vals, dense_idx = topk_scores_dense(w, h, 5)
    vals, idx = topk_retrieval(mesh, w, h, 5)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(dense_idx))


def test_retrieval_cache_reuse(factors):
    """Repeated serving calls reuse the compiled function."""
    from tpunmf.serve import topk as topk_mod

    w, h = factors
    mesh = build_mesh(shape=(8,), axis_names=("cols",))
    before = len(topk_mod._RETRIEVAL_CACHE)
    topk_retrieval(mesh, w, h, 5)
    topk_retrieval(mesh, w, h, 5)
    topk_retrieval(mesh, w, h, 5)
    after = len(topk_mod._RETRIEVAL_CACHE)
    assert after <= before + 1


def test_approximate_retrieval(rng):
    """recall_target < 1 routes through lax.approx_max_k; on CPU the
    fallback is exact, so results must coincide with the exact path."""
    import jax
    import numpy as np

    from tpunmf.parallel import build_mesh, nmf_shardings
    from tpunmf.serve import recall_at_k, topk_retrieval

    if jax.device_count() < 8:
        import pytest

        pytest.skip("needs 8 devices")
    b, r, n, k = 4, 6, 128, 10
    w = rng.random((b, r))
    h = rng.random((r, n))
    mesh = build_mesh(shape=(8,), axis_names=("cols",))
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    hs = jax.device_put(jnp.asarray(h), NamedSharding(mesh, P(None, "cols")))
    v_ex, i_ex = topk_retrieval(mesh, jnp.asarray(w), hs, k)
    v_ap, i_ap = topk_retrieval(mesh, jnp.asarray(w), hs, k,
                                recall_target=0.95)
    rec = recall_at_k(np.asarray(i_ap), np.asarray(i_ex))
    assert rec >= 0.95  # exact on the CPU; >= target on an accelerator
    # single-device approximate path
    v1, i1 = topk_retrieval(None, jnp.asarray(w), jnp.asarray(h), k,
                            recall_target=0.9)
    assert np.asarray(i1).shape == (b, k)


def test_topk_streaming_matches_dense(rng):
    """Panel-streamed retrieval (beyond-HBM H) equals the dense oracle,
    including a ragged last panel."""
    from tpunmf.serve import topk_streaming

    b, r, n, k = 5, 8, 230, 7  # 230 = 3*64 + 38 ragged tail at panel 64
    w = rng.random((b, r))
    h = rng.random((r, n))
    vals, idx = topk_streaming(w, h, n, k, panel_cols=64)
    scores = w @ h
    expect_idx = np.argsort(-scores, axis=1)[:, :k]
    np.testing.assert_array_equal(np.sort(np.asarray(idx), axis=1),
                                  np.sort(expect_idx, axis=1))
    np.testing.assert_allclose(
        np.sort(np.asarray(vals), axis=1)[:, ::-1],
        np.take_along_axis(scores, expect_idx, axis=1), rtol=1e-6)


def test_topk_streaming_exclusion_and_callable(rng):
    from tpunmf.serve import topk_streaming

    b, r, n, k = 4, 6, 100, 5
    w = rng.random((b, r))
    h = rng.random((r, n))
    exclude = np.zeros((b, n), dtype=bool)
    exclude[:, :50] = True  # first half of the catalog is excluded
    vals, idx = topk_streaming(w, lambda s, e: h[:, s:e], n, k,
                               panel_cols=33, exclude=exclude)
    assert np.all(np.asarray(idx) >= 50)
    scores = np.where(exclude, -np.inf, w @ h)
    expect_idx = np.argsort(-scores, axis=1)[:, :k]
    np.testing.assert_array_equal(np.sort(np.asarray(idx), axis=1),
                                  np.sort(expect_idx, axis=1))


def test_topk_streaming_sharded(rng):
    """Streamed panels scored through the sharded two-stage kernel."""
    from tpunmf.serve import topk_streaming

    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    b, r, n, k = 4, 6, 200, 6  # panels of 48 pad to /8; tail 8 cols
    w = rng.random((b, r))
    h = rng.random((r, n))
    mesh = build_mesh(shape=(8,), axis_names=("cols",))
    vals, idx = topk_streaming(w, h, n, k, panel_cols=48, mesh=mesh)
    scores = w @ h
    expect_idx = np.argsort(-scores, axis=1)[:, :k]
    np.testing.assert_array_equal(np.sort(np.asarray(idx), axis=1),
                                  np.sort(expect_idx, axis=1))


def test_topk_streaming_validation(rng):
    from tpunmf.serve import topk_streaming

    with pytest.raises(ValueError):
        topk_streaming(rng.random((2, 4)), rng.random((4, 10)), 10, 11)


def test_topk_streaming_starved_returns_sentinels(rng):
    """When exclusion leaves fewer than k valid items, the -inf-scored
    slots must return index -1, never an excluded/padded item id."""
    from tpunmf.serve import topk_streaming

    b, r, n, k = 3, 5, 70, 6
    w = rng.random((b, r))
    h = rng.random((r, n))
    exclude = np.ones((b, n), dtype=bool)
    exclude[:, :4] = False  # only 4 valid items but k=6 requested
    vals, idx = topk_streaming(w, h, n, k, panel_cols=33, exclude=exclude)
    vals, idx = np.asarray(vals), np.asarray(idx)
    starved = np.isneginf(vals)
    assert starved.sum() == b * (k - 4)
    assert np.all(idx[starved] == -1)
    assert np.all(idx[~starved] < 4)  # the real hits are the valid items


def test_quantized_first_stage_single_device(rng):
    """bf16 stage-1 + exact f32 rescore: with clearly separated top
    scores the result must EQUAL the exact path (quantization can only
    demote items that fall outside the oversampled candidate set)."""
    import jax.numpy as jnp
    from tpunmf.serve import topk_retrieval

    b, r, n, k = 4, 8, 256, 5
    w = rng.random((b, r)).astype(np.float32)
    h = rng.random((r, n)).astype(np.float32)
    # plant well-separated winners so bf16 cannot mis-rank across the
    # candidate boundary
    h[:, :k * 2] += np.linspace(3.0, 1.0, k * 2)[None, :]
    v_ex, i_ex = topk_retrieval(None, jnp.asarray(w), jnp.asarray(h), k)
    v_q, i_q = topk_retrieval(None, jnp.asarray(w), jnp.asarray(h), k,
                              first_stage_dtype="bf16", oversample=4)
    np.testing.assert_array_equal(np.asarray(i_q), np.asarray(i_ex))
    np.testing.assert_allclose(np.asarray(v_q), np.asarray(v_ex), rtol=1e-6)

    with pytest.raises(ValueError):
        topk_retrieval(None, w, h, k, first_stage_dtype="int4")


def test_quantized_first_stage_with_exclusion(rng):
    import jax.numpy as jnp
    from tpunmf.serve import topk_retrieval

    b, r, n, k = 3, 6, 128, 4
    w = rng.random((b, r)).astype(np.float32)
    h = rng.random((r, n)).astype(np.float32)
    exclude = np.zeros((b, n), dtype=bool)
    exclude[:, 64:] = True
    _, idx = topk_retrieval(None, jnp.asarray(w), jnp.asarray(h), k,
                            exclude=jnp.asarray(exclude),
                            first_stage_dtype="bf16", oversample=8)
    assert np.all(np.asarray(idx) < 64)


def test_quantized_first_stage_sharded(rng):
    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpunmf.serve import topk_retrieval

    b, r, n, k = 4, 6, 256, 6
    w = rng.random((b, r)).astype(np.float32)
    h = rng.random((r, n)).astype(np.float32)
    h[:, ::17] += np.arange(1, (n + 16) // 17 + 1)[: h[:, ::17].shape[1]][None, :] * 0.5
    mesh = build_mesh(shape=(8,), axis_names=("cols",))
    hs = jax.device_put(jnp.asarray(h), NamedSharding(mesh, P(None, "cols")))
    v_ex, i_ex = topk_retrieval(mesh, jnp.asarray(w), hs, k)
    v_q, i_q = topk_retrieval(mesh, jnp.asarray(w), hs, k,
                              first_stage_dtype="bf16", oversample=6)
    rec = recall_at_k(np.asarray(i_q), np.asarray(i_ex))
    assert rec >= 0.9
    # scores of the agreed items are exact f32
    agreed = np.asarray(i_q) == np.asarray(i_ex)
    np.testing.assert_allclose(np.asarray(v_q)[agreed],
                               np.asarray(v_ex)[agreed], rtol=1e-6)


def test_quantized_streaming_forwarding(rng):
    from tpunmf.serve import topk_streaming

    b, r, n, k = 3, 8, 150, 5
    w = rng.random((b, r)).astype(np.float32)
    h = rng.random((r, n)).astype(np.float32)
    h[:, :k * 3] += np.linspace(2.0, 0.5, k * 3)[None, :]
    v_q, i_q = topk_streaming(w, h, n, k, panel_cols=50,
                              first_stage_dtype="bf16", oversample=5)
    scores = w @ h
    expect_idx = np.argsort(-scores, axis=1)[:, :k]
    np.testing.assert_array_equal(np.sort(np.asarray(i_q), axis=1),
                                  np.sort(expect_idx, axis=1))


def test_quantized_prestored_hq_matches_cast(rng):
    """A pre-stored bf16 copy (the byte-saving deployment) must give the
    same results as the per-call cast, single-device and sharded."""
    import jax.numpy as jnp
    from tpunmf.serve import topk_retrieval

    b, r, n, k = 4, 8, 256, 5
    w = rng.random((b, r)).astype(np.float32)
    h = rng.random((r, n)).astype(np.float32)
    hq = jnp.asarray(h).astype(jnp.bfloat16)
    v_cast, i_cast = topk_retrieval(None, jnp.asarray(w), jnp.asarray(h), k,
                                    first_stage_dtype="bf16")
    v_pre, i_pre = topk_retrieval(None, jnp.asarray(w), jnp.asarray(h), k,
                                  first_stage_dtype="bf16", h_quantized=hq)
    np.testing.assert_array_equal(np.asarray(i_cast), np.asarray(i_pre))
    np.testing.assert_allclose(np.asarray(v_cast), np.asarray(v_pre))
    with pytest.raises(ValueError, match="requires first_stage_dtype"):
        topk_retrieval(None, w, h, k, h_quantized=hq)
    with pytest.raises(ValueError, match="does not match"):
        topk_retrieval(None, w, h, k, first_stage_dtype="f16", h_quantized=hq)

    if jax.device_count() >= 8:
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = build_mesh(shape=(8,), axis_names=("cols",))
        sh = NamedSharding(mesh, P(None, "cols"))
        hs = jax.device_put(jnp.asarray(h), sh)
        hqs = jax.device_put(hq, sh)
        v_s, i_s = topk_retrieval(mesh, jnp.asarray(w), hs, k,
                                  first_stage_dtype="bf16", h_quantized=hqs)
        v_c, i_c = topk_retrieval(mesh, jnp.asarray(w), hs, k,
                                  first_stage_dtype="bf16")
        np.testing.assert_array_equal(np.asarray(i_s), np.asarray(i_c))


def test_exact_topk_blocked_matches_lax(rng):
    """Blocked exact top-k (per-block top-k + merge) must equal plain
    ``lax.top_k`` bit-for-bit, ties included — lowest index wins.

    Exercised with a small block so the blocked branch actually runs
    (the production _TOPK_BLOCK=16384 only engages past ~32k items) and
    with n NOT a multiple of the block to cover the -inf padding path.
    """
    import jax.numpy as jnp
    from tpunmf.serve.topk import _blocked_topk, _exact_topk

    b, n, k, block = 4, 1000, 17, 128
    scores = rng.random((b, n)).astype(np.float32)
    # force ties across block boundaries: same value at indices in
    # different blocks; lax.top_k breaks ties by lowest index
    scores[:, 5] = 0.999
    scores[:, 400] = 0.999
    scores[:, 900] = 0.999
    s = jnp.asarray(scores)
    v_ref, i_ref = jax.lax.top_k(s, k)
    v_blk, i_blk = _exact_topk(s, k, block=block)
    np.testing.assert_array_equal(np.asarray(i_blk), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(v_blk), np.asarray(v_ref))
    # fallthrough branches: small n, and k >= block
    v2, i2 = _exact_topk(s, k, block=4096)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i_ref))
    v3, i3 = _exact_topk(s, 130, block=128)
    v3r, i3r = jax.lax.top_k(s, 130)
    np.testing.assert_array_equal(np.asarray(i3), np.asarray(i3r))
    # the sort-based fallback path, directly
    vb, ib = _blocked_topk(s, k, block=block)
    np.testing.assert_array_equal(np.asarray(ib), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(vb), np.asarray(v_ref))


def test_exact_topk_forced_fallback_all_ties(rng):
    """Constant scores put EVERY element on the tie boundary — the
    verification must reject the candidate set and lax.cond must take
    the sort-based fallback, still bit-for-bit equal to lax.top_k."""
    import jax.numpy as jnp
    from tpunmf.serve.topk import _exact_topk

    b, n, k, block = 3, 2000, 9, 128
    s = jnp.ones((b, n), jnp.float32) * 0.5
    v_ref, i_ref = jax.lax.top_k(s, k)
    v, i = _exact_topk(s, k, block=block)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v_ref))


def test_exact_topk_exclusion_neg_inf(rng):
    """-inf exclusions reaching the boundary force the fallback and stay
    exact (tau == -inf => infinite tie count mismatch)."""
    import jax.numpy as jnp
    from tpunmf.serve.topk import _exact_topk

    b, n, k, block = 2, 1500, 12, 128
    s = jnp.asarray(rng.random((b, n)).astype(np.float32))
    s = jnp.where(jnp.arange(n)[None, :] >= 5, -jnp.inf, s)  # only 5 finite
    v_ref, i_ref = jax.lax.top_k(s, k)
    v, i = _exact_topk(s, k, block=block)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v_ref))


def test_blockmax_relayout_matches_numpy(rng):
    """Block maxima and the (b, nb, sel_block) view equal a NumPy
    reshape of the finfo.min-padded scores — exact multiples, ragged
    tails, single blocks, and bf16."""
    import jax.numpy as jnp
    from tpunmf.serve.topk import blockmax_relayout

    for b, n, dtype in [(4, 16384, np.float32),
                        (4, 40000, np.float32),
                        (3, 128, np.float32),
                        (8, 20000, jnp.bfloat16)]:
        s = jnp.asarray(rng.standard_normal((b, n)).astype(np.float32)).astype(dtype)
        bm, s3 = blockmax_relayout(s)
        nb = -(-n // 128)
        sn = np.asarray(s, np.float32)
        lo = float(jnp.finfo(dtype).min)
        ref = np.concatenate([sn, np.full((b, nb * 128 - n), lo, np.float32)],
                             axis=1).reshape(b, nb, 128)
        np.testing.assert_array_equal(np.asarray(s3, np.float32), ref)
        np.testing.assert_array_equal(np.asarray(bm, np.float32),
                                      ref.max(axis=-1))
        assert s3.dtype == s.dtype


def test_wide_topk_two_level_matches_lax(rng):
    """The two-level candidate select (engaged when the gathered
    candidate set exceeds _WIDE_TOPK_MIN) must agree with plain
    lax.top_k through _exact_topk's verification: random scores, plus a
    tie pattern crossing inner blocks that forces the fallback."""
    import jax.numpy as jnp
    from tpunmf.serve import topk as st

    b, n, k = 4, 128 * 128 * 3, 150     # nb=384, ksel=158, c=20224 > 16384
    s = jnp.asarray(rng.standard_normal((b, n)).astype(np.float32))
    assert (158 * 128) > st._WIDE_TOPK_MIN  # the wide path really engages
    v_ref, i_ref = jax.lax.top_k(s, k)
    v, i = st._exact_topk(s, k)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v_ref))

    # boundary ties spread across inner blocks: exactness must survive
    # (fast path if the extra absorbs them, else verified fallback)
    st2 = np.asarray(s).copy()
    st2[:, ::997] = st2[:, k - 1:k]  # replicate the boundary value widely
    s2 = jnp.asarray(st2)
    v2_ref, i2_ref = jax.lax.top_k(s2, k)
    v2, i2 = st._exact_topk(s2, k)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i2_ref))


def test_exact_topk_core_without_scores(rng):
    """_exact_topk_core with scores=None (the fused-kernel entry) must
    reconstruct the flat scores for the fallback: all-constant rows
    force it, and the result still equals lax.top_k on the original
    (ragged) width."""
    import jax.numpy as jnp
    from tpunmf.serve.topk import blockmax_relayout
    from tpunmf.serve.topk import _exact_topk_core

    b, n, k = 3, 40000, 9               # ragged: nbp*128 > n
    s = jnp.ones((b, n), jnp.float32) * 0.25
    bm, s3 = blockmax_relayout(s)
    v_ref, i_ref = jax.lax.top_k(s, k)
    v, i = _exact_topk_core(bm, s3, n, k)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v_ref))

    # and the fast path through the core (no ties): same equality
    s = jnp.asarray(rng.standard_normal((b, n)).astype(np.float32))
    bm, s3 = blockmax_relayout(s)
    v_ref, i_ref = jax.lax.top_k(s, k)
    v, i = _exact_topk_core(bm, s3, n, k)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))


def test_scored_topk_matches_lax_at_any_dtype(rng):
    """Scoring + exact top-k: f32 accumulation and output regardless of
    input dtype, ragged tails, multi-block batches — equal to lax.top_k
    over the same f32-accumulated scores."""
    import jax.numpy as jnp
    from tpunmf.serve.topk import _scored_topk

    for b, r, n, dt in [(8, 128, 40000, jnp.float32),
                        (8, 64, 40000, jnp.bfloat16),
                        (96, 32, 50000, jnp.float32)]:
        w = jnp.asarray(rng.random((b, r)).astype(np.float32)).astype(dt)
        h = jnp.asarray(rng.random((r, n)).astype(np.float32)).astype(dt)
        v, i = _scored_topk(w, h, 25, block=128)
        scores = jnp.matmul(w, h, preferred_element_type=jnp.float32)
        v_ref, i_ref = jax.lax.top_k(scores, 25)
        assert v.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
        np.testing.assert_array_equal(np.asarray(v), np.asarray(v_ref))


def test_quantized_stage_scores_are_f32_accumulated(rng):
    """Regression (round 5): the quantized stage-1 matmul must emit f32,
    not bf16 — a bf16 OUTPUT ties many scores at the selection
    threshold, which forced the full-sort fallback on every call.  The
    candidate set must therefore match top-c of the f32-accumulated
    bf16-input scores exactly."""
    import jax.numpy as jnp
    from tpunmf.serve.topk import _quantized_rerank, _scored_topk

    b, r, n, k = 8, 32, 4096, 50
    w = jnp.asarray(rng.random((b, r)).astype(np.float32))
    h = jnp.asarray(rng.random((r, n)).astype(np.float32))
    hq = h.astype(jnp.bfloat16)
    ref_scores = jnp.matmul(w.astype(jnp.bfloat16), hq,
                            preferred_element_type=jnp.float32)
    c = 4 * k
    _, cand_ref = jax.lax.top_k(ref_scores, c)
    _, cand = _scored_topk(w.astype(jnp.bfloat16), hq, c)
    np.testing.assert_array_equal(np.asarray(cand), np.asarray(cand_ref))
    # end-to-end: rerank picks the exact-f32 top-k within the candidates
    vals, idx = _quantized_rerank(w, h, k, "bf16", 4, 1.0, hq=hq)
    exact = jnp.matmul(w, h, preferred_element_type=jnp.float32)
    v_ref, i_ref = jax.lax.top_k(exact, k)
    from tpunmf.serve import recall_at_k
    assert float(recall_at_k(idx, i_ref)) > 0.9


def test_exact_topk_boundary_value_straddles_selection(rng):
    """tau equal to an UNSELECTED block's max (the round-5 fast tier's
    rejection case): exactness must survive via the sort fallback, bit
    for bit, including lowest-index-first tie order.

    sel_extra=0 so ksel == k and the tie block (whose max equals the
    k-th value) is genuinely left out of the selection — with the
    default extra of 8 it would be gathered and the fast tier would
    accept, never exercising the tau == m_next rejection."""
    import jax.numpy as jnp
    from tpunmf.serve.topk import _exact_topk

    b, n, k, block = 2, 129 * 128, 5, 128
    s = rng.random((b, n)).astype(np.float32)
    s[:, :] = np.minimum(s, 0.8)
    for col in (3, 130, 260, 400, 523):       # five early candidates
        s[:, col] = 0.9
    s[:, 128 * 100 + 7] = 0.9                 # tie in unselected block 100
    s = jnp.asarray(s)
    v_ref, i_ref = jax.lax.top_k(s, k)
    v, i = _exact_topk(s, k, block=block, sel_extra=0)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v_ref))
    # with the default extra the tie block IS gathered: fast tier path,
    # same exact result
    v2, i2 = _exact_topk(s, k, block=block)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i_ref))


def test_exact_topk_nan_rows_fall_back(rng):
    """NaN anywhere must force the fallback (fast tier's gathered-strip
    isnan is a complete detector: a NaN block max sorts FIRST in
    lax.top_k, so the NaN block is always gathered) and the result must
    match lax.top_k's NaN-first semantics bit for bit — through both
    _exact_topk and the relayout-core path the fused kernel uses."""
    import jax.numpy as jnp
    from tpunmf.serve.topk import blockmax_relayout
    from tpunmf.serve.topk import _exact_topk, _exact_topk_core

    b, n, k, block = 3, 40000, 7, 128
    s = rng.random((b, n)).astype(np.float32)
    s[0, 12345] = np.nan                      # one NaN in one row
    s[2, 100] = np.nan
    s[2, 39999] = np.nan
    s = jnp.asarray(s)
    v_ref, i_ref = jax.lax.top_k(s, k)
    v, i = _exact_topk(s, k, block=block)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    bm, s3 = blockmax_relayout(s)
    # the NaN must have propagated into the block maxima
    assert bool(jnp.any(jnp.isnan(bm)))
    v2, i2 = _exact_topk_core(bm, s3, n, k, block=block)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i_ref))
