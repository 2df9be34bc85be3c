"""Serving path: sharded W @ H^T scoring + distributed top-k retrieval.

Absent in the reference (SURVEY §2C 'Serving path'); mandated by
BASELINE.json: "once W, H converge, serve top-k item retrieval as a sharded
W @ H^T scoring + approximate top-k kernel".

Design: H stays column-sharded on the mesh exactly as it was during
training (items axis).  A batch of user rows of W is scored against every
item shard locally (one GEMM per shard), each shard takes a local
``lax.top_k``, and the merge is an all-gather of the tiny
(batch, k_per_shard) candidate sets followed by a final top-k — the
standard two-stage exact top-k (exact as long as k <= k-per-shard, which
holds since we use the same k both stages).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

_TOPK_BLOCK = 16384


def blockmax_relayout(scores, sel_block: int = 128):
    """(b, n) scores -> (block maxima (b, nb), relayout (b, nb, sel_block)).

    nb = ceil(n / sel_block); the ragged tail block is filled with
    ``finfo(dtype).min`` (NOT -inf: downstream consumers may feed the
    blocks through arithmetic where ``0 * -inf`` would poison NaNs).  On
    a row-major buffer the reshape is a bitcast; only a ragged n pays a
    padded copy.
    """
    b, n = scores.shape
    pad = -n % sel_block
    if pad:
        scores = jnp.concatenate(
            [scores, jnp.full((b, pad), jnp.finfo(scores.dtype).min,
                              scores.dtype)], axis=1)
    s3 = scores.reshape(b, -1, sel_block)
    return jnp.max(s3, -1), s3


def _blocked_topk(scores, k: int, block: int = _TOPK_BLOCK):
    """Exact top-k via per-block top-k + merge (sort-based fallback).

    Blocking is exact (every global top-k element is a top-k element of
    its own block).  Tie order matches plain ``lax.top_k`` (lowest index
    first): candidates are laid out block-major with index-ordered ties
    inside each block, and indices in earlier blocks are strictly
    smaller.  Still sort-dominated — used only as the rare-miss fallback
    of :func:`_exact_topk`.
    """
    b, n = scores.shape
    if n <= 2 * block or k >= block:
        return jax.lax.top_k(scores, k)
    nb = -(-n // block)
    if nb * block != n:
        pad = jnp.full((b, nb * block - n), -jnp.inf, scores.dtype)
        scores = jnp.concatenate([scores, pad], axis=1)
    vals, idx = jax.lax.top_k(scores.reshape(b, nb, block), k)
    base = (jnp.arange(nb, dtype=idx.dtype) * block)[None, :, None]
    gidx = (idx + base).reshape(b, nb * k)
    v2, pos = jax.lax.top_k(vals.reshape(b, nb * k), k)
    return v2, jnp.take_along_axis(gidx, pos, axis=1)


def _exact_topk(scores, k: int, block: int = _TOPK_BLOCK,
                sel_block: int = 128, sel_extra: int = 8):
    """EXACT top-k over a wide item axis without sorting every element.

    ``lax.top_k`` over the full row can lower to an O(n log n) sort of
    every element.  (``approx_max_k`` was measured missing up to 2
    boundary elements per row in ~25% of rows even at 8x oversampling —
    useless as an exact candidate source.)

    Deterministic block-max selection instead:

      1. per-block maxima M over contiguous blocks of ``sel_block``
         columns.  The k-th largest block max M_(k) is a LOWER bound on
         the k-th global value tau: the k blocks achieving M_(1..k)
         each contain an element >= M_(k), so
         count(scores >= M_(k)) >= k;
      2. every element >= tau therefore lives in a block with
         max >= tau >= M_(k) — i.e. in one of the top-(k) blocks by
         max.  Gather the top-(k + sel_extra) blocks (extra absorbs
         block-max ties) and take the top-k of their contents: a sort
         over (k+8)*sel_block elements instead of n;
      3. restore lax.top_k's lowest-index-first tie order by re-sorting
         the small result by (value desc, global index asc);
      4. verify with ONE comparison pass: counts of elements > tau-hat
         and == tau-hat (tau-hat = the k-th selected value) must match
         between the gathered candidate set and the full array;
         mismatch (boundary ties straddling dropped blocks) falls back
         to the sort-based blocked merge under ``lax.cond``.  Exactness
         is unconditional; the fast path covers everything but
         pathological tie patterns.

    Step 1 is :func:`blockmax_relayout`, whose (b, nb, sel_block) view
    lets step 2 gather whole blocks.
    """
    b, n = scores.shape
    if n <= 2 * block or k >= block:
        return jax.lax.top_k(scores, k)

    bmax, s3 = blockmax_relayout(scores, sel_block)
    return _exact_topk_core(bmax, s3, n, k, sel_block=sel_block,
                            sel_extra=sel_extra, block=block, scores=scores)


# candidate sets wider than this use a second blockmax level instead of
# a flat lax.top_k over the whole (b, ksel * sel_block) strip (the
# quantized stage's oversample*k candidates make that strip wide)
_WIDE_TOPK_MIN = 16384
_WIDE_INNER_BLOCK = 8
_WIDE_INNER_EXTRA = 32


def _wide_topk(flat, kk: int):
    """top-kk of a WIDE (b, c) matrix via a second block-max level.

    Same lower-bound argument as :func:`_exact_topk`: every element
    strictly greater than the kk-th selected value is captured; ties AT
    the boundary value may be dropped when they straddle non-selected
    inner blocks (``_WIDE_INNER_EXTRA`` absorbs most block-max ties).
    Callers must run the full verification pass — this helper alone is
    not tie-exact.  ``c`` must be a multiple of ``_WIDE_INNER_BLOCK``
    (holds: c = ksel * sel_block, sel_block % 8 == 0).
    """
    b, c = flat.shape
    ib = _WIDE_INNER_BLOCK
    nb2 = c // ib
    f3 = flat.reshape(b, nb2, ib)
    m2 = jnp.max(f3, -1)
    ks2 = min(kk + _WIDE_INNER_EXTRA, nb2)
    _, b2 = jax.lax.top_k(m2, ks2)
    g2 = jnp.take_along_axis(f3, b2[:, :, None], axis=1).reshape(b, ks2 * ib)
    v, p = jax.lax.top_k(g2, kk)
    idx = jnp.take_along_axis(b2, p // ib, axis=1) * ib + p % ib
    return v, idx


def _exact_topk_core(bmax, s3, n: int, k: int, *, sel_block: int = 128,
                     sel_extra: int = 8, block: int = _TOPK_BLOCK,
                     scores=None):
    """Steps 2-4 of :func:`_exact_topk`, from a (block maxima, relayout)
    pair.

    Verification is TIERED (round 5).  The fast tier never touches the
    full array again: if tau strictly exceeds the best UNSELECTED block
    max ``m_next``, then every element >= tau lives in a gathered block
    (an element v >= tau would need block max >= v >= tau > m_next, so
    its block was selected) — the gathered set is provably a superset
    of everything at or above the boundary, and the count comparison
    only needs to run gathered-vs-candidates over the small gathered
    strip.  NaNs cannot hide either: a NaN anywhere makes its block max
    NaN (``jnp.max`` propagates NaN), and lax.top_k's total order puts NaN FIRST, so a
    NaN block is always gathered — ``isnan`` over the gathered strip is
    a complete detector.  When the fast tier rejects, the sort fallback
    runs directly: a full-array count verification (the pre-round-5
    tier) is PROVABLY redundant here — candidates ⊆ gathered ⊆ full
    array means the global count equality implies the gathered one, and
    tau >= m_next always holds (the k-th candidate is >= the k-th block
    max >= m_next), so tau == m_next puts an un-gathered element == tau
    in the array and the global eq-count exceeds the candidates' — the
    full check could never accept a fast-tier rejection.  Exactness
    (values AND lax.top_k tie order) stays unconditional.

    ``scores`` is only needed by the rare tie/NaN fallback; when absent
    it is reconstructed from ``s3`` (one relayout, paid only on
    fallback; tail blocks hold ``finfo.min`` padding which the
    ``tau > lo`` guard keeps out of the fast tier).
    """
    b, nb = bmax.shape
    ksel = min(k + sel_extra, nb)
    if ksel < nb:
        bvals, bidx_all = jax.lax.top_k(bmax, ksel + 1)
        bidx = bidx_all[:, :ksel]                        # (b, ksel)
        m_next = bvals[:, ksel:ksel + 1]                 # (b, 1)
    else:
        _, bidx = jax.lax.top_k(bmax, ksel)
        m_next = jnp.full((b, 1), -jnp.inf, bmax.dtype)  # nothing unselected
    gath = jnp.take_along_axis(s3, bidx[:, :, None], axis=1)
    c = ksel * sel_block
    kk = min(k + sel_extra, c)
    flat = gath.reshape(b, c)
    if c > _WIDE_TOPK_MIN and kk < c // _WIDE_INNER_BLOCK:
        v1, p1 = _wide_topk(flat, kk)
    else:
        v1, p1 = jax.lax.top_k(flat, kk)
    # global index of each selected element
    gidx = (jnp.take_along_axis(bidx, p1 // sel_block, axis=1) * sel_block
            + p1 % sel_block)
    # lax.top_k tie order: value desc, then global index asc
    neg_v, idx_sorted = jax.lax.sort((-v1, gidx), num_keys=2)
    vals_sorted = -neg_v
    tau = vals_sorted[:, k - 1:k]                        # (b, 1)

    lo = jnp.finfo(s3.dtype).min
    gt_cand = jnp.sum(vals_sorted > tau, axis=1)
    eq_cand = jnp.sum(vals_sorted == tau, axis=1)

    # fast tier: gathered-only checks (no full-array pass)
    gt_gath = jnp.sum(flat > tau, axis=1)
    eq_gath = jnp.sum(flat == tau, axis=1)
    nan_gath = jnp.any(jnp.isnan(flat))
    fast_ok = (jnp.all(tau > m_next)
               & jnp.all((gt_gath == gt_cand) & (eq_gath == eq_cand))
               & ~nan_gath & jnp.all(tau > lo))

    accept = (vals_sorted[:, :k], idx_sorted[:, :k])

    if scores is None:
        def sort_fallback(s3_):
            flat_scores = s3_.reshape(b, nb * sel_block)[:, :n]
            return _blocked_topk(flat_scores, k, block)

        fb_operand, fb = s3, sort_fallback
    else:
        fb_operand, fb = scores, lambda s: _blocked_topk(s, k, block)

    # NOTE: the fallback is batch-global (one pathological row pays the
    # full sort for the whole batch) — under jit a per-row select would
    # have to COMPUTE the sort for every batch unconditionally, which
    # costs more than the rare all-rows fallback.
    return jax.lax.cond(
        fast_ok,
        lambda op: accept,
        fb,
        fb_operand,
    )


def _acc_type(w_batch, h):
    """Accumulation/output dtype for scoring matmuls: at LEAST f32 (a
    bf16 output's 8-bit mantissa ties scores and defeats the verified
    fast path), but never below the natural result type (f64 inputs on
    the x64 CPU path keep f64)."""
    return jnp.promote_types(jnp.result_type(w_batch, h), jnp.float32)


def _scored_topk(w_batch, h, k: int, block: int = _TOPK_BLOCK,
                 sel_block: int = 128, sel_extra: int = 8):
    """score (w_batch @ h, f32 accumulation) + exact top-k."""
    scores = jnp.matmul(w_batch, h,
                        preferred_element_type=_acc_type(w_batch, h))
    n = h.shape[1]
    if n <= 2 * block or k >= block:
        return jax.lax.top_k(scores, k)
    return _exact_topk(scores, k, block=block, sel_block=sel_block,
                       sel_extra=sel_extra)


@partial(jax.jit, static_argnames=("k",))
def topk_scores_dense(w_batch, h, k: int):
    """Single-device scoring + top-k: returns (values, item_indices)."""
    return _scored_topk(w_batch, h, k)


_FIRST_STAGE_DTYPES = {"bf16": jnp.bfloat16, "f16": jnp.float16}


@partial(jax.jit, static_argnames=("k", "dtype_name", "oversample",
                                   "recall_target"))
def _quantized_rerank(w_batch, h, k: int, dtype_name: str, oversample: int,
                      recall_target: float, exclude=None, hq=None):
    """Two-stage retrieve-then-rerank with a quantized first stage.

    Stage 1 scores EVERY item in a low-precision dtype and keeps
    ``oversample * k`` candidates; stage 2 gathers just those candidates'
    f32 columns and re-scores exactly, so quantization can only demote
    items whose f32 score falls below the (oversample*k)-th candidate —
    near-ties inside the candidate set are ranked at full precision.

    The HBM-byte saving of the bandwidth-bound stage-1 pass is real only
    when ``hq`` is a PRE-STORED low-precision copy of H (serving keeps H
    twice: f32 for the rescore, bf16 for scoring).  Without ``hq`` the
    cast happens inside this call, and XLA either fuses it into the GEMM
    (H still read as f32 — no saving) or materializes a copy per call
    (extra traffic); the result is identical either way, only the bytes
    differ.
    """
    q = _FIRST_STAGE_DTYPES[dtype_name]
    n = h.shape[1]
    c = min(oversample * k, n)
    if hq is None:
        hq = h.astype(q)
    if exclude is None and recall_target >= 1.0:
        # low-precision H read with f32 accumulation AND f32 output: a
        # bf16 OUTPUT would tie up to ~90 of 1M scores at the selection
        # threshold via the 8-bit mantissa, making _exact_topk's
        # tie-verification fail on most rows and take the full-sort
        # fallback on every call
        _, cand = _scored_topk(w_batch.astype(q), hq, c)  # (b, c)
    else:
        scores_q = jnp.matmul(w_batch.astype(q), hq,
                              preferred_element_type=jnp.float32)
        if exclude is not None:
            scores_q = jnp.where(exclude, -jnp.inf, scores_q)
        if recall_target < 1.0:
            _, cand = jax.lax.approx_max_k(scores_q, c,
                                           recall_target=recall_target)
        else:
            _, cand = _exact_topk(scores_q, c)            # (b, c)
    h_cand = jnp.take(h.T, cand, axis=0)                  # (b, c, r)
    scores = jnp.einsum("br,bcr->bc", w_batch, h_cand)    # exact rescore
    if exclude is not None:
        excl_cand = jnp.take_along_axis(exclude, cand, axis=1)
        scores = jnp.where(excl_cand, -jnp.inf, scores)
    vals, pos = jax.lax.top_k(scores, k)
    return vals, jnp.take_along_axis(cand, pos, axis=1)


# jitted retrieval callables cached per (mesh, k, n, with-exclusion) —
# serving must not re-trace per request.  Bounded LRU so long-lived
# serving processes that cycle through meshes/configs don't pin dead
# Mesh objects (and their device buffers) forever.
from collections import OrderedDict

_RETRIEVAL_CACHE: OrderedDict = OrderedDict()
_RETRIEVAL_CACHE_MAX = 32


def _build_sharded_retrieval(mesh: Mesh, k: int, n: int, with_exclude: bool,
                             recall_target: float = 1.0,
                             first_stage_dtype: str | None = None,
                             oversample: int = 2, with_hq: bool = False):
    n_shards = mesh.shape["cols"]
    n_local = n // n_shards

    def f(w_b, h_loc, excl_loc=None, hq_loc=None):
        kk = min(k, n_local)
        if first_stage_dtype is not None:
            # quantized stage-1 scoring + exact local rescore of the
            # oversampled candidates (see _quantized_rerank)
            vals, idx = _quantized_rerank(
                w_b, h_loc, kk, first_stage_dtype, oversample,
                recall_target, exclude=excl_loc, hq=hq_loc)
            offset = jax.lax.axis_index("cols") * n_local
            idx = idx + offset
            all_vals = jax.lax.all_gather(vals, "cols", axis=1, tiled=True)
            all_idx = jax.lax.all_gather(idx, "cols", axis=1, tiled=True)
            out_vals, pos = jax.lax.top_k(all_vals, k)
            out_idx = jnp.take_along_axis(all_idx, pos, axis=1)
            return out_vals, out_idx
        if excl_loc is None and recall_target >= 1.0:
            # same scoring + exact block-max path as the dense route
            vals, idx = _scored_topk(w_b, h_loc, kk)
        else:
            scores = jnp.matmul(w_b, h_loc,
                                preferred_element_type=_acc_type(w_b, h_loc))
            if excl_loc is not None:
                scores = jnp.where(excl_loc, -jnp.inf, scores)
            if recall_target < 1.0:
                # approximate top-k (partial reduce): much cheaper than the full sort at large n_local, with
                # the requested per-shard recall (the final cross-shard
                # re-rank below is exact over the gathered candidates)
                vals, idx = jax.lax.approx_max_k(
                    scores, kk, recall_target=recall_target)
            else:
                vals, idx = _exact_topk(scores, kk)  # local candidates
        offset = jax.lax.axis_index("cols") * n_local
        idx = idx + offset
        # gather candidates from every shard and re-rank
        all_vals = jax.lax.all_gather(vals, "cols", axis=1, tiled=True)
        all_idx = jax.lax.all_gather(idx, "cols", axis=1, tiled=True)
        out_vals, pos = jax.lax.top_k(all_vals, k)
        out_idx = jnp.take_along_axis(all_idx, pos, axis=1)
        return out_vals, out_idx

    out_specs = (P(None, None), P(None, None))
    base = [P(None, None), P(None, "cols")]
    if with_exclude and with_hq:
        mapped = shard_map(
            f, mesh=mesh,
            in_specs=tuple(base + [P(None, "cols"), P(None, "cols")]),
            out_specs=out_specs, check_vma=False,
        )
    elif with_exclude:
        mapped = shard_map(
            lambda w_b, h_loc, e: f(w_b, h_loc, e), mesh=mesh,
            in_specs=tuple(base + [P(None, "cols")]),
            out_specs=out_specs, check_vma=False,
        )
    elif with_hq:
        mapped = shard_map(
            lambda w_b, h_loc, hq: f(w_b, h_loc, None, hq), mesh=mesh,
            in_specs=tuple(base + [P(None, "cols")]),
            out_specs=out_specs, check_vma=False,
        )
    else:
        mapped = shard_map(
            lambda w_b, h_loc: f(w_b, h_loc), mesh=mesh,
            in_specs=tuple(base),
            out_specs=out_specs, check_vma=False,
        )
    return jax.jit(mapped)


def topk_retrieval(mesh: Mesh | None, w_batch, h, k: int, exclude=None,
                   recall_target: float = 1.0,
                   first_stage_dtype: str | None = None,
                   oversample: int = 2, h_quantized=None):
    """Top-k item retrieval for a batch of user factors.

    Args:
      mesh: device mesh with a 'cols' axis (H column-sharded), or None for
        the single-device path.
      w_batch: (b, r) user factor rows (replicated).
      h: (r, n) item factors, column-sharded over 'cols' when mesh given.
      k: number of items to return per user.
      exclude: optional (b, n) bool mask of items to exclude (e.g. already
        interacted) — applied before ranking.
      recall_target: 1.0 (default) = exact two-stage top-k; < 1.0 switches
        the per-shard stage to ``lax.approx_max_k``
        partial reduction with that expected per-shard recall — the
        "approximate top-k kernel" of the BASELINE north star, for item
        counts where the full per-shard sort dominates.
      first_stage_dtype: None (exact f32 scoring) or 'bf16'/'f16' — score
        every item in that dtype first, keep ``oversample * k``
        candidates, then gather their f32 columns and re-rank exactly.
        Composes with ``recall_target``.
      oversample: candidate multiplier for the quantized first stage.
        Default 2: at (64, 1M) r128 bf16 recall@100 was the same at
        oversample 2, 4 and 8 (the residual loss is f32
        accumulation-order noise between the full-GEMM ranking and the
        gathered-candidate rescore, not quantization loss), while the
        wider candidate top-c costs time.  Raise it for catalogs with
        adversarially near-tied scores.
      h_quantized: optional PRE-STORED low-precision copy of ``h`` in the
        ``first_stage_dtype`` dtype (same (r, n) shape/sharding).  This
        is what realizes the byte saving of the bandwidth-bound stage-1
        scoring pass — serving keeps H twice (f32 + bf16).  Without it
        the cast happens per call (identical results, no byte saving).

    Returns: (values (b, k), indices (b, k)) global item indices.
    The compiled retrieval function is cached per
    (mesh, k, n, exclusion, recall_target, first-stage config) so
    repeated serving calls don't re-trace.
    """
    if first_stage_dtype is not None and first_stage_dtype not in _FIRST_STAGE_DTYPES:
        raise ValueError("first_stage_dtype must be None, 'bf16' or 'f16'")
    if h_quantized is not None:
        if first_stage_dtype is None:
            raise ValueError("h_quantized requires first_stage_dtype")
        if h_quantized.dtype != _FIRST_STAGE_DTYPES[first_stage_dtype]:
            raise ValueError(
                f"h_quantized dtype {h_quantized.dtype} does not match "
                f"first_stage_dtype {first_stage_dtype!r}")
    if mesh is None or "cols" not in mesh.axis_names:
        if first_stage_dtype is not None:
            return _quantized_rerank(
                w_batch, jnp.asarray(h), k, first_stage_dtype, oversample,
                recall_target, exclude=exclude, hq=h_quantized)
        if exclude is None and recall_target >= 1.0:
            # f32-accumulated scoring — same fast path as topk_scores_dense; a low-precision
            # matmul OUTPUT here would tie scores at the selection
            # threshold and force the sort fallback every call
            return _scored_topk(w_batch, jnp.asarray(h), k)
        scores = jnp.matmul(w_batch, h,
                            preferred_element_type=_acc_type(w_batch, h))
        if exclude is not None:
            scores = jnp.where(exclude, -jnp.inf, scores)
        if recall_target < 1.0:
            return jax.lax.approx_max_k(scores, k, recall_target=recall_target)
        return _exact_topk(scores, k)

    n = h.shape[1]
    n_shards = mesh.shape["cols"]
    if n % n_shards:
        raise ValueError(f"items axis {n} not divisible by 'cols'={n_shards}")

    cache_key = (mesh, k, n, exclude is not None, recall_target,
                 first_stage_dtype, oversample, h_quantized is not None)
    fn = _RETRIEVAL_CACHE.get(cache_key)
    if fn is None:
        fn = _build_sharded_retrieval(mesh, k, n, exclude is not None,
                                      recall_target, first_stage_dtype,
                                      oversample,
                                      with_hq=h_quantized is not None)
        _RETRIEVAL_CACHE[cache_key] = fn
        while len(_RETRIEVAL_CACHE) > _RETRIEVAL_CACHE_MAX:
            _RETRIEVAL_CACHE.popitem(last=False)
    else:
        _RETRIEVAL_CACHE.move_to_end(cache_key)
    args = [w_batch, h]
    if exclude is not None:
        args.append(exclude)
    if h_quantized is not None:
        args.append(h_quantized)
    return fn(*args)


@partial(jax.jit, static_argnames=("k",))
def _merge_topk(vals_a, idx_a, vals_b, idx_b, k: int):
    """Merge two (b, >=k) candidate sets into the global top-k."""
    vals = jnp.concatenate([vals_a, vals_b], axis=1)
    idx = jnp.concatenate([idx_a, idx_b], axis=1)
    out_vals, pos = jax.lax.top_k(vals, k)
    return out_vals, jnp.take_along_axis(idx, pos, axis=1)


def topk_streaming(w_batch, h_source, n: int, k: int, *,
                   panel_cols: int = 65536, mesh: Mesh | None = None,
                   exclude=None, recall_target: float = 1.0,
                   first_stage_dtype: str | None = None,
                   oversample: int = 2):
    """Top-k retrieval when H exceeds (aggregate) device memory.

    The item factors arrive from the host in column panels —
    ``h_source[:, start:stop]`` (numpy array / memmap) or a callable
    ``(start, stop) -> (r, stop-start)`` — are scored on device panel by
    panel (through the same exact/approximate two-stage kernel as
    :func:`topk_retrieval` when a mesh is given), and a running (b, k)
    candidate set is merged on device after each panel.  Peak device
    memory is one panel plus the candidates, so the item count is
    bounded by host storage, not HBM — the serving analog of the
    out-of-core streaming solver (solvers/streaming.py).

    Args:
      w_batch: (b, r) user factor rows.
      h_source: sliceable or callable source of H column panels.
      n: total item count.
      k: items to return per user.
      panel_cols: columns per streamed panel (the last panel may be short).
      mesh: optional mesh with a 'cols' axis for sharded panel scoring.
      exclude: optional (b, n) bool host array of items to exclude.
      recall_target: forwarded to the per-panel ranking (see
        :func:`topk_retrieval`).
      first_stage_dtype / oversample: forwarded to the per-panel ranking
        (quantized first stage + exact rescore, see :func:`topk_retrieval`).

    Returns: (values (b, k), indices (b, k)) global item indices.
    """
    import numpy as np

    if k > n:
        raise ValueError(f"k={k} exceeds the item count n={n}")
    take = min(panel_cols, n)
    slicer = h_source if callable(h_source) else (
        lambda s, e: h_source[:, s:e])

    b = w_batch.shape[0]
    # candidates carry the ACTUAL score dtype end-to-end (taken from the
    # first panel's results, so f64 H panels aren't truncated): downcasting
    # before the cross-panel merge could mis-rank near-ties
    vals = None
    idx = jnp.full((b, k), -1, dtype=jnp.int32)
    n_shards = mesh.shape["cols"] if (
        mesh is not None and "cols" in mesh.axis_names) else 1

    for start in range(0, n, take):
        stop = min(start + take, n)
        panel = np.asarray(slicer(start, stop))
        width = stop - start
        pad = (-width) % max(n_shards, 1)
        excl_panel = None
        if exclude is not None:
            excl_panel = np.asarray(exclude[:, start:stop])
        if pad:
            # ragged tail: pad columns are masked out via the exclusion
            # path so they can never enter the candidate set
            panel = np.pad(panel, ((0, 0), (0, pad)))
            full = np.zeros((b, width + pad), dtype=bool)
            full[:, width:] = True
            if excl_panel is not None:
                full[:, :width] = excl_panel
            excl_panel = full
        kk = min(k, panel.shape[1])
        p_vals, p_idx = topk_retrieval(
            mesh, w_batch, jnp.asarray(panel), kk,
            exclude=None if excl_panel is None else jnp.asarray(excl_panel),
            recall_target=recall_target,
            first_stage_dtype=first_stage_dtype, oversample=oversample)
        if vals is None:
            vals = jnp.full((b, k), -jnp.inf, dtype=p_vals.dtype)
        vals, idx = _merge_topk(
            vals, idx,
            p_vals.astype(vals.dtype),
            (p_idx + start).astype(jnp.int32), k)
    # fewer than k valid items overall (heavy exclusion / ragged-tail
    # padding): -inf-scored candidates carry real panel indices that the
    # tie-broken merge can rank above the -1 sentinels — scrub them so
    # excluded or padded item ids never surface in the result
    idx = jnp.where(jnp.isneginf(vals), -1, idx)
    return vals, idx


def recall_at_k(pred_idx, true_idx) -> float:
    """Mean recall@k between predicted and ground-truth index sets.

    pred_idx: (b, k) retrieved items; true_idx: (b, t) relevant items.
    """
    import numpy as np

    pred = np.asarray(pred_idx)
    true = np.asarray(true_idx)
    hits = 0.0
    evaluated = 0
    for p_row, t_row in zip(pred, true):
        t = set(int(i) for i in t_row if i >= 0)
        if not t:
            continue  # all-padding truth rows are excluded from the mean
        evaluated += 1
        hits += len(t.intersection(int(i) for i in p_row)) / len(t)
    return hits / evaluated if evaluated else 0.0
