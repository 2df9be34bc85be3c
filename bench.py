"""Benchmark: NMF iterations/sec and GFLOPS per device at rank 128.

Headline: Euclidean MUR at 8192 x 8192 rank 128 with bfloat16 X (X is
the dominant device-memory term at rank ~128 and bf16 halves its bytes;
factors stay f32), driven through the production solver loop
(_mur_block, gram objective).  The f32-X run is reported alongside in
``extra``.

Accounting.  ``vs_baseline`` is the fraction of the ROOFLINE iteration
time achieved, divided by the BASELINE.json 0.70 target:

    t_roofline = max(bytes_iter / BW, flops_iter / peak)

Peaks come from NVIDIA's published data sheets, keyed by the device's
``device_kind`` (``_PEAKS``); a device not in the table is an error.
The bench also measures deliverable bandwidth with neutral XLA probes (a
pure-read reduction, a streaming read+write pass and a read-dominated
GEMM) interleaved across the bench window, and reports the fraction
against the best probe beside the fraction against the data sheet.
bytes_iter counts only the algorithmically required traffic; temporaries
are excluded (conservative).

``extra.solver_rates`` records warm iterations/sec for MUR-KL, HALS,
ANLS, ADMM and AO-ADMM on a 2048x1024 rank-64 problem.

Timing: results are fetched to the host inside the timed region, and
rates use two-point delta timing (iters vs 5*iters of the SAME compiled
call) so the fixed per-call cost cancels.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "extra"}.  Any failed phase
fails the run.
"""
from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

# published dense peaks per device_kind: (bf16 FLOP/s, TF32 FLOP/s,
# device-memory bytes/s).  Source: NVIDIA H100 Tensor Core GPU data sheet
# (SXM5: 989 / 495 TF, 3.35 TB/s; PCIe: 756 / 378 TF, 2.0 TB/s; NVL:
# 835 / 418 TF, 3.9 TB/s; the sheet's "with sparsity" figures halved).
# The rates assume the card's full power limit.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 495e12, 3.35e12),
    "NVIDIA H100 PCIe": (756e12, 378e12, 2.0e12),
    "NVIDIA H100 NVL": (835e12, 418e12, 3.9e12),
}


def _chip_limits(kind: str | None = None) -> tuple[float, float, float]:
    """(bf16 FLOP/s, TF32 FLOP/s, memory bytes/s) of ``kind`` (default:
    the first device).  A device without a row is an error, never a
    default."""
    kind = kind or jax.devices()[0].device_kind
    if kind not in _PEAKS:
        raise ValueError(f"no published peaks for device {kind!r}; "
                         f"known: {sorted(_PEAKS)}")
    return _PEAKS[kind]


def _roofline(r, bw, flops_peak):
    """Roofline fields of a solver cell for memory bandwidth ``bw`` and
    compute peak ``flops_peak``: the least time the device could take is
    the larger of bytes / bw and flops / peak."""
    t_roof = max(r["bytes_per_iter"] / bw, r["flops_per_iter"] / flops_peak)
    return {
        "roofline_fraction": t_roof * r["iters_per_sec"],
        "t_roofline_ms": t_roof * 1e3,
        "bound": ("memory" if r["bytes_per_iter"] / bw
                  >= r["flops_per_iter"] / flops_peak else "compute"),
    }


class BandwidthTracker:
    """Interleaved deliverable-bandwidth and GEMM-rate probing.

    ``sample()`` runs three neutral XLA probes (pure-read reduction,
    streaming read+write, read-dominated GEMM) and a chained bf16 GEMM,
    and records each.  The pure-read probe is the binding one for the
    roofline: the solver's required traffic is dominated by reads of X.
    The bench calls it several times across its window; the ceiling is
    the best probe of this run, never the solver itself.
    """

    def __init__(self, mb: int = 128, gemm_shape=(8192, 8192, 128)):
        self.samples_stream: list[float] = []
        self.samples_gemm: list[float] = []
        self.samples_read: list[float] = []
        self.samples_bf16_gemm: list[float] = []
        self._build(mb, gemm_shape)

    def _build(self, mb, gemm_shape):
        self._mb = mb
        nelem = mb * 1024 * 1024 // 4
        self._buf = jnp.ones((nelem,), jnp.float32)

        @jax.jit
        def stream(x, it):
            def body(t, c):
                return c * 1.0000001
            return jax.lax.fori_loop(0, it, body, x)[0]

        self._stream = stream
        m, n, k = gemm_shape
        self._gemm_shape = (m, n, k)
        self._x = jnp.ones((m, n), jnp.float32)
        self._h = jnp.ones((k, n), jnp.float32)

        @jax.jit
        def gemm_read(x, h, it):
            def body(t, c):
                return 0.5 * c + 0.5 * (x @ (h + t).T)
            return jax.lax.fori_loop(0, it, body, jnp.zeros((m, k)))[0, 0]

        self._gemm = gemm_read

        @jax.jit
        def read_sum(x, it):
            def body(t, c):
                # maximum(x, t) defeats hoisting and algebraic rewrite:
                # the comparand changes every trip, so the full array is
                # genuinely re-read each iteration
                return c + jnp.sum(jnp.maximum(x, t.astype(jnp.float32)))

            return jax.lax.fori_loop(0, it, body, jnp.float32(0.0))

        self._read = read_sum

        @jax.jit
        def bf16_chain(a, it):
            # chained bf16 GEMM: each trip consumes the last trip's
            # output so nothing is hoisted; *1e-3 keeps values finite
            def body(t, c):
                return jnp.dot(c, self._gemm_b,
                               preferred_element_type=jnp.float32
                               ).astype(jnp.bfloat16) * 1e-3

            return jax.lax.fori_loop(0, it, body, a)[0, 0]

        self._gemm_dim = 4096
        self._gemm_a = jnp.ones((self._gemm_dim, self._gemm_dim), jnp.bfloat16)
        self._gemm_b = jnp.ones((self._gemm_dim, self._gemm_dim), jnp.bfloat16)
        self._bf16_gemm = bf16_chain

    def _delta_time(self, fn, i1, i2):
        """Seconds per pass from the (i1 vs i2)-pass wall-time delta,
        which cancels the fixed per-call cost."""
        float(fn(i1))
        float(fn(i2))  # same executable (dynamic trip count); warm both

        def wall(it):
            t0 = time.perf_counter()
            float(fn(it))
            return time.perf_counter() - t0

        t1 = min(wall(i1), wall(i1))
        t2 = min(wall(i2), wall(i2))
        return max(t2 - t1, 1e-4) / (i2 - i1)

    def sample(self, iters=30):
        m, n, _ = self._gemm_shape
        t = self._delta_time(lambda it: self._read(self._x, it), 5, 30)
        self.samples_read.append(m * n * 4 / t)
        t = self._delta_time(lambda it: self._stream(self._buf, it),
                             iters, 4 * iters)
        self.samples_stream.append(2 * self._mb * 1024 * 1024 / t)
        t = self._delta_time(lambda it: self._gemm(self._x, self._h, it),
                             5, 30)
        self.samples_gemm.append(m * n * 4 / t)
        t = self._delta_time(lambda it: self._bf16_gemm(self._gemm_a, it),
                             5, 30)
        self.samples_bf16_gemm.append(2 * self._gemm_dim ** 3 / t)

    @property
    def bw_ceiling(self) -> float:
        """Best bandwidth probe of this run."""
        return max(self.samples_read + self.samples_stream
                   + self.samples_gemm, default=0.0)

    def summary(self) -> dict:
        return {
            "bf16_gemm_samples_tflops": [round(s / 1e12, 1)
                                   for s in self.samples_bf16_gemm],
            "read_samples": [round(s / 1e9, 1) for s in self.samples_read],
            "stream_rw_samples": [round(s / 1e9, 1)
                                  for s in self.samples_stream],
            "gemm_read_samples": [round(s / 1e9, 1)
                                  for s in self.samples_gemm],
            "used": round(self.bw_ceiling / 1e9, 1),
        }


def bench_mur_eu(m=8192, n=8192, k=128, iters=50, data_dtype=jnp.float32):
    from tpunmf.core.backend import use_kernels
    from tpunmf.solvers.common import init_carry
    from tpunmf.solvers.mur import _mur_block

    key = jax.random.PRNGKey(0)
    kx, kw, kh = jax.random.split(key, 3)
    w0 = jax.random.uniform(kw, (m, k), dtype=jnp.float32)
    h0 = jax.random.uniform(kh, (k, n), dtype=jnp.float32)
    x = w0 @ h0 + 0.01 * jax.random.uniform(kx, (m, n), dtype=jnp.float32)
    x = x.astype(data_dtype)
    xsq = jnp.sum(x.astype(jnp.float32) ** 2)
    float(xsq)  # materialize inputs before timing
    use_pallas = use_kernels(x, k, None)

    long_iters = 5 * iters

    def run(carry, stop_i):
        return _mur_block(
            x, xsq, carry, stop_i, 0.0, 0.0, 0.0, 0.0,
            distance_type="eu", min_iter=long_iters + 1,
            max_iter=long_iters + 1,
            objective="gram", use_pallas=use_pallas, verbose=False,
        )

    obj0 = jnp.asarray(0.0, dtype=jnp.float32)

    def timed(stop_i):
        carry = init_carry(obj0, long_iters + 1, (w0, h0))
        float(carry.obj)
        t0 = time.perf_counter()
        out = run(carry, stop_i)
        obj = float(out.obj)  # host fetch = true completion
        return time.perf_counter() - t0, out, obj

    float(run(init_carry(obj0, long_iters + 1, (w0, h0)), 2).obj)  # warm-up

    # two-point delta timing: the rate is taken from the (iters vs
    # 5*iters) wall-time DELTA of the same compiled function (only the
    # dynamic stop index differs), so the fixed per-call cost cancels
    t1 = min(timed(iters)[0], timed(iters)[0])
    t2a, out, final_obj = timed(long_iters)
    t2b, _, _ = timed(long_iters)
    t2 = min(t2a, t2b)

    assert int(out.i) == long_iters
    iters_per_sec = (long_iters - iters) / max(t2 - t1, 1e-3)
    # GEMM inventory of the gram-objective iteration:
    #   X@H^T (2mnk) + W@Gh (2mk^2) + W^T X (2mnk) + GramW (2mk^2)
    #   + Gh=H@H^T (2nk^2) + H update GramW@H (2nk^2)
    #   + gram objective (2nk^2)
    flops_per_iter = 4 * m * n * k + 4 * m * k * k + 6 * n * k * k
    # required traffic: X read by each of the two GEMM passes, W r+w,
    # H^T read, WtX written+read, H written (all f32) — temporaries
    # excluded (conservative: fewer bytes => lower roofline fraction)
    xb = jnp.dtype(data_dtype).itemsize
    bytes_per_iter = 2 * m * n * xb + (2 * m * k + 4 * k * n) * 4
    return {
        "bytes_per_iter": bytes_per_iter,
        "flops_per_iter": flops_per_iter,
        "achieved_bw": bytes_per_iter * iters_per_sec,
        "iters_per_sec": iters_per_sec,
        "gflops_per_chip": flops_per_iter * iters_per_sec / 1e9,
        "t_iter_ms": 1e3 / iters_per_sec,
        "final_obj": final_obj,
        "fused_objective": use_pallas,
        "m": m, "n": n, "k": k, "iters": iters,
        "device": jax.devices()[0].device_kind,
    }


def bench_mur_kl(m=8192, n=8192, k=128, iters=30, data_dtype=jnp.bfloat16,
                 objective_every=1):
    """KL-MUR at headline scale with the same roofline accounting as EU.
    Where the fused KL passes run (ops/fused.py), the lagged objective
    leaves two passes over X per iteration (W pass, H pass); bytes_iter
    counts exactly that required traffic.
    """
    from tpunmf.core.backend import use_kernels
    from tpunmf.solvers.common import init_carry
    from tpunmf.solvers.mur import _mur_block

    key = jax.random.PRNGKey(0)
    kx, kw, kh = jax.random.split(key, 3)
    w0 = jax.random.uniform(kw, (m, k), dtype=jnp.float32) + 0.1
    h0 = jax.random.uniform(kh, (k, n), dtype=jnp.float32) + 0.1
    x = w0 @ h0 + 0.01 * jax.random.uniform(kx, (m, n), dtype=jnp.float32)
    x = x.astype(data_dtype)
    xsq = jnp.sum(x.astype(jnp.float32) ** 2)
    float(xsq)
    use_pallas = use_kernels(x, k, None)
    long_iters = 5 * iters

    def run(carry, stop_i):
        return _mur_block(
            x, xsq, carry, stop_i, 0.0, 0.0, 0.0, 0.0,
            distance_type="kl", min_iter=long_iters + 1,
            max_iter=long_iters + 1, objective="lagged",
            use_pallas=use_pallas,
            objective_every=objective_every, verbose=False,
        )

    obj0 = jnp.asarray(0.0, dtype=jnp.float32)
    if use_pallas:
        inner0 = (w0, h0)
    else:
        # the XLA step carries the trailing ratio
        from tpunmf.ops.fused import kl_ratio

        inner0 = (w0, h0, kl_ratio(x, w0, h0, eps=1e-9))

    def timed(stop_i):
        carry = init_carry(obj0, long_iters + 1, inner0)
        float(carry.obj)
        t0 = time.perf_counter()
        out = run(carry, stop_i)
        float(out.obj)
        return time.perf_counter() - t0, out

    float(run(init_carry(obj0, long_iters + 1, inner0), 2).obj)
    t1 = min(timed(iters)[0], timed(iters)[0])
    t2a, out = timed(long_iters)
    t2b, _ = timed(long_iters)
    t2 = min(t2a, t2b)
    assert int(out.i) == long_iters
    iters_per_sec = (long_iters - iters) / max(t2 - t1, 1e-3)

    xb = jnp.dtype(data_dtype).itemsize
    passes = 2  # W-pass + H-pass (lagged objective: no third pass)
    # X twice, W r+w, H r+w (f32 factors); ratio tiles never materialized
    bytes_per_iter = passes * m * n * xb + (2 * m * k + 2 * k * n) * 4
    # each pass forms WH tiles (2mnk) and a numerator GEMM (2mnk)
    flops_per_iter = 8 * m * n * k
    return {
        "bytes_per_iter": bytes_per_iter,
        "flops_per_iter": flops_per_iter,
        "achieved_bw": bytes_per_iter * iters_per_sec,
        "iters_per_sec": iters_per_sec,
        "gflops_per_chip": flops_per_iter * iters_per_sec / 1e9,
        "fused_kl_passes": use_pallas,
        "m": m, "n": n, "k": k,
    }


def bench_serving(b=64, r=128, n=1 << 20, topk=100, iters=20) -> dict:
    """Serving-path throughput: QPS for a 64-user batch retrieving
    top-100 of ~1M rank-128 item columns, f32 exact vs bf16
    retrieve-then-rerank (pre-stored bf16 H), plus the measured recall
    of the quantized stage vs exact.  Delta-timed like every other rate;
    the per-trip w_batch perturbation defeats CSE across loop trips.
    """
    from tpunmf.serve.topk import recall_at_k, topk_scores_dense
    from tpunmf.serve.topk import _quantized_rerank

    key = jax.random.PRNGKey(7)
    kw, kh = jax.random.split(key)
    w = jax.random.uniform(kw, (b, r), dtype=jnp.float32)
    h = jax.random.uniform(kh, (r, n), dtype=jnp.float32)
    hq = h.astype(jnp.bfloat16)

    # h/hq are jit ARGUMENTS, not closure captures: a captured array is
    # embedded in the program as a 537 MB literal
    @jax.jit
    def run_exact(w, hh, it):
        def body(t, c):
            wb = w * (1.0 + t.astype(jnp.float32) * 1e-6)
            v, _ = topk_scores_dense(wb, hh, topk)
            return c + v[0, 0]

        return jax.lax.fori_loop(0, it, body, jnp.float32(0.0))

    @jax.jit
    def run_quant(w, hh, hhq, it):
        def body(t, c):
            wb = w * (1.0 + t.astype(jnp.float32) * 1e-6)
            v, _ = _quantized_rerank(wb, hh, topk, "bf16", 2, 1.0, hq=hhq)
            return c + v[0, 0]

        return jax.lax.fori_loop(0, it, body, jnp.float32(0.0))

    def delta(fn, *hs):
        float(fn(w, *hs, 2))
        float(fn(w, *hs, iters))
        float(fn(w, *hs, 5 * iters))

        def wall(it):
            t0 = time.perf_counter()
            float(fn(w, *hs, it))
            return time.perf_counter() - t0

        t1 = min(wall(iters), wall(iters))
        t2 = min(wall(5 * iters), wall(5 * iters))
        return max(t2 - t1, 1e-4) / (4 * iters)

    t_exact = delta(run_exact, h)
    t_quant = delta(run_quant, h, hq)
    v_e, i_e = topk_scores_dense(w, h, topk)
    v_q, i_q = _quantized_rerank(w, h, topk, "bf16", 2, 1.0, hq=hq)
    rec = float(recall_at_k(i_q, i_e))
    h_bytes = r * n * 4
    return {
        "items": n, "rank": r, "batch": b, "topk": topk,
        "qps_exact_f32": round(b / t_exact, 1),
        "qps_quantized_bf16": round(b / t_quant, 1),
        "batch_latency_ms_exact": round(t_exact * 1e3, 3),
        "batch_latency_ms_quantized": round(t_quant * 1e3, 3),
        "recall_at_100_quantized_vs_exact": rec,
        "scoring_bw_gbps_exact": round(h_bytes / t_exact / 1e9, 1),
        "scoring_bw_gbps_quantized": round(h_bytes / 2 / t_quant / 1e9, 1),
    }


def bench_solver_rates(m=2048, n=1024, k=64, iters=8) -> dict:
    """Warm iterations/sec for the other solver families (machine record
    for BASELINE's 'NMF iterations/sec': not just MUR).

    Two-point measurement: run the same solver at iters and iters+delta
    and rate the DELTA, cancelling per-call fixed costs (host-side setup
    and eager dispatches) that would otherwise dominate at small
    iteration counts.
    """
    from tpunmf.solvers import admm, anls, ao_admm, hals, mur

    key = jax.random.PRNGKey(1)
    kx, kw, kh = jax.random.split(key, 3)
    w0 = jax.random.uniform(kw, (m, k), dtype=jnp.float32)
    h0 = jax.random.uniform(kh, (k, n), dtype=jnp.float32)
    x = w0 @ h0 + 0.05
    import numpy as np

    w0n, h0n = np.asarray(w0), np.asarray(h0)

    def run_timed(fn, n_it, **kw):
        common = dict(w_init=w0n, h_init=h0n, min_iter=n_it, max_iter=n_it,
                      tol1=0.0, tol2=0.0)
        t0 = time.perf_counter()
        res = fn(x, k, **common, **kw)
        dt = time.perf_counter() - t0
        assert len(res.obj_history) >= n_it
        return dt

    def rate(fn, delta, **kw):
        # delta chosen per family so the extra iterations dominate timing
        # noise
        run_timed(fn, iters, **kw)              # compile short count
        run_timed(fn, iters + delta, **kw)      # compile long count

        def one_rate():
            # min over TWO runs at each point: one slow window
            # otherwise poisons the delta
            t1 = min(run_timed(fn, iters, **kw), run_timed(fn, iters, **kw))
            t2 = min(run_timed(fn, iters + delta, **kw),
                     run_timed(fn, iters + delta, **kw))
            return delta / max(t2 - t1, 0.05)  # 50 ms measurement floor

        # median of three delta pairs: min-of-two per point bounds the
        # slow-window direction but a too-small delta can still INFLATE a
        # single pair; the median discards one outlier either way
        rates = sorted(one_rate() for _ in range(3))
        return round(rates[1], 2)

    from tpunmf.solvers import mur_masked

    mask = (jax.random.uniform(jax.random.PRNGKey(2), (m, n)) < 0.25
            ).astype(jnp.float32)

    def masked_eu(data, kk, **kw2):
        return mur_masked(data, mask, kk, **kw2)

    out = {}
    # a rate equal to delta / 0.05 s is the measurement floor, not a
    # measurement: deltas are sized to stay well above it
    out["mur_kl"] = rate(mur, 4000, distance_type="kl")
    out["mur_eu"] = rate(mur, 8000, distance_type="eu")
    out["mur_masked_eu"] = rate(masked_eu, 6000, distance_type="eu")
    out["hals"] = rate(hals, 8000)
    out["anls"] = rate(anls, 500)
    out["admm"] = rate(admm, 3000)
    out["ao_admm"] = rate(ao_admm, 2000)
    out["ao_admm_local_l1inf"] = rate(
        ao_admm, 1000, rho_mode="adaptive", reg_w=(0.1, "l1inf"))
    return out


def main():
    from tpunmf.utils import enable_compilation_cache, gpu_label

    enable_compilation_cache()
    card = gpu_label()
    bf16_peak, tf32_peak, hbm_peak = _chip_limits()
    print(f"card: {card}", flush=True)
    # interleave the bandwidth probes across the bench window
    tracker = BandwidthTracker()
    tracker.sample()
    r16 = bench_mur_eu(data_dtype=jnp.bfloat16)         # headline mode
    tracker.sample()
    r = bench_mur_eu()                                  # f32 reference mode
    # compute-bound mode: rank 512 is past the memory/compute crossover;
    # best-of-3 at 50-iteration windows
    r512 = max((bench_mur_eu(m=8192, n=2048, k=512, iters=50,
                             data_dtype=jnp.bfloat16) for _ in range(3)),
               key=lambda c: c["iters_per_sec"])
    tracker.sample()
    rkl = bench_mur_kl(data_dtype=jnp.bfloat16)
    # opt-in objective cadence: the objective (and its log) every 8th
    # iteration only
    rkl8 = bench_mur_kl(data_dtype=jnp.bfloat16, objective_every=8)
    serving = bench_serving()
    # high-rank point: scoring bytes scale with r while the top-k
    # machinery doesn't
    serving_r512 = bench_serving(b=64, r=512, n=1 << 19, topk=100, iters=10)
    tracker.sample()
    rates = bench_solver_rates()
    tracker.sample()

    # the solver GEMMs run on f32 factors, so TF32 is their compute peak
    bw_ceiling = tracker.bw_ceiling
    fields = {}
    for name, c in (("bf16", r16), ("f32", r), ("kl", rkl)):
        fields[name] = {
            "measured_bw": _roofline(c, bw_ceiling, tf32_peak),
            "data_sheet": _roofline(c, hbm_peak, tf32_peak),
        }
    mfu = r512["flops_per_iter"] * r512["iters_per_sec"] / tf32_peak
    print(json.dumps({
        "metric": "mur_eu_rank128_bf16x_gflops_per_chip",
        "value": round(r16["gflops_per_chip"], 1),
        "unit": "GFLOP/s",
        "vs_baseline": round(
            fields["bf16"]["data_sheet"]["roofline_fraction"] / 0.70, 3),
        "extra": {
            "card": card,
            "peaks_data_sheet": {"bf16_tflops": bf16_peak / 1e12,
                                 "tf32_tflops": tf32_peak / 1e12,
                                 "hbm_gbps": hbm_peak / 1e9},
            "iters_per_sec": round(r16["iters_per_sec"], 2),
            "t_iter_ms": round(r16["t_iter_ms"], 4),
            "roofline": fields["bf16"],
            "bw_probe_gbps": tracker.summary(),
            "shape": [r16["m"], r16["n"], r16["k"]],
            "fused_objective": r16["fused_objective"],
            "rank512_compute_bound": {
                "iters_per_sec": round(r512["iters_per_sec"], 2),
                "tflops_per_chip": round(r512["gflops_per_chip"] / 1e3, 1),
                "fraction_of_tf32_data_sheet": round(mfu, 3),
                "shape": [r512["m"], r512["n"], r512["k"]],
            },
            "kl_headline": {
                "iters_per_sec": round(rkl["iters_per_sec"], 2),
                "iters_per_sec_objective_every8": round(
                    rkl8["iters_per_sec"], 2),
                "gflops_per_chip": round(rkl["gflops_per_chip"], 1),
                "roofline": fields["kl"],
                "fused_kl_passes": rkl["fused_kl_passes"],
                "shape": [rkl["m"], rkl["n"], rkl["k"]],
            },
            "serving_topk": serving,
            "serving_topk_r512": serving_r512,
            "f32_data_mode": {
                "iters_per_sec": round(r["iters_per_sec"], 2),
                "gflops_per_chip": round(r["gflops_per_chip"], 1),
                "roofline": fields["f32"],
            },
            "solver_rates_it_per_s": rates,
            "device": r16["device"],
        },
    }))


if __name__ == "__main__":
    main()
