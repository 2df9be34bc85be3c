"""Smoke run of tpunmf's main paths on a GPU, at full width.

    python chip_smoke.py              # one card: phases 1-6
    python chip_smoke.py --devices 4  # the sharded path on four cards

Every phase goes through the entry points a user calls (``NMF``, the
solver functions, ``serve``) and checks its answer against a plain
``jax.numpy`` reference run on the same card.  Any failed phase makes
the process exit non-zero.  The last line of standard output is one
JSON object naming the device; it is printed only when every phase
passed.  Without a GPU the script fails at phase 1: it never falls back
to the CPU.

Tolerances (with their reasons):
  * 1e-4 relative final objective, main path vs reference, both under
    ``jax.default_matmul_precision("highest")``: the parity budget of
    BASELINE.md; what remains is f32 summation order.
  * ``DEFAULT_PRECISION_BOUND`` for the same comparison at the default
    precision, where the X-sized products run in TF32 (10-bit mantissa):
    set from the measured deviation (PERF.md, "Precision").
  * serving: indices equal to a "highest"-precision scoring + lax.top_k;
    a differing index is accepted only where the reference values tie.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

EPS = 1e-9
PARITY = 1e-4
DEFAULT_PRECISION_BOUND = 1e-2
CONFIG1 = (20000, 11000, 50)          # BASELINE config[1] at full CPU-parity size
HEADLINE = (8192, 8192, 128)          # bench headline shape, bf16 X


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def report(phase, card, msg):
    print(f"[phase {phase} | {card}] {msg}", flush=True)


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


# ------------------------------------------------------------ references


@jax.jit
def _kl_obj_ref(x, w, h):
    wh = w @ h
    val = x * jnp.log(x / wh)
    val = jnp.where(jnp.isfinite(val), val, 0.0)
    return jnp.sum(val - x + wh)


def ref_mur(x, w, h, iters: int, distance: str):
    """Plain KL- or EU-MUR (reference nmf/mur.py:20-49, lambda = 0) for
    ``iters`` iterations; returns the final objective."""

    def kl(_, wh):
        w, h = wh
        w = w * ((x / (w @ h + EPS)) @ h.T) / jnp.sum(h, axis=1)[None, :]
        h = h * (w.T @ (x / (w @ h + EPS))) / jnp.sum(w, axis=0)[:, None]
        return w, h

    def eu(_, wh):
        w, h = wh
        w = w * (x @ h.T) / ((w @ h) @ h.T + EPS)
        h = h * (w.T @ x) / (w.T @ (w @ h) + EPS)
        return w, h

    w, h = jax.jit(lambda w, h: jax.lax.fori_loop(
        0, iters, kl if distance == "kl" else eu, (w, h)))(w, h)
    if distance == "kl":
        return _kl_obj_ref(x, w, h)
    return 0.5 * jnp.sum((x - w @ h) ** 2)


def timed_factorize(x, k, **kw):
    """(results, first-call seconds, steady seconds) of NMF.factorize;
    results hold host arrays, so each call ends on the device."""
    from tpunmf import NMF

    t0 = time.perf_counter()
    NMF(x, k).factorize(**kw)
    first = time.perf_counter() - t0
    model = NMF(x, k)
    t0 = time.perf_counter()
    res = model.factorize(**kw)
    return res, first, time.perf_counter() - t0


# ---------------------------------------------------------------- phases


def phase_device():
    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"no GPU: JAX found platform {dev.platform!r}")
    from tpunmf.utils import gpu_label

    card = gpu_label()
    report(1, card, f"jax {jax.__version__}: {len(jax.devices())} x "
           f"{dev.device_kind} ({dev.platform})")
    return card


def config1_data():
    from tpunmf.data.synthetic import tfidf_like
    from tpunmf.init import random_init

    m, n, k = CONFIG1
    x = jnp.asarray(tfidf_like(m, n, seed=0))
    w0, h0 = random_init(jax.random.PRNGKey(1), m, n, k)
    return x, w0, h0


def phase_main(card, iters=25):
    from tpunmf.core.backend import use_kernels

    x, w0, h0 = config1_data()
    m, n, k = CONFIG1
    path = "Pallas kernels" if use_kernels(x, k, None) else "XLA step"
    kw = dict(method="mur", distance_type="kl", min_iter=iters,
              max_iter=iters, tol1=0.0, tol2=0.0, w_init=w0, h_init=h0)
    res, first, steady = timed_factorize(x, k, **kw)
    obj = res.obj_history[-1]
    check(np.isfinite(obj) and res.w.shape == (m, k), "non-finite result")
    with jax.default_matmul_precision("highest"):
        ref = ref_mur(x, w0, h0, iters, "kl")
        hi, _, _ = timed_factorize(x, k, **kw)
    dev_hi = rel(hi.obj_history[-1], ref)
    dev_default = rel(obj, ref)
    report(2, card, f"config[1] KL-MUR {m}x{n} rank {k} f32 via NMF.factorize:"
           f" path {path}; compile {first - steady:.2f} s; steady "
           f"{iters / steady:.1f} it/s")
    report(2, card, f"final objective {obj:.9e}; reference {float(ref):.9e};"
           f" deviation under 'highest' {dev_hi:.3e} (bound {PARITY:g});"
           f" at default precision (TF32) {dev_default:.3e} "
           f"(bound {DEFAULT_PRECISION_BOUND:g})")
    check(dev_hi <= PARITY, f"parity {dev_hi:.3e} > {PARITY}")
    check(dev_default <= DEFAULT_PRECISION_BOUND,
          f"default-precision deviation {dev_default:.3e} too large")
    return x, w0, h0


def headline_data():
    from tpunmf.init import random_init

    m, n, k = HEADLINE
    kx, kw = jax.random.split(jax.random.PRNGKey(2))
    wt, ht = random_init(kx, m, n, 32, kind="uniform")
    x = (wt @ ht + 0.1 * jax.random.uniform(kx, (m, n))).astype(jnp.bfloat16)
    w0, h0 = random_init(kw, m, n, k)
    return x, w0, h0


def phase_eu(card, iters=25):
    from tpunmf.solvers import mur

    x, w0, h0 = headline_data()
    m, n, k = HEADLINE
    kw = dict(distance_type="eu", min_iter=iters, max_iter=iters, tol1=0.0,
              tol2=0.0, w_init=w0, h_init=h0, data_dtype=jnp.bfloat16)
    mur(x, k, **kw)
    t0 = time.perf_counter()
    res = mur(x, k, **kw)
    steady = time.perf_counter() - t0
    xf = x.astype(jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref = ref_mur(xf, w0, h0, iters, "eu")
        hi = mur(x, k, **kw)
    dev_hi = rel(hi.obj_history[-1], ref)
    dev_default = rel(res.obj_history[-1], ref)
    report(3, card, f"EU-MUR {m}x{n} rank {k} bf16 X, exact objective: "
           f"steady {iters / steady:.1f} it/s; deviation under 'highest' "
           f"{dev_hi:.3e} (bound {PARITY:g}); default precision "
           f"{dev_default:.3e} (bound {DEFAULT_PRECISION_BOUND:g})")
    check(dev_hi <= PARITY, f"EU parity {dev_hi:.3e} > {PARITY}")
    check(dev_default <= DEFAULT_PRECISION_BOUND, "EU default deviation")
    return x, w0, h0


def phase_solvers(card, iters=20):
    from tpunmf.data.synthetic import lowrank_dense

    x = lowrank_dense(2048, 1024, 64, seed=3)
    cases = [("hals", {}), ("anls", {}), ("admm", {}), ("ao_admm", {}),
             ("ao_admm", {"reg_w": (0.1, "l1inf")})]
    for method, extra in cases:
        res, first, steady = timed_factorize(
            x, 64, method=method, min_iter=iters, max_iter=iters, tol1=0.0,
            tol2=0.0, **extra)
        hist = np.asarray(res.obj_history, dtype=np.float64)
        name = method + (" l1inf" if extra else "")
        report(4, card, f"{name} 2048x1024 rank 64: compile "
               f"{first - steady:.2f} s, {iters / steady:.1f} it/s; objective"
               f" {hist[0]:.6e} -> {hist[-1]:.6e}")
        check(np.all(np.isfinite(hist)), f"{name}: non-finite objective")
        check(hist[-1] < hist[0], f"{name}: objective did not decrease")


def phase_serving(card, b=64, n=1 << 20, r=128, k=100):
    from tpunmf.serve import topk_retrieval, topk_scores_dense

    kw, kh = jax.random.split(jax.random.PRNGKey(4))
    w = jax.random.uniform(kw, (b, r))
    h = jax.random.uniform(kh, (r, n))
    with jax.default_matmul_precision("highest"):
        scores = w @ h
        ref_v, ref_i = jax.lax.top_k(scores, k)
        got_v, got_i = topk_scores_dense(w, h, k)
    ref_i, got_i = np.asarray(ref_i), np.asarray(got_i)
    diff = ref_i != got_i
    tied = np.asarray(scores)[np.arange(b)[:, None], got_i] == np.asarray(ref_v)
    check(np.all(tied[diff]), "top-k indices differ where values do not tie")
    topk_scores_dense(w, h, k)[1].block_until_ready()
    t0 = time.perf_counter()
    for _ in range(10):
        out = topk_scores_dense(w, h, k)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / 10
    hq = h.astype(jnp.bfloat16)
    _, qi = topk_retrieval(None, w, h, k, first_stage_dtype="bf16",
                           h_quantized=hq)
    qi = np.asarray(qi)
    recall = np.mean([len(set(qi[i]) & set(ref_i[i])) / k for i in range(b)])
    report(5, card, f"topk_scores_dense ({b}, {n}) rank {r} k={k}: indices "
           f"equal the 'highest' scoring + lax.top_k ({int(diff.sum())} "
           f"positions differ, all value ties); {dt * 1e3:.3f} ms/batch at "
           f"default precision; quantized bf16 recall@{k} {recall:.4f}")
    check(recall >= 0.95, f"quantized recall {recall:.4f} < 0.95")


def phase_kernels(card, x1, w1, h1, xh, wh, hh):
    """The same mur() call in three modes, in turns: the default dispatch
    (kernels within their rank gate, ops/fused.MAX_RANK), the XLA step
    forced, and the kernels forced (past the gate where it applies)."""
    from tpunmf.ops import fused
    from tpunmf.solvers import mur

    cases = [("config[1] KL f32", x1, w1, h1, "kl", 25),
             ("config[1] EU f32", x1, w1, h1, "eu", 25),
             ("8192^2 KL bf16", xh, wh, hh, "kl", 50),
             ("8192^2 EU bf16", xh, wh, hh, "eu", 50)]
    gate = fused.MAX_RANK
    for name, x, w, h, dist, iters in cases:
        rates = {"default": [], "XLA": [], "kernels": []}
        for mode in ("default", "XLA", "kernels", "kernels", "XLA",
                     "default"):
            use = {"default": None, "XLA": False, "kernels": True}[mode]
            fused.MAX_RANK = max(gate, w.shape[1]) if use else gate
            kw = dict(distance_type=dist, min_iter=iters, max_iter=iters,
                      tol1=0.0, tol2=0.0, w_init=w, h_init=h, use_pallas=use)
            try:
                mur(x, w.shape[1], **kw)
                t0 = time.perf_counter()
                mur(x, w.shape[1], **kw)
            finally:
                fused.MAX_RANK = gate
            rates[mode].append(iters / (time.perf_counter() - t0))
        report(6, card, f"{name}: " + "; ".join(
            f"{mode} {a:.1f}/{b:.1f} it/s" for mode, (a, b) in rates.items()))


def run_one_card():
    card = phase_device()
    x1, w1, h1 = phase_main(card)
    xh, wh, hh = phase_eu(card)
    phase_solvers(card)
    phase_serving(card)
    phase_kernels(card, x1, w1, h1, xh, wh, hh)
    return card


def run_four_cards(n_dev=4, iters=25):
    """config[1] KL-MUR on a 1-D ('cols',) mesh of 4 cards against card 0
    alone, sharded top-k against one card, and no all-gather of X."""
    from jax.sharding import Mesh

    from tpunmf import NMF
    from tpunmf.parallel import shard_problem
    from tpunmf.serve import topk_retrieval, topk_scores_dense

    card = phase_device()
    check(len(jax.devices()) >= n_dev, f"need {n_dev} GPUs")
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("cols",))
    x, w0, h0 = config1_data()
    m, n, k = CONFIG1
    kw = dict(method="mur", distance_type="kl", min_iter=iters,
              max_iter=iters, tol1=0.0, tol2=0.0, w_init=w0, h_init=h0)
    with jax.default_matmul_precision("highest"):
        xs = shard_problem(mesh, x)
        t0 = time.perf_counter()
        sharded = NMF(xs, k).factorize(**kw)
        t_sh = time.perf_counter() - t0
        one = NMF(jax.device_put(x, jax.devices()[0]), k).factorize(**kw)
    hs, ho = (np.asarray(r.obj_history, np.float64) for r in (sharded, one))
    worst = float(np.max(np.abs(hs - ho) / np.abs(ho)))
    hlo = sharded_step_hlo(xs, w0, h0)
    # instruction names: "all-gather(" on the CPU, "all-gather-start(" for
    # the GPU's asynchronous collectives
    gathers = [ln for ln in hlo.splitlines()
               if re.search(r"all-gather[-a-z]*\(", ln) and f"[{m},{n}]" in ln]
    reduces = len(re.findall(r"all-reduce[-a-z]*\(", hlo))
    report("4x", card, f"config[1] KL-MUR on ('cols',) mesh of {n_dev}: "
           f"{t_sh:.2f} s for {iters} it incl. compile; objective trace vs "
           f"card 0 alone: worst relative deviation {worst:.3e} (bound "
           f"{PARITY:g}); all-gathers of X in the step HLO: {len(gathers)}"
           f" (all-reduces: {reduces})")
    check(worst <= PARITY, f"sharded trace deviates {worst:.3e}")
    check(not gathers, "the sharded step all-gathers X")

    hcols = jax.random.uniform(jax.random.PRNGKey(5), (128, 1 << 20))
    wb = jax.random.uniform(jax.random.PRNGKey(6), (64, 128))
    with jax.default_matmul_precision("highest"):
        _, i_sh = topk_retrieval(mesh, wb, shard_problem(mesh, hcols), 100)
        _, i_one = topk_scores_dense(wb, hcols, 100)
    same = bool(np.array_equal(np.asarray(i_sh), np.asarray(i_one)))
    report("4x", card, f"sharded topk_retrieval (64, {1 << 20}) rank 128 "
           f"k=100 vs one card: indices equal {same}")
    check(same, "sharded top-k indices differ from one card")
    return card


def sharded_step_hlo(xs, w0, h0) -> str:
    """Compiled HLO of the KL solver block for a sharded X."""
    from tpunmf.ops.fused import kl_ratio_and_obj
    from tpunmf.solvers.common import init_carry
    from tpunmf.solvers.mur import _mur_block

    r0, obj0 = kl_ratio_and_obj(xs, w0, h0)
    carry = init_carry(obj0, 4, (w0, h0, r0))
    z = jnp.zeros((), jnp.float32)
    return _mur_block.lower(
        xs, z, carry, 4, 0.0, 0.0, 0.0, 0.0, distance_type="kl", min_iter=4,
        max_iter=4, objective="exact", use_pallas=False,
        verbose=False).compile().as_text()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    from tpunmf.utils import enable_compilation_cache

    enable_compilation_cache()
    try:
        card = run_four_cards() if args.devices == 4 else run_one_card()
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    dev = jax.devices()[0]
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
