"""BASELINE.json config harness: golden parity + convergence quality.

Runs the five BASELINE.json benchmark config families (scaled by --scale
so the reference's numpy solvers stay tractable on CPU), comparing the
rebuild against the reference wherever the reference can run, and records
a JSON report.

  config0  MUR Euclidean, dense synthetic, NNDSVD init       (parity)
  config1  MUR KL, tf-idf-like term-doc matrix               (parity)
  config2  ANLS + FCNNLS, recommender matrix + recall@10     (parity + recall)
  config3  ADMM rho-damped, L1 on H, sparse matrix           (parity fixed-rho;
           adaptive-rho convergence quality)
  config4  AO-ADMM KL, mixed W/H regularizers, sharded mesh  (convergence +
           sharded == single-device)

Usage:  python benchmarks/run_configs.py [--scale 0.1] [--out report.json]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Parity comparisons are f64-vs-the-f64-numpy-reference: force the CPU
# backend (with 8 virtual devices for config4's sharded check) BEFORE the
# first jax op — an accelerator's f64 is slow or emulated, which would
# both fail the parity budget and crawl.
if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

REFERENCE = "/root/reference"
HAS_REF = os.path.isdir(os.path.join(REFERENCE, "nmf"))
if HAS_REF:
    sys.path.insert(0, REFERENCE)


# --max-iter-cap: full-scale runs (scale=1.0) are CPU-bound on the
# reference's numpy side; capping the iteration budget keeps parity
# meaningful (iterate-for-iterate at a FIXED budget) while tractable.
MAX_ITER_CAP = None


def capped(kw):
    if MAX_ITER_CAP is not None:
        kw = dict(kw, max_iter=min(kw["max_iter"], MAX_ITER_CAP),
                  min_iter=min(kw["min_iter"], MAX_ITER_CAP))
    return kw


def rel_err(x, w, h) -> float:
    return float(np.linalg.norm(x - w @ h) / np.linalg.norm(x))


def run_ref(solver_fn, x, k, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return solver_fn(np.array(x, dtype=np.float64), k, **kw)


def config0_mur_eu(scale):
    from tpunmf.data import lowrank_dense
    from tpunmf.solvers import mur

    m, n, k = max(64, int(2000 * scale)), max(48, int(1000 * scale)), 20
    x = lowrank_dense(m, n, k, seed=0, dtype=np.float64)
    kw = capped(dict(distance_type="eu", min_iter=20, max_iter=500, tol1=1e-6,
                     tol2=1e-6, nndsvd_init=(True, "zero")))
    t0 = time.perf_counter()
    ours = mur(x, k, **kw)
    t_ours = time.perf_counter() - t0
    out = {"config": "MUR-EU dense", "shape": [m, n, k], "i": ours.i,
           "rel_err": rel_err(x, ours.w, ours.h), "wall_s": round(t_ours, 2)}
    if HAS_REF:
        from nmf import mur as ref_mur

        t0 = time.perf_counter()
        ref = run_ref(ref_mur.mur, x, k, **kw)
        out["ref_wall_s"] = round(time.perf_counter() - t0, 2)
        out["ref_rel_err"] = rel_err(x, ref.w, ref.h)
        out["final_err_deviation"] = abs(out["rel_err"] - out["ref_rel_err"]) / max(
            out["ref_rel_err"], 1e-12)
        out["iters_match"] = ours.i == ref.i
    return out


def config1_mur_kl(scale, newsgroups_root=None):
    from tpunmf.data import tfidf_like
    from tpunmf.solvers import mur

    if newsgroups_root:
        # the REAL archive (BASELINE config[1]): a 20news-bydate-style
        # directory tree; drops in with zero code the moment the data
        # exists in the environment
        from tpunmf.data.loaders import load_newsgroups_tfidf

        csr, _, _ = load_newsgroups_tfidf(newsgroups_root,
                                          max_features=20000)
        x = np.asarray(csr.todense(), dtype=np.float64)
        m, n = x.shape
        k = 50
    else:
        m, n, k = (max(200, int(20000 * scale)),
                   max(100, int(11000 * scale)), 50)
        k = min(k, min(m, n) // 2)
        x = np.asarray(tfidf_like(m, n, n_topics=k, seed=1),
                       dtype=np.float64)
    kw = capped(dict(distance_type="kl", min_iter=20, max_iter=300, tol1=1e-6,
                     tol2=1e-6, nndsvd_init=(True, "zero")))
    ours = mur(x, k, **kw)
    out = {"config": "MUR-KL tfidf", "shape": [m, n, k], "i": ours.i,
           "final_kl": float(ours.obj_history[-1])}
    if HAS_REF:
        from nmf import mur as ref_mur

        with np.errstate(all="ignore"):
            ref = run_ref(ref_mur.mur, x, k, **kw)
        out["ref_final_kl"] = float(ref.obj_history[-1])
        out["final_err_deviation"] = abs(
            out["final_kl"] - out["ref_final_kl"]) / max(abs(out["ref_final_kl"]), 1e-12)
        out["iters_match"] = ours.i == ref.i
    return out


def config2_anls_recall(scale, movielens_path=None):
    from tpunmf.data import movielens_like
    from tpunmf.serve import recall_at_k, topk_scores_dense
    from tpunmf.solvers import anls

    if movielens_path:
        # the REAL archive (BASELINE config[2]): ratings.dat / u.data /
        # ratings.csv; drops in with zero code when the data exists
        from tpunmf.data.loaders import load_movielens

        csr, _, _ = load_movielens(movielens_path)
        x = np.asarray(csr.todense(), dtype=np.float64)
        m, n = x.shape
        k = 64
    else:
        m, n, k = (max(120, int(6040 * scale)),
                   max(80, int(3706 * scale)), 64)
        k = min(k, min(m, n) // 2)
        x = np.asarray(movielens_like(m, n, density=0.2, seed=2),
                       dtype=np.float64)
    kw = capped(dict(min_iter=5, max_iter=40, tol1=1e-6, tol2=1e-6,
                     nndsvd_init=(True, "zero")))
    ours = anls(x, k, use_fcnnls=True, **kw)
    out = {"config": "ANLS recommender", "shape": [m, n, k], "i": ours.i,
           "rel_err": rel_err(x, ours.w, ours.h)}
    if HAS_REF:
        from nmf import anls as ref_anls

        ref = run_ref(ref_anls.anls, x, k, use_fcnnls=False, **kw)
        out["ref_rel_err"] = rel_err(x, ref.w, ref.h)
        out["final_err_deviation"] = abs(out["rel_err"] - out["ref_rel_err"]) / max(
            out["ref_rel_err"], 1e-12)
        # retrieval parity: our top-10 vs the reference factors' top-10
        _, ours_idx = topk_scores_dense(ours.w[:64], ours.h, 10)
        _, ref_idx = topk_scores_dense(ref.w[:64], ref.h, 10)
        out["recall10_vs_ref"] = recall_at_k(np.asarray(ours_idx),
                                             np.asarray(ref_idx))
    return out


def config3_admm_sparse(scale):
    from tpunmf.data import densify, sparse_csr
    from tpunmf.solvers import admm

    m, n, k = max(200, int(50000 * scale)), max(100, int(20000 * scale)), 128
    k = min(k, min(m, n) // 2)
    csr = sparse_csr(m, n, density=0.02, k=k, seed=3)
    x = np.asarray(densify(csr), dtype=np.float64)
    kw = dict(distance_type="eu", rho=1.0, reg_w=(0, "nn"), reg_h=(0.1, "l1n"),
              min_iter=10, max_iter=150, tol1=1e-6, tol2=1e-6,
              nndsvd_init=(True, "zero"))
    fixed = admm(x, k, **kw)
    damped = admm(x, k, rho_mode="adaptive", **kw)
    out = {"config": "ADMM sparse L1(H)", "shape": [m, n, k],
           "fixed": {"i": fixed.i, "rel_err": rel_err(x, fixed.w, fixed.h)},
           "rho_damped": {"i": damped.i, "rel_err": rel_err(x, damped.w, damped.h)}}
    if HAS_REF:
        from nmf import admm as ref_admm

        ref = run_ref(ref_admm.admm, x, k, **kw)
        out["ref_i"] = ref.i
        out["ref_rel_err"] = rel_err(x, ref.w, ref.h)
        out["final_err_deviation"] = abs(
            out["fixed"]["rel_err"] - out["ref_rel_err"]) / max(out["ref_rel_err"], 1e-12)
        # ADMM's objective is non-monotone and the convergence test fires on
        # the first objective rise (nmf/utils.py:10), so the STOP INDEX is
        # fp-sensitive.  The trajectory comparison below is the robust
        # parity check: fixed iteration budget, no early stop.
        # min_iter == max_iter disables the early stop; tols must stay
        # positive (the reference's precision formatting crashes on 0.0,
        # nmf/admm.py:283)
        kw_fixed = dict(kw, max_iter=25, min_iter=25, tol1=1e-9, tol2=1e-9)
        ours_t = admm(x, k, **kw_fixed)
        ref_t = run_ref(ref_admm.admm, x, k, **kw_fixed)
        ro = np.array(ref_t.obj_history)
        oo = np.array(ours_t.obj_history)
        out["trajectory_max_rel_dev"] = float(
            np.max(np.abs(ro - oo) / np.maximum(np.abs(ro), 1e-12))
        )
        # control: the reference vs ITSELF under a 1-ulp input perturbation
        # — in this config the ADMM dynamics are unstable (objective rises
        # until the stop fires), so fp-level noise amplifies chaotically;
        # our deviation is "real" only if it exceeds this self-divergence.
        x_pert = x * (1.0 + 1e-15)
        ref_p = run_ref(ref_admm.admm, x_pert, k, **kw_fixed)
        rp = np.array(ref_p.obj_history)
        out["ref_self_divergence"] = float(
            np.max(np.abs(ro - rp) / np.maximum(np.abs(ro), 1e-12))
        )
        out["iters_match"] = fixed.i == ref.i
    return out


def config4_ao_admm_sharded(scale):
    import jax

    from tpunmf.data import lowrank_dense
    from tpunmf.parallel import build_mesh, nmf_shardings
    from tpunmf.solvers import ao_admm

    m, n, k = max(128, int(10000 * scale)), max(64, int(5000 * scale)), 32
    k = min(k, min(m, n) // 2)
    # divisible shapes for the (2,4) mesh
    m -= m % 2
    n -= n % 4
    x = lowrank_dense(m, n, k, seed=4, dtype=np.float64)
    kw = dict(distance_type="kl", reg_w=(0.05, "l1n"), reg_h=(0.05, "l2n"),
              min_iter=10, max_iter=60, tol1=1e-6, tol2=1e-6,
              nndsvd_init=(True, "zero"))
    single = ao_admm(x, k, **kw)
    out = {"config": "AO-ADMM-KL mixed-reg", "shape": [m, n, k],
           "i": single.i, "final_kl": float(single.obj_history[-1])}
    if jax.device_count() >= 8:
        import jax.numpy as jnp

        mesh = build_mesh(shape=(2, 4), axis_names=("rows", "cols"))
        xs = jax.device_put(jnp.asarray(x), nmf_shardings(mesh)["v"])
        sharded = ao_admm(xs, k, **kw)
        out["sharded_final_kl"] = float(sharded.obj_history[-1])
        out["sharded_matches"] = bool(
            np.isclose(out["sharded_final_kl"], out["final_kl"], rtol=1e-6)
        )
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--configs", default="0,1,2,3,4")
    ap.add_argument("--newsgroups-root", default=None,
                    help="path to a 20news-bydate-style directory tree: "
                         "config1 runs on the REAL archive")
    ap.add_argument("--max-iter-cap", type=int, default=None,
                    help="cap min/max_iter for full-scale runs (fixed-budget "
                         "iterate parity stays meaningful)")
    ap.add_argument("--movielens-path", default=None,
                    help="path to ratings.dat/u.data/ratings.csv: "
                         "config2 runs on the REAL archive")
    args = ap.parse_args()

    global MAX_ITER_CAP
    MAX_ITER_CAP = args.max_iter_cap

    import functools

    runners = [config0_mur_eu,
               functools.partial(config1_mur_kl,
                                 newsgroups_root=args.newsgroups_root),
               functools.partial(config2_anls_recall,
                                 movielens_path=args.movielens_path),
               config3_admm_sparse, config4_ao_admm_sharded]
    wanted = {int(c) for c in args.configs.split(",")}
    report = {"scale": args.scale, "reference_available": HAS_REF,
              "max_iter_cap": MAX_ITER_CAP, "configs": []}
    for idx, fn in enumerate(runners):
        if idx not in wanted:
            continue
        t0 = time.perf_counter()
        result = fn(args.scale)
        result["total_wall_s"] = round(time.perf_counter() - t0, 2)
        report["configs"].append(result)
        print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
