"""bench.py smoke test on small CPU shapes (the benchmark itself runs
on the GPU; a CPU run yields no device metric)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_bench_small_shapes():
    import bench

    r = bench.bench_mur_eu(m=128, n=128, k=8, iters=4)
    assert r["iters_per_sec"] > 0
    assert r["gflops_per_chip"] > 0
    assert r["bytes_per_iter"] == 2 * 128 * 128 * 4 + (2 * 128 * 8 + 4 * 8 * 128) * 4
    assert np.isfinite(r["final_obj"])
    kl = bench.bench_mur_kl(m=128, n=96, k=8, iters=3)
    assert kl["iters_per_sec"] > 0 and kl["fused_kl_passes"] is False


def test_bandwidth_tracker_interleaved_best():
    """The ceiling is the best PROBE across interleaved samples of this
    run — never derived from the solver, never read from disk."""
    import bench

    tr = bench.BandwidthTracker(mb=1, gemm_shape=(64, 64, 8))
    tr.sample(iters=2)
    tr.sample(iters=2)
    assert len(tr.samples_stream) == 2 and len(tr.samples_gemm) == 2
    assert len(tr.samples_read) == 2 and len(tr.samples_bf16_gemm) == 2
    assert tr.bw_ceiling == max(tr.samples_read + tr.samples_stream
                                + tr.samples_gemm)
    s = tr.summary()
    assert len(s["stream_rw_samples"]) == 2
    assert s["used"] == round(tr.bw_ceiling / 1e9, 1)


@pytest.mark.parametrize("kind,peaks", [
    ("NVIDIA H100 80GB HBM3", (989e12, 495e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 378e12, 2.0e12)),
])
def test_peaks_keyed_by_device_kind(kind, peaks):
    import bench

    assert bench._chip_limits(kind) == peaks


def test_unknown_device_is_an_error():
    """No assumed peak: a device without a row fails the bench."""
    import bench

    with pytest.raises(ValueError, match="no published peaks"):
        bench._chip_limits("cpu")
    with pytest.raises(ValueError, match="no published peaks"):
        bench._chip_limits()          # this CPU run's device


def test_roofline_bound_and_fraction():
    import bench

    cell = {"bytes_per_iter": 1e9, "flops_per_iter": 1e12,
            "iters_per_sec": 1000.0}
    mem = bench._roofline(cell, 1e12, 1e16)      # 1 ms memory, 0.1 ms flops
    assert mem["bound"] == "memory"
    assert mem["roofline_fraction"] == pytest.approx(1.0)
    comp = bench._roofline(cell, 1e13, 1e14)     # 0.1 ms memory, 10 ms flops
    assert comp["bound"] == "compute"
    assert comp["t_roofline_ms"] == pytest.approx(10.0)


def test_bench_solver_rates_small():
    import bench

    rates = bench.bench_solver_rates(m=96, n=64, k=6, iters=3)
    for name in ("mur_kl", "anls", "admm", "ao_admm", "ao_admm_local_l1inf"):
        assert rates[name] > 0
