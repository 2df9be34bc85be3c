"""Golden-parity and property tests for ANLS (reference: nmf/anls.py:50-135)."""
import contextlib
import io

import numpy as np
import pytest

from tpunmf.solvers import anls

from conftest import requires_reference


def _run_reference_anls(x, k, **kw):
    from nmf import anls as ref_anls

    with contextlib.redirect_stdout(io.StringIO()):
        return ref_anls.anls(x.copy(), k, **kw)


@requires_reference
@pytest.mark.parametrize("lambdas", [(0.0, 0.0), (0.05, 0.02)])
def test_parity_vs_reference_scipy_path(lowrank_data, lambdas):
    """Each half-step solves its NNLS subproblem exactly, so iterates must
    match the reference's per-column Lawson-Hanson path."""
    lw, lh = lambdas
    kw = dict(min_iter=5, max_iter=25, tol1=1e-10, tol2=1e-10,
              lambda_w=lw, lambda_h=lh, nndsvd_init=(True, "zero"))
    ref = _run_reference_anls(lowrank_data, 5, use_fcnnls=False, **kw)
    ours = anls(lowrank_data, 5, **kw)
    ro, oo = np.array(ref.obj_history), np.array(ours.obj_history)
    n = min(len(ro), len(oo))
    np.testing.assert_allclose(oo[:n], ro[:n], rtol=1e-7)
    np.testing.assert_allclose(ours.w, ref.w, rtol=1e-5, atol=1e-7)


@requires_reference
def test_parity_vs_reference_fcnnls_path(lowrank_data):
    """The reference FCNNLS path should land on the same objective."""
    kw = dict(min_iter=5, max_iter=20, tol1=1e-10, tol2=1e-10,
              nndsvd_init=(True, "zero"))
    ref = _run_reference_anls(lowrank_data, 5, use_fcnnls=True, **kw)
    ours = anls(lowrank_data, 5, use_fcnnls=True, **kw)
    np.testing.assert_allclose(
        np.array(ours.obj_history), np.array(ref.obj_history)[: len(ours.obj_history)],
        rtol=1e-6,
    )


def test_bpp_and_activeset_agree(lowrank_data):
    kw = dict(min_iter=5, max_iter=15, tol1=1e-10, tol2=1e-10,
              nndsvd_init=(True, "zero"))
    a = anls(lowrank_data, 5, nnls_solver="activeset", **kw)
    b = anls(lowrank_data, 5, nnls_solver="bpp", **kw)
    np.testing.assert_allclose(
        np.array(a.obj_history), np.array(b.obj_history), rtol=1e-8
    )


def test_kl_reporting_only(lowrank_data):
    """distance_type='kl' changes only the reported objective — the
    factors evolve identically to the EU run (nmf/anls.py:108 quirk)."""
    kw = dict(min_iter=5, max_iter=12, tol1=1e-12, tol2=1e-12,
              nndsvd_init=(True, "zero"))
    eu = anls(lowrank_data, 5, distance_type="eu", **kw)
    kl = anls(lowrank_data, 5, distance_type="kl", **kw)
    np.testing.assert_allclose(kl.w, eu.w, rtol=1e-9)
    assert not np.allclose(kl.obj_history[-1], eu.obj_history[-1])


def test_factors_nonnegative(lowrank_data):
    res = anls(lowrank_data, 5, min_iter=5, max_iter=10, tol1=1e-12, tol2=1e-12)
    assert res.w.min() >= 0 and res.h.min() >= 0


def test_objective_monotone_nonincreasing(lowrank_data):
    """Each ANLS half-step solves its subproblem exactly, so the EU
    objective never increases."""
    res = anls(lowrank_data, 5, min_iter=3, max_iter=25, tol1=1e-14,
               tol2=1e-14, nndsvd_init=(True, "zero"))
    hist = np.array(res.obj_history)
    assert np.all(np.diff(hist) <= 1e-9 * np.maximum(hist[:-1], 1.0))


def test_bad_nnls_solver_raises(lowrank_data):
    import pytest

    with pytest.raises(ValueError, match="nnls_solver"):
        anls(lowrank_data, 4, nnls_solver="bogus")


def test_host_loop_matches_device_loop(lowrank_data):
    """The host-driven loop (device_loop=False) must reproduce the device while_loop
    exactly (same math, same convergence semantics)."""
    kw = dict(min_iter=3, max_iter=20, tol1=1e-7, tol2=1e-7,
              nndsvd_init=(True, "zero"))
    dev = anls(lowrank_data, 5, device_loop=True, **kw)
    host = anls(lowrank_data, 5, device_loop=False, **kw)
    assert host.i == dev.i
    np.testing.assert_allclose(np.array(host.obj_history),
                               np.array(dev.obj_history), rtol=1e-12)
    np.testing.assert_allclose(host.w, dev.w, rtol=1e-12)


def test_cg_masked_solver_matches_chol_trajectory(lowrank_data):
    """ANLS with the GEMM-shaped CG inner solver reproduces the direct-solve
    trajectory (f64: CG is exact to solver precision)."""
    kw = dict(min_iter=3, max_iter=15, tol1=1e-10, tol2=1e-10,
              nndsvd_init=(True, "zero"))
    chol = anls(lowrank_data, 5, masked_solver="chol", **kw)
    cg = anls(lowrank_data, 5, masked_solver="cg", **kw)
    assert cg.i == chol.i
    np.testing.assert_allclose(np.array(cg.obj_history),
                               np.array(chol.obj_history), rtol=1e-8)
    np.testing.assert_allclose(cg.w, chol.w, rtol=1e-6, atol=1e-9)


def test_anls_host_loop_matches_device_loop(lowrank_data, tmp_path):
    """The host-driven path (device_loop=False) must share run_loop semantics:
    identical trajectory to the device loop, plus checkpoint/resume."""
    import numpy as np

    from tpunmf.solvers import anls

    kw = dict(min_iter=3, max_iter=12, tol1=0.0, tol2=0.0,
              nndsvd_init=(True, "zero"))
    dev = anls(lowrank_data, 4, **kw)
    host = anls(lowrank_data, 4, device_loop=False, **kw)
    np.testing.assert_allclose(
        np.array(host.obj_history), np.array(dev.obj_history), rtol=1e-10)
    np.testing.assert_allclose(host.w, dev.w, rtol=1e-10)

    # checkpointed run drives run_loop's callback machinery; a resume from
    # the saved carry reproduces the same final state
    ckpt = str(tmp_path / "anls_host.ckpt")
    calls = []
    ck = anls(lowrank_data, 4, device_loop=False, checkpoint_path=ckpt,
              checkpoint_every=4, on_block_end=lambda c: calls.append(int(c.i)),
              **kw)
    assert calls == [4, 8, 12]  # run_loop blocked the host loop
    resumed = anls(lowrank_data, 4, device_loop=False, checkpoint_path=ckpt,
                   resume=True, **kw)
    np.testing.assert_allclose(resumed.w, ck.w, rtol=1e-12)
    np.testing.assert_allclose(
        np.array(resumed.obj_history), np.array(ck.obj_history), rtol=1e-12)


def test_anls_nnls_opts(lowrank_data):
    """The nnls_opts throughput knobs run and stay near the exact path."""
    import numpy as np

    from tpunmf.solvers import anls

    kw = dict(min_iter=3, max_iter=10, tol1=0.0, tol2=0.0,
              nndsvd_init=(True, "zero"))
    exact = anls(lowrank_data, 4, **kw)
    fast = anls(lowrank_data, 4,
                nnls_opts=dict(max_outer=16, opt_tol_ulps=1000.0), **kw)
    assert np.all(np.isfinite(fast.obj_history))
    # relaxed NNLS stays within a few percent of the exact trajectory
    assert fast.obj_history[-1] < 1.10 * exact.obj_history[-1]
