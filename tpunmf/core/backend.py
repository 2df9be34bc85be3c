"""Per-backend choices, in one table.

Every solver default that depends on the device is read from here; an
explicit argument from the caller always wins.  ``gpu`` is the H100
row, ``cpu`` the row the tests and the parity runs use.  A backend
without a row is an error, not a fallback.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax


@dataclass(frozen=True)
class BackendDefaults:
    # the fused Pallas passes over X (ops/fused.py) exist for this
    # backend and run by default (MUR, and the objectives of ANLS, ADMM
    # and AO-ADMM)
    pallas: bool
    # (k, k) SPD solves: ANLS masked NNLS, ADMM, AO-ADMM, online NMF
    spd_solver: str
    # CG steps per masked NNLS solve when spd_solver='cg' (0 = l + 8)
    cg_iters: int
    # matmul precision of the k-sized NNLS internals (duals, CG matvecs);
    # None = the session default.  The X-sized products are not affected.
    nnls_precision: Optional[str]
    # AO-ADMM inner loop lowering (solvers/common.inner_loop)
    inner_loop: str
    # NNDSVD 'auto': exact SVD up to this min-dim, randomized beyond.  Kept
    # high on purpose: the randomized range finder changes the init
    # slightly, which shifts solver trajectories (measured on the CPU: a
    # 5.8% ADMM trajectory deviation at min-dim 5000, against 5e-15 with
    # the exact SVD), so rSVD is for sizes no reference comparison reaches.
    rsvd_threshold: int


_TABLE = {
    # pallas: within their rank gate (ops/fused.MAX_RANK) the fused passes
    # beat the XLA step end to end (PERF.md, "Kernels against XLA").
    # nnls_precision: TF32's ~1e-3 relative noise on the k-sized duals
    # makes active-set columns cycle on noise; 'highest' costs little at
    # rank size.  The solver choices are the CPU's until measured
    # (ROADMAP, Speed 6).
    "gpu": BackendDefaults(pallas=True, spd_solver="chol",
                           cg_iters=0, nnls_precision="highest",
                           inner_loop="while", rsvd_threshold=16384),
    "cpu": BackendDefaults(pallas=False, spd_solver="chol",
                           cg_iters=0, nnls_precision=None,
                           inner_loop="while", rsvd_threshold=16384),
}


def defaults(backend: Optional[str] = None) -> BackendDefaults:
    """The row for ``backend`` (default: ``jax.default_backend()``)."""
    backend = backend or jax.default_backend()
    try:
        return _TABLE[backend]
    except KeyError:
        raise ValueError(
            f"no per-backend defaults for {backend!r}; "
            f"rows exist for {sorted(_TABLE)}") from None


def use_kernels(x, k: int, use_pallas: Optional[bool]) -> bool:
    """Whether the passes over ``x`` run as the fused Pallas kernels.

    ``use_pallas=None`` takes the backend's row.  ``True`` on a backend
    with no kernels raises: the kernels are never run in interpret mode
    behind the caller's back.  A sharded ``x`` takes the XLA step (a
    ``pallas_call`` is not partitioned, so a sharded X would be gathered
    whole onto every device), as does a shape or dtype the kernels do
    not take (``ops.fused.kernel_fits``).
    """
    from ..ops.fused import kernel_fits

    has_kernels = defaults().pallas
    if use_pallas and not has_kernels:
        raise ValueError(
            f"use_pallas=True, but backend {jax.default_backend()!r} has no "
            "Pallas kernels (they are built for the GPU's Triton route)")
    if not (has_kernels if use_pallas is None else use_pallas):
        return False
    sharding = getattr(x, "sharding", None)
    if sharding is not None and len(sharding.device_set) > 1:
        return False
    return kernel_fits(x, k)
