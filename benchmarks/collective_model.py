"""Alpha-beta communication model for the sharded NMF schedules.

BASELINE.json's north star asks for ">=80% weak-scaling efficiency to 2+
hosts on a 100M-nonzero matrix".  Multi-host hardware is not available
to measure, so this module gives the machine-checkable paper model: ONE
bounded estimate per (config, hosts) via a per-hop alpha-beta cost with
explicit overlap accounting:

  * every collective is decomposed into ring steps; a step costs
    ``alpha + segment_bytes / beta`` (alpha = per-hop launch+fabric
    latency, beta = link bandwidth);
  * psum (ring all-reduce) of an S-byte operand over d devices:
    2(d-1) steps of S/d bytes -> 2(d-1)*alpha + 2(d-1)/d * S/beta;
  * all_gather of per-device S_loc bytes: (d-1) steps of S_loc;
  * ppermute panel rotation: (d-1) steps of S_loc, where each step's
    transfer is EXPLICITLY overlapped against the per-panel compute the
    schedule runs concurrently (collectives.py:169-206 rotates H while
    the current panel's GEMM runs): a step only exposes
    ``max(0, t_step_transfer - t_step_compute)``.

Parameterization (LinkParams), from NVIDIA's H100 SXM data sheet:
  * device memory 3.35 TB/s and 989 TFLOP/s dense bf16 per GPU;
  * NVLink 450 GB/s each way per GPU, all to all inside a host (the
    'cols' axis);
  * stated assumptions where no data sheet figure applies: 3 us per
    NVLink ring hop, and for the cross-host 'rows' axis one 400 Gb/s
    InfiniBand NIC per GPU (50 GB/s) at 10 us per hop.
The byte/step counts, by contrast, are exact properties of the schedules
and are pinned against the real sharded solvers' compiled HLO in
tests/test_collective_model.py.

Schedules modeled (see tpunmf/parallel/{collectives,sharded_solvers}.py):
  tp_cols   X P(None,cols), H P(None,cols), W replicated.
  mesh_2d   X P(rows,cols), W P(rows,None), H P(None,cols).
  ring      X fixed P(rows,cols); H panels rotate with ppermute.
  ulysses   X flips layout with one hoisted all_to_all; per iter
            all_gather(W) + all_gather(H) over the axis.
  rank      W P(None,rank), H P(rank,None): Gram cross-terms.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, asdict, field

GB = 1e9


# --------------------------------------------------------------- costs

def psum_bytes(operand_bytes: float, d: int) -> float:
    """Per-device bytes sent by a ring all-reduce."""
    return 0.0 if d <= 1 else 2.0 * (d - 1) / d * operand_bytes


def all_gather_bytes(local_bytes: float, d: int) -> float:
    """Per-device bytes sent by a ring all-gather of local shards."""
    return 0.0 if d <= 1 else (d - 1) * local_bytes


@dataclass
class Collective:
    """One collective of a schedule's per-iteration comm plan."""
    kind: str             # 'psum' | 'all_gather' | 'ppermute_ring'
    operand_bytes: float  # full operand (psum) / per-device shard (others)
    d: int                # participating devices on the axis
    fabric: str           # 'nvlink' (the cols axis) | 'rows'
    overlappable: bool = False  # schedule overlaps steps with compute

    @property
    def steps(self) -> int:
        if self.d <= 1:
            return 0
        return 2 * (self.d - 1) if self.kind == "psum" else self.d - 1

    @property
    def bytes_sent(self) -> float:
        if self.kind == "psum":
            return psum_bytes(self.operand_bytes, self.d)
        return all_gather_bytes(self.operand_bytes, self.d)

    def time(self, alpha: float, beta: float) -> float:
        """Serial alpha-beta time (no overlap credit)."""
        return self.steps * alpha + self.bytes_sent / beta

    def exposed_time(self, alpha: float, beta: float,
                     t_compute_overlappable: float) -> float:
        """Time this collective adds to the iteration.

        Non-overlappable collectives expose their full alpha-beta time.
        An overlappable ring rotation exposes only the per-step excess
        over the per-panel compute slice it runs under: with d panels,
        each of the (d-1) transfers overlaps t_compute_overlappable/d of
        GEMM work.  ``t_compute_overlappable`` must be ONLY the compute
        the rotation actually runs under (for the ring schedule, the
        W-half X@H^T panel loop — collectives.py rotates H during that
        loop only; the H-half runs after rotation is complete), NOT the
        full iteration — crediting the full iteration would overstate
        hiding by up to 2x when t_compW/d < t_step <= t_comp/d.
        """
        if not self.overlappable or self.steps == 0:
            return self.time(alpha, beta)
        per_step = alpha + (self.bytes_sent / max(self.steps, 1)) / beta
        compute_slice = t_compute_overlappable / self.d
        return self.steps * max(0.0, per_step - compute_slice)


def schedule_collectives(schedule: str, m: int, n: int, k: int,
                         rows: int = 1, cols: int = 1,
                         elem: int = 4) -> list[Collective]:
    """The exact per-iteration collective plan of a schedule.

    Convention (production mesh): 'cols' inside a host (NVLink), 'rows'
    across hosts — the cross-host psum operand k*n_loc is the small
    factor panel while m_loc*k stays on NVLink.  Byte counts are
    pinned against the compiled HLO of the real sharded solvers in
    tests/test_collective_model.py.
    """
    m_loc, n_loc = m // max(rows, 1), n // max(cols, 1)
    kk = k * k * elem
    if schedule == "tp_cols":
        return [
            Collective("psum", m * k * elem, cols, "nvlink"),
            Collective("psum", kk, cols, "nvlink"),
        ]
    if schedule == "mesh_2d":
        return [
            Collective("psum", m_loc * k * elem, cols, "nvlink"),
            Collective("psum", kk, cols, "nvlink"),
            Collective("psum", k * n_loc * elem, rows, "rows"),
            Collective("psum", kk, rows, "rows"),
        ]
    if schedule == "ring":
        # H panel rotation replaces the cols-psum of XHt; each of the
        # (cols-1) sends is a k x n/cols panel and overlaps the next
        # panel's GEMM (collectives.py:169-206 rotates H, X never moves)
        return [
            Collective("ppermute_ring", k * n_loc * elem, cols, "nvlink",
                       overlappable=True),
            Collective("psum", kk, cols, "nvlink"),
            Collective("psum", k * n_loc * elem, rows, "rows"),
            Collective("psum", kk, rows, "rows"),
        ]
    if schedule == "ulysses":
        return [
            Collective("all_gather", m // max(cols, 1) * k * elem, cols,
                       "nvlink"),
            Collective("all_gather", k * n_loc * elem, cols, "nvlink"),
        ]
    if schedule == "rank":
        k_loc = k // max(cols, 1)
        return [
            Collective("all_gather", k_loc * k * elem, cols, "nvlink"),
            Collective("psum", kk, cols, "nvlink"),
            Collective("psum", kk, cols, "nvlink"),
        ]
    raise ValueError(f"unknown schedule {schedule!r}")


def schedule_bytes(schedule: str, m: int, n: int, k: int,
                   rows: int = 1, cols: int = 1, elem: int = 4) -> dict:
    """Aggregate per-device collective bytes per iteration (back-compat
    view of schedule_collectives)."""
    out = {"nvlink": 0.0, "network": 0.0, "overlappable": 0.0}
    for c in schedule_collectives(schedule, m, n, k, rows, cols, elem):
        if c.overlappable:
            out["overlappable"] += c.bytes_sent
        else:
            # 'network' here means "the rows axis" — whether those bytes
            # leave the NVLink domain is a Scenario.row_fabric decision
            out["network" if c.fabric == "rows" else "nvlink"] += c.bytes_sent
    return out


# --------------------------------------------------------- link params

@dataclass
class LinkParams:
    """Hardware parameters: published H100 figures, and stated
    assumptions where none applies (see module docstring)."""
    hbm_gbps: float = 3350.0      # H100 SXM device memory
    bf16_tflops: float = 989.0    # H100 SXM dense bf16
    nvlink_gbps: float = 450.0    # per GPU, each way
    nvlink_alpha_us: float = 3.0  # per-hop latency (assumption)
    network_gbps: float = 50.0    # per GPU: one 400 Gb/s NIC (assumption)
    network_alpha_us: float = 10.0  # per-hop latency (assumption)
    source: str = "H100 SXM data sheet + stated assumptions"


# ----------------------------------------------------------- scenarios

@dataclass
class Scenario:
    """One weak-scaling efficiency evaluation."""
    name: str
    schedule: str
    m: int
    n: int
    k: int
    hosts: int
    gpus_per_host: int
    x_elem: int = 4            # X dtype bytes (2 = bf16 data/collectives)
    coll_elem: int = 4         # collective operand dtype bytes
    nnz: int | None = None     # sparse: total nonzeros (else dense)
    densify_factor: float = 4.0  # dense panel cells per nnz (streaming)
    inner_compute_mult: float = 1.0  # e.g. AO-ADMM inner-loop local work
    # What fabric the 'rows' axis rides.  'nvlink': rows stay inside one
    # NVLink domain; 'network': rows cross hosts, each GPU through its
    # own NIC.
    row_fabric: str = "network"
    links: LinkParams = field(default_factory=LinkParams)

    def evaluate(self) -> dict:
        rows, cols = self.hosts, self.gpus_per_host
        d = rows * cols
        m_loc = self.m // max(rows, 1)
        n_loc = self.n // max(cols, 1)
        L = self.links
        # --- compute floor per GPU: max(memory roofline, bf16 roofline)
        if self.nnz is None:
            cells = m_loc * n_loc           # dense local block
        else:
            cells = self.nnz / d * self.densify_factor
        flops = 4.0 * cells * self.k * self.inner_compute_mult
        x_bytes = cells * self.x_elem * self.inner_compute_mult
        fac_bytes = (4.0 * m_loc * self.k + 4.0 * self.k * n_loc) * 4
        t_comp = max((x_bytes + fac_bytes) / (L.hbm_gbps * GB),
                     flops / (L.bf16_tflops * 1e12))
        # --- communication: alpha-beta per collective, overlap-aware
        plan = schedule_collectives(self.schedule, self.m, self.n, self.k,
                                    rows=rows, cols=cols,
                                    elem=self.coll_elem)
        t_exposed = t_serial = 0.0
        bytes_acc = {"nvlink": 0.0, "network": 0.0, "overlappable": 0.0}
        # the ring rotation only runs under the W-half X@H^T panel loop
        # (the H-half starts after rotation completes), and the X-sized
        # work splits evenly between the two halves — so only half the
        # iteration's compute is available to hide the rotation.
        t_comp_overlappable = 0.5 * t_comp
        for c in plan:
            if c.fabric == "rows" and self.row_fabric == "network":
                alpha, beta = L.network_alpha_us * 1e-6, L.network_gbps * GB
            else:
                alpha, beta = L.nvlink_alpha_us * 1e-6, L.nvlink_gbps * GB
            t_serial += c.time(alpha, beta)
            t_exposed += c.exposed_time(alpha, beta, t_comp_overlappable)
            if c.overlappable:
                key = "overlappable"
            elif c.fabric == "rows" and self.row_fabric == "network":
                key = "network"
            else:
                key = "nvlink"
            bytes_acc[key] += c.bytes_sent
        eff = t_comp / (t_comp + t_exposed)
        return {
            **{kk: v for kk, v in asdict(self).items() if kk != "links"},
            "links": asdict(L),
            "bytes_per_iter_per_gpu": {kk: round(v)
                                        for kk, v in bytes_acc.items()},
            "t_compute_ms": round(t_comp * 1e3, 4),
            "t_comm_serial_ms": round(t_serial * 1e3, 4),
            "t_comm_exposed_ms": round(t_exposed * 1e3, 4),
            "efficiency_no_overlap": round(t_comp / (t_comp + t_serial), 3),
            "efficiency": round(eff, 3),
        }


def baseline_scenarios() -> list[dict]:
    """The scenarios the BASELINE weak-scaling claim rests on.

    Weak scaling GROWS the matrix with the host count: per-GPU block
    (and nnz/GPU) stays constant, hosts extend the row axis (the mesh
    'rows' axis crosses hosts, so the cross-host psum operand k*n_loc is a
    small factor panel and its bytes are CONSTANT in host count — the
    only growth is the ring all-reduce factor 2(H-1)/H -> 2 plus the
    alpha terms' 2(H-1) hops).
    """
    out = []
    # (a) dense production unit: a bf16 per-GPU block (262144 x 8192,
    # ~4.3 GB) at rank 128, bf16 collectives, ring
    # schedule (H-panel ppermute rotation overlaps per-step GEMMs).
    for hosts in (1, 2, 4, 8):
        out.append(Scenario(
            name=f"dense_ring_bf16_262144rows_{hosts}host",
            schedule="ring", m=262_144 * hosts, n=8192 * 8, k=128,
            hosts=hosts, gpus_per_host=8, x_elem=2,
            coll_elem=2).evaluate())
    # (b) config[3]: ADMM with L1-regularized H, 50k x 20k sparse,
    # rank 128 (BASELINE.json configs[3]).  Density unstated in the
    # config; assume 10% (100M nnz at this shape — the north star's
    # own nonzero count), streamed dense panels at densify_factor 4.
    # Flat ADMM's per-iteration X traffic matches MUR (W^T X and X H^T
    # once each); the k x k solves and prox are rank-sized local work
    # (inner_compute_mult 1.2 covers them).  Weak scaling grows rows.
    # (c) config[4]: AO-ADMM KL + mixed regularizers, 1M x 100k sharded,
    # rank 256, 100M nnz (BASELINE.json configs[4] + north star).
    # 500k rows + 50M nnz per host; inner-ADMM loops are factor-sized
    # local work on top of the single X pass (inner_compute_mult 1.5,
    # an assumed inner/outer cost ratio at 5 inner iters).
    # Each with rows inside one NVLink domain and across hosts.
    for hosts in (2, 4, 8):
        for fab in ("nvlink", "network"):
            out.append(Scenario(
                name=f"config3_admm_l1_sparse_{hosts}host_rows-{fab}",
                schedule="ring", m=25_000 * hosts, n=20_000, k=128,
                hosts=hosts, gpus_per_host=8, nnz=50_000_000 * hosts,
                densify_factor=4.0, inner_compute_mult=1.2,
                coll_elem=2, row_fabric=fab).evaluate())
            out.append(Scenario(
                name=f"config4_ao_admm_kl_sparse_{hosts}host_rows-{fab}",
                schedule="ring", m=500_000 * hosts, n=100_000, k=256,
                hosts=hosts, gpus_per_host=8, nnz=50_000_000 * hosts,
                densify_factor=4.0, inner_compute_mult=1.5,
                coll_elem=2, row_fabric=fab).evaluate())
    # (d) config[4] without any overlap credit and f32 collectives on a
    # plain 2-D mesh across hosts — the honest worst case
    out.append(Scenario(
        name="config4_ao_admm_kl_2host_serial_f32_rows-network",
        schedule="mesh_2d", m=1_000_000, n=100_000, k=256, hosts=2,
        gpus_per_host=8, nnz=100_000_000, densify_factor=4.0,
        inner_compute_mult=1.5, row_fabric="network").evaluate())
    return out


def schedule_table(m=8192, n=8192, k=128) -> dict:
    """Collective bytes/iteration for every schedule at the headline
    shape on an 8-GPU (1 host) and 2x8 (2 host) mesh."""
    table = {}
    for sched in ("tp_cols", "mesh_2d", "ring", "ulysses", "rank"):
        table[sched] = {
            "1host_8gpu": {kk: round(v) for kk, v in schedule_bytes(
                sched, m, n, k, rows=1, cols=8).items()},
            "2host_16gpu": {kk: round(v) for kk, v in schedule_bytes(
                sched, m, n, k, rows=2, cols=8).items()},
        }
    return table


if __name__ == "__main__":
    report = {
        "model": "alpha-beta per-hop with explicit ring-overlap exposure; "
                 "H100 data-sheet figures, stated link latencies",
        "schedule_bytes_8192x8192_r128": schedule_table(),
        "scenarios": baseline_scenarios(),
    }
    print(json.dumps(report, indent=1))
