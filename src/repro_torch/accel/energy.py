"""Latency & energy cost model (45 nm-class constants, paper §4.1.1).

Sources: NoC per-hop energy 0.64 pJ/bit (paper, McPAT 1.3); SRAM/DRAM access
energies CACTI-P/Horowitz-class; int8 MAC ≈ 0.23 pJ @45 nm. The *relative*
LTS-vs-TSS and CPU-vs-NPU gaps — which drive every paper figure — come from
these ratios, not absolute calibration.

All methods return seconds / joules.

Copy of the JAX package's ``accel/energy.py`` on the port's ``PSOConfig``
and ``WorkloadGraph``: plain Python floats, the reference's arithmetic in
its order, so the simulator's charges are the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

from repro_torch.accel.platform import Platform
from repro_torch.core.pso import PSOConfig
from repro_torch.workloads.layers import WorkloadGraph

PJ = 1e-12


@dataclasses.dataclass(frozen=True)
class CostModel:
    platform: Platform
    e_mac_int8: float = 0.23 * PJ           # per MAC
    e_sram_byte: float = 1.5 * PJ           # on-chip tile buffer access
    e_dram_byte: float = 160.0 * PJ         # off-chip access
    e_noc_byte_hop: float = 5.12 * PJ       # 0.64 pJ/bit × 8
    engine_util_dnn: float = 0.70           # sustained MAC utilization
    engine_util_matcher: float = 0.45       # small matrices → lower util
    cpu_watts: float = 4.0
    engine_idle_watts: float = 0.025
    avg_hops: float = 3.0                   # mean NoC distance (XY route)

    # ---------------- execution (per-task) ----------------

    def exec_tss(self, wl: WorkloadGraph, engines: int):
        """Tile-cascaded spatial execution: activations stay on-chip."""
        p = self.platform
        rate = engines * p.macs_per_engine * p.clock_hz * self.engine_util_dnn
        t_compute = wl.total_macs / rate
        t_noc = wl.total_bytes * self.avg_hops / (
            p.noc_link_bw_bytes * max(engines // 2, 1))
        t = max(t_compute, t_noc)  # overlapped
        e = (wl.total_macs * self.e_mac_int8
             + wl.total_bytes * (2 * self.e_sram_byte
                                 + self.avg_hops * self.e_noc_byte_hop))
        return t, e

    def exec_lts(self, wl: WorkloadGraph, engines: int,
                 overlap: float = 0.0):
        """Layer-temporal execution: every layer boundary round-trips DRAM.
        ``overlap`` ∈ [0,1) models cross-layer overlapping (CD-MSA-like)."""
        p = self.platform
        rate = engines * p.macs_per_engine * p.clock_hz * self.engine_util_dnn
        t_compute = wl.total_macs / rate
        dram_bytes = 2.0 * wl.total_bytes          # write + read back
        t_dram = dram_bytes / p.dram_bw_bytes
        t = t_compute + t_dram * (1.0 - overlap)
        e = (wl.total_macs * self.e_mac_int8
             + dram_bytes * self.e_dram_byte
             + wl.total_bytes * self.e_sram_byte)
        return t, e

    def preemption_cost_lts(self, live_bytes: float):
        """Context save+restore through DRAM at a layer boundary."""
        t = 2.0 * live_bytes / self.platform.dram_bw_bytes
        e = 2.0 * live_bytes * self.e_dram_byte
        return t, e

    def preemption_cost_tss(self, live_bytes: float):
        """Tile context drains over the NoC to neighbour engines' SRAM."""
        t = live_bytes / self.platform.noc_link_bw_bytes
        e = live_bytes * (self.e_noc_byte_hop * self.avg_hops
                          + self.e_sram_byte)
        return t, e

    # ---------------- scheduling (the paper's subject) ----------------

    def matcher_work_macs(self, n: int, m: int, cfg: PSOConfig) -> float:
        """Analytic MAC count of Algorithm 1 (per full match call)."""
        fitness = n * m * m + n * n * m            # S·G then (S·G)·Sᵀ
        update = 8.0 * n * m                       # fused elementwise pass
        per_step = cfg.num_particles * (fitness + update)
        refine = cfg.refine_iters * cfg.num_particles * (
            2 * n * m * m + 2 * n * n * m)
        project = cfg.num_particles * float(n) * n * m  # n argmax sweeps
        per_epoch = cfg.inner_steps * per_step + refine + project
        return cfg.epochs * per_epoch

    def matcher_prune_macs(self, n: int, m: int, sweeps: int = 4) -> float:
        """Analytic MAC count of the fused global pre-prune: per fused
        iteration one Ullmann refinement sweep (four {0,1}/int matmuls)
        plus one injectivity-propagation pass (row/col reductions)."""
        refine = 2.0 * n * m * m + 2.0 * n * n * m
        inject = 3.0 * n * m
        return max(sweeps, 1) * (refine + inject)

    def sched_immsched_prune(self, n: int, m: int,
                             engines_for_sched: int = 1,
                             sweeps: int = 4):
        """Fused pre-prune of the global compatibility mask ON the
        accelerator (one kernel launch, mask resident in on-chip memory
        for the whole fixpoint loop): the cold-start cost every Tier-2
        (swarm) decision pays before its first epoch. ``sweeps`` is the
        observed/assumed fused-iteration count (the kernels'
        ``prune_sweeps`` observable); the pruned mask (n·m bytes, uint8)
        ships once over the NoC."""
        p = self.platform
        macs = self.matcher_prune_macs(n, m, sweeps)
        rate = (max(engines_for_sched, 1) * p.macs_per_engine * p.clock_hz
                * self.engine_util_matcher)
        t = macs / rate + n * m * self.avg_hops / p.noc_link_bw_bytes
        e = (macs * self.e_mac_int8
             + n * m * self.avg_hops * self.e_noc_byte_hop)
        return t, e

    def sched_immsched(self, n: int, m: int, cfg: PSOConfig,
                       engines_for_sched: int):
        """IMMSched: matcher runs ON the accelerator (int8 datapath),
        particles parallel across engines; consensus via NoC."""
        p = self.platform
        macs = self.matcher_work_macs(n, m, cfg)
        rate = (engines_for_sched * p.macs_per_engine * p.clock_hz
                * self.engine_util_matcher)
        t_compute = macs / rate
        # per-epoch consensus: each engine ships one S (n·m bytes, uint8)
        consensus_bytes = cfg.epochs * engines_for_sched * n * m
        t_noc = consensus_bytes * self.avg_hops / (
            p.noc_link_bw_bytes * max(engines_for_sched // 2, 1))
        e = (macs * self.e_mac_int8
             + consensus_bytes * self.avg_hops * self.e_noc_byte_hop)
        return t_compute + t_noc, e

    def sched_immsched_revalidate(self, n: int, m: int,
                                  engines_for_sched: int = 1,
                                  batch: int = 1):
        """Tier-0/1 pipeline decision: carry rebase + ONE structured
        projection + one feasibility/fitness verification on the
        accelerator — no swarm epochs. A batch of B revalidations spreads
        across the scheduling engines (the problems are independent), so
        latency grows with ceil(B/engines) while energy scales with B;
        only the verified mapping (n·m bytes) ships over the NoC."""
        p = self.platform
        project = float(n) * n * m                 # n masked-argmax sweeps
        verify = float(n) * m * m + float(n) * n * m   # M G Mᵀ ⊇ Q check
        macs_per = project + verify
        rate = p.macs_per_engine * p.clock_hz * self.engine_util_matcher
        eng = max(engines_for_sched, 1)
        rounds = (max(batch, 1) + eng - 1) // eng
        t_compute = rounds * macs_per / rate
        result_bytes = max(batch, 1) * n * m
        t_noc = result_bytes * self.avg_hops / p.noc_link_bw_bytes
        e = (max(batch, 1) * macs_per * self.e_mac_int8
             + result_bytes * self.avg_hops * self.e_noc_byte_hop)
        return t_compute + t_noc, e

    def sched_serial_cpu(self, mac_ops: float, nodes_visited: int):
        """IsoSched-like: serial subgraph matching on the host CPU
        (float32 ops, branchy backtracking)."""
        p = self.platform
        t = (mac_ops / (p.cpu_gops * 1e9)
             + nodes_visited * p.cpu_dispatch_overhead_s)
        e = t * self.cpu_watts
        return t, e

    def sched_lts_heuristic(self, num_tasks: int):
        """PREMA/Planaria/MoCA/CD-MSA-like: priority arithmetic + mapping
        tables on the CPU. Cheap per decision but still host-side."""
        t = 50e-6 + 10e-6 * num_tasks
        return t, t * self.cpu_watts
