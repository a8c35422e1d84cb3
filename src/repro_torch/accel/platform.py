"""Accelerator platform models (paper Table 2).

Edge:  64 engines × (128×128 MACs) @ 700 MHz
Cloud: 128 engines × (128×128 MACs) @ 700 MHz

Engines sit on a 2-D mesh NoC (8×8 / 8×16) with on-chip links — the TSS
substrate. A host CPU model is included because the LTS/IsoSched baselines
run their scheduling there.

Numpy copy of the JAX package's ``accel/platform.py``; the port keeps its own
copy so that importing it never pulls in JAX.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    engines: int                 # number of engines (target-graph vertices)
    noc_rows: int
    noc_cols: int
    macs_per_engine: int         # systolic array size
    clock_hz: float
    sram_bytes_per_engine: int   # local tile buffer
    dram_bw_bytes: float         # off-chip bandwidth (shared)
    noc_link_bw_bytes: float     # per on-chip link
    # host CPU running serial schedulers (baselines)
    cpu_gops: float              # effective scalar-ish throughput
    cpu_dispatch_overhead_s: float

    @property
    def peak_macs_per_s(self) -> float:
        return self.engines * self.macs_per_engine * self.clock_hz

    def engine_tile_capacity_macs(self, tile_cycles: int = 4096) -> float:
        """MACs one engine retires in a scheduling tile quantum."""
        return self.macs_per_engine * tile_cycles


EDGE = Platform(
    name="edge", engines=64, noc_rows=8, noc_cols=8,
    macs_per_engine=128 * 128, clock_hz=700e6,
    sram_bytes_per_engine=256 * 1024,
    dram_bw_bytes=12.8e9, noc_link_bw_bytes=11.2e9,   # 128b @ 700MHz
    cpu_gops=8.0, cpu_dispatch_overhead_s=2e-6)

CLOUD = Platform(
    name="cloud", engines=128, noc_rows=8, noc_cols=16,
    macs_per_engine=128 * 128, clock_hz=700e6,
    sram_bytes_per_engine=512 * 1024,
    dram_bw_bytes=25.6e9, noc_link_bw_bytes=11.2e9,
    cpu_gops=16.0, cpu_dispatch_overhead_s=2e-6)

_PLATFORMS = {"edge": EDGE, "cloud": CLOUD}


def get_platform(name: str) -> Platform:
    return _PLATFORMS[name]
