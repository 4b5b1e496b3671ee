"""Monetary Cost Evaluator (paper Sec. V-C).

  silicon cost = sum_dies Area_die / Yield_die * C_silicon,
                 Yield_die = Yield_unit ^ (Area_die / Area_unit)
  DRAM cost    = ceil(DRAM_bw / Unit_bw) * C_dram_die          (GDDR6: 32 GB/s, $3.5)
  packaging    = (Area_tot * f_scale) / Yield_package^n_dies * C_package(area)

Chiplet areas follow the hardware template: per-core logic (MACs, GLB,
router/DMA/control) plus the D2D interfaces actually instantiated on that
chiplet's boundaries; IO dies carry DDR PHYs, PCIe and their D2D column.

Copy of ``src/repro/core/mc.py``, whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from math import ceil

from .hw import ArchConfig, Tech


@dataclass(frozen=True)
class MCBreakdown:
    silicon: float
    dram: float
    packaging: float
    compute_die_area: float       # one computing chiplet, mm^2
    io_die_area: float            # one IO chiplet, mm^2
    total_silicon_area: float
    d2d_area_fraction: float      # of computing-chiplet area

    @property
    def total(self) -> float:
        return self.silicon + self.dram + self.packaging


def core_logic_area(arch: ArchConfig) -> float:
    t = arch.tech
    return (arch.macs_per_core * t.a_mac
            + arch.glb_kb * t.a_glb_kb
            + t.a_core_fixed)


def d2d_interface_area(arch: ArchConfig) -> float:
    t = arch.tech
    return t.a_d2d_fixed + t.a_d2d_per_gbps * arch.d2d_bw


def _package_rate(tech: Tech, substrate_area: float, n_chiplets: int) -> float:
    if n_chiplets <= 1:
        return tech.c_package_mono_mm2
    for cap, rate in tech.c_package_tiers:
        if substrate_area <= cap:
            return rate
    return tech.c_package_tiers[-1][1]


@lru_cache(maxsize=65536)
def evaluate_mc(arch: ArchConfig) -> MCBreakdown:
    """Monetary cost of one architecture point.

    Pure in the frozen ``ArchConfig``, so results are memoized: the DSE grid
    scorer and ``joint_reuse_dse`` (which revisits each base chiplet once per
    scale factor) pay for each architecture exactly once."""
    t = arch.tech
    cores_per_chiplet = arch.n_cores // arch.n_chiplets
    ifaces_per_chiplet = arch.d2d_interfaces_per_chiplet
    a_d2d = d2d_interface_area(arch) * ifaces_per_chiplet
    # monolithic accelerators still need the IO-die boundary D2D unless the
    # IO functions are folded on-die; the template keeps separate IO dies.
    compute_die = core_logic_area(arch) * cores_per_chiplet + a_d2d

    n_io = 2
    io_die = (t.a_io_die_fixed
              + t.a_dram_phy_per_gbps * arch.dram_bw / n_io
              + d2d_interface_area(arch) * arch.y_cores)   # boundary column

    def die_cost(area: float) -> float:
        yld = t.yield_unit ** (area / t.area_unit_mm2)
        return area / yld * t.c_silicon_mm2

    silicon = arch.n_chiplets * die_cost(compute_die) + n_io * die_cost(io_die)
    dram = ceil(arch.dram_bw / t.dram_die_bw) * t.c_dram_die

    area_tot = arch.n_chiplets * compute_die + n_io * io_die
    n_dies = arch.n_chiplets + n_io
    substrate = area_tot * t.f_scale
    rate = _package_rate(t, substrate, arch.n_chiplets)
    pkg_yield = t.yield_package ** n_dies
    packaging = substrate / pkg_yield * rate

    return MCBreakdown(
        silicon=silicon, dram=dram, packaging=packaging,
        compute_die_area=compute_die, io_die_area=io_die,
        total_silicon_area=area_tot,
        d2d_area_fraction=a_d2d / compute_die if compute_die else 0.0)
