"""Hardware template for Gemini (paper Sec. III) + technology constants.

Reduced copy of ``src/repro/core/hw.py``: ``Tech``, ``TECH_12NM``,
``ArchConfig`` (fields, ``n_cores``, ``n_chiplets``, ``tops``, ``label()``,
and the
geometry the cost model reads, ``:148-210``: ``core_glb_bytes``,
``replace``, ``grid_w``/``grid_h``, ``core_node``, ``core_xy``,
``dram_node``, ``chiplet_of_core``, ``node_chiplet``), the D2D interface
count of the cost/area model (``d2d_interfaces_per_chiplet``, ``:211``)
and the paper's architectures ``simba_arch``, ``gemini_arch_72t`` and
``tenstorrent_arch`` (``:233-252``).  ``TPUChip`` and the TPU roofline
constants belong to the mesh bridge and stay in the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple


@dataclass(frozen=True)
class Tech:
    """Per-technology energy / area / cost constants (int8 inference)."""
    name: str
    # energy, joules
    e_mac: float            # per 8-bit MAC
    e_glb_byte: float       # per byte GLB (SRAM) access
    e_noc_hop_byte: float   # per byte per NoC hop (router+wire)
    e_d2d_byte: float       # per byte crossing one D2D interface
    e_dram_byte: float      # per byte of DRAM traffic
    # area, mm^2
    a_mac: float            # per MAC unit
    a_glb_kb: float         # per KB of GLB SRAM
    a_core_fixed: float     # router + DMA + control + vector unit
    a_d2d_fixed: float      # per D2D interface (PHY + controller), fixed part
    a_d2d_per_gbps: float   # per D2D interface, bandwidth-proportional part
    a_io_die_fixed: float   # per IO chiplet (PCIe, misc analog)
    a_dram_phy_per_gbps: float  # DDR PHY area per GB/s on the IO die
    # monetary cost
    c_silicon_mm2: float    # $ per mm^2 of (yielded) silicon
    yield_unit: float       # yield of one Area_unit die
    area_unit_mm2: float    # the unit area for the yield model
    c_dram_die: float       # $ per DRAM die
    dram_die_bw: float      # GB/s per DRAM die
    f_scale: float          # substrate area / total silicon area
    yield_package: float    # per-die mount yield (compounds with #dies)
    c_package_mono_mm2: float   # $/mm^2, plain fan-out substrate (monolithic)
    # chiplet-grade organic substrate tiers: (max_area_mm2, $/mm^2)
    c_package_tiers: Tuple[Tuple[float, float], ...] = (
        (1000.0, 0.020), (3000.0, 0.030), (float("inf"), 0.045))


TECH_12NM = Tech(
    name="tsmc12",
    e_mac=0.25e-12,
    e_glb_byte=1.2e-12,
    e_noc_hop_byte=0.8e-12,
    e_d2d_byte=9.4e-12,
    e_dram_byte=60e-12,
    a_mac=3.0e-4,
    a_glb_kb=1.0e-3,
    a_core_fixed=0.45,
    a_d2d_fixed=0.20,
    a_d2d_per_gbps=0.012,
    a_io_die_fixed=12.0,
    a_dram_phy_per_gbps=0.04,
    c_silicon_mm2=0.09,
    yield_unit=0.9,
    area_unit_mm2=40.0,
    c_dram_die=3.5,
    dram_die_bw=32.0,
    f_scale=4.0,
    yield_package=0.99,
    c_package_mono_mm2=0.005,
)


@dataclass(frozen=True)
class ArchConfig:
    """One point of the paper's architecture space.

    Printed form follows the paper: (Chiplets, Cores, DRAM_BW, NoC_BW,
    D2D_BW, GLB/Core, MAC/Core).
    """
    x_cores: int
    y_cores: int
    xcut: int = 1
    ycut: int = 1
    noc_bw: float = 32.0          # GB/s per directed NoC link
    d2d_bw: float = 16.0          # GB/s per directed D2D interface
    dram_bw: float = 144.0        # GB/s aggregate
    glb_kb: int = 2048            # per core
    macs_per_core: int = 1024
    freq_ghz: float = 1.0
    n_dram: int = 2               # DRAM ports (one per IO chiplet by default)
    tech: Tech = TECH_12NM

    def __post_init__(self):
        if self.x_cores % self.xcut or self.y_cores % self.ycut:
            raise ValueError(
                f"cut ({self.xcut},{self.ycut}) must divide core grid "
                f"({self.x_cores},{self.y_cores})")
        if self.n_dram < 1:
            raise ValueError("need at least one DRAM port")

    @property
    def n_cores(self) -> int:
        return self.x_cores * self.y_cores

    @property
    def n_chiplets(self) -> int:
        return self.xcut * self.ycut

    @property
    def tops(self) -> float:
        """Peak int8 TOPS (2 ops per MAC)."""
        return self.n_cores * self.macs_per_core * 2 * self.freq_ghz / 1e3

    @property
    def core_glb_bytes(self) -> int:
        return self.glb_kb * 1024

    def label(self) -> str:
        return (f"({self.n_chiplets}, {self.n_cores}, {self.dram_bw:g}GB/s, "
                f"{self.noc_bw:g}GB/s, "
                f"{'None' if self.n_chiplets == 1 else f'{self.d2d_bw:g}GB/s'}, "
                f"{self.glb_kb // 1024}MB, {self.macs_per_core})")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # -- grid geometry --------------------------------------------------------
    # Router-node grid: columns 0 and x_cores+1 are the west/east IO chiplets,
    # columns 1..x_cores hold the cores.  Node id = y * (x_cores+2) + x.
    @property
    def grid_w(self) -> int:
        return self.x_cores + 2

    @property
    def grid_h(self) -> int:
        return self.y_cores

    def core_node(self, core_id: int) -> int:
        """Router node of a core (cores are row-major over (y, x))."""
        y, x = divmod(core_id, self.x_cores)
        return y * self.grid_w + (x + 1)

    def core_xy(self, core_id: int) -> Tuple[int, int]:
        y, x = divmod(core_id, self.x_cores)
        return x, y

    def dram_node(self, dram_id: int) -> int:
        """Router node of a DRAM port (1-based id; spread over both IO dies)."""
        d = dram_id - 1
        side = d % 2                     # 0 -> west, 1 -> east
        row = (d // 2) * max(1, self.y_cores // max(1, (self.n_dram + 1) // 2))
        row = min(row, self.y_cores - 1)
        x = 0 if side == 0 else self.grid_w - 1
        return row * self.grid_w + x

    @cached_property
    def chiplet_of_core(self) -> Tuple[int, ...]:
        """Chiplet index of every core (row-major chiplet grid)."""
        cw = self.x_cores // self.xcut
        ch = self.y_cores // self.ycut
        out = []
        for cid in range(self.n_cores):
            x, y = self.core_xy(cid)
            out.append((y // ch) * self.xcut + (x // cw))
        return tuple(out)

    def node_chiplet(self, node: int) -> int:
        """Chiplet of a router node: -1 west IO die, -2 east IO die."""
        y, x = divmod(node, self.grid_w)
        if x == 0:
            return -1
        if x == self.grid_w - 1:
            return -2
        cw = self.x_cores // self.xcut
        ch = self.y_cores // self.ycut
        return (y // ch) * self.xcut + ((x - 1) // cw)

    @cached_property
    def d2d_interfaces_per_chiplet(self) -> float:
        """Average number of D2D interfaces per computing chiplet.

        Interfaces sit on both sides of every inter-chiplet boundary link,
        including the IO-die <-> core-array boundary (paper Fig. 2: the IO
        controllers join the same mesh through D2D).
        """
        n_ifaces = 0
        for y in range(self.grid_h):
            for x in range(self.grid_w):
                n = y * self.grid_w + x
                for nx, ny in ((x + 1, y), (x, y + 1)):
                    if nx >= self.grid_w or ny >= self.grid_h:
                        continue
                    m = ny * self.grid_w + nx
                    if self.node_chiplet(n) != self.node_chiplet(m):
                        n_ifaces += 2          # one TX/RX pair on each die
        return n_ifaces / max(1, self.n_chiplets)


def simba_arch() -> ArchConfig:
    """S-Arch: 36 chiplets x 1 core, 72 TOPS (paper Sec. VI-A4)."""
    return ArchConfig(x_cores=6, y_cores=6, xcut=6, ycut=6,
                      noc_bw=16.0, d2d_bw=8.0, dram_bw=144.0,
                      glb_kb=1024, macs_per_core=1024)


def gemini_arch_72t() -> ArchConfig:
    """G-Arch found by the paper's 72-TOPS DSE: (2, 36, 144, 32, 16, 2MB, 1024)."""
    return ArchConfig(x_cores=6, y_cores=6, xcut=2, ycut=1,
                      noc_bw=32.0, d2d_bw=16.0, dram_bw=144.0,
                      glb_kb=2048, macs_per_core=1024)


def tenstorrent_arch() -> ArchConfig:
    """T-Arch: 120-core monolithic Grayskull-like (paper Sec. VI-B2)."""
    return ArchConfig(x_cores=12, y_cores=10, xcut=1, ycut=1,
                      noc_bw=32.0, d2d_bw=32.0, dram_bw=192.0,
                      glb_kb=1024, macs_per_core=512)
