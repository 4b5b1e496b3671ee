"""Bridge: Gemini LMS mappings -> stage plans.

Copy of ``src/repro/core/bridge.py``: ``TECH_TPUPOD`` and ``mesh_as_arch``
(the abstract accelerator whose geometry mirrors a device mesh: devices as
cores, pods as chiplets, the device links as NoC and D2D), ``StagePlan``,
``MeshPlan`` (with ``stage_of``), ``lms_to_plan`` and ``plan_for_graph``
(the whole Gemini flow, DP graph partition then SA, on a layer graph);
``plan_from_tuples`` builds a graph and its plan by hand.
Each layer group becomes one pipeline stage whose core set is the union
of its layers' CGs; the per-layer ``Part`` and ordered ``CG`` ride along
for the stage's logical sharding.  :mod:`repro_torch.runtime.pipeline`
executes a plan.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .encoding import Mapping
from .graph_partition import partition_graph
from .hw import ArchConfig, Tech
from .sa import SAConfig, sa_optimize
from .workload import Graph, Layer

# The reference's constants for its abstract mesh model (devices as cores;
# energies per byte moved on the device links; the silicon-cost fields
# zeroed).  They are inputs to the cost model, kept as the reference has
# them so that a plan equals the reference's, not figures of any device.
TECH_TPUPOD = Tech(
    name="tpu-pod",
    e_mac=0.15e-12, e_glb_byte=0.8e-12, e_noc_hop_byte=0.4e-12,
    e_d2d_byte=6.0e-12, e_dram_byte=25e-12,
    a_mac=0.0, a_glb_kb=0.0, a_core_fixed=0.0, a_d2d_fixed=0.0,
    a_d2d_per_gbps=0.0, a_io_die_fixed=0.0, a_dram_phy_per_gbps=0.0,
    c_silicon_mm2=0.0, yield_unit=1.0, area_unit_mm2=1.0,
    c_dram_die=0.0, dram_die_bw=1.0, f_scale=1.0, yield_package=1.0,
    c_package_mono_mm2=0.0)


def mesh_as_arch(x_chips: int = 16, y_chips: int = 16, pods_x: int = 1,
                 ici_gbps: float = 50.0, dci_gbps: float = 6.25,
                 hbm_gbps: float = 819.0) -> ArchConfig:
    """An ArchConfig whose geometry mirrors a device mesh: devices as
    cores, pods as chiplets, in-pod links as NoC links, inter-pod links as
    D2D.  Signature, defaults and derived fields are the reference's."""
    return ArchConfig(
        x_cores=x_chips * pods_x, y_cores=y_chips, xcut=pods_x, ycut=1,
        noc_bw=ici_gbps, d2d_bw=dci_gbps, dram_bw=hbm_gbps * 2,
        glb_kb=16 * 1024 * 1024 // 1024,
        macs_per_core=98_500,
        freq_ghz=1.0, n_dram=2, tech=TECH_TPUPOD)


@dataclass
class StagePlan:
    layers: Tuple[str, ...]
    devices: Tuple[int, ...]          # flat Gemini core ids
    # per-layer Part factors: dict layer -> (ph, pw, pb, pk)
    parts: Dict[str, Tuple[int, int, int, int]] = field(default_factory=dict)
    # per-layer CG in correspondence order (row-major (h, w, b, k))
    cgs: Dict[str, Tuple[int, ...]] = field(default_factory=dict)

    def dominant_layer(self) -> str:
        """Layer with the largest core group: its ``Part`` is the stage's
        sharding skeleton."""
        return max(self.layers, key=lambda n: (len(self.cgs.get(n, ())), n))


@dataclass
class MeshPlan:
    stages: List[StagePlan]
    batch_unit: int
    cost_delay_s: float = 0.0
    cost_energy_j: float = 0.0

    def stage_of(self, layer: str) -> int:
        for i, st in enumerate(self.stages):
            if layer in st.layers:
                return i
        raise KeyError(layer)

    @property
    def n_devices_needed(self) -> int:
        """1 + highest core id any stage references."""
        return 1 + max((max(st.devices) for st in self.stages
                        if st.devices), default=-1)


def lms_to_plan(mapping: Mapping, delay_s: float = 0.0,
                energy_j: float = 0.0) -> MeshPlan:
    """Collapse an LMS mapping into contiguous stages, one per layer group."""
    stages: List[StagePlan] = []
    bu = 1
    for group, lms in mapping:
        devs: List[int] = []
        parts: Dict[str, Tuple[int, int, int, int]] = {}
        cgs: Dict[str, Tuple[int, ...]] = {}
        for name in group.names:
            ms = lms.ms[name]
            devs.extend(ms.cg)
            parts[name] = ms.part
            cgs[name] = ms.cg
        stages.append(StagePlan(layers=tuple(group.names),
                                devices=tuple(sorted(set(devs))),
                                parts=parts, cgs=cgs))
        bu = group.batch_unit
    return MeshPlan(stages=stages, batch_unit=bu, cost_delay_s=delay_s,
                    cost_energy_j=energy_j)


def plan_for_graph(g: Graph, arch: ArchConfig, total_batch: int,
                   sa_iters: int = 2000, seed: int = 0) -> MeshPlan:
    """Full Gemini flow on an arbitrary layer graph -> MeshPlan."""
    groups = partition_graph(g, arch, total_batch)
    res = sa_optimize(g, arch, groups, total_batch,
                      SAConfig(iters=sa_iters, seed=seed))
    return lms_to_plan(res.mapping, res.delay_s, res.energy_j)


def plan_from_tuples(layers: Sequence[tuple], stages: Sequence[tuple],
                     batch_unit: int, name: str = "hand",
                     classes: Optional[tuple] = None
                     ) -> Tuple[Graph, MeshPlan]:
    """A layer graph and a plan built by hand from plain tuples (JSON's
    lists will do): ``layers`` as ``(name, kind, H, W, C, K, preds)`` and
    ``stages`` as ``(layer names, Part, core ids)``, every layer of a stage
    on the stage's Part and cores.  ``classes``, ``(Graph, Layer,
    MeshPlan, StagePlan)``, builds them with another package's classes of
    the same fields; by default this package's."""
    G, L, MP, SP = classes or (Graph, Layer, MeshPlan, StagePlan)
    g = G(name)
    for lname, kind, H, W, C, K, preds in layers:
        g.add(L(name=lname, kind=kind, H=H, W=W, C=C, K=K),
              inputs=list(preds))
    return g, MP(stages=[
        SP(layers=tuple(names), devices=tuple(cores),
           parts={n: tuple(part) for n in names},
           cgs={n: tuple(cores) for n in names})
        for names, part, cores in stages], batch_unit=batch_unit)
