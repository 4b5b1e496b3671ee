"""Bridge: Gemini LMS mappings -> stage plans.

Reduced copy of ``src/repro/core/bridge.py`` (``StagePlan``, ``MeshPlan``,
``lms_to_plan``).  Each layer group becomes one pipeline stage whose core
set is the union of its layers' CGs; the per-layer ``Part`` and ordered
``CG`` ride along for the stage's logical sharding.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .encoding import Mapping


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
