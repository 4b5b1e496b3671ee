"""Layer-centric LP spatial-mapping encoding (paper Sec. IV).

Reduced copy of ``src/repro/core/encoding.py``: ``MS`` and ``LMS`` (with
``cores_used`` and ``validate``), plus the ``Mapping`` alias of
``src/repro/core/sa.py``.

An ``LMS`` (LP spatial Mapping Scheme) of a layer group holds one ``MS`` per
layer: ``MS = (Part, CG, FD)``.

* ``Part = (ph, pw, pb, pk)`` — partition counts of the ofmap cube along
  H, W, B(atch-unit) and K.  Product == len(CG).
* ``CG`` — *ordered* tuple of core ids.  CGs of different layers in one
  group are disjoint.
* ``FD = (IF, WGT, OF)`` — DRAM endpoints; -1 implicit/absent, 0
  interleaved, d>0 a concrete DRAM port.

The Correspondence Rule maps the partitioned workload with 4-D id
``(h, w, b, k)`` to core ``CG[((h*pw + w)*pb + b)*pk + k]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from .workload import Graph, LayerGroup

Part = Tuple[int, int, int, int]          # (ph, pw, pb, pk)
FD = Tuple[int, int, int]                 # (IF, WGT, OF)


@dataclass(frozen=True)
class MS:
    """Mapping Scheme of one layer."""
    part: Part
    cg: Tuple[int, ...]
    fd: FD

    def __post_init__(self):
        ph, pw, pb, pk = self.part
        if ph * pw * pb * pk != len(self.cg):
            raise ValueError(
                f"Part {self.part} product {ph*pw*pb*pk} != |CG| {len(self.cg)}")
        if len(set(self.cg)) != len(self.cg):
            raise ValueError("CG has duplicate cores")
        if min(self.part) < 1:
            raise ValueError(f"Part must be >=1, got {self.part}")


@dataclass(frozen=True)
class LMS:
    """LP Spatial Mapping Scheme of one layer group."""
    ms: Dict[str, MS]

    def cores_used(self) -> Tuple[int, ...]:
        out: List[int] = []
        for m in self.ms.values():
            out.extend(m.cg)
        return tuple(out)

    def validate(self, group: LayerGroup, g: Graph, n_cores: int,
                 n_dram: int) -> None:
        if set(self.ms) != set(group.names):
            raise ValueError("LMS layers != layer-group layers")
        seen: set = set()
        for name in group.names:
            m = self.ms[name]
            lyr = g.layers[name]
            ph, pw, pb, pk = m.part
            if ph > lyr.H or pw > lyr.W or pb > group.batch_unit or pk > lyr.K:
                raise ValueError(
                    f"{name}: Part {m.part} exceeds dims "
                    f"(H={lyr.H},W={lyr.W},B={group.batch_unit},K={lyr.K})")
            for c in m.cg:
                if not (0 <= c < n_cores):
                    raise ValueError(f"{name}: core {c} out of range")
                if c in seen:
                    raise ValueError(f"{name}: core {c} used by two layers")
                seen.add(c)
            for v in m.fd:
                if not (-1 <= v <= n_dram):
                    raise ValueError(f"{name}: FD value {v} out of range")
            # FD structural rules (paper Sec. IV-A)
            if lyr.has_weight and m.fd[1] < 0:
                raise ValueError(f"{name}: weighted layer needs WGT >= 0")
            if not lyr.has_weight and m.fd[1] >= 0:
                raise ValueError(f"{name}: weightless layer must have WGT=-1")


# a full LP-SPM mapping: one (layer group, LMS) per pipeline stage
Mapping = List[Tuple[LayerGroup, LMS]]
