"""Checkpoint -> validated :class:`MeshPlan` lowering (realization stage 1).

Port of ``src/repro/realize/plan.py``.  A schema-v2 checkpoint written with
``DSEConfig(keep_mappings=True)`` carries one record per (candidate,
workload) task whose ``mapping`` field is the full serialized LP-SPM
mapping.  This module parses those records back into
:class:`RealizeCandidate` objects (re-validating the LMS invariants against
the workload graph), checks that each supplied graph content-matches the
checkpoint header's fingerprint, and lowers each mapping into a plan.

A plan is validated against a pool of devices.  In the logical mode (one
card) its Gemini core ids are *logical* devices: the pool is the
checkpointed architecture's core count, and the stage program uses the
core ids only to bill inter-stage (DCI) traffic.  In mesh mode the pool is
the ranks of ``torch.distributed`` that ``launch/realize.py --mesh`` gives
it, and core ``c`` runs on the pool's rank ``c``.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core.bridge import MeshPlan, lms_to_plan
from ..core.encoding import Mapping
from ..core.explore import (ResumableSweep, arch_from_dict, graph_fingerprint,
                            mapping_from_jsonable)
from ..core.hw import ArchConfig
from ..core.workload import Graph
from ..core.workloads import make_workload


@dataclass
class RealizeCandidate:
    """One checkpointed (candidate, workload) task selected for realization."""
    key: str                      # schema-v2 checkpoint key (resume identity)
    workload: str                 # workload dict key in the sweep
    arch: ArchConfig
    mapping: Mapping
    graph: Graph
    energy_j: float               # analytical prediction from the sweep
    delay_s: float
    seed: Optional[int] = None

    @property
    def edp(self) -> float:
        return self.energy_j * self.delay_s

    def lower(self) -> MeshPlan:
        """Lower the LMS mapping into a MeshPlan (bridge collapse)."""
        return lms_to_plan(self.mapping, delay_s=self.delay_s,
                           energy_j=self.energy_j)


def graph_from_spec(spec: str) -> Graph:
    """Build a workload graph from a preset name or CLI spec."""
    return make_workload(spec)


_WL_FP = re.compile(r"(?:^|,)([^,:]+):([0-9a-f]{12})")


def checkpoint_workload_fingerprints(path: Union[str, Path]
                                     ) -> Dict[str, str]:
    """``{workload name: graph fingerprint}`` from a checkpoint's header;
    empty when the file has no parseable ``_config`` header."""
    p = Path(path)
    if not p.exists():
        return {}
    with p.open() as f:
        for line in f:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                return {}
            if "_config" not in rec:
                return {}
            _, _, wl = rec["_config"].partition(":wl=")
            return dict(_WL_FP.findall(wl))
    return {}


def load_realize_candidates(ckpt: Union[str, Path],
                            workloads: Dict[str, Graph],
                            top: int = 0,
                            verbose: bool = True,
                            sweep: Optional[ResumableSweep] = None
                            ) -> List[RealizeCandidate]:
    """Parse a schema-v2 checkpoint into realization candidates, best
    analytical EDP first; ``top > 0`` truncates before the mappings are
    deserialized."""
    if sweep is None:
        sweep = ResumableSweep.read(ckpt)
    fps = checkpoint_workload_fingerprints(ckpt)
    for wl, g in workloads.items():
        if wl in fps and graph_fingerprint(g) != fps[wl]:
            raise ValueError(
                f"workload {wl!r}: supplied graph (fingerprint "
                f"{graph_fingerprint(g)}) does not content-match the "
                f"checkpoint's ({fps[wl]}); realizing a mapping against a "
                f"different graph would measure the wrong program")
    usable: List[Tuple[float, str, Dict]] = []
    n_nomap = n_badwl = 0
    for key, rec in sweep.as_dict().items():
        if "mapping" not in rec:
            n_nomap += 1
            continue
        if rec.get("workload") not in workloads:
            n_badwl += 1
            continue
        usable.append((float(rec["energy_j"]) * float(rec["delay_s"]),
                       key, rec))
    if verbose and (n_nomap or n_badwl):
        print(f"[realize] skipped {n_nomap} metrics-only records "
              f"(keep_mappings was off) and {n_badwl} records with no "
              f"supplied workload graph")
    if not usable:
        raise ValueError(
            f"{ckpt}: no realizable records (need a keep_mappings=True "
            f"sweep checkpoint and matching --workload graphs)")
    usable.sort(key=lambda t: (t[0], t[1]))
    if top > 0:
        usable = usable[:top]
    out: List[RealizeCandidate] = []
    for _edp, key, rec in usable:
        wl = rec["workload"]
        g = workloads[wl]
        arch = arch_from_dict(rec["arch"])
        mapping = mapping_from_jsonable(rec["mapping"])
        for grp, lms in mapping:
            lms.validate(grp, g, arch.n_cores, arch.n_dram)
        out.append(RealizeCandidate(
            key=key, workload=wl, arch=arch, mapping=mapping, graph=g,
            energy_j=float(rec["energy_j"]), delay_s=float(rec["delay_s"]),
            seed=rec.get("seed")))
    return out


def validate_plan(plan: MeshPlan, n_devices: int,
                  arch: Optional[ArchConfig] = None) -> None:
    """Refuse plans the pool of ``n_devices`` cannot host (naming how to
    get ranks), plans that reference cores the architecture does not have,
    and stages whose Part product differs from their core-group size."""
    need = plan.n_devices_needed
    if arch is not None and need > arch.n_cores:
        raise ValueError(
            f"plan references core {need - 1} but the checkpointed arch "
            f"has only {arch.n_cores} cores — corrupt mapping record")
    if need > n_devices:
        from ..launch.mesh import RANKS_FIX
        raise ValueError(
            f"plan needs {need} devices, mesh/pool has {n_devices}; start "
            f">= {need} local ranks (--host-ranks), or {RANKS_FIX}")
    for i, st in enumerate(plan.stages):
        for name in st.layers:
            part = st.parts[name]
            cg = st.cgs[name]
            p = part[0] * part[1] * part[2] * part[3]
            if p != len(cg):
                raise ValueError(
                    f"stage {i} layer {name}: Part {part} product {p} != "
                    f"|CG| {len(cg)}")


def plans_for(cands: Sequence[RealizeCandidate],
              n_devices: Optional[int] = None
              ) -> List[Tuple[RealizeCandidate, MeshPlan]]:
    """Lower every candidate and validate it against a pool of
    ``n_devices`` ranks, or, without one, against its own architecture's
    logical pool (``arch.n_cores``)."""
    out = []
    for c in cands:
        plan = c.lower()
        validate_plan(plan, c.arch.n_cores if n_devices is None
                      else n_devices, c.arch)
        out.append((c, plan))
    return out


def hand_plans(ranks: int = 4, seq: int = 32) -> Dict[str, tuple]:
    """Hand-built plans that split what the realization's mesh mode must
    split, as :func:`..core.bridge.plan_from_tuples` arguments, for a pool
    of ``ranks`` (2 or 4):

    * ``ssd``: an fc layer split on k over ranks 0 and 1, then a ``*_ssd``
      layer of two heads of 128 on every rank in reverse order, split on
      heads (and on batch with four ranks);
    * ``flash``: q, k and v split on k over every rank, then a (qk, av)
      attention pair of ``seq`` query rows split on rows (and on heads
      with four ranks), the ranks rotated;
    * ``ici``: an fc layer split on k over ranks 0 and 1, then a matmul
      on the same two ranks split on batch, which reads it whole.
    """
    half = ranks // 2
    rot = tuple(range(half, ranks)) + tuple(range(half))
    return {
        "ssd": ([("l0", "fc", 64, 1, 32, 64, ()),
                 ("l0_ssd", "matmul", 64, 1, 64, 256, ("l0",))],
                [(("l0",), (1, 1, 1, 2), (0, 1)),
                 (("l0_ssd",), (1, 1, half, 2),
                  tuple(reversed(range(ranks))))], 2),
        "flash": ([("x", "fc", seq, 1, 32, 256, ()),
                   ("q", "fc", seq, 1, 256, 256, ("x",)),
                   ("k", "fc", seq, 1, 256, 256, ("x",)),
                   ("v", "fc", seq, 1, 256, 256, ("x",)),
                   ("qk", "matmul", seq, 1, 256, seq, ("q", "k")),
                   ("av", "matmul", seq, 1, seq, 256, ("qk", "v")),
                   ("o", "fc", seq, 1, 256, 64, ("av",))],
                  [(("x",), (1, 1, 2, 1), (1, 0)),
                   (("q", "k", "v"), (1, 1, 1, ranks), tuple(range(ranks))),
                   (("qk", "av", "o"), (2, 1, 1, half), rot)], 2),
        "ici": ([("a", "fc", 16, 1, 32, 64, ()),
                 ("b", "matmul", 16, 1, 64, 16, ("a",))],
                [(("a",), (1, 1, 1, 2), (0, 1)),
                 (("b",), (1, 1, 2, 1), (0, 1))], 2),
    }
