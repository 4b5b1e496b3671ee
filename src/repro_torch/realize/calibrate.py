"""Measured-cost calibration (realization stage 4).

Port of ``src/repro/realize/calibrate.py``, whole.  Fits per-``Tech``
correction factors from the measured-vs-predicted ratios of one or more
realization reports and emits a **Tech overlay**: a scaling of the
technology's traffic energy constants (D2D bytes, NoC hop bytes, DRAM
bytes) that a second DSE pass consumes by searching over overlay-applied
candidates.

Invariants (tested):

* an **identity overlay changes nothing** — ``apply`` returns the original
  ``Tech`` object untouched (same name, same checkpoint fingerprints), so
  calibration off is bit-identical by construction;
* a non-identity overlay's name is content-addressed and it registers its
  derived ``Tech`` with ``explore.register_tech``, so calibrated sweeps
  stay resumable;
* factors are fitted in log space (geometric mean over stages and
  candidates) and clamped to ``[f_min, f_max]``; an axis with no evidence
  stays at 1.0.

On one card the port measures no collective bytes, so its fits keep
``f_noc`` at 1.0, and its ``f_dram`` is on the port's own byte scale
(:mod:`.measure`); the port's ``launch/realize.py`` marks such an overlay
with a ``repro_torch:`` source naming the device.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Sequence, Union

import numpy as np

from ..core.explore import register_tech
from ..core.hw import ArchConfig, Tech
from .measure import RealizationReport

# ratio key (measure.StageReport.ratios) -> Tech energy field it calibrates
_FACTOR_FIELDS = {
    "d2d_bytes": "e_d2d_byte",
    "noc_bytes": "e_noc_hop_byte",
    "dram_bytes": "e_dram_byte",
}


@dataclass(frozen=True)
class TechOverlay:
    """Multiplicative corrections to a Tech's traffic energy constants."""
    f_d2d: float = 1.0                 # scales e_d2d_byte
    f_noc: float = 1.0                 # scales e_noc_hop_byte
    f_dram: float = 1.0                # scales e_dram_byte
    source: str = ""                   # provenance (ckpt/mesh description)
    n_stages: int = 0                  # evidence size behind the fit

    _FIELDS = ("f_d2d", "f_noc", "f_dram")

    def is_identity(self) -> bool:
        return all(getattr(self, f) == 1.0 for f in self._FIELDS)

    def tag(self) -> str:
        """Content hash of the factors — two different overlays must
        never produce same-named Techs (checkpoints identify techs by
        name only, so a name collision would let a sweep calibrated
        under overlay A silently resume with overlay B's constants)."""
        import hashlib
        h = hashlib.sha1(repr(tuple(getattr(self, f)
                                    for f in self._FIELDS)).encode())
        return h.hexdigest()[:8]

    def apply(self, tech: Tech) -> Tech:
        """Overlay-corrected Tech.

        Identity overlays return ``tech`` itself — same object, same name
        — so "calibration off" cannot perturb anything downstream (keys,
        fingerprints, float values)."""
        if self.is_identity():
            return tech
        new = dataclasses.replace(
            tech,
            name=f"{tech.name}+cal{self.tag()}",
            e_d2d_byte=tech.e_d2d_byte * self.f_d2d,
            e_noc_hop_byte=tech.e_noc_hop_byte * self.f_noc,
            e_dram_byte=tech.e_dram_byte * self.f_dram)
        register_tech(new)             # calibrated sweeps stay resumable
        return new

    def apply_arch(self, arch: ArchConfig) -> ArchConfig:
        t = self.apply(arch.tech)
        return arch if t is arch.tech else arch.replace(tech=t)

    def to_dict(self) -> Dict[str, Any]:
        return {f: getattr(self, f) for f in
                (*self._FIELDS, "source", "n_stages")}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TechOverlay":
        return cls(**{k: d[k] for k in
                      (*cls._FIELDS, "source", "n_stages") if k in d})


def _stage_ratio_dicts(rep: Union[RealizationReport, Dict[str, Any]]
                       ) -> List[Dict[str, float]]:
    """Per-stage ratio dicts from a live report OR a realize.jsonl record
    (resumed sweeps feed the fit from disk without re-measuring)."""
    if isinstance(rep, dict):
        return [dict(st.get("ratios", {})) for st in rep.get("stages", [])]
    return [st.ratios() for st in rep.stages]


def fit_overlay(reports: Sequence[Union[RealizationReport, Dict[str, Any]]],
                source: str = "",
                f_min: float = 0.1, f_max: float = 10.0) -> TechOverlay:
    """Fit the overlay from realization reports (log-space geomean).

    Only stages where both sides of a ratio are positive contribute (a
    monolithic candidate has no D2D edges to calibrate, a stage without
    collectives no NoC ratio).  An axis with no evidence stays at 1.0."""
    logs: Dict[str, List[float]] = {k: [] for k in _FACTOR_FIELDS}
    n_stages = 0
    for rep in reports:
        for ratios in _stage_ratio_dicts(rep):
            n_stages += 1
            for k, v in ratios.items():
                if k in logs and v > 0:
                    logs[k].append(math.log(v))
    factors = {}
    for k, vals in logs.items():
        f = math.exp(float(np.mean(vals))) if vals else 1.0
        factors[k] = min(f_max, max(f_min, f))
    return TechOverlay(f_d2d=factors["d2d_bytes"],
                       f_noc=factors["noc_bytes"],
                       f_dram=factors["dram_bytes"],
                       source=source, n_stages=n_stages)


def calibrated_candidates(cands: Sequence[ArchConfig],
                          overlay: TechOverlay) -> List[ArchConfig]:
    """Candidate grid under the overlay (what the second DSE pass sweeps).

    With an identity overlay this returns the input architectures
    *unchanged* (same objects), so ``run_dse(calibrated_candidates(c, id),
    ...)`` is bit-identical to ``run_dse(c, ...)``."""
    return [overlay.apply_arch(a) for a in cands]


def save_overlay(overlay: TechOverlay, path: Union[str, Path]) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(overlay.to_dict(), indent=1) + "\n")
    return p


def load_overlay(path: Union[str, Path]) -> TechOverlay:
    return TechOverlay.from_dict(json.loads(Path(path).read_text()))
