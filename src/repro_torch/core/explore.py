"""Checkpoint I/O of the DSE sweep: arch and mapping records, graph
fingerprints and the resumable JSON-lines sweep file.

Reduced copy of ``src/repro/core/explore.py``: ``_TECHS``/``_ARCH_FIELDS``,
``register_tech`` (``:235``), ``arch_from_dict``, ``graph_fingerprint``,
``mapping_from_jsonable`` and a
``ResumableSweep`` limited to the config header, ``read``, ``add`` and
``as_dict``.  Legacy-schema migration, heartbeats and shard merging stay in
the reference.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

from .encoding import LMS, MS, Mapping
from .hw import TECH_12NM, ArchConfig
from .workload import Graph, LayerGroup

_TECHS = {TECH_12NM.name: TECH_12NM}

_ARCH_FIELDS = ("x_cores", "y_cores", "xcut", "ycut", "noc_bw", "d2d_bw",
                "dram_bw", "glb_kb", "macs_per_core", "freq_ghz", "n_dram")


def register_tech(tech) -> None:
    """Make a non-default :class:`Tech` (a calibrated one, say) resolvable
    from checkpoint records, which name their tech only; an unknown name
    is refused rather than silently given the wrong constants."""
    _TECHS[tech.name] = tech


def arch_from_dict(d: Dict[str, Any]) -> ArchConfig:
    kw = {f: d[f] for f in _ARCH_FIELDS}
    tech_name = d.get("tech", "")
    tech = _TECHS.get(tech_name)
    if tech is None:
        raise ValueError(
            f"unknown tech {tech_name!r} in checkpoint record; the port "
            f"knows {sorted(_TECHS)} (register_tech() adds one)")
    return ArchConfig(**kw, tech=tech)


def graph_fingerprint(g: Graph) -> str:
    """Stable content digest of a workload DAG (layers, edges, inputs),
    byte-compatible with the reference's, so a port-built graph can be
    checked against a checkpoint header the JAX package wrote."""
    h = hashlib.sha1()
    for name in sorted(g.layers):
        lyr = g.layers[name]
        h.update(repr((name, lyr)).encode())
        if lyr.traffic_scale != 1.0 or lyr.weight_traffic_scale != 1.0:
            h.update(repr((name, "scale", lyr.traffic_scale,
                           lyr.weight_traffic_scale)).encode())
    h.update(repr(sorted(g.edges)).encode())
    if g.edge_mults:
        h.update(repr(("mults", sorted(g.edge_mults.items()))).encode())
    h.update(repr(sorted(g.input_layers)).encode())
    return h.hexdigest()[:12]


def mapping_from_jsonable(data: Sequence[Dict[str, Any]]) -> Mapping:
    """Rebuild a mapping from its checkpoint form.  ``MS.__post_init__``
    re-validates the structural invariants, so a damaged record raises."""
    mapping: Mapping = []
    for entry in data:
        grp = LayerGroup(names=tuple(entry["group"]["names"]),
                         batch_unit=int(entry["group"]["batch_unit"]))
        ms = {name: MS(part=tuple(int(v) for v in m["part"]),
                       cg=tuple(int(v) for v in m["cg"]),
                       fd=tuple(int(v) for v in m["fd"]))
              for name, m in entry["lms"].items()}
        mapping.append((grp, LMS(ms=ms)))
    return mapping


class ResumableSweep:
    """Append-only JSON-lines checkpoint.

    One ``{"_key": ..., **record}`` object per line after an optional
    ``{"_config": fingerprint}`` header.  Opening a file whose header differs
    from ``config_fingerprint``, or that holds a corrupt line before the
    last, moves it aside to a fresh ``.bakN`` name and starts anew; a
    truncated final line (a process killed mid-write) is dropped.  Duplicate
    keys are last-wins.
    """

    def __init__(self, path: Union[str, Path],
                 config_fingerprint: Optional[str] = None):
        self.path = Path(path)
        self.fingerprint = config_fingerprint
        self._records: Dict[str, Dict[str, Any]] = {}
        if self.path.exists() and self._load(readonly=False):
            return
        if self.path.exists():
            self._set_aside()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        header = (json.dumps({"_config": self.fingerprint}) + "\n"
                  if self.fingerprint is not None else "")
        self.path.write_text(header)

    def _set_aside(self) -> None:
        n = 0
        while True:
            bak = self.path.with_name(
                self.path.name + (".bak" if n == 0 else f".bak{n}"))
            if not bak.exists():
                break
            n += 1
        self.path.replace(bak)

    @classmethod
    def read(cls, path: Union[str, Path]) -> "ResumableSweep":
        """Read-only parse: never creates, repairs or resets the file."""
        inst = cls.__new__(cls)
        inst.path = Path(path)
        inst.fingerprint = None
        inst._records = {}
        if inst.path.exists():
            inst._load(readonly=True)
        return inst

    def _load(self, readonly: bool) -> bool:
        """Parse the existing file; False if it must be discarded."""
        text = self.path.read_text()
        lines = text.splitlines()
        valid = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1 or readonly:
                    continue          # truncated final line / salvage mode
                self._records.clear()
                return False
            if "_config" in rec:
                if self.fingerprint is not None \
                        and rec["_config"] != self.fingerprint:
                    self._records.clear()
                    return False
                valid.append(line)
                continue
            valid.append(line)
            key = rec.pop("_key", None)
            if key is not None:
                self._records[key] = rec
        repaired = "".join(v + "\n" for v in valid)
        if not readonly and repaired != text:
            # a trailing fragment would merge with the next append
            tmp = self.path.with_name(self.path.name + ".tmp")
            tmp.write_text(repaired)
            tmp.replace(self.path)
        return True

    def __contains__(self, key: str) -> bool:
        return key in self._records

    def __len__(self) -> int:
        return len(self._records)

    def add(self, key: str, record: Dict[str, Any]) -> None:
        self._records[key] = record
        with self.path.open("a") as f:
            f.write(json.dumps({"_key": key, **record}, default=float) + "\n")
            f.flush()

    def as_dict(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._records)
