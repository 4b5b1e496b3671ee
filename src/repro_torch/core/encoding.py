"""Layer-centric LP spatial-mapping encoding (paper Sec. IV).

Reduced copy of ``src/repro/core/encoding.py``: ``split_points`` (``:34``),
``MS`` (with its cached hash and ``geo``) and ``LMS`` (with ``cores_used``,
``cache_key`` and ``validate``), ``Region`` (``:283``),
``parse_regions_arrays`` (``:310``), ``parse_regions`` (``:335``) and
``ifmap_region`` (``:343``), plus the ``Mapping`` alias of
``src/repro/core/sa.py``.  The batched LMS packing and the random
generators stay in the reference until the search slice.

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
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from .workload import Graph, Layer, LayerGroup

Part = Tuple[int, int, int, int]          # (ph, pw, pb, pk)
FD = Tuple[int, int, int]                 # (IF, WGT, OF)


def split_points(dim: int, parts: int) -> np.ndarray:
    """Boundaries of an approximately-equal split (np.array_split semantics).

    Returns ``parts+1`` offsets; part i covers [off[i], off[i+1]).
    """
    if parts > dim:
        raise ValueError(f"cannot split dim {dim} into {parts} parts")
    base, extra = divmod(dim, parts)
    sizes = [base + (1 if i < extra else 0) for i in range(parts)]
    return np.concatenate([[0], np.cumsum(sizes)])


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
        # MS keys the analyzer's memo tables: hash once.  ``geo`` is
        # everything but the DRAM endpoints; region tables, NoC dependency
        # traffic and intra-core dataflows are pure functions of it.
        object.__setattr__(self, "_hash",
                           hash((self.part, self.cg, self.fd)))
        object.__setattr__(self, "geo", (self.part, self.cg))

    def __hash__(self) -> int:
        return self._hash


@dataclass(frozen=True)
class LMS:
    """LP Spatial Mapping Scheme of one layer group."""
    ms: Dict[str, MS]

    def cores_used(self) -> Tuple[int, ...]:
        out: List[int] = []
        for m in self.ms.values():
            out.extend(m.cg)
        return tuple(out)

    def cache_key(self) -> Tuple:
        """Stable hashable identity (the ``ms`` dict itself is unhashable),
        sorted by layer name; memoized, since an LMS is frozen."""
        try:
            return self._cache_key
        except AttributeError:
            key = tuple(sorted((n, m.part, m.cg, m.fd)
                               for n, m in self.ms.items()))
            object.__setattr__(self, "_cache_key", key)
            return key

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


# ---------------------------------------------------------------------------
# Region computation (parsing an MS into per-core ofmap regions)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Region:
    """Half-open ranges into the (H, W, B, K) ofmap cube of one layer part."""
    h0: int; h1: int
    w0: int; w1: int
    b0: int; b1: int
    k0: int; k1: int

    @property
    def elems(self) -> int:
        return ((self.h1 - self.h0) * (self.w1 - self.w0)
                * (self.b1 - self.b0) * (self.k1 - self.k0))


@lru_cache(maxsize=65536)
def _split_cached(dim: int, parts: int) -> np.ndarray:
    return split_points(dim, parts)


def parse_regions_arrays(m: MS, layer: Layer,
                         batch_unit: int) -> Tuple[np.ndarray, np.ndarray]:
    """Correspondence Rule, vectorized: (cores (N,), regions (N,8)).

    Rows are [h0,h1,w0,w1,b0,b1,k0,k1] in *correspondence order* — the
    (h, w, b, k) C-order nesting of the Rule, under which row i belongs to
    core ``CG[i]`` — NOT sorted by core id."""
    ph, pw, pb, pk = m.part
    hs = _split_cached(layer.H, ph)
    ws = _split_cached(layer.W, pw)
    bs = _split_cached(batch_unit, pb)
    ks = _split_cached(layer.K, pk)
    ih, iw, ib, ik = np.indices((ph, pw, pb, pk)).reshape(4, -1)
    rarr = np.empty((len(ih), 8), dtype=np.int64)
    rarr[:, 0] = hs[ih]
    rarr[:, 1] = hs[ih + 1]
    rarr[:, 2] = ws[iw]
    rarr[:, 3] = ws[iw + 1]
    rarr[:, 4] = bs[ib]
    rarr[:, 5] = bs[ib + 1]
    rarr[:, 6] = ks[ik]
    rarr[:, 7] = ks[ik + 1]
    return np.asarray(m.cg, dtype=np.int64), rarr


def parse_regions(m: MS, layer: Layer, batch_unit: int) -> Dict[int, Region]:
    """Correspondence Rule: core id -> its ofmap Region (insertion order =
    correspondence order, which downstream accumulation relies on)."""
    cores, rarr = parse_regions_arrays(m, layer, batch_unit)
    return {c: Region(*row)
            for c, row in zip(cores.tolist(), rarr.tolist())}


def ifmap_region(layer: Layer, r: Region, in_K: int) -> Region:
    """Ifmap region a consumer part needs, in the *producer's ofmap* cube.

    conv/fc/matmul contract over all input channels: the K-range widens to
    the full producer K.  Spatial dims map through stride with an RxS halo.
    eltwise/pool/depthwise are channel-wise 1:1.
    """
    if layer.kind in ("eltwise",):
        return r
    if layer.kind in ("pool", "depthwise"):
        s = layer.stride
        return Region(r.h0 * s, min(r.h1 * s + layer.R - 1, layer.H * s),
                      r.w0 * s, min(r.w1 * s + layer.S - 1, layer.W * s),
                      r.b0, r.b1, r.k0, r.k1)
    # conv / fc / matmul: full channel contraction
    s = layer.stride
    h_in = layer.H * s
    w_in = layer.W * s
    return Region(min(r.h0 * s, h_in - 1), min(r.h1 * s + layer.R - 1, h_in),
                  min(r.w0 * s, w_in - 1), min(r.w1 * s + layer.S - 1, w_in),
                  r.b0, r.b1, 0, in_K)
