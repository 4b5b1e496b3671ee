"""Layer-centric LP spatial-mapping encoding (paper Sec. IV).

Reduced copy of ``src/repro/core/encoding.py``: ``split_points`` (``:34``),
``MS`` (with its cached hash, ``geo``, ``part_index`` and ``core_of``) and
``LMS`` (with ``cores_used``, ``cache_key`` and ``validate``), ``Region`` (with
``overlap``, ``:283``), ``parse_regions_arrays`` (``:310``), ``parse_regions``
(``:335``) and ``ifmap_region`` (``:343``), the search's generators
``_divisors_upto``, ``factor_parts``, ``default_fd`` and ``random_lms``
(``:371-466``), the space-size bounds (``:470-495``), the batched engine's
packed LMS batches (``LMSBatch``, ``RoutingTables``, ``pack_lms_batch``,
``unpack_lms_batch``, ``:145-280``), plus the ``Mapping`` alias of
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
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

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

    @property
    def nc(self) -> int:
        return len(self.cg)

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

    def part_index(self, h: int, w: int, b: int, k: int) -> int:
        ph, pw, pb, pk = self.part
        return ((h * pw + w) * pb + b) * pk + k

    def core_of(self, h: int, w: int, b: int, k: int) -> int:
        return self.cg[self.part_index(h, w, b, k)]


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
# Packed structure-of-arrays LMS batches (batched evaluation engine)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LMSBatch:
    """B mappings of ONE layer group, packed as padded int arrays.

    Structure-of-arrays transport format of the batched evaluation engine:
    every per-layer field of every mapping lives in one int64 array with a
    leading batch axis, so a whole batch ships as five ndarrays instead of
    B dicts of frozen dataclasses.  Layer order is fixed (``names``); CG
    rows are right-padded with -1 to the batch-wide maximum (mappings of
    one group may give a layer different core counts — "ragged" batches).

    ``pack_lms_batch`` / ``unpack_lms_batch`` round-trip exactly;
    unpacking rebuilds real ``MS`` values, so ``MS.__post_init__``
    re-validates every row (Part product == |CG|, no duplicate cores) —
    a corrupted batch raises instead of analyzing garbage.
    """
    names: Tuple[str, ...]        # layer order of the rows below
    part: np.ndarray              # (B, L, 4) int64
    cg: np.ndarray                # (B, L, Cmax) int64, -1 padded
    cg_len: np.ndarray            # (B, L) int64 — valid prefix of each CG row
    fd: np.ndarray                # (B, L, 3) int64

    @property
    def batch_size(self) -> int:
        return int(self.part.shape[0])

    @property
    def n_layers(self) -> int:
        return len(self.names)

    def routing_tables(self) -> "RoutingTables":
        """Padded per-layer routing tables of this batch (memoized).

        Rectangularizes the ragged CG geometry so batched construction can
        gather core bindings without per-row Python: every table is a dense
        int/bool array over ``(B, L, Cmax)`` whose pad cells are routed to a
        *safe* real value (slot 0 / the row's last real core) and flagged
        off in ``slot_mask`` — the same trick the analyzer's packed
        multicast bitsets use (inactive members redirect to the empty
        ``(p, p)`` diagonal).  Consumers mask or slice by ``cg_len``;
        gathering through a pad cell is always in-bounds and never
        contributes.
        """
        try:
            return self._routes                      # type: ignore[attr-defined]
        except AttributeError:
            pass
        cg, cg_len = self.cg, self.cg_len
        B, L, cmax = cg.shape
        slot_mask = cg >= 0                          # (B, L, Cmax)
        cg_safe = np.where(slot_mask, cg, 0)
        # stable argsort over (real cores ascending, pads last): CG rows
        # hold distinct core ids, so this equals the analyzer's
        # np.argsort(cores) permutation on the valid prefix
        key = np.where(slot_mask, cg, np.iinfo(np.int64).max)
        order = np.argsort(key, axis=2, kind="stable")
        cg_sorted = np.take_along_axis(cg, order, axis=2)
        # pad slots -> the row's LAST real core (every row has >= 1 core:
        # Part products are >= 1), so sorted-order gathers stay in-bounds
        last = np.take_along_axis(
            cg_sorted, np.maximum(cg_len - 1, 0)[..., None], axis=2)
        cg_sorted = np.where(np.take_along_axis(slot_mask, order, axis=2),
                             cg_sorted, last)
        rt = RoutingTables(slot_mask=slot_mask, cg_safe=cg_safe,
                           order=order, cg_sorted=cg_sorted)
        object.__setattr__(self, "_routes", rt)
        return rt


@dataclass(frozen=True)
class RoutingTables:
    """Rectangular core-binding tables of one :class:`LMSBatch`.

    All arrays are ``(B, L, Cmax)``; see :meth:`LMSBatch.routing_tables`
    for the padding contract.  ``order`` maps correspondence order to
    sorted-core order per (mapping, layer) row — pad slots sort last, real
    slots reproduce ``np.argsort`` of the valid CG prefix exactly (core
    ids within a row are distinct, so the permutation is unique).
    """
    slot_mask: np.ndarray         # bool — True where the CG slot is real
    cg_safe: np.ndarray           # int64 — CG with pads replaced by 0
    order: np.ndarray             # int64 — correspondence -> sorted perm
    cg_sorted: np.ndarray         # int64 — cores ascending, pads = last core


def pack_lms_batch(lms_list: Sequence[LMS],
                   names: Optional[Sequence[str]] = None) -> LMSBatch:
    """Pack B same-group mappings into one :class:`LMSBatch`.

    ``names`` fixes the layer axis order (defaults to the first mapping's
    insertion order).  Every mapping must cover exactly that layer set.
    """
    if not lms_list:
        raise ValueError("cannot pack an empty LMS batch")
    if names is None:
        names = tuple(lms_list[0].ms)
    else:
        names = tuple(names)
    B, L = len(lms_list), len(names)
    for lms in lms_list:
        if set(lms.ms) != set(names):
            raise ValueError(
                f"LMS layers {sorted(lms.ms)} != batch layers {sorted(names)}")
    cmax = max(m.nc for lms in lms_list for m in lms.ms.values())
    part = np.empty((B, L, 4), dtype=np.int64)
    cg = np.full((B, L, cmax), -1, dtype=np.int64)
    cg_len = np.empty((B, L), dtype=np.int64)
    fd = np.empty((B, L, 3), dtype=np.int64)
    for b, lms in enumerate(lms_list):
        for l, name in enumerate(names):
            m = lms.ms[name]
            part[b, l] = m.part
            cg[b, l, :m.nc] = m.cg
            cg_len[b, l] = m.nc
            fd[b, l] = m.fd
    return LMSBatch(names=names, part=part, cg=cg, cg_len=cg_len, fd=fd)


def unpack_lms_batch(batch: LMSBatch) -> List[LMS]:
    """Rebuild the B ``LMS`` values of a packed batch (exact inverse of
    :func:`pack_lms_batch`; ``MS.__post_init__`` re-validates each row)."""
    out: List[LMS] = []
    part, cg, cg_len, fd = batch.part, batch.cg, batch.cg_len, batch.fd
    for b in range(batch.batch_size):
        ms: Dict[str, MS] = {}
        for l, name in enumerate(batch.names):
            n = int(cg_len[b, l])
            ms[name] = MS(part=tuple(int(v) for v in part[b, l]),
                          cg=tuple(int(v) for v in cg[b, l, :n]),
                          fd=tuple(int(v) for v in fd[b, l]))
        out.append(LMS(ms=ms))
    return out


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

    def overlap(self, other: "Region") -> int:
        dh = min(self.h1, other.h1) - max(self.h0, other.h0)
        dw = min(self.w1, other.w1) - max(self.w0, other.w0)
        db = min(self.b1, other.b1) - max(self.b0, other.b0)
        dk = min(self.k1, other.k1) - max(self.k0, other.k0)
        if dh <= 0 or dw <= 0 or db <= 0 or dk <= 0:
            return 0
        return dh * dw * db * dk


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


# ---------------------------------------------------------------------------
# Generators: random LMS + valid Part enumeration
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8192)
def _divisors_upto(n: int, cap: int) -> Tuple[int, ...]:
    return tuple(d for d in range(1, min(n, cap) + 1) if n % d == 0)


def factor_parts(n: int, dims: Tuple[int, int, int, int],
                 rng: np.random.Generator) -> Part:
    """Random 4-way factorization of ``n`` respecting per-dim caps.  The
    draws (a permutation, then one index per axis) are the reference's, in
    its order: the SA trajectory of a seed depends on it."""
    for _ in range(64):
        rem = n
        out = []
        caps = list(dims)
        order = rng.permutation(4)
        ok = True
        for i, axis in enumerate(order):
            if i == 3:
                f = rem
            else:
                divs = _divisors_upto(rem, caps[axis])
                if not divs:
                    ok = False
                    break
                f = divs[int(rng.integers(len(divs)))]
            if f > caps[axis]:
                ok = False
                break
            out.append((axis, f))
            rem //= f
        if ok and rem == 1:
            part = [1, 1, 1, 1]
            for axis, f in out:
                part[axis] = f
            return tuple(part)  # type: ignore[return-value]
    # fall back: all on the largest dim that fits
    for axis in np.argsort(dims)[::-1]:
        if dims[axis] >= n:
            part = [1, 1, 1, 1]
            part[axis] = n
            return tuple(part)  # type: ignore[return-value]
    raise ValueError(f"cannot split {n} parts over dims {dims}")


def default_fd(layer: Layer, g: Graph, group: LayerGroup,
               n_dram: int, rng: Optional[np.random.Generator] = None) -> FD:
    """Structurally-valid FD: explicit endpoints where the paper requires."""
    in_group = set(group.names)
    preds = g.preds(layer.name)
    succs = g.succs(layer.name)
    pick = (lambda: int(rng.integers(0, n_dram + 1))) if rng is not None \
        else (lambda: 0)
    if_ = -1
    if not preds or not any(p in in_group for p in preds):
        if_ = pick()            # DNN input or fed from a previous group
    wgt = pick() if layer.has_weight else -1
    of = -1
    if not succs or not all(s in in_group for s in succs):
        of = pick()             # DNN output or consumed by a later group
    return (if_, wgt, of)


def random_lms(group: LayerGroup, g: Graph, n_cores: int, n_dram: int,
               rng: np.random.Generator) -> LMS:
    """Uniform-ish random point of the optimization space (for tests/SA)."""
    n = len(group.names)
    if n_cores < n:
        raise ValueError("fewer cores than layers")
    # random composition of cores over layers, each >= 1, total <= n_cores
    sizes = np.ones(n, dtype=int)
    budget = n_cores - n
    extra = rng.multinomial(budget, np.ones(n) / n) if budget \
        else np.zeros(n, int)
    sizes = sizes + extra
    perm = rng.permutation(n_cores)
    ms: Dict[str, MS] = {}
    off = 0
    for name, nc in zip(group.names, sizes):
        lyr = g.layers[name]
        dims = (lyr.H, lyr.W, group.batch_unit, lyr.K)
        # shrink nc until it factorizes over the dims
        nc = int(nc)
        while nc > 1:
            try:
                part = factor_parts(nc, dims, rng)
                break
            except ValueError:
                nc -= 1
        else:
            part = (1, 1, 1, 1)
        cg = tuple(int(c) for c in perm[off:off + nc])
        off += nc
        ms[name] = MS(part=part, cg=cg,
                      fd=default_fd(lyr, g, group, n_dram, rng))
    return LMS(ms=ms)


# ---------------------------------------------------------------------------
# Optimization-space size (paper Sec. IV-B)
# ---------------------------------------------------------------------------

def _binom(x: int, y: int) -> int:
    from math import comb
    if y < 0 or y > x:
        return 0
    return comb(x, y)


def space_size_lower_bound(n_layers: int, n_cores: int) -> int:
    """Paper's conservative lower bound:
    m! * sum_i C(N,i)*C(M-N-1,N-i-1)*4^(N-i)."""
    from math import factorial
    N, M = n_layers, n_cores
    total = 0
    for i in range(N):
        total += _binom(N, i) * _binom(M - N - 1, N - i - 1) * 4 ** (N - i)
    return factorial(M) * total


def tangram_space_upper_bound(n_layers: int, n_cores: int) -> int:
    """Tangram heuristic upper bound: N * part(M) (integer partitions)."""
    # partition function via Euler recurrence
    M = n_cores
    p = [1] + [0] * M
    for i in range(1, M + 1):
        for j in range(i, M + 1):
            p[j] += p[j - i]
    return n_layers * p[M]
