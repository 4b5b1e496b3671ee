"""LP-SPM Analyzer: parse an LMS into core workloads + link/DRAM traffic.

Reduced copy of the scalar engine of ``src/repro/core/analyzer.py`` (the
paper's "LP SPM Analyzer", Fig. 4): the router grid (``RouterGrid``,
``_build_grid``, ``router_grid``, ``:94-162``), ``GroupAnalysis``, the
recorded scatter-add ``Contribution`` streams and their LRU memo tables
(``:263-390``), and ``Analyzer`` with ``analyze`` and the per-layer and
per-dependency builders it replays (``:482-905``, ``:1393-1465``,
``:1577-1742``).  The arithmetic is the reference's, float64 and in the
same order, so every ``GroupAnalysis`` equals the reference's.  The
batched builders (``_prefetch_contribs``, ``analyze_requests``,
``analyze_batch``, ``row_stream``) and the jitted segment-sum replay stay
in the reference until the search slice needs them; the port's copy
records no metrics.

Given a layer group, an ``LMS`` and an ``ArchConfig`` it produces per-core
compute work (MACs) and buffer footprints, per-directed-link feature-map
traffic under XY routing with multicast trees (cores needing identical
data share one tree), per-DRAM-port traffic (interleaved when FD == 0) and
weight-load traffic amortized over passes.

The analysis decomposes into per-layer contributions (MACs, GLB footprint,
weight/ifmap/ofmap DRAM flows) and per-dependency-edge contributions
(producer->consumer NoC flows), each a pure function of the involved
layers' frozen ``MS`` entries, recorded as scatter-add streams and
memoized.  ``analyze`` concatenates the streams and replays them with one
``np.bincount``, which adds in array order like an unbuffered
``np.add.at``, so the result is bit-identical to applying the
contributions one by one.  Expected-traffic scales multiply the recorded
contributions, each guarded behind ``scale != 1.0``, so graphs with every
scale at 1.0 replay the dense streams exactly.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .encoding import LMS, MS, parse_regions_arrays
from .hw import ArchConfig
from .intra_core import explore_intra_core_many
from .workload import Graph, Layer, LayerGroup


# ---------------------------------------------------------------------------
# Router geometry, cached per arch signature
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RouterGrid:
    n_nodes: int
    n_edges: int
    edge_is_d2d: np.ndarray          # (n_edges,) bool
    paths: np.ndarray                # (n_nodes, n_nodes, max_len) edge ids, -1 pad
    path_len: np.ndarray             # (n_nodes, n_nodes)
    hops_d2d: np.ndarray             # (n_nodes, n_nodes) number of D2D edges


def _build_grid(arch: ArchConfig) -> RouterGrid:
    gw, gh = arch.grid_w, arch.grid_h
    n_nodes = gw * gh
    # directed edges: id layout [east | west | south(+y) | north(-y)]
    n_h = (gw - 1) * gh
    n_v = gw * (gh - 1)
    n_edges = 2 * n_h + 2 * n_v

    def east_id(x, y):  return y * (gw - 1) + x            # (x,y)->(x+1,y)
    def west_id(x, y):  return n_h + y * (gw - 1) + (x - 1)  # (x,y)->(x-1,y)
    def south_id(x, y): return 2 * n_h + y * gw + x        # (x,y)->(x,y+1)
    def north_id(x, y): return 2 * n_h + n_v + (y - 1) * gw + x

    is_d2d = np.zeros(n_edges, dtype=bool)
    for y in range(gh):
        for x in range(gw - 1):
            d2d = arch.node_chiplet(y * gw + x) != arch.node_chiplet(y * gw + x + 1)
            is_d2d[east_id(x, y)] = d2d
            is_d2d[west_id(x + 1, y)] = d2d
    for y in range(gh - 1):
        for x in range(gw):
            d2d = arch.node_chiplet(y * gw + x) != arch.node_chiplet((y + 1) * gw + x)
            is_d2d[south_id(x, y)] = d2d
            is_d2d[north_id(x, y + 1)] = d2d

    max_len = (gw - 1) + (gh - 1)
    # int64 so gathered edge ids feed Contribution.add's fast path directly
    paths = np.full((n_nodes, n_nodes, max(max_len, 1)), -1, dtype=np.int64)
    plen = np.zeros((n_nodes, n_nodes), dtype=np.int32)
    hops_d2d = np.zeros((n_nodes, n_nodes), dtype=np.int32)
    for a in range(n_nodes):
        ay, ax = divmod(a, gw)
        for b in range(n_nodes):
            if a == b:
                continue
            by, bx = divmod(b, gw)
            e: List[int] = []
            x, y = ax, ay
            while x < bx:
                e.append(east_id(x, y)); x += 1
            while x > bx:
                e.append(west_id(x, y)); x -= 1
            while y < by:
                e.append(south_id(x, y)); y += 1
            while y > by:
                e.append(north_id(x, y)); y -= 1
            paths[a, b, :len(e)] = e
            plen[a, b] = len(e)
            hops_d2d[a, b] = int(is_d2d[e].sum()) if e else 0
    return RouterGrid(n_nodes, n_edges, is_d2d, paths, plen, hops_d2d)


_GRID_CACHE: Dict[Tuple, RouterGrid] = {}


def router_grid(arch: ArchConfig) -> RouterGrid:
    key = (arch.x_cores, arch.y_cores, arch.xcut, arch.ycut)
    if key not in _GRID_CACHE:
        _GRID_CACHE[key] = _build_grid(arch)
    return _GRID_CACHE[key]


# ---------------------------------------------------------------------------
# Analysis result
# ---------------------------------------------------------------------------

@dataclass
class GroupAnalysis:
    """Traffic/compute for ONE pipeline pass of one layer group."""
    arch: ArchConfig
    batch_unit: int
    core_macs: np.ndarray            # (n_cores,) MACs per pass
    edge_bytes: np.ndarray           # (n_edges,) NoC/D2D bytes per pass
    edge_bytes_amortized: np.ndarray  # weight loads etc., already / n_passes
    dram_bytes: np.ndarray           # (n_dram,) bytes per pass (fmap flows)
    dram_bytes_amortized: np.ndarray  # (n_dram,) weight loads / n_passes
    core_glb_need: np.ndarray        # (n_cores,) resident footprint bytes
    core_in_bytes: np.ndarray        # (n_cores,) fmap bytes received per pass
    core_out_bytes: np.ndarray       # (n_cores,) fmap bytes sent per pass
    weight_dram_bytes_total: float   # unamortized (for energy, counted once)
    # per-core intra-core compute seconds and the (GLB read, GLB write)
    # byte totals of the group's chosen core dataflows
    core_time_s: np.ndarray          # (n_cores,)
    glb_rw_bytes: np.ndarray         # (2,) read, write


def _overlap_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(P,8) x (Q,8) region arrays -> (P,Q) overlap element counts."""
    lo = np.maximum(a[:, None, 0::2], b[None, :, 0::2])
    hi = np.minimum(a[:, None, 1::2], b[None, :, 1::2])
    d = hi - lo
    np.clip(d, 0, None, out=d)
    return d[..., 0] * d[..., 1] * d[..., 2] * d[..., 3]


# ---------------------------------------------------------------------------
# Recorded scatter-add contributions
# ---------------------------------------------------------------------------

# accumulation targets a contribution may write (int-indexed: stream
# dispatch happens hundreds of thousands of times per SA run).  CORE_TIME
# and GLB_RW carry the intra-core engine's per-core compute seconds and
# the (read, write) GLB byte totals, so one cached stream replay yields
# the full GroupEval input.
(T_CORE_MACS, T_EDGE, T_EDGE_AM, T_DRAM, T_DRAM_AM,
 T_GLB, T_CORE_IN, T_CORE_OUT, T_CORE_TIME, T_GLB_RW) = range(10)
_N_TARGETS = 10


class Contribution:
    """A recorded sequence of scatter-adds onto the analysis accumulators.

    ``add`` records (target, indices, values) in call order; ``seal``
    shifts the indices by the per-target offsets into the analyzer's one
    flat accumulator buffer and concatenates everything into a single
    (idx, vals) stream.  Replaying with ``np.add.at`` — unbuffered,
    repeated indices applied in order — reproduces the exact float-add
    sequence of the recording computation: targets never share a buffer
    cell, and per-cell add order is the add-call order either way.
    """

    __slots__ = ("_parts", "flat_idx", "flat_vals", "weight_total")

    _EMPTY_I = np.empty(0, dtype=np.int64)
    _EMPTY_V = np.empty(0, dtype=np.float64)

    def __init__(self) -> None:
        self._parts: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self.flat_idx: np.ndarray = self._EMPTY_I
        self.flat_vals: np.ndarray = self._EMPTY_V
        self.weight_total = 0.0

    def add(self, target: int, idx, vals) -> None:
        # fast path: well-formed arrays (the overwhelming majority of the
        # call sites) skip the conversion checks — this method runs tens of
        # thousands of times per SA second
        if not (type(idx) is np.ndarray and idx.dtype == np.int64
                and idx.ndim == 1):
            idx = np.asarray(idx, dtype=np.int64)
            if idx.ndim != 1:
                idx = idx.reshape(-1)
        if idx.size == 0:
            return
        if not (type(vals) is np.ndarray and vals.dtype == np.float64
                and vals.ndim == 1 and vals.size == idx.size):
            vals = np.asarray(vals, dtype=np.float64)
            if vals.ndim == 0:
                vals = np.broadcast_to(vals, idx.shape)
            elif vals.ndim != 1:
                vals = vals.reshape(-1)
        self._parts.append((target, idx, vals))

    def seal(self, offsets: Sequence[int]) -> "Contribution":
        if self._parts:
            idxs = [i if offsets[t] == 0 else i + offsets[t]
                    for t, i, _ in self._parts]
            self.flat_idx = idxs[0] if len(idxs) == 1 else np.concatenate(idxs)
            self.flat_vals = self._parts[0][2] if len(self._parts) == 1 \
                else np.concatenate([v for _, _, v in self._parts])
        self._parts = []
        return self

    def collect(self, out_i: List[np.ndarray],
                out_v: List[np.ndarray]) -> None:
        """Append this contribution's flat stream to the gather lists; the
        caller concatenates once and replays with one ``np.add.at``."""
        if self.flat_idx.size:
            out_i.append(self.flat_idx)
            out_v.append(self.flat_vals)



class _LRU(dict):
    """Tiny bounded LRU dict for memoizing contributions and geometry.

    ``get`` refreshes recency (a plain dict keeps insertion order, so a
    hit re-inserts its entry at the end); ``put`` evicts the least
    recently used entry at the cap.  The refresh costs one delete + one
    re-insert per hit — noise next to the array work a hit saves — and
    it is what keeps hot shared geometry (``_GEO_CACHE``) resident across
    large multi-candidate sweeps instead of being FIFO-evicted by
    one-shot entries.
    """

    __slots__ = ("maxsize",)
    _MISS = object()

    def __init__(self, maxsize: int):
        super().__init__()
        self.maxsize = maxsize

    def get(self, key, default=None):
        val = dict.get(self, key, _LRU._MISS)
        if val is _LRU._MISS:
            return default
        # recency order only matters once eviction is in sight; below
        # half-fill a hit skips the refresh entirely, keeping the hot
        # all-hits path at plain-dict cost
        if len(self) * 2 >= self.maxsize:
            del self[key]
            dict.__setitem__(self, key, val)
        return val

    def put(self, key, value):
        if key not in self and len(self) >= self.maxsize:
            self.pop(next(iter(self)))
        self[key] = value
        return value



# Process-wide second-level cache for PURE LAYER GEOMETRY artifacts (region
# tables, needed-ifmap rows, sibling labels, overlap counts, intra-core
# dataflow stats).  These depend only on frozen Layer content + Part (+ the
# few arch constants in their keys), never on the graph or the core
# binding, so every Analyzer shares one copy; the per-analyzer first-level
# caches keep the hot hit path on small-int keys.  Entries are read-only
# by contract; the reference's default cap bounds it, and an eviction only
# costs recompute time (the geometry rebuilds bit-identically).
_GEO_CACHE = _LRU(262_144)


class Analyzer:
    """Stateful per-(arch, graph) analyzer; reused across SA iterations."""

    def __init__(self, arch: ArchConfig, g: Graph, cache_size: int = 50_000):
        self.arch = arch
        self.g = g
        self.grid = router_grid(arch)
        self._core_nodes = np.array(
            [arch.core_node(c) for c in range(arch.n_cores)], dtype=np.int64)
        self._dram_nodes = np.array(
            [arch.dram_node(d) for d in range(1, arch.n_dram + 1)], dtype=np.int64)
        # (src, dst) -> PACKED edge membership of the XY path (uint64
        # bitsets, bit e of word e // 64 = edge e): turns the per-multicast
        # path-union into a gather + bitwise-OR reduce at 1/8th the memory
        # traffic of a boolean mask.  Bit order relies on little-endian
        # uint64 <-> uint8 views (every supported target); gate on size
        # (fall back to sorting above on absurd grids).
        grid = self.grid
        n_words = -(-grid.n_edges // 64)
        if (sys.byteorder == "little"
                and grid.n_nodes * grid.n_nodes * n_words * 8 <= 64_000_000):
            bits = np.zeros((grid.n_nodes, grid.n_nodes, n_words),
                            dtype=np.uint64)
            ii, jj, kk = np.nonzero(grid.paths >= 0)
            ee = grid.paths[ii, jj, kk]
            np.bitwise_or.at(bits, (ii, jj, ee // 64),
                             np.uint64(1) << (ee % 64).astype(np.uint64))
            self._path_bits: Optional[np.ndarray] = bits
        else:
            self._path_bits = None
        # intern small ints for layers/groups: cache keys hash ints, not
        # string tuples
        self._layer_idx = {name: i for i, name in enumerate(g.layers)}
        self._group_ids: Dict[Tuple[str, ...], int] = {}
        # one flat accumulator buffer; analyze() zero-fills and slices it,
        # in T_* target order
        nc, ne, nd = arch.n_cores, self.grid.n_edges, arch.n_dram
        bounds = np.cumsum([0, nc, ne, ne, nd, nd, nc, nc, nc, nc, 2])
        self._layout = [(int(bounds[i]), int(bounds[i + 1]))
                        for i in range(_N_TARGETS)]
        self._offsets = [lo for lo, _ in self._layout]
        self._buf_len = int(bounds[-1])
        # memo tables for the incremental path
        self._table_cache = _LRU(cache_size)      # region geometry (per Part)
        self._rarr_cache = _LRU(cache_size)       # regions as (cores, array)
        self._node_cache = _LRU(cache_size)       # region cores -> grid nodes
        self._needgeo_cache = _LRU(cache_size)    # need rows (per Part)
        self._needgrp_cache = _LRU(cache_size)    # sibling labels (per Part)
        self._ov_cache = _LRU(cache_size)         # overlap counts (per Part)
        self._intra_cache = _LRU(cache_size)      # intra-core t/rd/wr (per Part)
        self._need_cache = _LRU(cache_size)       # consumer need regions
        self._layer_cache = _LRU(cache_size)      # (pre, post) contributions
        self._dep_cache = _LRU(cache_size)
        self._topo_cache = _LRU(cache_size)       # per-group internal preds

    # -- routing helpers -----------------------------------------------------
    def _route(self, contrib: Contribution, target: int, src_nodes: np.ndarray,
               dst_nodes: np.ndarray, vols: np.ndarray) -> None:
        """Record unicast volumes onto edge loads (vectorized).

        Zero-volume rows are routed too (their edge cells receive exact
        ``+0.0`` no-ops, so the replayed sums are bit-identical to
        filtering them out) — dropping the positivity filter saves four
        array ops on a path hot enough for that to matter."""
        paths = self.grid.paths[src_nodes, dst_nodes]   # (n, max_len)
        flat = paths.reshape(-1)
        keep = flat >= 0
        contrib.add(target, flat[keep], np.repeat(vols, paths.shape[1])[keep])

    # ifmap regions, the producerxconsumer overlap counts) depends only on a
    # layer's Part, never on its CG — core swaps (SA OP2/OP3) reuse it all.
    # Only the core BINDING (which core holds which row) involves the CG.

    def region_geometry(self, name: str, part: Tuple[int, ...],
                        bu: int) -> np.ndarray:
        """Region rows (N, 8) in correspondence order; row i -> CG[i]."""
        key = (self._layer_idx[name], part, bu)
        hit = self._table_cache.get(key)
        if hit is None:
            lyr = self.g.layers[name]
            gkey = ("rg", lyr, part, bu)
            hit = _GEO_CACHE.get(gkey)
            if hit is None:
                ms = MS(part=part, cg=tuple(range(int(np.prod(part)))),
                        fd=(-1, -1, -1))
                _, rarr = parse_regions_arrays(ms, lyr, bu)
                hit = _GEO_CACHE.put(gkey, rarr)
            self._table_cache.put(key, hit)
        return hit

    def region_table(self, name: str, ms: MS, bu: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(cores, region rows) in correspondence order (unsorted)."""
        return (np.asarray(ms.cg, dtype=np.int64),
                self.region_geometry(name, ms.part, bu))

    def _region_arrays(self, name: str, ms: MS, bu: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(cores sorted, region rows sorted by core, correspondence->sorted
        permutation)."""
        key = (self._layer_idx[name], ms.geo, bu)
        hit = self._rarr_cache.get(key)
        if hit is None:
            cores, rarr = self.region_table(name, ms, bu)
            order = np.argsort(cores)
            hit = self._rarr_cache.put(key,
                                       (cores[order], rarr[order], order))
        return hit

    def _region_nodes(self, name: str, ms: MS, bu: int) -> np.ndarray:
        key = (self._layer_idx[name], ms.geo, bu)
        hit = self._node_cache.get(key)
        if hit is None:
            cores, _, _ = self._region_arrays(name, ms, bu)
            hit = self._node_cache.put(key, self._core_nodes[cores])
        return hit

    def _need_geometry(self, cname: str, c_part: Tuple[int, ...], bu: int,
                       prod_K: int) -> np.ndarray:
        """Needed producer-ofmap regions (correspondence order)."""
        key = (self._layer_idx[cname], c_part, bu, prod_K)
        hit = self._needgeo_cache.get(key)
        if hit is None:
            cons = self.g.layers[cname]
            gkey = ("need", cons, c_part, bu, prod_K)
            hit = _GEO_CACHE.get(gkey)
            if hit is None:
                hit = _GEO_CACHE.put(
                    gkey, self._ifmap_regions(cons,
                                              self.region_geometry(
                                                  cname, c_part, bu), prod_K))
            self._needgeo_cache.put(key, hit)
        return hit

    def _intra_geometry(self, name: str, part: Tuple[int, ...], bu: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-region (compute seconds, GLB read bytes, GLB write bytes) of
        the chosen intra-core dataflows, in correspondence order.  Geometry
        only: row i belongs to whatever core CG[i] names."""
        key = (self._layer_idx[name], part, bu)
        hit = self._intra_cache.get(key)
        if hit is not None:
            return hit
        arch, lyr = self.arch, self.g.layers[name]
        gkey = ("intra", lyr, part, bu, arch.core_glb_bytes,
                arch.macs_per_core, arch.freq_ghz)
        hit = _GEO_CACHE.get(gkey)
        if hit is None:
            rarr = self.region_geometry(name, part, bu)
            spans = rarr[:, 1::2] - rarr[:, 0::2]       # (N, 4): h, w, b, k
            elems = spans[:, 0] * spans[:, 1] * spans[:, 2] * spans[:, 3]
            rk = spans[:, 3]
            hwb = np.maximum(1, elems // np.maximum(1, rk))
            bpe = lyr.bytes_per_elem
            sigs = [(int(rk[i]), lyr.C, int(hwb[i]), lyr.R, lyr.S, bpe,
                     arch.core_glb_bytes, arch.macs_per_core, lyr.kind)
                    for i in range(len(rarr))]
            dfs = explore_intra_core_many(sigs)
            n = len(dfs)
            util = np.fromiter((df.utilization for df in dfs), np.float64, n)
            rd = np.fromiter((df.glb_read_bytes for df in dfs), np.float64, n)
            wr = np.fromiter((df.glb_write_bytes for df in dfs), np.float64, n)
            mac_per_elem = lyr.macs(1) / max(1, lyr.ofmap_elems)
            peak = arch.macs_per_core * arch.freq_ghz * 1e9
            t = (elems * mac_per_elem) / (peak * np.maximum(util, 1e-3))
            hit = _GEO_CACHE.put(gkey, (t, rd, wr))
        self._intra_cache.put(key, hit)
        return hit

    def _overlap_geometry(self, pname: str, p_part: Tuple[int, ...],
                          cname: str, c_part: Tuple[int, ...], bu: int,
                          prod_K: int) -> Tuple[np.ndarray, bool]:
        """(overlap counts in correspondence order, any-nonzero flag)."""
        key = (self._layer_idx[pname], p_part,
               self._layer_idx[cname], c_part, bu, prod_K)
        hit = self._ov_cache.get(key)
        if hit is None:
            gkey = ("ov", self.g.layers[pname], p_part,
                    self.g.layers[cname], c_part, bu, prod_K)
            hit = _GEO_CACHE.get(gkey)
            if hit is None:
                ov = _overlap_matrix(self.region_geometry(pname, p_part, bu),
                                     self._need_geometry(cname, c_part, bu,
                                                         prod_K))
                hit = _GEO_CACHE.put(gkey, (ov, bool(ov.any())))
            self._ov_cache.put(key, hit)
        return hit

    @staticmethod
    def _ifmap_regions(cons: Layer, c_arr: np.ndarray,
                       prod_K: int) -> np.ndarray:
        """Vectorized :func:`repro.core.encoding.ifmap_region` over the rows
        of a consumer region table — same integer arithmetic per kind."""
        need = c_arr.copy()
        if cons.kind in ("eltwise",):
            return need
        s = cons.stride
        if cons.kind in ("pool", "depthwise"):
            need[:, 0] = c_arr[:, 0] * s
            need[:, 1] = np.minimum(c_arr[:, 1] * s + cons.R - 1, cons.H * s)
            need[:, 2] = c_arr[:, 2] * s
            need[:, 3] = np.minimum(c_arr[:, 3] * s + cons.S - 1, cons.W * s)
            return need
        # conv / fc / matmul: full channel contraction
        h_in = cons.H * s
        w_in = cons.W * s
        need[:, 0] = np.minimum(c_arr[:, 0] * s, h_in - 1)
        need[:, 1] = np.minimum(c_arr[:, 1] * s + cons.R - 1, h_in)
        need[:, 2] = np.minimum(c_arr[:, 2] * s, w_in - 1)
        need[:, 3] = np.minimum(c_arr[:, 3] * s + cons.S - 1, w_in)
        need[:, 6] = 0
        need[:, 7] = prod_K
        return need

    def _need_labels(self, cname: str, c_part: Tuple[int, ...], bu: int,
                     prod_K: int) -> np.ndarray:
        """Sibling-equivalence label per correspondence-order need row
        (rows with identical content share a label).  Pure geometry —
        cached per Part, so the per-CG grouping below reduces to integer
        ops on a permutation of these labels."""
        key = (self._layer_idx[cname], c_part, bu, prod_K)
        hit = self._needgrp_cache.get(key)
        if hit is None:
            gkey = ("lbl", self.g.layers[cname], c_part, bu, prod_K)
            hit = _GEO_CACHE.get(gkey)
            if hit is None:
                need_geo = self._need_geometry(cname, c_part, bu, prod_K)
                _, inv = np.unique(need_geo, axis=0, return_inverse=True)
                hit = _GEO_CACHE.put(gkey, inv.reshape(-1).astype(np.int64))
            self._needgrp_cache.put(key, hit)
        return hit

    def _need_arrays(self, cname: str, cms: MS, bu: int, prod_K: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Needed producer-ofmap region per consumer part (sorted-core order),
        plus the multicast grouping: consumer parts with identical need rows
        (K-partition siblings) as a padded member matrix.

        Returns (need (Q,8), first (G,) first member of each sibling group in
        first-seen order, members (G,Qmax) member indices padded with -1).

        The grouping reproduces the historical dict-of-lists scan exactly
        — groups enumerate in first-seen order over the sorted-core
        positions, members ascending within a group — but runs as a
        handful of integer-array ops on the cached per-Part sibling
        labels instead of a Python loop over row tuples."""
        key = (self._layer_idx[cname], cms.geo, bu, prod_K)
        hit = self._need_cache.get(key)
        if hit is None:
            c_cores, _, c_ord = self._region_arrays(cname, cms, bu)
            need = self._need_geometry(cname, cms.part, bu, prod_K)[c_ord]
            labels = self._need_labels(cname, cms.part, bu, prod_K)[c_ord]
            uniq, first_pos = np.unique(labels, return_index=True)
            order = np.argsort(first_pos, kind="stable")   # first-seen order
            G = len(uniq)
            rank = np.empty(int(uniq.max()) + 1 if G else 1, dtype=np.int64)
            rank[uniq[order]] = np.arange(G)
            r = rank[labels]                   # group row per position
            counts = np.bincount(r, minlength=G).astype(np.int64)
            qmax = int(counts.max()) if G else 0
            ordered = np.argsort(r, kind="stable")   # grouped, qi ascending
            off = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(
                np.int64) if G else np.zeros(0, np.int64)
            members = np.full((G, qmax), -1, dtype=np.int64)
            rr = r[ordered]
            members[rr, np.arange(len(rr)) - off[rr]] = ordered
            first = members[:, 0].copy() if qmax else np.zeros(0, np.int64)
            pad = members < 0
            c_nodes = self._region_nodes(cname, cms, bu)
            cn = np.where(pad, -1, c_nodes[members])
            hit = self._need_cache.put(key, (need, first, members, cn, ~pad))
        return hit

    def _layer_contribs(self, name: str, ms: MS, bu: int, n_passes: int,
                        group: LayerGroup,
                        gid: int) -> Tuple[Contribution, Contribution]:
        """(pre, post) contributions of one layer: pre = MACs + GLB footprint +
        weight loads; post = external-ifmap and ofmap DRAM flows.  The split
        preserves the accumulation order of the monolithic loop, where
        dependency traffic sits between the two."""
        key = (self._layer_idx[name], ms, bu, n_passes, gid)
        hit = self._layer_cache.get(key)
        if hit is not None:
            return hit
        g, in_group = self.g, set(group.names)
        lyr = g.layers[name]
        cores, rarr, _ = self._region_arrays(name, ms, bu)
        nodes = self._core_nodes[cores]
        bpe = lyr.bytes_per_elem
        # expected-traffic scales: activations/compute (ts) and weight
        # loads (ws).  Every application below is guarded behind != 1.0,
        # so a dense layer's float-op sequence is exactly the pre-scale
        # one — the bit-identity contract of the expected-traffic IR.
        ts = lyr.traffic_scale
        ws = lyr.weight_traffic_scale

        pre = Contribution()
        post = Contribution()

        # compute: MACs proportional to (expected) ofmap share
        elems = (rarr[:, 1] - rarr[:, 0]) * (rarr[:, 3] - rarr[:, 2]) \
            * (rarr[:, 5] - rarr[:, 4]) * (rarr[:, 7] - rarr[:, 6])
        mac_per_elem = lyr.macs(1) / max(1, lyr.ofmap_elems)
        macs_v = elems * mac_per_elem
        if ts != 1.0:
            macs_v = macs_v * ts
        pre.add(T_CORE_MACS, cores, macs_v)

        # GLB footprint: weight slice + ofmap part (double-buffered fmaps);
        # the fmap share is expected-resident, the weight slice stays dense
        # (it must be held regardless of routing)
        w_share = lyr.weight_bytes() / max(1, ms.part[3]) if lyr.has_weight else 0
        fmap_foot = elems * bpe * 2
        if ts != 1.0:
            fmap_foot = fmap_foot * ts
        pre.add(T_GLB, cores, fmap_foot + w_share)

        # intra-core engine: per-core compute time + GLB traffic of the
        # chosen dataflows, in correspondence order (the order the scalar
        # engine iterated regions in); pure geometry, cached per Part —
        # the expected scale multiplies outside the cache, so equal-dims
        # layers with different scales share the geometry entry content
        t_arr, rd, wr = self._intra_geometry(name, ms.part, bu)
        if ts != 1.0:
            t_arr = t_arr * ts
            rd = rd * ts
            wr = wr * ts
        u_cores = np.asarray(ms.cg, dtype=np.int64)
        pre.add(T_CORE_TIME, u_cores, t_arr)
        zeros = np.zeros(len(rd), dtype=np.int64)
        pre.add(T_GLB_RW, zeros, rd)
        pre.add(T_GLB_RW, zeros + 1, wr)

        # ---- weights: DRAM -> core, amortized over passes ----------------
        if lyr.has_weight:
            # each core holds the K-slice of its region (C,R,S full)
            k_span = (rarr[:, 7] - rarr[:, 6])
            w_bytes_core = k_span / max(1, lyr.K) * lyr.weight_bytes()
            if ws != 1.0:
                w_bytes_core = w_bytes_core * ws
            pre.weight_total = float(w_bytes_core.sum())
            self._dram_flow(pre, T_EDGE_AM, T_DRAM_AM, ms.fd[1], nodes,
                            w_bytes_core / n_passes, to_core=True)

        # ---- ifmaps (external only; internal deps are edge contributions) --
        preds = [p for p in g.preds(name)]
        external = (not preds) or any(p not in in_group for p in preds)
        if external and ms.fd[0] >= 0:
            # expected needed ifmap from DRAM (input of DNN or previous
            # group): the layer only fetches the tokens it processes
            if_bytes = self._external_ifmap_bytes(lyr, rarr, bu) * bpe
            if ts != 1.0:
                if_bytes = if_bytes * ts
            self._dram_flow(post, T_EDGE, T_DRAM, ms.fd[0], nodes,
                            if_bytes, to_core=True)
            post.add(T_CORE_IN, cores, if_bytes)

        # ---- ofmaps ------------------------------------------------------
        if ms.fd[2] >= 0:
            of_bytes = elems * bpe
            if ts != 1.0:
                of_bytes = of_bytes * ts
            self._dram_flow(post, T_EDGE, T_DRAM, ms.fd[2], nodes,
                            of_bytes.astype(float), to_core=False)
            post.add(T_CORE_OUT, cores, of_bytes)

        return self._layer_cache.put(
            key, (pre.seal(self._offsets), post.seal(self._offsets)))

    def _dep_contrib(self, pname: str, pms: MS, cname: str, cms: MS,
                     bu: int) -> Contribution:
        key = (self._layer_idx[pname], pms.geo,
               self._layer_idx[cname], cms.geo, bu)
        hit = self._dep_cache.get(key)
        if hit is None:
            contrib = Contribution()
            self._dep_traffic(contrib, pname, pms, cname, cms, bu)
            hit = self._dep_cache.put(key, contrib.seal(self._offsets))
        return hit

    def _group_topology(self, group: LayerGroup) -> List[Tuple[str, List[str]]]:
        """Per layer, its in-group predecessors (graph scans done once)."""
        key = group.names
        hit = self._topo_cache.get(key)
        if hit is None:
            in_group = set(group.names)
            hit = self._topo_cache.put(
                key, [(n, [p for p in self.g.preds(n) if p in in_group])
                      for n in group.names])
        return hit

    # -- main entry ------------------------------------------------------------
    def _gather_stream(self, group: LayerGroup, lms: LMS, bu: int,
                       n_passes: int, gid: int, chunks_i: List[np.ndarray],
                       chunks_v: List[np.ndarray]) -> float:
        """Append one mapping's contribution chunks in the canonical replay
        order (per layer: pre, internal-dep edges, post); returns the
        mapping's weight-DRAM total.  Shared by the scalar and batched
        paths, so both replay the exact same per-buffer add sequence."""
        weight_total = 0.0
        for name, internal_preds in self._group_topology(group):
            pre, post = self._layer_contribs(name, lms.ms[name], bu,
                                             n_passes, group, gid)
            pre.collect(chunks_i, chunks_v)
            weight_total += pre.weight_total
            for p in internal_preds:
                self._dep_contrib(p, lms.ms[p], name,
                                  lms.ms[name], bu).collect(chunks_i,
                                                            chunks_v)
            post.collect(chunks_i, chunks_v)
        return weight_total

    def _wrap_analysis(self, buf: np.ndarray, group: LayerGroup, lms: LMS,
                       bu: int, weight_total: float) -> GroupAnalysis:
        """View one replayed accumulator buffer as a :class:`GroupAnalysis`."""
        arrays = [buf[lo:hi] for lo, hi in self._layout]
        return GroupAnalysis(
            arch=self.arch, batch_unit=bu, core_macs=arrays[T_CORE_MACS],
            edge_bytes=arrays[T_EDGE], edge_bytes_amortized=arrays[T_EDGE_AM],
            dram_bytes=arrays[T_DRAM], dram_bytes_amortized=arrays[T_DRAM_AM],
            core_glb_need=arrays[T_GLB], core_in_bytes=arrays[T_CORE_IN],
            core_out_bytes=arrays[T_CORE_OUT],
            weight_dram_bytes_total=weight_total,
            core_time_s=arrays[T_CORE_TIME], glb_rw_bytes=arrays[T_GLB_RW])

    def analyze(self, group: LayerGroup, lms: LMS, total_batch: int) -> GroupAnalysis:
        bu = group.batch_unit
        n_passes = max(1, -(-total_batch // bu))
        gid = self._group_ids.setdefault(group.names, len(self._group_ids))

        # gather every contribution's flat stream, concatenate once, replay
        # with a single np.bincount — which accumulates elements in array
        # order exactly like unbuffered np.add.at (per cell, the adds land
        # in the same sequence), so this is bit-identical to applying the
        # contributions one by one, at a fraction of ufunc.at's dispatch
        # cost
        chunks_i: List[np.ndarray] = []
        chunks_v: List[np.ndarray] = []
        weight_total = self._gather_stream(group, lms, bu, n_passes, gid,
                                           chunks_i, chunks_v)
        if chunks_i:
            buf = np.bincount(np.concatenate(chunks_i),
                              weights=np.concatenate(chunks_v),
                              minlength=self._buf_len)
        else:
            buf = np.zeros(self._buf_len)
        return self._wrap_analysis(buf, group, lms, bu, weight_total)

    def _external_ifmap_bytes(self, lyr: Layer, rarr: np.ndarray,
                              bu: int) -> np.ndarray:
        """Elements of DNN-level input each core must fetch (halo included)."""
        s = lyr.stride
        dh = (rarr[:, 1] - rarr[:, 0]) * s + (lyr.R - 1)
        dw = (rarr[:, 3] - rarr[:, 2]) * s + (lyr.S - 1)
        db = rarr[:, 5] - rarr[:, 4]
        if lyr.kind in ("eltwise", "pool", "depthwise"):
            dk = (rarr[:, 7] - rarr[:, 6]) * (lyr.n_inputs if lyr.kind == "eltwise" else 1)
        elif lyr.kind == "matmul":
            # both operands streamed: rows of A for H-range + full B operand share
            dk = np.full(len(rarr), lyr.C, dtype=np.int64)
            return (rarr[:, 1] - rarr[:, 0]) * db * lyr.C \
                + (rarr[:, 7] - rarr[:, 6]) * db * lyr.C
        else:
            dk = np.full(len(rarr), max(1, lyr.C), dtype=np.int64)
        return dh * dw * db * dk

    def _dram_flow(self, contrib: Contribution, etarget: int, dtarget: int,
                   fd: int, nodes: np.ndarray, vols: np.ndarray,
                   to_core: bool) -> None:
        """Record core<->DRAM volumes.  fd==0 interleaves over all ports."""
        vols = np.asarray(vols, dtype=float)
        if np.ndim(vols) == 0:
            vols = np.full(len(nodes), float(vols))
        if fd == 0:
            # one route call covering every port: concatenating the
            # per-port (src, dst, vol) rows in port order preserves the
            # per-edge-cell add sequence of the historical per-port loop
            # (cross-target chunk order is free — edge and DRAM cells
            # never share a buffer cell), so the stream is bit-identical
            nd = self.arch.n_dram
            share = vols / nd
            dn = np.repeat(self._dram_nodes[:nd], len(nodes))
            cn = np.concatenate([nodes] * nd)
            sh = np.concatenate([share] * nd)
            if to_core:
                self._route(contrib, etarget, dn, cn, sh)
            else:
                self._route(contrib, etarget, cn, dn, sh)
            s = float(share.sum())
            contrib.add(dtarget, np.arange(nd, dtype=np.int64),
                        np.full(nd, s))
        else:
            d = fd - 1
            dn = np.full(len(nodes), self._dram_nodes[d])
            if to_core:
                self._route(contrib, etarget, dn, nodes, vols)
            else:
                self._route(contrib, etarget, nodes, dn, vols)
            contrib.add(dtarget, d, float(vols.sum()))

    def _dep_traffic(self, contrib: Contribution, pname: str, pms: MS,
                     cname: str, cms: MS, bu: int) -> None:
        """Producer->consumer on-chip flow with K-multicast grouping.

        Consumers whose needed region is identical (K-partition siblings for
        channel-contracting layers) form one multicast set per producer part.

        Expected-traffic scaling: the flow is the dense overlap volume times
        the producer's ``traffic_scale`` times the edge's multiplicity (the
        producer only emits its expected share; a routed consumer reading a
        fraction of a dense producer carries that fraction as edge
        multiplicity).  The guard keeps dense graphs bit-identical.
        """
        prod, cons = self.g.layers[pname], self.g.layers[cname]
        p_cores, _, p_ord = self._region_arrays(pname, pms, bu)
        c_cores, _, c_ord = self._region_arrays(cname, cms, bu)
        bpe = prod.bytes_per_elem
        escale = prod.traffic_scale * self.g.edge_mult(pname, cname)

        # needed region of each consumer part, in producer-ofmap coordinates,
        # with its multicast grouping (consumer parts sharing a need row)
        need, mc_first, mc_members, mc_cn, mc_live = \
            self._need_arrays(cname, cms, bu, prod.K)

        # overlap counts are pure geometry (cached per Part pair); permute
        # rows/columns from correspondence order into sorted-core order
        ov_geo, any_ov = self._overlap_geometry(pname, pms.part, cname,
                                                cms.part, bu, prod.K)
        if not any_ov:
            return
        p_nodes = self._region_nodes(pname, pms, bu)
        c_nodes = self._region_nodes(cname, cms, bu)

        contracting = cons.kind in ("conv", "fc", "matmul")
        if contracting:
            # one 3-d batch over (sibling group g, producer part p, member q);
            # the accumulation order is (g, p, q) — the order of the
            # historical nested loop.  Only sibling-first columns of the
            # overlap table are needed (identical need rows have identical
            # overlaps), so the permute gathers (P, G), not (P, Q).
            G, Qmax = mc_members.shape
            P = len(p_cores)
            vols = ov_geo[p_ord[:, None],
                          c_ord[mc_first][None, :]].T * np.float64(bpe)
            if escale != 1.0:
                vols = vols * escale
            cn = mc_cn                                        # (G, Qmax)
            off_node = (p_nodes[None, :, None] != cn[:, None, :]) \
                & mc_live[:, None, :]                         # (G, P, Qmax)
            live = vols > 0                                   # (G, P)
            act = off_node & live[:, :, None]                 # (G, P, Qmax)
            # union of XY paths per (g, p) over its off-node members; both
            # forms produce the edge ids ascending per (g, p) row — the
            # sorted-unique set np.unique would give
            if self._path_bits is not None:
                # packed-bitset union: redirect inactive members to the
                # (p, p) diagonal — whose XY path, hence bitset, is empty —
                # gather (G, P, Q, W) uint64 words and OR-reduce over
                # members, then unpack once.  Little-endian uint64 -> uint8
                # views keep bit j of word w at unpacked position 64 * w +
                # 8 * byte + bit == edge id, so nonzero yields edges
                # ascending per (g, p) row exactly like a boolean path
                # mask would.
                p_broad = np.broadcast_to(p_nodes[None, :, None], act.shape)
                cn_eff = np.where(act, cn[:, None, :], p_broad)
                pb = self._path_bits[p_broad, cn_eff]
                union_bits = np.bitwise_or.reduce(pb, axis=2)  # (G, P, W)
                ub = np.unpackbits(
                    union_bits.reshape(G * P, -1).view(np.uint8),
                    axis=1, bitorder="little")
                gp_idx, e_idx = np.nonzero(ub)
                contrib.add(T_EDGE, e_idx,
                            vols.reshape(-1)[gp_idx])
            else:
                paths = self.grid.paths[
                    np.broadcast_to(p_nodes[None, :, None], off_node.shape),
                    np.broadcast_to(cn[:, None, :], off_node.shape)]
                paths = np.where(act[..., None], paths, -1)
                srt = np.sort(paths.reshape(G * P, -1), axis=1)
                first = np.empty_like(srt, dtype=bool)
                first[:, 0] = True
                first[:, 1:] = srt[:, 1:] != srt[:, :-1]
                keep = (srt >= 0) & first
                contrib.add(T_EDGE, srt[keep],
                            np.repeat(vols.reshape(-1), keep.sum(axis=1)))
            # full-form records: dead (g, p[, q]) rows land exact +0.0
            # no-ops on valid cells (pad members index c_cores[-1], a real
            # core, with volume 0), which leaves every per-cell float sum
            # bit-identical to the filtered form while skipping two
            # nonzero scans and their gathers
            has_dst = off_node.any(axis=2)                    # (G, P)
            contrib.add(T_CORE_OUT,
                        np.broadcast_to(p_cores[None, :],
                                        vols.shape).reshape(-1),
                        (vols * has_dst).reshape(-1))
            # each off-node member receives the full volume
            contrib.add(T_CORE_IN,
                        np.broadcast_to(c_cores[mc_members][:, None, :],
                                        act.shape).reshape(-1),
                        (vols[:, :, None] * act).reshape(-1))
        else:
            ov = ov_geo[p_ord[:, None], c_ord[None, :]]   # (P, Q) elems
            vols = ov.astype(float) * bpe
            if escale != 1.0:
                vols = vols * escale
            same = p_nodes[:, None] == c_nodes[None, :]
            vols_off = np.where(same, 0.0, vols)
            P, Q = vols.shape
            self._route(contrib, T_EDGE,
                        np.repeat(p_nodes, Q), np.tile(c_nodes, P),
                        vols_off.reshape(-1))
            contrib.add(T_CORE_OUT, p_cores, vols_off.sum(axis=1))
            contrib.add(T_CORE_IN, c_cores, vols_off.sum(axis=0))

