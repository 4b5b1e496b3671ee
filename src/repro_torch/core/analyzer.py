"""LP-SPM Analyzer: parse an LMS into core workloads + link/DRAM traffic.

Reduced copy of the scalar engine of ``src/repro/core/analyzer.py`` (the
paper's "LP SPM Analyzer", Fig. 4): the router grid (``RouterGrid``,
``_build_grid``, ``router_grid``, ``:94-162``), ``GroupAnalysis`` (with
``total_hops_bytes`` and ``d2d_bytes``), the
recorded scatter-add ``Contribution`` streams and their LRU memo tables
(``:263-390``), and ``Analyzer`` with ``analyze`` and the per-layer and
per-dependency builders it replays (``:482-905``, ``:1393-1465``,
``:1577-1742``); the batched engine: ``GroupAnalysisBatch``,
``_regions_to_array``, ``_shape_chunks``, ``Contribution.from_flat``,
``_route_multicast``, ``regions``, the batched builders
(``_prefetch_contribs``, ``_layer_math``, ``_layer_contribs_batched``,
``_dep_traffic_batched`` and its two chunk builders, ``:906-1392``),
``analyze_requests``, ``row_stream``, ``analyze_batch`` (``:1467-1575``)
and ``d2d_hop_stats`` (``:1744``).  The arithmetic is the reference's,
float64 and in the same order, so every ``GroupAnalysis`` equals the
reference's, and every batched row equals the reference's batched row.
The reference's jitted ``segment_sum`` replay (``_jax_replay``,
``:60-92``, its ``backend="jax"``) is the port's ``backend="fused"``:
:func:`_fused_replay` runs the ``segment_replay`` CUDA kernel of
:mod:`repro_torch.kernels.fused_eval` on the analyzer's ``fused_device``
(the card unless the caller asks for the CPU, where the kernel's plain
version runs).  The process-wide geometry cache counts its hits, misses
and evictions and ``PREFETCH_STATS`` its batched and scalar builds, both
harvested by ``repro_torch.obs`` collectors under the reference's names
(``:392-480``).

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

import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..obs import metrics as _obs_metrics
from .encoding import (LMS, LMSBatch, MS, Region, parse_regions_arrays,
                       unpack_lms_batch)
from .hw import ArchConfig
from .intra_core import explore_intra_core_many
from .workload import Graph, Layer, LayerGroup


def _fused_replay(idx: np.ndarray, vals: np.ndarray, n: int,
                  device: str) -> np.ndarray:
    """``segment_sum(vals, idx, n)`` on ``device`` through the
    ``segment_replay`` kernel (the plain version on the CPU), as float64.

    The counterpart of the reference's ``_jax_replay``.  It keeps that
    function's refusals: an index stream that is not int64 or a value
    stream that is not float64 raises ``TypeError`` rather than being
    narrowed without a word.  The kernel adds each cell's entries in
    float64 in stream order, so a replay gives the same bits on every run,
    those of ``np.bincount``."""
    if idx.dtype != np.int64:
        raise TypeError(
            f"fused replay needs an int64 index stream, got {idx.dtype}")
    if vals.dtype != np.float64:
        raise TypeError(
            f"fused replay needs a float64 value stream, got {vals.dtype}")
    import torch

    from ..kernels.fused_eval import segment_replay
    dev = torch.device(device)
    out = segment_replay(torch.from_numpy(idx).to(dev),
                         torch.from_numpy(vals).to(dev), n)
    return out.cpu().numpy()


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

    @property
    def total_hops_bytes(self) -> float:
        return float(self.edge_bytes.sum())

    @property
    def d2d_bytes(self) -> float:
        g = router_grid(self.arch)
        return float(self.edge_bytes[g.edge_is_d2d].sum())


@dataclass
class GroupAnalysisBatch:
    """B :class:`GroupAnalysis` rows sharing one flat ``(B, buf_len)``
    accumulator buffer.  ``analyses[b]``'s arrays are views of ``buf[b]``,
    so the batched evaluator can run its math once over the 2-D slices
    (``target``) while every row remains a full, cache-storable
    ``GroupAnalysis``."""
    analyses: List[GroupAnalysis]
    buf: np.ndarray                  # (B, buf_len)
    layout: List[Tuple[int, int]]    # per-T_* target (lo, hi) columns
    weight_totals: np.ndarray        # (B,)

    def target(self, t: int) -> np.ndarray:
        lo, hi = self.layout[t]
        return self.buf[:, lo:hi]


def _regions_to_array(regions: Dict[int, Region]) -> Tuple[np.ndarray, np.ndarray]:
    cores = np.array(sorted(regions), dtype=np.int64)
    arr = np.array([[regions[c].h0, regions[c].h1, regions[c].w0, regions[c].w1,
                     regions[c].b0, regions[c].b1, regions[c].k0, regions[c].k1]
                    for c in cores], dtype=np.int64)
    return cores, arr


def _overlap_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(P,8) x (Q,8) region arrays -> (P,Q) overlap element counts."""
    lo = np.maximum(a[:, None, 0::2], b[None, :, 0::2])
    hi = np.minimum(a[:, None, 1::2], b[None, :, 1::2])
    d = hi - lo
    np.clip(d, 0, None, out=d)
    return d[..., 0] * d[..., 1] * d[..., 2] * d[..., 3]


def _shape_chunks(jobs: List, shape_fn, max_cells: int):
    """Split ``jobs`` into runs whose PADDED batch volume stays bounded.

    Jobs are sorted by shape first (similar shapes cluster, minimizing
    padding waste); a chunk of J jobs padded to the elementwise max of
    their ``shape_fn`` tuples costs ``J * prod(max_dims)`` cells, and the
    greedy scan cuts before that cost crosses the cap.  A single
    oversized job still forms its own chunk (it pads to itself, so the
    batched path degenerates to the scalar footprint, never worse).
    """
    if not jobs:
        return
    jobs = sorted(jobs, key=lambda j: tuple(shape_fn(j)))
    chunk: List = []
    dims: Tuple[int, ...] = ()
    for job in jobs:
        s = tuple(shape_fn(job))
        nd = tuple(map(max, dims, s)) if chunk else s
        cost = (len(chunk) + 1) * int(np.prod(nd))
        if chunk and cost > max_cells:
            yield chunk
            chunk, dims = [job], s
        else:
            chunk.append(job)
            dims = nd
    yield chunk


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


    @classmethod
    def from_flat(cls, idx: np.ndarray, vals: np.ndarray,
                  weight_total: float = 0.0) -> "Contribution":
        """Wrap an ALREADY-SEALED stream (offsets applied, chunks
        concatenated in add order) without the add/seal machinery — the
        batched builders construct whole streams as slices of one pooled
        array, and per-piece add/seal dispatch would dominate their
        runtime."""
        c = cls.__new__(cls)
        c._parts = []
        c.flat_idx = idx
        c.flat_vals = vals
        c.weight_total = weight_total
        return c


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


class _StatLRU(_LRU):
    """:class:`_LRU` + native hit/miss/eviction counters.

    Used only for the process-wide ``_GEO_CACHE``: that table is consulted
    on *first-level* cache misses, so the extra integer increments sit off
    the hot all-hits path.  The per-analyzer first-level caches stay plain
    ``_LRU`` — instrumenting them would tax every analyze call.  The obs
    layer harvests these through a collector at snapshot time; nothing
    here ever checks the ``REPRO_OBS`` switch.
    """

    __slots__ = ("hits", "misses", "evictions")

    def __init__(self, maxsize: int):
        super().__init__(maxsize)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        val = dict.get(self, key, _LRU._MISS)
        if val is _LRU._MISS:
            self.misses += 1
            return default
        self.hits += 1
        if len(self) * 2 >= self.maxsize:
            del self[key]
            dict.__setitem__(self, key, val)
        return val

    def put(self, key, value):
        if key not in self and len(self) >= self.maxsize:
            self.pop(next(iter(self)))
            self.evictions += 1
        self[key] = value
        return value


def _geo_cache_cap(default: int = 262_144) -> int:
    """Size cap of the process-wide geometry cache.

    Overridable via ``REPRO_GEO_CACHE_CAP`` (entries, not bytes) so
    memory-constrained sweeps can shrink it; evicted entries rebuild
    bit-identically (pure geometry), so the cap only trades memory for
    recompute time.
    """
    raw = os.environ.get("REPRO_GEO_CACHE_CAP", "")
    try:
        cap = int(raw)
    except ValueError:
        return default
    return cap if cap > 0 else default


# Process-wide second-level cache for PURE LAYER GEOMETRY artifacts (region
# tables, needed-ifmap rows, sibling labels, overlap counts, intra-core
# dataflow stats).  These depend only on frozen Layer content + Part (+ the
# few arch constants in their keys), never on the graph or the core
# binding, so every Analyzer shares one copy; the per-analyzer first-level
# caches keep the hot hit path on small-int keys.  Entries are read-only
# by contract; the reference's default cap bounds it, and an eviction only
# costs recompute time (the geometry rebuilds bit-identically).
_GEO_CACHE = _StatLRU(_geo_cache_cap())

# Batched-vs-scalar contribution construction counts: how much of the
# stream building went through the vectorized prefetch builders
# (``_prefetch_contribs``) vs the scalar fallbacks.  Native increments
# (one per *built* piece, i.e. per first-level cache miss), harvested by
# the obs collector below.
PREFETCH_STATS: Dict[str, int] = {
    "prefetch.batched_builds": 0,
    "prefetch.scalar_builds": 0,
}

_obs_metrics.register_collector(lambda: {
    "geo_cache.hits": _GEO_CACHE.hits,
    "geo_cache.misses": _GEO_CACHE.misses,
    "geo_cache.evictions": _GEO_CACHE.evictions,
    **PREFETCH_STATS,
})
_obs_metrics.register_collector(lambda: {
    "geo_cache.size": len(_GEO_CACHE),
    "geo_cache.cap": _GEO_CACHE.maxsize,
}, kind="gauge")


class Analyzer:
    """Stateful per-(arch, graph) analyzer; reused across SA iterations."""

    def __init__(self, arch: ArchConfig, g: Graph, cache_size: int = 50_000,
                 fused_device: str = "cuda"):
        self.arch = arch
        self.g = g
        # where analyze_requests(backend="fused") replays
        self.fused_device = fused_device
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
        self._regions_cache = _LRU(cache_size)
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
        self._row_cache = _LRU(cache_size)        # fused path: f32 row streams
        self._lmath_cache = _LRU(cache_size)      # per-layer value math (per Part)
        # pre-offset DRAM accumulator indices for the batched builders
        self._dram_iota = np.arange(nd, dtype=np.int64) + self._offsets[T_DRAM]
        self._dram_iota_am = np.arange(nd, dtype=np.int64) \
            + self._offsets[T_DRAM_AM]

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

    def _route_multicast(self, contrib: Contribution, target: int,
                         src_node: int, dst_nodes: Sequence[int],
                         vol: float) -> None:
        """One producer datum to many consumers: union of XY paths, counted once."""
        if vol <= 0 or not len(dst_nodes):
            return
        paths = self.grid.paths[src_node, np.asarray(dst_nodes, dtype=np.int64)]
        edges = np.unique(paths[paths >= 0])
        contrib.add(target, edges, vol)

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

    def regions(self, name: str, ms: MS, bu: int) -> Dict[int, Region]:
        key = (self._layer_idx[name], ms.geo, bu)
        hit = self._regions_cache.get(key)
        if hit is None:
            cores, rarr = self.region_table(name, ms, bu)
            hit = self._regions_cache.put(
                key, {c: Region(*row)
                      for c, row in zip(cores.tolist(), rarr.tolist())})
        return hit

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
        PREFETCH_STATS["prefetch.scalar_builds"] += 1
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
            PREFETCH_STATS["prefetch.scalar_builds"] += 1
            contrib = Contribution()
            self._dep_traffic(contrib, pname, pms, cname, cms, bu)
            hit = self._dep_cache.put(key, contrib.seal(self._offsets))
        return hit

    # -- batched construction (one vectorized pass over many cache misses) ----
    #
    # ``analyze_requests`` prefetches every contribution piece the batch
    # will need and builds the MISSING ones here, batched across requests:
    # ragged per-piece geometry is padded to rectangular index tables whose
    # pad cells are routed to provably-empty paths (the (n, n) diagonal /
    # self-routed pairs), so they emit no stream entries at all.  Per-piece
    # float reductions stay on exact per-piece slices — padding a float
    # reduction would change numpy's pairwise-summation tree.  The sealed
    # streams are BIT-IDENTICAL to the scalar builders' (same entries, same
    # order), which the scalar path remains the reference for.

    def _prefetch_contribs(self, requests: Sequence[Tuple[LayerGroup, LMS]],
                           total_batch: int) -> None:
        """Batch-build every layer/dependency piece the requests will miss."""
        layer_jobs: Dict[Tuple, Tuple] = {}
        dep_jobs: Dict[Tuple, Tuple] = {}
        for group, lms in requests:
            bu = group.batch_unit
            n_passes = max(1, -(-total_batch // bu))
            gid = self._group_ids.setdefault(group.names,
                                             len(self._group_ids))
            for name, internal_preds in self._group_topology(group):
                ms = lms.ms[name]
                lkey = (self._layer_idx[name], ms, bu, n_passes, gid)
                if lkey not in layer_jobs \
                        and self._layer_cache.get(lkey) is None:
                    layer_jobs[lkey] = (name, ms, bu, n_passes, group, gid)
                for p in internal_preds:
                    pms = lms.ms[p]
                    dkey = (self._layer_idx[p], pms.geo,
                            self._layer_idx[name], ms.geo, bu)
                    if dkey not in dep_jobs \
                            and self._dep_cache.get(dkey) is None:
                        dep_jobs[dkey] = (p, pms, name, ms, bu)
        if layer_jobs or dep_jobs:
            PREFETCH_STATS["prefetch.batched_builds"] \
                += len(layer_jobs) + len(dep_jobs)
        if layer_jobs:
            self._layer_contribs_batched(layer_jobs)
        if dep_jobs:
            self._dep_traffic_batched(dep_jobs)

    def _layer_math(self, name: str, part: Tuple[int, ...], bu: int,
                    n_passes: int) -> Dict[str, object]:
        """Per-layer value arrays depending only on (layer, Part, bu,
        n_passes) — computed with the scalar builder's exact pre-scale op
        sequence, so scale-1.0 jobs (the dense common case) reuse them
        verbatim and scaled jobs apply the same guarded multiplies the
        scalar path would."""
        key = (self._layer_idx[name], part, bu, n_passes)
        hit = self._lmath_cache.get(key)
        if hit is not None:
            return hit
        lyr = self.g.layers[name]
        # correspondence order — every array below is elementwise per
        # region row, so callers permute through their CG's sort order and
        # land on the exact values the scalar builder computes from the
        # sorted table (elementwise ops commute with permutation)
        rarr = self.region_geometry(name, part, bu)
        elems = (rarr[:, 1] - rarr[:, 0]) * (rarr[:, 3] - rarr[:, 2]) \
            * (rarr[:, 5] - rarr[:, 4]) * (rarr[:, 7] - rarr[:, 6])
        mac_per_elem = lyr.macs(1) / max(1, lyr.ofmap_elems)
        bpe = lyr.bytes_per_elem
        w_share = lyr.weight_bytes() / max(1, part[3]) if lyr.has_weight else 0
        fmap = elems * bpe * 2
        n = len(rarr)
        off_rw = self._offsets[T_GLB_RW]
        if lyr.has_weight:
            k_span = rarr[:, 7] - rarr[:, 6]
            w_core = k_span / max(1, lyr.K) * lyr.weight_bytes()
        else:
            w_core = None
        hit = {
            "macs": elems * mac_per_elem,
            "fmap": fmap,
            "w_share": w_share,
            # float64 up front: Contribution.add's dtype conversion is
            # value-exact, so pre-converting preserves bit-identity
            "glb1": np.asarray(fmap + w_share, dtype=np.float64),
            "rw0": np.full(n, off_rw, dtype=np.int64),
            "rw1": np.full(n, off_rw + 1, dtype=np.int64),
            "w_core": w_core,
            "if": np.asarray(self._external_ifmap_bytes(lyr, rarr, bu) * bpe,
                             dtype=np.float64),
            "of": np.asarray(elems * bpe, dtype=np.float64),
        }
        return self._lmath_cache.put(key, hit)

    def _layer_contribs_batched(self, jobs: Dict[Tuple, Tuple]) -> None:
        """Build many missing ``_layer_contribs`` pieces in one pass.

        Value math is memoized per (layer, Part, bu, passes) in
        ``_layer_math`` (the scalar builder's exact op sequence), every
        queued DRAM flow's XY-path gather runs as ONE fancy index into
        ``grid.paths``, and the sealed streams assemble as slices of one
        pooled (idx, vals) pair via ``from_flat`` — chunk content and
        order match the scalar add/seal output entry for entry.
        """
        offsets = self._offsets
        off_glb = offsets[T_GLB]
        off_time = offsets[T_CORE_TIME]
        off_in = offsets[T_CORE_IN]
        off_out = offsets[T_CORE_OUT]
        off_e = offsets[T_EDGE]
        off_eam = offsets[T_EDGE_AM]
        route_srcs: List[np.ndarray] = []
        route_dsts: List[np.ndarray] = []
        route_vols: List[np.ndarray] = []
        route_offs: List[int] = []

        def queue_route(chunks, eoff, srcs, dsts, vols):
            chunks.append(len(route_srcs))   # placeholder -> route id
            route_srcs.append(srcs)
            route_dsts.append(dsts)
            route_vols.append(vols)
            route_offs.append(eoff)

        def queue_dram_flow(chunks, eoff, diota, fd, nodes, vols, to_core):
            # mirrors _dram_flow exactly (vols arrive as float64 arrays);
            # the _route path gather is deferred to the bulk gather below
            if fd == 0:
                nd = self.arch.n_dram
                share = vols / nd
                dn = np.repeat(self._dram_nodes[:nd], len(nodes))
                cn = np.concatenate([nodes] * nd)
                sh = np.concatenate([share] * nd)
                if to_core:
                    queue_route(chunks, eoff, dn, cn, sh)
                else:
                    queue_route(chunks, eoff, cn, dn, sh)
                chunks.append((diota, np.full(nd, float(share.sum()))))
            else:
                d = fd - 1
                dn = np.full(len(nodes), self._dram_nodes[d])
                if to_core:
                    queue_route(chunks, eoff, dn, nodes, vols)
                else:
                    queue_route(chunks, eoff, nodes, dn, vols)
                chunks.append((diota[d:d + 1],
                               np.asarray([float(vols.sum())])))

        staged: List[Tuple[Tuple, List, List, float]] = []
        g = self.g
        for key, (name, ms, bu, n_passes, group, gid) in jobs.items():
            lyr = g.layers[name]
            cores, _, order = self._region_arrays(name, ms, bu)
            nodes = self._core_nodes[cores]
            m = self._layer_math(name, ms.part, bu, n_passes)
            ts = lyr.traffic_scale
            ws = lyr.weight_traffic_scale
            pre: List = []
            post: List = []
            weight_total = 0.0

            # cached arrays are correspondence-order; [order] lands on the
            # scalar builder's sorted-table values exactly
            pre.append((cores,
                        m["macs"][order] if ts == 1.0
                        else m["macs"][order] * ts))
            pre.append((cores + off_glb, m["glb1"][order] if ts == 1.0
                        else m["fmap"][order] * ts + m["w_share"]))
            t_arr, rd, wr = self._intra_geometry(name, ms.part, bu)
            if ts != 1.0:
                t_arr = t_arr * ts
                rd = rd * ts
                wr = wr * ts
            pre.append((np.asarray(ms.cg, dtype=np.int64) + off_time, t_arr))
            pre.append((m["rw0"], rd))
            pre.append((m["rw1"], wr))

            if lyr.has_weight:
                wc = m["w_core"][order]
                if ws != 1.0:
                    wc = wc * ws
                weight_total = float(wc.sum())
                queue_dram_flow(pre, off_eam, self._dram_iota_am, ms.fd[1],
                                nodes, wc / n_passes, to_core=True)

            preds = g.preds(name)
            in_group = group.names
            external = (not preds) or any(p not in in_group for p in preds)
            if external and ms.fd[0] >= 0:
                ifb = m["if"][order] if ts == 1.0 else m["if"][order] * ts
                queue_dram_flow(post, off_e, self._dram_iota, ms.fd[0],
                                nodes, ifb, to_core=True)
                post.append((cores + off_in, ifb))

            if ms.fd[2] >= 0:
                ofb = m["of"][order] if ts == 1.0 else m["of"][order] * ts
                queue_dram_flow(post, off_e, self._dram_iota, ms.fd[2],
                                nodes, ofb, to_core=False)
                post.append((cores + off_out, ofb))

            staged.append((key, pre, post, weight_total))

        # ONE bulk path gather over every queued flow of every job; the
        # per-target edge offsets ride along as a repeated offset vector,
        # so per-route chunks are pure slice views afterwards
        e_all = v_all = r_bounds = None
        if route_srcs:
            R = len(route_srcs)
            lens = np.fromiter((s.size for s in route_srcs), np.int64, R)
            roffs = np.concatenate(([0], np.cumsum(lens)))
            paths_all = self.grid.paths[np.concatenate(route_srcs),
                                        np.concatenate(route_dsts)]
            L = paths_all.shape[1]
            keep = paths_all >= 0
            per_route = np.add.reduceat(keep.sum(axis=1), roffs[:-1])
            flat_keep = keep.reshape(-1)
            e_all = paths_all.reshape(-1)[flat_keep] \
                + np.repeat(np.asarray(route_offs, dtype=np.int64), per_route)
            v_all = np.repeat(np.concatenate(route_vols), L)[flat_keep]
            r_bounds = np.concatenate(([0], np.cumsum(per_route)))

        ci: List[np.ndarray] = []
        cv: List[np.ndarray] = []

        def emit(chunks) -> int:
            n = 0
            for chunk in chunks:
                if type(chunk) is int:
                    s, e = r_bounds[chunk], r_bounds[chunk + 1]
                    ci.append(e_all[s:e])
                    cv.append(v_all[s:e])
                    n += int(e - s)
                else:
                    ci.append(chunk[0])
                    cv.append(chunk[1])
                    n += chunk[0].size
            return n

        spans: List[Tuple[Tuple, float, int, int]] = []
        for key, pre, post, weight_total in staged:
            n_pre = emit(pre)
            n_post = emit(post)
            spans.append((key, weight_total, n_pre, n_post))
        mega_i = np.concatenate(ci)
        mega_v = np.concatenate(cv)
        pos = 0
        for key, wt, n_pre, n_post in spans:
            mid = pos + n_pre
            end = mid + n_post
            self._layer_cache.put(
                key, (Contribution.from_flat(mega_i[pos:mid],
                                             mega_v[pos:mid], wt),
                      Contribution.from_flat(mega_i[mid:end],
                                             mega_v[mid:end])))
            pos = end

    # padded-volume cap per batched dependency chunk: bounds the peak
    # gather size (uint64 words / path cells) when jobs of very different
    # shapes co-occur; chunking changes nothing but peak memory
    _DEP_CHUNK_CELLS = 2_000_000

    def _dep_traffic_batched(self, jobs: Dict[Tuple, Tuple]) -> None:
        """Build many missing ``_dep_contrib`` pieces in one pass each for
        the contracting (multicast-grouped) and plain (unicast) families."""
        contracting: List[Tuple] = []
        plain: List[Tuple] = []
        for key, (pname, pms, cname, cms, bu) in jobs.items():
            prod, cons = self.g.layers[pname], self.g.layers[cname]
            ov_geo, any_ov = self._overlap_geometry(pname, pms.part, cname,
                                                    cms.part, bu, prod.K)
            if not any_ov:
                self._dep_cache.put(key, Contribution().seal(self._offsets))
                continue
            p_cores, _, p_ord = self._region_arrays(pname, pms, bu)
            c_cores, _, c_ord = self._region_arrays(cname, cms, bu)
            bpe = prod.bytes_per_elem
            escale = prod.traffic_scale * self.g.edge_mult(pname, cname)
            p_nodes = self._region_nodes(pname, pms, bu)
            c_nodes = self._region_nodes(cname, cms, bu)
            if cons.kind in ("conv", "fc", "matmul"):
                if self._path_bits is None:
                    # absurd grids fall back to the scalar sort-dedup path
                    contrib = Contribution()
                    self._dep_traffic(contrib, pname, pms, cname, cms, bu)
                    self._dep_cache.put(key, contrib.seal(self._offsets))
                    continue
                need, mc_first, mc_members, mc_cn, mc_live = \
                    self._need_arrays(cname, cms, bu, prod.K)
                contracting.append((key, ov_geo, p_ord, c_ord, p_cores,
                                    c_cores, p_nodes, bpe, escale, mc_first,
                                    mc_members, mc_cn, mc_live))
            else:
                plain.append((key, ov_geo, p_ord, c_ord, p_cores, c_cores,
                              p_nodes, c_nodes, bpe, escale))
        # pad jobs to chunk-max shapes: lockstep-iteration job shapes are
        # tiny (G*P is tens of cells), so padding waste is noise while the
        # chunk count — hence the numpy dispatch count, the actual cost on
        # these shapes — drops to O(1) per family per iteration
        W = self._path_bits.shape[2] if self._path_bits is not None else 1
        for chunk in _shape_chunks(
                contracting,
                lambda j: (len(j[9]), len(j[2]), max(1, j[10].shape[1]), W),
                self._DEP_CHUNK_CELLS):
            self._dep_contracting_chunk(chunk)
        L = self.grid.paths.shape[2]
        for chunk in _shape_chunks(plain,
                                   lambda j: (len(j[2]), len(j[3]), L),
                                   self._DEP_CHUNK_CELLS):
            self._dep_plain_chunk(chunk)

    def _dep_contracting_chunk(self, jobs: List[Tuple]) -> None:
        """Batched contracting-dependency construction (packed bitsets).

        Jobs pad to the chunk's max (G, P, Q).  Pad cells index row/col 0
        of the job's own pooled overlap block — in-bounds garbage — but
        are dead by construction: pad members carry a False live mask, pad
        producer columns get their volumes zeroed, so ``act`` is False and
        pads route to the empty ``(p, p)`` bitset diagonal, emitting no
        stream entries; the out/in value chunks slice exact (G, P[, Q])
        sub-blocks.  Every expensive stage — the bitset gather, the member
        OR-reduce, the unpack, the nonzero scan — runs ONCE per chunk, and
        per-job streams become slice views of one pooled (idx, vals) pair
        via ``from_flat``.
        """
        J = len(jobs)
        Gs = [len(j[9]) for j in jobs]
        Ps = [len(j[2]) for j in jobs]
        Qs = [j[10].shape[1] for j in jobs]
        Gm, Pm, Qm = max(Gs), max(Ps), max(max(Qs), 1)
        p_idx = np.zeros((J, Pm), dtype=np.int64)
        gfirst = np.zeros((J, Gm), dtype=np.int64)
        p_nodes_pad = np.zeros((J, Pm), dtype=np.int64)
        cn_pad = np.zeros((J, Gm, Qm), dtype=np.int64)
        live_pad = np.zeros((J, Gm, Qm), dtype=bool)
        scal = np.empty((J, 2), dtype=np.float64)
        sizes = np.fromiter((j[1].size for j in jobs), np.int64, J)
        offs = np.concatenate(([0], np.cumsum(sizes)))
        pool = np.concatenate([j[1].reshape(-1) for j in jobs])
        ncols = np.fromiter((j[1].shape[1] for j in jobs), np.int64, J)
        for jj, j in enumerate(jobs):
            G, P, Q = Gs[jj], Ps[jj], Qs[jj]
            p_idx[jj, :P] = j[2]
            gfirst[jj, :G] = j[3][j[9]]
            p_nodes_pad[jj, :P] = j[6]
            cn_pad[jj, :G, :Q] = j[11]
            live_pad[jj, :G, :Q] = j[12]
            scal[jj, 0] = j[7]
            scal[jj, 1] = j[8]
        flat_ov = offs[:-1, None, None] \
            + p_idx[:, :, None] * ncols[:, None, None] \
            + gfirst[:, None, :]                             # (J, Pm, Gm)
        vols = pool[flat_ov].transpose(0, 2, 1) * scal[:, :1, None]
        vols = vols * scal[:, 1:, None]                      # *1.0 bit-exact
        # zero pad producer columns: their garbage volumes must not trip
        # the (vols > 0) activity gate (real cells pass through verbatim)
        valid_p = np.arange(Pm)[None, :] < np.asarray(Ps)[:, None]
        vols = np.where(valid_p[:, None, :], vols, 0.0)      # (J, Gm, Pm)
        off_node = (p_nodes_pad[:, None, :, None] != cn_pad[:, :, None, :]) \
            & live_pad[:, :, None, :]                        # (J, G, P, Q)
        act = off_node & (vols > 0)[:, :, :, None]
        # Sparse union: gather path bitsets only at ACTIVE member cells
        # (typically <10% of the padded lattice), OR-reduce per (j, g, p)
        # row with reduceat, then unpack/scan only the surviving rows.
        # Inactive cells previously OR'd in the empty (p, p) diagonal —
        # the OR identity — so dropping them leaves every union word
        # bit-identical, and rows with no active member produce no stream
        # entries either way.
        flat_act = np.flatnonzero(act.reshape(-1))
        if flat_act.size:
            rowq, q_of = np.divmod(flat_act, Qm)             # row = (j,g,p)
            jj_of, gp_of = np.divmod(rowq, Gm * Pm)
            g_of, p_of = np.divmod(gp_of, Pm)
            srcs = p_nodes_pad.reshape(-1)[jj_of * Pm + p_of]
            dsts = cn_pad.reshape(-1)[(jj_of * Gm + g_of) * Qm + q_of]
            pb = self._path_bits[srcs, dsts]                 # (n_act, W)
            seg_starts = np.concatenate(
                ([0], np.flatnonzero(rowq[1:] != rowq[:-1]) + 1))
            union_small = np.bitwise_or.reduceat(pb, seg_starts, axis=0)
            live_rows = rowq[seg_starts]
            ub = np.unpackbits(union_small.view(np.uint8), axis=1,
                               bitorder="little")
            rr, e_idx = np.divmod(np.flatnonzero(ub.reshape(-1)), ub.shape[1])
            r_idx = live_rows[rr]
        else:
            r_idx = np.empty(0, dtype=np.int64)
            e_idx = np.empty(0, dtype=np.int64)
        off_e = self._offsets[T_EDGE]
        if off_e:
            e_idx = e_idx + off_e
        e_vals = vols.reshape(-1)[r_idx]
        bnd = np.searchsorted(r_idx, np.arange(1, J) * (Gm * Pm))
        starts = np.concatenate(([0], bnd))
        ends = np.concatenate((bnd, [len(r_idx)]))
        has_dst = off_node.any(axis=3)                       # (J, G, P)
        out_vals = vols * has_dst
        in_vals = vols[:, :, :, None] * act
        off_out = self._offsets[T_CORE_OUT]
        off_in = self._offsets[T_CORE_IN]
        ci: List[np.ndarray] = []
        cv: List[np.ndarray] = []
        lens: List[int] = []
        for jj, job in enumerate(jobs):
            G, P, Q = Gs[jj], Ps[jj], Qs[jj]
            p_cores, c_cores, members = job[4], job[5], job[10]
            s, e = starts[jj], ends[jj]
            ci.append(e_idx[s:e])
            cv.append(e_vals[s:e])
            ci.append(np.broadcast_to(p_cores + off_out, (G, P)).reshape(-1))
            cv.append(out_vals[jj, :G, :P].reshape(-1))
            ci.append(np.broadcast_to((c_cores + off_in)[members][:, None, :],
                                      (G, P, Q)).reshape(-1))
            cv.append(in_vals[jj, :G, :P, :Q].reshape(-1))
            lens.append(int(e - s) + G * P + G * P * Q)
        mega_i = np.concatenate(ci)
        mega_v = np.concatenate(cv)
        pos = 0
        for job, n in zip(jobs, lens):
            nxt = pos + n
            self._dep_cache.put(job[0], Contribution.from_flat(
                mega_i[pos:nxt], mega_v[pos:nxt]))
            pos = nxt

    def _dep_plain_chunk(self, jobs: List[Tuple]) -> None:
        """Batched non-contracting (unicast) dependency construction.

        Jobs pad to the chunk's max (P, Q); pad pairs self-route (dst :=
        src, whose path row is all ``-1``), so the keep mask drops them
        and pads emit no edge entries — their garbage volumes never
        surface, because the core in/out sums reduce exact per-job
        sub-block slices (padding a float reduction would change numpy's
        pairwise-summation tree).  One path gather + one keep scan per
        chunk; per-job streams are slice views of one pooled (idx, vals)
        pair via ``from_flat``.
        """
        J = len(jobs)
        Ps = [len(j[2]) for j in jobs]
        Qs = [len(j[3]) for j in jobs]
        Pm, Qm = max(Ps), max(Qs)
        p_idx = np.zeros((J, Pm), dtype=np.int64)
        c_idx = np.zeros((J, Qm), dtype=np.int64)
        p_nodes_pad = np.zeros((J, Pm), dtype=np.int64)
        c_nodes_pad = np.zeros((J, Qm), dtype=np.int64)
        scal = np.empty((J, 2), dtype=np.float64)
        sizes = np.fromiter((j[1].size for j in jobs), np.int64, J)
        offs = np.concatenate(([0], np.cumsum(sizes)))
        pool = np.concatenate([j[1].reshape(-1) for j in jobs])
        ncols = np.fromiter((j[1].shape[1] for j in jobs), np.int64, J)
        for jj, j in enumerate(jobs):
            P, Q = Ps[jj], Qs[jj]
            p_idx[jj, :P] = j[2]
            c_idx[jj, :Q] = j[3]
            p_nodes_pad[jj, :P] = j[6]
            c_nodes_pad[jj, :Q] = j[7]
            scal[jj, 0] = j[8]
            scal[jj, 1] = j[9]
        valid = (np.arange(Pm)[None, :, None] < np.asarray(Ps)[:, None, None]) \
            & (np.arange(Qm)[None, None, :] < np.asarray(Qs)[:, None, None])
        flat_ov = offs[:-1, None, None] \
            + p_idx[:, :, None] * ncols[:, None, None] \
            + c_idx[:, None, :]                              # (J, Pm, Qm)
        vols = pool[flat_ov].astype(float) * scal[:, :1, None]
        vols = vols * scal[:, 1:, None]                      # *1.0 bit-exact
        same = p_nodes_pad[:, :, None] == c_nodes_pad[:, None, :]
        vols_off = np.where(same, 0.0, vols)
        srcs = np.broadcast_to(p_nodes_pad[:, :, None], (J, Pm, Qm))
        dsts = np.where(valid,
                        np.broadcast_to(c_nodes_pad[:, None, :], (J, Pm, Qm)),
                        srcs)
        paths = self.grid.paths[srcs, dsts]                  # (J, Pm, Qm, L)
        L = paths.shape[3]
        flat = paths.reshape(J, -1)
        keep = flat >= 0
        e_all = flat[keep]
        off_e = self._offsets[T_EDGE]
        if off_e:
            e_all = e_all + off_e
        v_all = np.repeat(vols_off.reshape(J, -1), L, axis=1)[keep]
        cnt = keep.sum(axis=1)
        ends = np.cumsum(cnt)
        starts = ends - cnt
        off_out = self._offsets[T_CORE_OUT]
        off_in = self._offsets[T_CORE_IN]
        ci: List[np.ndarray] = []
        cv: List[np.ndarray] = []
        lens: List[int] = []
        for jj, job in enumerate(jobs):
            P, Q = Ps[jj], Qs[jj]
            s, e = starts[jj], ends[jj]
            vo = vols_off[jj, :P, :Q]
            ci.append(e_all[s:e])
            cv.append(v_all[s:e])
            ci.append(job[4] + off_out)
            cv.append(vo.sum(axis=1))
            ci.append(job[5] + off_in)
            cv.append(vo.sum(axis=0))
            lens.append(int(e - s) + P + Q)
        mega_i = np.concatenate(ci)
        mega_v = np.concatenate(cv)
        pos = 0
        for job, n in zip(jobs, lens):
            nxt = pos + n
            self._dep_cache.put(job[0], Contribution.from_flat(
                mega_i[pos:nxt], mega_v[pos:nxt]))
            pos = nxt

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

    def analyze_requests(self, requests: Sequence[Tuple[LayerGroup, LMS]],
                         total_batch: int,
                         backend: str = "numpy") -> GroupAnalysisBatch:
        """Analyze a mixed batch of (group, lms) requests in ONE replay.

        Row ``b`` of the result is bit-identical to
        ``analyze(requests[b][0], requests[b][1], total_batch)``: every
        request's contribution chunks are gathered in the scalar order,
        offset into its own ``buf_len`` window of one flat
        ``(B * buf_len,)`` buffer, and the whole batch replays through one
        ``np.bincount`` — rows never share a cell and per-row add order is
        the concatenation order, so the float-add sequence of each row is
        exactly the scalar one.  Requests may mix layer groups (the buffer
        layout is per-arch, shared by all groups), which is what lets the
        lockstep SA evaluate one whole iteration in a single pass.

        ``backend="fused"`` (the reference's ``"jax"``) replays on the
        analyzer's ``fused_device`` through the ``segment_replay`` kernel
        instead (:func:`_fused_replay`).  The kernel adds each cell's
        entries in stream order too, so its rows equal the numpy
        backend's bit for bit; it is not the default.
        """
        if backend not in ("numpy", "fused"):
            raise ValueError(f"unknown analyze batch backend {backend!r}")
        B = len(requests)
        idx, vals, weight_totals = self._request_streams(requests,
                                                         total_batch)
        if idx.size:
            if backend == "fused":
                buf = _fused_replay(idx, vals, B * self._buf_len,
                                    self.fused_device)
            else:
                buf = np.bincount(idx, weights=vals,
                                  minlength=B * self._buf_len)
        else:
            buf = np.zeros(B * self._buf_len)
        buf2 = buf.reshape(B, self._buf_len)
        analyses = [self._wrap_analysis(buf2[b], group, lms,
                                        group.batch_unit,
                                        float(weight_totals[b]))
                    for b, (group, lms) in enumerate(requests)]
        return GroupAnalysisBatch(analyses=analyses, buf=buf2,
                                  layout=self._layout,
                                  weight_totals=weight_totals)

    def _request_streams(self, requests: Sequence[Tuple[LayerGroup, LMS]],
                         total_batch: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A batch's replay stream: (int64 idx, row ``b``'s cells offset by
        ``b * buf_len``; float64 vals; per-row weight-DRAM totals), every
        request's chunks in the scalar gather order.  Every cache-missing
        piece is built first, batched across the whole request list (the
        batched builders seal bit-identical streams, so this is a pure
        construction-cost optimization)."""
        self._prefetch_contribs(requests, total_batch)
        chunks_i: List[np.ndarray] = []
        chunks_v: List[np.ndarray] = []
        bases: List[int] = []
        weight_totals = np.empty(len(requests))
        for b, (group, lms) in enumerate(requests):
            bu = group.batch_unit
            n_passes = max(1, -(-total_batch // bu))
            gid = self._group_ids.setdefault(group.names,
                                             len(self._group_ids))
            n0 = len(chunks_i)
            weight_totals[b] = self._gather_stream(group, lms, bu, n_passes,
                                                   gid, chunks_i, chunks_v)
            bases.extend([b * self._buf_len] * (len(chunks_i) - n0))
        if not chunks_i:
            return (np.empty(0, np.int64), np.empty(0), weight_totals)
        idx = np.concatenate(chunks_i)
        lens = np.fromiter((c.size for c in chunks_i), np.int64,
                           len(chunks_i))
        idx += np.repeat(np.asarray(bases, dtype=np.int64), lens)
        return idx, np.concatenate(chunks_v), weight_totals

    def row_stream(self, group: LayerGroup, lms: LMS, total_batch: int
                   ) -> Tuple[np.ndarray, np.ndarray, float]:
        """One request row's full contribution stream, downcast for the
        fused pass: (int32 idx, float32 vals, weight_total).

        The stream is the same canonical gather order the exact replay
        uses; the downcast (and the fused kernel's order of summation) is
        why the fused path is parity-grade, never bit-exact.  Cached per
        (group, mapping, pass count) so lockstep SA pays construction
        once per novel proposal.
        """
        bu = group.batch_unit
        n_passes = max(1, -(-total_batch // bu))
        gid = self._group_ids.setdefault(group.names, len(self._group_ids))
        key = (gid, lms.cache_key(), bu, n_passes)
        hit = self._row_cache.get(key)
        if hit is None:
            chunks_i: List[np.ndarray] = []
            chunks_v: List[np.ndarray] = []
            wt = self._gather_stream(group, lms, bu, n_passes, gid,
                                     chunks_i, chunks_v)
            if chunks_i:
                idx = np.concatenate(chunks_i).astype(np.int32)
                vals = np.concatenate(chunks_v).astype(np.float32)
            else:
                idx = np.empty(0, np.int32)
                vals = np.empty(0, np.float32)
            hit = self._row_cache.put(key, (idx, vals, wt))
        return hit

    def analyze_batch(self, group: LayerGroup,
                      lms_batch: "Union[Sequence[LMS], LMSBatch]",
                      total_batch: int,
                      backend: str = "numpy") -> GroupAnalysisBatch:
        """Analyze B mappings of ONE layer group in a single replay pass
        (:meth:`analyze_requests` with a constant group; accepts either a
        sequence of ``LMS`` or a packed SoA :class:`LMSBatch`)."""
        if isinstance(lms_batch, LMSBatch):
            lms_list: Sequence[LMS] = unpack_lms_batch(lms_batch)
        else:
            lms_list = list(lms_batch)
        return self.analyze_requests([(group, lms) for lms in lms_list],
                                     total_batch, backend=backend)

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


def d2d_hop_stats(arch: ArchConfig, analyses: Sequence[GroupAnalysis]) -> Dict[str, float]:
    """Totals used by the Fig. 9 style reporting."""
    grid = router_grid(arch)
    tot = sum(float(a.edge_bytes.sum()) for a in analyses)
    d2d = sum(float(a.edge_bytes[grid.edge_is_d2d].sum()) for a in analyses)
    return {"total_hop_bytes": tot, "d2d_hop_bytes": d2d,
            "d2d_fraction": d2d / tot if tot else 0.0}
