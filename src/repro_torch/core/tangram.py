"""Stripe-based heuristic LP SPM (the paper's baseline, "T-Map").

Tangram-style: each layer of a group gets a *contiguous rectangle* of cores,
sized proportionally to its MAC share; the layer's ofmap is partitioned over
the rectangle along spatial dims (H across rectangle rows, W/K across
columns).  FDs are interleaved (0) wherever explicit.  This is also the SA
engine's initial scheme (paper Sec. V-B1).

Copy of ``src/repro/core/tangram.py``, whole.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .encoding import LMS, MS, default_fd
from .hw import ArchConfig
from .workload import Graph, LayerGroup


def _rect_cores(arch: ArchConfig, x0: int, x1: int) -> List[int]:
    """Cores of the column stripe [x0, x1), row-major, snake order."""
    out: List[int] = []
    for y in range(arch.y_cores):
        cols = range(x0, x1) if y % 2 == 0 else range(x1 - 1, x0 - 1, -1)
        for x in cols:
            out.append(y * arch.x_cores + x)
    return out


def _best_2d_part(n: int, dims: Tuple[int, int, int, int]) -> Tuple[int, int, int, int]:
    """Deterministic near-square factorization of n over (H, W, B, K)."""
    H, W, B, K = dims
    best = None
    for ph in range(1, min(n, H) + 1):
        if n % ph:
            continue
        rest = n // ph
        for pk in range(1, min(rest, K) + 1):
            if rest % pk:
                continue
            rest2 = rest // pk
            for pb in range(1, min(rest2, B) + 1):
                if rest2 % pb:
                    continue
                pw = rest2 // pb
                if pw > W:
                    continue
                # prefer balanced spatial/channel splits
                score = abs(ph - pk) + pw + pb
                if best is None or score < best[0]:
                    best = (score, (ph, pw, pb, pk))
    if best is None:
        raise ValueError(f"no factorization of {n} over {dims}")
    return best[1]


def stripe_lms(group: LayerGroup, g: Graph, arch: ArchConfig,
               n_dram: int) -> LMS:
    """Allocate column stripes proportional to MACs; partition inside each."""
    names = list(group.names)
    # expected MACs: a routed MoE expert at top_k/E share gets a
    # proportionally thinner stripe (dense layers see the exact old ints)
    macs = np.array([max(1, g.layers[n].expected_macs(group.batch_unit))
                     for n in names], dtype=float)
    share = macs / macs.sum()
    # stripe widths in columns, each layer >= 1 column, total == x_cores
    X = arch.x_cores
    if len(names) > X:
        # fall back to core-level stripes over the flattened snake order
        return _core_stripe_lms(group, g, arch, n_dram)
    cols = np.maximum(1, np.floor(share * X).astype(int))
    while cols.sum() > X:
        cols[int(np.argmax(cols))] -= 1
    while cols.sum() < X:
        cols[int(np.argmax(share - cols / X))] += 1
    ms: Dict[str, MS] = {}
    x0 = 0
    for name, w in zip(names, cols):
        lyr = g.layers[name]
        cores = _rect_cores(arch, x0, x0 + int(w))
        x0 += int(w)
        nc = len(cores)
        dims = (lyr.H, lyr.W, group.batch_unit, lyr.K)
        nc_eff = nc
        while nc_eff > 1:
            try:
                part = _best_2d_part(nc_eff, dims)
                break
            except ValueError:
                nc_eff -= 1
        else:
            part = (1, 1, 1, 1)
        ms[name] = MS(part=part, cg=tuple(cores[:int(np.prod(part))]),
                      fd=default_fd(lyr, g, group, n_dram))
    return LMS(ms=ms)


def _core_stripe_lms(group: LayerGroup, g: Graph, arch: ArchConfig,
                     n_dram: int) -> LMS:
    """Stripe at core granularity when there are more layers than columns."""
    names = list(group.names)
    # expected MACs: a routed MoE expert at top_k/E share gets a
    # proportionally thinner stripe (dense layers see the exact old ints)
    macs = np.array([max(1, g.layers[n].expected_macs(group.batch_unit))
                     for n in names], dtype=float)
    share = macs / macs.sum()
    M = arch.n_cores
    sizes = np.maximum(1, np.floor(share * M).astype(int))
    while sizes.sum() > M:
        sizes[int(np.argmax(sizes))] -= 1
    while sizes.sum() < M:
        sizes[int(np.argmax(share - sizes / M))] += 1
    snake = _rect_cores(arch, 0, arch.x_cores)
    ms: Dict[str, MS] = {}
    off = 0
    for name, nc in zip(names, sizes):
        lyr = g.layers[name]
        cores = snake[off:off + int(nc)]
        off += int(nc)
        dims = (lyr.H, lyr.W, group.batch_unit, lyr.K)
        nc_eff = len(cores)
        while nc_eff > 1:
            try:
                part = _best_2d_part(nc_eff, dims)
                break
            except ValueError:
                nc_eff -= 1
        else:
            part = (1, 1, 1, 1)
        ms[name] = MS(part=part, cg=tuple(cores[:int(np.prod(part))]),
                      fd=default_fd(lyr, g, group, n_dram))
    return LMS(ms=ms)


def tangram_map(groups: Sequence[LayerGroup], g: Graph,
                arch: ArchConfig) -> List[Tuple[LayerGroup, LMS]]:
    """T-Map for a whole partitioned DNN."""
    return [(grp, stripe_lms(grp, g, arch, arch.n_dram)) for grp in groups]
