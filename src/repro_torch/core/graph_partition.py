"""DP-based graph partition into layer groups (Tangram-style, paper Sec. V-B).

The DAG is linearized topologically; a dynamic program over the linear order
chooses segment boundaries.  Segment cost is a fast proxy (the full mapping
engine runs afterwards per group): DRAM traffic saved by keeping dependencies
on-chip vs. pipeline fill/drain loss and GLB pressure.  The DP also picks the
``batch_unit`` per group — the largest power of two whose footprint fits the
aggregate GLB (the paper inherits this from Tangram).

Copy of ``src/repro/core/graph_partition.py``, whole.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .hw import ArchConfig
from .workload import Graph, LayerGroup, edge_volume


def pick_batch_unit(g: Graph, names: Sequence[str], arch: ArchConfig,
                    total_batch: int, max_unit: int = 64) -> int:
    """Largest power-of-two batch unit whose fmap footprint fits aggregate GLB.

    Feature-map footprints use the *expected* ofmap volume (a routed MoE
    expert holds its expected token share resident); weights stay dense —
    the full weight slice must be resident regardless of routing.  Dense
    graphs see the exact integer arithmetic of the static-volume model.
    """
    glb_total = arch.core_glb_bytes * arch.n_cores
    weights = sum(g.layers[n].weight_bytes() for n in names)
    fmaps_1 = sum(g.layers[n].expected_ofmap_bytes(1) * 2 for n in names)
    bu = 1
    while (bu * 2 <= min(total_batch, max_unit)
           and weights + fmaps_1 * bu * 2 <= glb_total):
        bu *= 2
    return bu


def _segment_cost(g: Graph, names: Sequence[str], arch: ArchConfig,
                  total_batch: int) -> float:
    """Proxy cost of one candidate group: DRAM bytes + fill/drain penalty."""
    sset = set(names)
    bu = pick_batch_unit(g, names, arch, total_batch)
    n_passes = max(1, -(-total_batch // bu))
    # DRAM traffic: group-boundary fmaps (in and out) + weights once.
    # Boundary transfers go through edge_volume — the expected-traffic
    # volume (producer traffic_scale x edge multiplicity); graph-input
    # fetches scale by the consumer's traffic_scale; weight loads by
    # weight_traffic_scale.  All guards reduce to the exact dense integer
    # sums when no scale is set.
    boundary = 0
    for s, d in g.edges:
        if (s in sset) != (d in sset):
            boundary += edge_volume(g, s, d, total_batch)
    for n in names:
        preds = g.preds(n)
        if not preds and n in sset:
            lyr = g.layers[n]
            fetch = lyr.ifmap_elems * lyr.bytes_per_elem * total_batch
            if lyr.traffic_scale != 1.0:
                fetch = fetch * lyr.traffic_scale
            boundary += fetch
    weights = sum(g.layers[n].expected_weight_bytes() for n in names)
    dram = boundary + weights
    # fill/drain loss: depth extra passes, scaled by per-pass work share
    depth = len(names)
    work = sum(g.layers[n].expected_macs(bu) for n in names)
    fill = work * (depth - 1) / max(1, n_passes) / max(1, arch.n_cores)
    # GLB overcommit pressure (expected-resident fmaps, dense weights)
    glb_total = arch.core_glb_bytes * arch.n_cores
    dense_weights = sum(g.layers[n].weight_bytes() for n in names)
    foot = dense_weights \
        + sum(g.layers[n].expected_ofmap_bytes(bu) * 2 for n in names)
    pressure = max(0.0, foot - glb_total) * 4.0
    # core starvation: fewer cores than layers is infeasible
    if len(names) > arch.n_cores:
        return float("inf")
    return dram + fill * 0.05 + pressure


def partition_graph(g: Graph, arch: ArchConfig, total_batch: int,
                    max_group: int = 12) -> List[LayerGroup]:
    """DP over the topological linearization; returns layer groups in order."""
    order = g.topo_order()
    n = len(order)
    INF = float("inf")
    best = [INF] * (n + 1)
    best[0] = 0.0
    choice = [0] * (n + 1)
    for j in range(1, n + 1):
        for i in range(max(0, j - max_group), j):
            seg = order[i:j]
            c = best[i] + _segment_cost(g, seg, arch, total_batch)
            if c < best[j]:
                best[j] = c
                choice[j] = i
    # backtrack
    cuts: List[Tuple[int, int]] = []
    j = n
    while j > 0:
        i = choice[j]
        cuts.append((i, j))
        j = i
    cuts.reverse()
    groups: List[LayerGroup] = []
    for i, j in cuts:
        names = tuple(order[i:j])
        bu = pick_batch_unit(g, names, arch, total_batch)
        groups.append(LayerGroup(names=names, batch_unit=bu))
    return groups
