"""Workload IR: DNN layers as a DAG with 4-D ofmap cubes (paper Sec. IV).

Reduced copy of ``src/repro/core/workload.py``: ``Layer`` (with the
per-sample sizes the cost model reads), ``Graph`` (with ``edge_mult`` and
``is_scaled``), ``LayerGroup``, ``dense_twin`` (``:250``) and
``edge_volume`` (``:285``), with the same class names, field order and
defaults.  Expected-traffic scales of 1.0 leave every size the exact int
of the dense model, as in the reference.  The
checkpoint header's graph fingerprint hashes ``repr(Layer)``
(:func:`repro_torch.core.explore.graph_fingerprint`), so the dataclass
fields, their order, defaults and ``repr`` flags must stay as they are in
the reference for a port-built graph to match a reference checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Sequence, Tuple, Union

LayerKind = str  # conv | fc | pool | eltwise | matmul | depthwise

# an edge input to Graph.add: a producer name, optionally with an
# expected-traffic multiplicity on the producer->consumer transfer
EdgeInput = Union[str, Tuple[str, float]]


@dataclass(frozen=True)
class Layer:
    """One DAG node.  Dims are per *sample*; B is filled by the batch unit."""
    name: str
    kind: LayerKind
    K: int                  # ofmap channels
    H: int = 1              # ofmap height (sequence length for LM layers)
    W: int = 1              # ofmap width
    C: int = 0              # contraction channels (0 for eltwise/pool)
    R: int = 1              # kernel height
    S: int = 1              # kernel width
    stride: int = 1
    groups: int = 1                 # grouped conv (ResNeXt); C is per-layer total
    bytes_per_elem: int = 1         # int8 inference default
    n_inputs: int = 1               # eltwise add has 2
    # expected-traffic scales; repr=False keeps dense fingerprints equal
    # to the reference's
    traffic_scale: float = field(default=1.0, repr=False)
    weight_traffic_scale: float = field(default=1.0, repr=False)

    def __post_init__(self):
        if self.K <= 0 or self.H <= 0 or self.W <= 0:
            raise ValueError(f"bad ofmap dims for {self.name}")
        if self.traffic_scale <= 0 or self.weight_traffic_scale <= 0:
            raise ValueError(
                f"{self.name}: expected-traffic scales must be > 0 "
                f"(traffic_scale={self.traffic_scale}, "
                f"weight_traffic_scale={self.weight_traffic_scale})")

    # -- sizes per sample, in elements ---------------------------------------
    @property
    def has_weight(self) -> bool:
        return self.kind in ("conv", "fc", "depthwise")

    @property
    def is_scaled(self) -> bool:
        return self.traffic_scale != 1.0 or self.weight_traffic_scale != 1.0

    @property
    def ofmap_elems(self) -> int:
        return self.K * self.H * self.W

    @property
    def ifmap_elems(self) -> int:
        if self.kind in ("eltwise",):
            return self.ofmap_elems * self.n_inputs
        if self.kind == "pool":
            return self.K * self.H * self.stride * self.W * self.stride
        if self.kind == "depthwise":
            return self.K * self.H * self.stride * self.W * self.stride
        if self.kind == "matmul":
            # ifmap = (H x C) activations; "weight-side" = (C x K) activations
            return self.H * self.C + self.C * self.K
        return self.C * self.H * self.stride * self.W * self.stride

    @property
    def weight_elems(self) -> int:
        if self.kind == "conv":
            return self.K * (self.C // self.groups) * self.R * self.S
        if self.kind == "fc":
            return self.K * self.C
        if self.kind == "depthwise":
            return self.K * self.R * self.S
        return 0

    def macs(self, batch: int = 1) -> int:
        """Multiply-accumulates per ``batch`` samples (dense)."""
        if self.kind in ("conv",):
            m = self.K * self.H * self.W * (self.C // self.groups) * self.R * self.S
        elif self.kind == "fc":
            m = self.K * self.H * self.W * self.C
        elif self.kind == "matmul":
            m = self.H * self.K * self.C
        elif self.kind == "depthwise":
            m = self.K * self.H * self.W * self.R * self.S
        elif self.kind == "pool":
            m = self.K * self.H * self.W * self.stride * self.stride
        else:  # eltwise
            m = self.ofmap_elems * self.n_inputs
        return m * batch

    def ofmap_bytes(self, batch: int = 1) -> int:
        return self.ofmap_elems * self.bytes_per_elem * batch

    def weight_bytes(self) -> int:
        return self.weight_elems * self.bytes_per_elem


@dataclass
class Graph:
    """DNN DAG.  Edges carry producer->consumer feature-map dependencies;
    an entry in ``edge_mults`` multiplies the expected traffic of that edge
    (absent == 1.0, the dense transfer)."""
    name: str
    layers: Dict[str, Layer] = field(default_factory=dict)
    edges: List[Tuple[str, str]] = field(default_factory=list)
    # graph inputs: layers whose ifmaps come from DRAM (the DNN input)
    input_layers: List[str] = field(default_factory=list)
    edge_mults: Dict[Tuple[str, str], float] = field(default_factory=dict)

    def add(self, layer: Layer, inputs: Sequence[EdgeInput] = ()) -> Layer:
        if layer.name in self.layers:
            raise ValueError(f"duplicate layer {layer.name}")
        parsed = []
        for item in inputs:                    # validate BEFORE mutating
            src, mult = item if isinstance(item, tuple) else (item, 1.0)
            if src not in self.layers:
                raise ValueError(f"unknown input {src} for {layer.name}")
            if mult <= 0:
                raise ValueError(
                    f"edge {src}->{layer.name}: multiplicity must be "
                    f"> 0, got {mult}")
            parsed.append((src, mult))
        self.layers[layer.name] = layer
        for src, mult in parsed:
            self.edges.append((src, layer.name))
            if mult != 1.0:
                self.edge_mults[(src, layer.name)] = float(mult)
        if not inputs:
            self.input_layers.append(layer.name)
        return layer

    def preds(self, name: str) -> List[str]:
        return [s for s, d in self.edges if d == name]

    def succs(self, name: str) -> List[str]:
        return [d for s, d in self.edges if s == name]

    def edge_mult(self, src: str, dst: str) -> float:
        """Expected-traffic multiplicity of one edge (1.0 == dense)."""
        return self.edge_mults.get((src, dst), 1.0)

    @property
    def is_scaled(self) -> bool:
        """True when any expected-traffic scale or multiplicity != 1.0."""
        return bool(self.edge_mults) \
            or any(l.is_scaled for l in self.layers.values())

    def topo_order(self) -> List[str]:
        indeg = {n: 0 for n in self.layers}
        for _, d in self.edges:
            indeg[d] += 1
        frontier = [n for n in self.layers if indeg[n] == 0]
        out: List[str] = []
        while frontier:
            n = frontier.pop(0)
            out.append(n)
            for d in self.succs(n):
                indeg[d] -= 1
                if indeg[d] == 0:
                    frontier.append(d)
        if len(out) != len(self.layers):
            raise ValueError(f"cycle in graph {self.name}")
        return out

    def validate(self) -> None:
        self.topo_order()
        edge_set = set(self.edges)
        for s, d in self.edges:
            if s not in self.layers or d not in self.layers:
                raise ValueError(f"dangling edge {s}->{d}")
        for (s, d), m in self.edge_mults.items():
            if (s, d) not in edge_set:
                raise ValueError(f"multiplicity on non-edge {s}->{d}")
            if m <= 0:
                raise ValueError(f"edge {s}->{d}: multiplicity {m} <= 0")


def dense_twin(g: Graph) -> Graph:
    """The same DAG with every expected-traffic scale/multiplicity reset to
    1.0.  Returns ``g`` itself when it is already dense (no copy, so
    dense-path callers stay bit-identical and allocation-free).  The
    measured report recovers per-axis expected-traffic factors from this
    twin's predictions (:mod:`repro_torch.realize.measure`)."""
    if not g.is_scaled:
        return g
    out = Graph(g.name)
    out.layers = {
        n: (replace(l, traffic_scale=1.0, weight_traffic_scale=1.0)
            if l.is_scaled else l)
        for n, l in g.layers.items()}
    out.edges = list(g.edges)
    out.input_layers = list(g.input_layers)
    return out


@dataclass(frozen=True)
class LayerGroup:
    """A contiguous-in-topo-order set of layers pipelined together."""
    names: Tuple[str, ...]
    batch_unit: int = 1          # samples processed per pipeline pass

    def __len__(self) -> int:
        return len(self.names)


def edge_volume(g: Graph, src: str, dst: str,
                batch: int = 1) -> Union[int, float]:
    """Expected bytes of feature map flowing src->dst per ``batch`` samples:
    the producer's dense ofmap, scaled by its ``traffic_scale`` and the
    edge's multiplicity.  Dense graphs return the exact int of the
    static-volume model."""
    l = g.layers[src]
    v = l.ofmap_bytes(batch)
    m = l.traffic_scale * g.edge_mult(src, dst)
    return v if m == 1.0 else v * m
