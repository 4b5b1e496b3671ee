"""MeshPlan -> per-stage PyTorch programs on one card (realization stage 2).

Port of ``src/repro/realize/program.py``.  Each plan stage becomes one
eager stage function that runs on the one device:

* ``fc``/``matmul`` layers run the tiled GEMM (:func:`..kernels.ops.matmul`),
  detected (qk, av) score/context pairs run flash attention (the score
  matrix is never materialized), ``*_ssd`` layers run the chunked SSD
  (:func:`..kernels.ops.ssd_forward`, one ``ssd_chunk_dual`` and one
  ``ssd_state_pass`` launch per layer), eltwise layers are adds.  With
  ``use_kernels=False`` the same program routes through the plain versions
  of :mod:`..kernels.ref` (the parity target).  On a CPU device the kernel
  wrappers run those plain versions too.
* Operands whose producers live outside the stage arrive as arguments.
  Where an abstract Gemini operand has no exact runtime tensor (a matmul's
  weight-side activations) it is derived from the producer's output by
  :func:`_fit` (``jnp.resize`` semantics), so the contraction sizes the
  cost model priced are kept.  Operand, source and weight derivation follow
  the reference line for line.
* The reference shards each stage over a device mesh built from the
  dominant layer's ``Part`` and ``CG``.  On one card that mesh is a
  *logical* (ph, pw, pb, pk) grid of Gemini core ids: it places nothing,
  and serves only to bill inter-stage (DCI) traffic.  An input cube is
  billed when the slices its producer's grid puts on each core differ from
  the consumer's (:func:`cube_layout`), the logical analogue of the
  reference's ``NamedSharding.is_equivalent_to`` test.
* Expected-traffic graphs (routed MoE: ``graph.is_scaled``) lower to their
  dense-equivalent programs, as in the reference: every expert branch runs
  its full cube (an fc layer takes its first in-stage predecessor as the
  activation operand; the router edges only model traffic) and the combine
  sums every expert's output.  The expected-traffic correction happens on
  the measured side (``measure.py``'s dense-twin factors).
* A conv with a kernel window (R·S > 1) or groups (groups > 1) has no
  route: the ``matmul`` route contracts the activation's C columns, not
  the ``C/groups·R·S`` rows of its weight, and the reference fails on it
  the same way deep in a shape error (``src/repro/realize/program.py:292,
  366``).  :func:`build_program` refuses such a layer up front.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.bridge import MeshPlan, StagePlan
from ..core.workload import Graph, Layer
from ..kernels import ops, ref

STAGE_AXES = ("h", "w", "b", "k")
# cube dim order (B, H, W, K) -> grid axis carrying it
CUBE_DIM_AXES = ("b", "h", "w", "k")

Slices = Tuple[Tuple[int, int], ...]
Layout = Tuple[Tuple[int, Slices], ...]


def cube_layout(shape: Tuple[int, ...], part: Tuple[int, int, int, int],
                cores: Sequence[int]) -> Layout:
    """``(core, index slices)`` of every position of a logical stage grid.

    ``part = (ph, pw, pb, pk)`` and ``cores`` (row-major over (h, w, b, k),
    the Correspondence Rule) describe the grid.  A cube dim is split over
    its grid axis only when the axis has more than one part and divides the
    dim evenly (the reference's ``cube_spec_for``); otherwise every core
    holds the whole dim.  Two layouts are equal exactly when the same cores,
    in the same grid order, hold the same slices, which is the condition
    under which the reference's ``is_equivalent_to`` moves nothing.
    """
    sizes = dict(zip(STAGE_AXES, part))
    out = []
    for pos, core in enumerate(cores):
        coord: Dict[str, int] = {}
        rem = pos
        for ax in reversed(STAGE_AXES):
            rem, coord[ax] = divmod(rem, sizes[ax])
        slices = []
        for dim, ax in zip(shape, CUBE_DIM_AXES):
            n = sizes[ax]
            if n > 1 and dim % n == 0:
                step = dim // n
                slices.append((coord[ax] * step, (coord[ax] + 1) * step))
            else:
                slices.append((0, dim))
        out.append((core, tuple(slices)))
    return tuple(out)


def _fit(x: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``jnp.resize`` of ``x`` (as f32) onto ``shape``: flatten, repeat
    cyclically, truncate."""
    flat = x.reshape(-1).float()
    n = math.prod(shape)
    if flat.numel() < n:
        flat = flat.repeat(-(-n // flat.numel()))
    return flat[:n].reshape(shape)


def _cube(layer: Layer, bu: int) -> Tuple[int, int, int, int]:
    return (bu, layer.H, layer.W, layer.K)


def _heads_for(d: int) -> Tuple[int, int]:
    """(heads, head_dim) factorization of a model width."""
    for hd in (128, 64, 32):
        if d % hd == 0:
            return d // hd, hd
    return 1, d


def _ssd_dims(lyr: Layer) -> Tuple[int, int, int, int]:
    """(heads, head dim, chunk, state width N) of an ``*_ssd`` layer's
    chunked SSD, by the reference's rules."""
    heads, hd = _heads_for(lyr.K)
    return heads, hd, min(128, lyr.H), max(16, min(64, lyr.C))


def _route_layers(g: Graph, st: StagePlan) -> Dict[str, str]:
    """layer -> route tag.  Attention (qk, av) pairs fuse into one flash
    call at the av layer's position when the scores layer has no other
    consumer (flash never materializes the score matrix)."""
    routes: Dict[str, str] = {}
    in_stage = set(st.layers)
    for name in st.layers:
        lyr = g.layers[name]
        if lyr.kind == "eltwise":
            routes[name] = "add"
        elif lyr.kind in ("pool", "depthwise"):
            routes[name] = "jnp"
        elif lyr.kind == "matmul" and name.endswith("_ssd"):
            routes[name] = "ssd"
        else:
            routes[name] = "matmul"
    for name in st.layers:
        lyr = g.layers[name]
        if lyr.kind != "matmul" or lyr.K != lyr.H:
            continue                       # not a square score matrix
        succs = g.succs(name)
        if len(succs) != 1 or succs[0] not in in_stage:
            continue
        av = succs[0]
        av_l = g.layers[av]
        if av_l.kind != "matmul" or av_l.C != lyr.K:
            continue                       # consumer doesn't contract scores
        routes[name] = f"flash-scores:{av}"
        routes[av] = f"flash:{name}"
    return routes


@dataclass
class StageProgram:
    index: int
    stage: StagePlan
    part: Tuple[int, int, int, int]    # logical grid (ph, pw, pb, pk)
    cores: Tuple[int, ...]             # Gemini core ids in grid order
    routes: Dict[str, str]
    ext_inputs: Tuple[str, ...]        # producer layers feeding this stage
    src_inputs: Tuple[str, ...]        # graph-input layers synthesized here
    out_layers: Tuple[str, ...]        # cubes later stages / callers need
    # argument shapes: ext cubes, then source-layer ifmaps, then weights
    arg_shapes: List[Tuple[int, ...]] = field(default_factory=list)
    # kernel launches of one run: (kernel name, shape), from the plan
    launches: List[Tuple[str, Dict[str, int]]] = field(default_factory=list)
    fn: Callable = None

    @property
    def n_devices(self) -> int:
        return len(self.cores)

    def layout(self, shape: Tuple[int, ...]) -> Layout:
        return cube_layout(shape, self.part, self.cores)


def draw_stage_arrays(prog: "RealizedProgram", seed: int
                      ) -> List[List[np.ndarray]]:
    """Source ifmaps and weights of every stage, drawn exactly as the
    reference's ``RealizedProgram.execute`` draws them: one
    ``np.random.default_rng(seed)``, stage by stage, in argument order."""
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=s).astype(np.float32)
             for s in sp.arg_shapes[len(sp.ext_inputs):]]
            for sp in prog.stages]


def stage_args_from_numpy(arrays: List[List[np.ndarray]],
                          device: torch.device) -> List[List[torch.Tensor]]:
    """Per-stage numpy arguments -> the port's per-stage tensors on
    ``device``, so the port and the reference run on identical inputs."""
    return [[torch.from_numpy(a).to(device) for a in stage]
            for stage in arrays]


def _elapsed(fn: Callable[[], Sequence[torch.Tensor]],
             device: torch.device) -> Tuple[Sequence[torch.Tensor], float]:
    """Run ``fn`` and return its outputs and seconds: CUDA events around
    the stage's work on the card, a host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = fn()
        end.record()
        end.synchronize()
        return outs, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    outs = fn()
    return outs, time.perf_counter() - t0


@dataclass
class RealizedProgram:
    graph: Graph
    plan: MeshPlan
    stages: List[StageProgram]
    batch_unit: int
    device: torch.device

    def execute(self, seed: int = 0) -> Dict[str, object]:
        """Run the pipeline once (one batch-unit pass).

        Returns per-stage wall seconds, the DCI bytes billed between stage
        grids, and every stage's exported cubes (``out_layers``)."""
        args = stage_args_from_numpy(draw_stage_arrays(self, seed),
                                     self.device)
        outputs: Dict[str, torch.Tensor] = {}
        layouts: Dict[str, Layout] = {}
        wall: List[float] = []
        dci_bytes: List[float] = []
        for sp, own in zip(self.stages, args):
            ext = [outputs[n] for n in sp.ext_inputs]
            moved = 0.0
            for name, x in zip(sp.ext_inputs, ext):
                if layouts[name] != sp.layout(tuple(x.shape)):
                    moved += x.numel() * x.element_size()
            outs, secs = _elapsed(lambda: sp.fn(*ext, *own), self.device)
            wall.append(secs)
            dci_bytes.append(moved)
            for name, x in zip(sp.out_layers, outs):
                outputs[name] = x
                layouts[name] = sp.layout(tuple(x.shape))
        return {"wall_s": wall, "dci_bytes": dci_bytes, "outputs": outputs}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch device; a CUDA device with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "the caller asks for the CPU (device='cpu')")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _stage_fn(g: Graph, st: StagePlan, routes: Dict[str, str],
              ext: Tuple[str, ...], src: Tuple[str, ...],
              weighted: Tuple[str, ...], outs: Tuple[str, ...], bu: int,
              use_kernels: bool) -> Callable:
    def mm(a2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
        return ops.matmul(a2, b2) if use_kernels else ref.matmul_ref(a2, b2)

    def attention(q, k, v):
        if use_kernels:
            return ops.flash_attention(q, k, v)
        t = lambda x: x.transpose(1, 2)
        return t(ref.attention_ref(t(q), t(k), t(v)))

    chunk_dual = ops.ssd_chunk_dual if use_kernels else ref.ssd_chunk_ref
    state_pass = ops.ssd_state_pass if use_kernels else ref.ssd_state_ref

    def stage_fn(*args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        vals: Dict[str, torch.Tensor] = {}
        na, ns = len(ext), len(src)
        for i, name in enumerate(ext):
            vals[name] = args[i]
        srcs = {name: args[na + i] for i, name in enumerate(src)}
        wts = {name: args[na + ns + i] for i, name in enumerate(weighted)}

        def operand(name: str) -> torch.Tensor:
            """The layer's activation operand, from preds or source."""
            preds = [p for p in g.preds(name) if p in vals]
            return vals[preds[0]] if preds else srcs[name]

        for name in st.layers:
            lyr = g.layers[name]
            route = routes[name]
            shape = _cube(lyr, bu)
            if route.startswith("flash-scores:"):
                continue            # materialized inside the av layer
            if route.startswith("flash:"):
                qk = route.split(":", 1)[1]
                S = g.layers[qk].H
                heads, hd = _heads_for(lyr.K)
                qk_preds = [p for p in g.preds(qk) if p in vals] or [qk]
                q_src = vals.get(qk_preds[0], srcs.get(qk))
                k_src = vals.get(qk_preds[-1], q_src)
                v_pr = [p for p in g.preds(name) if p != qk and p in vals]
                v_src = vals[v_pr[0]] if v_pr else k_src
                o = attention(_fit(q_src, (bu, S, heads, hd)),
                              _fit(k_src, (bu, S, heads, hd)),
                              _fit(v_src, (bu, S, heads, hd)))
                out = o.reshape(bu, S, 1, heads * hd)
                out = _fit(out, shape) if tuple(out.shape) != shape else out
            elif route == "ssd":
                heads, hd, chunk, N = _ssd_dims(lyr)
                S = lyr.H
                a_in = operand(name)
                x = _fit(a_in, (bu, S, heads, hd))
                dt = F.softplus(_fit(a_in, (bu, S, heads)) * 0.1)
                A = torch.full((heads,), -0.5, device=a_in.device)
                Bm = _fit(a_in, (bu, S, 1, N)) * 0.1
                Cm = _fit(a_in * 0.5 + 1.0, (bu, S, 1, N)) * 0.1
                y, _ = ops.ssd_forward(x, dt, A, Bm, Cm, chunk=chunk,
                                       chunk_dual=chunk_dual,
                                       state_pass=state_pass)
                out = y.reshape(bu, S, 1, heads * hd)
                out = _fit(out, shape) if tuple(out.shape) != shape else out
            elif route == "matmul":
                a2 = _fit(operand(name), (bu * lyr.H * lyr.W, max(lyr.C, 1)))
                if lyr.has_weight:
                    b2 = wts[name]
                else:
                    preds = [p for p in g.preds(name) if p in vals]
                    b_src = vals[preds[-1]] if preds else a2
                    b2 = _fit(b_src, (max(lyr.C, 1), lyr.K))
                out = mm(a2, b2).reshape(shape) / math.sqrt(max(lyr.C, 1))
            elif route == "add":
                preds = [p for p in g.preds(name) if p in vals]
                if preds:
                    out = sum(_fit(vals[p], shape) for p in preds)
                else:
                    out = _fit(srcs[name], shape)
            else:  # "jnp": pool / depthwise as a plain reduction
                out = _fit(operand(name), shape) / (lyr.R * lyr.S)
            vals[name] = out.float()
        return tuple(vals[n] for n in outs)

    return stage_fn


def build_program(g: Graph, plan: MeshPlan,
                  device: Union[str, torch.device] = "cuda",
                  use_kernels: bool = True) -> RealizedProgram:
    """Realization of ``plan`` on one ``device``.

    ``device`` defaults to the card and raises when there is none; pass
    ``"cpu"`` to run the plain versions on the CPU.  ``use_kernels=False``
    routes through the plain versions on any device (the parity target).
    """
    device = resolve_device(device)
    for st in plan.stages:
        for name in st.layers:
            lyr = g.layers[name]
            if lyr.kind == "conv" and (lyr.R * lyr.S > 1 or lyr.groups > 1):
                raise ValueError(
                    f"layer {name}: a conv with R*S = {lyr.R * lyr.S} and "
                    f"groups = {lyr.groups} has no route (the matmul route "
                    f"contracts the activation's C columns, not the "
                    f"weight's C/groups*R*S rows); only 1x1 ungrouped "
                    f"convs realize")
    bu = plan.batch_unit
    stage_of: Dict[str, int] = {}
    for i, st in enumerate(plan.stages):
        for n in st.layers:
            stage_of[n] = i

    stages: List[StageProgram] = []
    for si, st in enumerate(plan.stages):
        routes = _route_layers(g, st)
        in_stage = set(st.layers)
        ext: List[str] = []
        src: List[str] = []
        for name in st.layers:
            for p in g.preds(name):
                if p not in in_stage and p not in ext:
                    if stage_of.get(p, si) >= si:
                        raise ValueError(
                            f"stage {si} layer {name} depends on {p} of a "
                            f"later stage — plan stages are not topological")
                    ext.append(p)
            if not g.preds(name):
                src.append(name)
        outs = [n for n in st.layers
                if any(stage_of.get(s2, -1) > si for s2 in g.succs(n))
                or not g.succs(n)]
        dom = st.dominant_layer()
        weighted = [n for n in st.layers if g.layers[n].has_weight]

        arg_shapes: List[Tuple[int, ...]] = []
        for name in ext:
            arg_shapes.append(_cube(g.layers[name], bu))
        for name in src:
            lyr = g.layers[name]
            cin = max(lyr.C, 1) if lyr.kind in ("conv", "fc", "matmul") \
                else lyr.K
            arg_shapes.append((bu, lyr.H * lyr.stride, lyr.W * lyr.stride,
                               cin))
        for name in weighted:
            lyr = g.layers[name]
            cin = max(1, (lyr.C // lyr.groups)) * lyr.R * lyr.S
            arg_shapes.append((cin, lyr.K))

        launches: List[Tuple[str, Dict[str, int]]] = []
        for name in st.layers:
            lyr = g.layers[name]
            if routes[name].startswith("flash:"):
                S = g.layers[routes[name].split(":", 1)[1]].H
                heads, hd = _heads_for(lyr.K)
                launches.append(("flash_attention_mha",
                                 {"B": bu, "H": heads, "Sq": S, "Sk": S,
                                  "D": hd, "causal": 1}))   # ops default
            elif routes[name] == "ssd":
                heads, hd, chunk, N = _ssd_dims(lyr)
                launches.append(("ssd_chunk_dual",
                                 {"BC": bu * -(-lyr.H // chunk), "Q": chunk,
                                  "H": heads, "P": hd, "N": N}))
            elif routes[name] == "matmul":
                launches.append(("tiled_matmul",
                                 {"M": bu * lyr.H * lyr.W,
                                  "K": max(lyr.C, 1), "N": lyr.K}))

        stages.append(StageProgram(
            index=si, stage=st, part=st.parts[dom], cores=st.cgs[dom],
            routes=routes, ext_inputs=tuple(ext), src_inputs=tuple(src),
            out_layers=tuple(outs), arg_shapes=arg_shapes, launches=launches,
            fn=_stage_fn(g, st, routes, tuple(ext), tuple(src),
                         tuple(weighted), tuple(outs), bu, use_kernels)))
    return RealizedProgram(graph=g, plan=plan, stages=stages, batch_unit=bu,
                           device=device)
