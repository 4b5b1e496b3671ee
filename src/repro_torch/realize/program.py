"""MeshPlan -> per-stage PyTorch programs (realization stage 2).

Port of ``src/repro/realize/program.py``.  Each plan stage becomes one
eager stage function:

* ``fc``/``matmul`` layers run the tiled GEMM (:func:`..kernels.ops.matmul`),
  detected (qk, av) score/context pairs run flash attention (the score
  matrix is never materialized), ``*_ssd`` layers run the chunked SSD
  (:func:`..kernels.ops.ssd_forward`, one ``ssd_chunk_dual`` launch and
  the inter-chunk pass per layer: one ``ssd_state_walk`` launch, or
  ``ssd_state_scan`` and ``ssd_state_out`` where the walk would leave the
  card's SMs idle), eltwise layers are adds.  With
  ``use_kernels=False`` the same program routes through the plain versions
  of :mod:`..kernels.ref` (the parity target).  On a CPU device the kernel
  wrappers run those plain versions too.
* Operands whose producers live outside the stage arrive as arguments.
  Where an abstract Gemini operand has no exact runtime tensor (a matmul's
  weight-side activations) it is derived from the producer's output by
  :func:`_fit` (``jnp.resize`` semantics), so the contraction sizes the
  cost model priced are kept.  Operand, source and weight derivation follow
  the reference line for line.
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

**Two modes.**  The reference shards each stage over a device mesh: the
dominant layer's ``CG`` reshaped to its ``Part = (ph, pw, pb, pk)`` on the
axes ``("h", "w", "b", "k")``, every layer's cube ``(B, H, W, K)`` laid
out by :func:`cube_spec_for`.

* **Logical** (``mesh=None``, the default): the program runs on one device
  and the stage grid is *logical*: its Gemini core ids place nothing and
  only bill inter-stage (DCI) traffic.  An input cube is billed when the
  slices its producer's grid puts on each core differ from the consumer's
  (:func:`cube_layout`), the logical analogue of the reference's
  ``NamedSharding.is_equivalent_to`` test.
* **Mesh** (``mesh`` a pool of ``torch.distributed`` ranks, core ``c`` on
  rank ``mesh[c]``): every stage runs on a ``DeviceMesh`` of its ranks
  (:func:`..launch.mesh.stage_mesh`), built by every rank in plan order.
  Arguments and layer cubes are DTensors placed by :func:`cube_spec_for`,
  and weights by ``(None, "k")`` as in the reference.  **The owner
  computes**: each rank computes its own slice of each layer's output cube
  (:func:`local_slices`), through ``local_map``, from inputs redistributed
  to the placements that slice needs (:func:`..launch.mesh.redistribute`:
  an all-gather over each mesh axis whose split the slice cannot use).
  Those all-gathers are the stage's on-chip (NoC / ICI) traffic:

  - ``matmul``: the rank's rows of A (its b, h and w slices of the
    ``B·H·W`` rows) with all C columns, against its k columns of the
    weight (``Shard(1)`` on k); an activation-side B is made whole;
  - ``flash``: the rank's query rows (its h slice) and batch, over the
    whole sequence of K and V, and its heads where k splits on whole heads
    (``heads % pk == 0``); otherwise every head, its columns kept after.
    Its queries sit at ``q_offset`` = the first row of its slice;
  - ``ssd``: the operand made whole (dt, B and C are resized from all of
    it), the whole sequence, the rank's batch and heads; its rows kept
    after;
  - ``add`` and the ``jnp`` routes: the operand in the output's own
    placement, so local.

  Where ``_fit`` is not the identity (the operand's cube is not the shape
  the route reads), the operand is made whole (``Replicate``), fitted, and
  sliced to the rank's part; a route whose output must be fitted computes
  the whole output from whole operands and keeps its own slice.  XLA's
  SPMD partitioner, which places the reference's cubes with
  ``with_sharding_constraint``, chooses its own collectives (PERF.md
  compares the two), so measured ICI bytes are on the port's scale.
  :meth:`RealizedProgram.execute` draws every argument on every rank
  exactly as the logical mode does and takes the rank's slices, moves each
  inter-stage cube whose layout changes over the world group (DCI, billed
  by the same rule), times each stage on each rank between barriers, and
  sends the exported cubes to rank 0 after the timed stages.

Both modes run the same body for each route (:func:`_stage_fn`): the
logical mode calls it on whole tensors with the one position's whole part,
the mesh mode through ``local_map`` on the rank's part.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..core.bridge import MeshPlan, StagePlan
from ..core.workload import Graph, Layer
from ..kernels import ops, ref, ssd_state
from ..launch.mesh import (STAGE_AXES, collective_bytes, rank_device, recv,
                           redistribute, send, stage_mesh)

# cube dim order (B, H, W, K) -> grid axis carrying it
CUBE_DIM_AXES = ("b", "h", "w", "k")

Slices = Tuple[Tuple[int, int], ...]
Layout = Tuple[Tuple[int, Slices], ...]


def cube_spec_for(shape: Tuple[int, ...], part: Tuple[int, int, int, int],
                  dim_axes: Tuple[Optional[str], ...] = CUBE_DIM_AXES
                  ) -> Tuple[Any, ...]:
    """DTensor placements of ``shape`` on a stage mesh of ``part = (ph,
    pw, pb, pk)``, one for each axis of ``STAGE_AXES``: ``Shard(dim)`` on
    the axis that carries ``dim`` (``dim_axes``) where the axis has more
    than one part and divides the dim evenly, ``Replicate()`` elsewhere.
    The rule of the reference's ``cube_spec_for`` (an indivisible dim is
    whole on every rank)."""
    sizes = dict(zip(STAGE_AXES, part))
    spec = {ax: Replicate() for ax in STAGE_AXES}
    for d, (dim, ax) in enumerate(zip(shape, dim_axes)):
        if ax is not None and sizes[ax] > 1 and dim % sizes[ax] == 0:
            spec[ax] = Shard(d)
    return tuple(spec[ax] for ax in STAGE_AXES)


def local_slices(shape: Tuple[int, ...], part: Tuple[int, int, int, int],
                 pos: int,
                 dim_axes: Tuple[Optional[str], ...] = CUBE_DIM_AXES
                 ) -> Tuple[slice, ...]:
    """The slice of each dim of ``shape`` that grid position ``pos`` (row
    major over ``(h, w, b, k)``) holds under :func:`cube_spec_for`."""
    sizes = dict(zip(STAGE_AXES, part))
    coord: Dict[str, int] = {}
    rem = pos
    for ax in reversed(STAGE_AXES):
        rem, coord[ax] = divmod(rem, sizes[ax])
    spec = dict(zip(STAGE_AXES, cube_spec_for(shape, part, dim_axes)))
    out = []
    for d, (dim, ax) in enumerate(zip(shape, dim_axes)):
        if ax is not None and spec[ax] == Shard(d):
            step = dim // sizes[ax]
            out.append(slice(coord[ax] * step, (coord[ax] + 1) * step))
        else:
            out.append(slice(0, dim))
    return tuple(out)


def cube_layout(shape: Tuple[int, ...], part: Tuple[int, int, int, int],
                cores: Sequence[int]) -> Layout:
    """``(core, index slices)`` of every position of a stage grid.

    ``part = (ph, pw, pb, pk)`` and ``cores`` (row-major over (h, w, b, k),
    the Correspondence Rule) describe the grid; each position holds
    :func:`local_slices` of the cube.  Two layouts are equal exactly when
    the same cores, in the same grid order, hold the same slices, which is
    the condition under which the reference's ``is_equivalent_to`` moves
    nothing.
    """
    return tuple((core, tuple((s.start, s.stop) for s in
                              local_slices(shape, part, pos)))
                 for pos, core in enumerate(cores))


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
    # kernel launches of one run: (kernel name, shape), from the plan; the
    # layers' work, which the measured side counts
    launches: List[Tuple[str, Dict[str, int]]] = field(default_factory=list)
    # the SSD inter-chunk pass after each chunk kernel: the kernels of the
    # route ``ssd_state_pass`` takes on the program's device, with the
    # pass's shape (B, nc, Q, H, P, N, G).  Launched, but not counted by
    # the measured side (the chunked SSD's FLOPs are the chunk form's)
    state_launches: List[Tuple[str, Dict[str, int]]] = field(
        default_factory=list)
    fn: Callable = None
    # mesh mode only (``build_program(mesh=pool)``):
    mesh: Any = None                   # DeviceMesh of the stage's ranks
    ranks: Tuple[int, ...] = ()        # world ranks in grid order
    pos: Optional[int] = None          # this rank's grid position, if any
    # each argument's mesh axis of each dim, and its placements
    arg_axes: List[Tuple[Optional[str], ...]] = field(default_factory=list)
    arg_specs: List[Tuple[Any, ...]] = field(default_factory=list)
    # each grid position's own launches: the layers' work and the state
    # pass's kernels, as ``launches`` / ``state_launches`` for the stage
    rank_launches: List[List[Tuple[str, Dict[str, int]]]] = field(
        default_factory=list)
    rank_state_launches: List[List[Tuple[str, Dict[str, int]]]] = field(
        default_factory=list)

    @property
    def n_devices(self) -> int:
        return len(self.cores)

    @property
    def kernel_launches(self) -> List[Tuple[str, Dict[str, int]]]:
        """Every kernel launch of one run of the whole stage on one card."""
        return self.launches + self.state_launches

    def launches_at(self, pos: int) -> List[Tuple[str, Dict[str, int]]]:
        """Every kernel launch grid position ``pos`` makes in mesh mode."""
        return self.rank_launches[pos] + self.rank_state_launches[pos]

    def layout(self, shape: Tuple[int, ...]) -> Layout:
        return cube_layout(shape, self.part, self.cores)


def draw_stage_arrays(prog: "RealizedProgram", seed: int
                      ) -> List[List[np.ndarray]]:
    """Source ifmaps and weights of every stage, drawn exactly as the
    reference's ``RealizedProgram.execute`` draws them: one
    ``np.random.default_rng(seed)``, stage by stage, in argument order."""
    return list(_drawn_stages(prog, seed))


def _drawn_stages(prog: "RealizedProgram", seed: int
                  ) -> Iterator[List[np.ndarray]]:
    """:func:`draw_stage_arrays` one stage at a time (the same draws), so
    that a rank holds one stage's arrays at once."""
    rng = np.random.default_rng(seed)
    for sp in prog.stages:
        yield [rng.normal(size=s).astype(np.float32)
               for s in sp.arg_shapes[len(sp.ext_inputs):]]


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
    # mesh mode: the world rank of each Gemini core (None: logical)
    pool: Optional[Tuple[int, ...]] = None

    def execute(self, seed: int = 0) -> Dict[str, object]:
        """Run the pipeline once (one batch-unit pass).

        Returns per-stage wall seconds, the DCI bytes billed between stage
        grids, each stage's argument bytes (its inputs and weights,
        ``arg_bytes``) and scratch (``temp_bytes``: the card's allocator
        peak beyond what the stage found and what its outputs hold; 0 on
        the CPU, whose allocator keeps no peak), both taken outside the
        timed window, and every stage's exported cubes (``out_layers``); in
        mesh mode the cubes on rank 0 only, and each stage's collective
        bytes (:meth:`_execute_mesh`)."""
        from ..launch.costs import local_bytes
        if self.pool is not None:
            return self._execute_mesh(seed)
        args = stage_args_from_numpy(draw_stage_arrays(self, seed),
                                     self.device)
        outputs: Dict[str, torch.Tensor] = {}
        layouts: Dict[str, Layout] = {}
        wall: List[float] = []
        dci_bytes: List[float] = []
        arg_bytes: List[float] = []
        temp_bytes: List[float] = []
        # no cyclic garbage collection while the stages are timed: a full
        # collection of the host's objects landed inside a stage's wall
        # and added 0.1-0.16 s to it on an H100's host (PERF.md)
        collecting = gc.isenabled()
        gc.disable()
        try:
            for sp, own in zip(self.stages, args):
                ext = [outputs[n] for n in sp.ext_inputs]
                moved = 0.0
                for name, x in zip(sp.ext_inputs, ext):
                    if layouts[name] != sp.layout(tuple(x.shape)):
                        moved += x.numel() * x.element_size()
                base = _peak_from_here(self.device)
                outs, secs = _elapsed(lambda: sp.fn(*ext, *own), self.device)
                wall.append(secs)
                dci_bytes.append(moved)
                arg_bytes.append(float(local_bytes(ext + list(own))))
                temp_bytes.append(_scratch_bytes(self.device, base, outs))
                for name, x in zip(sp.out_layers, outs):
                    outputs[name] = x
                    layouts[name] = sp.layout(tuple(x.shape))
        finally:
            if collecting:
                gc.enable()
        return {"wall_s": wall, "dci_bytes": dci_bytes,
                "arg_bytes": arg_bytes, "temp_bytes": temp_bytes,
                "outputs": outputs}

    def _whole(self, sp: StageProgram, name: str,
               local: Optional[torch.Tensor]) -> torch.Tensor:
        """Cube ``name`` of stage ``sp`` whole on every rank of the world:
        each distinct slice of its layout broadcast from the first rank
        that holds it (``local`` there)."""
        shape = _cube(self.graph.layers[name], self.batch_unit)
        whole = torch.empty(shape, dtype=torch.float32, device=self.device)
        rank = dist.get_rank()
        for slices, r in _holders(sp, shape):
            buf = local if rank == r else torch.empty(
                [b - a for a, b in slices], dtype=torch.float32,
                device=self.device)
            dist.broadcast(buf, src=r)
            whole[tuple(slice(a, b) for a, b in slices)] = buf
        return whole

    def _on_rank0(self, sp: StageProgram, name: str,
                  local: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Cube ``name`` of stage ``sp`` whole on rank 0 (None on the
        others): each distinct slice of its layout sent there by the first
        rank that holds it (``local`` there)."""
        shape = _cube(self.graph.layers[name], self.batch_unit)
        rank = dist.get_rank()
        whole = torch.empty(shape, dtype=torch.float32,
                            device=self.device) if rank == 0 else None
        for slices, r in _holders(sp, shape):
            at = tuple(slice(a, b) for a, b in slices)
            if rank == 0:
                whole[at] = local if r == 0 else recv(
                    [b - a for a, b in slices], r, self.device)
            elif rank == r:
                send(local, 0)
        return whole

    def _execute_mesh(self, seed: int) -> Dict[str, object]:
        """One pass over the stage meshes; every rank of the world calls it.

        Each rank draws every stage's sources and weights as the logical
        mode does and keeps its slices.  An inter-stage cube whose layout
        changes (:func:`cube_layout`, checked against the one the stage
        meshes and placements give) is billed as DCI and moved over the
        world group (:meth:`_whole`); an unchanged one stays where it is.
        Each member runs its stage between two barriers of the world, timed
        as in logical mode with no instrument inside the window: the
        collective bytes are :func:`..launch.mesh.collective_bytes` read
        before and after, and the scratch the card's allocator peak.  After
        the last stage the exported cubes go whole to rank 0 (the other
        ranks return none), and every rank gets the ranks' counts.  Returns,
        per stage, the slowest member's wall, the DCI bytes, the collective
        output bytes summed over the members (``ici_bytes``,
        ``coll_by_kind``), and the largest member's argument and scratch
        bytes."""
        from ..launch.costs import local_bytes
        g, bu = self.graph, self.batch_unit
        arrays = _drawn_stages(self, seed)
        made = {n: sp for sp in self.stages for n in sp.out_layers}
        held: Dict[str, torch.Tensor] = {}   # this rank's slice of a cube
        dci_bytes: List[float] = []
        mine: List[Optional[Dict[str, Any]]] = []
        collecting = gc.isenabled()
        gc.disable()
        try:
            for sp, own in zip(self.stages, arrays):
                moved = 0.0
                ext = []
                for name in sp.ext_inputs:
                    prod = made[name]
                    shape = _cube(g.layers[name], bu)
                    spec = cube_spec_for(shape, sp.part)
                    same = prod.layout(shape) == sp.layout(shape)
                    if same != (_mesh_layout(prod.mesh, cube_spec_for(
                            shape, prod.part), shape)
                            == _mesh_layout(sp.mesh, spec, shape)):
                        raise AssertionError(
                            f"stage {sp.index} input {name}: the stage "
                            f"meshes' placements and cube_layout disagree "
                            f"on whether it moves")
                    if same:
                        x = held.get(name)
                    else:
                        moved += math.prod(shape) * 4
                        x = self._whole(prod, name, held.get(name))
                        if sp.pos is not None:
                            x = x[local_slices(shape, sp.part, sp.pos)]
                    if sp.pos is not None:
                        ext.append(_placed(x, sp.mesh, spec))
                dci_bytes.append(moved)
                dist.barrier()
                if sp.pos is not None:
                    args = ext + [
                        _placed(torch.from_numpy(a[local_slices(
                            a.shape, sp.part, sp.pos, axes)]).to(
                                self.device), sp.mesh, spec)
                        for a, spec, axes in zip(
                            own, sp.arg_specs[len(sp.ext_inputs):],
                            sp.arg_axes[len(sp.ext_inputs):])]
                    before = collective_bytes()
                    base = _peak_from_here(self.device)
                    outs, secs = _elapsed(lambda: sp.fn(*args), self.device)
                    after = collective_bytes()
                    mine.append({
                        "wall_s": secs,
                        "coll_by_kind": {k: after[k] - before[k]
                                         for k in after},
                        "arg_bytes": float(local_bytes(args)),
                        "temp_bytes": _scratch_bytes(self.device, base,
                                                     outs)})
                    for name, x in zip(sp.out_layers, outs):
                        held[name] = x.to_local()
                else:
                    mine.append(None)
                dist.barrier()
        finally:
            if collecting:
                gc.enable()
        outputs = {name: self._on_rank0(sp, name, held.get(name))
                   for sp in self.stages for name in sp.out_layers}
        if dist.get_rank():
            outputs = {}
        ranks: List[List[Optional[Dict[str, Any]]]] = \
            [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        out: Dict[str, Any] = {"dci_bytes": dci_bytes, "outputs": outputs,
                               "wall_s": [], "ici_bytes": [],
                               "coll_by_kind": [], "arg_bytes": [],
                               "temp_bytes": []}
        for i in range(len(self.stages)):
            per = [r[i] for r in ranks if r[i] is not None]
            kinds = {k: sum(p["coll_by_kind"][k] for p in per)
                     for k in per[0]["coll_by_kind"]}
            out["wall_s"].append(max(p["wall_s"] for p in per))
            out["coll_by_kind"].append({k: v for k, v in kinds.items()
                                        if v})
            out["ici_bytes"].append(float(sum(kinds.values())))
            out["arg_bytes"].append(max(p["arg_bytes"] for p in per))
            out["temp_bytes"].append(max(p["temp_bytes"] for p in per))
        return out


def _peak_from_here(device: torch.device) -> int:
    """Start the card's allocator peak at what it holds now, and return
    that (0 on the CPU)."""
    if device.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _scratch_bytes(device: torch.device, base: int,
                   outs: Sequence[Any]) -> float:
    """The bytes a stage allocated at its peak on the card beyond ``base``
    (:func:`_peak_from_here`), less what its outputs ``outs`` hold: its
    scratch.  The host's allocator keeps no peak, so 0 on the CPU."""
    from ..launch.costs import local_bytes
    if device.type != "cuda":
        return 0.0
    peak = torch.cuda.max_memory_allocated(device) - base
    return float(max(0, peak - local_bytes(list(outs))))


def _holders(sp: StageProgram, shape: Tuple[int, ...]
             ) -> List[Tuple[Slices, int]]:
    """Each distinct slice of ``shape``'s layout on stage ``sp`` and the
    first world rank that holds it."""
    seen: Dict[Slices, int] = {}
    for (_, slices), r in zip(sp.layout(shape), sp.ranks):
        seen.setdefault(slices, r)
    return list(seen.items())


def _placed(local: torch.Tensor, mesh: Any,
            spec: Tuple[Any, ...]) -> DTensor:
    """A rank's slice as a DTensor of its stage mesh, placed by ``spec``
    (moves nothing)."""
    return DTensor.from_local(local.contiguous(), mesh, spec,
                              run_check=False)


def _mesh_layout(mesh: Any, spec: Tuple[Any, ...],
                 shape: Tuple[int, ...]) -> Tuple:
    """``(rank, index slices)`` of every rank of ``mesh`` under
    placements ``spec``, read off the mesh's own rank grid: what DTensor
    puts where, against which :func:`cube_layout` is checked."""
    grid = mesh.mesh
    out = []
    for r in grid.flatten().tolist():
        coord = [int(c) for c in (grid == r).nonzero()[0]]
        slices = [(0, dim) for dim in shape]
        for axis, pl in enumerate(spec):
            if isinstance(pl, Shard):
                step = shape[pl.dim] // grid.shape[axis]
                slices[pl.dim] = (coord[axis] * step,
                                  (coord[axis] + 1) * step)
        out.append((r, tuple(slices)))
    return tuple(out)


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


# ---------------------------------------------------------------------------
# the stage function: each grid position computes its own part of each
# layer's cube (in logical mode the one position computes it whole)
# ---------------------------------------------------------------------------

_REP = (Replicate(),) * len(STAGE_AXES)


@dataclass(frozen=True)
class _LocalPart:
    """What one grid position computes of one layer (the whole cube on the
    logical grid's one position)."""
    sl: Tuple[slice, ...]              # its slice of the layer's cube
    whole: bool                        # the route computes the whole cube
    heads: slice                       # flash / ssd: the heads it computes
    head_split: bool                   # k splits on whole heads
    launches: Tuple[Tuple[str, Dict[str, int]], ...]
    state: Tuple[Tuple[str, Dict[str, int]], ...]


def _size(s: slice) -> int:
    return s.stop - s.start


def _layer_part(g: Graph, name: str, route: str, bu: int,
                part: Tuple[int, int, int, int], pos: int,
                device: torch.device) -> _LocalPart:
    """Grid position ``pos``'s part of layer ``name`` and the kernel
    launches it makes (the module docstring's rule)."""
    lyr = g.layers[name]
    shape = _cube(lyr, bu)
    sl = local_slices(shape, part, pos)
    b_l, h_l, w_l, k_l = (_size(s) for s in sl)
    k_split = isinstance(cube_spec_for(shape, part)[3], Shard)
    launches: List[Tuple[str, Dict[str, int]]] = []
    state: List[Tuple[str, Dict[str, int]]] = []
    whole, head_split, heads_sl = False, False, slice(0, 0)
    if route.startswith("flash:") or route == "ssd":
        if route == "ssd":
            heads, hd, chunk, N = _ssd_dims(lyr)
            S = lyr.H
        else:
            S = g.layers[route.split(":", 1)[1]].H
            heads, hd = _heads_for(lyr.K)
        whole = shape != (bu, S, 1, heads * hd)
        head_split = not whole and k_split and heads % part[3] == 0
        if head_split:
            step = heads // part[3]
            first = sl[3].start // hd
            heads_sl = slice(first, first + step)
        else:
            heads_sl = slice(0, heads)
        heads_l = _size(heads_sl)
        if route == "ssd":
            b = bu if whole else b_l
            nc = -(-S // chunk)
            launches.append(("ssd_chunk_dual",
                             {"BC": b * nc, "Q": chunk, "H": heads_l,
                              "P": hd, "N": N}))
            pass_shape = {"B": b, "nc": nc, "Q": chunk, "H": heads_l,
                          "P": hd, "N": N, "G": 1}
            state += [(k, pass_shape) for k in ssd_state.route_kernels(
                b, heads_l, hd, N, device)]
        else:
            b, sq, q0 = (bu, S, 0) if whole else (b_l, h_l, sl[1].start)
            shp = {"B": b, "H": heads_l, "Sq": sq, "Sk": S, "D": hd,
                   "causal": 1}
            if q0:
                shp["q_offset"] = q0
            launches.append(("flash_attention_mha", shp))
    elif route == "matmul":
        launches.append(("tiled_matmul", {"M": b_l * h_l * w_l,
                                          "K": max(lyr.C, 1), "N": k_l}))
    return _LocalPart(sl=sl, whole=whole, heads=heads_sl,
                      head_split=head_split, launches=tuple(launches),
                      state=tuple(state))


def _stage_parts(g: Graph, st: StagePlan, routes: Dict[str, str], bu: int,
                 part: Tuple[int, int, int, int], pos: int,
                 device: torch.device) -> Dict[str, _LocalPart]:
    """Grid position ``pos``'s part of every computed layer of a stage."""
    return {name: _layer_part(g, name, routes[name], bu, part, pos, device)
            for name in st.layers
            if not routes[name].startswith("flash-scores:")}


def _stage_fn(g: Graph, st: StagePlan, routes: Dict[str, str],
              ext: Tuple[str, ...], src: Tuple[str, ...],
              weighted: Tuple[str, ...], outs: Tuple[str, ...], bu: int,
              use_kernels: bool, parts: Dict[str, _LocalPart],
              mesh: Any = None,
              part: Tuple[int, int, int, int] = (1, 1, 1, 1),
              weight_specs: Optional[Dict[str, Tuple[Any, ...]]] = None
              ) -> Callable:
    """The stage function: its arguments in, the ``outs`` cubes out.

    Each layer's route is one body over local tensors that computes the
    layer's part (``parts``: its slice of the cube) from the inputs it
    names, each with the placements it needs.  In logical mode (``mesh``
    None, every part whole) the body runs on the plain tensors.  In mesh
    mode the stage takes and returns DTensors: each input is first brought
    to its placements (:func:`..launch.mesh.redistribute`) and the body
    runs through ``local_map``, its result this rank's slice of the cube,
    placed by :func:`cube_spec_for`."""
    weight_specs = weight_specs or {}

    def mm(a2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
        return ops.matmul(a2, b2) if use_kernels else ref.matmul_ref(a2, b2)

    def attention(q, k, v, q_offset: int):
        if use_kernels:
            return ops.flash_attention(q, k, v, q_offset=q_offset)
        t = lambda x: x.transpose(1, 2)
        return t(ref.attention_ref(t(q), t(k), t(v), q_offset=q_offset))

    chunk_dual = ops.ssd_chunk_dual if use_kernels else ref.ssd_chunk_ref
    state_pass = ops.ssd_state_pass if use_kernels else ref.ssd_state_ref

    def run(body: Callable, spec: Tuple[Any, ...],
            inputs: Sequence[Tuple[Any, Tuple[Any, ...]]]):
        """``body`` on the local tensors of ``inputs``, each (mesh mode)
        first brought to its placements; its result is the layer's slice,
        placed (mesh mode) by ``spec``."""
        if mesh is None:
            return body(*(x for x, _ in inputs)).float()
        args = [redistribute(x, pl) for x, pl in inputs]
        # a list of placements: one output (a tuple would mean several)
        return local_map(lambda *ls: body(*ls).float().contiguous(),
                         out_placements=list(spec),
                         in_placements=tuple(pl for _, pl in inputs),
                         device_mesh=mesh)(*args)

    def stage_fn(*args):
        vals: Dict[str, Any] = {}
        na, ns = len(ext), len(src)
        for i, name in enumerate(ext):
            vals[name] = args[i]
        srcs = {name: args[na + i] for i, name in enumerate(src)}
        wts = {name: args[na + ns + i] for i, name in enumerate(weighted)}

        def operand(name: str):
            """The layer's activation operand, from preds or source."""
            preds = [p for p in g.preds(name) if p in vals]
            return vals[preds[0]] if preds else srcs[name]

        for name in st.layers:
            lyr = g.layers[name]
            route = routes[name]
            shape = _cube(lyr, bu)
            if route.startswith("flash-scores:"):
                continue            # materialized inside the av layer
            spec = cube_spec_for(shape, part)
            lp = parts[name]
            sl = lp.sl
            if route.startswith("flash:"):
                qk = route.split(":", 1)[1]
                S = g.layers[qk].H
                heads, hd = _heads_for(lyr.K)
                qk_preds = [p for p in g.preds(qk) if p in vals] or [qk]
                q_src = vals.get(qk_preds[0], srcs.get(qk))
                k_src = vals.get(qk_preds[-1], q_src)
                v_pr = [p for p in g.preds(name) if p != qk and p in vals]
                v_src = vals[v_pr[0]] if v_pr else k_src
                qkv = (bu, S, heads, hd)
                if lp.whole:
                    def body(ql, kl, vl, _lp=lp, _shape=shape):
                        o = attention(_fit(ql, qkv), _fit(kl, qkv),
                                      _fit(vl, qkv), 0)
                        out = o.reshape(bu, S, 1, heads * hd)
                        if tuple(out.shape) != _shape:
                            out = _fit(out, _shape)
                        return out[_lp.sl]
                    vals[name] = run(body, spec, [(q_src, _REP),
                                                  (k_src, _REP),
                                                  (v_src, _REP)])
                    continue
                # q: the rank's query rows; k, v: the whole sequence
                hsp = Shard(3) if lp.head_split else Replicate()
                inputs, own = [], []
                for x, is_q in ((q_src, True), (k_src, False),
                                (v_src, False)):
                    mine = tuple(x.shape) == (bu, S, 1, heads * hd)
                    own.append((mine, sl[1] if is_q else slice(0, S)))
                    rows_pl = spec[0] if is_q else Replicate()
                    inputs.append((x, (rows_pl, spec[1], spec[2], hsp)
                                   if mine else _REP))

                def body(ql, kl, vl, _lp=lp, _own=tuple(own)):
                    h_l = _size(_lp.heads)
                    got = []
                    for t, (mine, rows) in zip((ql, kl, vl), _own):
                        if mine:
                            got.append(t.reshape(t.shape[0], t.shape[1],
                                                 h_l, hd))
                        else:
                            got.append(_fit(t, qkv)[_lp.sl[0], rows,
                                                    _lp.heads].contiguous())
                    o = attention(*got, _lp.sl[1].start)
                    out = o.reshape(o.shape[0], o.shape[1], 1, h_l * hd)
                    return out if _lp.head_split else out[..., _lp.sl[3]]
                vals[name] = run(body, spec, inputs)
            elif route == "ssd":
                heads, hd, chunk, N = _ssd_dims(lyr)
                S = lyr.H

                def body(al, _lp=lp, _shape=shape, _heads=heads, _hd=hd,
                         _chunk=chunk, _N=N, _S=S):
                    bs = slice(0, bu) if _lp.whole else _lp.sl[0]
                    hs = _lp.heads
                    x = _fit(al, (bu, _S, _heads, _hd))[bs, :, hs]
                    dt = F.softplus(_fit(al, (bu, _S, _heads)) * 0.1)[
                        bs, :, hs]
                    A = torch.full((_size(hs),), -0.5, device=al.device)
                    Bm = (_fit(al, (bu, _S, 1, _N)) * 0.1)[bs]
                    Cm = (_fit(al * 0.5 + 1.0, (bu, _S, 1, _N)) * 0.1)[bs]
                    y, _ = ops.ssd_forward(
                        x.contiguous(), dt.contiguous(), A, Bm.contiguous(),
                        Cm.contiguous(), chunk=_chunk, chunk_dual=chunk_dual,
                        state_pass=state_pass)
                    out = y.reshape(y.shape[0], _S, 1, _size(hs) * _hd)
                    if _lp.whole:
                        if tuple(out.shape) != _shape:
                            out = _fit(out, _shape)
                        return out[_lp.sl]
                    cols = slice(None) if _lp.head_split else _lp.sl[3]
                    return out[:, _lp.sl[1], _lp.sl[2], cols]
                vals[name] = run(body, spec, [(operand(name), _REP)])
            elif route == "matmul":
                C = max(lyr.C, 1)
                rows = (bu, lyr.H, lyr.W, C)
                x = operand(name)
                preds = [p for p in g.preds(name) if p in vals]
                own_a = tuple(x.shape) == rows and (lyr.has_weight
                                                    or bool(preds))
                inputs = [(x, spec[:3] + (Replicate(),) if own_a else _REP)]
                if lyr.has_weight:
                    inputs.append((wts[name], weight_specs.get(name, _REP)))
                elif preds:
                    inputs.append((vals[preds[-1]], _REP))

                def body(xl, bl=None, _lp=lp, _own=own_a, _rows=rows, _C=C,
                         _K=lyr.K, _w=lyr.has_weight):
                    s0, s1, s2, s3 = _lp.sl
                    if _own:
                        a2 = xl.reshape(-1, _C)
                    else:
                        af = _fit(xl, (_rows[0] * _rows[1] * _rows[2], _C))
                        a2 = af.reshape(_rows)[s0, s1, s2].reshape(-1, _C)
                    if _w:
                        b2 = bl
                    else:
                        b2 = _fit(af if bl is None else bl, (_C, _K))[:, s3]
                    out = mm(a2.contiguous(), b2.contiguous())
                    return out.reshape(_size(s0), _size(s1), _size(s2),
                                       _size(s3)) / math.sqrt(_C)
                vals[name] = run(body, spec, inputs)
            else:                   # "add", "jnp": local in the out's layout
                if route == "add":
                    preds = [p for p in g.preds(name) if p in vals]
                    terms = [vals[p] for p in preds] or [srcs[name]]
                else:               # pool / depthwise as a plain reduction
                    preds, terms = [], [operand(name)]
                mine = tuple(tuple(t.shape) == shape for t in terms)

                def body(*tl, _lp=lp, _mine=mine, _shape=shape,
                         _sum=bool(preds), _div=lyr.R * lyr.S,
                         _add=route == "add"):
                    got = [t if m else _fit(t, _shape)[_lp.sl]
                           for t, m in zip(tl, _mine)]
                    if not _add:
                        return got[0] / _div
                    return sum(got) if _sum else got[0]
                vals[name] = run(body, spec, [(t, spec if m else _REP)
                                              for t, m in zip(terms, mine)])
        return tuple(vals[n] for n in outs)

    return stage_fn


def build_program(g: Graph, plan: MeshPlan,
                  device: Union[str, torch.device] = "cuda",
                  use_kernels: bool = True,
                  mesh: Optional[Sequence[int]] = None) -> RealizedProgram:
    """Realization of ``plan`` on one ``device``, or over a pool of ranks.

    ``device`` defaults to the card and raises when there is none; pass
    ``"cpu"`` to run the plain versions on the CPU.  ``use_kernels=False``
    routes through the plain versions on any device (the parity target).
    ``mesh``, the world ranks of a pool (Gemini core ``c`` on rank
    ``mesh[c]``), selects mesh mode: every rank of the world calls this
    with the same plan, builds every stage's mesh, and runs on its own
    device of ``device``'s type (:func:`..launch.mesh.rank_device`).  The
    plan must fit the pool (``realize.plan.validate_plan``).
    """
    device = resolve_device(device)
    pool: Optional[Tuple[int, ...]] = None
    if mesh is not None:
        pool = tuple(int(r) for r in mesh)
        if plan.n_devices_needed > len(pool):
            raise ValueError(f"plan needs {plan.n_devices_needed} devices, "
                             f"mesh/pool has {len(pool)}")
        device = rank_device(device.type)
        rank = dist.get_rank()
        meshes: Dict[Tuple, Any] = {}
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

        whole = _stage_parts(g, st, routes, bu, (1, 1, 1, 1), 0, device)
        sp = StageProgram(
            index=si, stage=st, part=st.parts[dom], cores=st.cgs[dom],
            routes=routes, ext_inputs=tuple(ext), src_inputs=tuple(src),
            out_layers=tuple(outs), arg_shapes=arg_shapes,
            launches=[x for lp in whole.values() for x in lp.launches],
            state_launches=[x for lp in whole.values() for x in lp.state])
        stages.append(sp)
        fn_args = (g, st, routes, tuple(ext), tuple(src), tuple(weighted),
                   tuple(outs), bu, use_kernels)
        if pool is None:
            sp.fn = _stage_fn(*fn_args, whole)
            continue
        sp.ranks = tuple(pool[c] for c in sp.cores)
        key = (sp.ranks, sp.part)
        if key not in meshes:               # collective: every rank, in order
            meshes[key] = stage_mesh(sp.ranks, sp.part, device.type)
        sp.mesh = meshes[key]
        sp.pos = sp.ranks.index(rank) if rank in sp.ranks else None
        n_args = len(ext) + len(src)
        sp.arg_axes = [CUBE_DIM_AXES] * n_args + [(None, "k")] * len(weighted)
        sp.arg_specs = [cube_spec_for(shape, sp.part, axes)
                        for shape, axes in zip(arg_shapes, sp.arg_axes)]
        parts = [_stage_parts(g, st, routes, bu, sp.part, pos, device)
                 for pos in range(sp.n_devices)]
        sp.rank_launches = [[x for lp in pp.values() for x in lp.launches]
                            for pp in parts]
        sp.rank_state_launches = [[x for lp in pp.values() for x in lp.state]
                                  for pp in parts]
        if sp.pos is not None:
            sp.fn = _stage_fn(*fn_args, parts[sp.pos], sp.mesh, sp.part,
                              dict(zip(weighted, sp.arg_specs[n_args:])))
    return RealizedProgram(graph=g, plan=plan, stages=stages, batch_unit=bu,
                           device=device, pool=pool)
