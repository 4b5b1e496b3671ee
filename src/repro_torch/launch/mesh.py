"""Device meshes over ``torch.distributed`` ranks.

Port of ``src/repro/launch/mesh.py``.  A mesh element is a rank of the
default process group, one device each (rank r uses ``cuda:r % count`` on
its host); ``make_host_mesh`` lays the first ``prod(shape)`` ranks out in
``shape`` and ``make_production_mesh`` is the reference's 16 x 16 pod (2 x
16 x 16 with ``multi_pod``).  Meshes are ``"cuda"`` (NCCL) unless the
caller asks for ``"cpu"`` (gloo); a ``"cuda"`` mesh raises without a card.
A pool of fewer ranks than the shape raises before anything starts, naming
how to get ranks.  With no process group yet, a one-rank mesh starts a
single-process group itself (``tcp://localhost`` on a free port); a larger
one needs its ranks from a launcher.

The realization's stage meshes (:func:`stage_mesh`) lay a plan stage's
ranks out as its ``Part`` on the axes ``("h", "w", "b", "k")``; a pool of
ranks comes from a launcher (``torchrun``: NCCL, one rank a card), from
:func:`start_local_ranks` (gloo: local processes on the CPU or sharing one
card, the counterpart of the reference's forced host devices), or is a
one-rank group started here (:func:`init_world`).  Functions only:
importing this module starts nothing.
"""

from __future__ import annotations

import math
import os
import socket
import warnings
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

RANKS_FIX = ("start one process a rank, e.g. `torchrun --nproc-per-node=<N> "
             "...`, or call torch.distributed.init_process_group with "
             "world_size=<N> and each process's rank before building the "
             "mesh")


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _backend(device_type: str) -> str:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; a mesh is on the card unless "
                "the caller asks for device_type='cpu'")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device type {device_type!r}")


def _rank_pool(n: int, what: str, device_type: str) -> int:
    """The world size, after checking it holds ``n`` ranks; a one-rank
    mesh starts its own group when there is none."""
    backend = _backend(device_type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(f"need {n} devices for {what}, have {world}; "
                           f"{RANKS_FIX}")
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    return world


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], what: str,
          device_type: str):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    n = math.prod(shape)
    world = _rank_pool(n, what, device_type)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    if world == n:
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False) -> Tuple[int, ...]:
    """The production mesh's shape: 16 x 16 a pod, 2 pods with
    ``multi_pod``."""
    return (2, 16, 16) if multi_pod else (16, 16)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 ranks a pod; ``multi_pod`` adds a leading 2-pod axis
    (512)."""
    shape = production_shape(multi_pod)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, f"mesh {shape}", device_type)


def make_host_mesh(shape: Tuple[int, ...] = (1, 1),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device_type: str = "cuda"):
    """A small mesh over the first ``prod(shape)`` ranks (tests, examples,
    one card)."""
    return _mesh(tuple(shape), tuple(axes), f"mesh {tuple(shape)}",
                 device_type)


# ---------------------------------------------------------------------------
# pools of ranks for the realization (``launch/realize.py --mesh``)
# ---------------------------------------------------------------------------

STAGE_AXES = ("h", "w", "b", "k")


def rank_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:rank % count`` on the card (ranks share
    the cards round-robin, as ``make_host_mesh`` places them), or the CPU."""
    if device_type == "cuda":
        _backend("cuda")
        rank = dist.get_rank() if dist.is_initialized() else 0
        return torch.device("cuda", rank % torch.cuda.device_count())
    if device_type == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unsupported device type {device_type!r}")


def init_world(device_type: str) -> int:
    """Join the default process group and return the world size.  Under a
    launcher (``RANK`` and ``WORLD_SIZE`` in the environment, as
    ``torchrun`` sets them) the group comes from the environment, NCCL with
    one rank a card (``cuda:LOCAL_RANK``) or gloo on the CPU; without one a
    one-rank group starts on ``tcp://localhost`` (a free port).  A group
    that exists already is kept."""
    if not dist.is_initialized():
        backend = _backend(device_type)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device_type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend, init_method="env://")
        else:
            if device_type == "cuda":
                torch.cuda.set_device(0)
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{free_port()}",
                world_size=1, rank=0)
    return dist.get_world_size()


def pool_size(spec: str, world: int) -> int:
    """The ranks a ``--mesh`` spec asks of a world of ``world`` ranks:
    ``host`` every rank, ``production`` / ``production2`` the production
    mesh's 256 / 512, or a count.  Raises, naming how to get ranks, when
    the world is smaller."""
    if spec == "host":
        return world
    if spec in ("production", "production2"):
        n = math.prod(production_shape(multi_pod=spec == "production2"))
    else:
        n = int(spec)
    if n < 1 or world < n:
        raise RuntimeError(f"--mesh {spec} asks for {n} ranks, the world "
                           f"has {world}; pass --host-ranks {n} for local "
                           f"ranks, or {RANKS_FIX}")
    return n


def stage_mesh(ranks: Sequence[int], part: Tuple[int, int, int, int],
               device_type: str):
    """A ``DeviceMesh`` over the world ranks ``ranks`` (row-major over
    ``(h, w, b, k)``, the Correspondence Rule's order) reshaped to ``part``
    on the axes ``STAGE_AXES``: the counterpart of the reference's
    ``_stage_mesh``.  Creating a mesh is collective, so every rank of the
    world builds every stage's mesh, in the same order; a rank outside
    ``ranks`` gets a mesh it has no coordinate in."""
    from torch.distributed.device_mesh import DeviceMesh
    if math.prod(part) != len(ranks):
        raise ValueError(f"Part {part} does not hold {len(ranks)} ranks")
    world = dist.get_world_size()
    if max(ranks) >= world:
        raise RuntimeError(f"need {max(ranks) + 1} devices for a stage on "
                           f"ranks {tuple(ranks)}, have {world}; "
                           f"{RANKS_FIX}")
    return DeviceMesh(device_type,
                      torch.tensor(list(ranks), dtype=torch.int).reshape(
                          part), mesh_dim_names=STAGE_AXES)


def _local_rank(rank: int, n: int, port: int, device_type: str,
                fn: Callable, args: tuple) -> None:
    if device_type == "cuda":
        _backend("cuda")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def start_local_ranks(n: int, fn: Callable, args: tuple = (),
                      device_type: str = "cuda") -> None:
    """Run ``fn(*args)`` in ``n`` spawned processes, ranks 0..n-1 of one
    gloo group on ``tcp://localhost`` (a free port), each on
    ``rank_device(device_type)``: on the CPU, or sharing the cards (NCCL
    takes one rank a card).  The counterpart of the reference's
    ``--host-devices``.  ``fn`` must be importable by name (a module-level
    function).  Returns when every rank has ended; raises when one fails,
    after ending the others."""
    import torch.multiprocessing as mp
    if device_type == "cuda":
        _backend("cuda")
    mp.start_processes(_local_rank, nprocs=n,
                       args=(n, free_port(), device_type, fn, tuple(args)),
                       start_method="spawn", join=True)


# The stages' collectives.  DTensor's own redistribution gathers through
# the functional collectives (``_c10d_functional.all_gather_into_tensor``),
# which crashed every rank (SIGSEGV) with gloo on CUDA tensors on an H100
# under torch 2.11, while c10d's ``all_gather_into_tensor`` and ``broadcast``
# ran there.  So the stages move their tensors with these two, on every
# backend, and DTensor only carries the placements.  The exported cubes go
# to rank 0 after the timed stages by ``send`` / ``recv``.


def transport(device: torch.device) -> Dict[str, str]:
    """How the realization's collectives move a tensor on ``device`` in
    the current default group: the backend, and the c10d call of each."""
    backend = dist.get_backend()
    where = ("the card's tensors (gloo stages them through host memory "
             "itself)" if backend == "gloo" and device.type == "cuda"
             else f"{device.type} tensors")
    return {"backend": backend, "device": str(device),
            "all_gather": f"c10d all_gather_into_tensor on {where}",
            "broadcast": f"c10d broadcast on {where}",
            "outputs_to_rank0": "c10d send / recv" + (
                " staged through host memory (gloo sends host tensors "
                "only)" if backend == "gloo" and device.type == "cuda"
                else f" on {device.type} tensors"),
            "dtensor_redistribute": "not used (its functional all-gather "
                                    "crashed with gloo on CUDA tensors, "
                                    "torch 2.11)"}


# output bytes of every all-gather :func:`all_gather` has run in this
# process, under the reference's kind name
_GATHERED = {"all-gather": 0.0}


def collective_bytes() -> Dict[str, float]:
    """The output bytes of the collectives this process has run through
    :func:`all_gather`, by kind: the realization reads them before and
    after each stage, as that stage's ICI."""
    return dict(_GATHERED)


def all_gather(x: torch.Tensor, group, dim: int,
               order: Sequence[int]) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated along ``dim`` in the
    order of the world ranks ``order`` (c10d ``all_gather_into_tensor``,
    whose output bytes :func:`collective_bytes` counts).  A group
    numbers its ranks in ascending order, not the mesh's, so the gathered
    blocks are put in ``order`` after."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * front.shape[0], *front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        # torch 2.13 renames it all_gather_single; 2.11 has only this name
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, front, group=group)
    _GATHERED["all-gather"] += out.numel() * out.element_size()
    members = dist.get_process_group_ranks(group)
    if list(order) != members:
        blocks = out.chunk(n, 0)
        out = torch.cat([blocks[members.index(r)] for r in order])
    return out.movedim(0, dim).contiguous()


def _wire(device: torch.device) -> torch.device:
    """Where c10d's point-to-point calls take a tensor of ``device``: gloo
    sends host tensors only, so a card's tensor goes through host memory."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else device


def send(x: torch.Tensor, dst: int) -> None:
    """Send ``x`` to world rank ``dst`` (c10d ``send``; :func:`recv` takes
    it)."""
    dist.send(x.to(_wire(x.device)).contiguous(), dst)


def recv(shape: Sequence[int], src: int, device: torch.device
         ) -> torch.Tensor:
    """The f32 tensor of ``shape`` that world rank ``src`` sends
    (:func:`send`), on ``device``."""
    buf = torch.empty(tuple(shape), dtype=torch.float32,
                      device=_wire(device))
    dist.recv(buf, src)
    return buf.to(device)


def redistribute(x, placements):
    """The DTensor ``x`` with ``placements`` on its own mesh, where each
    axis keeps its placement or goes from ``Shard(d)`` to ``Replicate()``
    (an all-gather of dim ``d`` over that axis's group, :func:`all_gather`):
    the only change the realization's stages make, since each stage axis
    carries one cube dim and a rank's slice only ever needs more of it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    placements = tuple(placements)
    local = x.to_local()
    coord = mesh.get_coordinate()
    for i, (have, want) in enumerate(zip(x.placements, placements)):
        if have == want:
            continue
        if not (isinstance(have, Shard) and isinstance(want, Replicate)):
            raise NotImplementedError(f"redistribute {have} -> {want}")
        # the ranks along axis i through this rank, in mesh order
        line = mesh.mesh[tuple(coord[:i]) + (slice(None),)
                         + tuple(coord[i + 1:])].tolist()
        local = all_gather(local, mesh.get_group(i), have.dim, line)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())
