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
one needs its ranks from a launcher.  Functions only: importing this
module starts nothing.
"""

from __future__ import annotations

import math
import socket
from typing import Tuple

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


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 ranks a pod; ``multi_pod`` adds a leading 2-pod axis
    (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, f"mesh {shape}", device_type)


def make_host_mesh(shape: Tuple[int, ...] = (1, 1),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device_type: str = "cuda"):
    """A small mesh over the first ``prod(shape)`` ranks (tests, examples,
    one card)."""
    return _mesh(tuple(shape), tuple(axes), f"mesh {tuple(shape)}",
                 device_type)
