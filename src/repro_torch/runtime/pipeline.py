"""Execute a Gemini ``MeshPlan`` as a layer-pipelined forward pass.

Port of ``src/repro/runtime/pipeline.py``: the demonstration executor for
the dense family.  Stage s owns the blocks ``[lo, hi)`` of the model and a
device from the plan; activations hop stage to stage with ``.to(device)``
(the D2D transfer the Gemini evaluator priced).  Microbatches stream
through the stages in pipeline order, and each stage's seconds are summed
over them in ``stage_times``, so the schedule is inspectable.

The stage-to-block rule is the reference's, quirks included: a stage
takes as many blocks as it holds ``_add2`` layers (or ``_add`` layers
other than ``_add1``), at least one, clamped at both ends to the model's
depth, and the last stage is stretched over whatever remains.  At a plan
of one stage a Gemini layer the first ``n_layers`` stages run a block each
and the rest run none; the logits still equal the monolithic forward's.

Stages run eager (the reference jits each one).  The stage body is the
reference's scan body through the port's modules, so attention takes the flash
kernel for CUDA tensors wherever
:func:`repro_torch.nn.attention.multihead_attention` picks it.  On the card a
stage is timed between two synchronizes. ``devices=None`` means every CUDA
device, and raises without one.  The caller's ``params`` are never moved: a
stage runs the caller's blocks where they already sit on its device, and a copy
of them on its device where they do not, made when the executor is built.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.bridge import MeshPlan
from ..models.lm import LM
from ..nn.layers import dtype_of


def stage_ranges(plan: MeshPlan, n_layers: int) -> List[Tuple[int, int]]:
    """The block range ``[lo, hi)`` each stage of ``plan`` runs
    (``src/repro/runtime/pipeline.py:42-61``)."""
    ranges: List[Tuple[int, int]] = []
    count = 0
    for st in plan.stages:
        n_blocks = sum(1 for name in st.layers if name.endswith("_add2")
                       or name.endswith("_add") and "_add1" not in name)
        n_blocks = max(1, n_blocks)
        lo = min(count, n_layers)
        hi = min(count + n_blocks, n_layers)
        ranges.append((lo, hi))
        count += n_blocks
    if ranges:
        lo, _ = ranges[-1]
        ranges[-1] = (lo, n_layers)
    return ranges


@dataclass
class PipelineExec:
    cfg: ModelConfig
    params: LM
    plan: MeshPlan
    devices: Optional[Sequence] = None      # flat device list to index into
    stage_times: List[float] = field(default_factory=list)

    def __post_init__(self):
        if self.cfg.family != "dense":
            raise ValueError(f"PipelineExec runs the dense family, not "
                             f"{self.cfg.family!r} ({self.cfg.name})")
        if self.devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; PipelineExec runs on the "
                    "card unless the caller passes devices (e.g. "
                    "[torch.device('cpu')])")
            self.devices = [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
        self.devices = [_indexed(torch.device(d)) for d in self.devices]
        if not self.devices:
            raise ValueError("PipelineExec needs at least one device")
        self._ranges = stage_ranges(self.plan, self.cfg.n_layers)
        # each block runs in exactly one stage: that stage holds it on its
        # device, a copy where the caller's sits elsewhere (the reference's
        # jit(device=...) copies it there a call and leaves params alone)
        self._blocks = [[_on(bp, self._stage_device(si))
                         for bp in self.params.blocks[lo:hi]]
                        for si, (lo, hi) in enumerate(self._ranges)]

    def _stage_device(self, si: int) -> torch.device:
        # plan core ids are flat device indices; a pool smaller than the
        # plan folds (modulo), as in the reference
        devs = self.plan.stages[si].devices
        return self.devices[devs[0] % len(self.devices)]

    def _stage(self, si: int, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        for bp in self._blocks[si]:
            y, _ = bp.attn(bp.norm1(h), positions=positions,
                           rope_theta=cfg.rope_theta, compute_dtype=cdt)
            h = h + y
            h = h + bp.mlp(bp.norm2(h), cdt)
        return h

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, n_micro: int = 1) -> torch.Tensor:
        """Pipelined forward -> f32 logits (B, S, padded_vocab).  tokens:
        (B, S), B divisible by ``n_micro``."""
        if tokens.shape[0] % n_micro:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{n_micro} equal microbatches")
        cdt = dtype_of(self.cfg.compute_dtype)
        h = self.params.embed(tokens, cdt)
        micro = torch.split(h, tokens.shape[0] // n_micro, dim=0)
        outs = []
        self.stage_times = [0.0] * len(self._ranges)
        for mb in micro:
            x = mb
            for si in range(len(self._ranges)):
                dev = self._stage_device(si)
                x = x.to(dev)
                _sync(dev)
                t0 = time.perf_counter()
                x = self._stage(si, x)
                _sync(dev)
                self.stage_times[si] += time.perf_counter() - t0
            outs.append(x)
        h = torch.cat([o.to(h.device) for o in outs], dim=0)
        return self.params.logits(h, cdt).float()


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its index: a bare "cuda" is the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(module: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
    """``module`` if its parameters lie on ``dev``, else a copy on ``dev``."""
    if all(p.device == dev for p in module.parameters()):
        return module
    return copy.deepcopy(module).to(dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
