"""The cost model's two kernels: the evaluator's fused pass and the
analyzer's segment replay.

``fused_eval`` is the port of the jitted ``fused`` function of
``_build_fused_fn`` (``src/repro/core/evaluator.py:97-179``): one launch of
``csrc/fused_eval.cu`` replays a batch's float32 contribution stream into B
rows and computes every row's delay, energy, stage time, GLB overflow,
bottleneck and five energy parts.  ``segment_replay`` is the port of
``_jax_replay`` (``src/repro/core/analyzer.py:60-92``): a float64
scatter-add of an int64 index stream.  Both launch their kernel for tensors
on the card and run the plain versions of :mod:`.ref` for tensors on the
CPU; a CUDA tensor never falls back, and what the kernel does not take
raises.  ``fused_eval.launches`` and ``segment_replay.launches`` count
kernel launches.

What an evaluator fixes once (the analyzer's target spans, the D2D mask
over the edges, bandwidths, GLB capacity and unit energies) lives in a
:class:`FusedEvalPlan`, uploaded to its device when it is built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build
from .ref import fused_eval_ref, segment_replay_ref

# slots of FusedEvalPlan.consts (csrc/fused_eval.cu C_*)
CONSTS = ("noc_bw", "d2d_bw", "dram_port_bw", "dram_bw", "glb_cap",
          "glb_total", "e_mac", "e_glb", "e_noc", "e_d2d", "e_dram")
# rows of fused_eval's output (csrc/fused_eval.cu O_*)
OUT_ROWS = ("delay", "energy", "stage", "overflow", "e_mac", "e_glb",
            "e_noc", "e_d2d", "e_dram")
N_TARGETS = 10
_INT_MAX = 2**31 - 1


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the fused pass runs on the card "
            "unless the caller asks for the CPU (fused_device='cpu')")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class FusedEvalPlan:
    """One evaluator's fixed inputs of :func:`fused_eval`, on ``device``."""
    device: torch.device
    buf_len: int
    spans: torch.Tensor       # (N_TARGETS, 2) int32: each target's columns
    d2d_mask: torch.Tensor    # (n_edges,) f32: 1.0 on a D2D link
    consts: torch.Tensor      # (len(CONSTS),) f32
    has_d2d: bool

    @classmethod
    def build(cls, layout: Sequence[Tuple[int, int]], buf_len: int,
              is_d2d: np.ndarray, arch, device) -> "FusedEvalPlan":
        """From the analyzer's ``layout`` and ``buf_len``, the router
        grid's D2D edge mask and the arch; raises for a CUDA ``device``
        without a card."""
        dev = _device(device)
        tech = arch.tech
        consts = (arch.noc_bw * 1e9, arch.d2d_bw * 1e9,
                  arch.dram_bw / arch.n_dram * 1e9, arch.dram_bw * 1e9,
                  float(arch.core_glb_bytes),
                  float(arch.core_glb_bytes) * arch.n_cores,
                  tech.e_mac, tech.e_glb_byte, tech.e_noc_hop_byte,
                  tech.e_d2d_byte, tech.e_dram_byte)
        if len(layout) != N_TARGETS:
            raise ValueError(f"layout of {len(layout)} targets, not "
                             f"{N_TARGETS}")
        return cls(
            device=dev, buf_len=int(buf_len),
            spans=torch.tensor([[int(lo), int(hi)] for lo, hi in layout],
                               dtype=torch.int32, device=dev),
            d2d_mask=torch.from_numpy(
                np.asarray(is_d2d, dtype=np.float32)).to(dev),
            consts=torch.tensor(consts, dtype=torch.float32, device=dev),
            has_d2d=bool(np.asarray(is_d2d).any()))


def fused_eval(plan: FusedEvalPlan, idx: torch.Tensor, vals: torch.Tensor,
               npass: torch.Tensor, depth: torch.Tensor, wts: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay ``(idx, vals)`` (int32, f32; pad entries at the dump cell
    ``B * buf_len``) into B rows and evaluate each with its pass count
    ``npass`` and pipeline ``depth`` (int32) and weight-DRAM total ``wts``
    (f32).  Returns ``(out (9, B) f32 in OUT_ROWS order, bottleneck (B,)
    int32: 0 compute, 1 NoC, 2 D2D, 3 DRAM)``."""
    kw = dict(spans=plan.spans, d2d_mask=plan.d2d_mask, consts=plan.consts,
              has_d2d=plan.has_d2d, buf_len=plan.buf_len)
    tensors = (idx, vals, npass, depth, wts)
    if all(t.device.type == "cpu" for t in tensors) \
            and plan.device.type == "cpu":
        return fused_eval_ref(*tensors, **kw)
    if any(t.device != plan.device for t in tensors) \
            or plan.device.type != "cuda":
        raise ValueError(f"fused_eval: tensors on "
                         f"{sorted({str(t.device) for t in tensors})} and a "
                         f"plan on {plan.device}; the kernel takes all on "
                         f"one card")
    want = (torch.int32, torch.float32, torch.int32, torch.int32,
            torch.float32)
    if tuple(t.dtype for t in tensors) != want:
        raise TypeError(f"fused_eval: dtypes {[t.dtype for t in tensors]}, "
                        f"not {list(want)}")
    B = npass.shape[0]
    if any(t.dim() != 1 or not t.is_contiguous() for t in tensors) \
            or idx.shape != vals.shape or depth.shape[0] != B \
            or wts.shape[0] != B:
        raise ValueError("fused_eval: idx/vals and npass/depth/wts must be "
                         "contiguous 1-D streams of equal lengths")
    if B < 1 or B * plan.buf_len + 1 > _INT_MAX:
        raise ValueError(f"fused_eval: {B} rows of {plan.buf_len} cells out "
                         f"of the kernel's range")
    buf = torch.empty(B * plan.buf_len + 1, dtype=torch.float32,
                      device=idx.device)
    out = torch.empty((len(OUT_ROWS), B), dtype=torch.float32,
                      device=idx.device)
    bottleneck = torch.empty(B, dtype=torch.int32, device=idx.device)
    lib = _build.load("fused_eval")
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    code = lib.fused_eval_f32(
        idx.data_ptr(), vals.data_ptr(), idx.numel(), B, plan.buf_len,
        buf.data_ptr(), npass.data_ptr(), depth.data_ptr(), wts.data_ptr(),
        plan.spans.data_ptr(), plan.d2d_mask.data_ptr(),
        plan.consts.data_ptr(), int(plan.has_d2d), out.data_ptr(),
        bottleneck.data_ptr(), idx.device.index or 0, stream)
    _build.check(lib, "fused_eval", code)
    fused_eval.launches += 1
    return out, bottleneck


fused_eval.launches = 0


@dataclass(frozen=True)
class FusedRows:
    """:func:`fused_eval`'s outputs on the host, one entry per row."""
    delay: np.ndarray
    energy: np.ndarray
    stage: np.ndarray
    overflow: np.ndarray
    bottleneck: np.ndarray        # index into (compute, noc, d2d, dram)
    energy_parts: np.ndarray      # (5, B): mac, glb, noc, d2d, dram


def evaluate_rows(plan: FusedEvalPlan, idx: np.ndarray, vals: np.ndarray,
                  npass: np.ndarray, depth: np.ndarray,
                  wts: np.ndarray) -> FusedRows:
    """:func:`fused_eval` of host arrays: upload to the plan's device,
    launch, bring the rows back."""
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(plan.device)
    out, bottleneck = fused_eval(plan, up(idx), up(vals), up(npass),
                                 up(depth), up(wts))
    out = out.cpu().numpy()
    return FusedRows(delay=out[0], energy=out[1], stage=out[2],
                     overflow=out[3], bottleneck=bottleneck.cpu().numpy(),
                     energy_parts=out[4:])


def segment_replay(idx: torch.Tensor, vals: torch.Tensor,
                   n: int) -> torch.Tensor:
    """``segment_sum(vals, idx, n)`` of an int64 index stream and a float64
    value stream, float64 (atomic adds: the order, and so the last bits,
    change from run to run)."""
    if idx.device.type == "cpu" and vals.device.type == "cpu":
        return segment_replay_ref(idx, vals, n)
    if idx.device.type != "cuda" or vals.device != idx.device:
        raise ValueError(f"segment_replay: streams on {idx.device} and "
                         f"{vals.device}; the kernel takes both on one card")
    if idx.dtype != torch.int64 or vals.dtype != torch.float64:
        raise TypeError(f"segment_replay: dtypes {idx.dtype}, {vals.dtype}, "
                        f"not int64 and float64")
    if idx.dim() != 1 or idx.shape != vals.shape \
            or not (idx.is_contiguous() and vals.is_contiguous()) or n < 1:
        raise ValueError("segment_replay: idx and vals must be contiguous "
                         "1-D streams of one length, n >= 1")
    out = torch.empty(n, dtype=torch.float64, device=idx.device)
    lib = _build.load("fused_eval")
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    code = lib.segment_replay_f64(idx.data_ptr(), vals.data_ptr(),
                                  idx.numel(), out.data_ptr(), n,
                                  idx.device.index or 0, stream)
    _build.check(lib, "segment_replay", code)
    segment_replay.launches += 1
    return out


segment_replay.launches = 0
