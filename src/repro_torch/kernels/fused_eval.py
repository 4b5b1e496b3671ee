"""The cost model's two kernels: the evaluator's fused pass and the
analyzer's segment replay.

``fused_eval`` is the port of the jitted ``fused`` function of
``_build_fused_fn`` (``src/repro/core/evaluator.py:97-179``): one launch of
``csrc/fused_eval.cu``, one block a row, sums each row's slice of a
float32 contribution stream in shared memory, in an order fixed by the
row's inputs (the same inputs give the same bits on every run), and
computes every row's delay, energy, stage time, GLB overflow, bottleneck
and five energy parts.  A row too wide for 16 copies in one block's
shared memory (:func:`copies`) is summed in :func:`splits` parts by as
many blocks, into a scratch buffer the plan owns, and a second launch
adds the parts in order and finishes the rows.
The stream is not padded: row ``b``'s entries are ``idx[off[b]:off[b+1]]``
and the same slice of ``vals``, each index a cell of that row, in ``[0,
buf_len)``.  ``segment_replay`` is the port of ``_jax_replay``
(``src/repro/core/analyzer.py:60-92``): a float64 scatter-add of an int64 index
stream, each cell's entries added in stream order (two launches: each range of
cells finds its stretch of the stream, then one block a range sorts each tile
of it by cell and adds every cell's run in order, one thread a cell), so the
same stream gives the same bits on every run, those of a serial scatter-add.  Both launch their kernel for tensors on the card and run
the plain versions of :mod:`.ref` for tensors on the CPU; a CUDA tensor never
falls back, and what the kernel does not take raises.
``fused_eval.launches`` and ``segment_replay.launches`` count the calls
that launch a kernel (a call on rows too wide for one block launches
``fused_eval``'s twice); a :mod:`repro_torch.obs` collector harvests both under those
names, so a traced process's metrics snapshot (a shard child's, say)
says how often it ran each kernel.

What an evaluator fixes once (the analyzer's target spans, the D2D mask
over the edges, bandwidths, GLB capacity and unit energies) lives in a
:class:`FusedEvalPlan`, uploaded to its device when it is built.  The plan
also owns one batch's buffers, each grown geometrically and reused: a
host staging buffer (pinned for the card) packed as ``[off | npass | depth
| wts | idx | vals]`` with its twin on the device, and the packed output
``[out | bottleneck]`` on the device with its pinned host twin.
:meth:`FusedEvalPlan.stage` hands out numpy views of the staging buffer
for the caller to fill; :func:`evaluate_rows` then makes one copy to the
card, one :func:`fused_eval` launch on views of the device buffers, one
copy back and one stream synchronize.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import metrics as _obs_metrics
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
_MIN_WORDS = 1 << 12              # the buffers' first capacity, 4-byte words
_MAX_CELLS: Dict[int, int] = {}   # device index -> fused_eval_max_cells
_WARPS = 16                       # a block's warps (csrc/fused_eval.cu kWarps)
# the fewest cells a block of segment_replay owns (csrc/fused_eval.cu
# kReplayMinCells): its scratch holds two ints a block at that count
REPLAY_MIN_CELLS = 32


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


class FusedInputs(NamedTuple):
    """One batch of :func:`fused_eval`'s inputs, in its argument order:
    row offsets ``off`` (B + 1,) int32, the row-local stream ``idx`` (n,)
    int32 and ``vals`` (n,) f32, ``npass`` and ``depth`` (B,) int32 and
    the weight-DRAM totals ``wts`` (B,) f32; numpy arrays, or tensors."""
    off: np.ndarray
    idx: np.ndarray
    vals: np.ndarray
    npass: np.ndarray
    depth: np.ndarray
    wts: np.ndarray


def _grow(buf: Optional[torch.Tensor], words: int,
          **kw) -> torch.Tensor:
    """``buf`` if it holds ``words`` 4-byte words, else a new int32 buffer
    of at least twice its capacity."""
    if buf is not None and buf.numel() >= words:
        return buf
    cap = max(words, 2 * (0 if buf is None else buf.numel()), _MIN_WORDS)
    return torch.empty(cap, dtype=torch.int32, **kw)


def _views(words, B: int, n: int, f32) -> FusedInputs:
    """A batch of ``B`` rows and ``n`` entries as views of the packed
    int32 buffer ``words`` (numpy or torch, ``f32`` its float32 dtype):
    ``[off | npass | depth | wts | idx | vals]``."""
    i = 4 * B + 1
    return FusedInputs(
        off=words[:B + 1], idx=words[i:i + n],
        vals=words[i + n:i + 2 * n].view(f32),
        npass=words[B + 1:2 * B + 1], depth=words[2 * B + 1:3 * B + 1],
        wts=words[3 * B + 1:i].view(f32))


@dataclass(eq=False)
class FusedEvalPlan:
    """One evaluator's fixed inputs of :func:`fused_eval`, on ``device``,
    and its batch buffers (the module docstring)."""
    device: torch.device
    buf_len: int
    spans: torch.Tensor       # (N_TARGETS, 2) int32: each target's columns
    d2d_mask: torch.Tensor    # (n_edges,) f32: 1.0 on a D2D link
    consts: torch.Tensor      # (len(CONSTS),) f32
    has_d2d: bool
    host_in: Optional[torch.Tensor] = field(default=None, init=False,
                                            repr=False)
    dev_in: Optional[torch.Tensor] = field(default=None, init=False,
                                           repr=False)
    dev_out: Optional[torch.Tensor] = field(default=None, init=False,
                                            repr=False)
    host_out: Optional[torch.Tensor] = field(default=None, init=False,
                                             repr=False)
    dev_partial: Optional[torch.Tensor] = field(default=None, init=False,
                                                repr=False)
    staged: Optional[FusedInputs] = field(default=None, init=False,
                                          repr=False)

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

    def stage(self, B: int, n: int) -> FusedInputs:
        """Numpy views of the staging buffer for a batch of ``B`` rows and
        ``n`` stream entries, for the caller to fill and hand to
        :func:`evaluate_rows`; the next call reuses the memory."""
        self.host_in = _grow(self.host_in, 4 * B + 1 + 2 * n,
                             pin_memory=self.device.type == "cuda")
        self.staged = _views(self.host_in.numpy(), B, n, np.float32)
        return self.staged


def max_cells(device: torch.device) -> int:
    """The most cells a :func:`fused_eval` row may have on the card
    ``device``: one block's opt-in shared memory, less the kernel's own."""
    index = device.index or 0
    cells = _MAX_CELLS.get(index)
    if cells is None:
        lib = _build.load("fused_eval")
        cells = lib.fused_eval_max_cells(index)
        if cells < 0:
            _build.check(lib, "fused_eval_max_cells", -cells)
        cells = _MAX_CELLS[index] = cells
    return cells


def copies(device: torch.device, buf_len: int) -> int:
    """The shared-memory copies of a row of ``buf_len`` cells that a
    :func:`fused_eval` block sums on the card ``device``: one for each of
    the block's first warps, 16 or as many as fit (the launch's dynamic
    shared memory is ``4 * copies * buf_len`` bytes)."""
    return min(_WARPS, max_cells(device) // int(buf_len))


def splits(device: torch.device, buf_len: int) -> int:
    """The parts, one block each, that :func:`fused_eval` sums a row of
    ``buf_len`` cells in on the card ``device``: 1 where 16 copies fit,
    else enough blocks that 16 warps stream each row."""
    return -(-_WARPS // copies(device, buf_len))


def fused_eval(plan: FusedEvalPlan, off: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor, npass: torch.Tensor, depth: torch.Tensor,
               wts: torch.Tensor,
               out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum row ``b``'s entries ``idx[off[b]:off[b+1]]`` (int32 cells of
    the row, f32 ``vals``) into its ``buf_len`` cells and evaluate each
    row with its pass count ``npass`` and pipeline ``depth`` (int32) and
    weight-DRAM total ``wts`` (f32).  Returns ``(out (9, B) f32 in
    OUT_ROWS order, bottleneck (B,) int32: 0 compute, 1 NoC, 2 D2D, 3
    DRAM)``, written into ``out`` (on the card) when it is given.  On
    the card each row's slice is clamped to the stream and an index
    outside ``[0, buf_len)`` is skipped; the plain version raises on
    either."""
    tensors = (off, idx, vals, npass, depth, wts)
    if all(t.device.type == "cpu" for t in tensors) \
            and plan.device.type == "cpu" and out is None:
        return fused_eval_ref(*tensors, spans=plan.spans,
                              d2d_mask=plan.d2d_mask, consts=plan.consts,
                              has_d2d=plan.has_d2d, buf_len=plan.buf_len)
    B = npass.shape[0] if npass.dim() == 1 else -1
    if out is None:
        out = (torch.empty((len(OUT_ROWS), B), dtype=torch.float32,
                           device=plan.device),
               torch.empty(B, dtype=torch.int32, device=plan.device))
    tensors += tuple(out)
    if any(t.device != plan.device for t in tensors) \
            or plan.device.type != "cuda":
        raise ValueError(f"fused_eval: tensors on "
                         f"{sorted({str(t.device) for t in tensors})} and a "
                         f"plan on {plan.device}; the kernel takes all on "
                         f"one card")
    want = (torch.int32, torch.int32, torch.float32, torch.int32,
            torch.int32, torch.float32, torch.float32, torch.int32)
    if tuple(t.dtype for t in tensors) != want:
        raise TypeError(f"fused_eval: dtypes {[t.dtype for t in tensors]}, "
                        f"not {list(want)}")
    if any(not t.is_contiguous() for t in tensors) \
            or any(t.dim() != 1 for t in tensors[:6] + tensors[7:]) \
            or idx.shape != vals.shape or off.shape[0] != B + 1 \
            or depth.shape[0] != B or wts.shape[0] != B \
            or out[0].shape != (len(OUT_ROWS), B) or out[1].shape[0] != B:
        raise ValueError("fused_eval: off (B + 1), idx/vals (n), "
                         "npass/depth/wts/bottleneck (B) and out (9, B) "
                         "must be contiguous tensors")
    limit = max_cells(plan.device)
    if plan.buf_len > limit:
        raise ValueError(f"fused_eval: buf_len {plan.buf_len} cells do not "
                         f"fit one block's shared memory ({limit} cells); "
                         f"the kernel sums a row on chip and has no "
                         f"fallback")
    parts = splits(plan.device, plan.buf_len)
    if B < 1 or B * parts > _INT_MAX:
        raise ValueError(f"fused_eval: {B} rows out of the kernel's range")
    partial = None
    if parts > 1:
        plan.dev_partial = _grow(plan.dev_partial, B * parts * plan.buf_len,
                                 device=plan.device)
        partial = plan.dev_partial.data_ptr()
    lib = _build.load("fused_eval")
    code = lib.fused_eval_f32(
        *(t.data_ptr() for t in tensors[:3]), idx.numel(), B, plan.buf_len,
        *(t.data_ptr() for t in tensors[3:6]), plan.spans.data_ptr(),
        plan.d2d_mask.data_ptr(), plan.consts.data_ptr(), int(plan.has_d2d),
        copies(plan.device, plan.buf_len), parts, partial,
        out[0].data_ptr(), out[1].data_ptr(), plan.device.index or 0,
        torch.cuda.current_stream(plan.device).cuda_stream)
    _build.check(lib, "fused_eval", code)
    fused_eval.launches += 1
    return out


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

    @classmethod
    def of(cls, out: np.ndarray, bottleneck: np.ndarray) -> "FusedRows":
        return cls(delay=out[0], energy=out[1], stage=out[2],
                   overflow=out[3], bottleneck=bottleneck,
                   energy_parts=out[4:])


def evaluate_rows(plan: FusedEvalPlan, x: FusedInputs) -> FusedRows:
    """:func:`fused_eval` of the batch ``x`` that ``plan.stage`` handed
    out last and the caller filled: on the card one copy of the packed
    inputs to the card, one launch on views of them (two for rows too
    wide for one block), one copy of the
    packed outputs ``[out | bottleneck]`` back and one synchronize of the
    stream; on the CPU the plain version.  Raises on a batch the plan did
    not stage last, and on offsets that do not run from 0 up to the
    stream's length."""
    if x is not plan.staged:
        raise ValueError("evaluate_rows takes the batch that "
                         "FusedEvalPlan.stage handed out last")
    B, n = x.npass.size, x.idx.size
    off = x.off
    if B < 1 or off[0] != 0 or off[B] != n \
            or (B > 1 and bool((off[1:] < off[:-1]).any())):
        raise ValueError(f"fused_eval: {B} rows whose offsets do not run "
                         f"from 0 up to the stream's {n} entries")
    if plan.device.type == "cpu":
        out, bn = fused_eval(plan, *_views(plan.host_in, B, n, torch.float32))
        return FusedRows.of(out.numpy(), bn.numpy())
    words = 4 * B + 1 + 2 * n
    plan.dev_in = _grow(plan.dev_in, words, device=plan.device)
    plan.dev_out = _grow(plan.dev_out, 10 * B, device=plan.device)
    plan.host_out = _grow(plan.host_out, 10 * B, pin_memory=True)
    plan.dev_in[:words].copy_(plan.host_in[:words], non_blocking=True)
    packed = plan.dev_out[:10 * B]
    fused_eval(plan, *_views(plan.dev_in, B, n, torch.float32),
               out=(packed[:9 * B].view(torch.float32).view(9, B),
                    packed[9 * B:]))
    plan.host_out[:10 * B].copy_(packed, non_blocking=True)
    torch.cuda.current_stream(plan.device).synchronize()
    got = plan.host_out[:10 * B].numpy().copy()
    return FusedRows.of(got[:9 * B].view(np.float32).reshape(9, B),
                        got[9 * B:])


def segment_replay(idx: torch.Tensor, vals: torch.Tensor,
                   n: int) -> torch.Tensor:
    """``segment_sum(vals, idx, n)`` of an int64 index stream and a float64
    value stream, float64, each cell's entries added in stream order (the
    same bits on every run, a serial scatter-add's)."""
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
    if idx.numel() > _INT_MAX:
        raise ValueError(f"segment_replay: a stream of {idx.numel()} "
                         f"entries, above {_INT_MAX}")
    lib = _build.load("fused_eval")
    out = torch.empty(n, dtype=torch.float64, device=idx.device)
    device = idx.device.index or 0
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    # the cell ranges' scratch, kept per card and stream: each launch
    # leaves it as it found it, so only a new one is set first
    key = (device, stream)
    need = 2 * -(-n // REPLAY_MIN_CELLS)
    ranges = _REPLAY_RANGES.get(key)
    fresh = ranges is None or ranges.numel() < need
    if fresh:
        ranges = torch.empty(need, dtype=torch.int32, device=idx.device)
        _REPLAY_RANGES[key] = ranges
    code = lib.segment_replay_f64(idx.data_ptr(), vals.data_ptr(),
                                  idx.numel(), out.data_ptr(), n,
                                  ranges.data_ptr(), int(fresh), device,
                                  stream)
    if code != 0:
        _REPLAY_RANGES.pop(key, None)
    _build.check(lib, "segment_replay", code)
    segment_replay.launches += 1
    return out


segment_replay.launches = 0
# segment_replay's scratch by (card, stream handle)
_REPLAY_RANGES: Dict[Tuple[int, int], torch.Tensor] = {}

_obs_metrics.register_collector(lambda: {
    "fused_eval.launches": fused_eval.launches,
    "segment_replay.launches": segment_replay.launches,
})
