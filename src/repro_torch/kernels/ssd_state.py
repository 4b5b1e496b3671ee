"""The chunked SSD's inter-chunk pass: the port of the recurrence and the
inter-chunk output of the jitted ``ssd_forward``
(``src/repro/kernels/ops.py:51-99``) and of ``nn/mamba2.py::ssd_chunked``
(``src/repro/nn/mamba2.py:73-89``).

``ssd_state_pass(y_intra, S, cum, Cm, init_state)`` is the one entry point.
For tensors on the card it takes one of two routes of ``csrc/ssd_state.cu``
(f32; the product C . h on the tensor cores in 3xTF32), by
:func:`state_route`: the walk (:func:`ssd_state_walk`, one block per (P
tile, head, batch) walking the chunks) where its blocks fill the walks the
card runs at once, else the split (:func:`ssd_state_scan`, the states of
every chunk, then :func:`ssd_state_out`, every chunk's output in parallel,
:func:`out_heads` heads a block).  For tensors on the CPU it runs the
plain version (:func:`repro_torch.kernels.ref.ssd_state_ref`).  A CUDA
tensor never falls back: what the kernels do not take raises.  Each
kernel's wrapper counts its launches (``ssd_state_walk.launches``, ...);
:func:`kernel_route` names the route and copy width a launch takes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .ref import ssd_state_out_ref, ssd_state_ref, ssd_state_scan_ref

MAX_SMEM = 232448               # bytes of shared memory a block may take
P_TILE = 64                     # head-dim columns a block of the kernels takes
MAX_STATE = 128                 # the largest state width N the kernels take
# SMs of an H100 SXM, the card the port is written for: the count the
# route rule assumes where the program's device is not a card (a plan
# counted on the CPU)
H100_SMS = 132
# the kernels each route launches, in order
ROUTE_KERNELS = {"walk": ("ssd_state_walk",),
                 "split": ("ssd_state_scan", "ssd_state_out")}


def smem_bytes(Q: int, N: int) -> int:
    """Shared memory of one block of the walk (a block of the split's
    outputs takes less): the (N, 64) state tile split in its TF32 hi and lo
    parts (N padded to a multiple of 8, rows of 72 floats), two buffers of
    the chunk's C rows (rows of N8 + 4 floats) and two of its cum."""
    N8 = -(-N // 8) * 8
    return 4 * (2 * N8 * (P_TILE + 8) + 2 * Q * (N8 + 4) + 2 * Q)


def sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` names; :data:`H100_SMS` for any other
    device."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def walk_slots(N: int, sms: int) -> int:
    """Blocks of the walk the card runs at once: two an SM at N <= 64 (128
    registers a thread), one above (a block takes more than half an SM's
    shared memory)."""
    return sms * (2 if N <= 64 else 1)


def state_route(B: int, H: int, P: int, N: int, sms: int) -> str:
    """The route rule: the walk runs one block per (64-column P tile, head,
    batch), each a sequential walk over the chunks, and the blocks of a
    wave walk in step, so a wave the walk leaves partly empty takes as long
    as a full one.  ``"walk"`` where its B * H * ceil(P / 64) blocks fill
    the :func:`walk_slots` of their last wave to at least 5/6, else
    ``"split"``: on an H100 at 8 chunks the walk was the faster route from
    112 to 132 blocks and at 256 with N = 128, at 256 with N = 64, and the
    split below and at 160 (``benchmarks/port_kernel_variants.py``;
    PERF.md)."""
    blocks, slots = B * H * -(-P // P_TILE), walk_slots(N, sms)
    waves = -(-blocks // slots)
    return "walk" if 6 * blocks >= 5 * waves * slots else "split"


def out_heads(BC: int, H: int, G: int, P: int, sms: int) -> int:
    """Heads one block of :func:`ssd_state_out` takes: C rows and cum of
    the chunk are copied once for all of them, and the next head's state
    tile is loaded during the current head's product.  The most of 4, 2
    and 1 that divides a group's H // G heads and still gives the grid of
    BC * (H / heads) * ceil(P / 64) blocks about two blocks an SM (at
    least 15/8: 256 blocks pass on an H100's 132); else 1."""
    tiles = -(-P // P_TILE)
    for heads in (4, 2):
        if (H // G) % heads == 0 \
                and 8 * BC * (H // heads) * tiles >= 15 * sms:
            return heads
    return 1


def route_kernels(B: int, H: int, P: int, N: int, device: torch.device
                  ) -> Tuple[str, ...]:
    """The kernels ``ssd_state_pass`` launches for a (B, H, P, N) pass on
    ``device``, in order (the plan's declared launches)."""
    return ROUTE_KERNELS[state_route(B, H, P, N, sm_count(device))]


def _check_card(name: str, args, Q: int, N: int, dims) -> None:
    """Raise unless ``args`` (None skipped) are contiguous f32 tensors on
    one card and the shapes are within the kernels' range."""
    args = [a for a in args if a is not None]
    dev = args[0].device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError(f"{name}: the inputs must lie on one card")
    _build.refuse_grad(name, args)
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError(f"{name}: the kernel takes float32; got "
                        f"{[str(a.dtype) for a in args]}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError(f"{name}: the inputs must be contiguous")
    if min(dims) < 1 or max(dims) > 65535 or not 1 <= N <= MAX_STATE \
            or smem_bytes(Q, N) > MAX_SMEM:
        raise ValueError(f"{name}: shape {tuple(dims)} with Q={Q} N={N} out "
                         f"of the kernel's range (B, H, P tiles <= 65535; "
                         f"1 <= N <= {MAX_STATE}; Q and N within {MAX_SMEM} "
                         f"bytes of shared memory)")


def _launch(name: str, lib, *args) -> None:
    _build.check(lib, name, getattr(lib, f"{name}_f32")(*args))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ssd_state_walk(y_intra: torch.Tensor, S: torch.Tensor,
                   cum: torch.Tensor, Cm: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk on the card (shapes as :func:`ssd_state_pass`, already
    checked there): (y, final state)."""
    B, nc, Q, H, P = y_intra.shape
    G, N = Cm.shape[3], Cm.shape[4]
    _check_card("ssd_state_walk", (y_intra, S, cum, Cm, init_state), Q, N,
                (B, H, -(-P // P_TILE)))
    y = torch.empty_like(y_intra)
    h = torch.empty((B, H, N, P), device=y.device, dtype=torch.float32)
    _launch("ssd_state_walk", _build.load("ssd_state"), y_intra.data_ptr(),
            S.data_ptr(), cum.data_ptr(), Cm.data_ptr(), _ptr(init_state),
            y.data_ptr(), h.data_ptr(), B, nc, Q, H, P, N, G,
            y.device.index or 0, _stream(y))
    ssd_state_walk.launches += 1
    return y, h


ssd_state_walk.launches = 0


def ssd_state_scan(S: torch.Tensor, cum: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split's states: S (B, nc, H, N, P), cum (B, nc, Q, H),
    init_state (B, H, N, P) or None -> (the state before each chunk (B, nc,
    H, N, P), the final state (B, H, N, P)), f32.  CPU tensors run
    :func:`repro_torch.kernels.ref.ssd_state_scan_ref`."""
    B, nc, H, N, P = S.shape
    Q = cum.shape[2]
    if tuple(cum.shape) != (B, nc, Q, H) or (
            init_state is not None
            and tuple(init_state.shape) != (B, H, N, P)):
        raise ValueError(f"ssd_state_scan: shapes {tuple(S.shape)}, "
                         f"{tuple(cum.shape)} do not agree")
    if all(a.device.type == "cpu" for a in (S, cum, init_state)
           if a is not None):
        return ssd_state_scan_ref(S, cum, init_state)
    _check_card("ssd_state_scan", (S, cum, init_state), Q, N, (B, H))
    hb = torch.empty_like(S)
    h = torch.empty((B, H, N, P), device=S.device, dtype=torch.float32)
    _launch("ssd_state_scan", _build.load("ssd_state"), S.data_ptr(),
            cum.data_ptr(), _ptr(init_state), hb.data_ptr(), h.data_ptr(),
            B, nc, Q, H, P, N, S.device.index or 0, _stream(S))
    ssd_state_scan.launches += 1
    return hb, h


ssd_state_scan.launches = 0


def ssd_state_out(y_intra: torch.Tensor, h_before: torch.Tensor,
                  cum: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """The split's outputs: y_intra (B, nc, Q, H, P), h_before (B, nc, H,
    N, P), cum (B, nc, Q, H), Cm (B, nc, Q, G, N) -> y = y_intra + exp(cum)
    * (C . h_before) (B, nc, Q, H, P), f32.  CPU tensors run
    :func:`repro_torch.kernels.ref.ssd_state_out_ref`."""
    B, nc, Q, H, P = y_intra.shape
    G, N = Cm.shape[3], Cm.shape[4]
    if tuple(h_before.shape) != (B, nc, H, N, P) \
            or tuple(cum.shape) != (B, nc, Q, H) \
            or tuple(Cm.shape[:3]) != (B, nc, Q) or H % G:
        raise ValueError(f"ssd_state_out: shapes {tuple(y_intra.shape)}, "
                         f"{tuple(h_before.shape)}, {tuple(cum.shape)}, "
                         f"{tuple(Cm.shape)} do not agree")
    args = (y_intra, h_before, cum, Cm)
    if all(a.device.type == "cpu" for a in args):
        return ssd_state_out_ref(*args)
    _check_card("ssd_state_out", args, Q, N, (H, -(-P // P_TILE)))
    if B * nc > 2**31 - 1:
        raise ValueError(f"ssd_state_out: B * nc = {B * nc} past 2^31 - 1")
    heads = out_heads(B * nc, H, G, P, sm_count(y_intra.device))
    y = torch.empty_like(y_intra)
    _launch("ssd_state_out", _build.load("ssd_state"), y_intra.data_ptr(),
            h_before.data_ptr(), cum.data_ptr(), Cm.data_ptr(), y.data_ptr(),
            B, nc, Q, H, P, N, G, heads, y.device.index or 0, _stream(y))
    ssd_state_out.launches += 1
    return y


ssd_state_out.launches = 0


def ssd_state_pass(y_intra: torch.Tensor, S: torch.Tensor, cum: torch.Tensor,
                   Cm: torch.Tensor, init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_intra (B, nc, Q, H, P), S (B, nc, H, N, P), cum (B, nc, Q, H),
    Cm (B, nc, Q, G, N), init_state (B, H, N, P) or None, all f32.  Returns
    (y = y_intra + y_inter (B, nc, Q, H, P), final state (B, H, N, P)),
    f32.  Shapes are checked on every device; then CPU tensors run the
    plain version, and CUDA tensors the route :func:`state_route` picks for
    the card."""
    args = (y_intra, S, cum, Cm) + (() if init_state is None
                                    else (init_state,))
    if y_intra.dim() != 5 or S.dim() != 5 or cum.dim() != 4 \
            or Cm.dim() != 5:
        raise ValueError(f"ssd_state_pass: shapes {tuple(y_intra.shape)}, "
                         f"{tuple(S.shape)}, {tuple(cum.shape)}, "
                         f"{tuple(Cm.shape)} are not (B, nc, Q, H, P), "
                         f"(B, nc, H, N, P), (B, nc, Q, H), (B, nc, Q, G, N)")
    B, nc, Q, H, P = y_intra.shape
    G, N = Cm.shape[3], Cm.shape[4]
    if tuple(S.shape) != (B, nc, H, N, P) \
            or tuple(cum.shape) != (B, nc, Q, H) \
            or tuple(Cm.shape[:3]) != (B, nc, Q) or G < 1 or H % G \
            or (init_state is not None
                and tuple(init_state.shape) != (B, H, N, P)):
        raise ValueError(f"ssd_state_pass: shapes {tuple(y_intra.shape)}, "
                         f"{tuple(S.shape)}, {tuple(cum.shape)}, "
                         f"{tuple(Cm.shape)}"
                         + ("" if init_state is None
                            else f", {tuple(init_state.shape)}")
                         + " do not agree (S (B, nc, H, N, P), cum "
                         "(B, nc, Q, H), Cm (B, nc, Q, G, N) with H % G == 0, "
                         "init_state (B, H, N, P))")
    if all(a.device.type == "cpu" for a in args):
        return ssd_state_ref(y_intra, S, cum, Cm, init_state)
    if y_intra.device.type != "cuda" \
            or any(a.device != y_intra.device for a in args):
        raise ValueError("ssd_state_pass: y_intra, S, cum, Cm and "
                         "init_state must lie on one card")
    if state_route(B, H, P, N, sm_count(y_intra.device)) == "walk":
        return ssd_state_walk(y_intra, S, cum, Cm, init_state)
    hb, h = ssd_state_scan(S, cum, init_state)
    return ssd_state_out(y_intra, hb, cum, Cm), h


def copy_width(Cm: torch.Tensor, rows: torch.Tensor) -> str:
    """The copy width a launch that reads C and the (N, P) state rows
    ``rows`` takes (S for the walk, h_before for the split's outputs):
    ``"cp.async16"`` where N and P are multiples of 4 and both tensors are
    16-byte aligned, else ``"cp.async4"``."""
    lib = _build.load("ssd_state")
    return lib.ssd_state_pass_route(Cm.shape[-1], rows.shape[-1],
                                    Cm.data_ptr(), rows.data_ptr()).decode()


def kernel_route(S: torch.Tensor, Cm: torch.Tensor) -> str:
    """The route and copy width ``ssd_state_pass`` takes for these CUDA
    tensors, e.g. ``"walk cp.async16"`` or ``"split cp.async4"``: the
    route :func:`state_route` picks, and the :func:`copy_width` of the rows
    it reads: S for the walk; for the split the h_before that
    :func:`ssd_state_scan` allocates, whose alignment a fresh allocation on
    the card shows."""
    B, _, H, N, P = S.shape
    if state_route(B, H, P, N, sm_count(S.device)) == "walk":
        return f"walk {copy_width(Cm, S)}"
    return f"split {copy_width(Cm, S.new_empty((N, P)))}"
