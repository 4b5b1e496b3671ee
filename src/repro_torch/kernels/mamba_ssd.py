"""Mamba-2 SSD per-chunk quadratic form: the port of the Pallas
``ssd_chunk_dual`` (``src/repro/kernels/mamba_ssd.py:48``).

``ssd_chunk_dual(x, cum, Bm, Cm)`` launches the CUDA kernel of
``csrc/mamba_ssd.cu`` (3xTF32 on the tensor cores, f32 accuracy; f32 or
bf16 inputs, f32 outputs, as the reference) for tensors on the card and
runs the plain version
(:func:`repro_torch.kernels.ref.ssd_chunk_ref`) for tensors on the CPU.  A
CUDA tensor never falls back: what the kernel does not take raises.
``ssd_chunk_dual.launches`` counts kernel launches; :func:`kernel_route`
names the instance (by the state width: N <= 64 takes a 128-column P
tile, N <= 128 a 64-column one) and copy width a launch takes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .ref import ssd_chunk_ref

MAX_CHUNK = 128
MAX_STATE = 128


def p_tile(N: int) -> int:
    """Head-dim columns a block of the kernel takes at state width N: 128
    for N <= 64, 64 above (the shared-memory budget of csrc/mamba_ssd.cu)."""
    return 128 if N <= 64 else 64


def ssd_chunk_dual(x: torch.Tensor, cum: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BC, Q, H, P) discretized inputs per flattened (batch*chunk);
    cum (BC, Q, H) cumulative log-decay within the chunk; Bm/Cm (BC, Q, N)
    (n_groups = 1).  Returns (y_intra (BC, Q, H, P), chunk_state
    (BC, H, N, P)), both f32 whether the inputs are f32 or bf16."""
    args = (x, cum, Bm, Cm)
    if all(a.device.type == "cpu" for a in args):
        return ssd_chunk_ref(x, cum, Bm, Cm)
    if x.device.type != "cuda" or any(a.device != x.device for a in args):
        raise ValueError("ssd_chunk_dual: x, cum, Bm, Cm must lie on one "
                         "card")
    _build.refuse_grad("ssd_chunk_dual", args)
    suffix = _build.dtype_suffix("ssd_chunk_dual", args)
    if x.dim() != 4 or cum.dim() != 3 or Bm.dim() != 3 \
            or Bm.shape != Cm.shape or cum.shape != x.shape[:3] \
            or Bm.shape[:2] != x.shape[:2]:
        raise ValueError(f"ssd_chunk_dual: shapes {tuple(x.shape)}, "
                         f"{tuple(cum.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)} are not (BC, Q, H, P), "
                         f"(BC, Q, H), (BC, Q, N) x 2")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("ssd_chunk_dual: x, cum, Bm, Cm must be contiguous")
    BC, Q, H, P = x.shape
    N = Bm.shape[2]
    if min(BC, Q, H, P, N) < 1 or Q > MAX_CHUNK or N > MAX_STATE \
            or BC * H > 2**31 - 1 or -(-P // p_tile(N)) > 65535:
        raise ValueError(f"ssd_chunk_dual: BC={BC} Q={Q} H={H} P={P} N={N} "
                         f"out of the kernel's range (1 <= Q <= {MAX_CHUNK}, "
                         f"1 <= N <= {MAX_STATE}, BC*H < 2^31)")
    y = torch.empty(x.shape, device=x.device, dtype=torch.float32)
    state = torch.empty((BC, H, N, P), device=x.device, dtype=torch.float32)
    lib = _build.load("mamba_ssd")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch = getattr(lib, f"ssd_chunk_dual_{suffix}")
    code = launch(x.data_ptr(), cum.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                  y.data_ptr(), state.data_ptr(), BC, Q, H, P, N,
                  x.device.index or 0, stream)
    _build.check(lib, "ssd_chunk_dual", code)
    ssd_chunk_dual.launches += 1
    return y, state


ssd_chunk_dual.launches = 0


def kernel_route(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor) -> str:
    """The kernel configuration ``ssd_chunk_dual(x, cum, Bm, Cm)`` launches
    for these CUDA tensors, e.g. ``"P128 cp.async16"`` or ``"P64 N128
    cp.async16"``: the instance (``P128`` for N <= 64, ``P64 N128`` above)
    and the copy width (16 bytes where P and N are multiples of 4 f32 or 8
    bf16 elements and x, Bm, Cm are 16-byte aligned, else one element:
    ``cp.async4`` for f32, ``ld2`` for bf16, whose routes end in
    `` bf16``)."""
    lib = _build.load("mamba_ssd")
    return lib.ssd_chunk_dual_route(x.shape[3], Bm.shape[2], x.data_ptr(),
                                    Bm.data_ptr(), Cm.data_ptr(),
                                    x.element_size()).decode()
