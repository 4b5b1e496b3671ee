"""Mamba-2 SSD per-chunk quadratic form: the port of the Pallas
``ssd_chunk_dual`` (``src/repro/kernels/mamba_ssd.py:48``).

``ssd_chunk_dual(x, cum, Bm, Cm)`` launches the CUDA kernel of
``csrc/mamba_ssd.cu`` (tensor cores, f32 accuracy, f32 outputs, as the
reference) for tensors on the card and runs the plain version
(:func:`repro_torch.kernels.ref.ssd_chunk_ref`) for tensors on the CPU.  It
takes x and cum f32 with B and C f32 or bf16 (as the reference's
``ssd_forward`` hands B and C in the model's type), or all four bf16.  A
CUDA tensor never falls back: what the kernel does not take raises.
``ssd_chunk_dual.launches`` counts kernel launches; :func:`kernel_route`
names the instance (by the state width: N <= 64 or N <= 128) and copy
width a launch takes, :func:`heads_per_block` the heads one block takes
(the scores C Bᵀ are computed once a block, for all of them).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .ref import ssd_chunk_ref

MAX_CHUNK = 128
MAX_STATE = 128


# head-dim columns of the narrowest unit of the kernel's work
# (csrc/mamba_ssd.cu): the range check counts P in these
P_TILE = 64


def ssd_chunk_dual(x: torch.Tensor, cum: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BC, Q, H, P) discretized inputs per flattened (batch*chunk);
    cum (BC, Q, H) cumulative log-decay within the chunk; Bm/Cm (BC, Q, N)
    (n_groups = 1).  Returns (y_intra (BC, Q, H, P), chunk_state
    (BC, H, N, P)), both f32 whatever the inputs' types."""
    args = (x, cum, Bm, Cm)
    if all(a.device.type == "cpu" for a in args):
        return ssd_chunk_ref(x, cum, Bm, Cm)
    if x.device.type != "cuda" or any(a.device != x.device for a in args):
        raise ValueError("ssd_chunk_dual: x, cum, Bm, Cm must lie on one "
                         "card")
    _build.refuse_grad("ssd_chunk_dual", args)
    suffix = _build.ssd_dtype_suffix("ssd_chunk_dual", *args)
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
            or BC * H > 2**31 - 1 or -(-P // P_TILE) > 65535:
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
    for these CUDA tensors, e.g. ``"N64 P64 cp.async16"`` or ``"N128 P64
    cp.async16 mixed"``: the instance (``N64`` for N <= 64, ``N128``
    above), the head-dim columns of a unit of a block's work (``P128`` for
    bf16 x at N <= 64 and P > 64, else ``P64``), the copy width (16 bytes
    where P and N are multiples of 16 bytes of their types and x, Bm, Cm
    are 16-byte aligned, else one element: ``cp.async4`` for f32, ``ld2``
    for bf16, ``cp.async4+ld2`` for the mix), then `` bf16`` or
    `` mixed`` (x f32, B and C bf16)."""
    lib = _build.load("mamba_ssd")
    return lib.ssd_chunk_dual_route(x.shape[3], Bm.shape[2], x.data_ptr(),
                                    Bm.data_ptr(), Cm.data_ptr(),
                                    x.element_size(),
                                    Bm.element_size()).decode()


def heads_per_block(x: torch.Tensor, Bm: torch.Tensor) -> int:
    """The heads one block of ``ssd_chunk_dual`` takes for CUDA ``x``
    (BC, Q, H, P) and ``Bm`` (BC, Q, N) on their card: the grid-fill rule
    of csrc/mamba_ssd.cu (the least waves x (units a block + 1))."""
    lib = _build.load("mamba_ssd")
    BC, _, H, P = x.shape
    return lib.ssd_chunk_dual_heads(BC, H, P, Bm.shape[2], x.element_size(),
                                    x.device.index or 0)
