"""The chunked SSD's inter-chunk pass: the port of the recurrence and the
inter-chunk output of the jitted ``ssd_forward``
(``src/repro/kernels/ops.py:51-99``) and of ``nn/mamba2.py::ssd_chunked``
(``src/repro/nn/mamba2.py:73-89``).

``ssd_state_pass(y_intra, S, cum, Cm, init_state)`` launches the CUDA
kernel of ``csrc/ssd_state.cu`` (f32) for tensors on the card and runs the
plain version (:func:`repro_torch.kernels.ref.ssd_state_ref`) for tensors
on the CPU.  A CUDA tensor never falls back: what the kernel does not take
raises.  ``ssd_state_pass.launches`` counts kernel launches;
:func:`kernel_route` names the copy width a launch takes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .ref import ssd_state_ref

MAX_SMEM = 232448               # bytes of shared memory a block may take
P_TILE = 64                     # head-dim columns a block of the kernel takes


def smem_bytes(Q: int, N: int) -> int:
    """Shared memory of one block: the (N, 64) state and S tiles (N padded
    to a multiple of 4), two buffers of the chunk's C rows (rows padded by
    4 floats) and two of its cum."""
    N4 = -(-N // 4) * 4
    return 4 * (2 * N4 * P_TILE + 2 * Q * (N4 + 4) + 2 * Q)


def ssd_state_pass(y_intra: torch.Tensor, S: torch.Tensor, cum: torch.Tensor,
                   Cm: torch.Tensor, init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_intra (B, nc, Q, H, P), S (B, nc, H, N, P), cum (B, nc, Q, H),
    Cm (B, nc, Q, G, N), init_state (B, H, N, P) or None, all f32.  Returns
    (y = y_intra + y_inter (B, nc, Q, H, P), final state (B, H, N, P)),
    f32.  Shapes are checked on every device; then CPU tensors run the
    plain version."""
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
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError(f"ssd_state_pass: the kernel takes float32; got "
                        f"{[str(a.dtype) for a in args]}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("ssd_state_pass: the inputs must be contiguous")
    if min(B, nc, Q, H, P, N) < 1 or max(B, H, -(-P // P_TILE)) > 65535 \
            or smem_bytes(Q, N) > MAX_SMEM:
        raise ValueError(f"ssd_state_pass: B={B} nc={nc} Q={Q} H={H} P={P} "
                         f"N={N} out of the kernel's range (B, H <= 65535; "
                         f"Q and N within {MAX_SMEM} bytes of shared memory)")
    y = torch.empty_like(y_intra)
    h = torch.empty((B, H, N, P), device=y_intra.device, dtype=torch.float32)
    lib = _build.load("ssd_state")
    stream = torch.cuda.current_stream(y_intra.device).cuda_stream
    code = lib.ssd_state_pass_f32(
        y_intra.data_ptr(), S.data_ptr(), cum.data_ptr(), Cm.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), h.data_ptr(), B, nc, Q, H, P, N, G,
        y_intra.device.index or 0, stream)
    _build.check(lib, "ssd_state_pass", code)
    ssd_state_pass.launches += 1
    return y, h


ssd_state_pass.launches = 0


def kernel_route(S: torch.Tensor, Cm: torch.Tensor) -> str:
    """The copy width ``ssd_state_pass`` takes for these CUDA tensors:
    ``"cp.async16"`` where N and P are multiples of 4 and C and S are
    16-byte aligned, else ``"cp.async4"``."""
    lib = _build.load("ssd_state")
    return lib.ssd_state_pass_route(Cm.shape[-1], S.shape[-1], Cm.data_ptr(),
                                    S.data_ptr()).decode()
