"""Operations and bytes, counted from the configuration's widths and the
shapes handed to the model, never from the program's launch list; and
the peaks they are held against.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 989 TFLOP/s in
bf16 on the tensor cores, 3.35 TB/s of HBM.  No derived rate (such as a
3xTF32 one) is used.  A roofline's least time is the larger of the
operations over the FLOP peak and the bytes over the HBM peak, each input
read once and each output written once.
"""

from __future__ import annotations

import math
from typing import Dict

PEAK_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
BYTES = {"float32": 4, "bfloat16": 2}


def least_time(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def widths(m: Dict) -> Dict[str, int]:
    d = int(m["d_model"])
    d_in = int(m["ssm_expand"]) * d
    P = int(m["ssm_headdim"])
    return {"d": d, "d_in": d_in, "P": P, "H": d_in // P,
            "G": int(m["ssm_groups"]), "N": int(m["ssm_state"]),
            "L": int(m["n_layers"]), "V": -(-int(m["vocab"]) // 256) * 256}


def block_matmul_params(m: Dict) -> int:
    """Weights of the linear layers applied to each token in one pass
    (every layer), without the head."""
    w = widths(m)
    proj = 2 * w["d_in"] + 2 * w["G"] * w["N"] + w["H"]
    return w["L"] * (w["d"] * proj + w["d_in"] * w["d"])


def head_params(m: Dict) -> int:
    w = widths(m)
    return w["V"] * w["d"]


def ssd_token_flops(m: Dict) -> int:
    """The SSD's own operations a token, all layers, in its recurrent
    form: ``B x^T`` into the (N, P) state and ``C h`` out of it, per head,
    plus the width-4 causal conv over ``[x, B, C]``."""
    w = widths(m)
    conv = 2 * 4 * (w["d_in"] + 2 * w["G"] * w["N"])
    return w["L"] * (4 * w["H"] * w["N"] * w["P"] + conv)


def prefill_flops(m: Dict, T: int) -> int:
    """Model operations of one prompt of ``T`` real tokens: every layer
    at each token, the head at the last position only."""
    return 2 * block_matmul_params(m) * T + ssd_token_flops(m) * T \
        + 2 * head_params(m)


def train_flops(m: Dict, B: int, S: int) -> int:
    """Model operations of one training step of ``B`` sequences of ``S``
    tokens: three times the forward (the backward counts two), the head
    at every position; recomputation is not counted."""
    fwd = 2 * (block_matmul_params(m) + head_params(m)) * S \
        + ssd_token_flops(m) * S
    return 3 * B * fwd


def ssd_chunk_work(m: Dict, B: int, L: int) -> tuple:
    """(FLOPs, bytes) of the chunked SSD's per-chunk form over a prefill
    of ``B`` rows of ``L`` positions, all layers, in the configuration's
    chunks (``ssm_chunk``): the causal half of ``C B^T`` once a group, the
    masked scores times ``x`` per head, and the chunk states
    ``B^T (decay x)`` per head.  It reads x, dt, B and C and writes the
    intra-chunk output and the chunk states, all in the configuration's
    compute type."""
    w = widths(m)
    Q = int(m["ssm_chunk"])
    BC = B * math.ceil(L / Q)
    H, P, N, G = w["H"], w["P"], w["N"], w["G"]
    tri = Q * (Q + 1) // 2
    flops = BC * (G * tri * N * 2 + H * tri * P * 2 + H * Q * N * P * 2)
    nbytes = BC * (2 * Q * H * P + Q * H + 2 * Q * G * N + H * N * P) \
        * BYTES[m["compute_dtype"]]
    return w["L"] * flops, w["L"] * nbytes
