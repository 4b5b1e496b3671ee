"""Plain PyTorch versions of the kernels (the allclose targets).

Port of the oracles of ``src/repro/kernels/ref.py``: f32 math, the JAX
package's layouts; the chunked SSD's inter-chunk pass (``ssd_state_ref``:
the ``lax.scan`` and output of ``src/repro/kernels/ops.py:72-93``, with
the model's groups and initial state), which is its two halves composed,
``ssd_state_scan_ref`` (the states) and ``ssd_state_out_ref`` (the
outputs); and the plain versions of the cost
model's two kernels, ``segment_replay_ref`` and ``fused_eval_ref`` (the
jitted functions of
``src/repro/core/analyzer.py:60-92`` and ``src/repro/core/evaluator.py:97-179``).
On the CPU the kernel wrappers run these; on the card they are what each
kernel is held against.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

# the running max of a row with no visible key, in the reference's
# attention statistics (src/repro/nn/attention.py:22); the flash kernel
# writes the same value (csrc/flash_attention.cu)
NEG_INF = -2.0e38


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0,
                  return_stats: bool = False
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Naive softmax attention.  q/k/v: (B, H, S, D), MHA layout.  The causal
    mask is ``q_offset + q_pos >= k_pos``, both counted from 0 (top-left
    aligned at ``q_offset = 0``); masked scores are the finite -1e30, as in
    the reference.  With ``return_stats`` also each row's online-softmax
    statistics, f32 (B, H, Sq): ``m`` the max of the scaled scores and
    ``l = sum exp(s - m)`` over the visible keys.  With no key (Sk = 0) the
    output is 0, ``m`` the reference's ``NEG_INF`` (-2e38) and ``l`` 0."""
    D = q.shape[-1]
    if k.shape[2] == 0:
        out = torch.zeros_like(q)
        if not return_stats:
            return out
        B, H, Sq = q.shape[:3]
        return (out, torch.full((B, H, Sq), NEG_INF, device=q.device),
                torch.zeros((B, H, Sq), device=q.device))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        mask = (q_offset + torch.arange(Sq, device=s.device)[:, None]
                >= torch.arange(Sk, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if not return_stats:
        return out
    m = s.amax(dim=-1)
    return out, m, torch.exp(s - m[..., None]).sum(dim=-1)


def ssd_chunk_ref(x: torch.Tensor, cum: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk SSD quadratic form (oracle of ``ssd_chunk_dual``), f32.

    x (BC, Q, H, P); cum (BC, Q, H) cumulative log-decay within the chunk;
    Bm/Cm (BC, Q, N).  Returns ``y = ((C Bᵀ) ⊙ L) X`` (BC, Q, H, P) with
    ``L[i, j, h] = exp(cum_i - cum_j)`` for i >= j, else 0, and the chunk
    state ``S = Σ_j B_j ⊗ exp(cum_last - cum_j) X_j`` (BC, H, N, P).

    The masked decay is exp(-inf) = 0 above the diagonal, so no
    overflowing exp is ever formed; ``(scores ⊙ L)`` meets x in a batched
    product over (chunk, head), so no (BC, Q, Q, H, P) tensor exists."""
    xf, cumf = x.float(), cum.float()
    Bf, Cf = Bm.float(), Cm.float()
    Q = x.shape[1]
    scores = torch.bmm(Cf, Bf.transpose(1, 2))                 # (BC, Qi, Qj)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    diff = cumf.transpose(1, 2)[:, :, :, None] \
        - cumf.transpose(1, 2)[:, :, None, :]                  # (BC, H, Qi, Qj)
    L = diff.masked_fill(~keep, float("-inf")).exp()
    xh = xf.permute(0, 2, 1, 3)                                # (BC, H, Qj, P)
    y = torch.matmul(scores[:, None] * L, xh).permute(0, 2, 1, 3)
    decay_end = (cumf[:, -1:, :] - cumf).exp()                 # (BC, Q, H)
    xd = (xf * decay_end[..., None]).permute(0, 2, 1, 3)       # (BC, H, Q, P)
    state = torch.matmul(Bf.transpose(1, 2)[:, None], xd)      # (BC, H, N, P)
    return y.contiguous(), state


def ssd_state_scan_ref(S: torch.Tensor, cum: torch.Tensor,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The states of the SSD inter-chunk pass (oracle of
    ``ssd_state_scan``), f32: the recurrence ``h <- h * exp(tot_c) + S_c``
    with ``tot_c = cum[:, c, Q - 1]`` as a loop over chunks (``lax.scan``
    in the reference).  S (B, nc, H, N, P), cum (B, nc, Q, H), init_state
    (B, H, N, P) or None for zeros.  Returns (the state before each chunk
    (B, nc, H, N, P), the final state (B, H, N, P))."""
    Bsz, nc, H, N, P = S.shape
    tot = cum.float()[:, :, -1]                          # (B, nc, H)
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=S.device)
         if init_state is None else init_state.float())
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = h * tot[:, c].exp()[..., None, None] + S[:, c].float()
    return torch.stack(h_before, dim=1), h


def ssd_state_out_ref(y_intra: torch.Tensor, h_before: torch.Tensor,
                      cum: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """The outputs of the SSD inter-chunk pass (oracle of
    ``ssd_state_out``), f32: ``y = y_intra + exp(cum) * (C . h_before)``.
    y_intra (B, nc, Q, H, P), h_before (B, nc, H, N, P), cum (B, nc, Q, H),
    Cm (B, nc, Q, G, N) (head h reads group h // (H // G), ``jnp.repeat``
    order).  Returns y (B, nc, Q, H, P)."""
    H, G = y_intra.shape[3], Cm.shape[3]
    Ch = Cm.float().repeat_interleave(H // G, dim=3)     # (B, nc, Q, H, N)
    # y_inter[b,c,q,h,p] = sum_n C[b,c,q,h,n] hb[b,c,h,n,p] exp(cum[b,c,q,h])
    y_inter = torch.matmul(Ch.transpose(2, 3), h_before.float()) \
        .transpose(2, 3) * cum.float().exp()[..., None]
    return y_intra.float() + y_inter


def ssd_state_ref(y_intra: torch.Tensor, S: torch.Tensor, cum: torch.Tensor,
                  Cm: torch.Tensor, init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD's inter-chunk pass (oracle of ``ssd_state_pass``),
    f32: the states (:func:`ssd_state_scan_ref`), then the outputs
    (:func:`ssd_state_out_ref`).

    y_intra (B, nc, Q, H, P), S (B, nc, H, N, P), cum (B, nc, Q, H),
    Cm (B, nc, Q, G, N), init_state (B, H, N, P) or None for zeros.
    Returns (y (B, nc, Q, H, P), final state (B, H, N, P))."""
    h_before, h = ssd_state_scan_ref(S, cum, init_state)
    return ssd_state_out_ref(y_intra, h_before, cum, Cm), h


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) in f32, cast to ``out_dtype`` (default: a's)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def segment_replay_ref(idx: torch.Tensor, vals: torch.Tensor,
                       n: int) -> torch.Tensor:
    """``segment_sum(vals, idx, n)``: a scatter-add of ``vals`` into ``n``
    zeroed cells of their type (oracle of ``segment_replay``)."""
    return torch.zeros(n, dtype=vals.dtype, device=vals.device) \
        .scatter_add_(0, idx.long(), vals)


def fused_eval_ref(off: torch.Tensor, idx: torch.Tensor,
                   vals: torch.Tensor, npass: torch.Tensor,
                   depth: torch.Tensor, wts: torch.Tensor, *,
                   spans: torch.Tensor, d2d_mask: torch.Tensor,
                   consts: torch.Tensor, has_d2d: bool, buf_len: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The evaluator's fused pass (oracle of ``fused_eval``), f32.

    Sums row ``b``'s entries ``idx[off[b]:off[b+1]]`` (cells of that row,
    in ``[0, buf_len)``; raises on offsets that do not run from 0 up to
    the stream's length and on an index outside the row) into ``B`` rows
    of ``buf_len`` cells, then per row the math of the reference's
    ``_build_fused_fn`` (``src/repro/core/evaluator.py:131-177``): the four
    resource times (maxima with initial 0), stage time, first-max
    bottleneck, GLB-overflow penalty, delay and the five energies.
    ``spans`` (10, 2) are the analyzer's target columns, ``d2d_mask`` the
    D2D links among the edges, ``consts`` the slots of
    :data:`repro_torch.kernels.fused_eval.CONSTS`.  Returns ``(out (9, B)
    f32 in OUT_ROWS order, bottleneck (B,) int32)``."""
    B, n = npass.shape[0], idx.shape[0]
    off = off.long()
    counts = off.diff()
    if off.shape[0] != B + 1 or int(off[0]) != 0 or int(off[-1]) != n \
            or bool((counts < 0).any()):
        raise ValueError(f"fused_eval: offsets {off.tolist()[:8]}... do "
                         f"not run from 0 up to the stream's {n} entries "
                         f"over {B} rows")
    if n and (int(idx.min()) < 0 or int(idx.max()) >= buf_len):
        raise ValueError(f"fused_eval: an index outside [0, {buf_len}) of "
                         f"its row")
    rows = torch.repeat_interleave(
        torch.arange(B, device=idx.device), counts.to(idx.device))
    buf = segment_replay_ref(rows * buf_len + idx.long(), vals.float(),
                             B * buf_len).reshape(B, buf_len)
    sp = spans.tolist()
    tgt = lambda t: buf[:, sp[t][0]:sp[t][1]]
    (noc_bw, d2d_bw, dram_port_bw, dram_bw, glb_cap, glb_total,
     e_mac_u, e_glb_u, e_noc_u, e_d2d_u, e_dram_u) = consts.float()
    zero = torch.zeros(B, 1, device=buf.device)
    row_max = lambda x: torch.cat([zero, x], dim=1).amax(dim=1)
    edge_tot = tgt(1) + tgt(2)
    d2d = d2d_mask.bool()[None, :]
    edge_noc = torch.where(d2d, 0.0, edge_tot)
    edge_d2d = torch.where(d2d, edge_tot, 0.0)
    t_noc = row_max(edge_noc) / noc_bw
    t_d2d = row_max(edge_d2d) / d2d_bw if has_d2d else zero[:, 0]
    t_dram = row_max(tgt(3) + tgt(4)) / dram_port_bw
    t_comp = row_max(tgt(8))
    times = torch.stack([t_comp, t_noc, t_d2d, t_dram])          # (4, B)
    stage = times.amax(dim=0).clamp_min(1e-12)
    b_idx = torch.argmax(times, dim=0)                 # first of tied maxima
    overflow = (tgt(5) - glb_cap).clamp_min(0.0).sum(dim=1)
    spill = overflow * 2.0
    stage = stage * (1.0 + overflow / glb_total)
    stage = stage + spill / dram_bw
    np_f = npass.float()
    delay = stage * (np_f + depth.float() - 1.0)
    noc_bytes = edge_noc.sum(dim=1) * np_f
    d2d_bytes = edge_d2d.sum(dim=1) * np_f
    dram_b = tgt(3).sum(dim=1) * np_f + wts.float() + spill * np_f
    glb_rw = tgt(9)
    e_mac = tgt(0).sum(dim=1) * np_f * e_mac_u
    e_glb = (glb_rw[:, 0] + glb_rw[:, 1] + tgt(6).sum(dim=1)) * np_f \
        * e_glb_u
    e_noc = (noc_bytes + d2d_bytes) * e_noc_u
    e_d2d = d2d_bytes * e_d2d_u
    e_dram = dram_b * e_dram_u
    energy = e_mac + e_glb + e_noc + e_d2d + e_dram
    return (torch.stack([delay, energy, stage, overflow, e_mac, e_glb,
                         e_noc, e_d2d, e_dram]), b_idx.int())
