"""GQA attention with rope, qk-norm, a KV cache, and the flash route.

Port of ``src/repro/nn/attention.py``.  The reference's flash path is a
jnp block scan (``_flash_path``), the mathematical twin of its Pallas
flash kernel, which XLA compiles on the TPU.  Here that path takes the
port's flash kernel (:func:`repro_torch.kernels.ops.flash_attention`) for
CUDA tensors; :func:`_flash_path` mirrors the block scan as the plain
version, for CPU tensors or ``use_kernels=False``.  The plain einsum
scores path (short sequences, decode) is the reference's own and runs on
either device.  GQA never materializes repeated KV heads on the plain
paths: queries are reshaped to (KV, G) groups instead.

The port's cache keeps ``pos`` as a host int, and ``attention_block``
writes the new segment into the cache's tensors in place when it updates
the cache (the reference returns updated copies).

With ``rules`` (:class:`repro_torch.nn.params.ShardingRules`) and DTensor
inputs, ``multihead_attention`` repeats GQA heads where ``rules.repeat_kv``
says and constrains q, k and v to the ``act_*`` layout, as the reference
does; the attention itself (plain routes and the flash kernel alike) then
runs on each rank's shards through ``local_map``
(:func:`_attention_local_map`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels import ops
from ..kernels.ref import NEG_INF
from .layers import Linear, RMSNorm
from .params import (ShardingRules, grad_placements, local_io, seq_shard_index,
                     shard_constraint, write_seq)
from .rope import apply_rope


class Attention(nn.Module):
    """``{"wq", "wk", "wv", "wo"[, "q_norm", "k_norm"]}`` of the
    reference's ``init_attention``."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int,
                 head_dim: Optional[int] = None, *, qkv_bias: bool = False,
                 qk_norm: bool = False, dtype: torch.dtype = torch.float32,
                 device=None, gen: Optional[torch.Generator] = None):
        super().__init__()
        hd = head_dim or d_model // n_heads
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, hd
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.wq = Linear(d_model, n_heads * hd, bias=qkv_bias, **kw)
        self.wk = Linear(d_model, n_kv * hd, bias=qkv_bias, **kw)
        self.wv = Linear(d_model, n_kv * hd, bias=qkv_bias, **kw)
        self.wo = Linear(n_heads * hd, d_model, **kw)
        self.q_norm = RMSNorm(hd, dtype=dtype, device=device) \
            if qk_norm else None
        self.k_norm = RMSNorm(hd, dtype=dtype, device=device) \
            if qk_norm else None

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[Dict[str, Any]] = None,
                cache_stack: Optional[Tuple] = None,
                update_cache: bool = False, rope_theta: float = 10000.0,
                qk_norm_eps: float = 1e-6, causal: bool = True,
                compute_dtype: torch.dtype = torch.bfloat16,
                block: int = 1024, use_kernels: bool = True,
                rules: Optional[ShardingRules] = None
                ) -> Tuple[torch.Tensor, Optional[Any]]:
        """The reference's ``attention_block``: x (B, S, d) -> (y, cache).

        Two cache modes:
          * ``cache`` - a per-layer dict {"k", "v", "pos"}; the segment is
            written at ``pos`` and attention reads the whole cache with
            ``q_offset = pos``, ``kv_len = pos + S``.  With
            ``update_cache`` the write lands in the cache's tensors and
            ``{"k", "v", "pos": pos + S}`` is returned; without it, in a
            copy, and None is returned.
          * ``cache_stack`` - ``(k_stack, v_stack, layer_idx, pos)`` with
            stacks (L, B, S_max, KV, D): the old pages and the new segment
            are attended separately and merged with their online-softmax
            statistics; the segment is then written into the stacks in
            place and ``(k_stack, v_stack)`` is returned.
        """
        B, S, d = x.shape
        n_heads, n_kv, hd = self.n_heads, self.n_kv, self.head_dim
        q = split_heads(self.wq(x, compute_dtype), n_heads, hd)
        k = split_heads(self.wk(x, compute_dtype), n_kv, hd)
        v = split_heads(self.wv(x, compute_dtype), n_kv, hd)
        if self.q_norm is not None:
            q = self.q_norm(q, qk_norm_eps)
            k = self.k_norm(k, qk_norm_eps)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
        kw = dict(n_kv=n_kv, block=block, use_kernels=use_kernels,
                  rules=rules)

        new_cache = None
        if cache_stack is not None:
            k_stack, v_stack, li, pos = cache_stack
            ck, cv = k_stack[li], v_stack[li]
            o_old, m_old, l_old = multihead_attention(
                q, ck.to(compute_dtype), cv.to(compute_dtype), causal=False,
                kv_len=pos, return_stats=True, **kw)
            o_new, m_new, l_new = multihead_attention(
                q, k, v, causal=causal, return_stats=True, **kw)
            out = merge_attention(o_old, m_old, l_old, o_new, m_new, l_new)
            k_stack[li, :, pos:pos + S] = k.to(k_stack.dtype)
            v_stack[li, :, pos:pos + S] = v.to(v_stack.dtype)
            new_cache = (k_stack, v_stack)
        elif cache is not None:
            idx = int(cache["pos"])
            ck = cache["k"] if update_cache else cache["k"].clone()
            cv = cache["v"] if update_cache else cache["v"].clone()
            write_seq(ck, k.to(ck.dtype), idx)
            write_seq(cv, v.to(cv.dtype), idx)
            out = multihead_attention(
                q, ck.to(compute_dtype), cv.to(compute_dtype), causal=causal,
                q_offset=idx, kv_len=idx + S, **kw)
            if update_cache:
                new_cache = {"k": ck, "v": cv, "pos": idx + S}
        else:
            out = multihead_attention(q, k, v, causal=causal, **kw)
        y = self.wo(out.reshape(B, S, n_heads * hd), compute_dtype)
        return y, new_cache


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n * hd) -> (..., n, hd).  A DTensor whose last dim shards over
    more ranks than ``n`` heads split into evenly is made whole there
    first (DTensor cannot split a sharded dim unevenly)."""
    if isinstance(t, DTensor):
        mesh, pl = t.device_mesh, tuple(t.placements)
        last = t.dim() - 1
        if n % math.prod(mesh.size(md) for md, p in enumerate(pl)
                         if p == Shard(last)):
            t = t.redistribute(mesh, tuple(Replicate() if p == Shard(last)
                                           else p for p in pl))
    return t.reshape(tuple(t.shape[:-1]) + (n, hd))


# ---------------------------------------------------------------------------
# Attention math
# ---------------------------------------------------------------------------

def _gqa_scores_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor], scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain einsum attention (short sequences, decode).  q (B,Sq,KV,G,D).
    Returns (out, running max m, denominator l), both (B,KV,G,Sq)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v) \
        / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out, m, l


def merge_attention(o1: torch.Tensor, m1: torch.Tensor, l1: torch.Tensor,
                    o2: torch.Tensor, m2: torch.Tensor, l2: torch.Tensor
                    ) -> torch.Tensor:
    """Online-softmax merge of two partial attentions over disjoint KV sets.
    o: (B,Sq,H,D); m/l: (B,H,Sq) [flattened (KV,G)]."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m) * l1
    a2 = torch.exp(m2 - m) * l2
    denom = (a1 + a2).clamp_min(1e-30)
    w1 = (a1 / denom).transpose(1, 2)[..., None]           # (B,Sq,H,1)
    w2 = (a2 / denom).transpose(1, 2)[..., None]
    return o1 * w1.to(o1.dtype) + o2 * w2.to(o2.dtype)


def _flash_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, q_offset: int, kv_len: Optional[int],
                scale: float, block: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's online-softmax scan over KV blocks, as a loop; never
    materializes (Sq, Sk).  The plain version of the flash route."""
    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    n_blocks = -(-Sk // block)
    pad = n_blocks * block - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32, device=dev)
    for bi in range(n_blocks):
        kblk = k[:, bi * block:(bi + 1) * block]
        vblk = v[:, bi * block:(bi + 1) * block]
        s = torch.einsum("bqkgd,bskd->bkgqs", q, kblk).float() * scale
        kv_pos = bi * block + torch.arange(block, device=dev)
        msk = torch.ones((Sq, block), dtype=torch.bool, device=dev)
        if causal:
            msk &= q_pos[:, None] >= kv_pos[None, :]
        if kv_len is not None:
            msk &= kv_pos[None, :] < kv_len
        msk &= kv_pos[None, :] < Sk                        # padding
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(vblk.dtype), vblk).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype), m, l   # (B,Sq,KV,G,D)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, n_kv: int, causal: bool = True, q_offset: int = 0,
                        kv_len: Optional[int] = None, block: int = 1024,
                        force_flash: Optional[bool] = None,
                        return_stats: bool = False,
                        use_kernels: bool = True,
                        rules: Optional[ShardingRules] = None):
    """q (B,Sq,H,D); k, v (B,Sk,KV,D).  Returns (B,Sq,H,D), with
    ``return_stats`` also the online-softmax (m, l), each (B,H,Sq).

    The reference's rule picks the flash path: ``Sq * Sk > 256 * 2048``
    over the full key length, unless ``force_flash`` says otherwise, and
    never for one query.  On CUDA tensors with ``use_kernels`` it runs the
    flash kernel on the first ``kv_len`` keys with ``q_offset``, which
    returns the statistics too.  Every row the kernel sees has a visible
    key, except with ``kv_len = 0``: the kernel route then gives m = -2e38
    and l = 0 where the reference's scan gives l = the masked key count
    (its exp(NEG_INF - NEG_INF) = 1); either way the row weighs nothing in
    :func:`merge_attention`.

    With ``rules.repeat_kv`` the GQA groups are materialized to full heads
    (transient tensors only, the KV cache stays GQA) so the head dim
    shards when n_kv doesn't divide the model axis; with ``rules`` q, k
    and v are constrained to the ``act_seq`` / ``act_kv`` /
    ``act_kv_seq`` layout (q as (B, Sq, H, D): its head dim holds the
    reference's (KV, G) with the groups unsharded).  DTensors then take
    :func:`_attention_local_map`, the route picked on the global shapes."""
    B, Sq, H, D = q.shape
    if rules is not None and rules.repeat_kv and n_kv != H:
        k = k.repeat_interleave(H // n_kv, dim=2)
        v = v.repeat_interleave(H // n_kv, dim=2)
        n_kv = H
    if rules is not None:
        q = shard_constraint(q, rules, ("batch", "act_seq", "act_kv", None))
        k = shard_constraint(k, rules, ("batch", "act_kv_seq", "act_kv",
                                        None))
        v = shard_constraint(v, rules, ("batch", "act_kv_seq", "act_kv",
                                        None))
    Sk = k.shape[1]
    use_flash = (Sq * Sk > 256 * 2048) if force_flash is None else force_flash
    kw = dict(n_kv=n_kv, causal=causal, q_offset=int(q_offset),
              kv_len=kv_len, block=block, use_flash=use_flash,
              return_stats=return_stats, use_kernels=use_kernels)
    if isinstance(q, DTensor):
        return _attention_local_map(q, k, v, **kw)
    return _attention(q, k, v, **kw)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               n_kv: int, causal: bool, q_offset: int, kv_len: Optional[int],
               block: int, use_flash: bool, return_stats: bool,
               use_kernels: bool):
    """:func:`multihead_attention` on plain tensors, the route given."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    G = H // n_kv
    scale = 1.0 / (D ** 0.5)
    if use_flash and Sq > 1:
        if use_kernels and q.device.type == "cuda":
            n = Sk if kv_len is None else int(kv_len)
            return ops.flash_attention(q, k[:, :n], v[:, :n], causal=causal,
                                       q_offset=q_offset,
                                       return_stats=return_stats)
        qg = q.reshape(B, Sq, n_kv, G, D)
        out, m, l = _flash_path(qg, k, v, causal=causal, q_offset=q_offset,
                                kv_len=kv_len, scale=scale, block=block)
    else:
        dev = q.device
        q_pos = q_offset + torch.arange(Sq, device=dev)
        kv_pos = torch.arange(Sk, device=dev)
        msk = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
        if causal:
            msk &= q_pos[:, None] >= kv_pos[None, :]
        if kv_len is not None:
            msk &= kv_pos[None, :] < kv_len
        out, m, l = _gqa_scores_path(q.reshape(B, Sq, n_kv, G, D), k, v,
                                     msk, scale)
    out = out.reshape(B, Sq, H, D)
    if return_stats:
        return out, m.reshape(B, H, Sq), l.reshape(B, H, Sq)
    return out


def _attention_local_map(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, q_offset: int, kv_len: Optional[int],
                         return_stats: bool, **kw):
    """:func:`_attention` on each rank's shards of DTensors q (B,Sq,H,D), k
    and v (B,Sk,KV,D) through ``local_map``: batch and heads may shard (k
    and v heads as q's), and the sequence of q (context parallel: a
    rank's rows start at ``q_offset`` plus its block's offset) or of k and
    v (the decode cache: each rank attends its own keys, and the partial
    results merge by their online-softmax statistics with all-reduces
    over the mesh axes that shard them).  The flash kernel takes whole key
    sequences only.  Outputs take q's placements, the statistics (B,H,Sq)
    the same mesh axes on their dims."""
    mesh = q.device_mesh
    qp, kp, vp = tuple(q.placements), tuple(k.placements), \
        tuple(v.placements)
    if kp != vp:
        raise ValueError(f"attention under a mesh: keys {kp} and values "
                         f"{vp} are laid out apart")
    k_seq = [md for md, p in enumerate(kp) if p == Shard(1)]
    for t, pl in ((q, qp), (k, kp)):
        n = math.prod(mesh.size(md) for md, p in enumerate(pl)
                      if p == Shard(1))
        if t.shape[1] % n:
            raise ValueError(f"attention under a mesh: {t.shape[1]} rows "
                             f"do not split evenly over {n} ranks")
    on_card = kw["use_kernels"] and q.device.type == "cuda" \
        and kw["use_flash"] and q.shape[1] > 1
    if k_seq and on_card:
        raise ValueError("flash kernel under a mesh: the keys' sequence "
                         "dim is sharded; constrain it replicated first")
    stat_dim = {0: 0, 1: 2, 2: 1}
    sp = tuple(Shard(stat_dim[p.dim]) if isinstance(p, Shard) else p
               for p in qp)

    def local(ql, kl, vl):
        ql, kl, vl = local_io(ql), local_io(kl), local_io(vl)
        kw["n_kv"] = kl.shape[2]                         # this rank's heads
        qo = q_offset + seq_shard_index(mesh, qp, 1) * ql.shape[1]
        if not k_seq:
            out = _attention(ql, kl, vl, q_offset=qo, kv_len=kv_len,
                             return_stats=return_stats, **kw)
            return tuple(t.contiguous() for t in out) if return_stats \
                else out.contiguous()
        ko = seq_shard_index(mesh, kp, 1) * kl.shape[1]
        o, m, l = _attention(ql, kl, vl, q_offset=qo - ko,
                             kv_len=None if kv_len is None else kv_len - ko,
                             return_stats=True, **kw)
        m_g = _all_reduce(m, "max", mesh, k_seq)
        w = torch.exp(m - m_g) * l                       # (B, H, Sq)
        l_g = _all_reduce(w, "sum", mesh, k_seq)
        num = _all_reduce(o.float() * w.transpose(1, 2)[..., None], "sum",
                          mesh, k_seq)
        out = (num / l_g.clamp_min(1e-30).transpose(1, 2)[..., None]) \
            .to(o.dtype)
        return (out, m_g, l_g) if return_stats else out.contiguous()

    out_pl = (qp, sp, sp) if return_stats else list(qp)
    in_pl = (qp, kp, vp)
    return local_map(local, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_placements(in_pl),
                     device_mesh=mesh)(q, k, v)


def _all_reduce(t: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    for md in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, md)))
    return t


def init_kv_cache(batch: int, max_seq: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> Dict[str, Any]:
    return {"k": torch.zeros((batch, max_seq, n_kv, head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_seq, n_kv, head_dim), dtype=dtype,
                             device=device),
            "pos": 0}
