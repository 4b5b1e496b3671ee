"""Encoder-decoder model (whisper-small backbone).

Port of ``src/repro/models/encdec.py``.  Encoder: pre-LN transformer over
precomputed frame embeddings (the conv frontend is a stub: the batch
supplies frame embeddings directly).  Decoder: self-attention (causal,
KV-cached) + cross-attention to the final encoder states + GELU MLP.
Sinusoidal absolute positions are added to both streams.  The reference
stacks each side's layers on a leading axis and drives them with
``lax.scan``; here ``enc_blocks`` and ``dec_blocks`` are ``ModuleList``\\ s
walked by a Python loop, so a parameter's name is its pytree path with the
layer index inserted (``dec_blocks.<i>.cross_attn.wq.w``).

The reference's arithmetic is kept where it is odd:

* self-attention applies rope on top of the sinusoidal positions (the
  encoder's too; the reference's ``attention_block`` default theta);
* cross-attention has no rope and no cross-KV cache: k and v are
  recomputed from ``enc_out`` at every decode step;
* the cache holds ``enc_out`` in bf16, which decode steps upcast to the
  compute dtype (prefill attends the encoder output it just computed).

The decoder takes the per-layer cache mode of
:class:`repro_torch.nn.attention.Attention` (``cache`` = ``{"k", "v",
"pos"}``), as the reference does.  The cache keeps the reference's layout
({"kv": {"k", "v"} stacked over layers, "pos", "enc_out"}) with ``pos`` a
host int; ``decode`` with ``update_cache`` writes the new entries into the
cache's tensors in place and returns the cache with ``pos`` advanced.

``use_kernels`` (default True) routes CUDA tensors through the port's
flash kernel where the reference's rule takes the flash path; False runs
the plain versions on any device (a training step's route: the kernel
has no backward).  With ``cfg.remat`` each encoder layer, and each
decoder layer of a forward without a cache, is recomputed in the backward
pass (``torch.utils.checkpoint``), where the reference wraps the scan
body in ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..nn.attention import (Attention, init_kv_cache, multihead_attention,
                            split_heads)
from ..nn.params import ShardingRules, shard_constraint
from ..nn.layers import Embedding, LayerNorm, dtype_of, softmax_cross_entropy
from .lm import MLP, remat_call

Cache = Dict[str, Any]


def sinusoidal(seq: int, d: int, offset: int = 0,
               device=None) -> torch.Tensor:
    """(seq, d) f32 absolute positions ``offset ... offset + seq - 1``:
    sin on the even columns, cos on the odd ones."""
    pos = offset + torch.arange(seq, device=device)[:, None].float()
    step = -torch.log(torch.tensor(10000.0, device=device)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * step)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class EncBlock(nn.Module):
    """``{"norm1", "attn", "norm2", "mlp"}``."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        self.norm1 = LayerNorm(cfg.d_model, **kw)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                              gen=gen, **kw)
        self.norm2 = LayerNorm(cfg.d_model, **kw)
        self.mlp = MLP(cfg, gen=gen, **kw)


class DecBlock(nn.Module):
    """``{"norm1", "self_attn", "norm_x", "cross_attn", "norm2", "mlp"}``;
    the cross-attention has ``n_heads`` kv heads."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        self.norm1 = LayerNorm(cfg.d_model, **kw)
        self.self_attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                   cfg.hd, gen=gen, **kw)
        self.norm_x = LayerNorm(cfg.d_model, **kw)
        self.cross_attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_heads,
                                    cfg.hd, gen=gen, **kw)
        self.norm2 = LayerNorm(cfg.d_model, **kw)
        self.mlp = MLP(cfg, gen=gen, **kw)


class EncDec(nn.Module):
    """``{"embed", "enc_blocks", "dec_blocks", "enc_norm", "dec_norm"}`` of
    the reference's ``init_params``; the embedding is tied to the logits."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, dtype=dt,
                               device=device, gen=gen)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, device=device, gen=gen)
            for _ in range(cfg.n_enc_layers))
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, device=device, gen=gen)
            for _ in range(cfg.n_layers))
        self.enc_norm = LayerNorm(cfg.d_model, dtype=dt, device=device)
        self.dec_norm = LayerNorm(cfg.d_model, dtype=dt, device=device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

ACT = ("batch", "seq", "embed")         # the residual stream's axes

def encode(cfg: ModelConfig, params: EncDec, embeds: torch.Tensor,
           use_kernels: bool = True, rules: Optional[ShardingRules] = None
           ) -> torch.Tensor:
    """embeds: (B, S_enc, d) frame embeddings (frontend stub output) ->
    (B, S_enc, d) encoder states in the compute dtype.  ``rules``
    constrains DTensor activations as the reference's ``encode``."""
    cdt = dtype_of(cfg.compute_dtype)
    S = embeds.shape[1]
    h = embeds.to(cdt) + sinusoidal(S, cfg.d_model,
                                    device=embeds.device).to(cdt)[None]
    h = shard_constraint(h, rules, ACT)
    positions = torch.arange(S, device=h.device)[None, :]

    def layer(h, bp):
        y, _ = bp.attn(bp.norm1(h), positions=positions, causal=False,
                       compute_dtype=cdt, use_kernels=use_kernels,
                       rules=rules)
        h = h + y
        return shard_constraint(h + bp.mlp(bp.norm2(h), cdt), rules, ACT)

    for bp in params.enc_blocks:
        h = remat_call(cfg.remat, layer, h, bp)
    return params.enc_norm(h)


def _cross_attend(cfg: ModelConfig, bp: DecBlock, h: torch.Tensor,
                  enc_out: torch.Tensor, cdt: torch.dtype,
                  use_kernels: bool = True,
                  rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """Cross-attention: queries from decoder h, keys/values from enc_out
    (no rope, no cache)."""
    B, S, _ = h.shape
    H, hd, Se = cfg.n_heads, cfg.hd, enc_out.shape[1]
    ca = bp.cross_attn
    q = split_heads(ca.wq(h, cdt), H, hd)
    k = split_heads(ca.wk(enc_out, cdt), H, hd)
    v = split_heads(ca.wv(enc_out, cdt), H, hd)
    out = multihead_attention(q, k, v, n_kv=H, causal=False,
                              use_kernels=use_kernels, rules=rules)
    return ca.wo(out.reshape(B, S, H * hd), cdt)


def decode(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor,
           enc_out: torch.Tensor, *, cache: Optional[Cache] = None,
           update_cache: bool = False, use_kernels: bool = True,
           rules: Optional[ShardingRules] = None
           ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Decoder forward.  tokens (B, S); enc_out (B, S_enc, d).  Returns
    (logits (B, S, padded_vocab) f32, the advanced cache with
    ``update_cache``, else None)."""
    cdt = dtype_of(cfg.compute_dtype)
    S = tokens.shape[1]
    pos0 = int(cache["pos"]) if cache is not None else 0
    h = params.embed(tokens, cdt) + sinusoidal(
        S, cfg.d_model, pos0, device=tokens.device).to(cdt)[None]
    h = shard_constraint(h, rules, ACT)
    positions = pos0 + torch.arange(S, device=h.device)[None, :]

    def layer(h, bp, page):
        y, _ = bp.self_attn(bp.norm1(h), positions=positions, cache=page,
                            update_cache=update_cache, compute_dtype=cdt,
                            use_kernels=use_kernels, rules=rules)
        h = h + y
        h = h + _cross_attend(cfg, bp, bp.norm_x(h), enc_out, cdt,
                              use_kernels, rules)
        return shard_constraint(h + bp.mlp(bp.norm2(h), cdt), rules, ACT)

    for li, bp in enumerate(params.dec_blocks):
        page = None if cache is None else {
            "k": cache["kv"]["k"][li], "v": cache["kv"]["v"][li],
            "pos": pos0}
        h = remat_call(cfg.remat and cache is None, layer, h, bp, page)
    new_cache = None
    if cache is not None and update_cache:
        new_cache = dict(cache, pos=pos0 + S)
        new_cache.setdefault("enc_out", enc_out)
    logits = params.embed.unembed(params.dec_norm(h), cdt)
    return shard_constraint(logits, rules, ("batch", "seq", "vocab")), \
        new_cache


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> EncDec:
    """The model with parameters drawn from the reference's distributions
    with ``generator`` (a generator of ``device``)."""
    return EncDec(cfg, device=device, gen=generator)


def loss_fn(cfg: ModelConfig, params: EncDec,
            batch: Dict[str, torch.Tensor], use_kernels: bool = True,
            rules: Optional[ShardingRules] = None
            ) -> Tuple[torch.Tensor, Dict]:
    enc_out = encode(cfg, params, batch["embeds"], use_kernels, rules)
    logits, _ = decode(cfg, params, batch["tokens"], enc_out,
                       use_kernels=use_kernels, rules=rules)
    loss = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"nll": loss,
                  "aux": torch.zeros((), device=logits.device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, enc_len: int,
               device=None) -> Cache:
    """KV caches (bf16, stacked over the decoder layers), ``pos`` and a
    bf16 (batch, enc_len, d) ``enc_out``."""
    kv = init_kv_cache(batch, max_seq, cfg.n_kv, cfg.hd, device=device)
    return {"kv": {k: kv[k][None].repeat((cfg.n_layers,) + (1,) * kv[k].dim())
                   for k in ("k", "v")},
            "pos": 0,
            "enc_out": torch.zeros((batch, enc_len, cfg.d_model),
                                   dtype=torch.bfloat16, device=device)}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: EncDec,
            batch: Dict[str, torch.Tensor], cache: Cache,
            use_kernels: bool = True, rules: Optional[ShardingRules] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Encode ``batch["embeds"]``, store the encoder states in the cache in
    its dtype (replacing its ``enc_out``, whatever its length), decode
    ``batch["tokens"]`` against them.  Returns (last-position logits,
    cache)."""
    enc_out = encode(cfg, params, batch["embeds"], use_kernels, rules)
    cache = dict(cache, enc_out=enc_out.to(cache["enc_out"].dtype))
    logits, new_cache = decode(cfg, params, batch["tokens"], enc_out,
                               cache=cache, update_cache=True,
                               use_kernels=use_kernels, rules=rules)
    return logits[:, -1], new_cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor,
                cache: Cache, use_kernels: bool = True,
                rules: Optional[ShardingRules] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B, 1) -> (logits (B, vocab), new cache)."""
    cdt = dtype_of(cfg.compute_dtype)
    logits, new_cache = decode(cfg, params, tokens,
                               cache["enc_out"].to(cdt), cache=cache,
                               update_cache=True, use_kernels=use_kernels,
                               rules=rules)
    return logits[:, -1], new_cache

