"""Decoder LM covering the dense / moe / ssm / hybrid families.

Port of ``src/repro/models/lm.py``.  The reference stacks the layers on a
leading axis and drives them with ``lax.scan`` (one HLO body for any
depth); here ``blocks`` is a ``ModuleList`` walked by a Python loop, so a
parameter's name is its pytree path with the layer index inserted
(``blocks.<i>.mamba.in_proj.w``).  The hybrid family (zamba2) has ONE
shared attention+MLP block (``shared``), applied every ``cfg.attn_every``
layers (an ``if`` where the reference has ``lax.cond``) with one KV cache
per application.  There is no remat: this port serves and does not train
yet.

Caches keep the reference's stacked layout ({"ssm": {"conv", "state"}
stacked over layers, "kv": {"k", "v"} stacked over layers or shared-block
applications, "pos"}), with ``pos`` a host int.  ``prefill`` and
``decode_step`` write the new entries into the cache's tensors in place
and return the cache with ``pos`` advanced (the reference returns new
arrays); ``forward`` with a cache and without ``update_cache`` works on a
copy.

``use_kernels`` (default True) routes CUDA tensors through the port's
kernels (flash attention, the SSD chunk kernel and state pass); False
runs the plain versions on any device.

Batch dicts:
  train   {"tokens"|"embeds", "labels", optional "mask"} -> scalar loss
  prefill {"tokens"|"embeds"}                  -> (last-token logits, cache)
  decode  {"tokens": (B,1)} + cache            -> (logits, new cache)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..nn.attention import Attention, init_kv_cache
from ..nn.layers import (Embedding, Linear, dtype_of, gelu, make_norm,
                         softmax_cross_entropy, swiglu)
from ..nn.mamba2 import Mamba2, init_ssm_cache
from ..nn.moe import MoE

Cache = Dict[str, Any]

AUX_LOSS_WEIGHT = 0.01


class MLP(nn.Module):
    """``{"gate", "up", "down"}`` (swiglu) or ``{"up", "down"}`` (gelu)."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.act = cfg.act
        self.gate = Linear(cfg.d_model, cfg.d_ff, **kw) \
            if cfg.act == "swiglu" else None
        self.up = Linear(cfg.d_model, cfg.d_ff, **kw)
        self.down = Linear(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        if self.act == "swiglu":
            h = swiglu(self.gate(x, compute_dtype), self.up(x, compute_dtype))
        else:
            h = gelu(self.up(x, compute_dtype))
        return self.down(h, compute_dtype)


class Block(nn.Module):
    """One layer: ``{"norm1", "mamba"}`` (ssm, hybrid) or ``{"norm1",
    "attn", "norm2", "mlp"|"moe"}`` (dense, moe)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        kw = dict(dtype=dt, device=device)
        self.norm1 = make_norm(cfg.norm, cfg.d_model, **kw)
        if cfg.family in ("ssm", "hybrid"):
            self.mamba = Mamba2(cfg.d_model, d_state=cfg.ssm_state,
                                headdim=cfg.ssm_headdim,
                                expand=cfg.ssm_expand,
                                n_groups=cfg.ssm_groups, chunk=cfg.ssm_chunk,
                                gen=gen, **kw)
            return
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                              qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                              gen=gen, **kw)
        self.norm2 = make_norm(cfg.norm, cfg.d_model, **kw)
        if cfg.family == "moe":
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, gen=gen,
                           **kw)
        else:
            self.mlp = MLP(cfg, gen=gen, **kw)


class SharedBlock(nn.Module):
    """The hybrid family's shared ``{"norm1", "attn", "norm2", "mlp"}``."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        kw = dict(dtype=dt, device=device)
        self.norm1 = make_norm(cfg.norm, cfg.d_model, **kw)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                              qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                              gen=gen, **kw)
        self.norm2 = make_norm(cfg.norm, cfg.d_model, **kw)
        self.mlp = MLP(cfg, gen=gen, **kw)


class LM(nn.Module):
    """``{"embed", "blocks", ["shared"], "final_norm", ["lm_head"]}`` of the
    reference's ``init_params``, ``blocks`` one module per layer."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, dtype=dt,
                               device=device, gen=gen)
        self.blocks = nn.ModuleList(Block(cfg, device=device, gen=gen)
                                    for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, device=device, gen=gen) \
            if cfg.family == "hybrid" else None
        self.final_norm = make_norm(cfg.norm, cfg.d_model, dtype=dt,
                                    device=device)
        self.lm_head = None if cfg.tie_embeddings else Linear(
            cfg.d_model, cfg.padded_vocab, dtype=dt, device=device, gen=gen)

    def forward(self, batch: Dict[str, torch.Tensor], *,
                cache: Optional[Cache] = None, update_cache: bool = False,
                use_kernels: bool = True, cfg: Optional[ModelConfig] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
        """Returns (logits (B, S, padded_vocab) f32, aux_loss, new_cache).
        ``cfg`` (default: the one the model was built with) supplies the
        numerics and flags, as the reference's ``forward(cfg, params)``
        does; its shapes must be the model's."""
        cfg = cfg or self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        if cache is not None and not update_cache:
            cache = copy_cache(cache)
        if "embeds" in batch:
            h = batch["embeds"].to(cdt)
        else:
            h = self.embed(batch["tokens"], cdt)
        B, S = h.shape[:2]
        pos0 = int(cache["pos"]) if cache is not None else 0
        positions = pos0 + torch.arange(S, device=h.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        attn_kw = dict(positions=positions, update_cache=update_cache,
                       rope_theta=cfg.rope_theta, compute_dtype=cdt,
                       use_kernels=use_kernels)

        if cfg.family in ("ssm", "hybrid"):
            if cache is None and update_cache:
                raise ValueError("update_cache requires an initialized cache")
            kvs = cache.get("kv") if cache is not None else None
            for li, bp in enumerate(self.blocks):
                ssm_c = None if cache is None else {
                    k: cache["ssm"][k][li] for k in ("conv", "state")}
                y, new_ssm = bp.mamba(
                    bp.norm1(h), cache=ssm_c,
                    update_cache=update_cache or ssm_c is not None,
                    compute_dtype=cdt, use_kernels=use_kernels)
                h = h + y
                if ssm_c is not None:
                    for k in ("conv", "state"):
                        cache["ssm"][k][li] = new_ssm[k]
                if cfg.family == "hybrid" and li % cfg.attn_every == 0:
                    sp = self.shared
                    app = li // cfg.attn_every
                    page = None if kvs is None else {
                        "k": kvs["k"][app], "v": kvs["v"][app], "pos": pos0}
                    y, _ = sp.attn(sp.norm1(h), cache=page, **attn_kw)
                    h = h + y
                    h = h + sp.mlp(sp.norm2(h), cdt)
        else:
            for li, bp in enumerate(self.blocks):
                page = None if cache is None else {
                    "k": cache["kv"]["k"][li], "v": cache["kv"]["v"][li],
                    "pos": pos0}
                y, _ = bp.attn(bp.norm1(h), cache=page, **attn_kw)
                h = h + y
                hin = bp.norm2(h)
                if cfg.family == "moe":
                    y2, a = bp.moe(hin, n_experts=cfg.n_experts,
                                   top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor,
                                   dispatch_groups=cfg.moe_dispatch_groups,
                                   compute_dtype=cdt)
                    aux = aux + a
                else:
                    y2 = bp.mlp(hin, cdt)
                h = h + y2

        new_cache = None
        if cache is not None and update_cache:
            new_cache = dict(cache, pos=pos0 + S)
        return self.logits(h, cdt), aux, new_cache

    def logits(self, h: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
        h = self.final_norm(h)
        if self.lm_head is None:
            return self.embed.unembed(h, cdt)
        return self.lm_head(h, cdt).float()


def copy_cache(cache: Cache) -> Cache:
    """A cache whose tensors are copies (``pos`` kept)."""
    def walk(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        return v
    return walk(cache)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """The model with parameters drawn from the reference's distributions
    with ``generator`` (a generator of ``device``)."""
    return LM(cfg, device=device, gen=generator)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Cache:
    """Stacked decode caches: KV caches bf16, SSM states f32."""
    c: Dict[str, Any] = {}
    if cfg.family in ("ssm", "hybrid"):
        one = init_ssm_cache(batch, cfg.d_model, d_state=cfg.ssm_state,
                             headdim=cfg.ssm_headdim, expand=cfg.ssm_expand,
                             n_groups=cfg.ssm_groups, device=device)
        c["ssm"] = {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
                    for k, v in one.items()}
        if cfg.family == "hybrid":
            napp = cfg.n_shared_attn()
            kv = init_kv_cache(batch, max_seq, cfg.n_kv, cfg.hd,
                               device=device)
            c["kv"] = {k: kv[k][None].repeat((napp,) + (1,) * kv[k].dim())
                       for k in ("k", "v")}
    else:
        kv = init_kv_cache(batch, max_seq, cfg.n_kv, cfg.hd, device=device)
        c["kv"] = {k: kv[k][None].repeat((cfg.n_layers,) + (1,) * kv[k].dim())
                   for k in ("k", "v")}
    c["pos"] = 0
    return c


def forward(cfg: ModelConfig, params: LM, batch: Dict[str, torch.Tensor],
            *, cache: Optional[Cache] = None, update_cache: bool = False,
            mode: str = "train", use_kernels: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
    """Returns (logits, aux_loss, new_cache).  ``mode`` is the reference's
    (it selects remat there) and changes nothing here."""
    del mode
    return params(batch, cache=cache, update_cache=update_cache,
                  use_kernels=use_kernels, cfg=cfg)


def loss_fn(cfg: ModelConfig, params: LM, batch: Dict[str, torch.Tensor],
            use_kernels: bool = True) -> Tuple[torch.Tensor, Dict]:
    logits, aux, _ = forward(cfg, params, batch, mode="train",
                             use_kernels=use_kernels)
    loss = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    total = loss + AUX_LOSS_WEIGHT * aux
    return total, {"nll": loss, "aux": aux}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: LM, batch: Dict[str, torch.Tensor],
            cache: Cache, use_kernels: bool = True
            ) -> Tuple[torch.Tensor, Cache]:
    logits, _, new_cache = forward(cfg, params, batch, cache=cache,
                                   update_cache=True, mode="prefill",
                                   use_kernels=use_kernels)
    return logits[:, -1], new_cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
                cache: Cache, use_kernels: bool = True
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B, 1) -> (logits (B, vocab), new cache)."""
    logits, _, new_cache = forward(cfg, params, {"tokens": tokens},
                                   cache=cache, update_cache=True,
                                   mode="decode", use_kernels=use_kernels)
    return logits[:, -1], new_cache
