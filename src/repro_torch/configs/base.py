"""Model configurations: one ``ModelConfig`` covers the dense, moe, ssm,
hybrid and encdec families, plus reduced variants for CPU runs.  The four
run shapes (``ShapeConfig``, ``SHAPES``) and the cells an arch has
(``cells_for``) live here too.

Copy of ``src/repro/configs/base.py``.  Field names, defaults,
``param_count``, ``active_param_count``, ``reduced`` and the shapes are
the reference's; ``remat`` recomputes
each block in the backward pass of a training step
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does there.  Numpy-free and
torch-free: the workload exporter (:mod:`repro_torch.core`) loads it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = True
    # ssm / hybrid
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    attn_every: int = 0          # hybrid: shared attn+mlp block period
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch_groups: int = 16  # group-local dispatch (nn.moe); 0 = flat
    # modality frontend (stub: the batch provides embeddings)
    frontend: str = "none"       # none | patch | audio
    n_enc_layers: int = 0        # encdec only
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    source: str = ""             # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference pads so the
        vocab dim shards on any mesh axis).  Labels stay < vocab; padded
        rows take part in the softmax."""
        return -(-self.vocab // 256) * 256

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """long_500k runs only for O(1)-state decode families."""
        return self.family in ("ssm", "hybrid")

    def n_shared_attn(self) -> int:
        if self.family != "hybrid" or not self.attn_every:
            return 0
        return -(-self.n_layers // self.attn_every)

    def param_count(self) -> int:
        """Analytic parameter count (matches ``init_params``)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) \
            + (self.n_heads * hd) * d
        mlp = 3 * d * self.d_ff if self.act == "swiglu" else 2 * d * self.d_ff
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            H = d_in // self.ssm_headdim
            gn = self.ssm_groups * self.ssm_state
            blk = d * (2 * d_in + 2 * gn + H) + d_in * d \
                + 4 * (d_in + 2 * gn) + 3 * H + d_in
            if self.family == "ssm":
                return emb + L * (blk + d)
            return emb + L * (blk + d) + (attn + mlp + 3 * d)
        if self.family == "moe":
            expert = 3 * d * self.d_ff
            return emb + L * (attn + self.n_experts * expert
                              + d * self.n_experts + 2 * d)
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp + 2 * d)
            dec = L * (2 * attn + mlp + 3 * d)
            return emb + enc + dec
        return emb + L * (attn + mlp + 2 * d)

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6*N_active*D)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) \
            + (self.n_heads * hd) * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        expert = 3 * d * self.d_ff
        return emb + L * (attn + self.top_k * expert
                          + d * self.n_experts + 2 * d)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw: Dict = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 4),
            d_model=128,
            n_heads=max(2, min(self.n_heads, 4)),
            n_kv=1 if self.n_kv == 1 else 2,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=32 if self.head_dim else None,
            n_enc_layers=min(self.n_enc_layers, 2),
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_chunk=32,
            attn_every=2 if self.attn_every else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            remat=False,
        )
        return dataclasses.replace(self, **kw)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        from . import archs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> Tuple[str, ...]:
    if not _REGISTRY:
        from . import archs  # noqa: F401
    return tuple(sorted(_REGISTRY))


def cells_for(cfg: ModelConfig) -> Tuple[str, ...]:
    """The (arch x shape) cells that are defined for this arch."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_decode:
        out.append("long_500k")
    return tuple(out)
