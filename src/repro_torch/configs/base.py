"""Model configurations: the shape fields the workload exporter reads.

Reduced copy of ``src/repro/configs/base.py``: ``ModelConfig`` keeps the
fields :func:`repro_torch.core.workloads.lm_graph.lm_graph` reads (with the
reference's names and defaults), its ``hd`` property, and the by-name
registry (``register``, ``get_config``).  The model stack's fields
(vocabulary, norms, numerics, frontends) and the run shapes come with the
model slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    head_dim: Optional[int] = None
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
    source: str = ""             # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


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
