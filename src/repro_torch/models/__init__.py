"""Model zoo: one decoder LM covering dense / moe / ssm / hybrid + an
enc-dec.

Port of ``src/repro/models/__init__.py``.  ``model_api(cfg)`` returns the
family's (init, loss, prefill, decode_step, init_cache) bundle so
launchers never branch on family.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..configs.base import ModelConfig
from . import encdec, lm


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable
    loss_fn: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def model_api(cfg: ModelConfig) -> ModelAPI:
    """``init_params(generator, device)``, ``loss_fn(params, batch)``,
    ``init_cache(batch, max_seq, enc_len=None, device=None)`` (a decoder
    LM ignores ``enc_len``, as the reference does), ``prefill(params,
    batch, cache)`` and ``decode_step(params, tokens, cache)``; the last
    three take ``use_kernels`` (default True), and the loss and those
    three a ``rules`` (:class:`repro_torch.nn.params.ShardingRules`,
    default None) that lays DTensor activations out under a mesh.  The encoder-decoder's
    ``init_cache`` holds an ``enc_len`` (default ``min(max_seq, 1500)``)
    frame ``enc_out``, which its ``prefill`` replaces with the encoder
    states of ``batch["embeds"]``."""
    if cfg.family == "encdec":
        def init_cache(batch, max_seq, enc_len=None, device=None):
            return encdec.init_cache(cfg, batch, max_seq,
                                     enc_len or min(max_seq, 1500), device)

        return ModelAPI(
            cfg=cfg,
            init_params=lambda generator, device=None:
                encdec.init_params(cfg, generator, device),
            loss_fn=lambda p, b, use_kernels=True, rules=None:
                encdec.loss_fn(cfg, p, b, use_kernels, rules),
            init_cache=init_cache,
            prefill=lambda p, b, c, use_kernels=True, rules=None:
                encdec.prefill(cfg, p, b, c, use_kernels, rules),
            decode_step=lambda p, t, c, use_kernels=True, rules=None:
                encdec.decode_step(cfg, p, t, c, use_kernels, rules),
        )
    return ModelAPI(
        cfg=cfg,
        init_params=lambda generator, device=None:
            lm.init_params(cfg, generator, device),
        loss_fn=lambda p, b, use_kernels=True, rules=None:
            lm.loss_fn(cfg, p, b, use_kernels, rules),
        init_cache=lambda batch, max_seq, enc_len=None, device=None:
            lm.init_cache(cfg, batch, max_seq, device),
        prefill=lambda p, b, c, use_kernels=True, rules=None:
            lm.prefill(cfg, p, b, c, use_kernels, rules),
        decode_step=lambda p, t, c, use_kernels=True, rules=None:
            lm.decode_step(cfg, p, t, c, use_kernels, rules),
    )
