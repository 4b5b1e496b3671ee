"""The train step: a loss, its gradients by ``torch.autograd``, micro-batch
accumulation and one AdamW update.

Port of the training half of ``src/repro/launch/steps.py``:
``batch_axes`` and the step of ``make_train_bundle`` as
:func:`make_train_step`.  One card has no mesh, so the ``NamedSharding``\\ s,
the sharding rules (``get_param_axes``, ``fit_batch_rules``,
``derive_attn_rules``) and ZeRO-1 wait for the multi-device slice; the
step runs eager where the reference jits it.

The train state is the reference's ``{"params", "opt"}``, with
``"params"`` the model (``nn.Module``, the port's parameter tree, its
parameters requiring grad) and ``"opt"`` :func:`init_opt_state` of its
named parameters; :func:`state_tree` is the checkpointable view of it.

The step takes the plain routes (``loss_fn(..., use_kernels=False)``): the
port's CUDA kernels have no backward, and the reference's jitted step
differentiates its jnp twins (block-scan attention, ``ssd_chunked``),
never a Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..models import model_api
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state

State = Dict[str, Any]


def batch_axes(cfg: ModelConfig, kind: str) -> Dict[str, Tuple]:
    a: Dict[str, Tuple] = {}
    if cfg.frontend in ("patch", "audio"):
        a["embeds"] = ("batch", "seq", "embed")
        if cfg.family == "encdec":
            a["tokens"] = ("batch", "seq")
    else:
        a["tokens"] = ("batch", "seq")
    if kind == "train":
        a["labels"] = ("batch", "seq")
    return a


def train_state(params: nn.Module) -> State:
    """``{"params": params, "opt": ...}`` with ``params``' parameters set
    to require grad and zero AdamW moments."""
    params.requires_grad_(True)
    return {"params": params,
            "opt": init_opt_state(dict(params.named_parameters()))}


def state_tree(state: State) -> Dict[str, Any]:
    """The state as nested dicts of tensors (the parameters by name), for
    :mod:`repro_torch.checkpoint.ckpt`."""
    return {"params": dict(state["params"].named_parameters()),
            "opt": state["opt"]}


@torch.no_grad()
def load_state_tree(state: State, tree: Mapping[str, Any]) -> State:
    """Copy a restored :func:`state_tree` into ``state`` (the parameters
    in place, the optimizer state replaced)."""
    for name, p in state["params"].named_parameters():
        p.copy_(tree["params"][name])
    state["opt"] = tree["opt"]
    return state


def to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str,
                                                               torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    n_micro: int = 1, zero1: bool = False
                    ) -> Callable[[State, Dict[str, torch.Tensor]],
                                  Tuple[State, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm", "lr"})``:
    the gradient of ``loss_fn`` on the plain routes (with ``n_micro > 1``,
    the mean of the gradients of ``n_micro`` equal slices of the batch,
    and the mean of their NLLs), then :func:`adamw_update` in place.
    ``loss`` is the NLL without the MoE auxiliary term, as the
    reference's."""
    if zero1:
        raise NotImplementedError(
            "zero1: sharding the optimizer state needs a mesh; it comes with "
            "the multi-device slice (ROADMAP slice 6)")
    opt_cfg = opt_cfg or AdamWConfig()
    api = model_api(cfg)

    def grads_of(model: nn.Module, plist, batch):
        loss, m = api.loss_fn(model, batch, use_kernels=False)
        # a parameter off the loss's graph (the token embedding of a
        # frontend fed embeddings) gets zeros, as jax.grad gives it
        return torch.autograd.grad(loss, plist, allow_unused=True,
                                   materialize_grads=True), \
            m["nll"].detach()

    def train_step(state: State, batch: Dict[str, torch.Tensor]):
        model, opt = state["params"], state["opt"]
        named = dict(model.named_parameters())
        plist = list(named.values())
        if n_micro > 1:
            mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                               + tuple(v.shape[1:])) for k, v in batch.items()}
            gsum, nll = grads_of(model, plist, {k: v[0]
                                                for k, v in mb.items()})
            gsum = list(gsum)
            for i in range(1, n_micro):
                g, n = grads_of(model, plist, {k: v[i]
                                               for k, v in mb.items()})
                torch._foreach_add_(gsum, g)
                nll = nll + n
            grads = torch._foreach_div(gsum, float(n_micro))
            nll = nll / n_micro
        else:
            grads, nll = grads_of(model, plist, batch)
        _, opt, om = adamw_update(opt_cfg, named, dict(zip(named, grads)),
                                  opt)
        return {"params": model, "opt": opt}, {"loss": nll, **om}

    return train_step
