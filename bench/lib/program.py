"""The program under test as the harness builds it: the port's
``ModelConfig`` from a configuration's ``model`` fields, and the port's
model holding the benchmark's weights (loaded by name, strictly)."""

from __future__ import annotations

import dataclasses
from typing import Dict

from bench.reference.weights import make_weights


def model_config(model: Dict):
    from repro_torch.configs.base import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in model.items() if k in fields})


def load_model(model: Dict, seed: int, device):
    """(config, the program's model holding the weights of ``seed``)."""
    from repro_torch.models import model_api
    cfg = model_config(model)
    params = model_api(cfg).init_params(None, device)
    weights = make_weights(model, seed, device)
    params.load_state_dict(weights, strict=True)
    del weights
    return cfg, params
