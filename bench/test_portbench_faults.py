"""The check has to fail what it should: the FP8 control, and a run whose
timed path is broken underneath, come out not correct.  The harness's
look for a card is skipped; the rest of a run is driven on the CPU at a
size a test holds (``bench/lib/tiny.py``).

The limits here are the tiny cells' own, set as the full cells' are
(readings of the sound program on seeds 10-21 and of the control):
serve gap program <= 0.0024, control >= 0.022; train median
leaf's gradient gap program <= 7.1e-4, control >= 2.7e-3, half batch >=
7.4e-3; worst leaf's change gap program <= 0.015, a state left unchanged 1.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bench import control
from bench.drivers import serve_closed, train_packed
from bench.lib import harness, program, tiny

CPU = torch.device("cpu")


class TickClock:
    """A clock that moves 5 ms at each reading, so that a window serves
    the same waves or steps however busy the machine is."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 0.005
        return self.t


@pytest.fixture(autouse=True)
def tick_clock(monkeypatch):
    for mod in (serve_closed, train_packed):
        monkeypatch.setattr(mod, "time", TickClock())
SERVE_LIMITS = {"logit_gap": {"limit": 0.009}}
TRAIN_LIMITS = {"grad_norm_gap_median": {"limit": 1.5e-3},
                "change_norm_gap": {"limit": 0.08}}


def serve_run(name, seed, fault=None):
    model, mix = tiny.model(name), tiny.mix("azure_code")
    st = serve_closed.setup(model, mix, seed, CPU)
    if fault is not None:
        st["ex"].api = fault(st["ex"].api)
    rec = serve_closed.window(st, 0.4, None)
    serve_closed.release(st)
    return harness.verdict(serve_closed.check(rec, model, mix, seed, CPU,
                                              SERVE_LIMITS)), rec


def train_run(seed, step_fn=None):
    model, mix = tiny.model("mamba2-370m"), tiny.mix("pack2k")
    st = train_packed.setup(model, mix, seed, CPU, step_fn=step_fn)
    rec = train_packed.window(st, 0.2, None)
    train_packed.release(st)
    return harness.verdict(train_packed.check(rec, model, mix, seed, CPU,
                                              TRAIN_LIMITS)), rec


def altered_token(api):
    """Every decoded token replaced where it is produced."""
    def decode_step(params, tok, cache, **kw):
        logits, cache = api.decode_step(params, tok, cache, **kw)
        return logits.index_fill(-1, torch.tensor([7]), 1e4), cache
    return dataclasses.replace(api, decode_step=decode_step)


def state_unchanged(api):
    """A decode step that hands back its cache as it found it."""
    from repro_torch.models.lm import copy_cache

    def decode_step(params, tok, cache, **kw):
        logits, _ = api.decode_step(params, tok, copy_cache(cache), **kw)
        return logits, cache
    return dataclasses.replace(api, decode_step=decode_step)


@pytest.mark.parametrize("seed", [11, 2**31 + 11])
def test_sound_serve_run_is_correct(seed):
    ok, rec = serve_run("mamba2-370m", seed)
    assert ok and rec.failed == 0 and rec.attempted >= 4


@pytest.mark.parametrize("fault", [altered_token, state_unchanged])
def test_broken_serve_run_is_not_correct(fault):
    ok, rec = serve_run("mamba2-370m", 11, fault)
    assert rec.attempted >= 4
    assert not ok


def test_serve_control_is_not_correct():
    spec = {"model": tiny.model("mamba2-370m"), "mix": tiny.mix("azure_code")}
    r = control.readings(spec, 12, 0.4, CPU)
    assert r["logit_gap"] <= SERVE_LIMITS["logit_gap"]["limit"]
    assert r["control"]["logit_gap"] > SERVE_LIMITS["logit_gap"]["limit"]


def test_sound_train_run_is_correct():
    ok, rec = train_run(13)
    assert ok and rec.attempted >= 1 and len(rec.check_losses) == 3


def unchanged_step(cfg, opt):
    """A step that computes its loss and returns the state unchanged."""
    from repro_torch.models import model_api
    api = model_api(cfg)

    def step(state, batch):
        with torch.no_grad():
            loss, m = api.loss_fn(state["params"], batch, use_kernels=False)
        return state, {"loss": m["nll"]}
    return step


def half_batch_step(cfg, opt):
    """The program's step on the first half of the batch's rows."""
    from repro_torch.launch.steps import make_train_step
    inner = make_train_step(cfg, opt)

    def step(state, batch):
        half = batch["tokens"].shape[0] // 2
        return inner(state, {k: v[:half] for k, v in batch.items()})
    return step


@pytest.mark.parametrize("make", [unchanged_step, half_batch_step])
def test_broken_train_run_is_not_correct(make):
    model, mix = tiny.model("mamba2-370m"), tiny.mix("pack2k")
    cfg = program.model_config(model)
    ok, rec = train_run(13, make(cfg, train_packed.opt_config(mix)))
    assert not ok


def test_train_control_is_not_correct():
    spec = {"model": tiny.model("mamba2-370m"), "mix": tiny.mix("pack2k")}
    r = control.readings(spec, 14, 0.1, CPU)
    got = {k: r[k] <= v["limit"] for k, v in TRAIN_LIMITS.items()}
    assert all(got.values())
    assert not harness.verdict([{"name": k, "value": r["control"][k],
                                 "limit": v["limit"]}
                                for k, v in TRAIN_LIMITS.items()])
    assert np.isfinite(r["half_batch"]["loss_gap"])
    assert np.isfinite(r["bf16_reference"]["grad_norm_gap"])
