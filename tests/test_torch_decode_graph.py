"""The decode step replayed as a CUDA graph (``repro_torch.models.
decode_graph``) against the eager step it captures (``lm._decode_eager``).

On the CPU: the route, chosen from the input alone for every family; the
public ``decode_step`` equal to the eager body where the route is eager;
and the runner's own logic (static buffers, binding, generations, spans)
with its capture and replay done eagerly by a stand-in (the fixture
``graph_stand_in`` of ``tests/conftest.py``).  On the card
(marker ``gpu``, skipped without one; this file imports no JAX):

    python -m pytest -q -m gpu tests/test_torch_decode_graph.py

two waves of 16 through the wave server at ``mamba2-370m``'s widths
(4 of its 48 layers), every step's logits and state equal to the eager
step's on a copy of the cache bit for bit, the tokens equal, one capture
and one replay a step, a stale cache refused, and no synchronize in a
replayed step.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models import decode_graph, lm, model_api
from repro_torch.nn.params import default_rules
from repro_torch.runtime.serve_loop import ModelWaveExecutor, Request

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
FAMILIES = {"smollm-135m": "dense", "granite-moe-3b-a800m": "moe",
            "mamba2-370m": "ssm", "zamba2-1.2b": "hybrid"}


@pytest.fixture(autouse=True)
def empty_store():
    obs.clear_kept()
    yield
    obs.clear_kept()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return CUDA


def _model(cfg, device):
    gen = torch.Generator(device=device).manual_seed(0)
    return model_api(cfg).init_params(gen, device=device)


def _waves(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    return [[Request(rid=100 * w + i, max_new=int(rng.integers(3, 7)),
                     prompt=rng.integers(1, cfg.vocab, int(rng.integers(
                         4, 40))).astype(np.int32)) for i in range(B)]
            for w in range(2)]


def _checked(api, cfg, log):
    """``api`` whose decode step also runs the eager body on a copy of the
    cache and logs whether the logits, the SSM cache and ``pos`` agree,
    and the cache it returned."""
    def decode_step(params, tok, cache, **kw):
        ref_cache = lm.copy_cache(cache)
        logits, new = api.decode_step(params, tok, cache, **kw)
        want, ref = lm._decode_eager(cfg, params, tok.clone(), ref_cache,
                                     **kw)
        log.append(dict(
            logits=torch.equal(logits, want),
            ssm=all(torch.equal(new["ssm"][k], ref["ssm"][k])
                    for k in ref["ssm"]),
            pos=new["pos"] == ref["pos"], cache=new))
        return logits, new
    return dataclasses.replace(api, decode_step=decode_step)


def _eager(api, cfg):
    return dataclasses.replace(
        api, decode_step=lambda p, t, c, use_kernels=True, rules=None:
        lm._decode_eager(cfg, p, t, c, use_kernels, rules))


def _two_waves_against_eager(cfg, params, B):
    """Serve two waves through the graph route and through the eager body;
    returns the per-step log of the graph route's waves."""
    kw = dict(max_batch=B, max_seq=64, eos_id=cfg.padded_vocab - 1)
    ex, ref = (ModelWaveExecutor(cfg, params, **kw) for _ in range(2))
    ref.api = _eager(ref.api, cfg)
    log = []
    ex.api = _checked(ex.api, cfg, log)
    want = [ref.run_wave(wave)[:2] for wave in _waves(cfg, B)]
    obs.clear_kept()
    for wave, (wout, wtok) in zip(_waves(cfg, B), want):
        out, ntok, _ = ex.run_wave(wave)
        np.testing.assert_array_equal(ntok, wtok)
        np.testing.assert_array_equal(out, wout)
    assert log and all(e["logits"] and e["ssm"] and e["pos"] for e in log)
    steps = len(obs.kept_spans("serve.decode"))
    assert len(log) == steps
    (cap,) = obs.kept_spans("decode.graph.capture")
    assert cap.attrs == {"B": B}
    assert len(obs.kept_spans("decode.graph.replay")) == steps
    assert len(decode_graph.runners(params)) == 1
    return log


def _stale_cache_raises(cfg, params, log):
    """A runner cache from the first wave, after the second wave rebound
    the runner, is refused."""
    old = next(e["cache"] for e in log if e["cache"][decode_graph.GEN_KEY]
               == 1)
    assert log[-1]["cache"][decode_graph.GEN_KEY] == 2
    tok = torch.ones((old["ssm"]["state"].shape[1], 1), dtype=torch.int32,
                     device=old["ssm"]["state"].device)
    with pytest.raises(RuntimeError, match="generation 1"):
        lm.decode_step(cfg, params, tok, old)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_the_route_is_chosen_from_the_input(arch):
    cfg = get_config(arch).reduced()
    keys = lm.init_cache(cfg, 2, 8).keys()
    take = decode_graph.takes_graph
    assert take((CUDA, CUDA), False, None, keys) == (FAMILIES[arch] == "ssm")
    assert not take((CPU, CPU), False, None, keys)
    assert not take((CUDA, CPU), False, None, keys)
    assert not take((CUDA, CUDA), True, None, keys)
    assert not take((CUDA, CUDA), False, default_rules(), keys)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_decode_step_on_the_cpu_is_the_eager_body(arch):
    cfg = get_config(arch).reduced()
    params = _model(cfg, CPU)
    api = model_api(cfg)
    toks = torch.randint(1, cfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    logits, cache = api.prefill(params, {"tokens": toks},
                                api.init_cache(2, 16))
    cur = logits.argmax(-1).to(torch.int32)[:, None]
    for _ in range(3):
        ref = lm.copy_cache(cache)
        logits, cache = api.decode_step(params, cur, cache)
        want, ref = lm._decode_eager(cfg, params, cur, ref)
        assert torch.equal(logits, want)
        assert cache.keys() == ref.keys() and cache["pos"] == ref["pos"]
        for k in ("ssm", "kv"):
            for name, t in cache.get(k, {}).items():
                assert torch.equal(t, ref[k][name]), (k, name)
        cur = logits.argmax(-1).to(torch.int32)[:, None]
    assert decode_graph.runners(params) == {}


def test_the_runner_serves_the_eager_steps(graph_stand_in):
    cfg = get_config("mamba2-370m").reduced()
    params = _model(cfg, CPU)
    log = _two_waves_against_eager(cfg, params, 3)
    _stale_cache_raises(cfg, params, log)
    decode_graph.drop(params)
    assert decode_graph.runners(params) == {}


def test_a_runner_cache_of_this_generation_binds_nothing(graph_stand_in):
    """Steps on the runner's own cache copy nothing in; a new sequence's
    cache is copied in once and leaves its own tensors as they were."""
    cfg = get_config("mamba2-370m").reduced()
    params = _model(cfg, CPU)
    api = model_api(cfg)
    _, cache = api.prefill(params, {"tokens": torch.ones((2, 4),
                                                         dtype=torch.int32)},
                           api.init_cache(2, 16))
    before = lm.copy_cache(cache)
    tok = torch.ones((2, 1), dtype=torch.int32)
    _, c1 = api.decode_step(params, tok, cache)
    (runner,) = decode_graph.runners(params).values()
    assert c1["ssm"] is runner.ssm and c1[decode_graph.GEN_KEY] == 1
    for k, t in cache["ssm"].items():
        assert torch.equal(t, before["ssm"][k])
    _, c2 = api.decode_step(params, tok, c1)
    assert c2[decode_graph.GEN_KEY] == 1 and c2["pos"] == c1["pos"] + 1
    _, c3 = api.decode_step(params, tok, before)
    assert c3[decode_graph.GEN_KEY] == 2
    with pytest.raises(RuntimeError, match="another sequence"):
        api.decode_step(params, tok, c2)
    decode_graph.drop(params)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_the_graph_is_the_eager_step_bit_for_bit(cuda):
    cfg = get_config("mamba2-370m").replace(n_layers=4)
    params = _model(cfg, cuda)
    log = _two_waves_against_eager(cfg, params, 16)
    _stale_cache_raises(cfg, params, log)
    cache = log[-1]["cache"]
    tok = torch.ones((16, 1), dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = lm.decode_step(cfg, params, tok, cache)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(logits).all()
    assert len(obs.kept_spans("decode.graph.capture")) == 1
