"""The port's kept spans (``repro_torch.obs.kept_span``): the tree a serve
wave and a train step keep (with the decode graph's, through a stand-in
runner), the costs the serve loop reads from them, the store's bound, the
profiler's marks, and the ``REPRO_OBS`` switch.

On the CPU a span has no device clock: its device milliseconds are None.
"""

import json
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import steps
from repro_torch.models import decode_graph, model_api
from repro_torch.optim import adamw
from repro_torch.runtime.serve_loop import ModelWaveExecutor, Request
from repro_torch.runtime.train_loop import TrainConfig, Trainer

SERVE_TREE = {"serve.prefill": "serve.wave",
              "serve.prefill.issue": "serve.prefill",
              "serve.prefill.wait": "serve.prefill",
              "serve.decode": "serve.wave",
              "serve.decode.issue": "serve.decode",
              "serve.decode.wait": "serve.decode",
              "serve.decode.readback": "serve.decode"}


@pytest.fixture(autouse=True)
def empty_store():
    obs.clear_kept()
    yield
    obs.clear_kept()


def _executor():
    cfg = get_config("mamba2-370m").reduced()
    params = model_api(cfg).init_params(torch.Generator().manual_seed(0))
    return ModelWaveExecutor(cfg, params, max_batch=3, max_seq=32,
                             eos_id=cfg.padded_vocab - 1)


def _wave():
    return [Request(rid=10 + i, prompt=np.arange(1, 4 + i, dtype=np.int32),
                    max_new=n) for i, n in enumerate((2, 5, 3))]


def _by_sid():
    return {s.sid: s for s in obs.kept_spans()}


def test_a_wave_keeps_its_span_tree_and_its_cost_reads_it():
    ex = _executor()
    t_lo = time.perf_counter()
    _, _, cost = ex.run_wave(_wave())
    t_hi = time.perf_counter()
    spans = obs.kept_spans()
    by_sid = _by_sid()
    (wave,) = obs.kept_spans("serve.wave")
    assert wave.key == (10, 11, 12) and wave.parent is None
    assert wave.attrs == {"B": 3, "L": 5}
    for s in spans:
        assert t_lo <= s.t0 <= s.t1 <= t_hi
        assert s.key == wave.key
        assert s.device_ms() is None
        if s is not wave:
            parent = by_sid[s.parent]
            assert parent.name == SERVE_TREE[s.name]
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    names = [s.name for s in spans]
    assert names.count("serve.decode") == len(cost.step_s) == 4
    for child in ("issue", "wait", "readback"):
        assert names.count(f"serve.decode.{child}") == 4
    (prefill,) = obs.kept_spans("serve.prefill")
    assert cost.prefill_s == prefill.host_s
    issues = obs.kept_spans("serve.decode.issue")
    waits = obs.kept_spans("serve.decode.wait")
    assert cost.step_s == [i.host_s + w.host_s for i, w in zip(issues, waits)]
    # issue, wait and readback in order within each step
    for d in obs.kept_spans("serve.decode"):
        kids = sorted((s for s in spans if s.parent == d.sid),
                      key=lambda s: s.t0)
        assert [k.name for k in kids] == ["serve.decode.issue",
                                          "serve.decode.wait",
                                          "serve.decode.readback"]
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))


def test_decode_graph_spans_nest_in_the_decode_issue(graph_stand_in):
    """Through the graph route (a stand-in runner on the CPU), each decode
    step's ``serve.decode.issue`` holds one ``decode.graph.replay``, the
    first also the ``decode.graph.capture`` (attribute B), both carrying
    the wave's key."""
    ex = _executor()
    ex.run_wave(_wave())
    by_sid = _by_sid()
    issues = obs.kept_spans("serve.decode.issue")
    replays = obs.kept_spans("decode.graph.replay")
    (capture,) = obs.kept_spans("decode.graph.capture")
    assert len(replays) == len(issues) == 4
    assert capture.attrs == {"B": 3}
    assert sorted(r.parent for r in replays) == [i.sid for i in issues]
    assert capture.parent == issues[0].sid
    for s in replays + [capture]:
        parent = by_sid[s.parent]
        assert s.key == parent.key == (10, 11, 12)
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    assert capture.t1 <= replays[0].t0
    decode_graph.drop(ex.params)


def _tiny_train_cfg():
    return get_config("smollm-135m").reduced().replace(
        n_layers=2, d_model=64, vocab=256, d_ff=128)


def _batch(cfg, B=4, S=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(1, cfg.vocab, (B, S + 1), generator=g)
    return {"tokens": toks[:, :-1].to(torch.int32),
            "labels": toks[:, 1:].to(torch.int32),
            "mask": torch.ones(B, S, dtype=torch.float32)}


@pytest.mark.parametrize("n_micro", [1, 2])
def test_a_train_step_keeps_forward_backward_and_optimizer(n_micro):
    cfg = _tiny_train_cfg()
    params = model_api(cfg).init_params(torch.Generator().manual_seed(0))
    state = steps.train_state(params)
    step_fn = steps.make_train_step(cfg, adamw.AdamWConfig(),
                                    n_micro=n_micro)
    for k in range(2):
        t_lo = time.perf_counter()
        state, metrics = step_fn(state, _batch(cfg, seed=k))
        t_hi = time.perf_counter()
        assert np.isfinite(float(metrics["loss"]))
        top = obs.last_kept("train.step")
        assert top.key == k and top.parent is None
        assert t_lo <= top.t0 <= top.t1 <= t_hi
    by_sid = _by_sid()
    tops = obs.kept_spans("train.step")
    assert len(tops) == 2
    for top in tops:
        kids = sorted((s for s in by_sid.values() if s.parent == top.sid),
                      key=lambda s: s.t0)
        want = []
        for i in range(n_micro):
            want += ["train.forward", "train.backward"]
            if i:
                want.append("train.accumulate")
        assert [k.name for k in kids] == want + ["train.optimizer"]
        micro = [k.key for k in kids if k.name == "train.forward"]
        assert micro == list(range(n_micro))
        for s in kids:
            assert top.t0 <= s.t0 <= s.t1 <= top.t1
            assert s.device_ms() is None and s.events is None


def test_the_trainer_reads_its_step_time_from_the_span(tmp_path):
    cfg = _tiny_train_cfg()
    tr = Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=16,
                                 global_batch=2),
                 TrainConfig(steps=3, ckpt_every=100, ckpt_dir=str(tmp_path),
                             log_every=1, async_ckpt=False), device="cpu")
    tr.run(resume=False)
    tops = obs.kept_spans("train.step")
    assert [r["dt"] for r in tr.metrics_log] == [s.host_s for s in tops]


def test_the_store_keeps_the_newest_at_its_bound():
    n = obs.KEPT_MAX + 37
    for i in range(n):
        with obs.kept_span("x", key=i):
            pass
    kept = obs.kept_spans()
    assert len(kept) == obs.KEPT_MAX
    assert kept[0].key == n - obs.KEPT_MAX and kept[-1].key == n - 1
    assert obs.last_kept("x") is kept[-1] and obs.last_kept("y") is None


def test_a_span_closed_by_an_exception_is_kept_and_unwinds():
    with pytest.raises(ValueError):
        with obs.kept_span("outer", key="k"):
            with obs.kept_span("inner"):
                raise ValueError("boom")
    inner, outer = obs.kept_spans()
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == outer.sid and inner.key == "k"
    with obs.kept_span("after") as after:
        pass
    assert after.parent is None


def test_spans_mark_the_profilers_trace(tmp_path):
    """While a profiler records, each span is a ``user_annotation`` of its
    name on the trace's clock; outside one, it opens none."""
    ex = _executor()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        ex.run_wave(_wave())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    notes = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in notes]
    for name in ["serve.wave"] + list(SERVE_TREE):
        assert name in names, name
    assert names.count("serve.decode.issue") == 4
    with obs.kept_span("quiet") as quiet:
        pass
    assert quiet._note is None


def test_the_switch_decides_what_reaches_disk(tmp_path, monkeypatch):
    """With ``REPRO_OBS`` unset a wave writes nothing and feeds no
    histogram; with it on, its spans are events of the JSONL stream and
    feed their ``phase.*`` histograms."""
    monkeypatch.chdir(tmp_path)
    ex = _executor()
    assert not obs.enabled()
    ex.run_wave(_wave())
    assert list(tmp_path.iterdir()) == []
    assert "phase.serve.decode" not in obs.metrics.snapshot()["histograms"]
    d = tmp_path / "obs"
    obs.enable(d)
    try:
        ex.run_wave(_wave())
        snap = obs.metrics.snapshot()
        obs.flush()
    finally:
        obs.disable()
        obs.metrics.reset()
    events = [json.loads(line) for f in sorted(d.glob("trace-*"))
              for line in f.read_text().splitlines()]
    spans = [e for e in events if e.get("ev") == "span"]
    kept = obs.kept_spans()[-len(spans):]
    assert [e["name"] for e in spans] == [s.name for s in kept]
    assert all(e["attrs"]["key"] == [10, 11, 12] for e in spans)
    assert [e["dur"] for e in spans] == [s.host_s for s in kept]
    hist = snap["histograms"]
    assert hist["phase.serve.decode.issue"]["n"] == 4
    assert hist["phase.serve.wave"]["n"] == 1
