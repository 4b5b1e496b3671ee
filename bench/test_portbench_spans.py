"""The readers of the program's kept spans (``bench/lib/spans.py`` and the
six ``program_span`` metrics that use it): they take the spans of the
window's waves or steps outside the profiler, and give None where the
program keeps no spans or, on the CPU, no device clock."""

import itertools
from types import SimpleNamespace

import pytest
import torch

from bench.drivers import serve_closed, train_packed
from bench.lib import harness, spans, tiny
from repro_torch import obs

CPU = torch.device("cpu")
SERVE = ("decode_issue_ms.serve", "decode_wait_ms.serve",
         "prefill_issue_ms.serve")
TRAIN = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train")
SIDS = itertools.count()


def read(name, rec):
    return harness.metric_module(name).read(rec, {}, {})


def fake(name, t0, t1, key=None, parent=None, device_ms=None):
    return SimpleNamespace(name=name, sid=next(SIDS), t0=t0, t1=t1, key=key,
                           parent=parent, device_ms=lambda: device_ms)


@pytest.fixture
def store(monkeypatch):
    """The program's store replaced by a list the test fills."""
    kept = []
    monkeypatch.setattr(obs, "kept_spans", lambda name=None: [
        s for s in kept if name is None or s.name == name])
    return kept


def test_serve_readers_take_the_waves_outside_the_profiler(store):
    rec = SimpleNamespace(waves=[
        SimpleNamespace(rids=[1, 2], traced=False),
        SimpleNamespace(rids=[3, 4], traced=True),
        SimpleNamespace(rids=[5, 6], traced=False)])
    for key, issue, wait in (((1, 2), 0.010, 0.002), ((3, 4), 0.100, 0.100),
                             ((5, 6), 0.030, 0.004), ((7, 8), 1.0, 1.0)):
        store += [fake("serve.decode.issue", 1.0, 1.0 + issue, key),
                  fake("serve.decode.wait", 2.0, 2.0 + wait, key),
                  fake("serve.prefill.issue", 0.0, 2 * issue, key)]
    assert read("decode_issue_ms.serve", rec) == pytest.approx(20.0)
    assert read("decode_wait_ms.serve", rec) == pytest.approx(3.0)
    assert read("prefill_issue_ms.serve", rec) == pytest.approx(40.0)
    rec.waves = [w for w in rec.waves if w.traced]     # only traced: all
    assert read("decode_issue_ms.serve", rec) == pytest.approx(100.0)


def test_train_readers_take_the_steps_outside_the_profiler(store):
    rec = SimpleNamespace(steps=[
        SimpleNamespace(t0=10.0, t1=11.0, traced=False),
        SimpleNamespace(t0=11.0, t1=12.0, traced=True),
        SimpleNamespace(t0=12.0, t1=13.0, traced=False)])
    for t0, fwd, opt in ((10.1, 100.0, 20.0), (11.1, 500.0, 500.0),
                         (12.1, 300.0, 40.0), (14.1, 900.0, 900.0)):
        top = fake("train.step", t0, t0 + 0.8, key=0)
        store.append(top)
        store += [fake("train.forward", t0, t0 + 0.1, 0, top.sid, fwd),
                  fake("train.backward", t0, t0 + 0.1, 0, top.sid, 2 * fwd),
                  fake("train.optimizer", t0, t0 + 0.1, None, top.sid, opt)]
    # a step of two micro-batches: its forwards are summed
    top = fake("train.step", 12.5, 12.9, key=1)
    store += [top, fake("train.forward", 12.5, 12.6, 0, top.sid, 50.0),
              fake("train.forward", 12.6, 12.7, 1, top.sid, 50.0)]
    assert read("forward_ms.train", rec) == pytest.approx(
        (100.0 + 300.0 + 100.0) / 3)
    assert read("backward_ms.train", rec) == pytest.approx(
        (200.0 + 600.0) / 2)
    assert read("optimizer_ms.train", rec) == pytest.approx(30.0)
    store.append(fake("train.optimizer", 10.2, 10.3, None,
                      store[0].sid, None))
    assert read("optimizer_ms.train", rec) is None     # no device clock


def test_readers_give_none_without_spans(store, monkeypatch):
    serve_rec = SimpleNamespace(waves=[SimpleNamespace(rids=[1],
                                                       traced=False)])
    train_rec = SimpleNamespace(steps=[SimpleNamespace(t0=0.0, t1=1.0,
                                                       traced=False)])
    for name in SERVE:
        assert read(name, serve_rec) is None
        assert read(name, SimpleNamespace()) is None
    for name in TRAIN:
        assert read(name, train_rec) is None
        assert read(name, SimpleNamespace()) is None
    # a program whose obs keeps no spans at all
    store.append(fake("serve.decode.issue", 0.0, 1.0, (1,)))
    assert read("decode_issue_ms.serve", serve_rec) == pytest.approx(1e3)
    monkeypatch.delattr(obs, "kept_spans")
    assert spans.kept("serve.decode.issue") == []
    assert read("decode_issue_ms.serve", serve_rec) is None


def test_a_tiny_window_read_through_the_program_spans():
    """A serve and a train window of the tiny cells on the CPU: the serve
    readers read the program's own spans, and issue plus wait is the serve
    loop's step time; the train readers find spans with no device clock
    and give None."""
    obs.clear_kept()
    model, mix = tiny.model("mamba2-370m"), tiny.mix("azure_code")
    st = serve_closed.setup(model, mix, 3, CPU)
    rec = serve_closed.window(st, 0.5, None)
    serve_closed.release(st)
    rec.waves[0].traced = True
    values = {n: read(n, rec) for n in SERVE + ("decode_step_ms.serve",)}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert values["decode_issue_ms.serve"] + values["decode_wait_ms.serve"] \
        == pytest.approx(values["decode_step_ms.serve"], rel=1e-9)
    model, mix = tiny.model("mamba2-370m"), tiny.mix("pack2k")
    st = train_packed.setup(model, mix, 3, CPU)
    rec = train_packed.window(st, 0.3, None)
    train_packed.release(st)
    assert spans.step_spans(rec, "train.forward")
    assert all(read(n, rec) is None for n in TRAIN)
    obs.clear_kept()
