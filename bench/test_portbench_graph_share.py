"""The reader of ``decode_graph_share.serve``: the share of the window's
decode steps outside the profiler whose ``serve.decode.issue`` span holds
a ``decode.graph.replay`` span, on synthetic kept spans."""

import itertools
from types import SimpleNamespace

import pytest

from bench.lib import harness
from repro_torch import obs

SIDS = itertools.count()


def read(rec):
    return harness.metric_module("decode_graph_share.serve").read(rec, {}, {})


def fake(name, t0, key, parent=None):
    return SimpleNamespace(name=name, sid=next(SIDS), t0=t0, t1=t0 + 0.01,
                           key=key, parent=parent)


@pytest.fixture
def store(monkeypatch):
    """The program's store replaced by a list the test fills."""
    kept = []
    monkeypatch.setattr(obs, "kept_spans", lambda name=None: [
        s for s in kept if name is None or s.name == name])
    return kept


def test_the_share_counts_the_steps_that_replayed(store):
    """0 without replay spans, 100 with one a step; the traced wave is left
    out."""
    rec = SimpleNamespace(waves=[
        SimpleNamespace(rids=[1, 2], traced=False),
        SimpleNamespace(rids=[3, 4], traced=True)])
    issues = [fake("serve.decode.issue", t, key)
              for key in ((1, 2), (3, 4)) for t in (1.0, 2.0)]
    store += issues
    assert read(rec) == 0.0
    # replays in the traced wave's steps only: still 0
    store += [fake("decode.graph.replay", i.t0, i.key, i.sid)
              for i in issues[2:]]
    assert read(rec) == 0.0
    store.append(fake("decode.graph.replay", 1.0, (1, 2), issues[0].sid))
    assert read(rec) == pytest.approx(50.0)
    store.append(fake("decode.graph.replay", 2.0, (1, 2), issues[1].sid))
    assert read(rec) == pytest.approx(100.0)
    # a capture span is no replay
    store.append(fake("decode.graph.capture", 1.0, (1, 2), issues[0].sid))
    assert read(rec) == pytest.approx(100.0)


def test_the_share_is_none_without_decode_spans(store, monkeypatch):
    rec = SimpleNamespace(waves=[SimpleNamespace(rids=[1], traced=False)])
    assert read(rec) is None
    assert read(SimpleNamespace()) is None
    store.append(fake("serve.decode.issue", 0.0, (1,)))
    assert read(rec) == 0.0
    monkeypatch.delattr(obs, "kept_spans")     # a program without the store
    assert read(rec) is None
