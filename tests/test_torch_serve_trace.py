"""The port's traffic-replay half of serving (``repro_torch.serve``: traces,
the replay harness, the SLO model) and the trace mode of
``repro_torch.launch.serve`` against the reference's (``repro.serve``,
``repro.launch.serve``) on the CPU.

Everything here is numpy on both sides, so every comparison is equality:
the same spec and seed give the same requests, JSONL bytes and
fingerprint; a seeded trace replayed on the analytical executor gives the
same ``ServeReport`` to the bit; the CLI's virtual sections write the same
JSONL lines.  The measured section (``--measure``) runs the port's model
with ``--device cpu``, whose wall times differ by nature: it must answer
every request.  Its numbers on the card come from ``chip_smoke.py``, whose
pinned values this file holds equal to both packages' output.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.serve as ref
from repro.launch import serve as ref_launch
from repro.serve.slo import SLO_SCALAR_KEY as REF_SLO_KEY
import repro_torch.serve as port
from repro_torch.launch import cli
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.slo import SLO_SCALAR_KEY

REPO = Path(__file__).resolve().parent.parent
SPEC = "poisson:rate=8,n=32,seed=0,plen=4..32,new=8..32"
SPECS = [SPEC, "poisson:rate=3.5,n=20,plen=mix:0.8*4..32/0.2*256..512,"
         "new=16", "diurnal:rate=8,n=32,seed=0,plen=4..8,new=4..8,"
         "period=30,peak=3", "diurnal:rate=2,n=24,seed=5"]


def _models():
    kw = dict(prefill_s_per_token=1e-4, decode_s_per_token=2e-4,
              overhead_s=1e-3)
    return port.ServiceModel(**kw), ref.ServiceModel(**kw)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [None, 0, 3])
@pytest.mark.parametrize("spec", SPECS)
def test_traces_and_fingerprints_equal_the_reference(spec, seed):
    mine, theirs = port.make_trace(spec, seed=seed), ref.make_trace(spec,
                                                                    seed=seed)
    assert mine.to_jsonl() == theirs.to_jsonl()
    assert mine.fingerprint() == theirs.fingerprint()
    assert [r.to_json() for r in mine.requests] == \
        [r.to_json() for r in theirs.requests]
    assert mine.arrival_rate() == theirs.arrival_rate()
    assert mine.total_new_tokens == theirs.total_new_tokens
    req = mine.requests[1]
    np.testing.assert_array_equal(mine.prompt_tokens(req, 512),
                                  theirs.prompt_tokens(theirs.requests[1],
                                                       512))
    assert port.make_trace(spec, seed=seed).to_jsonl() == mine.to_jsonl()


def test_generators_equal_the_reference():
    assert port.poisson_trace(4.0, 10, seed=2, plen="8", new="1..3") \
        .to_jsonl() == ref.poisson_trace(4.0, 10, seed=2, plen="8",
                                         new="1..3").to_jsonl()
    assert port.diurnal_trace(6.0, 12, seed=1, period=10.0, peak=2.0) \
        .to_jsonl() == ref.diurnal_trace(6.0, 12, seed=1, period=10.0,
                                         peak=2.0).to_jsonl()


def test_respec_equals_the_reference():
    for kw in ({"rate": 16}, {"rate": 8.25}, {"n": 4, "plen": "2..3"}):
        mine = port.respec(SPEC, **kw)
        assert mine == ref.respec(SPEC, **kw)
        assert port.make_trace(mine).to_jsonl() == \
            ref.make_trace(mine).to_jsonl()
    assert port.make_trace(port.respec(SPEC, rate=16), seed=0) \
        .arrival_rate() > port.make_trace(SPEC, seed=0).arrival_rate() * 1.5


def test_jsonl_round_trip_across_the_packages(tmp_path):
    t = port.make_trace(SPEC, seed=1)
    back = ref.Trace.load(t.save(tmp_path / "port.jsonl"))
    assert back.to_jsonl() == t.to_jsonl()
    mine = port.Trace.load(ref.make_trace(SPEC, seed=1)
                           .save(tmp_path / "ref.jsonl"))
    assert mine.requests == t.requests
    assert (mine.name, mine.spec, mine.seed) == (t.name, t.spec, t.seed)


@pytest.mark.parametrize("bad", ["uniform:rate=1", "poisson:rate=1,x=2",
                                 "poisson:rate", "poisson:plen=0..3",
                                 "diurnal:peak=0.5"])
def test_bad_specs_raise_the_references_error(bad):
    with pytest.raises(ValueError) as mine:
        port.make_trace(bad)
    with pytest.raises(ValueError) as theirs:
        ref.make_trace(bad)
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# replay harness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_batch", [1, 4, 8])
@pytest.mark.parametrize("mode", ["wave", "continuous"])
@pytest.mark.parametrize("spec", SPECS)
def test_serve_report_equals_the_reference(spec, mode, max_batch):
    """``ServeReport.summary()`` and the per-request timelines, bit-equal,
    from a seeded trace on the analytical executor."""
    model, rmodel = _models()
    mine = port.replay(port.make_trace(spec, seed=2),
                       port.AnalyticalWaveExecutor(model, max_batch),
                       mode=mode)
    theirs = ref.replay(ref.make_trace(spec, seed=2),
                        ref.AnalyticalWaveExecutor(rmodel, max_batch),
                        mode=mode)
    assert mine.summary() == theirs.summary()
    assert mine.to_json() == theirs.to_json()
    assert (mine.p99_e2e_s, mine.p99_ttft_s) == (theirs.p99_e2e_s,
                                                 theirs.p99_ttft_s)
    for tl in mine.requests:
        assert tl.enqueue_t <= tl.start_t <= tl.first_token_t <= tl.finish_t


def test_mixed_wave_latencies_equal_the_reference():
    """One wave of mixed budgets: slots finish at their own decode step."""
    model, rmodel = _models()
    reqs = [(i, new) for i, new in enumerate((2, 9, 17, 30))]
    mine = port.replay(port.Trace("one", "manual", 0, [
        port.TraceRequest(i, 0.0, 8, n) for i, n in reqs]),
        port.AnalyticalWaveExecutor(model, 4))
    theirs = ref.replay(ref.Trace("one", "manual", 0, [
        ref.TraceRequest(i, 0.0, 8, n) for i, n in reqs]),
        ref.AnalyticalWaveExecutor(rmodel, 4))
    assert mine.to_json() == theirs.to_json() and mine.n_waves == 1
    fins = [tl.finish_t for tl in mine.requests]
    assert fins == sorted(fins) and len(set(fins)) == 4


def test_replay_takes_a_service_model_and_refuses_what_it_cannot_run():
    model, _ = _models()
    trace = port.make_trace(SPEC, seed=0)
    for mode in ("wave", "continuous"):
        assert port.replay(trace, model, mode=mode, max_batch=4).to_json() \
            == port.replay(trace, port.AnalyticalWaveExecutor(model, 4),
                           mode=mode).to_json()

    class Opaque:
        max_batch = 4

        def execute(self, wave):
            raise AssertionError("never called")
    assert isinstance(Opaque(), port.WaveExecutor)
    with pytest.raises(ValueError, match="continuous"):
        port.replay(trace, Opaque(), mode="continuous")
    with pytest.raises(ValueError, match="unknown replay mode"):
        port.replay(trace, model, mode="batch")
    with pytest.raises(ValueError, match="max_batch"):
        port.AnalyticalWaveExecutor(model, 0)


@pytest.mark.parametrize("mode", ["wave", "continuous"])
def test_saturation_sweep_equals_the_reference(mode):
    kw = dict(prefill_s_per_token=1e-3, decode_s_per_token=1e-3)
    rates = [1, 4, 16, 64, 256, 1024]
    mine = port.saturation_sweep(
        lambda r: port.make_trace(port.respec(SPEC, rate=r), seed=0),
        lambda: port.ServiceModel(**kw), rates, mode=mode, max_batch=4)
    theirs = ref.saturation_sweep(
        lambda r: ref.make_trace(ref.respec(SPEC, rate=r), seed=0),
        lambda: ref.ServiceModel(**kw), rates, mode=mode, max_batch=4)
    assert mine == theirs
    assert mine["saturated"] and mine["sat_rate_rps"] < 1024
    with pytest.raises(ValueError, match="at least one rate"):
        port.saturation_sweep(lambda r: None, lambda: None, [])


def test_service_model_from_delay_equals_the_reference():
    for args, kw in (((0.512, 8, 64), {}),
                     ((0.512, 8, 64), {"decode_mult": 2.0}),
                     ((3e-4, 1, 17), {"overhead_s": 1e-5})):
        mine = port.service_model_from_delay(*args, **kw)
        theirs = ref.service_model_from_delay(*args, **kw)
        assert (mine.prefill_s_per_token, mine.decode_s_per_token,
                mine.overhead_s) == (theirs.prefill_s_per_token,
                                     theirs.decode_s_per_token,
                                     theirs.overhead_s)
        assert mine.request_unloaded_s(20, 8) == \
            theirs.request_unloaded_s(20, 8)
    with pytest.raises(ValueError, match="delay_s > 0"):
        port.service_model_from_delay(0.0, 8, 64)


# ---------------------------------------------------------------------------
# slo: traffic models and the analytical predictor
# ---------------------------------------------------------------------------

def test_resolve_traffic_forms_equal_the_reference():
    for name in ("chat-quick", "diurnal-quick", SPEC):
        mine, theirs = port.resolve_traffic(name), ref.resolve_traffic(name)
        assert (mine.name, mine.trace_spec, mine.max_batch, mine.mode,
                mine.seq_ref, mine.decode_mult) == \
            (theirs.name, theirs.trace_spec, theirs.max_batch, theirs.mode,
             theirs.seq_ref, theirs.decode_mult)
        assert mine.fingerprint() == theirs.fingerprint()
    over = port.resolve_traffic("chat-quick", max_batch=2, mode="wave")
    assert over.fingerprint() == ref.resolve_traffic(
        "chat-quick", max_batch=2, mode="wave").fingerprint()
    tm = port.resolve_traffic("chat-quick")
    assert port.resolve_traffic(tm) is tm
    with pytest.raises(KeyError, match="chat-quick"):
        port.resolve_traffic("no-such-model")
    with pytest.raises(ValueError):
        port.resolve_traffic("bogus:rate=nope")
    with pytest.raises(ValueError, match="already registered"):
        port.register_traffic_model(port.TrafficModel(
            name="chat-quick", trace_spec=SPEC))
    assert SLO_SCALAR_KEY == REF_SLO_KEY == "p99_e2e_s"


@pytest.mark.parametrize("traffic", ["chat-quick", "diurnal-quick", SPEC])
def test_predict_slo_equals_the_reference(traffic):
    for delay, batch in ((2e-4, 8), (8e-4, 8), (1e-3, 4), (5e-2, 1)):
        mine = port.predict_slo(delay, traffic, batch=batch)
        assert mine == ref.predict_slo(delay, traffic, batch=batch)
        assert mine == port.predict_slo(delay, traffic, batch=batch)
    assert port.predict_slo(8e-4, traffic, 8)[SLO_SCALAR_KEY] > \
        port.predict_slo(2e-4, traffic, 8)[SLO_SCALAR_KEY]


# ---------------------------------------------------------------------------
# launch.serve --trace
# ---------------------------------------------------------------------------

def _ref_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    ref_launch.main()


@pytest.mark.parametrize("arch,extra", [
    ("mamba2-370m", ["--max-seq", "2048"]),
    ("whisper-small", ["--reduced", "--max-batch", "2"]),
    ("smollm-135m", ["--workload", "TF=tf-quick", "--seed", "3"])])
def test_trace_sections_equal_the_reference_cli(tmp_path, monkeypatch, capsys,
                                                arch, extra):
    """``serve_loop`` and ``realized``, the two virtual sections, are the
    reference CLI's JSONL lines byte for byte, and its printed lines."""
    spec = "poisson:rate=8,n=16,plen=300..1024,new=16"
    argv = ["--arch", arch, "--trace", spec, "--report", *extra]
    launch_serve.main([*argv, "--device", "cpu", "--out",
                       str(tmp_path / "port.jsonl")])
    mine = capsys.readouterr().out.splitlines()
    _ref_cli(monkeypatch, [*argv, "--out", str(tmp_path / "ref.jsonl")])
    theirs = capsys.readouterr().out.splitlines()
    text = (tmp_path / "port.jsonl").read_text()
    assert text == (tmp_path / "ref.jsonl").read_text()
    assert [json.loads(ln)["section"] for ln in text.splitlines()] == \
        ["serve_loop", "realized"]
    assert mine[:-1] == theirs[:-1]


def test_trace_sections_from_a_checkpoint_equal_the_reference_cli(
        tmp_path, monkeypatch, capsys):
    """``--ckpt``: the realized section's service model from the best
    record of a keep_mappings sweep, through the port's
    ``load_realize_candidates``."""
    argv = ["--arch", "smollm-135m", "--reduced", "--trace", SPEC,
            "--ckpt", str(REPO / "tests" / "data" / "realize"
                          / "tf-paper.simba.ckpt.jsonl"),
            "--workload", "TF=tf-paper"]
    launch_serve.main([*argv, "--out", str(tmp_path / "port.jsonl")])
    _ref_cli(monkeypatch, [*argv, "--out", str(tmp_path / "ref.jsonl")])
    capsys.readouterr()
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()


def test_chip_smoke_pins_the_references_sections(tmp_path, monkeypatch,
                                                 capsys):
    """``chip_smoke.py``'s ``serve_trace`` phase holds the card's virtual
    sections to ``SERVE_TRACE_PINNED``: those are the reference CLI's
    values for its arguments, and the port's."""
    cs = _chip_smoke()
    argv = [a for a in cs.SERVE_TRACE_ARGV if a != "--measure"]
    _ref_cli(monkeypatch, [*argv, "--out", str(tmp_path / "ref.jsonl")])
    launch_serve.main([*argv, "--out", str(tmp_path / "port.jsonl")])
    capsys.readouterr()
    text = (tmp_path / "ref.jsonl").read_text()
    assert (tmp_path / "port.jsonl").read_text() == text
    sections = {d["section"]: d for d in map(json.loads, text.splitlines())}
    assert set(cs.SERVE_TRACE_PINNED) == set(sections)
    for name, pin in cs.SERVE_TRACE_PINNED.items():
        for path, want in pin.items():
            assert cs._nested(sections[name], path) == want, (name, path)


@pytest.mark.parametrize("arch", ["mamba2-370m", "whisper-small"])
def test_measured_replay_on_the_cpu_answers_every_request(tmp_path, capsys,
                                                          arch):
    """``--measure --device cpu --reduced``: the trace replayed through the
    port's ``ModelWaveExecutor`` (the plain versions) answers every
    request, in the wave policy of the virtual ``serve_loop`` section."""
    spec = "poisson:rate=8,n=6,plen=4..40,new=2..5"
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--trace", spec, "--measure", "--max-seq", "64",
                       "--out", str(tmp_path / "r.jsonl")])
    out = capsys.readouterr().out
    assert "measured replay" in out and "on cpu" in out
    docs = [json.loads(ln) for ln in
            (tmp_path / "r.jsonl").read_text().splitlines()]
    assert [d["section"] for d in docs] == ["serve_loop", "realized",
                                            "serve_loop_measured"]
    meas = docs[2]
    assert meas["timing"] == "measured" and meas["trace"]["n"] == 6
    assert meas["mode"] == "wave" and meas["e2e_s"]["p99"] > 0


def test_trace_flags_need_a_trace():
    for flag in (["--report"], ["--measure"], ["--out", "x.jsonl"]):
        with pytest.raises(SystemExit, match="need --trace"):
            launch_serve.main(["--device", "cpu", "--reduced", *flag])


def test_cli_helpers_equal_the_reference():
    from repro.launch import cli as ref_cli
    import argparse
    for mod in (cli, ref_cli):
        ap = argparse.ArgumentParser()
        mod.add_workload_args(ap)
        got = ap.parse_args(["--workload", "A=tf-quick", "--workload", "B"])
        assert got.workload == ["A=tf-quick", "B"]
    items = ["a=1", "b=2.5"]
    assert cli.parse_kv(items, float, "--weight") == \
        ref_cli.parse_kv(items, float, "--weight") == {"a": 1.0, "b": 2.5}
    assert cli.parse_kv(None) is None and cli.parse_kv([]) is None
    for bad, match in ((["a"], "is not NAME=VALUE"), (["a=x"], "a=x")):
        with pytest.raises(SystemExit, match=match):
            cli.parse_kv(bad, float, "--weight")
