"""The port's telemetry (``repro_torch.obs``, ``launch/obs_report.py``)
and the ``obs`` calls of its engine and serving harness, against the
reference's ``repro.obs``.

Sweeps are bit-identical with tracing on and off.  With ``REPRO_OBS=1`` the
same sweep in both packages, each in a fresh interpreter (the geometry and
evaluator caches are process-wide), gives equal counters (``sa.*``,
``engine.tasks``, ``screen.kept/pruned``, ``merge.conflicts``,
``group_eval.*``, ``geo_cache.*``, ``prefetch.*``), equal call counts of
every ``phase.*`` histogram and the same multiset of span names.  The
report's pure functions equal the reference's on the same files, and
``render_report`` gives the reference's text on the reference's golden
run and the reference's sections and rows on a live run, its time columns
aside.  The harness's replay emits the reference's ``serve`` events.
Every comparison is equality; nothing here reads a clock it compares.
"""

import json
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

from repro.obs import report as ref_report
from repro.serve import harness as ref_harness
from repro.serve import trace as ref_trace
from repro_torch import obs
from repro_torch.core.dse import DSEConfig, grid_candidates, run_dse
from repro_torch.core.explore import ExplorationEngine, ResumableSweep
from repro_torch.core.sa import SAConfig
from repro_torch.core.workloads import transformer
from repro_torch.obs import report
from repro_torch.obs.manifest import GIT_COMMIT_ENV, git_head
from repro_torch.serve import harness
from repro_torch.serve import trace as port_trace

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "obs_mini"
COMPARED = ("sa.", "engine.tasks", "screen.", "merge.", "group_eval",
            "geo_cache.", "prefetch.")


def _tf_small():
    return transformer(n_layers=2, d_model=128, d_ff=256, seq=64, name="tf-s")


def _grid(n=4):
    return grid_candidates(
        72.0, mac_options=(512, 1024), cut_options=(1, 2),
        dram_per_tops=(2.0,), noc_options=(16,), d2d_ratio=(0.5,),
        glb_options=(1024,))[:n]


def _cfg(iters=40, seed=3, n_chains=1):
    return DSEConfig(batch=8, sa=SAConfig(iters=iters, seed=seed,
                                          n_chains=n_chains))


def _sig(points):
    return [(p.arch, p.objective, p.energy_j, p.delay_s) for p in points]


@pytest.fixture
def obs_dir(tmp_path):
    """Tracing on into a temp run dir; the global state always restored."""
    d = tmp_path / "obs"
    obs.enable(d)
    yield d
    obs.disable()
    obs.metrics.reset()


# the same sweep in either package (``sys.argv[1]``: repro or repro_torch)
# in a fresh interpreter with REPRO_OBS=1 into ``sys.argv[2]``: a screened
# single-chain sweep, a replica-exchange shard, and a merge of the two
# checkpoints with one conflicting record
_SWEEP = '''
import importlib, json, sys
from pathlib import Path
pkg, out = sys.argv[1], Path(sys.argv[2])
obs = importlib.import_module(pkg + ".obs")
dse = importlib.import_module(pkg + ".core.dse")
explore = importlib.import_module(pkg + ".core.explore")
sa = importlib.import_module(pkg + ".core.sa")
tf = importlib.import_module(pkg + ".core.workloads").transformer
g = {"TF": tf(n_layers=2, d_model=128, d_ff=256, seq=64, name="tf-s")}
cands = dse.grid_candidates(72.0, mac_options=(512, 1024),
                            cut_options=(1, 2), dram_per_tops=(2.0,),
                            noc_options=(16,), d2d_ratio=(0.5,),
                            glb_options=(1024,))[:4]
cfg = dse.DSEConfig(batch=8, sa=sa.SAConfig(iters=40, seed=3))
dse.run_dse(cands, g, cfg, screen_keep=0.5,
            checkpoint=out / "ck0.jsonl")
re_cfg = dse.DSEConfig(batch=8, sa=sa.SAConfig(iters=30, seed=3,
                                               n_chains=3))
dse.run_dse(cands, g, re_cfg, shard=(1, 2), checkpoint=out / "re.jsonl")
lines = (out / "ck0.jsonl").read_text().splitlines()
rec = json.loads(lines[-1])
rec["energy_j"] *= 2.0
(out / "ck1.jsonl").write_text("\\n".join([lines[0], json.dumps(rec)])
                               + "\\n")
explore.merge_checkpoints([out / "ck0.jsonl", out / "ck1.jsonl"],
                          out / "merged.jsonl")
obs.metrics.write_snapshot()
obs.flush()
'''


def _traced_sweep(pkg: str, root: Path) -> Path:
    out = root / pkg
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), REPRO_OBS="1",
               REPRO_OBS_DIR=str(out / "run"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _SWEEP, pkg, str(out)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=root)
    assert r.returncode == 0, r.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Both packages' traced sweeps: {"ref": dir, "port": dir}."""
    root = tmp_path_factory.mktemp("traced")
    return {"ref": _traced_sweep("repro", root),
            "port": _traced_sweep("repro_torch", root)}


def _metrics(d: Path) -> dict:
    return json.loads((d / "run" / "metrics.json").read_text())


def _events(d: Path) -> list:
    return [json.loads(line) for p in sorted((d / "run").glob("trace-*"))
            for line in p.read_text().splitlines()]


# ---------------------------------------------------------------------------
# bit-identity with tracing on; the counters, spans and histograms of both
# ---------------------------------------------------------------------------

def test_run_dse_bit_identical_with_tracing(tmp_path):
    g, cands, cfg = _tf_small(), _grid(), _cfg()
    off = run_dse(cands, {"TF": g}, cfg)
    d = tmp_path / "obs"
    obs.enable(d)
    try:
        on = run_dse(cands, {"TF": g}, cfg, n_workers=2)
    finally:
        obs.disable()
        obs.metrics.reset()
    assert _sig(off) == _sig(on)
    for f in sorted(d.glob("trace-*.jsonl")):
        for line in f.read_text().splitlines():
            json.loads(line)
    man = json.loads((d / "manifest.json").read_text())
    assert man["schema"] == "obs_manifest/v1" and man["seed"] == cfg.sa.seed
    prov = man["provenance"]
    assert {"torch", "cuda", "gpu", "commit", "python"} <= set(prov)
    assert "jax" not in prov
    m = json.loads((d / "metrics.json").read_text())
    assert m["counters"]["engine.tasks"] == len(off)


def test_sharded_and_re_sweeps_bit_identical_with_tracing(tmp_path,
                                                          obs_dir):
    from repro_torch.core.explore import merge_checkpoints
    g, cands = _tf_small(), _grid()
    for cfg in (_cfg(), _cfg(iters=30, n_chains=3)):
        obs.disable()
        full = run_dse(cands, {"TF": g}, cfg)
        obs.enable(obs_dir)
        shards = []
        for i in range(2):
            ck = tmp_path / f"shard{i}-{cfg.sa.n_chains}.jsonl"
            run_dse(cands, {"TF": g}, cfg, shard=(i, 2), checkpoint=ck)
            shards.append(ck)
        merged = tmp_path / f"merged-{cfg.sa.n_chains}.jsonl"
        merge_checkpoints(shards, merged)
        assert _sig(full) == _sig(run_dse(cands, {"TF": g}, cfg,
                                          checkpoint=merged))


def test_counters_equal_the_references(traced):
    a, b = (_metrics(traced[k])["counters"] for k in ("port", "ref"))
    pick = lambda c: {k: v for k, v in c.items() if k.startswith(COMPARED)}
    assert pick(a) == pick(b)
    for key in ("sa.runs", "sa.proposed", "sa.accepted", "sa.swap_attempts",
                "engine.tasks", "screen.kept", "screen.pruned",
                "merge.conflicts", "group_eval.misses", "geo_cache.misses",
                "prefetch.batched_builds"):
        assert a.get(key, 0) > 0, key
    assert a["merge.conflicts"] == 1


def test_histogram_calls_and_gauges_equal_the_references(traced):
    a, b = (_metrics(traced[k]) for k in ("port", "ref"))
    assert {k: h["n"] for k, h in a["histograms"].items()} == \
        {k: h["n"] for k, h in b["histograms"].items()}
    assert a["gauges"] == b["gauges"]


def test_span_names_equal_the_references(traced):
    names = {k: Counter(e["name"] for e in _events(d)
                        if e.get("ev") == "span")
             for k, d in traced.items()}
    assert names["port"] == names["ref"]
    assert {"dse", "screen", "task"} <= set(names["port"])
    logs = {k: sorted(e["tag"] + " " + re.sub(r"/\S+", "<path>", e["msg"])
                      for e in _events(d) if e.get("ev") == "log")
            for k, d in traced.items()}
    assert logs["port"] == logs["ref"]


def test_manifests_hold_the_same_sweep(traced):
    a, b = (json.loads((traced[k] / "run" / "manifest.json").read_text())
            for k in ("port", "ref"))
    for k in ("fingerprint", "seed", "grid", "n_workloads", "shard",
              "n_workers", "stage", "screen_keep"):
        assert a[k] == b[k], k


def test_disabled_metrics_are_noops():
    assert not obs.enabled()
    c = obs.metrics.counter("test.noop_counter")
    v0 = c.value
    c.inc(5)
    assert c.value == v0
    h = obs.metrics.histogram("test.noop_hist")
    h.observe(1.0)
    assert h.n == 0
    g = obs.metrics.gauge("test.noop_gauge")
    g.set(3.0)
    assert g.value is None
    assert obs.span("x") is obs.timed("y")          # the shared no-op


@pytest.mark.parametrize("n_workers", [1, 3])
def test_worker_metrics_aggregate_across_the_pool(tmp_path, n_workers):
    g, cands, cfg = _tf_small(), _grid(), _cfg()
    serial = run_dse(cands, {"TF": g}, cfg)
    obs.enable(tmp_path / f"obs-w{n_workers}")
    try:
        pts = run_dse(cands, {"TF": g}, cfg, n_workers=n_workers)
        snap = obs.metrics.snapshot()
    finally:
        obs.disable()
        obs.metrics.reset()
    assert _sig(pts) == _sig(serial)
    assert snap["counters"]["engine.tasks"] == len(cands)
    assert snap["counters"]["sa.runs"] == len(cands)
    assert snap["histograms"]["phase.task"]["n"] == len(cands)


def test_collectors_harvest_the_caches_and_the_kernel_counts(obs_dir):
    """The GroupEval, geometry-cache and prefetch collectors, and the
    ``fused_eval`` / ``segment_replay`` launch counts: a snapshot reports
    what changed since ``enable``."""
    from repro_torch.core import evaluator
    from repro_torch.kernels import fused_eval as fe
    obs.enable(obs_dir)
    evaluator.CACHE_STATS["group_eval.hits"] += 3
    fe.fused_eval.launches += 2
    try:
        c = obs.metrics.snapshot()["counters"]
    finally:
        evaluator.CACHE_STATS["group_eval.hits"] -= 3
        fe.fused_eval.launches -= 2
    assert c["group_eval.hits"] == 3 and c["fused_eval.launches"] == 2
    assert "segment_replay.launches" not in c
    assert {"geo_cache.size", "geo_cache.cap"} <= \
        set(obs.metrics.snapshot()["gauges"])


# ---------------------------------------------------------------------------
# heartbeats and the report
# ---------------------------------------------------------------------------

def test_heartbeats_written_and_read_as_the_reference(tmp_path):
    ck = tmp_path / "hb.jsonl"
    with ExplorationEngine({"TF": _tf_small()}, _cfg(), checkpoint=ck,
                           hb_every=0.0) as eng:
        pts = eng.run(_grid())
    n_rec, hb = report.parse_heartbeats(ck)
    assert (n_rec, hb) == ref_report.parse_heartbeats(ck)
    assert n_rec == len(pts) and hb["done"] == hb["total"] == len(pts)
    assert hb["shard"] == "0/1"
    assert len(ResumableSweep.read(ck)) == len(pts)


@pytest.mark.parametrize("files", [["shard0.jsonl"], ["ck0.jsonl"],
                                   ["ck0.jsonl", "re.jsonl", "nothere"]])
def test_report_functions_equal_the_references(traced, files):
    """``parse_heartbeats``, ``shard_progress`` (a fixed ``now``) and
    ``pareto_snapshot`` on the reference's golden shard and on the live
    sweeps' checkpoints."""
    paths = [DATA / f if f == "shard0.jsonl" else traced["port"] / f
             for f in files]
    for p in paths:
        assert report.parse_heartbeats(p) == ref_report.parse_heartbeats(p)
    assert report.shard_progress(paths, now=1786177000.0) == \
        ref_report.shard_progress(paths, now=1786177000.0)
    front = report.pareto_snapshot(paths, top=5)
    assert front == ref_report.pareto_snapshot(paths, top=5)
    assert front or files == ["shard0.jsonl"]
    data = report.load_run(traced["port"] / "run")
    assert report.phase_rows(data["metrics"]) == \
        ref_report.phase_rows(data["metrics"])
    assert report.cache_rows(data["metrics"]) == \
        ref_report.cache_rows(data["metrics"])
    assert report.top_tasks(data["events"]) == \
        ref_report.top_tasks(data["events"])


def test_render_report_equals_the_references_golden_text():
    got = report.render_report(run=DATA / "run",
                               ckpts=[DATA / "shard0.jsonl"], top=5,
                               now=1786177000.0)
    assert got == (DATA / "report.txt").read_text()


def _masked(text: str) -> list:
    """A rendering's lines with its time columns blanked: the phase and
    task tables' seconds and milliseconds, the heartbeat ages, and the
    manifest's date; the slowest-tasks rows sorted (their order is by
    wall time)."""
    out, section = [], None
    for line in text.splitlines():
        if line.startswith("== "):
            section = line
        elif section and "time in phase" in section and line \
                and not line.startswith(("phase", "-")):
            line = " ".join(line.split()[:2])
        elif section and "slowest tasks" in section and line \
                and not line.startswith(("arch", "-")):
            line = " ".join(line.split()[:-3])
        elif section and "shard progress" in section and line \
                and not line.startswith(("shard", "-")):
            line = " ".join(line.split()[:3])
        elif line.strip().startswith("commit"):
            line = line.split("@")[0]
        out.append(line.rstrip())
    return out


def test_render_report_has_the_references_sections_and_rows(traced):
    texts = {k: report.render_report(
        run=d / "run", ckpts=[d / "ck0.jsonl", d / "re.jsonl"], top=50)
        for k, d in traced.items()}
    a, b = (_masked(texts[k]) for k in ("port", "ref"))
    assert sorted(a) == sorted(b)
    heads = [ln for ln in a if ln.startswith("== ")]
    assert heads == [ln for ln in b if ln.startswith("== ")]
    assert heads[:3] == ["== run manifest ==", "== time in phase ==",
                         f"== top {heads[2].split()[2]} slowest tasks =="]
    assert "== cache economics ==" in heads
    assert "== engine counters ==" in heads
    assert ref_report.render_report(run=traced["port"] / "run") \
        .splitlines()[0] == "== run manifest =="


def test_obs_report_cli(capsys, traced):
    from repro_torch.launch.obs_report import main
    assert main(["--run", str(DATA / "run"),
                 "--ckpt", str(DATA / "shard0.jsonl")]) == 0
    out = capsys.readouterr().out
    for head in ("== run manifest ==", "== shard progress ==",
                 "== Pareto snapshot"):
        assert head in out
    assert main(["--run", str(traced["port"] / "run"), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["metrics"]["counters"]["merge.conflicts"] == 1
    assert "no obs artifacts" in report.render_report(run=REPO / "nothere")


# ---------------------------------------------------------------------------
# logging, provenance, the serving harness
# ---------------------------------------------------------------------------

def test_vlog_verbosity_gating(capsys, obs_dir):
    obs.vlog("sweep", "visible", level=1)
    obs.vlog("sweep", "hidden", level=2)
    out = capsys.readouterr().out
    assert "[sweep] visible" in out and "hidden" not in out
    obs.set_verbosity(2)
    try:
        obs.vlog("sweep", "now-visible", level=2)
        obs.vlog("sweep", "kwarg-hidden", level=2, verbosity=0)
    finally:
        obs.set_verbosity(1)
    out = capsys.readouterr().out
    assert "now-visible" in out and "kwarg-hidden" not in out
    obs.flush()
    logs = [json.loads(line)["msg"] for f in Path(obs_dir).glob("trace-*")
            for line in f.read_text().splitlines()
            if json.loads(line).get("ev") == "log"]
    for msg in ("visible", "hidden", "now-visible", "kwarg-hidden"):
        assert msg in logs


def test_export_and_import_state_cross_to_a_worker(tmp_path):
    assert obs.export_state() is None
    obs.enable(tmp_path / "r")
    try:
        state = obs.export_state()
    finally:
        obs.disable()
    assert state == {"run_dir": str(tmp_path / "r"), "verbosity": 1}
    obs.import_state(None)
    assert not obs.enabled()
    obs.import_state(state)
    try:
        assert obs.enabled() and obs.run_dir() == tmp_path / "r"
    finally:
        obs.disable()
        obs.metrics.reset()


def test_git_head_env_override_and_manifest_noop(monkeypatch, tmp_path):
    monkeypatch.setenv(GIT_COMMIT_ENV, "cafef00d")
    assert git_head() == "cafef00d"
    assert obs.manifest.provenance()["commit"] == "cafef00d"
    assert not obs.enabled()
    assert obs.manifest.write_manifest({"stage": "x"}) is None
    p = obs.manifest.write_manifest({"stage": "x"}, directory=tmp_path)
    assert json.loads(p.read_text())["stage"] == "x"


@pytest.mark.parametrize("mode", ["wave", "continuous"])
def test_harness_replay_emits_the_references_serve_events(tmp_path, mode):
    """The same trace and service model replayed by both harnesses with
    tracing on: the same ``serve`` timeline events (the pid aside), the
    same ``serve.*`` counters and histograms, one ``serve.replay`` span."""
    from repro import obs as ref_obs
    spec = "poisson:rate=8,n=40,plen=300..1024,new=16..64"
    runs = {}
    for name, o, h, t in (("port", obs, harness, port_trace),
                          ("ref", ref_obs, ref_harness, ref_trace)):
        d = tmp_path / name
        o.enable(d)
        try:
            model = h.ServiceModel(1e-4, 2e-3, 1e-3)
            h.replay(t.make_trace(spec), h.AnalyticalWaveExecutor(
                model, max_batch=4), mode=mode)
            snap = o.metrics.snapshot()
            o.flush()
        finally:
            o.disable()
            o.metrics.reset()
        evs = [json.loads(line) for f in sorted(d.glob("trace-*"))
               for line in f.read_text().splitlines()]
        runs[name] = (
            [{k: v for k, v in e.items() if k != "pid"} for e in evs
             if e.get("ev") == "serve"],
            [e["name"] for e in evs if e.get("ev") == "span"],
            {k: v for k, v in snap["counters"].items()
             if k.startswith("serve.")},
            {k: {f: x for f, x in v.items()}
             for k, v in snap["histograms"].items()
             if k.startswith("serve.")})
    assert runs["port"] == runs["ref"]
    serve_events, spans, counters, _ = runs["port"]
    assert serve_events and spans == ["serve.replay"]
    assert counters["serve.requests"] == 40
