"""The harness finds a cell's configuration, traffic, limits and metrics
by name, so that a new one is a new file; and BENCHMARK.json keeps to
its own rules."""

import json
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench.lib import harness

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_resolves_and_reports_what_it_must():
    b = bench_json()
    for cell in b["workloads"]:
        spec = harness.cell_spec(b, cell["name"])
        assert spec["model"]["name"] == cell["config"]
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in e2e
            assert hasattr(harness.metric_module(m["name"]), "read")
        for m in spec["end_to_end"]:
            if m["name"] != "setup_s":
                assert hasattr(harness.metric_module(m["name"]), "read")
        assert harness.driver_module(spec["mix"]["kind"])
        assert spec["limits"]


def test_benchmark_json_keeps_its_rules():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert sum(w["chips"] == 4 for w in b["workloads"]) == 0
    assert all(len(w["why"]) <= 200 for w in b["workloads"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in b["end_to_end"])


def test_new_config_traffic_metric_and_cell_are_found_by_name(tmp_path):
    """A copy of the benchmark with one more configuration, mix, metric
    and cell, each added as a file, resolves without editing any file the
    benchmark already had."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench_json()
    conf = json.loads((ROOT / "bench/configs/mamba2-370m.json").read_text())
    conf["name"] = conf["model"]["name"] = "mamba2-tiny"
    conf["model"]["n_layers"] = 2
    (root / "bench/configs/mamba2-tiny.json").write_text(json.dumps(conf))
    mix = json.loads((ROOT / "bench/traffic/azure_code.json").read_text())
    mix["prompt_max"] = 2048
    (root / "bench/traffic/shortdoc.json").write_text(json.dumps(mix))
    (root / "bench/limits/serve.mamba2-tiny.shortdoc.json").write_text(
        json.dumps({"logit_gap": {"limit": 0.5}}))
    (root / "bench/metrics/waves.serve.py").write_text(
        "def read(rec, model, mix):\n    return len(rec.waves)\n")
    b["configs"].append({"name": "mamba2-tiny", "source": "test",
                         "file": "bench/configs/mamba2-tiny.json",
                         "reduced": ["n_layers"], "why": "test"})
    b["workloads"].append({"name": "serve.mamba2-tiny.shortdoc",
                           "config": "mamba2-tiny", "traffic": "shortdoc",
                           "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "waves.serve", "unit": "waves",
                           "better": "higher", "source": "host_clock",
                           "layer": "serving loop (runtime/serve_loop.py)",
                           "moves": "serve_tok_s",
                           "workloads": ["serve.mamba2-tiny.shortdoc"]})
    for m in b["end_to_end"]:
        if "workloads" in m and m["name"] != "train_tok_s":
            m["workloads"].append("serve.mamba2-tiny.shortdoc")
    spec = harness.cell_spec(b, "serve.mamba2-tiny.shortdoc", root=root)
    assert spec["model"]["n_layers"] == 2
    assert spec["mix"]["prompt_max"] == 2048
    assert spec["limits"] == {"logit_gap": {"limit": 0.5}}
    assert {m["name"] for m in spec["per_layer"]} >= {"waves.serve"}
    rec = SimpleNamespace(waves=[1, 2, 3])
    mod = harness.metric_module("waves.serve", root=root)
    assert mod.read(rec, spec["model"], spec["mix"]) == 3
    with pytest.raises(KeyError):
        harness.cell_spec(b, "serve.nothing.here", root=root)


def test_verdict_needs_every_number_within_its_limit():
    ok = {"name": "a", "value": 0.1, "limit": 0.2}
    assert harness.verdict([ok])
    assert not harness.verdict([])
    assert not harness.verdict([ok, {"name": "b", "value": 0.3,
                                     "limit": 0.2}])
    assert not harness.verdict([{"name": "c", "value": float("nan"),
                                 "limit": 1.0}])
    assert not harness.verdict([{"name": "d", "value": None, "limit": 1.0}])
