"""The port's loop (``repro_torch.examples.realize_demo``) on the
CPU, against the reference's DSE.

``close_loop`` runs the whole loop on the reference demo's graph and
candidates: the port's keep_mappings DSE, realization through the plain
versions, the overlay fit and the two second passes.  Its baseline must
equal the reference's ``run_dse`` on the same candidates, and its
calibrated pass the reference's ``run_dse(calibrated_candidates(cands,
overlay))`` for the same overlay factors, objective for objective and in
order (equality: both run the same float64 arithmetic).
"""

import json

import pytest
import torch

from repro.core import dse as ref_dse
from repro.core import explore as ref_explore
from repro.core import sa as ref_sa
from repro.core.workloads import transformer as ref_transformer
from repro.realize.calibrate import TechOverlay as RefOverlay
from repro.realize.calibrate import calibrated_candidates as ref_calibrated
from repro_torch.core.explore import arch_to_dict, candidate_key
from repro_torch.core.hw import gemini_arch_72t
from repro_torch.examples import realize_demo
from repro_torch.examples.realize_demo import (close_loop, demo_candidates,
                                               demo_config, demo_graph)

IDENTITY_LINE = ("[demo] identity overlay: second pass bit-identical to "
                 "baseline")


def _ref_inputs(cands):
    g = ref_transformer(n_layers=1, d_model=64, d_ff=128, seq=32,
                        name="tf-demo")
    rcands = [ref_explore.arch_from_dict(arch_to_dict(a)) for a in cands]
    cfg = ref_dse.DSEConfig(batch=4, sa=ref_sa.SAConfig(iters=120, seed=0),
                            keep_mappings=True)
    return {"TF": g}, rcands, cfg


def _objectives(pts, key):
    return [(key(p.arch), p.objective) for p in pts]


def test_close_loop_on_cpu_equals_reference_dse(tmp_path, capsys):
    cands = demo_candidates()
    res = close_loop({"TF": demo_graph()}, cands, demo_config(),
                     device="cpu", ckpt=tmp_path / "ck.jsonl",
                     out=tmp_path / "rep.jsonl")
    out = capsys.readouterr().out
    assert IDENTITY_LINE in out and "[demo] Tech overlay" in out
    assert len(res.realized) == 2 and res.overlay.n_stages > 0
    for r in res.realized:
        assert r.launches == {"tiled_matmul": 0, "flash_attention_mha": 0,
                              "ssd_chunk_dual": 0, "ssd_state_walk": 0,
                              "ssd_state_scan": 0,
                              "ssd_state_out": 0}   # plain versions
        assert len(r.report.stages) == len(r.program.stages) > 0
    rwl, rcands, rcfg = _ref_inputs(cands)
    ref = ref_dse.run_dse(rcands, rwl, rcfg)
    assert _objectives(res.baseline, candidate_key) == \
        _objectives(ref, ref_explore.candidate_key)
    assert [p.objective for p in res.identity] == \
        [p.objective for p in res.baseline]
    ov = res.overlay
    assert not ov.is_identity()
    ref_ov = RefOverlay(f_d2d=ov.f_d2d, f_noc=ov.f_noc, f_dram=ov.f_dram)
    ref_cal = ref_dse.run_dse(ref_calibrated(rcands, ref_ov), rwl, rcfg)
    assert _objectives(res.calibrated, candidate_key) == \
        _objectives(ref_cal, ref_explore.candidate_key)
    assert {k: b for k, (b, _) in res.rows.items()} == \
        {candidate_key(p.arch): p.objective for p in res.baseline}
    records = [json.loads(l) for l in
               (tmp_path / "rep.jsonl").read_text().splitlines()
               if '"_key"' in l]
    assert [r["arch"] for r in records] == \
        [r.report.arch_label for r in res.realized]


def test_close_loop_pairs_rows_by_candidate_key(tmp_path, capsys):
    """Two grids cut differently share a label; their rows stay apart."""
    a = gemini_arch_72t().replace(xcut=3, ycut=2)
    b = gemini_arch_72t().replace(xcut=6, ycut=1)
    assert a.label() == b.label() and candidate_key(a) != candidate_key(b)
    res = close_loop({"TF": demo_graph()}, [a, b], demo_config(),
                     device="cpu", top=1, ckpt=tmp_path / "ck.jsonl",
                     out=tmp_path / "rep.jsonl")
    capsys.readouterr()
    assert set(res.rows) == {candidate_key(a), candidate_key(b)}
    cal = {candidate_key(p.arch): p.objective for p in res.calibrated}
    cal_a, cal_b = realize_demo.calibrated_candidates([a, b], res.overlay)
    assert res.rows[candidate_key(a)][1] == cal[candidate_key(cal_a)]
    assert res.rows[candidate_key(b)][1] == cal[candidate_key(cal_b)]


def test_demo_cli_runs_on_cpu_and_refuses_a_missing_card(tmp_path,
                                                         monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    realize_demo.main(["--device", "cpu"])
    assert IDENTITY_LINE in capsys.readouterr().out
    assert (tmp_path / realize_demo.OUT).exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            realize_demo.main([])
