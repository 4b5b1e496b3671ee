"""The port's calibration (``repro_torch.realize.calibrate``) and the
predicted half of its report (``repro_torch.realize.measure``) against the
reference's (``repro.realize``).

``fit_overlay`` is held to the reference's on identical ratio records:
synthetic ones as ``tests/test_realize.py`` builds them, and the records
of the port's own CPU report of the ``tf-paper`` fixture (counted, not
executed, so its stages carry FLOP and DRAM ratios).  Factors are compared
for equality: both fits take the same logs and means in the same order.
"""

import dataclasses
import json
import math
from pathlib import Path

import pytest

from repro.core.evaluator import Evaluator as RefEvaluator
from repro.core.hw import TECH_12NM as REF_TECH
from repro.core.hw import ArchConfig as RefArch
from repro.realize.calibrate import fit_overlay as ref_fit_overlay
from repro.realize.measure import RealizationReport as RefReport
from repro.realize.measure import StageReport as RefStage
from repro.realize.plan import graph_from_spec as ref_graph_from_spec
from repro.realize.plan import load_realize_candidates as ref_load
from repro_torch.core.evaluator import Evaluator
from repro_torch.core.explore import arch_from_dict
from repro_torch.core.hw import TECH_12NM, simba_arch
from repro_torch.realize.calibrate import (TechOverlay, calibrated_candidates,
                                           fit_overlay, load_overlay,
                                           save_overlay)
from repro_torch.realize.measure import (RealizationReport, StageReport,
                                         measure_candidate)
from repro_torch.realize.plan import (graph_from_spec,
                                      load_realize_candidates, plans_for)
from repro_torch.realize.program import build_program

DATA = Path(__file__).resolve().parent / "data" / "realize"
TF_FIXTURE = DATA / "tf-paper.simba.ckpt.jsonl"
FACTORS = ("f_d2d", "f_noc", "f_dram")


def _stage(cls, ratio: float, **kw):
    return cls(index=0, layers=("l",), n_devices=2, routes={},
               flops=2.0e6, pred_flops=1.0e6,
               hbm_bytes=ratio * 1e6, pred_dram_bytes=1e6,
               ici_bytes=ratio * 1e5, pred_noc_bytes=1e5,
               dci_bytes=ratio * 1e4, pred_d2d_bytes=1e4, **kw)


def _report(ratio: float):
    """A one-stage report as ``tests/test_realize.py`` builds it."""
    return RealizationReport(key="k", workload="TF", arch_label="a",
                             tech=TECH_12NM.name, batch_unit=1,
                             stages=[_stage(StageReport, ratio)])


def _ref_report(ratio: float):
    return RefReport(key="k", workload="TF", arch_label="a",
                     tech=REF_TECH.name, batch_unit=1,
                     stages=[_stage(RefStage, ratio)])


def _factors(ov):
    return tuple(getattr(ov, f) for f in FACTORS), ov.n_stages


@pytest.mark.parametrize("ratios", [(3.0,), (0.3,), (2.5, 0.7, 1.3),
                                    (1e6,), (1e-6, 4.0)])
def test_fit_overlay_equals_reference_on_synthetic_reports(ratios):
    got = fit_overlay([_report(r) for r in ratios], source="s")
    want = ref_fit_overlay([_ref_report(r) for r in ratios], source="s")
    assert _factors(got) == _factors(want)
    assert got.to_dict() == want.to_dict()
    # the records a resumed sweep feeds the fit from disk give the same
    recs = [json.loads(json.dumps(_report(r).to_record())) for r in ratios]
    assert _factors(fit_overlay(recs)) == _factors(got)


def test_ratios_and_summary_equal_reference():
    for r in (3.0, 0.3):
        st, rst = _stage(StageReport, r), _stage(RefStage, r)
        assert st.ratios() == rst.ratios()
        assert _report(r).ratio_summary() == _ref_report(r).ratio_summary()
    # an axis with a zero side has no ratio: the port's stages carry no
    # ICI bytes, so no noc_bytes ratio, and the fit leaves f_noc at 1.0
    st = dataclasses.replace(_stage(StageReport, 3.0), ici_bytes=0.0)
    assert "noc_bytes" not in st.ratios()
    rep = dataclasses.replace(_report(3.0), stages=[st])
    ov = fit_overlay([rep])
    assert ov.f_noc == 1.0 and ov.f_dram == pytest.approx(3.0)


@pytest.fixture(scope="module")
def tf_cpu_report():
    """The port's report of the committed ``tf-paper`` winner on the CPU,
    counted (``execute=False``: the fixture's full width is too large to
    run here)."""
    g = graph_from_spec("tf-paper")
    (cand, plan), = plans_for(load_realize_candidates(
        TF_FIXTURE, {"TF": g}, verbose=False))
    prog = build_program(g, plan, device="cpu")
    return measure_candidate(cand, prog, execute=False)


def test_fit_overlay_equals_reference_on_the_tf_paper_cpu_report(
        tf_cpu_report):
    rep = tf_cpu_report
    rec = json.loads(json.dumps(rep.to_record()))
    assert len(rec["stages"]) == 37
    assert all(st["pred_flops"] > 0 for st in rec["stages"])
    rs = rec["ratio_summary"]
    assert set(rs) == {"flops", "dram_bytes"}
    assert 0.2 < rs["flops"] < 20
    got = fit_overlay([rep], source="repro_torch:tf")
    want = ref_fit_overlay([rec], source="repro_torch:tf")
    assert _factors(got) == _factors(want)
    assert _factors(fit_overlay([rec])) == _factors(got)
    assert got.n_stages == 37 and got.f_d2d == got.f_noc == 1.0
    assert got.f_dram != 1.0


def test_tf_paper_cpu_report_predicts_what_the_reference_does(
        tf_cpu_report):
    """The report's ``pred_*`` of every stage equal the reference
    evaluator's ``traffic_summary`` of the same (group, LMS)."""
    (ref,) = ref_load(TF_FIXTURE, {"TF": ref_graph_from_spec("tf-paper")})
    rev = RefEvaluator(ref.arch, ref.graph)
    pairs = (("pred_flops", "flops"), ("pred_dram_bytes", "dram_bytes"),
             ("pred_noc_bytes", "noc_bytes"), ("pred_d2d_bytes", "d2d_bytes"),
             ("pred_delay_s", "delay_s"), ("pred_energy_j", "energy_j"),
             ("pred_glb_overflow", "glb_overflow_bytes"))
    for st, (grp, lms) in zip(tf_cpu_report.stages, ref.mapping):
        want = rev.traffic_summary(grp, lms, grp.batch_unit)
        for field, key in pairs:
            assert math.isclose(getattr(st, field), want[key],
                                rel_tol=1e-9), (st.index, field)
        assert st.expected_scale == {}
    assert tf_cpu_report.predict_s > 0


def test_identity_overlay_returns_the_same_objects():
    ov = TechOverlay()
    assert ov.is_identity()
    assert ov.apply(TECH_12NM) is TECH_12NM
    arch = simba_arch()
    assert ov.apply_arch(arch) is arch
    cands = [simba_arch(), arch.replace(xcut=3, ycut=2)]
    assert all(a is b for a, b in
               zip(calibrated_candidates(cands, ov), cands))


def test_overlays_are_content_addressed_clamped_and_resumable(tmp_path):
    a = fit_overlay([_report(3.0)])
    b = fit_overlay([_report(0.3)])
    ta, tb = a.apply(TECH_12NM), b.apply(TECH_12NM)
    assert ta.name != tb.name
    assert ta.name.startswith(TECH_12NM.name + "+cal")
    assert ta.name == fit_overlay([_report(3.0)]).apply(TECH_12NM).name
    assert ta.e_dram_byte == TECH_12NM.e_dram_byte * a.f_dram
    assert fit_overlay([_report(1e6)]).f_dram == 10.0
    assert fit_overlay([_report(1e-6)]).f_dram == 0.1
    # the calibrated tech resolves through a checkpoint record by name
    arch = a.apply_arch(simba_arch())
    rec = {f: getattr(arch, f) for f in (
        "x_cores", "y_cores", "xcut", "ycut", "noc_bw", "d2d_bw", "dram_bw",
        "glb_kb", "macs_per_core", "freq_ghz", "n_dram")}
    back = arch_from_dict({**rec, "tech": arch.tech.name})
    assert back.tech is arch.tech and back.tech == ta and back == arch
    with pytest.raises(ValueError, match="unknown tech"):
        arch_from_dict({**rec, "tech": "tsmc12+calnever"})
    # the JSON round trip
    ov = fit_overlay([_report(2.5)], source="repro_torch:x|device=cpu")
    assert load_overlay(save_overlay(ov, tmp_path / "o" / "ov.json")) == ov


def test_overlay_moves_the_evaluator_as_the_reference_does():
    """Measured above predicted raises the calibrated energy of the same
    mapping, below lowers it, by exactly the reference's amount."""
    g = graph_from_spec("tf-paper")
    (cand,) = load_realize_candidates(TF_FIXTURE, {"TF": g}, verbose=False)
    (ref,) = ref_load(TF_FIXTURE, {"TF": ref_graph_from_spec("tf-paper")})
    base = Evaluator(cand.arch, g).evaluate(cand.mapping, 4).energy_j
    for ratio, direction in ((3.0, 1), (0.3, -1)):
        ov, rov = fit_overlay([_report(ratio)]), \
            ref_fit_overlay([_ref_report(ratio)])
        arch = ov.apply_arch(cand.arch)
        rarch = rov.apply_arch(ref.arch)
        assert isinstance(rarch, RefArch) and arch.tech.name == \
            rarch.tech.name
        e = Evaluator(arch, g).evaluate(cand.mapping, 4).energy_j
        re_ = RefEvaluator(rarch, ref.graph).evaluate(ref.mapping, 4)
        assert direction * (e - base) > 0
        assert math.isclose(e, re_.energy_j, rel_tol=1e-9)


def test_scaled_graph_measures_on_the_dense_scale(tf_cpu_report):
    """An expected-traffic graph runs its dense cubes, so its measured side
    is scaled by each axis's ``pred_scaled / pred_dense`` from a
    ``dense_twin`` evaluation of the same LMS (``expected_scale``); the
    dense report records no factor."""
    g = graph_from_spec("tf-paper")
    (cand, plan), = plans_for(load_realize_candidates(
        TF_FIXTURE, {"TF": g}, verbose=False))
    scaled = graph_from_spec("tf-paper")
    name = next(n for n in scaled.topo_order()
                if scaled.layers[n].kind == "fc")
    scaled.layers[name] = dataclasses.replace(scaled.layers[name],
                                              traffic_scale=0.5)
    rep = measure_candidate(dataclasses.replace(cand, graph=scaled),
                            build_program(scaled, plan, device="cpu"),
                            execute=False)
    dense = tf_cpu_report
    assert all(st.expected_scale for st in rep.stages)
    touched = [st.index for st in rep.stages
               if st.expected_scale["flops"] != 1.0]
    assert touched and len(touched) < len(rep.stages)
    for st, dst in zip(rep.stages, dense.stages):
        esc = st.expected_scale
        assert esc["flops"] == st.pred_flops / dst.pred_flops <= 1.0
        assert st.flops == dst.flops * esc["flops"]
        assert st.hbm_bytes == dst.hbm_bytes * esc["dram_bytes"]
        assert st.to_record()["expected_scale"] == esc
    assert all("expected_scale" not in st.to_record()
               for st in dense.stages)
