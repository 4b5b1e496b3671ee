"""The port's sweep side of ``repro_torch.core.explore`` against the
reference's ``repro.core.explore``: seed derivation, schema-v2 checkpoints
written, resumed and merged across the two packages, schema-v1 migration,
the durable writer's repairs, the supervisor-facing introspection and the
Pareto frontier.

A checkpoint the port writes must equal the reference's for the same
sweep byte for byte (the header, then one record per task with the same
floats), and each package must resume the other's without recomputing.
Comparisons are equality; the sweeps are small (``tf-quick`` and a
one-layer transformer on 4- and 8-core candidates).
"""

import json
from pathlib import Path

import pytest

from repro.core import dse as ref_dse
from repro.core import explore as ref_explore
from repro.core import sa as ref_sa
from repro.core.workloads import make_workload as ref_workload
from repro_torch.core import dse, explore, sa
from repro_torch.core.workloads import make_workload

SMALL = "transformer:n_layers=1,d_model=64,d_ff=128,seq=32,name=tf-t"


def grid():
    kw = dict(tops=8, mac_options=(512, 1024), cut_options=(1, 2),
              dram_per_tops=(1.0,), noc_options=(16,), d2d_ratio=(0.5,),
              glb_options=(512,))
    return dse.grid_candidates(**kw), ref_dse.grid_candidates(**kw)


def cfgs(keep=True, iters=50):
    return (dse.DSEConfig(batch=4, sa=sa.SAConfig(iters=iters, seed=2),
                          keep_mappings=keep),
            ref_dse.DSEConfig(batch=4, sa=ref_sa.SAConfig(iters=iters, seed=2),
                              keep_mappings=keep))


def workloads():
    return ({"A": make_workload("tf-quick"), "B": make_workload(SMALL)},
            {"A": ref_workload("tf-quick"), "B": ref_workload(SMALL)})


def objectives(pts, mod):
    return [(mod.candidate_key(p.arch), p.objective) for p in pts]


def records(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()
            if '"_key"' in line]


def forbid_evaluation(monkeypatch, module):
    """Make a package's task evaluation raise: a resumed sweep must not
    reach it."""
    def boom(*a, **kw):
        raise AssertionError("a resumed task was recomputed")
    monkeypatch.setattr(module, "evaluate_task", boom)


# ---------------------------------------------------------------------------
# seeds and shard specs
# ---------------------------------------------------------------------------

def test_seed_derivation_equals_reference():
    for base in (0, 7, -3, 2**31):
        for ci in range(5):
            assert explore.derive_seed(base, ci) == \
                ref_explore.derive_seed(base, ci)
            for wi in range(3):
                assert explore.derive_task_seed(base, ci, wi) == \
                    ref_explore.derive_task_seed(base, ci, wi)
    assert explore.derive_task_seed(4, 3, 0) == explore.derive_seed(4, 3)


@pytest.mark.parametrize("spec,want", [("0/1", (0, 1)), ("2/3", (2, 3)),
                                       ("3/3", None), ("x", None),
                                       ("1/0", None), ("-1/2", None)])
def test_parse_shard_spec_equals_reference(spec, want):
    if want is None:
        for mod in (explore, ref_explore):
            with pytest.raises(ValueError):
                mod.parse_shard_spec(spec)
    else:
        assert explore.parse_shard_spec(spec) == want == \
            ref_explore.parse_shard_spec(spec)


def test_keys_and_records_equal_reference():
    cands, rcands = grid()
    for a, ra in zip(cands, rcands):
        assert explore.candidate_key(a) == ref_explore.candidate_key(ra)
        assert explore.task_checkpoint_key(a, "A") == \
            ref_explore.task_checkpoint_key(ra, "A")
        assert explore.arch_from_dict(explore.arch_to_dict(a)) == a
    tr = dse.TaskResult(energy_j=1.5, delay_s=2.5)
    assert explore.task_to_dict(tr, cands[0], "A", 9, True) == \
        ref_explore.task_to_dict(ref_dse.TaskResult(1.5, 2.5), rcands[0],
                                 "A", 9, True)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def test_port_checkpoint_equals_reference_checkpoint(tmp_path):
    cands, rcands = grid()
    (cfg, rcfg), (wl, rwl) = cfgs(), workloads()
    mine = dse.run_dse(cands, wl, cfg, checkpoint=tmp_path / "port.jsonl")
    ref = ref_dse.run_dse(rcands, rwl, rcfg, checkpoint=tmp_path / "ref.jsonl")
    assert objectives(mine, explore) == objectives(ref, ref_explore)
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    assert len(records(tmp_path / "port.jsonl")) == 2 * len(cands)


def test_each_package_resumes_the_others_checkpoint(tmp_path, monkeypatch):
    cands, rcands = grid()
    (cfg, rcfg), (wl, rwl) = cfgs(), workloads()
    dse.run_dse(cands, wl, cfg, checkpoint=tmp_path / "port.jsonl")
    ref = ref_dse.run_dse(rcands, rwl, rcfg, checkpoint=tmp_path / "ref.jsonl")
    forbid_evaluation(monkeypatch, dse)
    forbid_evaluation(monkeypatch, ref_dse)
    mine = dse.run_dse(cands, wl, cfg, checkpoint=tmp_path / "ref.jsonl")
    theirs = ref_dse.run_dse(rcands, rwl, rcfg,
                             checkpoint=tmp_path / "port.jsonl")
    assert objectives(mine, explore) == objectives(ref, ref_explore) == \
        objectives(theirs, ref_explore)
    assert [explore.mapping_to_jsonable(p.mappings["A"]) for p in mine] == \
        [ref_explore.mapping_to_jsonable(p.mappings["A"]) for p in ref]


SLO_TRAFFIC = "poisson:rate=8,n=32,seed=0,plen=4..32,new=8..32"


@pytest.mark.parametrize("traffic", ["chat-quick", SLO_TRAFFIC])
def test_slo_checkpoint_equals_reference_checkpoint(tmp_path, monkeypatch,
                                                    traffic):
    """An ``objective="slo"`` sweep writes the reference's checkpoint byte
    for byte (its header's ``obj=slo(<traffic fingerprint>):`` segment
    included), and each package resumes the other's."""
    cands, rcands = grid()
    (cfg, rcfg), (wl, rwl) = cfgs(), workloads()
    kw = dict(objective="slo", traffic=traffic)
    mine = dse.run_dse(cands, wl, cfg, checkpoint=tmp_path / "port.jsonl",
                       **kw)
    ref = ref_dse.run_dse(rcands, rwl, rcfg,
                          checkpoint=tmp_path / "ref.jsonl", **kw)
    text = (tmp_path / "port.jsonl").read_text()
    assert text == (tmp_path / "ref.jsonl").read_text()
    assert ":obj=slo(" in text.splitlines()[0]
    assert objectives(mine, explore) == objectives(ref, ref_explore)
    assert [sorted(p.slo.items()) for p in mine] == \
        [sorted(p.slo.items()) for p in ref]
    forbid_evaluation(monkeypatch, dse)
    forbid_evaluation(monkeypatch, ref_dse)
    again = dse.run_dse(cands, wl, cfg, checkpoint=tmp_path / "ref.jsonl",
                        **kw)
    theirs = ref_dse.run_dse(rcands, rwl, rcfg,
                             checkpoint=tmp_path / "port.jsonl", **kw)
    assert objectives(again, explore) == objectives(theirs, ref_explore) \
        == objectives(ref, ref_explore)


def test_fingerprint_obj_segment_equals_reference():
    """The default objective stamps no ``obj=`` segment; ``"slo"`` stamps
    the reference's, before ``:wl=``, naming the traffic model's
    fingerprint (``adhoc.<sha1>`` for a raw spec)."""
    import dataclasses
    (cfg, rcfg), (wl, rwl) = cfgs(), workloads()
    with explore.ExplorationEngine(wl, cfg) as eng:
        fp = eng._fingerprint(True)
    assert ":obj=" not in fp and ":wl=" in fp
    for traffic in ("chat-quick", SLO_TRAFFIC):
        with explore.ExplorationEngine(wl, dataclasses.replace(
                cfg, objective="slo", traffic=traffic)) as eng:
            mine = eng._fingerprint(True)
        with ref_explore.ExplorationEngine(rwl, dataclasses.replace(
                rcfg, objective="slo", traffic=traffic)) as eng:
            assert mine == eng._fingerprint(True)
        assert mine.index(":obj=slo(") < mine.index(":wl=")
        assert mine.split(":wl=")[1] == fp.split(":wl=")[1]
    assert ":obj=slo(adhoc." in mine


def test_partial_resume_recomputes_only_missing_tasks(tmp_path, monkeypatch):
    cands, rcands = grid()
    (cfg, rcfg), (wl, rwl) = cfgs(), workloads()
    ck = tmp_path / "ref.jsonl"
    ref = ref_dse.run_dse(rcands, rwl, rcfg, checkpoint=ck)
    lines = ck.read_text().splitlines()
    ck.write_text("\n".join(lines[:-3]) + "\n")
    calls = []
    real = dse.evaluate_task

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(dse, "evaluate_task", counting)
    mine = dse.run_dse(cands, wl, cfg, checkpoint=ck)
    assert len(calls) == 3
    assert objectives(mine, explore) == objectives(ref, ref_explore)
    assert len(records(ck)) == 2 * len(cands)


def test_metrics_only_checkpoint_recomputes_for_mappings(tmp_path):
    cands, rcands = grid()
    (cfg, _), (wl, _) = cfgs(keep=True), workloads()
    (cfg0, rcfg0), (_, rwl) = cfgs(keep=False), workloads()
    ck = tmp_path / "ref.jsonl"
    ref_dse.run_dse(rcands[:2], rwl, rcfg0, checkpoint=ck)
    assert all("mapping" not in r for r in records(ck))
    mine = dse.run_dse(cands[:2], wl, cfg, checkpoint=ck)
    assert all(p.mappings for p in mine)
    assert sum("mapping" in r for r in records(ck)) == 4


def test_merged_shards_equal_unsharded_sweep(tmp_path, monkeypatch):
    """Two stride shards, one written by each package, merged by the
    port, resume into the unsharded sweep with nothing recomputed."""
    cands, rcands = grid()
    (cfg, rcfg), (wl, rwl) = cfgs(), workloads()
    full = dse.run_dse(cands, wl, cfg)
    dse.run_dse(cands, wl, cfg, shard=(0, 2),
                checkpoint=tmp_path / "s0.jsonl")
    ref_dse.run_dse(rcands, rwl, rcfg, shard=(1, 2),
                    checkpoint=tmp_path / "s1.jsonl")
    rep = explore.merge_checkpoints([tmp_path / "s0.jsonl",
                                     tmp_path / "s1.jsonl"],
                                    out=tmp_path / "merged.jsonl",
                                    on_conflict="error")
    ref_rep = ref_explore.merge_checkpoints([tmp_path / "s0.jsonl",
                                             tmp_path / "s1.jsonl"],
                                            verbose=False)
    assert rep.records == ref_rep.records and not rep.conflicts
    assert rep.n_records == 2 * len(cands) and not rep.skipped
    assert rep.fingerprint == explore.sweep_fingerprint(wl, cfg) == \
        ref_explore.sweep_fingerprint(rwl, rcfg)
    forbid_evaluation(monkeypatch, dse)
    merged = dse.run_dse(cands, wl, cfg, checkpoint=tmp_path / "merged.jsonl")
    assert objectives(merged, explore) == objectives(full, explore)


def test_merge_reports_and_refuses_conflicts(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_text('{"_config": "fp"}\n{"_key": "k", "x": 1}\n')
    b.write_text('{"_config": "fp"}\n{"_key": "k", "x": 2}\n'
                 '{"_hb": {"done": 1}}\n')
    rep = explore.merge_checkpoints([a, b], verbose=False)
    assert rep.conflicts == ["k"] and rep.records == {"k": {"x": 2}}
    with pytest.raises(ValueError, match="conflicting records"):
        explore.merge_checkpoints([a, b], on_conflict="error", verbose=False)
    c = tmp_path / "c.jsonl"
    c.write_text('{"_config": "other"}\n')
    with pytest.raises(ValueError, match="mismatched"):
        explore.merge_checkpoints([a, c], verbose=False)
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"_config": "fp"}\n{broken\n{"_key": "z", "x": 0}\n')
    rep = explore.merge_checkpoints([a, bad], verbose=False)
    assert [p.name for p, _ in rep.skipped] == ["bad.jsonl"]


def test_v1_record_migrates_as_the_reference(tmp_path, monkeypatch):
    cands, rcands = grid()
    cfg, rcfg = cfgs(keep=False)
    wl = {"A": make_workload("tf-quick")}
    rwl = {"A": ref_workload("tf-quick")}
    fresh = dse.run_dse(cands[:3], wl, cfg)
    rec = {"seed": explore.derive_seed(cfg.sa.seed, 1),
           "arch": explore.arch_to_dict(cands[1]),
           "per_workload": {"A": [fresh[0].energy_j, fresh[0].delay_s]}}
    key = explore.candidate_key(cands[1])
    assert explore.migrate_v1_record(key, rec) == \
        ref_explore.migrate_v1_record(key, rec)
    # a whole schema-v1 file is migrated in place on open, by either package
    with explore.ExplorationEngine(wl, cfg) as eng:
        v1 = eng._fingerprint(True, schema=1)
    with ref_explore.ExplorationEngine(rwl, rcfg) as eng:
        assert v1 == eng._fingerprint(True, schema=1)
    by_key = {explore.candidate_key(p.arch): p for p in fresh}
    lines = [json.dumps({"_config": v1})]
    for ci, arch in enumerate(cands[:3]):
        p = by_key[explore.candidate_key(arch)]
        lines.append(json.dumps({
            "_key": explore.candidate_key(arch),
            "seed": explore.derive_seed(cfg.sa.seed, ci),
            "arch": explore.arch_to_dict(arch),
            "per_workload": {"A": [p.energy_j, p.delay_s]}}))
    for name in ("port.jsonl", "ref.jsonl"):
        (tmp_path / name).write_text("".join(l + "\n" for l in lines))
    forbid_evaluation(monkeypatch, dse)
    forbid_evaluation(monkeypatch, ref_dse)
    mine = dse.run_dse(cands[:3], wl, cfg, checkpoint=tmp_path / "port.jsonl")
    ref_dse.run_dse(rcands[:3], rwl, rcfg, checkpoint=tmp_path / "ref.jsonl")
    assert objectives(mine, explore) == objectives(fresh, explore)
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    assert (tmp_path / "port.jsonl").read_text().startswith(
        json.dumps({"_config": explore.sweep_fingerprint(wl, cfg)}))


def test_remaining_indices_equal_reference(tmp_path):
    cands, rcands = grid()
    (cfg, rcfg), (wl, rwl) = cfgs(), workloads()
    ck = tmp_path / "s.jsonl"
    dse.run_dse(cands, wl, cfg, shard=(1, 3), checkpoint=ck)
    mine = explore.remaining_candidate_indices(cands, wl, cfg, ck)
    ref = ref_explore.remaining_candidate_indices(rcands, rwl, rcfg, ck)
    assert mine == ref == [i for i in range(len(cands)) if i % 3 != 1]
    assert explore.remaining_candidate_indices(
        cands, wl, cfg, tmp_path / "none.jsonl", indices=[2, 0]) == [0, 2]


# ---------------------------------------------------------------------------
# the durable writer
# ---------------------------------------------------------------------------

def test_sweep_repairs_and_sets_aside_as_the_reference(tmp_path):
    for mod, d in ((explore, tmp_path / "port"), (ref_explore,
                                                   tmp_path / "ref")):
        p = d / "s.jsonl"
        s = mod.ResumableSweep(p, config_fingerprint="fp")
        s.add("a", {"x": 1})
        s.heartbeat({"done": 1})
        s.add("b", {"x": 2})
        with p.open("a") as f:
            f.write('{"_key": "c", "x":')          # killed mid-write
        s2 = mod.ResumableSweep(p, config_fingerprint="fp")
        assert s2.as_dict() == {"a": {"x": 1}, "b": {"x": 2}}
        with p.open("a") as f:                     # torn by a heartbeat
            f.write('{"_key": "d", "_hb": 1\n{"_hb": {"done": 2}}\n')
        s3 = mod.ResumableSweep(p, config_fingerprint="fp")
        assert len(s3) == 2 and s3.get("a") == {"x": 1}
        with p.open("a") as f:
            f.write('{"_key": "f", "x": 6}\n{broken\n{"_key": "e", "x": 5}\n')
        s4 = mod.ResumableSweep(p, config_fingerprint="fp")
        assert len(s4) == 0 and (d / "s.jsonl.bak").exists()
        mod.ResumableSweep(p, config_fingerprint="other")
        mod.ResumableSweep(p, config_fingerprint="other", resume=False)
        assert (d / "s.jsonl.bak2").exists()
    for name in ("s.jsonl", "s.jsonl.bak", "s.jsonl.bak1", "s.jsonl.bak2"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "ref" / name).read_text(), name


@pytest.mark.parametrize("value,on", [(None, True), ("1", True),
                                      ("0", False), ("off", False),
                                      ("no", False), ("false", False)])
def test_fsync_switch_reads_the_same_variable(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv("REPRO_CKPT_FSYNC", raising=False)
    else:
        monkeypatch.setenv("REPRO_CKPT_FSYNC", value)
    assert explore._fsync_enabled() is on is ref_explore._fsync_enabled()


def test_heartbeats_follow_hb_every(tmp_path):
    cands, _ = grid()
    (cfg, _), (wl, _) = cfgs(iters=10), workloads()
    ck = tmp_path / "s.jsonl"
    with explore.ExplorationEngine(wl, cfg, checkpoint=ck,
                                   hb_every=0) as eng:
        eng.run(cands[:2])
    hbs = [json.loads(l)["_hb"] for l in ck.read_text().splitlines()
           if '"_hb"' in l]
    assert [h["done"] for h in hbs] == [1, 2, 3, 4]
    assert {h["shard"] for h in hbs} == {"0/1"}
    assert len(explore.ResumableSweep.read(ck)) == 4


# ---------------------------------------------------------------------------
# screening, engine API, Pareto frontier
# ---------------------------------------------------------------------------

def test_batched_screen_equals_per_candidate_screen():
    """The port's batched T-Map screen is bit-identical to scoring each
    candidate on its own (``batched_screen=False``)."""
    cands, _ = grid()
    (cfg, _), (wl, _) = cfgs(), workloads()
    bw = [a.replace(noc_bw=n, dram_bw=d) for a in cands[:4]
          for n, d in ((8.0, 8.0), (32.0, 16.0))]
    with explore.ExplorationEngine(wl, cfg) as eng:
        batched = eng.screen(bw)
    with explore.ExplorationEngine(wl, cfg, batched_screen=False) as eng:
        single = eng.screen(bw)
    assert objectives(batched, explore) == objectives(single, explore)
    assert [p.per_workload for p in batched] == \
        [p.per_workload for p in single]


def test_engine_map_archs_keeps_order_and_last_screen():
    cands, rcands = grid()
    (cfg, rcfg), (wl, rwl) = cfgs(), workloads()
    with explore.ExplorationEngine(wl, cfg) as eng:
        mapped = eng.map_archs(cands[:3], use_sa=False)
        eng.run(cands, screen_keep=0.5)
        screened = eng.last_screen
    with ref_explore.ExplorationEngine(rwl, rcfg) as eng:
        ref = eng.map_archs(rcands[:3], use_sa=False)
    assert objectives(mapped, explore) == objectives(ref, ref_explore)
    assert [explore.candidate_key(p.arch) for p in mapped] == \
        [explore.candidate_key(a) for a in cands[:3]]
    assert len(screened) == len(cands)
    with pytest.raises(ValueError, match="adaptive"):
        dse.run_dse(cands, wl, cfg, screen_keep="auto", shard=(0, 2))
    with pytest.raises(ValueError, match="bad shard"):
        dse.run_dse(cands, wl, cfg, shard=(2, 2))
    with pytest.raises(ValueError, match="indices"):
        dse.run_dse(cands, wl, cfg, indices=[0], screen_keep=0.5)


def test_indices_run_equals_the_same_candidates_of_the_full_sweep():
    cands, _ = grid()
    (cfg, _), (wl, _) = cfgs(), workloads()
    full = {k: v for k, v in objectives(dse.run_dse(cands, wl, cfg),
                                        explore)}
    part = dse.run_dse(cands, wl, cfg, indices=[4, 1], shard_label="x")
    assert {k: full[k] for k, _ in objectives(part, explore)} == \
        dict(objectives(part, explore))


def test_pareto_frontier_equals_reference():
    cands, rcands = grid()
    (cfg, rcfg), (wl, rwl) = cfgs(), workloads()
    pts = dse.run_dse(cands, wl, cfg, use_sa=False)
    rpts = ref_dse.run_dse(rcands, rwl, rcfg, use_sa=False)
    for keys in (("mc", "energy_j", "delay_s"), ("energy_j", "delay_s"),
                 ("mc", "energy_j", "delay_s", "objective")):
        assert objectives(explore.pareto_frontier(pts, keys), explore) == \
            objectives(ref_explore.pareto_frontier(rpts, keys), ref_explore)
    vals = [(1.0, 2.0, 3.0), (1.0, 2.0, 3.0), (2.0, 1.0, 3.0),
            (2.0, 2.0, 3.0), (0.5, 5.0, 1.0)]
    assert explore._pareto_mask_sweep(vals) == \
        explore._pareto_mask_quadratic(vals) == \
        [True, True, True, False, True]
