"""The port's supervised sweep (``repro_torch.dist``,
``repro_torch.launch.sweep_ctl``) against the reference's ``repro.dist``.

Both packages get the same inputs: the seeded retry jitter and fault plans,
the host list, the CI-sized quick spec and its fingerprint.  The port's
chaos matrix (every fault kind) merges bit-identically to a clean
unsharded run; its merged records equal the reference's for the same spec
and fault seed, record for record (the ``_merged_from`` provenance line
aside); each package's ``sweep_ctl merge`` and ``status`` read the other's
out dir.  The shard children score with the numpy backend and import no
torch.  A spec that scores on ``backend="fused"`` without a card ends in
``SupervisorError``, its children's logs naming ``fused_device``, and no
record is scored on numpy.  Every comparison is bit-equality.
"""

import functools
import itertools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.dist import faults as ref_faults
from repro.dist import hosts as ref_hosts
from repro.dist import retrying as ref_retrying
from repro.dist import supervisor as ref_sup
from repro.launch import sweep_ctl as ref_ctl
from repro_torch.core.dse import run_dse
from repro_torch.dist import faults, hosts, retrying
from repro_torch.dist import supervisor as sup
from repro_torch.dist.faults import FAULT_EXIT_CODE, FAULT_KINDS, FaultSpec
from repro_torch.dist.hosts import LocalProcessHost, ShellCommandHost
from repro_torch.dist.supervisor import (Supervisor, SupervisorError,
                                         SweepSpec, quick_spec, read_state,
                                         supervised_results)
from repro_torch.launch import sweep_ctl

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"


def _sig(points):
    return [(p.arch, p.objective, p.energy_j, p.delay_s) for p in points]


def _two_hosts(mod=hosts):
    return [mod.LocalProcessHost(name="local0", retry_seed=100),
            mod.LocalProcessHost(name="local1", retry_seed=101)]


@pytest.fixture(scope="module")
def spec():
    return quick_spec(seed=3, n_shards=2)


@pytest.fixture(scope="module")
def clean_sig(spec):
    """The failure-free unsharded run every supervised result must match
    bit for bit."""
    return _sig(run_dse(spec.build_candidates(), spec.build_workloads(),
                        spec.build_cfg(), use_sa=True))


@functools.lru_cache(maxsize=None)
def _chaos_run(pkg: str, kind: str, root: str) -> Path:
    """One supervised quick sweep with ``kind`` injected (fault seed 0)
    under ``pkg``'s supervisor; its out dir (each (pkg, kind) runs once).
    Only ``stall`` waits out the heartbeat deadline, so only it gets a
    short one (long enough for a loaded machine to start a child)."""
    mod = sup if pkg == "port" else ref_sup
    out = Path(root) / f"{pkg}-{kind}"
    s = mod.Supervisor(mod.quick_spec(seed=3, n_shards=2), out_dir=out,
                       hosts=_two_hosts(hosts if pkg == "port"
                                        else ref_hosts),
                       hb_timeout=10.0 if kind == "stall" else 60.0,
                       poll_s=0.15, fault_kind=kind, fault_seed=0)
    s.run()
    return out


@pytest.fixture(scope="module")
def chaos_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("chaos"))


def _records(path):
    """A merged checkpoint's task records by key, and its header."""
    recs, header = {}, None
    for line in Path(path).read_text().splitlines():
        d = json.loads(line)
        if "_key" in d:
            recs[d.pop("_key")] = d
        elif "_config" in d:
            header = d["_config"]
    return recs, header


# ---------------------------------------------------------------------------
# retrying, faults, hosts: the reference's seeded streams and grammar
# ---------------------------------------------------------------------------

POLICIES = [
    {},
    {"max_attempts": 5, "base_s": 0.05, "factor": 3.0, "max_s": 1.0,
     "jitter": 0.25},
    {"jitter": 0.0, "base_s": 0.2},
    {"max_attempts": 4, "base_s": 0.05, "factor": 2.0, "max_s": 2.0},
]


@pytest.mark.parametrize("kw", POLICIES)
def test_backoff_delays_equal_the_references(kw):
    for seed in (0, 1, 2, 7, 100, 12345, -3):
        a = list(itertools.islice(retrying.backoff_delays(
            retrying.RetryPolicy(**kw), seed), 16))
        b = list(itertools.islice(ref_retrying.backoff_delays(
            ref_retrying.RetryPolicy(**kw), seed), 16))
        assert a == b


@pytest.mark.parametrize("fails", [0, 2, 5])
def test_retry_call_sleeps_and_raises_as_the_reference(fails):
    """Injected clock and sleep: the same sleeps, the same result or the
    same re-raised error, and a non-retryable error passes at once."""
    def run(mod):
        calls, slept = [0], []

        def fn():
            calls[0] += 1
            if calls[0] <= fails:
                raise OSError(f"transient {calls[0]}")
            return "done"
        pol = mod.RetryPolicy(max_attempts=4, base_s=0.1)
        try:
            got = mod.retry_call(fn, policy=pol, seed=11, sleep=slept.append,
                                 clock=lambda: 0.0)
        except OSError as e:
            got = f"raised {e}"
        return got, slept, calls[0]
    assert run(retrying) == run(ref_retrying)
    with pytest.raises(KeyError):
        retrying.retry_call(lambda: {}["x"], sleep=lambda s: None)


@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_plan_faults_equal_the_references(kind):
    assert FAULT_KINDS == ref_faults.FAULT_KINDS
    assert FAULT_EXIT_CODE == ref_faults.FAULT_EXIT_CODE == 73
    assert (faults.FAULT_ENV, faults.FAULT_ATTEMPT_ENV) == \
        ("REPRO_FAULT", "REPRO_FAULT_ATTEMPT")
    for seed in range(32):
        for n in (1, 2, 3, 4, 7):
            for k in (None, 3):
                a = {v: s.encode() for v, s in
                     faults.plan_faults(seed, n, kind, k=k).items()}
                b = {v: s.encode() for v, s in
                     ref_faults.plan_faults(seed, n, kind, k=k).items()}
                assert a == b
    spec = FaultSpec(kind, 2)
    assert faults.env_for(spec, 1) == ref_faults.env_for(
        ref_faults.FaultSpec(kind, 2), 1)


@pytest.mark.parametrize("text", ["kill", "stall:3", "slow", "corrupt:2:0",
                                  "slow:2:0.25", "dup:1", "kill::"])
def test_fault_spec_grammar_round_trips_as_the_references(text):
    a, b = FaultSpec.parse(text), ref_faults.FaultSpec.parse(text)
    assert (a.kind, a.k, a.param) == (b.kind, b.k, b.param)
    assert a.encode() == b.encode()
    assert FaultSpec.parse(a.encode()) == a
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("meteor")


def test_parse_hosts_gives_the_references_kinds_and_names():
    for specs, n in (([], 0), ([], 2), (["{cmd}"], 2),
                     (["ssh dse-01 {cmd}", "srun -p b {cmd}"], 1)):
        a = [(type(h).__name__, h.name, h.retry_seed)
             for h in hosts.parse_hosts(specs, n_local=n)]
        b = [(type(h).__name__, h.name, h.retry_seed)
             for h in ref_hosts.parse_hosts(specs, n_local=n)]
        assert a == b
    with pytest.raises(ValueError, match="cmd"):
        ShellCommandHost("ssh dse-01")


def test_child_env_reaches_this_checkouts_src(tmp_path, monkeypatch):
    """With ``PYTHONPATH`` unset, a local child still imports this
    checkout's ``repro_torch``; the env overrides arrive."""
    monkeypatch.delenv("PYTHONPATH", raising=False)
    env = hosts._child_env({"DIST_TEST": "yes"})
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(SRC)
    log = tmp_path / "out.log"
    h = LocalProcessHost()
    handle = h.launch(["-c", "import os, repro_torch; "
                       "print(repro_torch.__file__, os.environ['DIST_TEST'])"],
                      env={"DIST_TEST": "yes"}, log_path=log)
    assert handle.wait(timeout=60) == 0
    assert f"{SRC / 'repro_torch' / '__init__.py'} yes" in log.read_text()


def test_shell_command_host_loopback(tmp_path):
    """The ``{cmd}`` template is a local loopback: env prefixes and argv
    quoting survive the ``sh -c`` hop."""
    h = ShellCommandHost("{cmd}", python=sys.executable)
    log = tmp_path / "out.log"
    handle = h.launch(["-c", "import os; print(os.environ['DIST_TEST'])"],
                      env={"DIST_TEST": "a b'c"}, log_path=log)
    assert handle.wait(timeout=60) == 0
    assert "a b'c" in log.read_text()


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,keep", [(3, 2, 1.0), (0, 3, 0.5),
                                         (99, 1, 1.0)])
def test_quick_spec_json_and_fingerprint_equal_the_references(seed, n,
                                                              keep):
    a = quick_spec(seed=seed, n_shards=n, screen_keep=keep)
    b = ref_sup.quick_spec(seed=seed, n_shards=n, screen_keep=keep)
    assert a.to_json() == b.to_json()
    assert a.fingerprint() == b.fingerprint()
    assert SweepSpec.from_json(a.to_json()) == a
    assert [c.label() for c in a.build_candidates()] == \
        [c.label() for c in b.build_candidates()]


def test_spec_validation_and_the_ports_backends():
    base = dict(workloads={"tf": "tf-quick"}, grid={"tops": 72.0})
    for bad in (dict(workloads={}, grid={"tops": 72.0}),
                dict(base, n_shards=0), dict(base, screen_keep="auto"),
                dict(base, cfg={"sa": {}})):
        with pytest.raises(ValueError):
            SweepSpec(**bad)
    with pytest.raises(ValueError, match="unknown eval batch backend"):
        SweepSpec(**base, sa={"backend": "jax"})
    fused = SweepSpec(**base, sa={"backend": "fused", "n_chains": 4})
    assert fused.build_cfg().sa.backend == "fused"
    assert SweepSpec.from_json(fused.to_json()) == fused


# ---------------------------------------------------------------------------
# supervised sweeps: the chaos matrix, resume, the reference's records
# ---------------------------------------------------------------------------

def test_supervisor_happy_path_bit_identical(spec, clean_sig, tmp_path):
    s = Supervisor(spec, out_dir=tmp_path, hosts=_two_hosts(),
                   hb_timeout=60.0, poll_s=0.15)
    merged = s.run()
    assert _sig(supervised_results(spec, merged)) == clean_sig
    state = read_state(s.state_path)
    assert state["plan"]["fingerprint"] == spec.fingerprint()
    evs = [e["ev"] for e in state["events"]]
    assert evs.count("launch") == 2 and "merged" in evs


@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_chaos_matrix_bit_identical(spec, clean_sig, chaos_root, kind):
    """Under every fault kind the supervised sweep's merged result is
    bit-identical to the clean unsharded run."""
    out = _chaos_run("port", kind, chaos_root)
    assert _sig(supervised_results(spec, out / "merged.jsonl")) == clean_sig
    evs = read_state(out / "supervisor_state.jsonl")["events"]
    names = [e["ev"] for e in evs]
    if kind in ("kill", "corrupt"):
        assert FAULT_EXIT_CODE in [e["rc"] for e in evs if e["ev"] == "exit"]
    if kind == "stall":
        assert {"hb_timeout", "dead", "reshard"} <= set(names)
    if kind == "dup":
        assert names.count("launch") >= 3


@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_merged_records_equal_the_references(chaos_root, kind):
    """The same spec and fault seed under both supervisors: the same plan
    and the same merged records, record for record."""
    mine, theirs = (_chaos_run(p, kind, chaos_root) for p in ("port", "ref"))
    a, ha = _records(mine / "merged.jsonl")
    b, hb = _records(theirs / "merged.jsonl")
    assert ha == hb and len(a) == 6
    assert a == b
    pa = read_state(mine / "supervisor_state.jsonl")["plan"]
    pb = ref_sup.read_state(theirs / "supervisor_state.jsonl")["plan"]
    for k in ("fingerprint", "keep", "shards", "spec", "fault_kind",
              "faults"):
        assert pa[k] == pb[k], k


def test_supervisor_resume_after_death(spec, clean_sig, tmp_path):
    """One host, one attempt: the victim's crash exhausts the retries, the
    only host is declared dead and the supervisor raises with its journal
    on disk; a fresh supervisor resumes and completes bit-identically."""
    out = tmp_path / "sweep"
    s = Supervisor(spec, out_dir=out, hosts=[LocalProcessHost(name="only")],
                   hb_timeout=60.0, poll_s=0.15, max_attempts=1,
                   fault_kind="kill", fault_seed=0)
    with pytest.raises(SupervisorError):
        s.run()
    state = read_state(s.state_path)
    assert state["merged"] is None
    assert any(e["ev"] == "dead" for e in state["events"])
    s2 = Supervisor(spec, out_dir=out, hosts=_two_hosts(), hb_timeout=60.0,
                    poll_s=0.15)
    merged = s2.resume()
    assert _sig(supervised_results(spec, merged)) == clean_sig
    assert any(e["ev"] == "resume" for e in read_state(s2.state_path)
               ["events"])


def test_supervisor_resume_refuses_a_foreign_journal(spec, tmp_path):
    other = quick_spec(seed=99)
    s = Supervisor(other, out_dir=tmp_path, hosts=_two_hosts())
    s._event("plan", fingerprint="dse:v2:something-else", keep=[0],
             n_candidates=1, shards=[[0]], spec=other.to_dict())
    with pytest.raises(SupervisorError, match="different sweep"):
        Supervisor(spec, out_dir=tmp_path, hosts=_two_hosts()).resume()


def test_supervisor_screens_once_like_the_sharded_screen(tmp_path):
    """``screen_keep < 1``: the supervisor screens once and ships the keep
    set; the result equals the clean run that screens inside the engine."""
    spec = quick_spec(seed=3, n_shards=2, screen_keep=0.5)
    clean = _sig(run_dse(spec.build_candidates(), spec.build_workloads(),
                         spec.build_cfg(), use_sa=True, screen_keep=0.5))
    s = Supervisor(spec, out_dir=tmp_path, hosts=_two_hosts(), poll_s=0.15)
    merged = s.run()
    assert _sig(supervised_results(spec, merged)) == clean
    assert len(read_state(s.state_path)["plan"]["keep"]) == 3


def test_numpy_shard_child_imports_no_torch(spec, tmp_path):
    """A numpy shard child imports the engine, never torch."""
    (tmp_path / "spec.json").write_text(spec.to_json())
    code = (
        "import json, sys\n"
        "from repro_torch.dist import shard_child\n"
        f"rc = shard_child.main(['--spec', {str(tmp_path / 'spec.json')!r},"
        f" '--indices', '0,3', '--checkpoint', "
        f"{str(tmp_path / 'c.jsonl')!r}])\n"
        "print(json.dumps([rc, 'torch' in sys.modules]))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.splitlines()[-1]) == [0, False]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
def test_fused_spec_without_a_card_ends_in_supervisor_error(tmp_path):
    """``backend="fused"`` on a machine without CUDA: every child fails
    with the fused path's error (naming ``fused_device``), the supervisor
    raises after its attempts, and no record was scored on numpy."""
    q = quick_spec(seed=3, n_shards=2)
    spec = SweepSpec(workloads=q.workloads, grid=q.grid,
                     sa={**q.sa, "backend": "fused", "n_chains": 2},
                     cfg=q.cfg, n_shards=2)
    s = Supervisor(spec, out_dir=tmp_path, hosts=_two_hosts(),
                   hb_timeout=60.0, poll_s=0.15, max_attempts=2)
    with pytest.raises(SupervisorError, match="no live hosts"):
        s.run()
    exited = {f"s{e['shard']}{'d' if e['dup'] else 'a'}{e['attempt']}"
              for e in read_state(s.state_path)["events"]
              if e["ev"] == "exit"}
    assert len(exited) >= 4          # two shards, two attempts each
    for label in exited:             # (a child killed when its host died
        text = (tmp_path / f"{label}.log").read_text()   # never exited)
        assert "fused_device" in text and "RuntimeError" in text, label
    for ck in tmp_path.glob("shard*.jsonl"):
        assert '"_key"' not in ck.read_text()


# ---------------------------------------------------------------------------
# sweep_ctl: the CLI, and each package's CLI on the other's out dir
# ---------------------------------------------------------------------------

def test_sweep_ctl_launch_status_merge(tmp_path, capsys):
    out = tmp_path / "run"
    rc = sweep_ctl.main(["launch", "--quick", "--out", str(out), "--hosts",
                         "2", "--poll", "0.15", "--fault", "kill",
                         "--fault-seed", "0", "--verify-clean"])
    assert rc == 0
    assert "verify-clean: OK" in capsys.readouterr().out
    assert sweep_ctl.main(["status", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "fingerprint" in text and "shard progress" in text
    assert sweep_ctl.main(["merge", "--out", str(out), "--on-conflict",
                           "error"]) == 0
    assert "[complete]" in capsys.readouterr().out


@pytest.mark.parametrize("reader,writer", [("port", "ref"), ("ref", "port")])
def test_sweep_ctl_reads_the_other_packages_out_dir(chaos_root, tmp_path,
                                                    capsys, reader, writer):
    """``merge`` and ``status`` of one package over the other's supervised
    out dir (a copy: the journal names the original checkpoints): the
    merge is complete, its records equal the writer's, the status names
    the fingerprint and the shards."""
    src = _chaos_run(writer, "kill", chaos_root)
    out = tmp_path / "copy"
    shutil.copytree(src, out)
    (out / "merged.jsonl").unlink()
    main = (sweep_ctl if reader == "port" else ref_ctl).main
    assert main(["merge", "--out", str(out), "--on-conflict", "error"]) == 0
    assert "[complete]" in capsys.readouterr().out
    assert _records(out / "merged.jsonl")[0] == \
        _records(src / "merged.jsonl")[0]
    assert main(["status", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "fingerprint dse:v2:" in text and "== shard progress ==" in text
    assert "== Pareto snapshot" in text


def test_sweep_ctl_exit_codes(tmp_path, capsys):
    """No journal: ``status`` 1; an unknown fault kind refused; a spec
    that names neither a file nor ``--quick`` refused."""
    assert sweep_ctl.main(["status", "--out", str(tmp_path)]) == 1
    with pytest.raises(SystemExit, match="unknown --fault"):
        sweep_ctl.main(["launch", "--quick", "--out", str(tmp_path),
                        "--fault", "meteor"])
    with pytest.raises(SystemExit, match="--quick"):
        sweep_ctl.main(["launch", "--out", str(tmp_path)])
    capsys.readouterr()
