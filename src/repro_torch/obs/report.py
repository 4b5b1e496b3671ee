"""Sweep post-mortem: render a run dir + shard checkpoints as text tables.

Input artifacts (all optional — sections render from whatever exists):

* a **run dir** written under ``REPRO_OBS=1`` — ``manifest.json``,
  ``metrics.json``, and the per-process ``trace-*.jsonl`` event streams;
* **shard checkpoint** files (``ResumableSweep`` JSONL) — record counts +
  the ``{"_hb": ...}`` heartbeat lines give per-shard liveness/progress,
  and the task records themselves give a Pareto-frontier snapshot of the
  running (or finished) sweep.

Everything here is a pure function of its inputs (the only clock read is
the ``now`` parameter of :func:`shard_progress`), so the report output is
byte-stable — ``tests/test_torch_obs.py`` holds it to the reference's
rendering of the same files.  CLI wrapper: ``python -m
repro_torch.launch.obs_report``.

Copy of ``src/repro/obs/report.py``; the Pareto snapshot reads the port's
own ``core.explore`` and ``core.mc``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def load_run(run_dir: Union[str, Path]) -> Dict[str, Any]:
    """Parse one obs run dir: manifest, metrics, merged event list.

    Events from all ``trace-*.jsonl`` streams are concatenated in sorted
    stream-name order (per-stream line order preserved); unparseable lines
    are skipped — a stream truncated by a dying worker must not take the
    post-mortem down with it.
    """
    d = Path(run_dir)
    out: Dict[str, Any] = {"manifest": None, "metrics": None, "events": []}
    man = d / "manifest.json"
    if man.exists():
        try:
            out["manifest"] = json.loads(man.read_text())
        except ValueError:
            pass
    met = d / "metrics.json"
    if met.exists():
        try:
            out["metrics"] = json.loads(met.read_text())
        except ValueError:
            pass
    for p in sorted(d.glob("trace-*.jsonl")):
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            try:
                out["events"].append(json.loads(line))
            except ValueError:
                continue
    return out


# ---------------------------------------------------------------------------
# Sections (pure projections)
# ---------------------------------------------------------------------------

def phase_rows(metrics: Optional[Dict[str, Any]]
               ) -> List[Tuple[str, int, float, float, float]]:
    """Time-in-phase from the ``phase.*`` histograms: (name, n calls,
    total s, mean ms, max ms), largest total first."""
    if not metrics:
        return []
    rows = []
    for name, h in (metrics.get("histograms") or {}).items():
        if not name.startswith("phase.") or not h.get("n"):
            continue
        total = float(h["total"])
        rows.append((name[len("phase."):], int(h["n"]), total,
                     1e3 * total / h["n"], 1e3 * float(h["max"])))
    rows.sort(key=lambda r: (-r[2], r[0]))
    return rows


def top_tasks(events: Sequence[Dict[str, Any]], k: int = 10
              ) -> List[Dict[str, Any]]:
    """The k slowest ``task`` spans (one per (candidate, workload) SA run),
    with their queue-wait where the parent recorded one."""
    tasks = [e for e in events
             if e.get("ev") == "span" and e.get("name") == "task"]
    tasks.sort(key=lambda e: (-float(e.get("dur", 0.0)),
                              str(e.get("attrs", {}))))
    return tasks[:k]


_CACHE_GROUPS = (
    ("group_eval", "GroupEval exact"),
    ("group_eval_fused", "GroupEval fused"),
    ("geo_cache", "_GEO_CACHE"),
)


def cache_rows(metrics: Optional[Dict[str, Any]]
               ) -> List[Tuple[str, int, int, float, int]]:
    """Cache economics: (cache, hits, misses, hit rate, evictions)."""
    if not metrics:
        return []
    c = metrics.get("counters") or {}
    rows = []
    for prefix, label in _CACHE_GROUPS:
        hits = int(c.get(f"{prefix}.hits", 0))
        misses = int(c.get(f"{prefix}.misses", 0))
        ev = int(c.get(f"{prefix}.evictions", 0))
        if hits or misses or ev:
            rate = hits / (hits + misses) if hits + misses else 0.0
            rows.append((label, hits, misses, rate, ev))
    return rows


def parse_heartbeats(path: Union[str, Path]
                     ) -> Tuple[int, Optional[Dict[str, Any]]]:
    """(task-record count, last heartbeat) of one checkpoint shard.

    Tolerant by design: corrupt lines are skipped — this is the liveness
    probe a multi-host driver polls against files being appended to
    *right now*.
    """
    n_records = 0
    last_hb: Optional[Dict[str, Any]] = None
    p = Path(path)
    if not p.exists():
        return 0, None
    for line in p.read_text().splitlines():
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if "_key" in rec:
            n_records += 1
        elif "_hb" in rec:
            last_hb = rec["_hb"]
    return n_records, last_hb


def shard_progress(paths: Sequence[Union[str, Path]],
                   now: Optional[float] = None
                   ) -> List[Dict[str, Any]]:
    """Per-shard liveness rows from heartbeat records.

    ``now`` (wall clock) turns the last heartbeat's timestamp into an age;
    pass a fixed value for reproducible output (the golden test does),
    None to read the real clock.
    """
    if now is None:
        import time
        now = time.time()
    rows = []
    for p in paths:
        n_rec, hb = parse_heartbeats(p)
        row: Dict[str, Any] = {"shard": Path(p).name, "records": n_rec,
                               "done": None, "total": None,
                               "wall_s": None, "hb_age_s": None}
        if hb:
            row["shard"] = str(hb.get("shard", row["shard"]))
            row["done"] = hb.get("done")
            row["total"] = hb.get("total")
            row["wall_s"] = hb.get("wall_s")
            if hb.get("t") is not None:
                row["hb_age_s"] = max(0.0, now - float(hb["t"]))
        rows.append(row)
    return rows


_FP_OBJ_RE = re.compile(r"^dse:v\d+:a([0-9.eE+-]+):b([0-9.eE+-]+)"
                        r":g([0-9.eE+-]+):")


def pareto_snapshot(paths: Sequence[Union[str, Path]], top: int = 10
                    ) -> List[Dict[str, Any]]:
    """Pareto frontier of the (possibly still-running) sweep recorded in
    ``paths``: merge task records last-wins, geomean (E, D) per candidate
    over its recorded workloads, re-derive MC from the arch dict, mask by
    (MC, E, D) dominance.

    Candidates whose task set is still incomplete contribute whatever
    workloads they have — this is a *snapshot*, not the final reduction
    (the objective column uses the fingerprint's alpha/beta/gamma and the
    plain geomean, i.e. the default-objective view).
    """
    import math

    from ..core.explore import _pareto_mask_sweep, arch_from_dict
    from ..core.mc import evaluate_mc

    fingerprint: Optional[str] = None
    records: Dict[str, Dict[str, Any]] = {}
    for p in (Path(s) for s in paths):
        if not p.exists():
            continue
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if "_config" in rec:
                fingerprint = rec["_config"]
                continue
            key = rec.pop("_key", None)
            if key is not None and "energy_j" in rec:
                records[key] = rec
    alpha = beta = gamma = 1.0
    if fingerprint:
        m = _FP_OBJ_RE.match(fingerprint)
        if m:
            alpha, beta, gamma = (float(m.group(i)) for i in (1, 2, 3))
    by_cand: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for key, rec in records.items():
        cand, _, wl = key.rpartition("|wl=")
        if not cand:
            continue
        by_cand.setdefault(cand, {})[wl] = rec
    pts = []
    for cand in sorted(by_cand):
        per = by_cand[cand]
        try:
            arch = arch_from_dict(per[sorted(per)[0]]["arch"])
            mc = evaluate_mc(arch).total
        except (KeyError, TypeError, ValueError):
            continue
        logE = logD = 0.0
        for wl in sorted(per):
            logE += math.log(float(per[wl]["energy_j"]))
            logD += math.log(float(per[wl]["delay_s"]))
        n = max(1, len(per))
        E, D = math.exp(logE / n), math.exp(logD / n)
        pts.append({"arch": arch.label(), "mc": mc, "energy_j": E,
                    "delay_s": D, "n_workloads": len(per),
                    "objective": (mc ** alpha) * (E ** beta) * (D ** gamma)})
    mask = _pareto_mask_sweep(
        [(p["mc"], p["energy_j"], p["delay_s"]) for p in pts])
    front = [p for p, m in zip(pts, mask) if m]
    front.sort(key=lambda p: p["objective"])
    return front[:top]


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def _table(headers: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    cols = [list(col) for col in zip(headers, *rows)] if rows else \
        [[h] for h in headers]
    widths = [max(len(c) for c in col) for col in cols]
    def fmt(cells):
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths)) \
            .rstrip()
    lines = [fmt(headers), fmt(["-" * w for w in widths])]
    lines += [fmt(r) for r in rows]
    return "\n".join(lines)


def render_report(run: Union[str, Path, None] = None,
                  ckpts: Sequence[Union[str, Path]] = (),
                  top: int = 10, now: Optional[float] = None) -> str:
    """The full post-mortem as one text blob (CLI prints it verbatim)."""
    out: List[str] = []
    data = load_run(run) if run is not None else \
        {"manifest": None, "metrics": None, "events": []}
    man = data["manifest"]
    if man:
        out.append("== run manifest ==")
        prov = man.get("provenance") or {}
        for k in ("fingerprint", "seed", "grid", "shard", "n_workers",
                  "stage"):
            if man.get(k) is not None:
                out.append(f"  {k:<12} {man[k]}")
        out.append(f"  {'commit':<12} {prov.get('commit', '?')} "
                   f"@ {prov.get('date', '?')} "
                   f"(cpus={prov.get('cpu_count', '?')})")
        out.append("")
    ph = phase_rows(data["metrics"])
    if ph:
        out.append("== time in phase ==")
        out.append(_table(
            ("phase", "calls", "total_s", "mean_ms", "max_ms"),
            [(n, str(c), f"{t:.3f}", f"{mean:.2f}", f"{mx:.2f}")
             for n, c, t, mean, mx in ph]))
        out.append("")
    tt = top_tasks(data["events"], k=top)
    if tt:
        out.append(f"== top {len(tt)} slowest tasks ==")
        rows = []
        for e in tt:
            a = e.get("attrs", {})
            rows.append((str(a.get("arch", "?")), str(a.get("wl", "?")),
                         f"{float(e.get('dur', 0.0)):.3f}",
                         f"{float(a.get('queue_s', 0.0)):.3f}",
                         str(e.get("pid", "?"))))
        out.append(_table(("arch", "workload", "wall_s", "queue_s", "pid"),
                          rows))
        out.append("")
    cr = cache_rows(data["metrics"])
    if cr:
        out.append("== cache economics ==")
        out.append(_table(
            ("cache", "hits", "misses", "hit_rate", "evictions"),
            [(n, str(h), str(m), f"{r:.1%}", str(ev))
             for n, h, m, r, ev in cr]))
        out.append("")
    if data["metrics"]:
        c = data["metrics"].get("counters") or {}
        extras = []
        for key, label in (
                ("screen.kept", "screening kept"),
                ("screen.pruned", "screening pruned"),
                ("prefetch.batched_builds", "prefetch batched builds"),
                ("prefetch.scalar_builds", "prefetch scalar builds"),
                ("sa.proposed", "SA proposals"),
                ("sa.accepted", "SA accepts"),
                ("sa.swap_attempts", "RE swap attempts"),
                ("sa.swap_accepts", "RE swap accepts"),
                ("engine.tasks", "tasks evaluated"),
                ("engine.tasks_resumed", "tasks resumed"),
                ("serve.requests", "serve requests replayed"),
                ("supervisor.launches", "supervisor launches"),
                ("supervisor.retries", "supervisor retries"),
                ("supervisor.deaths", "hosts declared dead"),
                ("supervisor.reshards", "re-shard events"),
                ("retry.attempts", "retried transient failures"),
                ("merge.conflicts", "merge conflicts")):
            if c.get(key):
                extras.append((label, f"{int(c[key])}"))
        if c.get("sa.proposed"):
            extras.append(("SA acceptance rate",
                           f"{c.get('sa.accepted', 0) / c['sa.proposed']:.1%}"))
        if c.get("sa.swap_attempts"):
            extras.append((
                "RE swap rate",
                f"{c.get('sa.swap_accepts', 0) / c['sa.swap_attempts']:.1%}"))
        if extras:
            out.append("== engine counters ==")
            out.append(_table(("counter", "value"), extras))
            out.append("")
    if ckpts:
        rows = shard_progress(ckpts, now=now)
        out.append("== shard progress ==")
        def cell(v, fmt="{}"):
            return "?" if v is None else fmt.format(v)
        out.append(_table(
            ("shard", "records", "done/total", "wall_s", "hb_age_s"),
            [(r["shard"], str(r["records"]),
              f"{cell(r['done'])}/{cell(r['total'])}",
              cell(r["wall_s"], "{:.1f}"), cell(r["hb_age_s"], "{:.1f}"))
             for r in rows]))
        out.append("")
        front = pareto_snapshot(ckpts, top=top)
        if front:
            out.append(f"== Pareto snapshot (top {len(front)}) ==")
            out.append(_table(
                ("arch", "MC", "E_J", "D_s", "objective", "wls"),
                [(p["arch"], f"{p['mc']:.4g}", f"{p['energy_j']:.4g}",
                  f"{p['delay_s']:.4g}", f"{p['objective']:.6g}",
                  str(p["n_workloads"])) for p in front]))
            out.append("")
    if not out:
        out.append("(no obs artifacts found — run with REPRO_OBS=1 and/or "
                   "pass --ckpt shard files)")
    return "\n".join(out).rstrip() + "\n"
