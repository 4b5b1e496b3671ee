"""Training on packed documents: the program's train step
(``repro_torch.launch.steps.make_train_step``, AdamW from
``repro_torch.optim.adamw``) over the model holding the benchmark's
weights, fed the mix's batches.

Set-up builds one train state and drives it through the mix's first
``check_steps`` steps through the same step function and feed as the
window (they are its warm-up), keeping what the check needs: each
step's loss, the per-leaf norms of the first gradient as the optimizer
got it (``m / (1 - b1)`` after one step) and of the parameters' change
after the last.  The window then takes step after step of the same state
until ``--seconds`` have passed, each ending on the loss read on the host
(as the program's own trainer does); it spans from its start to the end
of its last step.

The check (after the window, the program's state freed): the plain
reference in f32 takes the same weights and batches through the same
number of steps of AdamW with the mix's settings.  The numbers compared:
those the cell's limits name, of :func:`compare`'s: the gap between the
program's and the reference's norm of the first gradient and of the
change, leaf by leaf, against the larger of the reference's norm of that
leaf and of the median leaf, taken at the worst leaf and at the median
one.  Leaves whose reference gradient is under ``skip_grad_ratio`` of
the median leaf's are left out of the change.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench.lib.program import load_model
from bench.lib.trace import Tracer
from bench.lib.traffic import packed_batch
from bench.reference import lm as ref
from bench.reference.adamw import AdamW
from bench.reference.weights import make_weights


@dataclass
class Step:
    tokens: int
    t0: float
    t1: float
    loss: float
    traced: bool = False


@dataclass
class TrainRecord:
    steps: List[Step] = field(default_factory=list)
    check_losses: List[float] = field(default_factory=list)
    grad_norms: Dict[str, float] = field(default_factory=dict)
    change_norms: Dict[str, float] = field(default_factory=dict)
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    trace: Optional[object] = None


def opt_config(mix: Dict):
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(**mix["optimizer"])


def to_device(batch: Dict[str, np.ndarray], device) -> Dict:
    return {k: torch.from_numpy(v).to(device, non_blocking=False)
            for k, v in batch.items()}


def leaf_norms(tree: Dict[str, torch.Tensor], scale: float = 1.0
               ) -> Dict[str, float]:
    names = list(tree)
    norms = torch.stack(torch._foreach_norm(
        [tree[k].float() for k in names])) * scale
    return dict(zip(names, norms.double().cpu().tolist()))


def setup(model: Dict, mix: Dict, seed: int, device,
          step_fn: Optional[Callable] = None) -> Dict:
    from repro_torch.launch.steps import make_train_step, train_state
    cfg, params = load_model(model, seed, device)
    state = train_state(params)
    step_fn = step_fn or make_train_step(cfg, opt_config(mix))
    rec = TrainRecord()
    vocab = int(model["vocab"])
    b1 = float(mix["optimizer"]["b1"])
    for k in range(int(mix["check_steps"])):
        batch = to_device(packed_batch(mix, vocab, seed, k), device)
        state, metrics = step_fn(state, batch)
        rec.check_losses.append(float(metrics["loss"]))
        if k == 0:
            rec.grad_norms = leaf_norms(state["opt"]["m"], 1.0 / (1.0 - b1))
    W0 = make_weights(model, seed, device)
    with torch.no_grad():
        rec.change_norms = leaf_norms(
            {n: p - W0[n] for n, p in state["params"].named_parameters()})
    del W0
    return {"state": state, "step_fn": step_fn, "rec": rec, "model": model,
            "mix": mix, "seed": seed, "device": device}


def window(st: Dict, seconds: float, trace_path: Optional[Path]
           ) -> TrainRecord:
    """Steps until ``seconds`` have passed.  With ``trace_path``, the
    steps ``traced_steps = [first, end)`` of the window run under the
    profiler, whose trace is written and read once the window is over."""
    state, step_fn, rec = st["state"], st["step_fn"], st["rec"]
    mix, device, seed = st["mix"], st["device"], st["seed"]
    vocab = int(st["model"]["vocab"])
    lo, hi = (int(i) for i in mix["traced_steps"])
    ntok = int(mix["batch"]) * int(mix["seq_len"])
    k = int(mix["check_steps"])
    tracer = Tracer()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        if trace_path is not None and i == lo:
            tracer.start()
        ts = time.perf_counter()
        with tracer.note("bench.batch"):
            batch = to_device(packed_batch(mix, vocab, seed, k + i), device)
        with tracer.note("bench.step"):
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
        te = time.perf_counter()
        rec.attempted += 1
        rec.failed += int(not np.isfinite(loss))
        rec.steps.append(Step(ntok, ts, te, loss, traced=tracer.on))
        i += 1
        if i == hi:
            tracer.stop()
    rec.window_s = rec.steps[-1].t1 - t0 if rec.steps else 0.0
    tracer.stop()
    st["state"] = state
    if trace_path is not None:
        rec.trace = tracer.read(trace_path)
    return rec


def release(st: Dict) -> None:
    st.clear()


def reference_steps(model: Dict, mix: Dict, seed: int, device,
                    mm=torch.matmul, rows: Optional[slice] = None
                    ) -> Dict:
    """The reference's losses, first clipped gradient's leaf norms and
    change's leaf norms over the mix's ``check_steps`` steps.  ``rows``
    keeps only those rows of every batch (a fault's reading)."""
    W = make_weights(model, seed, device)
    W0 = {k: v.clone() for k, v in W.items()}
    for v in W.values():
        v.requires_grad_(True)
    opt = AdamW(mix["optimizer"], W)
    losses, grads0 = [], {}
    vocab = int(model["vocab"])
    with ref.f32_exact():
        for k in range(int(mix["check_steps"])):
            b = to_device(packed_batch(mix, vocab, seed, k), device)
            if rows is not None:
                b = {n: v[rows] for n, v in b.items()}
            loss = ref.loss(W, model, b["tokens"], b["labels"], b["mask"],
                            mm=mm)
            grads = torch.autograd.grad(loss, list(W.values()))
            g = opt.step(dict(zip(W, grads)))
            losses.append(float(loss.detach()))
            if k == 0:
                grads0 = leaf_norms(g)
            del grads, g, loss
    with torch.no_grad():
        change = leaf_norms({n: W[n] - W0[n] for n in W})
    return {"losses": losses, "grads": grads0, "change": change}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep=None) -> np.ndarray:
    """Each leaf's ``|got - want| / max(want, median want)``."""
    names = [n for n in want if keep is None or n in keep]
    med = float(np.median([want[n] for n in names]))
    return np.array([abs(got[n] - want[n]) / max(want[n], med)
                     for n in names])


def worst_leaves(got: Dict[str, float], want: Dict[str, float], k: int = 4
                 ) -> List[list]:
    """The ``k`` leaves of largest gap, with both norms."""
    med = float(np.median(list(want.values())))
    gaps = sorted(((abs(got[n] - want[n]) / max(want[n], med), n)
                   for n in want), reverse=True)[:k]
    return [[n, g, got[n], want[n]] for g, n in gaps]


def compare(prog: Dict, refr: Dict, mix: Dict) -> Dict[str, float]:
    """Every number that can be compared, program (or a stand-in) against
    reference: the largest relative gap of a step's loss, and the worst
    and the median leaf's gap of the first gradient's and of the change's
    norms."""
    med = float(np.median(list(refr["grads"].values())))
    moved = {n for n, g in refr["grads"].items()
             if g >= float(mix["skip_grad_ratio"]) * med}
    grads = leaf_gaps(prog["grads"], refr["grads"])
    change = leaf_gaps(prog["change"], refr["change"], moved)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(prog["losses"], refr["losses"])),
            "grad_norm_gap": float(grads.max()),
            "grad_norm_gap_median": float(np.median(grads)),
            "change_norm_gap": float(change.max()),
            "change_norm_gap_median": float(np.median(change))}


def check(rec: TrainRecord, model: Dict, mix: Dict, seed: int, device,
          limits: Dict) -> List[Dict]:
    refr = reference_steps(model, mix, seed, device)
    got = compare({"losses": rec.check_losses, "grads": rec.grad_norms,
                   "change": rec.change_norms}, refr, mix)
    return [{"name": k, "value": got[k], "limit": v["limit"]}
            for k, v in limits.items()]
