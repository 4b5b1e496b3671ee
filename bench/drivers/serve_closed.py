"""Serving in a closed loop: ``max_batch`` clients, each sending its next
request when its last one is answered, and the program's wave server
(``repro_torch.runtime.serve_loop.ModelWaveExecutor``) taking them in
waves of ``max_batch``: prefill, then greedy decode through the cache.

The window calls ``execute(wave)`` wave after wave until ``--seconds``
have passed; it spans from its start to the end of its last wave.  A
request is submitted at its wave's start (its client's previous request
ended with the previous wave) and its first token is on the host when
the wave's first decode step is called; both stamps are the harness's
own clock.  A request that comes back with no token counts as failed.

The check (after the window, the program's state freed): a sample of the
finished requests drawn from the seed, the one with the longest prompt
among them, is run through the plain reference once each, over the row
the wave gave the model (the prompt left-padded with ``eos_id`` to the
wave's longest, as the wave server pads) and the served tokens.  The
number compared is the widest gap by which a served token's logit lies
below the reference's best at its position.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.lib.program import load_model
from bench.lib.trace import Tracer
from bench.lib.traffic import ServeStream, seed_words
from bench.reference import lm as ref
from bench.reference.weights import make_weights

# the program's CUDA sources the serve path launches
SOURCES = ("flash_attention", "mamba_ssd", "ssd_state")


@dataclass
class Wave:
    rids: List[int]
    prompt_lens: List[int]
    padded_len: int
    new_tokens: List[int]          # tokens each request was served
    t_submit: float
    t_first: float
    t_end: float
    prefill_s: float               # the program's own span
    step_s: List[float]            # the program's own spans
    traced: bool = False


@dataclass
class ServeRecord:
    waves: List[Wave] = field(default_factory=list)
    served: Dict[int, np.ndarray] = field(default_factory=dict)
    prompts: Dict[int, np.ndarray] = field(default_factory=dict)
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    trace: Optional[object] = None


class Stamps:
    """The program's API with the host-clock time of each decode step's
    call recorded, and prefill and decode annotated while tracing."""

    def __init__(self, api, tracer: Tracer):
        self.calls: List[float] = []

        def prefill(*a, **k):
            with tracer.note("bench.prefill"):
                return api.prefill(*a, **k)

        def decode_step(*a, **k):
            self.calls.append(time.perf_counter())
            with tracer.note("bench.decode"):
                return api.decode_step(*a, **k)

        self.api = dataclasses.replace(api, prefill=prefill,
                                       decode_step=decode_step)


def setup(model: Dict, mix: Dict, seed: int, device) -> Dict:
    from repro_torch.kernels import _build
    from repro_torch.runtime.serve_loop import ModelWaveExecutor, Request
    if device.type == "cuda":
        _build.build(SOURCES)
    cfg, params = load_model(model, seed, device)
    B = int(mix["max_batch"])
    max_seq = int(mix["prompt_max"]) + int(mix["new_max"])
    ex = ModelWaveExecutor(cfg, params, max_batch=B, max_seq=max_seq,
                           eos_id=int(mix["eos_id"]))
    # warm-up: one wave at the longest prompt, a prefill and two decodes
    rng = np.random.default_rng(seed_words(seed, 9))
    warm = [Request(rid=-1 - i, prompt=rng.integers(
        1, int(model["vocab"]), int(mix["prompt_max"])).astype(np.int32),
        max_new=3) for i in range(B)]
    ex.execute(warm)
    return {"ex": ex, "params": params, "model": model, "mix": mix,
            "seed": seed, "device": device}


def window(state: Dict, seconds: float, trace_path: Optional[Path]
           ) -> ServeRecord:
    """Waves until ``seconds`` have passed.  With ``trace_path``, the
    waves ``traced_waves = [first, end)`` of the mix run under the
    profiler, whose trace is written and read once the window is over."""
    from repro_torch.runtime.serve_loop import Request
    ex, mix, model = state["ex"], state["mix"], state["model"]
    stream = ServeStream(mix, int(model["vocab"]), state["seed"])
    tracer = Tracer()
    base_api = ex.api
    stamps = Stamps(base_api, tracer)
    ex.api = stamps.api
    B = int(mix["max_batch"])
    lo, hi = (int(i) for i in mix["traced_waves"])
    rec = ServeRecord()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        reqs = stream.take(B)
        if trace_path is not None and i == lo:
            tracer.start()
        stamps.calls.clear()
        t_sub = time.perf_counter()
        cost = ex.execute([Request(rid=r.rid, prompt=r.prompt,
                                   max_new=r.max_new) for r in reqs])
        t_end = time.perf_counter()
        rec.attempted += len(reqs)
        lens = [len(r.prompt) for r in reqs]
        for r, toks in zip(reqs, cost.tokens):
            rec.served[r.rid] = np.asarray(toks, np.int64)
            rec.prompts[r.rid] = r.prompt
            rec.failed += int(len(toks) == 0)
        rec.waves.append(Wave(
            rids=[r.rid for r in reqs], prompt_lens=lens,
            padded_len=max(lens), new_tokens=list(cost.slot_tokens),
            t_submit=t_sub,
            t_first=stamps.calls[0] if stamps.calls else t_end,
            t_end=t_end, prefill_s=cost.prefill_s, step_s=list(cost.step_s),
            traced=tracer.on))
        i += 1
        if i == hi:
            tracer.stop()
    rec.window_s = rec.waves[-1].t_end - t0 if rec.waves else 0.0
    tracer.stop()
    ex.api = base_api
    if trace_path is not None:
        rec.trace = tracer.read(trace_path)
    return rec


def release(state: Dict) -> None:
    state.clear()


def sample(rec: ServeRecord, mix: Dict, seed: int) -> List[int]:
    """The rids checked: the longest prompt, then others drawn from the
    seed, ``check_requests`` in all."""
    rids = sorted(rec.served)
    longest = max(rids, key=lambda r: (len(rec.prompts[r]), -r))
    rest = [r for r in rids if r != longest]
    rng = np.random.default_rng(seed_words(seed, 11))
    k = min(len(rest), int(mix["check_requests"]) - 1)
    pick = rng.choice(len(rest), size=k, replace=False) if k > 0 else []
    return [longest] + [rest[j] for j in sorted(pick)]


def check_rows(rec: ServeRecord, rids: List[int], mix: Dict):
    """(row tokens, position of the first served token, served tokens) of
    each of ``rids``, the row as its wave handed it to the model."""
    pad_of = {}
    for w in rec.waves:
        for r in w.rids:
            pad_of[r] = w.padded_len
    eos = int(mix["eos_id"])
    for r in rids:
        prompt, toks = rec.prompts[r], rec.served[r]
        L = pad_of[r]
        row = np.concatenate([np.full(L - len(prompt), eos, np.int64),
                              prompt.astype(np.int64), toks[:-1]])
        yield row, L - 1, toks


def logit_gaps(W, model: Dict, row: np.ndarray, first: int,
               toks: np.ndarray, device, choose=None) -> np.ndarray:
    """The reference's best logit minus its logit of each served token
    (or, with ``choose``, of the token that ``choose``'s logits put
    first) at the positions that produced them."""
    t = torch.as_tensor(row, device=device)[None]
    with torch.no_grad(), ref.f32_exact():
        h = ref.hidden(W, model, t)[0, first:first + len(toks)]
        lg = ref.logits(W, h)
        if choose is not None:
            hc = ref.hidden(W, model, t, mm=choose)[0, first:first + len(toks)]
            pick = ref.logits(W, hc, mm=choose).argmax(-1)
        else:
            pick = torch.as_tensor(toks, device=device)
        gap = lg.max(-1).values - lg.gather(-1, pick[:, None])[:, 0]
    return gap.double().cpu().numpy()


def check(rec: ServeRecord, model: Dict, mix: Dict, seed: int, device,
          limits: Dict) -> List[Dict]:
    if not rec.served:
        return [{"name": "logit_gap", "value": None,
                 "limit": limits["logit_gap"]["limit"]}]
    W = make_weights(model, seed, device)
    widest = max(float(logit_gaps(W, model, row, first, toks, device).max())
                 for row, first, toks in check_rows(
                     rec, sample(rec, mix, seed), mix))
    del W
    return [{"name": "logit_gap", "value": widest,
             "limit": limits["logit_gap"]["limit"]}]
