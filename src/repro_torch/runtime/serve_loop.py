"""Batched serving loop: wave-style batching.

Port of ``src/repro/runtime/serve_loop.py``.  Requests queue up; the
server packs up to ``max_batch`` of them into a wave, left-pads to a
common length, prefills once, then decodes until every slot hits EOS or
its token budget.  Finished slots are masked out (their tokens ignored).

:class:`RequestQueue` (admission, FIFO, enqueue timestamps) and
:class:`ModelWaveExecutor` (the model behind the structural
:class:`repro_torch.serve.harness.WaveExecutor` protocol, reporting a
measured :class:`~repro_torch.serve.harness.WaveCost` per wave) are the
transport-agnostic pieces; :class:`Server` is the shim over both that
``examples/serve_lm.py`` uses.  The model runs on the device of its
parameters; a wave's wall times end in a synchronize of that device.

Timing contract: ``Result.latency_s`` is the **per-request** queueing +
service time ``finish_t - enqueue_t``.  Slots in the same wave finish at
different decode steps, so latencies differ across a mixed-length wave.

As in the reference, ``init_cache(B, max_seq, cache_len)`` hands
``cache_len`` to the model as the encoder length, which a decoder-only
model ignores: its KV cache holds ``max_seq`` positions.  The
encoder-decoder's prefill replaces those ``cache_len`` frames with the
encoder states of the wave's own (B, L, d) frame embeddings (zeros, as
the reference's loop gives them).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import model_api
from ..serve.harness import WaveCost

# Decode-phase KV-cache length cap (see the module docstring: a decoder
# LM ignores it).
DEFAULT_DECODE_CACHE_LEN = 1500


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new: int = 32
    enqueue_t: float = 0.0        # stamped by RequestQueue.submit if unset


@dataclass
class Result:
    rid: int
    tokens: np.ndarray
    latency_s: float              # finish_t - enqueue_t, per request
    enqueue_t: float = 0.0
    start_t: float = 0.0          # wave admission (prefill launch)
    finish_t: float = 0.0         # this slot's last token, not wave end


class RequestQueue:
    """Transport-agnostic FIFO admission queue.

    Stamps ``enqueue_t`` at submit time (wall clock) unless the request
    already carries one (trace replay pre-stamps virtual arrival times).
    """

    def __init__(self) -> None:
        self._q: List[Request] = []

    def submit(self, req: Request) -> None:
        if req.enqueue_t == 0.0:
            req.enqueue_t = time.time()
        self._q.append(req)

    def next_wave(self, max_batch: int) -> List[Request]:
        wave, self._q = self._q[:max_batch], self._q[max_batch:]
        return wave

    def __len__(self) -> int:
        return len(self._q)

    @property
    def pending(self) -> Sequence[Request]:
        return tuple(self._q)


class ModelWaveExecutor:
    """Real-model serving backend: one prefill + a greedy decode loop.

    Satisfies the ``WaveExecutor`` protocol: ``execute(wave)`` accepts
    requests (prompt tokens given, from ``prompt_fn``, or synthesized
    deterministically from the rid) and returns a measured
    :class:`WaveCost`, wall-clock prefill and per-decode-step durations
    with per-slot token counts.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_seq: int = 512, eos_id: int = 0,
                 cache_len: Optional[int] = None,
                 prompt_fn: Optional[Callable[[object], np.ndarray]] = None):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.cache_len = min(max_seq, cache_len or DEFAULT_DECODE_CACHE_LEN)
        self.prompt_fn = prompt_fn
        self.api = model_api(cfg)
        self.device = next(params.parameters()).device

    # -- prompt materialization --------------------------------------
    def _prompt_of(self, req) -> np.ndarray:
        if getattr(req, "prompt", None) is not None:
            return np.asarray(req.prompt, np.int32)
        if self.prompt_fn is not None:
            return np.asarray(self.prompt_fn(req), np.int32)
        # Deterministic synthetic prompt from the rid (trace replay).
        rng = np.random.Generator(np.random.Philox(
            np.random.SeedSequence([0x544F4B53, int(req.rid)])))
        n = max(1, int(getattr(req, "prompt_len", 1)))
        vocab = int(self.cfg.vocab)
        return rng.integers(1, max(2, vocab), size=n, dtype=np.int64) \
                  .astype(np.int32)

    def _pad_wave(self, prompts: List[np.ndarray]) -> np.ndarray:
        L = max(len(p) for p in prompts)
        toks = np.full((len(prompts), L), self.eos_id, np.int32)
        for i, p in enumerate(prompts):
            toks[i, L - len(p):] = p                   # left-pad
        return toks

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- core wave execution -----------------------------------------
    def run_wave(self, wave: Sequence[object]
                 ) -> Tuple[np.ndarray, np.ndarray, WaveCost]:
        """Execute one wave; returns (out_tokens, n_tokens, cost).

        ``out_tokens`` is (B, max_budget) with finished slots masked
        (budget-exceeding steps are never written)."""
        prompts = [self._prompt_of(r) for r in wave]
        budgets = np.array([int(r.max_new) for r in wave], np.int32)
        toks = self._pad_wave(prompts)
        B, L = toks.shape
        t0 = time.time()
        cache = self.api.init_cache(B, self.max_seq, self.cache_len,
                                    device=self.device)
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if self.cfg.frontend in ("patch", "audio"):
            batch["embeds"] = torch.zeros((B, L, self.cfg.d_model),
                                          dtype=torch.bfloat16,
                                          device=self.device)
        logits, cache = self.api.prefill(self.params, batch, cache)
        cur = logits.argmax(dim=-1).to(torch.int32)[:, None]
        self._sync()
        prefill_s = time.time() - t0
        max_new = int(budgets.max())
        out = np.full((B, max_new), self.eos_id, np.int32)
        done = np.zeros((B,), bool)
        ntok = np.zeros((B,), np.int32)
        step_s: List[float] = []
        for t in range(max_new):
            tok = cur[:, 0].cpu().numpy()
            live = ~done
            out[live, t] = tok[live]
            ntok[live] += 1
            done |= tok == self.eos_id
            done |= (t + 1) >= budgets
            if done.all():
                break
            ts = time.time()
            logits, cache = self.api.decode_step(self.params, cur, cache)
            cur = logits.argmax(dim=-1).to(torch.int32)[:, None]
            self._sync()
            step_s.append(time.time() - ts)
        cost = WaveCost(prefill_s=prefill_s, step_s=step_s,
                        slot_tokens=[int(n) for n in ntok],
                        tokens=[out[i, :ntok[i]] for i in range(B)])
        return out, ntok, cost

    def execute(self, wave: Sequence[object]) -> WaveCost:
        """WaveExecutor protocol entry point (harness replay)."""
        _, _, cost = self.run_wave(wave)
        return cost


class Server:
    """Compat shim: RequestQueue + ModelWaveExecutor behind the old API."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_seq: int = 512, eos_id: int = 0, greedy: bool = True,
                 cache_len: Optional[int] = None):
        del greedy                       # argmax decode is the only policy
        self.executor = ModelWaveExecutor(
            cfg, params, max_batch=max_batch, max_seq=max_seq,
            eos_id=eos_id, cache_len=cache_len)
        self.queue = RequestQueue()

    # Old surface, delegated.
    cfg = property(lambda self: self.executor.cfg)
    params = property(lambda self: self.executor.params)
    max_batch = property(lambda self: self.executor.max_batch)
    max_seq = property(lambda self: self.executor.max_seq)
    eos_id = property(lambda self: self.executor.eos_id)
    api = property(lambda self: self.executor.api)

    def submit(self, req: Request) -> None:
        self.queue.submit(req)

    def step(self) -> List[Result]:
        """Serve one wave; returns completed results (possibly empty)."""
        if not len(self.queue):
            return []
        wave = self.queue.next_wave(self.executor.max_batch)
        start_t = time.time()
        out, ntok, cost = self.executor.run_wave(wave)
        first = start_t + cost.prefill_s
        cum = np.concatenate([[0.0], np.cumsum(cost.step_s)])
        results = []
        for i, r in enumerate(wave):
            seq = out[i, :ntok[i]]
            stop = np.nonzero(seq == self.eos_id)[0]
            if len(stop):
                seq = seq[:stop[0] + 1]
            fin = first + float(cum[min(ntok[i] - 1, len(cost.step_s))])
            results.append(Result(
                rid=r.rid, tokens=seq, latency_s=fin - r.enqueue_t,
                enqueue_t=r.enqueue_t, start_t=start_t, finish_t=fin))
        return results

    def run_until_empty(self) -> List[Result]:
        results = []
        while len(self.queue):
            results.extend(self.step())
        return results
