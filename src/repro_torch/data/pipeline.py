"""Deterministic synthetic token pipeline.

Copy of ``src/repro/data/pipeline.py`` (numpy only): batches bit-equal to
the reference's for the same config, step and host.

Batches are a pure function of (seed, step, host) — counter-based hashing
(no stored RNG state), so the iterator is trivially checkpointable and
restart-exact: resuming at step k yields bit-identical batches regardless of
crash history or host count changes (elastic restarts re-derive their shard
from the new topology).  A background prefetch thread keeps the host busy.

The token stream mimics packed LM training data: documents of hash-derived
lengths, EOS-separated, next-token labels, loss mask off at padding.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    eos_id: int = 0
    mean_doc_len: int = 256
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _hash_u64(x: np.ndarray, seed: int) -> np.ndarray:
    """SplitMix64 — counter-based, vectorized."""
    seed_mix = np.uint64((seed * 0x9E3779B97F4A7C15) % (1 << 64))
    z = (x.astype(np.uint64) + seed_mix) \
        + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Pure: (cfg, step) -> {"tokens", "labels", "mask"} for THIS host.

    Sequences are a noisy Markov chain: 75% of transitions follow the fixed
    affine map ``t -> (a*t + b) mod V`` and 25% jump to a hash-random token,
    with EOS document boundaries.  A model can therefore push its loss well
    below the uniform entropy floor (training tests rely on this), while
    every batch stays a pure function of (seed, step, host).
    """
    B, S = cfg.host_batch, cfg.seq_len
    V = max(2, cfg.vocab - 1)
    row0 = (step * cfg.global_batch + cfg.host_id * B)
    rows = row0 + np.arange(B, dtype=np.int64)
    cols = np.arange(S + 1, dtype=np.int64)
    grid = rows[:, None] * np.int64(1_000_003) + cols[None, :]
    rand = (_hash_u64(grid, cfg.seed) % np.uint64(V)).astype(np.int64)
    jump = (_hash_u64(grid * np.int64(104_729), cfg.seed + 3)
            % np.uint64(4)) == 0            # 25% random jumps
    bnd = (_hash_u64(grid * np.int64(7919), cfg.seed + 1)
           % np.uint64(cfg.mean_doc_len)) == 0
    a, b = 31, 17
    toks = np.empty((B, S + 1), dtype=np.int64)
    toks[:, 0] = rand[:, 0]
    for i in range(1, S + 1):
        det = (a * toks[:, i - 1] + b) % V
        toks[:, i] = np.where(jump[:, i], rand[:, i], det)
    toks = np.where(bnd, np.int64(cfg.eos_id), toks + 1)
    toks = np.minimum(toks, V).astype(np.int32)
    tokens = toks[:, :S]
    labels = toks[:, 1:S + 1]
    mask = np.ones((B, S), dtype=np.float32)
    return {"tokens": tokens, "labels": labels.astype(np.int32), "mask": mask}


def make_embeds_batch(cfg: DataConfig, step: int, d_model: int,
                      need_tokens: bool = False) -> Dict[str, np.ndarray]:
    """Frontend-stub variant: deterministic embeddings + labels."""
    base = make_batch(cfg, step)
    B, S = cfg.host_batch, cfg.seq_len
    flat = _hash_u64(
        (np.arange(B * S * 8, dtype=np.int64)
         + np.int64(step) * np.int64(B * S * 8)), cfg.seed + 2)
    u = (flat.astype(np.float64) / 2**64).astype(np.float32)
    proj = np.resize(u * 2 - 1, (B, S, d_model)) * 0.02
    out = {"embeds": proj, "labels": base["labels"], "mask": base["mask"]}
    if need_tokens:
        out["tokens"] = base["tokens"]
    return out


class Prefetcher:
    """Background thread that stays ``depth`` batches ahead."""

    def __init__(self, fn, start_step: int, depth: int = 2):
        self._fn = fn
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        try:
            while not self._stop.is_set():
                batch = self._fn(step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1
        except BaseException as e:  # noqa: BLE001 — surfaced in next()
            self._error = e

    def next(self):
        """Blocking get that re-raises worker exceptions instead of hanging."""
        while True:
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError("data pipeline worker died") \
                        from self._error
                if not self._thread.is_alive():
                    raise RuntimeError("data pipeline worker exited")

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
