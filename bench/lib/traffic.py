"""The one generator of traffic: it reads a mix's parameters (a file
``bench/traffic/<name>.json``) and makes its requests or batches from
``--seed``.

Two shapes of mix:

- ``serve_closed``: requests of a closed loop.  Prompt lengths and new
  tokens are each log-normal (``<x>_median``, ``<x>_sigma``), rounded and
  held to ``[<x>_min, <x>_max]``, drawn stratified: each block of
  ``block`` consecutive requests holds the ``block`` quantile midpoints of
  each distribution once, the two in independent orders set by the seed,
  so every seed serves the same set of sizes in another order while the
  make-up of each wave varies.  Token ids are uniform over ``[1, vocab)``.
- ``train_packed``: batches of packed synthetic documents, a copy of the
  program's own stream (``repro_torch/data/pipeline.py::make_batch``):
  a noisy affine Markov chain with EOS-separated documents of mean length
  ``mean_doc_len``, next-token labels; every row of every step differs.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

import numpy as np

SEED_MASK = (1 << 63) - 1


def seed_words(seed: int, *tag: int) -> List[int]:
    """Non-negative words for ``np.random.SeedSequence``."""
    return [int(seed) & SEED_MASK, *tag]


@dataclass(frozen=True)
class ServeRequest:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new: int


def lognormal_quantiles(median: float, sigma: float, n: int) -> np.ndarray:
    """The ``n`` quantile midpoints of the log-normal distribution with
    this median and log-space standard deviation, ascending."""
    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    return float(median) * np.exp(float(sigma) * np.asarray(z))


def stratified_sizes(mix: Dict, key: str, n: int) -> np.ndarray:
    """The ``n`` stratified draws of ``key`` (``prompt`` or ``new``),
    rounded to whole tokens and held to the mix's range."""
    q = lognormal_quantiles(mix[key + "_median"], mix[key + "_sigma"], n)
    return np.clip(np.rint(q), mix[key + "_min"], mix[key + "_max"]
                   ).astype(np.int64)


class ServeStream:
    """The requests of a ``serve_closed`` mix, in order, from ``seed``."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, int(vocab), int(seed)
        blk = int(mix["block"])
        self.lengths = stratified_sizes(mix, "prompt", blk)
        self.news = stratified_sizes(mix, "new", blk)
        self._next = 0

    def sizes(self, rid: int) -> tuple:
        """(prompt length, new tokens) of request ``rid``."""
        blk = len(self.lengths)
        rng = np.random.default_rng(seed_words(self.seed, 1, rid // blk))
        j = rid % blk
        order_len, order_new = rng.permutation(blk), rng.permutation(blk)
        return int(self.lengths[order_len[j]]), int(self.news[order_new[j]])

    def request(self, rid: int) -> ServeRequest:
        n, new = self.sizes(rid)
        rng = np.random.default_rng(seed_words(self.seed, 2, rid))
        prompt = rng.integers(1, self.vocab, size=n, dtype=np.int64)
        return ServeRequest(rid, prompt.astype(np.int32), new)

    def take(self, k: int) -> List[ServeRequest]:
        out = [self.request(self._next + i) for i in range(k)]
        self._next += k
        return out


# ---------------------------------------------------------------------------
# train_packed: a copy of repro_torch/data/pipeline.py's make_batch
# ---------------------------------------------------------------------------

def _hash_u64(x: np.ndarray, seed: int) -> np.ndarray:
    """SplitMix64, counter-based, vectorized."""
    seed_mix = np.uint64((seed * 0x9E3779B97F4A7C15) % (1 << 64))
    z = (x.astype(np.uint64) + seed_mix) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def packed_batch(mix: Dict, vocab: int, seed: int, step: int
                 ) -> Dict[str, np.ndarray]:
    """{"tokens", "labels", "mask"} of step ``step``: ``batch`` rows of
    ``seq_len`` tokens."""
    B, S = int(mix["batch"]), int(mix["seq_len"])
    eos, mean_doc = int(mix["eos_id"]), int(mix["mean_doc_len"])
    seed = int(seed) & SEED_MASK
    V = max(2, int(vocab) - 1)
    rows = step * B + np.arange(B, dtype=np.int64)
    cols = np.arange(S + 1, dtype=np.int64)
    grid = rows[:, None] * np.int64(1_000_003) + cols[None, :]
    rand = (_hash_u64(grid, seed) % np.uint64(V)).astype(np.int64)
    jump = (_hash_u64(grid * np.int64(104_729), seed + 3)
            % np.uint64(4)) == 0            # 25% random jumps
    bnd = (_hash_u64(grid * np.int64(7919), seed + 1)
           % np.uint64(mean_doc)) == 0
    a, b = 31, 17
    toks = np.empty((B, S + 1), dtype=np.int64)
    toks[:, 0] = rand[:, 0]
    for i in range(1, S + 1):
        det = (a * toks[:, i - 1] + b) % V
        toks[:, i] = np.where(jump[:, i], rand[:, i], det)
    toks = np.where(bnd, np.int64(eos), toks + 1)
    toks = np.minimum(toks, V).astype(np.int32)
    return {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1].copy(),
            "mask": np.ones((B, S), dtype=np.float32)}
