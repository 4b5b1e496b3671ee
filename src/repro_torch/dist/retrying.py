"""Reusable retry/timeout/exponential-backoff-with-jitter utility.

Every dispatch path in the multi-host stack (host launches, supervisor
re-dispatch) funnels through
:func:`retry_call`, so transient-failure policy lives in exactly one
place.  Two properties matter for the chaos harness:

* **Determinism** — the jitter stream derives from a seeded
  ``np.random.SeedSequence``, never the global RNG, so a chaos run's
  backoff schedule (and therefore its event ordering) replays exactly
  from the run seed.  Telemetry-grade randomness must not leak into
  anything bit-identity-tested.
* **Typed retry surface** — only exception types listed in
  ``RetryPolicy.retryable`` are retried; anything else passes straight
  through to the caller (a programming error must never be masked by a
  backoff loop).

Copy of ``src/repro/dist/retrying.py``: the same policy, the same
``"RTRY"``-tagged seeded jitter, so a seed gives the reference's delays.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import (Any, Callable, Iterator, Optional, Tuple, Type,
                    TypeVar)

import numpy as np

from .. import obs as _obs

T = TypeVar("T")

# SeedSequence domain tag ("RTRY") keeping retry jitter streams disjoint
# from every other seeded stream in the repo (SA chains, swap RNG, faults)
_JITTER_TAG = 0x52545259


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule + retry surface for :func:`retry_call`.

    ``attempt k`` (0-based) failing sleeps
    ``min(max_s, base_s * factor**k)`` scaled by a jitter factor drawn
    uniformly from ``[1 - jitter, 1 + jitter]``; ``deadline_s`` bounds
    the total time budget (measured on the injected clock) — a retry
    whose sleep would overrun the deadline re-raises instead of sleeping.
    """
    max_attempts: int = 3
    base_s: float = 0.1
    factor: float = 2.0
    max_s: float = 30.0
    jitter: float = 0.5
    deadline_s: Optional[float] = None
    retryable: Tuple[Type[BaseException], ...] = (OSError,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")


def backoff_delays(policy: RetryPolicy, seed: int = 0) -> Iterator[float]:
    """The policy's infinite jittered delay sequence for ``seed``.

    Exposed for tests and for callers that pace their own loop (the
    supervisor's re-dispatch path sleeps inside its poll loop rather
    than blocking in :func:`retry_call`).
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([abs(int(seed)), _JITTER_TAG]))
    k = 0
    while True:
        base = min(policy.max_s, policy.base_s * policy.factor ** k)
        scale = 1.0 + policy.jitter * (2.0 * rng.random() - 1.0)
        yield base * scale
        k += 1


def retry_call(fn: Callable[..., T], *args: Any,
               policy: RetryPolicy = RetryPolicy(),
               seed: int = 0,
               label: str = "call",
               on_retry: Optional[Callable[[int, float, BaseException],
                                           None]] = None,
               sleep: Callable[[float], None] = _time.sleep,
               clock: Callable[[], float] = _time.monotonic,
               **kwargs: Any) -> T:
    """Call ``fn(*args, **kwargs)``; retry retryable failures with
    deterministic jittered exponential backoff.

    * a **non-retryable** exception propagates immediately, untouched;
    * exhausting ``policy.max_attempts`` (or the deadline) re-raises the
      *last* retryable exception — callers keep seeing the original
      type, with the retry history in the obs counters/log;
    * ``sleep``/``clock`` are injectable so tests (and the supervisor's
      virtual pacing) never wait on the wall clock.
    """
    t0 = clock()
    delays = backoff_delays(policy, seed)
    for attempt in range(policy.max_attempts):
        try:
            return fn(*args, **kwargs)
        except policy.retryable as e:
            if attempt + 1 >= policy.max_attempts:
                raise
            delay = next(delays)
            if policy.deadline_s is not None and \
                    clock() - t0 + delay > policy.deadline_s:
                _obs.vlog("retry", f"{label}: deadline exhausted after "
                          f"{attempt + 1} attempt(s): {e}", level=2)
                raise
            _obs.metrics.counter("retry.attempts").inc()
            _obs.vlog("retry", f"{label}: attempt {attempt + 1}/"
                      f"{policy.max_attempts} failed ({e}); retrying in "
                      f"{delay:.3g}s", level=2)
            if on_retry is not None:
                on_retry(attempt, delay, e)
            sleep(delay)
    raise AssertionError("unreachable")  # loop always returns or raises
