"""Deterministic, seeded fault injection for chaos-testing the supervisor.

A chaos run is reproducible from a single seed: :func:`plan_faults`
derives, from ``(seed, n_shards, kind)``, which shard misbehaves and how
hard, and the supervisor ships the resulting :class:`FaultSpec` to the
shard child through two environment variables:

* ``REPRO_FAULT`` — ``kind[:k[:param]]``, e.g. ``kill:2`` (exit hard
  after 2 checkpoint records), ``stall:1`` (stop heartbeating after 1
  record and hang), ``corrupt:2`` (append a torn half-record to the
  checkpoint tail and die), ``slow:0.05`` (sleep 50 ms per record);
* ``REPRO_FAULT_ATTEMPT`` — the dispatch attempt number; faults fire
  only on attempt 0, so the supervisor's retry/re-shard recovery path
  gets a clean second run (the failure mode under test is the *first*
  crash, not an unrecoverable host).

``dup`` is the one supervisor-side fault: the same shard is dispatched
twice into separate attempt checkpoints, exercising the last-wins merge
and the conflict detector (identical records are the only correct
outcome — the per-task seed gate makes both attempts compute the same
numbers).

The hooks install inside the dedicated shard-child process only
(class-level wrappers on ``ResumableSweep``), never in the parent or the
library import path.

Copy of ``src/repro/dist/faults.py``: the same kinds, exit code, env
names and ``"FALT"``-tagged seeded plan, so a seed picks the reference's
victim; the hooks wrap the port's ``ResumableSweep``.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

FAULT_ENV = "REPRO_FAULT"
FAULT_ATTEMPT_ENV = "REPRO_FAULT_ATTEMPT"

# child exit code for an injected crash — distinguishable from real
# failures (tracebacks exit 1) in supervisor logs and CI artifacts
FAULT_EXIT_CODE = 73

# every injectable fault class; "dup" is handled by the supervisor
# (duplicate dispatch), the rest by the shard-child hooks below
FAULT_KINDS = ("kill", "stall", "corrupt", "dup", "slow")

# SeedSequence domain tag ("FALT") — disjoint from SA/task/retry streams
_FAULT_TAG = 0x46414C54


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault: ``kind`` + after-how-many-records ``k`` +
    optional float ``param`` (per-record sleep for ``slow``)."""
    kind: str
    k: int = 1
    param: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")

    def encode(self) -> str:
        return f"{self.kind}:{self.k}:{self.param:g}"

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        """``kind[:k[:param]]`` — the CLI / env grammar."""
        parts = spec.split(":")
        kind = parts[0]
        k = int(parts[1]) if len(parts) > 1 and parts[1] else 1
        param = float(parts[2]) if len(parts) > 2 and parts[2] else 0.0
        if kind == "slow" and param == 0.0:
            param = 0.05
        return cls(kind=kind, k=k, param=param)


def plan_faults(seed: int, n_shards: int, kind: str,
                k: Optional[int] = None) -> Dict[int, FaultSpec]:
    """Deterministically pick the victim shard (and ``k``) for ``kind``.

    One seeded draw decides which of the ``n_shards`` first-generation
    shards misbehaves and after how many completed records, so a chaos
    matrix re-run with the same seed replays the identical failure.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([abs(int(seed)), _FAULT_TAG]))
    victim = int(rng.integers(0, max(1, n_shards)))
    kk = int(rng.integers(1, 3)) if k is None else int(k)
    spec = FaultSpec(kind=kind, k=kk,
                     param=0.05 if kind == "slow" else 0.0)
    return {victim: spec}


def env_for(spec: Optional[FaultSpec], attempt: int) -> Dict[str, str]:
    """The environment overrides a host launch ships to the child."""
    env = {FAULT_ATTEMPT_ENV: str(int(attempt))}
    if spec is not None:
        env[FAULT_ENV] = spec.encode()
    return env


def _active_spec() -> Optional[FaultSpec]:
    raw = os.environ.get(FAULT_ENV)
    if not raw:
        return None
    if os.environ.get(FAULT_ATTEMPT_ENV, "0") != "0":
        return None                 # faults fire on the first attempt only
    return FaultSpec.parse(raw)


def install_fault_hooks() -> Optional[FaultSpec]:
    """Arm the planned fault inside the shard-child process.

    Wraps ``ResumableSweep.add``/``heartbeat`` at class level — safe
    because the shard child is a dedicated process whose only sweep is
    its own shard checkpoint.  Returns the armed spec (None = clean run).
    """
    spec = _active_spec()
    if spec is None or spec.kind == "dup":
        return None
    from ..core.explore import ResumableSweep

    state = {"records": 0, "fired": False}
    real_add = ResumableSweep.add
    real_hb = ResumableSweep.heartbeat

    def add(self, key, record):
        if spec.kind == "slow":
            time.sleep(spec.param)
            return real_add(self, key, record)
        if state["fired"]:
            return real_add(self, key, record)
        real_add(self, key, record)
        state["records"] += 1
        if state["records"] < spec.k:
            return
        state["fired"] = True
        if spec.kind == "kill":
            sys.stderr.write(f"[fault] kill after {spec.k} record(s)\n")
            sys.stderr.flush()
            os._exit(FAULT_EXIT_CODE)
        if spec.kind == "corrupt":
            # torn half-record with NO trailing newline: the classic
            # killed-mid-write tail every resume/merge path must drop
            sys.stderr.write(f"[fault] corrupt tail after {spec.k} "
                             "record(s)\n")
            sys.stderr.flush()
            corrupt_tail(self.path)
            os._exit(FAULT_EXIT_CODE)
        if spec.kind == "stall":
            sys.stderr.write(f"[fault] heartbeat stall after {spec.k} "
                             "record(s)\n")
            sys.stderr.flush()
            time.sleep(3600.0)      # hang until the supervisor kills us

    def heartbeat(self, payload):
        if spec.kind == "stall" and state["fired"]:
            return                  # liveness silenced, work "continues"
        return real_hb(self, payload)

    ResumableSweep.add = add
    ResumableSweep.heartbeat = heartbeat
    return spec


def corrupt_tail(path, fragment: str = '{"_key": "torn-by-fault", "ener'
                 ) -> None:
    """Append a torn, newline-less half-record — the truncated-tail
    injector the durability tests and the ``corrupt`` fault share."""
    with open(path, "a") as f:
        f.write(fragment)
        f.flush()
        os.fsync(f.fileno())
