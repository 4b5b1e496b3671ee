"""Fault-tolerant multi-host sweep orchestration.

Layers, bottom up:

* :mod:`repro_torch.dist.retrying` — the reusable retry/timeout/
  exponential-backoff-with-jitter utility every dispatch path goes
  through (deterministic under a seeded RNG, so chaos runs replay
  exactly);
* :mod:`repro_torch.dist.hosts` — the :class:`Host` launch protocol with
  a :class:`LocalProcessHost` (subprocess ``--shard`` children) and a
  :class:`ShellCommandHost` (SSH/SLURM-style ``{cmd}`` templates);
* :mod:`repro_torch.dist.faults` — the deterministic, seeded
  fault-injection harness (kill-after-k, heartbeat stall, corrupt
  checkpoint tail, duplicate dispatch, slow-host skew) hooked into the
  shard child via environment variables;
* :mod:`repro_torch.dist.supervisor` — the sweep supervisor proper:
  dispatch the shard set, poll shard checkpoints' ``_hb`` heartbeat lines
  for liveness, declare hosts dead after a missed-heartbeat deadline,
  re-shard a dead host's *remaining* tasks onto live hosts, merge with a
  fingerprint assertion, all while journaling its own state to an
  append-only resumable JSONL;
* :mod:`repro_torch.dist.shard_child` — the ``python -m`` entry point a
  host launches for one shard.

The CLI front end is ``python -m repro_torch.launch.sweep_ctl``
(launch / status / resume / merge).  The headline invariant, enforced by
the chaos tests: under every injected fault class the supervised sweep's
merged checkpoint is bit-identical to a failure-free unsharded run of the
same grid and seed.

Copy of ``src/repro/dist/``, numpy and the standard library only: the
supervisor and its numpy shard children import no torch.  A spec whose
SA scores on ``backend="fused"`` makes each child run the ``fused_eval``
kernel on the card; the kernel sums each row in a fixed order, so its
records are as reproducible as the numpy engine's.
"""

from .faults import FaultSpec, plan_faults
from .hosts import Host, LocalProcessHost, ShellCommandHost
from .retrying import RetryPolicy, retry_call
from .supervisor import (ShardJob, Supervisor, SupervisorError, SweepSpec,
                         quick_spec)

__all__ = [
    "FaultSpec", "plan_faults",
    "Host", "LocalProcessHost", "ShellCommandHost",
    "RetryPolicy", "retry_call",
    "ShardJob", "Supervisor", "SupervisorError", "SweepSpec", "quick_spec",
]
