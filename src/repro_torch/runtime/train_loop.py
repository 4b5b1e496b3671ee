"""Fault-tolerant training loop.

Port of ``src/repro/runtime/train_loop.py``.  Composes the synthetic data
pipeline (+prefetch), the train step (:func:`repro_torch.launch.steps.
make_train_step`), the checkpoint manager (atomic, keep-K, async) and the
straggler watchdog (step-time EWMA; slow steps are logged and counted),
with crash recovery: on start the loop restores the latest checkpoint and
the data pipeline resumes bit-exactly (batches are a pure function of
step).  Log lines, the resume rule and the returned dict are the
reference's.

A step's time, which the watchdog and the log read, is the host duration
of the step function's kept ``train.step`` span
(:func:`repro_torch.obs.kept_span`, ``perf_counter``).  On a card that
is the time to issue the step, which the launch queue holds near the
device's for a step of thousands of kernels; the loss's copy to the
host, which waits for the rest, lies outside it.

The loop runs on one explicit ``device`` (default the card; a CUDA device
with no card raises) with no mesh.  Parameters come from the port's
``init_params`` with ``torch.Generator(device).manual_seed(tcfg.seed)``,
so the port's numbers differ from the reference's, whose ``PRNGKey``
draws others.  The step takes the plain routes: the kernels have no
backward.  ``TrainConfig.ckpt_dir`` defaults to a directory relative to
the working directory.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import obs
from ..checkpoint.ckpt import CheckpointManager
from ..configs.base import ModelConfig
from ..data.pipeline import (DataConfig, Prefetcher, make_batch,
                             make_embeds_batch)
from ..launch.steps import (load_state_tree, make_train_step, state_tree,
                            to_device, train_state)
from ..models import model_api
from ..optim.adamw import AdamWConfig
from ..realize.program import resolve_device


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "results/train_ckpt"
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0
    async_ckpt: bool = True
    opt: AdamWConfig = field(default_factory=AdamWConfig)


@dataclass
class StragglerWatchdog:
    """EWMA step-time monitor (straggler mitigation hook)."""
    factor: float = 3.0
    alpha: float = 0.2
    ewma: Optional[float] = None
    slow_steps: int = 0

    def observe(self, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.slow_steps += 1
        # don't poison the EWMA with outliers
        self.ewma = dt if self.ewma is None else (
            self.ewma if slow else
            (1 - self.alpha) * self.ewma + self.alpha * dt)
        return slow


class Trainer:
    def __init__(self, cfg: ModelConfig, data: DataConfig, tcfg: TrainConfig,
                 device="cuda"):
        self.cfg = cfg
        self.data = data
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.api = model_api(cfg)
        self.mgr = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep,
                                     async_write=tcfg.async_ckpt)
        self.watchdog = StragglerWatchdog(factor=tcfg.straggler_factor)
        self.metrics_log: list = []
        self.step_fn = make_train_step(cfg, tcfg.opt)

    def init_state(self) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        return train_state(self.api.init_params(gen, self.device))

    def _batch_fn(self, step: int) -> Dict[str, np.ndarray]:
        if self.cfg.frontend in ("patch", "audio"):
            return make_embeds_batch(self.data, step, self.cfg.d_model,
                                     need_tokens=self.cfg.family == "encdec")
        return make_batch(self.data, step)

    def run(self, resume: bool = True) -> Dict[str, Any]:
        state = self.init_state()
        start = 0
        if resume:
            restored, start = self.mgr.restore_latest(state_tree(state))
            if restored is not None:
                load_state_tree(state, restored)
                print(f"[trainer] resumed from step {start}")
        pf = Prefetcher(self._batch_fn, start_step=start, depth=2)
        losses = []
        try:
            for step in range(start, self.tcfg.steps):
                _, batch = pf.next()
                state, metrics = self.step_fn(
                    state, to_device(batch, self.device))
                loss = float(metrics["loss"])
                dt = obs.last_kept("train.step").host_s
                slow = self.watchdog.observe(dt)
                losses.append(loss)
                if slow:
                    print(f"[watchdog] step {step} took {dt:.2f}s "
                          f"(ewma {self.watchdog.ewma:.2f}s) — straggler")
                if step % self.tcfg.log_every == 0:
                    rec = {"step": step, "loss": loss, "dt": dt,
                           "grad_norm": float(metrics["grad_norm"]),
                           "lr": float(metrics["lr"])}
                    self.metrics_log.append(rec)
                    print(f"[trainer] {json.dumps(rec)}", flush=True)
                if (step + 1) % self.tcfg.ckpt_every == 0 \
                        or step + 1 == self.tcfg.steps:
                    self.mgr.save(state_tree(state), step + 1)
            self.mgr.wait()
        finally:
            pf.close()
        return {"state": state, "losses": losses,
                "slow_steps": self.watchdog.slow_steps,
                "final_step": self.tcfg.steps}
