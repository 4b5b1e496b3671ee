"""What one served wave cost, and the protocol of a serving backend.

Reduced copy of ``src/repro/serve/harness.py``: ``WaveCost`` and the
``WaveExecutor`` protocol, which ``runtime/serve_loop.py`` implements.
The traffic-replay harness itself (traces, the analytical service model,
SLO reports, saturation sweeps) comes with slice 4b of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np


@dataclass
class WaveCost:
    """What one wave execution cost, in the executor's time base.

    ``prefill_s`` covers prompt ingestion for every slot; each slot's
    first token is available at ``start + prefill_s`` (greedy decode
    emits it from the prefill logits).  ``step_s[t]`` is the duration of
    the wave's ``t``-th decode step; ``slot_tokens[i]`` is how many
    tokens slot ``i`` actually produced (1 from prefill + one per decode
    step it was active in), so slot ``i`` finishes at
    ``start + prefill_s + sum(step_s[:slot_tokens[i] - 1])``.
    """
    prefill_s: float
    step_s: List[float]
    slot_tokens: List[int]
    tokens: Optional[List[np.ndarray]] = None     # real ids, if executed

    @property
    def total_s(self) -> float:
        return self.prefill_s + float(sum(self.step_s))


@runtime_checkable
class WaveExecutor(Protocol):
    """Transport-agnostic serving backend: execute one wave, report cost.

    ``runtime.serve_loop.ModelWaveExecutor`` (the model, measured wall
    clock) satisfies it."""
    max_batch: int

    def execute(self, wave: Sequence[object]) -> WaveCost: ...
