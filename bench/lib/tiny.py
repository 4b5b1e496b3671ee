"""Cells cut to a size a CPU test run holds: the configurations' own
families and mixes at tiny widths, depths and lengths, for the tests
that drive the harness on the CPU (the card's runs never use these)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

BENCH = Path(__file__).resolve().parents[1]


def model(name: str) -> Dict:
    m = json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]
    m.update(n_layers=2, d_model=128, n_heads=4, n_kv=2, vocab=512,
             ssm_state=32, ssm_chunk=32, remat=False)
    return m


def mix(name: str) -> Dict:
    m = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    if m["kind"] == "serve_closed":
        m.update(max_batch=4, prompt_median=40, prompt_min=16,
                 prompt_max=96, new_median=3, new_min=2, new_max=5,
                 block=16, check_requests=12, traced_waves=[1, 2])
    else:
        m.update(batch=2, seq_len=64, traced_steps=[1, 2])
    return m
