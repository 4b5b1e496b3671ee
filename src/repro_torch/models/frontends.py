"""Modality frontend stubs: the [vlm] and [audio] configs specify the
transformer backbone only, and the batch provides precomputed frame or
patch embeddings.  These helpers fabricate deterministic embeddings shaped
like a real frontend's output.

Port of ``src/repro/models/frontends.py``, with a ``torch.Generator`` in
place of a ``jax.random`` key."""

from __future__ import annotations

import torch


def fake_patch_embeddings(generator: torch.Generator, batch: int, seq: int,
                          d_model: int, device=None) -> torch.Tensor:
    """Stands in for the LLaVA-NeXT anyres vision tower + projector."""
    return torch.randn((batch, seq, d_model), generator=generator,
                       device=device) * 0.02


def fake_audio_frames(generator: torch.Generator, batch: int, frames: int,
                      d_model: int, device=None) -> torch.Tensor:
    """Stands in for whisper's log-mel + conv1d stem (stride-2 conv)."""
    return torch.randn((batch, frames, d_model), generator=generator,
                       device=device) * 0.02
