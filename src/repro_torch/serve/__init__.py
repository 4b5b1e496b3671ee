"""Serving substrate (port of ``src/repro/serve``, reduced to what the
serve loop names; traces, replay and SLO reports come with slice 4b)."""

from .harness import WaveCost, WaveExecutor

__all__ = ["WaveCost", "WaveExecutor"]
