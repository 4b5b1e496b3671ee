"""Synthetic data pipeline (copy of ``src/repro/data``)."""
