"""Optimizer (port of ``src/repro/optim``): AdamW."""
