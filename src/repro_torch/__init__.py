"""PyTorch/CUDA port of the Gemini realization loop for one NVIDIA H100.

A keep_mappings DSE checkpoint is lowered into a stage plan
(:mod:`.realize.plan`), built into per-stage programs
(:mod:`.realize.program`) whose GEMMs, attention pairs and SSD layers run
through hand-written CUDA kernels (:mod:`.kernels`), executed on the card,
measured against the analytical cost model's prediction
(:mod:`.realize.measure`, :mod:`.core.evaluator`), and fed back as a Tech
overlay (:mod:`.realize.calibrate`).  ``python -m repro_torch.launch.realize``
drives the loop.

The package imports ``torch`` and ``numpy`` only.  Where it needs a numpy
module of the JAX package it keeps its own reduced copy under the same
relative path, and each copy names the file it came from.
"""
