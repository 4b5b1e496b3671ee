"""Reduced copies of the JAX package's numpy core (workload IR, hardware
template, mapping encoding, checkpoint I/O, the LMS -> plan bridge, and
the cost model's scalar engine: intra-core search, analyzer, evaluator)."""
