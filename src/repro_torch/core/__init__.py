"""Reduced copies of the JAX package's numpy core (workload IR, hardware
template, mapping encoding, checkpoint I/O and the LMS -> plan bridge)."""
