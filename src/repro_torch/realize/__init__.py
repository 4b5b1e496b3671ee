"""Realization loop on one card: checkpoint -> plan -> stage programs ->
execution and the measured side of the report."""
