"""Realization loop on one card: checkpoint -> plan -> stage programs ->
execution -> measured-vs-predicted report -> Tech overlay."""
