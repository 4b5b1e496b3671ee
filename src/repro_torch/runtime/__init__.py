"""Runtime loops (port of ``src/repro/runtime``): the serve loop."""
