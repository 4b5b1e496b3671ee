"""``--workload NAME=SPEC`` bindings: the port's part of
``src/repro/launch/cli.py`` (``workload_bindings`` and
``resolve_workloads``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence


def workload_bindings(items: Sequence[str],
                      names: Optional[Sequence[str]] = None
                      ) -> Dict[str, str]:
    """Parse ``NAME=SPEC`` items into ``{name: spec}``.

    With ``names`` given (the workload names a checkpoint was swept over),
    a bare ``SPEC`` binds to the single name — including parameterized specs
    like ``transformer:k=v`` whose first ``=`` is part of the spec — and
    every name must end up bound.
    """
    out: Dict[str, str] = {}
    for s in items:
        name, sep, spec = s.partition("=")
        if sep and ":" not in name and "," not in name:
            pass                        # NAME=SPEC binding
        elif names is not None and len(names) == 1:
            name, spec = names[0], s
        elif names is not None:
            raise SystemExit(
                f"--workload {s!r}: target has workloads {list(names)}; "
                f"bind explicitly with NAME=SPEC")
        else:
            name, spec = s, s           # standalone: spec doubles as name
        out[name] = spec
    if names is not None:
        missing = [n for n in names if n not in out]
        if missing:
            raise SystemExit(
                f"no --workload binding for workload(s) {missing}")
    return out


def resolve_workloads(bindings: Dict[str, str],
                      builder: Optional[Callable] = None) -> Dict:
    """``{name: spec}`` -> ``{name: Graph}`` via the workload registry."""
    if builder is None:
        from ..core.workloads import make_workload as builder
    return {name: builder(spec) for name, spec in bindings.items()}
