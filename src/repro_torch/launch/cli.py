"""Shared launcher CLI surface: the port's part of
``src/repro/launch/cli.py``.

* ``--arch NAME`` + ``--reduced``: a model config from
  ``repro_torch.configs.get_config`` (``--reduced`` applies the CPU-sized
  variant);
* ``--workload NAME=SPEC`` bindings (``add_workload_args``,
  ``workload_bindings``, ``resolve_workloads``);
* repeated ``NAME=VALUE`` options (``parse_kv``);
* ``--out PATH`` / ``--seed N``: artifact path and base RNG seed.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional, Sequence


def add_arch_args(ap: argparse.ArgumentParser, required: bool = True,
                  default: Optional[str] = None) -> None:
    ap.add_argument("--arch", required=required, default=default,
                    help="model config name (repro_torch.configs.get_config)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced-size config variant (CPU runs)")


def model_config(args: argparse.Namespace):
    """Resolve ``--arch``/``--reduced`` into a ModelConfig."""
    from ..configs import get_config
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def add_out_arg(ap: argparse.ArgumentParser, default: Optional[str] = None,
                what: str = "result artifact") -> None:
    ap.add_argument("--out", default=default,
                    help=f"write the {what} here"
                         + (f" (default {default})" if default else ""))


def add_seed_arg(ap: argparse.ArgumentParser, default: int = 0) -> None:
    ap.add_argument("--seed", type=int, default=default,
                    help=f"base RNG seed (default {default})")


def add_workload_args(ap: argparse.ArgumentParser,
                      help_extra: str = "") -> None:
    ap.add_argument(
        "--workload", action="append", default=[], metavar="NAME=SPEC",
        help="workload graph binding (repeatable); SPEC is a registry "
             "preset (tf-quick, moe-quick, mla-quick, ...) or a "
             "parameterized spec ('transformer:k=v,...', 'moe:...', "
             "'mla:...', 'lm:<config>') — see "
             "repro_torch.core.workloads.make_workload. " + help_extra)


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


def parse_kv(items: Optional[Sequence[str]], cast: Callable = str,
             flag: str = "option") -> Optional[Dict[str, object]]:
    """Parse repeated ``NAME=VALUE`` flags; None when nothing was given."""
    if not items:
        return None
    out: Dict[str, object] = {}
    for item in items:
        name, sep, val = item.partition("=")
        if not sep:
            raise SystemExit(f"{flag} {item!r} is not NAME=VALUE")
        try:
            out[name] = cast(val)
        except ValueError as e:
            raise SystemExit(f"{flag} {item!r}: {e}")
    return out
