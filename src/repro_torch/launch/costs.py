"""Per-device costs of one traced step: FLOPs, bytes, collective bytes and
memory, counted from the ops the step dispatches.

Stands in for ``src/repro/launch/hlo_analysis.py`` and
``roofline.collective_bytes``: the reference reads the compiled,
SPMD-partitioned HLO; the port runs the step eagerly over DTensors
(under ``FakeTensorMode`` for the dry-run: shapes only, no memory) inside
an :class:`OpCounter`, a dispatch mode that sees the local ops each
DTensor op turns into on this rank, so every count is per device.  The
step is eager, so loops (layers, micro-batches, KV blocks) are unrolled:
what the reference's trip-count walker reconstructs.

* FLOPs: ``torch.utils.flop_counter``'s formulas (2 x output elements x
  contraction for the products, as the reference counts dots; elementwise
  ops count none).
* Bytes: each op's tensor inputs read once and outputs written once, views
  and metadata ops free.  These are unfused eager-op bytes: XLA's fusions
  keep many intermediates on chip that an eager op writes and the next
  reads, so they are not comparable with the reference's HLO bytes.
* Collective bytes: the output bytes of each c10d functional collective,
  under the reference's five kinds (the reference sums output shapes too).
  On a ``"cpu"`` mesh an all-to-all runs as an all-gather and a chunk
  (DTensor's fallback) and counts as an all-gather.
* Memory: ``argument_bytes`` / ``output_bytes`` are the local shard bytes
  of the step's arguments and results (:func:`local_bytes`); ``temp_bytes``
  the peak of the storage the step allocated and had alive at once, less
  what its results still hold at the end.

DTensor computes each op's global output shape by running the op once on
global-shape fake tensors (sharding propagation); those runs are not the
step's work and are not counted.
"""

from __future__ import annotations

import functools
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "broadcast": "collective-permute",
         "permute_tensor": "collective-permute"}

_FREE = {"detach", "alias", "lift_fresh", "wait_tensor",
         "_local_scalar_dense", "device", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_contiguous", "_unsafe_view",
         "empty", "empty_strided", "empty_like"}


@dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})


_propagating = threading.local()


def _untracked(fn):
    """Run ``fn`` with this thread's counting off."""
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        _propagating.depth = getattr(_propagating, "depth", 0) + 1
        try:
            return fn(*a, **kw)
        finally:
            _propagating.depth -= 1
    wrapped._untracked = True
    return wrapped


def _install_propagation_guard() -> None:
    """Make DTensor's global-shape propagation runs invisible to the
    counter (idempotent)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    fn = ShardingPropagator._propagate_tensor_meta_non_cached
    if not getattr(fn, "_untracked", False):
        ShardingPropagator._propagate_tensor_meta_non_cached = \
            _untracked(fn)


def _tensors(tree) -> Iterable[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors in ``tree`` (nested
    dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    return 0


class OpCounter(TorchDispatchMode):
    """Counts :class:`Costs` and live storage of the plain (local) ops
    dispatched inside it; DTensor ops pass through to DTensor, whose local
    ops come back here."""

    def __init__(self):
        super().__init__()
        _install_propagation_guard()
        self.costs = Costs()
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, DTensor) for t in ins):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_propagating, "depth", 0):
            return out
        ns, _, name = func.name().partition("::")
        name = name.split(".")[0]
        outs = _tensors(out)
        if "c10d" in ns:
            kind = _KIND.get(name)
            if kind is not None:
                b = float(sum(_nbytes(t) for t in outs))
                self.costs.coll_by_kind[kind] += b
                self.costs.coll_bytes += b
            self._track(outs)
            return out
        if func._overloadpacket in flop_registry:
            self.costs.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if not func.is_view and name not in _FREE:
            self.costs.bytes += float(sum(_nbytes(t) for t in ins)
                                      + sum(_nbytes(t) for t in outs))
        self._track(outs)
        return out

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def temp_bytes(self, results: Any) -> float:
        """Peak storage the step allocated, less what ``results`` hold of
        it at the end."""
        held = {}
        for t in _tensors(results):
            t = t.to_local() if isinstance(t, DTensor) else t
            st = t.untyped_storage()
            if st._cdata in self.live:
                held[st._cdata] = self.live[st._cdata]
        return float(max(0, self.peak_bytes - sum(held.values())))
