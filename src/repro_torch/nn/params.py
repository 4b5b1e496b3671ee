"""Parameter trees with logical sharding axes, and their counts.

Port of ``src/repro/nn/params.py``.  A parallel tree of *logical axis
tuples* describes how each tensor dim shards; logical axes resolve to mesh
axes through ``ShardingRules``, so a layout changes by swapping the rules,
not the model.  The port's trees are dicts keyed by parameter name
(``dict(model.named_parameters())``) or nested dicts of them;
:func:`param_axes` names each parameter's axes by the port's names.

``ShardingRules.spec`` gives the reference's ``PartitionSpec`` entries as
a plain tuple (``None``, a mesh axis name, or a tuple of names);
``ShardingRules.placements`` turns that into DTensor placements on a
``torch.distributed`` ``DeviceMesh``: a tensor dim mapped to several mesh
axes is ``Shard(dim)`` on each of them, in mesh order (the reference's
major-to-minor order), and a mesh axis no dim uses is ``Replicate()``.
A mesh here is a ``DeviceMesh`` or anything with the reference's
``shape`` (axis name -> size) and ``axis_names``.

``shard_constraint`` is ``DTensor.redistribute`` to the spec for a DTensor
and a no-op otherwise, as the reference's ``with_sharding_constraint`` is
outside a mesh.  ``tree_shape_structs`` and ``abstract_init`` give meta
tensors: the structure, with no memory (the reference's
``ShapeDtypeStruct`` / ``jax.eval_shape``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, Mapping, Optional, Tuple,
                    Union)

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

Axes = Tuple[Optional[str], ...]
Rule = Union[None, str, Tuple[str, ...]]
Params = Union[nn.Module, Mapping[str, Any]]


# Default logical->mesh rules.  None = replicated dim.
# Parameters are 2-D sharded: FSDP over "data" (the `embed` axis) x TP over
# "model" (heads / mlp / vocab), the MaxText-style default.
DEFAULT_RULES: Dict[str, Rule] = {
    "batch": ("pod", "data"),
    "embed": "data",            # d_model dim of weights -> FSDP shard
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",             # FFN hidden
    "experts": "model",
    "expert_mlp": None,
    "seq": None,
    "kv_seq": "model",          # decode KV-cache sequence dim
    "layers": None,             # stacked leading dim of the caches
    "conv": None,
    "state": None,
    "stage": None,
    # attention activation layout (derived per arch x mesh in launch/steps):
    #   act_kv='model'  when (repeated) head count divides the model axis,
    #   act_seq='model' (context parallel) otherwise.
    "act_seq": None,
    "act_kv": "model",
    "act_kv_seq": None,         # decode: KV-cache seq dim inside attention
    "act_group": None,
}


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or of a mesh
    with the reference's ``shape`` and ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


@dataclass(frozen=True)
class ShardingRules:
    rules: Mapping[str, Rule]
    repeat_kv: bool = False     # materialize GQA kv->H heads in attention
                                # (Megatron-style TP trick; transient only)

    def spec(self, axes: Axes, mesh=None) -> Tuple[Rule, ...]:
        """The reference's ``PartitionSpec`` entries, one per dim: a mesh
        axis is used at most once, and with ``mesh`` only its axes."""
        have = mesh_axes(mesh) if mesh is not None else None
        out = []
        used: set = set()
        for a in axes:
            m = None if a is None else self.rules.get(a)
            if m is None:
                out.append(None)
                continue
            names = (m,) if isinstance(m, str) else tuple(m)
            if have is not None:
                names = tuple(n for n in names if n in have)
            names = tuple(n for n in names if n not in used)
            used.update(names)
            if not names:
                out.append(None)
            elif len(names) == 1:
                out.append(names[0])
            else:
                out.append(names)
        return tuple(out)

    def placements(self, axes: Axes, mesh) -> Tuple[Any, ...]:
        """DTensor placements, one per mesh dim, of :meth:`spec`."""
        return spec_placements(self.spec(axes, mesh), mesh)

    def replace_rules(self, **kw) -> "ShardingRules":
        d = dict(self.rules)
        repeat = kw.pop("repeat_kv", self.repeat_kv)
        d.update(kw)
        return ShardingRules(d, repeat_kv=repeat)


def spec_placements(spec: Tuple[Rule, ...], mesh) -> Tuple[Any, ...]:
    """``Shard(dim)`` on each mesh axis a spec entry names, ``Replicate()``
    on the others."""
    out = []
    for name in mesh_axes(mesh):
        dim = next((i for i, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def even_placements(rules: ShardingRules, axes: Axes, shape, mesh
                    ) -> Tuple[Any, ...]:
    """:meth:`ShardingRules.placements` with each dim's mesh axes cut to
    the longest prefix whose product divides the dim (kernels and local
    code take even shards only)."""
    sizes = mesh_axes(mesh)
    spec = []
    for n, e in zip(shape, rules.spec(axes, mesh)):
        names = () if e is None else (e,) if isinstance(e, str) else e
        while names and n % math.prod(sizes[a] for a in names):
            names = names[:-1]
        spec.append(names or None)
    return spec_placements(tuple(spec), mesh)


def default_rules(**overrides) -> ShardingRules:
    d = dict(DEFAULT_RULES)
    repeat = overrides.pop("repeat_kv", False)
    d.update(overrides)
    return ShardingRules(d, repeat_kv=repeat)


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of a tree of (nested) dicts."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_spec(axes_tree, rules: ShardingRules, mesh=None):
    """Logical-axes tree -> spec tree."""
    return tree_map(lambda axes: rules.spec(axes, mesh), axes_tree)


def tree_sharding(axes_tree, rules: ShardingRules, mesh):
    """Logical-axes tree -> DTensor placements tree on ``mesh``."""
    return tree_map(lambda axes: rules.placements(axes, mesh), axes_tree)


def shard_constraint(x: torch.Tensor, rules: Optional[ShardingRules],
                     axes: Axes, mesh=None) -> torch.Tensor:
    """``x`` redistributed to the spec of ``axes`` (a no-op without rules
    or for a tensor that is not a DTensor)."""
    if rules is None or not isinstance(x, DTensor):
        return x
    return placed(x, rules.placements(axes, mesh if mesh is not None
                                      else x.device_mesh))


def placed(t: torch.Tensor, placements) -> torch.Tensor:
    """DTensor ``t`` redistributed to ``placements`` on its mesh (``t``
    itself where it is laid out so already)."""
    if not isinstance(t, DTensor):
        raise TypeError(f"a DTensor is needed here, not {type(t).__name__}")
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, tuple(placements))


def seq_shard_index(mesh, placements, dim: int) -> int:
    """This rank's block index along tensor dim ``dim`` over the mesh dims
    that shard it (mesh order, major to minor); 0 where none does."""
    idx = 0
    for md, p in enumerate(placements):
        if p == Shard(dim):
            idx = idx * mesh.size(md) + mesh.get_local_rank(md)
    return idx


def grad_placements(in_placements) -> Tuple[Any, ...]:
    """``local_map``'s ``in_grad_placements`` for ``in_placements``: an
    input whole (``Replicate()``) on a mesh axis that another input shards
    took part in every rank's share of the work, so its gradient is the
    sum of the ranks' (``Partial()``)."""
    split = {md for pl in in_placements if pl is not None
             for md, p in enumerate(pl) if isinstance(p, Shard)}
    return tuple(None if pl is None else
                 tuple(Partial() if md in split and isinstance(p, Replicate)
                       else p for md, p in enumerate(pl))
                 for pl in in_placements)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_io(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A ``local_map`` function's input as its computation should take it:
    its gradient leaves contiguous, as DTensor expects of a local shard
    (an op's backward may hand back a transposed one, and DTensor's view
    ops then fail on the shard)."""
    if t is None or not t.requires_grad:
        return t
    return _ContiguousGrad.apply(t)


def write_seq(dst: torch.Tensor, src: torch.Tensor, pos: int) -> None:
    """``dst[:, pos:pos + S] = src`` in place, ``S = src.shape[1]``.  For
    a DTensor ``dst`` each rank writes the part of the segment that falls
    in its own rows of dim 1 (which may shard), from ``src`` brought to
    ``dst``'s placements with dim 1 whole."""
    if not isinstance(dst, DTensor):
        dst[:, pos:pos + src.shape[1]] = src
        return
    mesh, dp = dst.device_mesh, tuple(dst.placements)
    sp = tuple(Replicate() if p == Shard(1) else p for p in dp)
    if not isinstance(src, DTensor):
        raise TypeError("write_seq: a DTensor destination takes a DTensor "
                        "segment")
    src = src.redistribute(mesh, sp)
    n_blocks = math.prod(mesh.size(md) for md, p in enumerate(dp)
                         if p == Shard(1))
    rows = -(-dst.shape[1] // n_blocks)
    S = src.shape[1]

    def local(dl, sl):
        start = seq_shard_index(mesh, dp, 1) * rows
        lo, hi = max(pos, start), min(pos + S, start + dl.shape[1])
        if lo < hi:
            dl[:, lo - start:hi - start] = sl[:, lo - pos:hi - pos]

    local_map(local, out_placements=None, in_placements=(dp, sp),
              device_mesh=mesh)(dst, src)


# logical axes of each parameter, by the longest matching suffix of its
# port name (the reference's init_* functions, without the stacked
# "layers" axis: the port keeps one module a layer)
_PARAM_AXES: Dict[str, Axes] = {
    "embed.embedding": ("vocab", "embed"),
    "lm_head.w": ("embed", "vocab"),
    "wq.w": ("embed", "heads"), "wk.w": ("embed", "heads"),
    "wv.w": ("embed", "heads"), "wo.w": ("heads", "embed"),
    "wq.b": ("heads",), "wk.b": ("heads",), "wv.b": ("heads",),
    "q_norm.scale": ("head_dim",), "k_norm.scale": ("head_dim",),
    "gate.w": ("embed", "mlp"), "up.w": ("embed", "mlp"),
    "down.w": ("mlp", "embed"),
    "router.w": ("embed", None),
    "w_gate": ("experts", "embed", "expert_mlp"),
    "w_up": ("experts", "embed", "expert_mlp"),
    "w_down": ("experts", "expert_mlp", "embed"),
    "in_proj.w": ("embed", "mlp"), "out_proj.w": ("mlp", "embed"),
    "conv_w": ("conv", "mlp"), "conv_b": ("mlp",),
    "A_log": (None,), "D": (None,), "dt_bias": (None,),
    "mamba.norm.scale": ("mlp",),
    "scale": ("embed",), "bias": ("embed",),      # the model's norms
}


def param_axes(names: Iterable[str]) -> Dict[str, Axes]:
    """Logical axes of each named parameter of the port's models."""
    out = {}
    for name in names:
        parts = name.split(".")
        for i in range(len(parts)):
            ax = _PARAM_AXES.get(".".join(parts[i:]))
            if ax is not None:
                out[name] = ax
                break
        else:
            raise KeyError(f"no logical axes for parameter {name!r}")
    return out


def _tensors(tree: Params) -> Iterable[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return tree.parameters()
    out = []
    tree_map(out.append, tree)
    return out


def count_params(tree: Params) -> int:
    return sum(t.numel() for t in _tensors(tree))


def param_bytes(tree: Params) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def tree_shape_structs(tree):
    """Tensor tree -> meta tensors of the same shapes and dtypes."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                           device="meta"), tree)


def abstract_init(init_fn: Callable[..., Any], *args, **kw):
    """``init_fn`` evaluated on the meta device: its tensors' shapes and
    dtypes, with no memory."""
    with torch.device("meta"):
        return init_fn(*args, **kw)
