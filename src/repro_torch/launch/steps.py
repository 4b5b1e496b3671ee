"""Step builders: the train step, and the cell bundles: train, prefill
and decode steps over DTensors on a mesh, with ``input_specs()`` and the
other meta-tensor stand-ins for every input.

Port of ``src/repro/launch/steps.py``.  :func:`make_train_step` is the
unsharded train step on plain tensors; :func:`make_train_bundle`,
:func:`make_prefill_bundle` and :func:`make_decode_bundle` (and
:func:`make_cell`, which picks one by the shape's kind) return a
:class:`CellBundle`: ``fn`` is an eager callable over DTensors laid out by
the sharding rules (the reference jits it with in/out shardings), ``args``
are meta tensors with the reference's global shapes and dtypes, and
``placements`` says where each argument lives on ``mesh``
(:meth:`CellBundle.place` puts full tensors there).  Given real tensors,
a bundle runs on the mesh's ranks; given fake ones under
``FakeTensorMode``, it is traced without memory, which is what
:mod:`repro_torch.launch.dryrun` measures.  Where the reference donates
the state or the cache, ``fn`` updates them in place.

Inside ``fn``, plain tensors that the model makes for itself (positions,
masks, rope tables, zero accumulators; the same on every rank) enter
DTensor ops as ``Replicate()`` on every mesh axis
(``implicit_replication``); code without a DTensor sharding rule (the
SSD, MoE dispatch, the kernels) runs on each rank's shards through
``local_map`` with its placements stated (:mod:`repro_torch.nn`).  The
train bundle reduces each gradient to the layout of its AdamW moments
(the reduce-scatter of FSDP, or of ZeRO-1 with ``zero1``) and updates the
parameters there, gathering them back where the layouts differ.

The train state is the reference's ``{"params", "opt"}``.  For
:func:`make_train_step`, ``"params"`` is the model (``nn.Module``, the
port's parameter tree, its parameters requiring grad) and ``"opt"``
:func:`init_opt_state` of its named parameters, :func:`state_tree` the
checkpointable view of it; for the train bundle, ``"params"`` is the
dict of named parameters.  Both train steps take the plain routes
(``loss_fn(..., use_kernels=False)``): the port's CUDA kernels have no
backward, and the reference's jitted step differentiates its jnp twins
(block-scan attention, ``ssd_chunked``), never a Pallas kernel.  The
prefill and decode bundles take the kernels on CUDA meshes, as the eager
route does.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from .. import obs
from ..configs.base import ModelConfig, ShapeConfig
from ..models import model_api
from ..nn.params import (Axes, ShardingRules, abstract_init, default_rules,
                         mesh_axes, param_axes, placed, tree_map,
                         tree_shape_structs, tree_sharding)
from ..optim.adamw import (AdamWConfig, adamw_update, init_opt_state,
                           zero1_axes)

State = Dict[str, Any]


def batch_axes(cfg: ModelConfig, kind: str) -> Dict[str, Tuple]:
    a: Dict[str, Tuple] = {}
    if cfg.frontend in ("patch", "audio"):
        a["embeds"] = ("batch", "seq", "embed")
        if cfg.family == "encdec":
            a["tokens"] = ("batch", "seq")
    else:
        a["tokens"] = ("batch", "seq")
    if kind == "train":
        a["labels"] = ("batch", "seq")
    return a


def train_state(params: nn.Module) -> State:
    """``{"params": params, "opt": ...}`` with ``params``' parameters set
    to require grad and zero AdamW moments."""
    params.requires_grad_(True)
    return {"params": params,
            "opt": init_opt_state(dict(params.named_parameters()))}


def state_tree(state: State) -> Dict[str, Any]:
    """The state as nested dicts of tensors (the parameters by name), for
    :mod:`repro_torch.checkpoint.ckpt`."""
    return {"params": dict(state["params"].named_parameters()),
            "opt": state["opt"]}


@torch.no_grad()
def load_state_tree(state: State, tree: Mapping[str, Any]) -> State:
    """Copy a restored :func:`state_tree` into ``state`` (the parameters
    in place, the optimizer state replaced)."""
    for name, p in state["params"].named_parameters():
        p.copy_(tree["params"][name])
    state["opt"] = tree["opt"]
    return state


def to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str,
                                                               torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    n_micro: int = 1, zero1: bool = False
                    ) -> Callable[[State, Dict[str, torch.Tensor]],
                                  Tuple[State, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm", "lr"})``:
    the gradient of ``loss_fn`` on the plain routes (with ``n_micro > 1``,
    the mean of the gradients of ``n_micro`` equal slices of the batch,
    and the mean of their NLLs), then :func:`adamw_update` in place.
    ``loss`` is the NLL without the MoE auxiliary term, as the
    reference's.  ``zero1`` needs a mesh, and raises here: it is
    :func:`make_train_bundle`'s.

    Each call keeps the span ``train.step`` (key: the call's index, from
    0) holding ``train.forward`` (``loss_fn``) and ``train.backward``
    (``autograd.grad``, remat's recompute included) for each micro-batch
    (key: its index), ``train.accumulate`` (the gradients' sum) from the
    second on, and ``train.optimizer`` (:func:`adamw_update`); all but
    ``train.step`` carry the device clock on a CUDA device
    (:func:`repro_torch.obs.kept_span`)."""
    if zero1:
        raise ValueError(
            "zero1 shards the optimizer state over a mesh's data axis: build "
            "the step with make_train_bundle(cfg, shape, mesh, zero1=True)")
    opt_cfg = opt_cfg or AdamWConfig()
    api = model_api(cfg)
    calls = itertools.count()

    def grads_of(model: nn.Module, plist, batch, micro: int, dev):
        with obs.kept_span("train.forward", key=micro, device=dev):
            loss, m = api.loss_fn(model, batch, use_kernels=False)
        # a parameter off the loss's graph (the token embedding of a
        # frontend fed embeddings) gets zeros, as jax.grad gives it
        with obs.kept_span("train.backward", key=micro, device=dev):
            grads = torch.autograd.grad(loss, plist, allow_unused=True,
                                        materialize_grads=True)
        return grads, m["nll"].detach()

    def train_step(state: State, batch: Dict[str, torch.Tensor]):
        model, opt = state["params"], state["opt"]
        named = dict(model.named_parameters())
        plist = list(named.values())
        dev = plist[0].device
        with obs.kept_span("train.step", key=next(calls)):
            if n_micro > 1:
                mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                   + tuple(v.shape[1:]))
                      for k, v in batch.items()}
                gsum, nll = grads_of(model, plist,
                                     {k: v[0] for k, v in mb.items()}, 0, dev)
                gsum = list(gsum)
                for i in range(1, n_micro):
                    g, n = grads_of(model, plist,
                                    {k: v[i] for k, v in mb.items()}, i, dev)
                    with obs.kept_span("train.accumulate", key=i,
                                       device=dev):
                        torch._foreach_add_(gsum, g)
                        nll = nll + n
                grads = torch._foreach_div(gsum, float(n_micro))
                nll = nll / n_micro
            else:
                grads, nll = grads_of(model, plist, batch, 0, dev)
            with obs.kept_span("train.optimizer", device=dev):
                _, opt, om = adamw_update(opt_cfg, named,
                                          dict(zip(named, grads)), opt)
        return {"params": model, "opt": opt}, {"loss": nll, **om}

    return train_step


# ---------------------------------------------------------------------------
# input_specs and the other stand-ins: meta tensors, no memory
# ---------------------------------------------------------------------------

def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta tensors for the step function's *batch* argument."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, torch.Tensor] = {}
    if shape.kind == "decode":
        out["tokens"] = _meta((B, 1), torch.int32)
        return out
    if cfg.frontend in ("patch", "audio"):
        out["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        if cfg.family == "encdec":
            out["tokens"] = _meta((B, S), torch.int32)
    else:
        out["tokens"] = _meta((B, S), torch.int32)
    if shape.kind == "train":
        out["labels"] = _meta((B, S), torch.int32)
    return out


def skeleton(cfg: ModelConfig) -> nn.Module:
    """The model on the meta device: its parameters' names, shapes and
    dtypes, no memory."""
    return abstract_init(model_api(cfg).init_params, None)


def get_param_axes(cfg: ModelConfig) -> Dict[str, Axes]:
    """Logical axes of each named parameter."""
    return param_axes(n for n, _ in skeleton(cfg).named_parameters())


def param_structs(cfg: ModelConfig, serve_dtype: Optional[str] = None
                  ) -> Dict[str, torch.Tensor]:
    """Each named parameter as a meta tensor; ``serve_dtype``
    ("bfloat16" | "float32") recasts the floating ones."""
    structs = tree_shape_structs(dict(skeleton(cfg).named_parameters()))
    if serve_dtype is None:
        return structs
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[serve_dtype]
    return {n: _meta(t.shape, dt) if t.is_floating_point() else t
            for n, t in structs.items()}


_KV_AXES = ("batch", "kv_seq", "kv_heads", "head_dim")


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of :func:`cache_structs`'s tree (the reference's
    ``init_cache`` axes); ``pos`` is a host int, ``()``."""
    a: Dict[str, Any] = {}
    if cfg.family in ("ssm", "hybrid"):
        a["ssm"] = {"conv": ("layers", "batch", None, "mlp"),
                    "state": ("layers", "batch", "heads", None, None)}
        if cfg.family == "hybrid":
            a["kv"] = {k: ("stage",) + _KV_AXES for k in ("k", "v")}
    else:
        a["kv"] = {k: ("layers",) + _KV_AXES for k in ("k", "v")}
    a["pos"] = ()
    if cfg.family == "encdec":
        a["enc_out"] = ("batch", "seq", "embed")
    return a


def cache_structs(cfg: ModelConfig, batch: int, max_seq: int,
                  enc_len: Optional[int] = None) -> Tuple[Any, Any]:
    """(the cache with meta tensors, its logical axes)."""
    structs = model_api(cfg).init_cache(batch, max_seq, enc_len,
                                        device="meta")
    return structs, cache_axes(cfg)


# ---------------------------------------------------------------------------
# Cell bundles
# ---------------------------------------------------------------------------

def _tree_zip(fn: Callable, a, b):
    if isinstance(a, Mapping):
        return {k: _tree_zip(fn, v, b[k]) for k, v in a.items()}
    return fn(a, b)


@dataclass
class CellBundle:
    """Everything needed to run or trace one (arch x shape x mesh) cell."""
    name: str
    fn: Callable                    # eager, over DTensors on ``mesh``
    args: Tuple[Any, ...]           # meta tensors (global shapes)
    static_desc: str = ""
    mesh: Any = None
    placements: Tuple[Any, ...] = ()    # a placements tree for each arg

    def place(self, *args) -> Tuple[Any, ...]:
        """Full tensors in ``args``' structure -> DTensors on ``mesh``, each
        rank keeping its shards of what it was given (so every rank must
        be given the same full tensors); non-tensors pass through."""
        def one(t, pl):
            if not isinstance(t, torch.Tensor):
                return t
            return distribute_tensor(t, self.mesh, pl, src_data_rank=None)
        return tuple(_tree_zip(one, a, p)
                     for a, p in zip(args, self.placements))

    def empty_args(self) -> Tuple[Any, ...]:
        """``args`` as uninitialized tensors on the mesh's device type,
        placed: under ``FakeTensorMode`` they take no memory."""
        dev = self.mesh.device_type

        def empty(t):
            if not isinstance(t, torch.Tensor):
                return t
            return torch.empty(t.shape, dtype=t.dtype, device=dev)
        return self.place(*(tree_map(empty, a) for a in self.args))


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a row-major local shard: a gradient can come back
    transposed (a tied embedding's), and reductions over it (AdamW's
    global norm) then add in another order than the unsharded step's."""
    local = t.to_local()
    if local.is_contiguous():
        return t
    return DTensor.from_local(local.contiguous(), t.device_mesh, t.placements,
                              shape=t.shape, stride=t.stride())


def _load(model: nn.Module, params: Mapping[str, torch.Tensor]) -> None:
    """Bind ``params`` (by name) as ``model``'s parameters."""
    for name, t in params.items():
        mod, _, leaf = name.rpartition(".")
        model.get_submodule(mod)._parameters[leaf] = t


def derive_attn_rules(cfg: ModelConfig, mesh, rules: ShardingRules,
                      kind: str) -> ShardingRules:
    """Pick the attention activation layout for this (arch x mesh):
      kv-shard   when n_kv divides the model axis,
      repeat-kv  when only n_heads divides it (Megatron GQA trick; transient
                 tensors only, never the cache; disabled for decode where
                 the cache's kv_seq sharding already balances),
      seq-shard  (context parallel) otherwise.
    MoE: when n_experts doesn't divide the model axis, shard the expert FFN
    hidden dim instead of the expert dim."""
    M = mesh_axes(mesh).get("model", 1)
    if cfg.n_experts and cfg.n_experts % M != 0:
        rules = rules.replace_rules(experts=None, expert_mlp="model")
    if cfg.family == "ssm":
        return rules
    if kind == "decode":
        return rules.replace_rules(act_kv=None, act_kv_seq="model")
    if cfg.n_kv % M == 0:
        return rules
    if cfg.n_heads % M == 0:
        return rules.replace_rules(repeat_kv=True)
    return rules.replace_rules(act_kv=None, act_seq="model")


def serve_param_rules(cfg: ModelConfig, mesh, rules: ShardingRules,
                      kind: str = "decode") -> ShardingRules:
    """Serving default: drop the FSDP (data-axis) shard on params when the
    TP-sharded bf16 weights fit comfortably in device memory (< 8 GB a
    device); static serving weights should not be re-gathered every step.
    SSM/hybrid *prefill* keeps the 2-D layout, as the reference's rule
    does."""
    if kind == "prefill" and cfg.family in ("ssm", "hybrid"):
        return rules
    M = mesh_axes(mesh).get("model", 1)
    bytes_tp = cfg.param_count() * 2 / M
    if bytes_tp < 8e9:
        return rules.replace_rules(embed=None)
    return rules


def fit_batch_rules(rules: ShardingRules, global_batch: int,
                    mesh) -> ShardingRules:
    """Shrink the 'batch' rule to the largest mesh-axis prefix whose product
    divides global_batch (batch=1 long-context cells stay unsharded)."""
    raw = rules.rules.get("batch")
    if raw is None:
        return rules
    sizes = mesh_axes(mesh)
    names = [raw] if isinstance(raw, str) else list(raw)
    names = [n for n in names if n in sizes]
    while names:
        prod = 1
        for n in names:
            prod *= sizes[n]
        if global_batch % prod == 0:
            break
        names.pop()
    return rules.replace_rules(batch=tuple(names) if names else None)


def _micro_batches(x: torch.Tensor, n: int, placements, mesh):
    """The ``n`` micro-batches of a batch DTensor: each rank's rows cut
    into ``n`` equal runs, micro-batch i taking run i of every rank (so
    each keeps the batch layout; the rows differ from the reference's
    contiguous cut, the mean of the ``n`` gradients does not)."""
    shifted = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                    for p in placements)
    stacked = local_map(
        lambda t: t.reshape((n, t.shape[0] // n) + tuple(t.shape[1:])),
        out_placements=list(shifted), in_placements=(tuple(placements),),
        device_mesh=mesh)(x)
    return [stacked[i] for i in range(n)]


def make_train_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      rules: Optional[ShardingRules] = None,
                      n_micro: int = 1, zero1: bool = False,
                      opt_cfg: Optional[AdamWConfig] = None) -> CellBundle:
    """``fn(state, batch) -> (state, {"loss", "grad_norm", "lr"})``, the
    state updated in place.  ``zero1`` shards the AdamW moments over the
    data axis on the largest free dim of each parameter
    (:func:`repro_torch.optim.adamw.zero1_axes`)."""
    rules = fit_batch_rules(rules or default_rules(), shape.global_batch, mesh)
    rules = derive_attn_rules(cfg, mesh, rules, "train")
    opt_cfg = opt_cfg or AdamWConfig()
    api = model_api(cfg)
    model = skeleton(cfg)
    p_axes = get_param_axes(cfg)
    p_structs = param_structs(cfg)
    o_structs = init_opt_state(p_structs)
    if zero1:
        mv_axes = zero1_axes(p_axes, p_structs,
                             mesh_size=mesh_axes(mesh).get("data", 1))
        rules = rules.replace_rules(opt_shard="data")
    else:
        mv_axes = p_axes
    p_pl = tree_sharding(p_axes, rules, mesh)
    mv_pl = tree_sharding(mv_axes, rules, mesh)
    rep = tuple(Replicate() for _ in mesh_axes(mesh))
    state_pl = {"params": p_pl, "opt": {"m": mv_pl, "v": mv_pl,
                                        "step": rep}}
    b_axes = batch_axes(cfg, "train")
    b_structs = input_specs(cfg, shape)
    b_pl = {k: rules.placements(b_axes[k], mesh) for k in b_structs}

    def grads_of(params, plist, batch):
        _load(model, params)
        loss, m = api.loss_fn(model, batch, use_kernels=False, rules=rules)
        return torch.autograd.grad(loss, plist, allow_unused=True,
                                   materialize_grads=True), m["nll"].detach()

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        plist = [p.requires_grad_(True) for p in params.values()]
        with implicit_replication():
            if n_micro > 1:
                mbs = {k: _micro_batches(v, n_micro, b_pl[k], mesh)
                       for k, v in batch.items()}
                gsum, nll = None, None
                for i in range(n_micro):
                    g, n = grads_of(params, plist,
                                    {k: v[i] for k, v in mbs.items()})
                    if gsum is None:
                        gsum, nll = [x.float() for x in g], n
                    else:
                        torch._foreach_add_(gsum, g)
                        nll = nll + n
                grads = torch._foreach_div(gsum, float(n_micro))
                nll = nll / n_micro
            else:
                grads, nll = grads_of(params, plist, batch)
            # reduce each gradient to its moments' layout, update there
            grads = {k: _dense(placed(g, mv_pl[k]))
                     for k, g in zip(params, grads)}
            pz = {k: placed(p.detach(), mv_pl[k])
                  for k, p in params.items()}
            _, opt, om = adamw_update(opt_cfg, pz, grads, opt)
            with torch.no_grad():
                for k, p in params.items():
                    if tuple(p.placements) != tuple(mv_pl[k]):
                        p.copy_(placed(pz[k], p_pl[k]))
            metrics = {"loss": placed(nll, rep),
                       "grad_norm": placed(om["grad_norm"], rep),
                       "lr": placed(om["lr"], rep)}
        return {"params": params, "opt": opt}, metrics

    return CellBundle(name=f"{cfg.name}/{shape.name}", fn=train_step,
                      args=({"params": p_structs, "opt": o_structs},
                            b_structs),
                      static_desc=f"train micro={n_micro} zero1={zero1}",
                      mesh=mesh, placements=(state_pl, b_pl))


def _serve_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  rules: Optional[ShardingRules], kind: str) -> CellBundle:
    rules = fit_batch_rules(rules or default_rules(), shape.global_batch, mesh)
    rules = derive_attn_rules(cfg, mesh, rules, kind)
    rules = serve_param_rules(cfg, mesh, rules, kind)
    api = model_api(cfg)
    model = skeleton(cfg)
    p_pl = tree_sharding(get_param_axes(cfg), rules, mesh)
    p_structs = param_structs(cfg, serve_dtype="bfloat16")
    enc_len = shape.seq_len if kind == "prefill" \
        else min(shape.seq_len, 32768)
    c_structs, c_axes = cache_structs(cfg, shape.global_batch, shape.seq_len,
                                      enc_len=enc_len)
    c_pl = tree_sharding(c_axes, rules, mesh)
    out_pl = rules.placements(("batch", "vocab"), mesh)
    if kind == "prefill":
        b_structs = input_specs(cfg, shape)
        b_axes = batch_axes(cfg, "prefill")
        b_pl = {k: rules.placements(b_axes[k], mesh) for k in b_structs}
        step = api.prefill
    else:
        b_structs = _meta((shape.global_batch, 1), torch.int32)
        b_pl = rules.placements(("batch", "seq"), mesh)
        step = api.decode_step

    def serve_fn(params, batch, cache):
        _load(model, params)
        with implicit_replication():
            logits, cache = step(model, batch, cache, rules=rules)
            return placed(logits, out_pl), cache

    return CellBundle(name=f"{cfg.name}/{shape.name}", fn=serve_fn,
                      args=(p_structs, b_structs, c_structs),
                      static_desc=kind, mesh=mesh,
                      placements=(p_pl, b_pl, c_pl))


def make_prefill_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh,
                        rules: Optional[ShardingRules] = None) -> CellBundle:
    """``fn(params, batch, cache) -> (last-token logits, cache)``, the
    cache written in place; bf16 parameters."""
    return _serve_bundle(cfg, shape, mesh, rules, "prefill")


def make_decode_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       rules: Optional[ShardingRules] = None) -> CellBundle:
    """``fn(params, tokens (B, 1), cache) -> (logits, cache)``, the cache
    written in place; bf16 parameters."""
    return _serve_bundle(cfg, shape, mesh, rules, "decode")


def make_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
              rules: Optional[ShardingRules] = None, **kw) -> CellBundle:
    if shape.kind == "train":
        big = cfg.param_count() > 5e9
        kw.setdefault("n_micro", 4 if big else 1)
        return make_train_bundle(cfg, shape, mesh, rules, **kw)
    if shape.kind == "prefill":
        return make_prefill_bundle(cfg, shape, mesh, rules)
    return make_decode_bundle(cfg, shape, mesh, rules)
