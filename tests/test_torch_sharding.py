"""The port's sharding layer and cell bundles (``repro_torch.nn.params``,
``repro_torch.launch.steps``, ``zero1_axes``, the roofline's arithmetic)
against the reference's.

Structure and rules are compared directly: the reference's mesh-taking
helpers read only a mesh's ``shape`` and ``axis_names``, so both packages
get the same small stand-in.  The port's parameters are one module a
layer; the reference stacks them on a leading ``layers`` axis, so its
trees are walked into the port's names (``blocks.<i>.``, ``enc_blocks``
and ``dec_blocks``, as ``models/convert.py::split_blocks`` walks them)
with that axis dropped.  The reference's hill-climb variants are read
from its source: importing its launch scripts would force 512 host
devices on this process.

The sharded numerics run 8 gloo ranks, spawned from one subprocess for
the module (as ``tests/test_torch_compressed_dp.py`` does): a reduced
``smollm-135m`` train step on a (4, 2) mesh against the single-process
step and the reference's loss, and prefill and decode bundles of reduced
``smollm-135m``, ``mamba2-370m`` and ``granite-moe-3b-a800m`` (MoE, its
router cast to bf16 with the serving weights) on (2, 4) against the
unsharded plain route.
"""

from __future__ import annotations

import ast
import itertools
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import roofline as jroofline
from repro.launch import steps as jsteps
from repro.models import model_api as jmodel_api
from repro.nn import params as jparams
from repro.optim.adamw import zero1_axes as jzero1_axes
from repro_torch.configs import base
from repro_torch.configs.base import SHAPES, ShapeConfig, all_archs, \
    get_config
from repro_torch.launch import hillclimb, roofline, steps
from repro_torch.models import model_api
from repro_torch.nn import params
from repro_torch.optim.adamw import zero1_axes

REPO = Path(__file__).resolve().parent.parent
RANKS = 8
SUB_TIMEOUT = 300       # seconds, the ranks' subprocess
REL = 2e-4              # the reference's sharded-vs-single tolerance
STACKED = ("blocks", "enc_blocks", "dec_blocks")
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (4, 2): ("data", "model"), (2, 4): ("data", "model")}


def _mesh(shape):
    names = MESHES[shape]
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, tree


def _by_port_name(tree, n_layers, axes=False):
    """The reference's tree keyed by the port's parameter names: stacked
    leaves split per layer, their leading axis dropped."""
    out = {}
    for path, leaf in _walk(tree):
        if path[0] in STACKED:
            for i in range(n_layers[path[0]]):
                name = ".".join((path[0], str(i)) + path[1:])
                out[name] = tuple(leaf)[1:] if axes else leaf
        else:
            out[".".join(path)] = tuple(leaf) if axes else leaf
    return out


def _layers(cfg):
    return {"blocks": cfg.n_layers, "enc_blocks": cfg.n_enc_layers,
            "dec_blocks": cfg.n_layers}


def _shape_dtype(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _ref_shape_dtype(s, stacked=False):
    return tuple(s.shape[1:] if stacked else s.shape), str(s.dtype)


def _ref_structs(tree, cfg):
    out = {}
    for path, leaf in _walk(tree):
        if path[0] in STACKED:
            for i in range(_layers(cfg)[path[0]]):
                out[".".join((path[0], str(i)) + path[1:])] = \
                    _ref_shape_dtype(leaf, True)
        else:
            out[".".join(path)] = _ref_shape_dtype(leaf)
    return out


def _variants_from_reference_source():
    tree = ast.parse((REPO / "src/repro/launch/hillclimb.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and node.target.id == "VARIANTS":
            return ast.literal_eval(node.value)
    raise AssertionError("no VARIANTS in the reference's hillclimb.py")


ARCHS = all_archs()


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------

def test_shapes_cells_and_counts_equal_the_references():
    assert all_archs() == jbase.all_archs()
    assert {k: vars(v) for k, v in SHAPES.items()} == \
        {k: vars(v) for k, v in jbase.SHAPES.items()}
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jbase.get_config(arch)
        assert base.cells_for(cfg) == jbase.cells_for(jcfg), arch
        assert cfg.supports_long_decode == jcfg.supports_long_decode
        assert cfg.active_param_count() == jcfg.active_param_count(), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_param_structs_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jbase.get_config(arch)
    for shape in SHAPES.values():
        got = {k: _shape_dtype(v)
               for k, v in steps.input_specs(cfg, shape).items()}
        want = {k: _ref_shape_dtype(v)
                for k, v in jsteps.input_specs(jcfg, shape).items()}
        assert got == want, (arch, shape.name)
    for dt in (None, "bfloat16"):
        got = {k: _shape_dtype(v)
               for k, v in steps.param_structs(cfg, dt).items()}
        assert got == _ref_structs(jsteps.param_structs(jcfg, dt), cfg), \
            (arch, dt)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_structs_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jbase.get_config(arch)
    for name in jbase.cells_for(jcfg):
        shape = SHAPES[name]
        if shape.kind == "train":
            continue
        enc = shape.seq_len if shape.kind == "prefill" \
            else min(shape.seq_len, 32768)
        got, axes = steps.cache_structs(cfg, shape.global_batch,
                                        shape.seq_len, enc_len=enc)
        want, jaxes = jsteps.cache_structs(jcfg, shape.global_batch,
                                           shape.seq_len, enc_len=enc)
        got_t = {p: _shape_dtype(t) for p, t in _walk(got)
                 if isinstance(t, torch.Tensor)}
        want_t = {p: _ref_shape_dtype(t) for p, t in _walk(want)
                  if p[-1] != "pos"}
        assert got_t == want_t, (arch, name)
        assert {p: a for p, a in _walk(axes) if p[-1] != "pos"} == \
            {p: tuple(a) for p, a in _walk(jaxes) if p[-1] != "pos"}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_and_tree_specs_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jbase.get_config(arch)
    axes = steps.get_param_axes(cfg)
    jaxes = jsteps.get_param_axes(jcfg)
    assert axes == _by_port_name(jaxes, _layers(cfg), axes=True)
    overrides = [{}] + [v.get("rules_overrides", {}) for v in
                        _variants_from_reference_source().values()]
    for ov, shape in itertools.product(overrides, [(16, 16), (2, 16, 16)]):
        mesh = _mesh(shape)
        got = params.tree_spec(axes, params.default_rules(**ov), mesh)
        jspec = jparams.tree_spec(jaxes, jparams.default_rules(**ov), mesh)
        want = {k: tuple(v)[1:] if k.split(".")[0] in STACKED else tuple(v)
                for k, v in _by_port_name(
                    jax.tree.map(lambda p: tuple(p), jspec,
                                 is_leaf=lambda x: isinstance(
                                     x, jax.sharding.PartitionSpec)),
                    _layers(cfg)).items()}
        assert got == want, (arch, ov, shape)


def test_hillclimb_variants_equal_the_references():
    assert hillclimb.VARIANTS == _variants_from_reference_source()


def test_placements_follow_the_spec():
    """A dim on two mesh axes shards on each (mesh order); an axis no dim
    uses replicates; a mesh axis is used once."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh((2, 16, 16))
    rules = params.default_rules()
    assert rules.spec(("batch", "seq", "embed"), mesh) == \
        (("pod", "data"), None, None)
    assert params.spec_placements((("pod", "data"), None, None), mesh) == \
        (Shard(0), Shard(0), Replicate())
    assert rules.placements(("embed", "vocab"), mesh) == \
        (Replicate(), Shard(0), Shard(1))
    assert params.spec_placements((None, "model"), _mesh((4, 2))) == \
        (Replicate(), Shard(1))


# ---------------------------------------------------------------------------
# Rules, ZeRO-1, roofline arithmetic
# ---------------------------------------------------------------------------

def _rules_eq(got, want):
    return dict(got.rules) == dict(want.rules) and \
        got.repeat_kv == want.repeat_kv


@pytest.mark.parametrize("mesh_shape", list(MESHES))
def test_layout_rules_equal_the_references(mesh_shape):
    mesh = _mesh(mesh_shape)
    batches = sorted({s.global_batch for s in SHAPES.values()} | {1, 8})
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jbase.get_config(arch)
        for kind in ("train", "prefill", "decode"):
            for b in batches:
                r = steps.fit_batch_rules(params.default_rules(), b, mesh)
                jr = jsteps.fit_batch_rules(jparams.default_rules(), b, mesh)
                assert _rules_eq(r, jr), (arch, kind, b)
                r = steps.derive_attn_rules(cfg, mesh, r, kind)
                jr = jsteps.derive_attn_rules(jcfg, mesh, jr, kind)
                assert _rules_eq(r, jr), (arch, kind, b)
                if kind != "train":
                    assert _rules_eq(
                        steps.serve_param_rules(cfg, mesh, r, kind),
                        jsteps.serve_param_rules(jcfg, mesh, jr, kind)), \
                        (arch, kind, b)


@pytest.mark.parametrize("mesh_size", [8, 16])
def test_zero1_axes_equal_the_references(mesh_size):
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jbase.get_config(arch)
        got = zero1_axes(steps.get_param_axes(cfg), steps.param_structs(cfg),
                         mesh_size=mesh_size)
        want = jzero1_axes(jsteps.get_param_axes(jcfg),
                           jsteps.param_structs(jcfg), mesh_size=mesh_size)
        assert got == _by_port_name(want, _layers(cfg), axes=True), arch


def test_model_flops_and_flash_adjustment_equal_the_references():
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jbase.get_config(arch)
        for shape, n_pod in itertools.product(SHAPES.values(), (1, 2)):
            assert roofline.model_flops_for(cfg, shape) == \
                jroofline.model_flops_for(jcfg, shape)
            assert roofline.flash_kernel_adjustment(cfg, shape,
                                                    n_pod=n_pod) == \
                jroofline.flash_kernel_adjustment(jcfg, shape, n_pod=n_pod)


def test_roofline_record_uses_the_h100_constants():
    rl = roofline.Roofline("x", 989e12, 3.35e12, 900e9, model_flops=989e12,
                           n_devices=1)
    assert (rl.t_compute, rl.t_memory, rl.t_collective) == (1.0, 1.0, 1.0)
    assert set(rl.to_dict()) == set(jroofline.Roofline(
        "x", 1.0, 1.0, 1.0).to_dict())


# ---------------------------------------------------------------------------
# Sharded numerics on 8 gloo ranks
# ---------------------------------------------------------------------------

PORT_CODE = textwrap.dedent("""
    import logging, sys
    from pathlib import Path
    SERVE_ARCHS = ("smollm-135m", "mamba2-370m", "granite-moe-3b-a800m")
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, world, port, inp, out_dir):
        torch.set_num_threads(1)
        logging.getLogger("torch.distributed").setLevel(logging.ERROR)
        from torch.distributed.tensor import Shard
        from repro_torch.configs.base import ShapeConfig, get_config
        from repro_torch.launch import steps
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import model_api
        from repro_torch.models.convert import params_from_jax
        from repro_torch.nn.params import default_rules
        from repro_torch.optim.adamw import AdamWConfig, init_opt_state
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        d = dict(np.load(inp))
        tree = {}
        for k, v in d.items():
            if k.startswith("w/"):
                node = tree
                *path, leaf = k[2:].split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = v
        res = {}
        cfg = get_config("smollm-135m").reduced().replace(
            compute_dtype="float32")
        model = params_from_jax(cfg, tree)
        B, S = d["tokens"].shape
        batch = {"tokens": torch.from_numpy(d["tokens"]),
                 "labels": torch.from_numpy(d["labels"])}
        ocfg = AdamWConfig(lr=1e-2, warmup_steps=0, eps=1e-3)
        mesh = make_host_mesh((4, 2), device_type="cpu")
        shape = ShapeConfig("t", S, B, "train")
        # zero1 on the no-FSDP layout, where the data axis is free
        for tag, zero1, rules in (("fsdp", False, None),
                                  ("zero1", True, default_rules(embed=None))):
            b = steps.make_train_bundle(cfg, shape, mesh, rules=rules,
                                        zero1=zero1, opt_cfg=ocfg)
            p = {n: t.detach().clone() for n, t in model.named_parameters()}
            state, bd = b.place({"params": p, "opt": init_opt_state(p)},
                                batch)
            state, m = b.fn(state, bd)
            res[f"{tag}/loss"] = m["loss"].full_tensor().numpy()
            for n, t in state["params"].items():
                res[f"{tag}/p/{n}"] = t.detach().full_tensor().numpy()
            res[f"{tag}/m_sharded_on_data"] = np.asarray(sum(
                Shard(i) == t.placements[0] for t in state["opt"]["m"].values()
                for i in range(t.dim())))
            res[f"{tag}/m_local"] = np.asarray(sum(
                t.to_local().numel() for t in state["opt"]["m"].values()))
            res[f"{tag}/p_local"] = np.asarray(sum(
                t.to_local().numel() for t in state["params"].values()))
        mesh2 = make_host_mesh((2, 4), device_type="cpu")
        for arch in SERVE_ARCHS:
            cfg = get_config(arch).reduced().replace(compute_dtype="float32")
            api = model_api(cfg)
            model = api.init_params(torch.Generator().manual_seed(1)) \\
                .to(torch.bfloat16)
            prm = {n: t.detach() for n, t in model.named_parameters()}
            toks = torch.from_numpy(d[f"serve_tokens"]) % cfg.vocab
            Sp, n_dec = toks.shape[1] - 4, 4
            pb = steps.make_prefill_bundle(
                cfg, ShapeConfig("p", Sp + n_dec, B, "prefill"), mesh2)
            db = steps.make_decode_bundle(
                cfg, ShapeConfig("d", Sp + n_dec, B, "decode"), mesh2)
            cache = api.init_cache(B, Sp + n_dec)
            pd, bd, cd = pb.place(prm, {"tokens": toks[:, :Sp]}, cache)
            lg, cd = pb.fn(pd, bd, cd)
            got = [lg.full_tensor()]
            for i in range(n_dec):
                td = db.place(prm, toks[:, Sp + i:Sp + i + 1], cache)[1]
                lg, cd = db.fn(pd, td, cd)
                got.append(lg.full_tensor())
            plain = api.init_cache(B, Sp + n_dec)
            lg, plain = api.prefill(model, {"tokens": toks[:, :Sp]}, plain,
                                    use_kernels=False)
            want = [lg]
            for i in range(n_dec):
                lg, plain = api.decode_step(
                    model, toks[:, Sp + i:Sp + i + 1], plain,
                    use_kernels=False)
                want.append(lg)
            res[f"{arch}/got"] = torch.stack(got).numpy()
            res[f"{arch}/want"] = torch.stack(want).numpy()
        if rank == 0:
            np.savez(Path(out_dir) / "ranks.npz", **res)
        dist.destroy_process_group()

    if __name__ == "__main__":
        from repro_torch.launch.mesh import free_port
        mp.start_processes(rank_main, nprocs=int(sys.argv[1]),
                           args=(int(sys.argv[1]), free_port(), sys.argv[2],
                                 sys.argv[3]),
                           start_method="spawn")
        print("done")
""")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The reference's reduced ``smollm-135m`` (f32 compute) weights and a
    batch go to the ranks; returns (the ranks' arrays, the weights' tree,
    the batch, the reference's loss)."""
    tmp = tmp_path_factory.mktemp("sharded")
    cfg = jbase.get_config("smollm-135m").reduced().replace(
        compute_dtype="float32")
    jparams_, _ = jmodel_api(cfg).init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams_)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    jloss = float(jmodel_api(cfg).loss_fn(
        jparams_, {"tokens": jnp.asarray(tokens),
                   "labels": jnp.asarray(labels)})[0])
    arrays = {"w/" + "/".join(p): v for p, v in _walk(tree)}
    arrays.update(tokens=tokens, labels=labels,
                  serve_tokens=rng.integers(0, 1 << 20, (8, 44)).astype(
                      np.int32))
    np.savez(tmp / "in.npz", **arrays)
    script = tmp / "ranks.py"
    script.write_text(PORT_CODE)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(script), str(RANKS),
                        str(tmp / "in.npz"), str(tmp)], capture_output=True,
                       text=True, timeout=SUB_TIMEOUT, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(tmp / "ranks.npz")), tree, tokens, labels, jloss


def test_sharded_loss_equals_single_process_and_the_references(sharded):
    res, tree, tokens, labels, jloss = sharded
    from repro_torch.models.convert import params_from_jax
    cfg = get_config("smollm-135m").reduced().replace(compute_dtype="float32")
    model = params_from_jax(cfg, tree)
    loss = float(model_api(cfg).loss_fn(
        model, {"tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels)}, use_kernels=False)[0])
    for tag in ("fsdp", "zero1"):
        assert float(res[f"{tag}/loss"]) == pytest.approx(loss, rel=REL)
        assert float(res[f"{tag}/loss"]) == pytest.approx(jloss, rel=REL)


def test_train_bundle_step_equals_the_single_process_step(sharded):
    """One step of the train bundle, FSDP and ZeRO-1 (on the no-FSDP
    layout), against ``make_train_step``'s on the same weights.  AdamW
    runs with eps = 1e-3: its first update is ``g / (|g| + eps)``, which
    with the default 1e-8 turns the last-bit differences of a gradient
    near zero into a full step either way."""
    res, tree, tokens, labels, _ = sharded
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config("smollm-135m").reduced().replace(compute_dtype="float32")
    state = steps.train_state(params_from_jax(cfg, tree))
    step = steps.make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=0,
                                                  eps=1e-3))
    state, _ = step(state, {"tokens": torch.from_numpy(tokens),
                            "labels": torch.from_numpy(labels)})
    for tag in ("fsdp", "zero1"):
        for n, p in state["params"].named_parameters():
            assert _rel(res[f"{tag}/p/{n}"], p.detach().numpy()) <= REL, \
                (tag, n)
    # the reference's ZeRO-1 rule puts ``opt_shard`` only on dims without
    # a logical axis; every dim of this model has one, so the moments keep
    # the parameters' layout (FSDP's data shard, or none without FSDP)
    assert int(res["fsdp/m_sharded_on_data"]) > 0
    assert int(res["zero1/m_sharded_on_data"]) == 0
    assert int(res["zero1/m_local"]) == int(res["zero1/p_local"])


def test_zero1_shards_the_moments_of_axis_less_dims_over_data():
    """``make_train_bundle(zero1=True)`` lays the moments of the dims with
    no logical axis (the SSM's per-head vectors) over the data axis, and
    leaves the parameters as they are."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = get_config("mamba2-370m").reduced()
    shape = ShapeConfig("t", 32, 8, "train")
    mesh = _mesh((4, 2))
    plain = steps.make_train_bundle(cfg, shape, mesh).placements[0]
    z = steps.make_train_bundle(cfg, shape, mesh, zero1=True).placements[0]
    assert z["params"] == plain["params"]
    moved = {n for n in z["opt"]["m"]
             if z["opt"]["m"][n] != plain["opt"]["m"][n]}
    assert moved == {n for n in z["params"]
                     if n.rsplit(".", 1)[-1] in ("A_log", "D", "dt_bias")}
    for n in moved:
        assert z["opt"]["m"][n] == z["opt"]["v"][n] == (Shard(0),
                                                        Replicate())


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m",
                                  "granite-moe-3b-a800m"])
def test_prefill_and_decode_bundles_equal_the_plain_route(sharded, arch):
    res = sharded[0]
    assert res[f"{arch}/got"].shape == res[f"{arch}/want"].shape
    for got, want in zip(res[f"{arch}/got"], res[f"{arch}/want"]):
        assert _rel(got, want) <= REL


def test_model_api_rules_none_keeps_the_unsharded_arithmetic():
    """``rules`` defaults to None, and default rules on plain tensors
    constrain nothing: the same logits bit for bit."""
    cfg = get_config("smollm-135m").reduced()
    api = model_api(cfg)
    model = api.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator()
                         .manual_seed(1))
    c1, c2 = api.init_cache(2, 16), api.init_cache(2, 16)
    a, _ = api.prefill(model, {"tokens": toks}, c1, use_kernels=False)
    b, _ = api.prefill(model, {"tokens": toks}, c2, use_kernels=False,
                       rules=params.default_rules())
    assert torch.equal(a, b)
