"""The port's training path (``repro_torch.optim``, ``launch.steps``,
``runtime.train_loop``) against the reference's on the CPU, from the
reference's own initialized parameters carried across by
``params_from_jax`` and the same batches.

Tolerances:
  * AdamW, its schedule and the int8 error-feedback functions, from
    identical trees: rel 1e-6 (f32 arithmetic in another order);
  * gradients (``torch.autograd`` against ``jax.grad`` of ``loss_fn``, f32
    compute) and three train steps: rel 1e-4 of each leaf's largest
    reference value;
  * the port's crash-restart against its straight run: the reference
    test's rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig
from repro.core.explore import graph_fingerprint as jgraph_fingerprint
from repro.core.workloads import make_workload as jmake_workload
from repro.data import pipeline as jpipe
from repro.launch.steps import make_train_bundle
from repro.models import model_api as jmodel_api
from repro.optim import adamw as jadamw
from repro.runtime.train_loop import TrainConfig as JTrainConfig
from repro.runtime.train_loop import Trainer as JTrainer
from repro_torch.configs import all_archs, get_config
from repro_torch.core.explore import graph_fingerprint
from repro_torch.core.workloads import make_workload
from repro_torch.data.pipeline import DataConfig, make_batch, make_embeds_batch
from repro_torch.launch import steps
from repro_torch.models import model_api
from repro_torch.models.convert import (flatten_tree, params_from_jax,
                                        split_blocks)
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import (StragglerWatchdog, TrainConfig,
                                            Trainer)

OPT_TOL = 1e-6
GRAD_TOL = 1e-4

# one reduced config for each (family, frontend) pair of all_archs(), and
# smollm at a length where the reference's rule takes the block-scan
# (flash) path: Sq * Sk > 256 * 2048
GRAD_CASES = [("smollm-135m", 2, 32), ("granite-moe-3b-a800m", 2, 32),
              ("mamba2-370m", 2, 64), ("zamba2-1.2b", 2, 64),
              ("whisper-small", 2, 32), ("llava-next-34b", 2, 32),
              ("smollm-135m", 1, 768)]


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def _by_name(cfg, tree):
    """The reference's stacked pytree as the port's parameter names."""
    tree = jax.tree.map(np.asarray, tree)
    for key in (("enc_blocks", "dec_blocks") if cfg.family == "encdec"
                else ("blocks",)):
        tree = split_blocks(tree, key)
    return flatten_tree(tree)


def _pair(arch, **kw):
    """The reference's config, params and the port's model on them, f32
    compute."""
    jc = jget_config(arch).reduced().replace(compute_dtype="float32", **kw)
    pc = get_config(arch).reduced().replace(compute_dtype="float32", **kw)
    jp, _ = jmodel_api(jc).init_params(jax.random.PRNGKey(0))
    jp = jax.tree.map(np.asarray, jp)
    return jc, jp, pc, params_from_jax(pc, jp)


def _batch(cfg, batch, seq, step=0):
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    if cfg.frontend in ("patch", "audio"):
        return make_embeds_batch(data, step, cfg.d_model,
                                 need_tokens=cfg.family == "encdec")
    return make_batch(data, step)


def _worst(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    return max(_rel(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# AdamW, schedule, int8 error feedback
# ---------------------------------------------------------------------------

OPT_CASES = [dict(), dict(grad_clip=0.0), dict(weight_decay=0.0, lr=1e-2),
             dict(b2=0.999, eps=1e-6, warmup_steps=2, total_steps=5)]


def _trees(seed):
    rng = np.random.default_rng(seed)
    p = {"a": {"w": rng.normal(size=(8, 16)).astype(np.float32),
               "b": rng.normal(size=(16,)).astype(np.float32)},
         "c": rng.normal(size=(3, 4, 5)).astype(np.float32)}
    g = [jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3)
                      .astype(np.float32), p) for _ in range(4)]
    return p, g


@pytest.mark.parametrize("kw", OPT_CASES)
def test_adamw_update_equals_the_references(kw):
    """Four steps from identical trees (gradients large enough that the
    global-norm clip bites where it is on)."""
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    p, gs = _trees(0)
    jp = jax.tree.map(jnp.asarray, p)
    jopt = jadamw.init_opt_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in flatten_tree(p).items()}
    opt = adamw.init_opt_state(tp)
    for g in gs:
        jp, jopt, jm = jadamw.adamw_update(jcfg, jp, g, jopt)
        tg = {k: torch.from_numpy(v) for k, v in flatten_tree(g).items()}
        tp2, opt, m = adamw.adamw_update(cfg, tp, tg, opt)
        assert tp2 is tp
        for k in ("grad_norm", "lr"):
            assert _rel(m[k], jm[k]) <= OPT_TOL, (k, m[k], jm[k])
        assert int(opt["step"]) == int(jopt["step"])
        assert _worst(tp, flatten_tree(jax.tree.map(np.asarray, jp))) \
            <= OPT_TOL
        for k in ("m", "v"):
            assert _worst(opt[k], flatten_tree(
                jax.tree.map(np.asarray, jopt[k]))) <= OPT_TOL


@pytest.mark.parametrize("kw", [dict(lr=1.0, warmup_steps=10,
                                     total_steps=100, min_lr_ratio=0.1),
                                dict(), dict(warmup_steps=0, total_steps=1)])
def test_lr_schedule_equals_the_references(kw):
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for step in (0, 1, 5, 10, 55, 100, 101, 10_000, 20_000):
        got = adamw.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = jadamw.lr_schedule(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= OPT_TOL * abs(float(want)) \
            + 1e-12, (step, float(got), float(want))
    if kw.get("lr") == 1.0:
        assert float(adamw.lr_schedule(cfg, 0)) == 0.0
        assert float(adamw.lr_schedule(cfg, 10)) == pytest.approx(1.0)
        assert float(adamw.lr_schedule(cfg, 100)) == pytest.approx(0.1)


def test_adamw_minimizes_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=100, min_lr_ratio=1.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    opt = adamw.init_opt_state(params)
    for _ in range(60):
        params, opt, _ = adamw.adamw_update(cfg, params,
                                            {"x": 2 * params["x"]}, opt)
    assert float(params["x"].abs().max()) < 0.5


def test_int8_error_feedback_equals_the_references():
    rng = np.random.default_rng(3)
    g = {"a": (rng.normal(size=(64, 32)) * 1e-3).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(np.float32)}
    jerr = jadamw.init_error_state(jax.tree.map(jnp.asarray, g))
    err = adamw.init_error_state({k: torch.from_numpy(v)
                                  for k, v in g.items()})
    for step in range(3):
        gs = {k: v * (step + 1) for k, v in g.items()}
        jq, js, jerr = jadamw.ef_compress_tree(gs, jerr)
        q, s, err = adamw.ef_compress_tree(
            {k: torch.from_numpy(v) for k, v in gs.items()}, err)
        for k in g:
            assert q[k].dtype == torch.int8
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
            assert _rel(s[k], js[k]) <= OPT_TOL
            np.testing.assert_allclose(err[k].numpy(), np.asarray(jerr[k]),
                                       rtol=0, atol=OPT_TOL
                                       * float(np.abs(gs[k]).max()))
            deq = adamw.decompress_int8(q[k], s[k])
            assert _rel(deq, jadamw.decompress_int8(jq[k], js[k])) \
                <= OPT_TOL


# ---------------------------------------------------------------------------
# gradients, remat
# ---------------------------------------------------------------------------

def _port_grads(cfg, model, batch):
    model.requires_grad_(True)
    loss, _ = model_api(cfg).loss_fn(model, steps.to_device(batch, "cpu"),
                                     use_kernels=False)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()],
                                allow_unused=True, materialize_grads=True)
    return loss, dict(zip(names, grads))


@pytest.mark.parametrize("arch,batch,seq", GRAD_CASES)
def test_gradients_equal_jax_grad(arch, batch, seq):
    jc, jp, pc, model = _pair(arch)
    b = _batch(pc, batch, seq)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmodel_api(jc).loss_fn(p, b), has_aux=True)(
            jax.tree.map(jnp.asarray, jp))
    loss, grads = _port_grads(pc, model, b)
    assert _rel(loss, jl) <= GRAD_TOL
    want = _by_name(jc, jg)
    errs = {k: _rel(grads[k], want[k]) for k in want}
    assert sorted(grads) == sorted(want)
    assert max(errs.values()) <= GRAD_TOL, sorted(
        errs.items(), key=lambda kv: -kv[1])[:5]
    assert all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b",
                                  "whisper-small"])
def test_remat_on_and_off_give_equal_gradients(arch):
    """Recomputing each layer in the backward pass changes no gradient
    (the reduced configs turn remat off; the full ones have it on)."""
    pc = get_config(arch).reduced().replace(compute_dtype="float32")
    model = model_api(pc).init_params(torch.Generator().manual_seed(0))
    b = _batch(pc, 2, 64)
    l0, g0 = _port_grads(pc, model, b)
    l1, g1 = _port_grads(pc.replace(remat=True), model, b)
    assert torch.equal(l0, l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# train steps, Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_micro", [("smollm-135m", 1),
                                          ("mamba2-370m", 2)])
def test_three_train_steps_equal_the_references(arch, n_micro, tmp_path):
    """``make_train_step`` against the reference's ``Trainer.step_fn``
    (n_micro 1) or ``make_train_bundle``'s step (n_micro 2), from the same
    parameters and batches (tokens and labels: the bundle's inputs).

    Adam's ``eps`` is 1e-6 here, not the default 1e-8: an element whose
    gradient is near ``eps`` moves by ``lr / eps`` times its gradient's
    absolute error, and a near-zero gradient carries f32 noise of about
    1e-9 in either package; at 1e-8 that moves such a parameter by 1e-4
    of its leaf's largest value, at 1e-6 by 1e-6."""
    jc, jp, pc, model = _pair(arch)
    B, S = 4, 32
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3, eps=1e-6)
    data = jpipe.DataConfig(vocab=jc.vocab, seq_len=S, global_batch=B)
    if n_micro == 1:
        jstep = JTrainer(jc, data, JTrainConfig(
            steps=3, ckpt_dir=str(tmp_path), async_ckpt=False,
            opt=jadamw.AdamWConfig(**kw))).step_fn
    else:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                 ("data", "model"))
        jstep = make_train_bundle(jc, ShapeConfig("t", S, B, "train"), mesh,
                                  n_micro=n_micro,
                                  opt_cfg=jadamw.AdamWConfig(**kw)).fn
    jstate = {"params": jax.tree.map(jnp.asarray, jp),
              "opt": jadamw.init_opt_state(jax.tree.map(jnp.asarray, jp))}
    step_fn = steps.make_train_step(pc, adamw.AdamWConfig(**kw),
                                    n_micro=n_micro)
    state = steps.train_state(model)
    for i in range(3):
        b = {k: v for k, v in jpipe.make_batch(data, i).items()
             if k != "mask"}
        jstate, jm = jstep(jstate, b)
        state, m = step_fn(state, steps.to_device(b, "cpu"))
        for k in ("loss", "grad_norm", "lr"):
            assert _rel(m[k], jm[k]) <= GRAD_TOL, (i, k, m[k], jm[k])
    tree = steps.state_tree(state)
    assert _worst(tree["params"], _by_name(jc, jstate["params"])) <= GRAD_TOL
    for k in ("m", "v"):
        assert _worst(tree["opt"][k], _by_name(jc, jstate["opt"][k])) \
            <= GRAD_TOL
    assert int(tree["opt"]["step"]) == int(jstate["opt"]["step"]) == 3


def test_train_step_refuses_zero1_and_takes_no_kernel():
    """ZeRO-1 shards the moments over a mesh: the unsharded step refuses
    it and names the bundle that takes it
    (``tests/test_torch_sharding.py`` runs that one)."""
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(ValueError, match=r"make_train_bundle\(.*zero1=True"):
        steps.make_train_step(cfg, zero1=True)
    assert steps.batch_axes(cfg, "train") == {"tokens": ("batch", "seq"),
                                              "labels": ("batch", "seq")}
    w = get_config("whisper-small")
    assert steps.batch_axes(w, "prefill") == {
        "embeds": ("batch", "seq", "embed"), "tokens": ("batch", "seq")}


def _tiny_cfg():
    return get_config("smollm-135m").reduced().replace(
        n_layers=2, d_model=64, vocab=256, d_ff=128)


def _trainer(tmp, steps_, ckpt_every, lr=1e-3, warmup=2, total=10):
    cfg = _tiny_cfg()
    return Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=4), TrainConfig(
        steps=steps_, ckpt_every=ckpt_every, ckpt_dir=str(tmp),
        log_every=100, async_ckpt=False,
        opt=adamw.AdamWConfig(lr=lr, warmup_steps=warmup,
                              total_steps=total)), device="cpu")


def test_crash_restart_resumes_exactly(tmp_path, capsys):
    """10 straight steps == 5 steps + 'crash' + restart of 5 more."""
    out_a = _trainer(tmp_path / "a", 10, 100).run(resume=False)
    _trainer(tmp_path / "b", 5, 5).run(resume=False)
    out_b = _trainer(tmp_path / "b", 10, 5).run(resume=True)
    assert "[trainer] resumed from step 5" in capsys.readouterr().out
    np.testing.assert_allclose(out_a["losses"][5:], out_b["losses"],
                               rtol=1e-5, atol=1e-6)
    assert out_b["final_step"] == 10 and len(out_b["losses"]) == 5


def test_training_loss_decreases(tmp_path):
    out = _trainer(tmp_path, 30, 100, lr=3e-3, warmup=5, total=30) \
        .run(resume=False)
    losses = out["losses"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_straggler_watchdog():
    wd = StragglerWatchdog(factor=2.0)
    for _ in range(5):
        wd.observe(0.1)
    assert wd.observe(0.5) is True
    assert wd.slow_steps == 1
    assert wd.observe(0.1) is False


def test_trainer_on_the_card_without_one_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot show")
    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2),
                TrainConfig(ckpt_dir=str(tmp_path)))


def test_train_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--reduced", "--arch",
                      "mamba2-370m", "--steps", "3", "--batch", "2", "--seq",
                      "32", "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "[trainer] {\"step\": 0" in text and "[train] done" in text
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000003.json", "ckpt_00000003.npz"]


@pytest.mark.parametrize("arch", sorted(a for a in all_archs()
                                        if get_config(a).family != "encdec"))
def test_lm_fingerprints_unchanged(arch):
    """``remat`` reaches no workload graph: every ``lm:`` spec keeps the
    reference's fingerprint."""
    spec = f"lm:{arch}:seq=64,n_layers=2"
    assert graph_fingerprint(make_workload(spec)) \
        == jgraph_fingerprint(jmake_workload(spec))
