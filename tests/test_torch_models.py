"""The port's model stack (``repro_torch.models``) against the reference's
(``repro.models``) on the CPU, from the reference's own initialized
parameters carried across by ``params_from_jax``.

Tolerances, relative to the largest reference logit:
  * f32 compute: 1e-4 (forward, loss); 1e-3 for prefill and decode, whose
    KV and conv caches are bf16 in both packages: an f32 value that rounds
    to the other side of a bf16 boundary moves that cache entry by a bf16
    ulp (2^-8 of it);
  * bf16 compute: 2e-2, or the reference's own bf16-vs-f32 gap on the same
    input where that is larger.  bf16 roundings that differ in a few
    elements per layer (sums taken in another order) compound over the
    layers, and a top-k router can flip on a near tie; the reference's
    gap between its bf16 and f32 logits measures that noise on the input.
  * the port's own decode-vs-full invariant: the reference's test
    (``tests/test_models.py``: atol = rtol = 2e-2, f32 compute, bf16 KV
    cache, capacity factor 8 for MoE).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jall_archs
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.models import model_api as jmodel_api
from repro.nn.params import count_params as jcount_params
from repro_torch.configs import all_archs, get_config
from repro_torch.models import lm, model_api
from repro_torch.models.convert import (flatten_tree, params_from_jax,
                                        split_blocks)
from repro_torch.models.frontends import (fake_audio_frames,
                                          fake_patch_embeddings)
from repro_torch.nn.params import count_params

FAMILIES = ["smollm-135m", "qwen3-0.6b", "mamba2-370m", "zamba2-1.2b",
            "phi3.5-moe-42b-a6.6b"]
F32_TOL = 1e-4
CACHED_F32_TOL = 1e-3
BF16_TOL = 2e-2


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(arch, compute_dtype="float32", **kw):
    """The reference's and the port's model on the reference's params."""
    jc = jget_config(arch).reduced().replace(compute_dtype=compute_dtype,
                                             **kw)
    pc = get_config(arch).reduced().replace(compute_dtype=compute_dtype,
                                            **kw)
    jp, _ = jmodel_api(jc).init_params(jax.random.PRNGKey(0))
    return jc, jp, pc, params_from_jax(pc, jax.tree.map(np.asarray, jp))


def test_configs_equal_the_references():
    assert all_archs() == jall_archs()
    for name in all_archs():
        for c, r in ((get_config(name), jget_config(name)),
                     (get_config(name).reduced(),
                      jget_config(name).reduced())):
            ours = dataclasses.asdict(c)
            theirs = {k: v for k, v in dataclasses.asdict(r).items()
                      if k != "remat"}
            assert ours == theirs, name
            assert (c.param_count(), c.padded_vocab, c.n_shared_attn(),
                    c.hd) == (r.param_count(), r.padded_vocab,
                              r.n_shared_attn(), r.hd)


@pytest.mark.parametrize("arch", FAMILIES + ["paper-transformer"])
def test_parameter_names_shapes_and_counts(arch):
    """The port's parameters are the reference's pytree split along the
    stacked layer axis, name for name, shape and dtype for dtype;
    ``count_params`` equals the reference's over its pytree, and
    ``param_count`` (the analytic count, which leaves out the final and
    qk norms' scales in both packages) the reference's."""
    jc, jp, pc, m = _pair(arch)
    want = {k: (tuple(np.shape(v)), str(np.asarray(v).dtype)) for k, v in
            flatten_tree(split_blocks(jax.tree.map(np.asarray, jp))).items()}
    got = {k: (tuple(p.shape), str(p.dtype).rsplit(".", 1)[-1])
           for k, p in m.named_parameters()}
    assert got == want
    assert count_params(m) == jcount_params(jp)
    assert pc.param_count() == jc.param_count()


def test_init_params_draws_every_parameter_with_the_references_shapes():
    """``init_params`` from a seeded generator: the reference's names and
    shapes, finite values, the deterministic ones equal (norm scales 1,
    ``A_log``, ``D``), the random ones at the reference's scale; the same
    seed gives the same model."""
    cfg = get_config("zamba2-1.2b").reduced()
    jp, _ = jmodel_api(jget_config("zamba2-1.2b").reduced()) \
        .init_params(jax.random.PRNGKey(0))
    ref = flatten_tree(split_blocks(jax.tree.map(np.asarray, jp)))
    m = model_api(cfg).init_params(torch.Generator().manual_seed(0))
    again = model_api(cfg).init_params(torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(m.named_parameters(),
                                 again.named_parameters()):
        want = ref[name]
        assert tuple(p.shape) == want.shape and torch.isfinite(p).all()
        assert torch.equal(p, q)
        if name.endswith(("scale", "A_log", ".D", "conv_b")):
            np.testing.assert_allclose(p.numpy(), want, rtol=1e-6)
        elif want.size > 64:
            assert abs(p.std().item() / want.std() - 1) < 0.25, name


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_and_loss(arch, compute_dtype):
    jc, jp, pc, m = _pair(arch, compute_dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, pc.vocab, (2, 32)).astype(np.int32)
    labels = rng.integers(0, pc.vocab, (2, 32)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels)}
    want = jax.jit(lambda p, b: jlm.forward(jc, p, b)[0])(jp, jb)
    got, _, _ = lm.forward(pc, m, tb)
    jloss, jmet = jax.jit(lambda p, b: jlm.loss_fn(jc, p, b))(jp, jb)
    loss, met = lm.loss_fn(pc, m, tb)
    if compute_dtype == "float32":
        tol = F32_TOL
    else:
        jf = jc.replace(compute_dtype="float32")
        f32 = jax.jit(lambda p, b: jlm.forward(jf, p, b)[0])(jp, jb)
        tol = max(BF16_TOL, _rel(f32, want))
    assert _rel(got, want) <= tol
    for a, b in ((loss, jloss), (met["nll"], jmet["nll"]),
                 (met["aux"], jmet["aux"])):
        assert abs(float(a) - float(b)) <= tol * max(abs(float(b)), 1.0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_the_reference(arch):
    """Prefill of 24 tokens then 4 decode steps, f32 compute, the logits
    of each against the reference's, and the cache's ``pos``."""
    kw = {"capacity_factor": 8.0} if "moe" in arch else {}
    jc, jp, pc, m = _pair(arch, **kw)
    ja, pa = jmodel_api(jc), model_api(pc)
    B, S = 2, 24
    toks = np.random.default_rng(1).integers(0, pc.vocab, (B, S + 4)) \
        .astype(np.int32)
    jcache, _ = ja.init_cache(B, S + 4, S)
    cache = pa.init_cache(B, S + 4, S)
    jlg, jcache = jax.jit(ja.prefill)(jp, {"tokens": jnp.asarray(
        toks[:, :S])}, jcache)
    lg, cache = pa.prefill(m, {"tokens": torch.from_numpy(toks[:, :S])},
                           cache)
    assert _rel(lg, jlg) <= CACHED_F32_TOL and cache["pos"] == S
    step = jax.jit(ja.decode_step)
    for t in range(S, S + 4):
        jlg, jcache = step(jp, jnp.asarray(toks[:, t:t + 1]), jcache)
        lg, cache = pa.decode_step(m, torch.from_numpy(toks[:, t:t + 1]),
                                   cache)
        assert _rel(lg, jlg) <= CACHED_F32_TOL
        assert cache["pos"] == int(jcache["pos"]) == t + 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_full_forward(arch):
    """The reference's serving invariant on the port alone: prefill(8) + 4
    decode steps give the full forward's logits."""
    cfg = get_config(arch).reduced().replace(compute_dtype="float32")
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=8.0)
    api = model_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0))
    B, S = 1, 12
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    full, _, _ = lm.forward(cfg, params, {"tokens": toks})
    cache = api.init_cache(B, S + 4, S)
    lg, cache = api.prefill(params, {"tokens": toks[:, :8]}, cache)
    np.testing.assert_allclose(lg.numpy(), full[:, 7].numpy(), atol=2e-2,
                               rtol=2e-2)
    for t in range(8, S):
        lg, cache = api.decode_step(params, toks[:, t:t + 1], cache)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   atol=2e-2, rtol=2e-2)


def test_forward_with_a_cache_and_no_update_leaves_the_cache():
    """Without ``update_cache`` the forward works on a copy, as the
    reference's immutable arrays do; with it, the cache's tensors are
    written in place and ``pos`` advances."""
    cfg = get_config("zamba2-1.2b").reduced().replace(
        compute_dtype="float32")
    api = model_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0))
    cache = api.init_cache(2, 16)
    toks = torch.ones((2, 5), dtype=torch.int32)
    before = [t.clone() for t in (cache["kv"]["k"], cache["ssm"]["state"])]
    _, _, none = lm.forward(cfg, params, {"tokens": toks}, cache=cache)
    assert none is None and cache["pos"] == 0
    assert all(torch.equal(a, b) for a, b in
               zip(before, (cache["kv"]["k"], cache["ssm"]["state"])))
    _, new = api.prefill(params, {"tokens": toks}, cache)
    assert new["pos"] == 5 and new["kv"]["k"] is cache["kv"]["k"]
    assert cache["kv"]["k"][:, :, :5].abs().sum() > 0


def test_embeds_input_and_frontends():
    """A batch of ``embeds`` (the frontend stubs' output) in place of
    tokens, against the reference on the same embeddings."""
    jc, jp, pc, m = _pair("smollm-135m")
    g = torch.Generator().manual_seed(0)
    for fake in (fake_patch_embeddings, fake_audio_frames):
        emb = fake(g, 2, 6, pc.d_model)
        assert tuple(emb.shape) == (2, 6, pc.d_model)
        assert 0.01 < emb.std().item() < 0.03
        got, _, _ = lm.forward(pc, m, {"embeds": emb})
        want = jlm.forward(jc, jp, {"embeds": jnp.asarray(emb.numpy())})[0]
        assert _rel(got, want) <= F32_TOL


def test_params_from_jax_keeps_bf16_parameters_bit_for_bit():
    """A bf16 pytree (``param_dtype="bfloat16"``) crosses as bf16, every
    bit kept, and the model built from it computes."""
    jc = jget_config("mamba2-370m").reduced().replace(
        param_dtype="bfloat16")
    pc = get_config("mamba2-370m").reduced().replace(param_dtype="bfloat16")
    jp, _ = jmodel_api(jc).init_params(jax.random.PRNGKey(0))
    tree = flatten_tree(split_blocks(jax.tree.map(np.asarray, jp)))
    m = params_from_jax(pc, jax.tree.map(np.asarray, jp))
    for name, p in m.named_parameters():
        want = tree[name]
        assert p.dtype == (torch.bfloat16 if want.dtype.name == "bfloat16"
                           else torch.float32), name
        assert np.array_equal(p.float().numpy(), want.astype(np.float32))
    toks = torch.ones((1, 8), dtype=torch.int32)
    assert torch.isfinite(lm.forward(pc, m, {"tokens": toks})[0]).all()


def test_encdec_model_api_builds_whisper():
    """``model_api`` builds the encoder-decoder family (``whisper-small``):
    its cache holds ``enc_len`` frames, by default ``min(max_seq, 1500)``
    as the reference's, and a prefill of frames and tokens gives the last
    position's logits (``tests/test_torch_encdec.py`` holds its numbers to
    the reference's)."""
    cfg = get_config("whisper-small").reduced()
    api = model_api(cfg)
    m = api.init_params(torch.Generator().manual_seed(0))
    for max_seq, enc_len, want in ((64, None, 64), (2000, None, 1500),
                                   (64, 7, 7)):
        cache = api.init_cache(2, max_seq, enc_len)
        assert cache["enc_out"].shape == (2, want, cfg.d_model)
        assert cache["kv"]["k"].shape == (cfg.n_layers, 2, max_seq,
                                          cfg.n_kv, cfg.hd)
    batch = {"embeds": torch.zeros((2, 5, cfg.d_model)),
             "tokens": torch.ones((2, 5), dtype=torch.int32)}
    logits, cache = api.prefill(m, batch, api.init_cache(2, 16))
    assert logits.shape == (2, cfg.padded_vocab) and cache["pos"] == 5
    assert torch.isfinite(logits).all()
