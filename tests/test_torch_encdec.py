"""The port's encoder-decoder (``repro_torch.models.encdec``, the
``whisper-small`` backbone) against the reference's
(``repro.models.encdec``) on the CPU, on ``whisper-small.reduced()`` in f32
compute with the reference's weights carried over by ``params_from_jax``.

Tolerances are the model tests' (``tests/test_torch_models.py``): the
encoder, the decoder and the loss within 1e-4 relative to the largest
value; a prefill and four cached decode steps within 1e-3.  The plain
flash route is compared too, by forcing the flash path in both packages
(the reference's ``force_flash``) at shapes under the rule.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.encdec as jenc
import repro.nn.attention as jattn
from repro.configs import get_config as jget_config
from repro.models import model_api as jmodel_api
from repro.runtime import serve_loop as jserve
import repro_torch.models.encdec as penc
import repro_torch.nn.attention as pattn
from repro_torch.configs import get_config
from repro_torch.models import model_api
from repro_torch.models.convert import (flatten_tree, params_from_jax,
                                        split_blocks)
from repro_torch.nn.params import count_params
from repro_torch.runtime.serve_loop import ModelWaveExecutor, Request, Server

ARCH = "whisper-small"
F32_TOL = 1e-4
CACHED_F32_TOL = 1e-3
B, FRAMES, TOKENS = 2, 24, 10


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _pair(compute_dtype="float32"):
    jc = jget_config(ARCH).reduced().replace(compute_dtype=compute_dtype)
    pc = get_config(ARCH).reduced().replace(compute_dtype=compute_dtype)
    jp, _ = jmodel_api(jc).init_params(jax.random.PRNGKey(0))
    return jc, jp, pc, params_from_jax(pc, jax.tree.map(np.asarray, jp))


def _inputs(seed=0, frames=FRAMES, tokens=TOKENS, vocab=512, d=128):
    rng = np.random.default_rng(seed)
    emb = (rng.standard_normal((B, frames, d)) * 0.02).astype(np.float32)
    toks = rng.integers(1, vocab, size=(B, tokens)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(B, tokens)).astype(np.int32)
    return emb, toks, labels


@pytest.fixture
def forced_flash(monkeypatch):
    """Both packages take the flash path wherever a query block has more
    than one row (the reference's ``force_flash=True``)."""
    for mod in (jattn, jenc, pattn, penc):
        orig = mod.multihead_attention
        monkeypatch.setattr(mod, "multihead_attention", functools.partial(
            orig, force_flash=True))


def test_parameter_names_shapes_and_counts():
    jc, jp, pc, m = _pair()
    tree = flatten_tree(split_blocks(split_blocks(
        jax.tree.map(np.asarray, jp), "enc_blocks"), "dec_blocks"))
    got = dict(m.named_parameters())
    assert set(got) == set(tree)
    for name, p in got.items():
        assert np.array_equal(p.numpy(), tree[name]), name
    assert count_params(m) == sum(x.size for x in jax.tree.leaves(jp))
    assert len(m.enc_blocks) == pc.n_enc_layers == 2
    assert len(m.dec_blocks) == pc.n_layers == 2
    full = get_config(ARCH)
    assert (full.n_enc_layers, full.n_layers, full.d_model, full.n_heads,
            full.d_ff, full.vocab, full.padded_vocab) == \
        (12, 12, 768, 12, 3072, 51865, 51968)


def test_init_params_draws_the_references_shapes():
    pc = get_config(ARCH).reduced()
    m = model_api(pc).init_params(torch.Generator().manual_seed(0))
    jc = jget_config(ARCH).reduced()
    jp, _ = jmodel_api(jc).init_params(jax.random.PRNGKey(0))
    tree = flatten_tree(split_blocks(split_blocks(
        jax.tree.map(np.asarray, jp), "enc_blocks"), "dec_blocks"))
    for name, p in m.named_parameters():
        assert tuple(p.shape) == tree[name].shape, name
        assert torch.isfinite(p).all(), name
    w = m.dec_blocks[0].cross_attn.wq.w
    assert abs(float(w.std()) - pc.d_model ** -0.5) < 0.02
    assert float(m.enc_norm.scale.min()) == 1.0


@pytest.mark.parametrize("offset", [0, 7])
def test_sinusoidal_positions_equal_the_reference(offset):
    got = penc.sinusoidal(33, 128, offset)
    want = np.asarray(jenc.sinusoidal(33, 128, jnp.int32(offset)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("flash", [False, True])
def test_encode_matches_the_reference(request, flash):
    if flash:
        request.getfixturevalue("forced_flash")
    jc, jp, pc, m = _pair()
    emb, _, _ = _inputs()
    want = jenc.encode(jc, jp, jnp.asarray(emb))
    got = penc.encode(pc, m, torch.from_numpy(emb))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("flash", [False, True])
def test_decode_matches_the_reference(request, flash):
    if flash:
        request.getfixturevalue("forced_flash")
    jc, jp, pc, m = _pair()
    emb, toks, _ = _inputs(1)
    enc = np.asarray(jenc.encode(jc, jp, jnp.asarray(emb)))
    want, _ = jenc.decode(jc, jp, jnp.asarray(toks), jnp.asarray(enc))
    got, cache = penc.decode(pc, m, torch.from_numpy(toks),
                             torch.from_numpy(enc))
    assert cache is None
    assert got.shape == (B, TOKENS, pc.padded_vocab)
    assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("flash", [False, True])
def test_loss_fn_matches_the_reference(request, flash):
    if flash:
        request.getfixturevalue("forced_flash")
    jc, jp, pc, m = _pair()
    emb, toks, labels = _inputs(2)
    mask = (np.arange(TOKENS)[None] < np.array([[TOKENS], [6]])) \
        .astype(np.float32)
    for extra in ({}, {"mask": mask}):
        jb = {"embeds": jnp.asarray(emb), "tokens": jnp.asarray(toks),
              "labels": jnp.asarray(labels),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
        pb = {"embeds": torch.from_numpy(emb),
              "tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels),
              **{k: torch.from_numpy(v) for k, v in extra.items()}}
        want, wm = jmodel_api(jc).loss_fn(jp, jb)
        got, gm = model_api(pc).loss_fn(m, pb)
        assert abs(float(got) - float(want)) <= F32_TOL * abs(float(want))
        assert float(gm["aux"]) == float(wm["aux"]) == 0.0


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_and_decode_steps_match_the_reference(request, flash):
    """``model_api``'s prefill (which stores the encoder states in the
    cache) and four cached decode steps fed the reference's greedy
    tokens."""
    if flash:
        request.getfixturevalue("forced_flash")
    jc, jp, pc, m = _pair()
    emb, toks, _ = _inputs(3)
    japi, api = jmodel_api(jc), model_api(pc)
    jcache, _ = japi.init_cache(B, 32)
    cache = api.init_cache(B, 32)
    assert cache["enc_out"].shape == (B, 32, pc.d_model)
    assert cache["enc_out"].dtype == torch.bfloat16
    want, jcache = japi.prefill(jp, {"embeds": jnp.asarray(emb),
                                     "tokens": jnp.asarray(toks)}, jcache)
    got, cache = api.prefill(m, {"embeds": torch.from_numpy(emb),
                                 "tokens": torch.from_numpy(toks)}, cache)
    assert _rel(got, want) <= CACHED_F32_TOL
    assert cache["enc_out"].shape == (B, FRAMES, pc.d_model)
    np.testing.assert_allclose(                  # within a bf16 rounding
        cache["enc_out"].float().numpy(),
        np.asarray(jcache["enc_out"].astype(jnp.float32)), rtol=2 ** -7,
        atol=1e-6)
    for step in range(4):
        cur = np.asarray(jnp.argmax(want, -1)).astype(np.int32)[:, None]
        want, jcache = japi.decode_step(jp, jnp.asarray(cur), jcache)
        got, cache = api.decode_step(m, torch.from_numpy(cur), cache)
        assert _rel(got, want) <= CACHED_F32_TOL, step
        assert cache["pos"] == int(jcache["pos"]) == TOKENS + step + 1


def test_decode_steps_equal_the_full_decode():
    """Cached decoding equals the uncached decoder on the whole sequence,
    against the bf16 encoder states the cache holds."""
    _, _, pc, m = _pair()
    emb, toks, _ = _inputs(4, tokens=12)
    api = model_api(pc)
    cache = api.init_cache(B, 16)
    _, cache = api.prefill(m, {"embeds": torch.from_numpy(emb),
                               "tokens": torch.from_numpy(toks[:, :8])},
                           cache)
    steps = []
    for t in range(8, 12):
        lg, cache = api.decode_step(m, torch.from_numpy(toks[:, t:t + 1]),
                                    cache)
        steps.append(lg)
    enc = cache["enc_out"].float()
    full, _ = penc.decode(pc, m, torch.from_numpy(toks), enc)
    for i, lg in enumerate(steps):
        assert _rel(lg, full[:, 8 + i].numpy()) <= CACHED_F32_TOL


def test_decode_with_a_cache_and_no_update_leaves_the_cache():
    _, _, pc, m = _pair()
    emb, toks, _ = _inputs(5)
    api = model_api(pc)
    cache = api.init_cache(B, 16)
    _, cache = api.prefill(m, {"embeds": torch.from_numpy(emb),
                               "tokens": torch.from_numpy(toks[:, :4])},
                           cache)
    before = cache["kv"]["k"].clone()
    lg, new = penc.decode(pc, m, torch.from_numpy(toks[:, 4:5]),
                          cache["enc_out"].float(), cache=cache)
    assert new is None and cache["pos"] == 4
    assert torch.equal(cache["kv"]["k"], before)
    stepped, _ = api.decode_step(m, torch.from_numpy(toks[:, 4:5]), cache)
    assert torch.allclose(lg[:, -1], stepped)


def test_bf16_compute_tracks_f32():
    """The served numerics: bf16 compute within 2e-2 of the largest
    logit of f32 compute, the reference's bf16 serving tolerance."""
    _, _, pc, m = _pair()
    emb, toks, _ = _inputs(6)
    batch = {"embeds": torch.from_numpy(emb), "tokens": torch.from_numpy(toks)}
    f32 = model_api(pc).prefill(m, batch, model_api(pc).init_cache(B, 16))[0]
    pc16 = pc.replace(compute_dtype="bfloat16")
    bf16 = model_api(pc16).prefill(m, batch,
                                   model_api(pc16).init_cache(B, 16))[0]
    assert bf16.dtype == torch.float32
    assert _rel(bf16, f32.numpy()) <= 2e-2


def test_server_serves_whisper_as_the_reference():
    """The serve loop on the encoder-decoder, as the reference's: each
    wave's frames are zeros of its padded prompt length (the cache's
    ``cache_len`` frames replaced at prefill), greedy tokens equal in f32
    compute."""
    jc, jp, pc, m = _pair()
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(1, pc.vocab, size=int(rng.integers(4, 20)))
             .astype(np.int32), int(rng.integers(2, 6))) for i in range(5)]
    eos = pc.padded_vocab - 1              # the pad; not drawn on this path
    kw = dict(max_batch=2, max_seq=48, eos_id=eos)
    jsrv, srv = jserve.Server(jc, jp, **kw), Server(pc, m, **kw)
    for rid, prompt, n in reqs:
        jsrv.submit(jserve.Request(rid=rid, prompt=prompt, max_new=n))
        srv.submit(Request(rid=rid, prompt=prompt, max_new=n))
    want = {r.rid: r.tokens for r in jsrv.run_until_empty()}
    got = {r.rid: r.tokens for r in srv.run_until_empty()}
    assert sorted(got) == sorted(want) == list(range(5))
    for rid, _, n in reqs:
        assert len(got[rid]) == n
        np.testing.assert_array_equal(got[rid], want[rid])
    ex = ModelWaveExecutor(pc, m, max_seq=48, cache_len=16)
    cache = ex.api.init_cache(2, ex.max_seq, ex.cache_len)
    assert cache["enc_out"].shape == (2, 16, pc.d_model)
    assert cache["kv"]["k"].shape == (pc.n_layers, 2, 48, pc.n_kv, pc.hd)


def test_kernel_and_plain_routes_agree_on_the_cpu():
    """On CPU tensors ``use_kernels`` changes nothing: both routes run
    the plain versions."""
    _, _, pc, m = _pair()
    emb, toks, _ = _inputs(8)
    api = model_api(pc)
    batch = {"embeds": torch.from_numpy(emb), "tokens": torch.from_numpy(toks)}
    a = api.prefill(m, batch, api.init_cache(B, 16), use_kernels=True)[0]
    b = api.prefill(m, batch, api.init_cache(B, 16), use_kernels=False)[0]
    assert torch.equal(a, b)
