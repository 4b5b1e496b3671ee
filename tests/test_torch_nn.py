"""The port's model layers (``repro_torch.nn``) against the reference's
(``repro.nn``) on the CPU.

The same numpy inputs and the reference's own initialized parameters (as
numpy, loaded by name with ``repro_torch.models.convert.load_tree``) go
through both.  Tolerance: f32 within 1e-5 of the largest reference value
(``_rel``); the port sums in other orders than XLA.  silu and gelu in
bf16 are the reference's op sequences and equal it to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import mamba2 as jmamba
from repro.nn import moe as jmoe
from repro.nn import rope as jrope
from repro_torch.kernels import ops
from repro_torch.models.convert import load_tree
from repro_torch.nn import attention, layers, mamba2, moe, rope
from repro_torch.nn.params import count_params, param_bytes

TOL = 1e-5


def _randn(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tree(p):
    return jax.tree.map(np.asarray, p)


def test_linear_norms_embedding_and_activations():
    rng = np.random.default_rng(0)
    x = _randn(rng, (3, 5, 16))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    p, _ = jlayers.init_linear(jax.random.PRNGKey(0), 16, 24, bias=True)
    p["b"] = jnp.asarray(_randn(rng, (24,)))
    lin = load_tree(layers.Linear(16, 24, bias=True), _tree(p))
    assert _rel(lin(xt, torch.float32),
                jlayers.linear(p, xj, jnp.float32)) <= TOL
    norm = {"scale": _randn(rng, (16,))}
    rms = load_tree(layers.RMSNorm(16), norm)
    assert _rel(rms(xt), jlayers.rmsnorm(norm, xj)) <= TOL
    ln_p = {"scale": _randn(rng, (16,)), "bias": _randn(rng, (16,))}
    ln = load_tree(layers.LayerNorm(16), ln_p)
    assert _rel(ln(xt), jlayers.layernorm(ln_p, xj)) <= TOL
    e, _ = jlayers.init_embedding(jax.random.PRNGKey(1), 40, 16)
    emb = load_tree(layers.Embedding(40, 16), _tree(e))
    toks = rng.integers(0, 40, (3, 5)).astype(np.int32)
    assert _rel(emb(torch.from_numpy(toks), torch.float32),
                jlayers.embed(e, jnp.asarray(toks), jnp.float32)) <= TOL
    assert _rel(emb.unembed(xt, torch.float32),
                jlayers.unembed(e, xj, jnp.float32)) <= TOL
    y = _randn(rng, (3, 5, 16), 3.0)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        a, b = torch.from_numpy(x).to(dt), torch.from_numpy(y).to(dt)
        ja, jb = jnp.asarray(x, jdt), jnp.asarray(y, jdt)
        if dt == torch.bfloat16:        # the same op sequence: bit-equal
            assert np.array_equal(_np(layers.gelu(b)),
                                  _np(jlayers.gelu(jb)))
            assert np.array_equal(_np(layers.swiglu(a, b)),
                                  _np(jlayers.swiglu(ja, jb)))
        else:
            assert _rel(layers.gelu(b), jlayers.gelu(jb)) <= TOL
            assert _rel(layers.swiglu(a, b), jlayers.swiglu(ja, jb)) <= TOL
    labels = rng.integers(0, 16, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = layers.softmax_cross_entropy(
            xt, torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        want = jlayers.softmax_cross_entropy(
            xj, jnp.asarray(labels), None if m is None else jnp.asarray(m))
        assert abs(float(got) - float(want)) <= TOL * abs(float(want))


def test_count_params_and_bytes_over_a_module_or_a_dict():
    lin = layers.Linear(16, 24, bias=True)
    assert count_params(lin) == 16 * 24 + 24
    assert param_bytes(lin) == 4 * count_params(lin)
    d = {"a": torch.zeros(3, 4, dtype=torch.bfloat16), "b": torch.zeros(5)}
    assert count_params(d) == 17 and param_bytes(d) == 2 * 12 + 4 * 5


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = _randn(rng, (2, 7, 3, 16))
    pos = np.arange(5, 12)[None]
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    assert _rel(got, want) <= TOL


def _qkv(rng, B, Sq, Sk, H, KV, D):
    return (_randn(rng, (B, Sq, H, D)), _randn(rng, (B, Sk, KV, D)),
            _randn(rng, (B, Sk, KV, D)))


@pytest.mark.parametrize("Sq,Sk,H,KV,causal,q_offset,kv_len,block", [
    (8, 8, 4, 2, True, 0, None, 4),        # GQA, several blocks
    (5, 24, 4, 4, True, 11, 16, 8),        # cache mode: offset + kv_len
    (6, 20, 2, 1, False, 0, 13, 32),       # one block, padded
    (9, 9, 4, 2, True, 0, None, 5),        # a ragged last block
])
def test_attention_scores_and_flash_block_scan(Sq, Sk, H, KV, causal,
                                               q_offset, kv_len, block):
    """The scores path and the block scan (the flash route's plain
    version), each with the statistics, and ``multihead_attention`` with
    the flash path forced on and off."""
    rng = np.random.default_rng(Sq * Sk + block)
    B, D = 2, 16
    q, k, v = _qkv(rng, B, Sq, Sk, H, KV, D)
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    scale = 1.0 / D ** 0.5
    got = attention._flash_path(
        torch.from_numpy(qg), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=q_offset, kv_len=kv_len, scale=scale,
        block=block)
    want = jattn._flash_path(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=jnp.asarray(q_offset),
        kv_len=None if kv_len is None else jnp.asarray(kv_len),
        scale=scale, block=block)
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL
    msk = np.ones((Sq, Sk), bool)
    if causal:
        msk &= (q_offset + np.arange(Sq))[:, None] >= np.arange(Sk)[None]
    if kv_len is not None:
        msk &= np.arange(Sk)[None] < kv_len
    got = attention._gqa_scores_path(
        torch.from_numpy(qg), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(msk)[None, None, None], scale)
    want = jattn._gqa_scores_path(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(msk)[None, None, None], scale)
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL
    for flash in (True, False):
        kw = dict(n_kv=KV, causal=causal, q_offset=q_offset, kv_len=kv_len,
                  block=block, force_flash=flash, return_stats=True)
        got = attention.multihead_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), **kw)
        want = jattn.multihead_attention(
            *(jnp.asarray(a) for a in (q, k, v)), **kw)
        for a, b in zip(got, want):
            assert _rel(a, b) <= TOL


def test_the_flash_rule_is_the_references():
    """Sq * Sk > 256 * 2048 picks the block scan, never for one query."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 300, 2048, 2, 2, 8)
    got = attention.multihead_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), n_kv=2, block=512)
    want = jattn.multihead_attention(
        *(jnp.asarray(a) for a in (q, k, v)), n_kv=2, block=512)
    assert _rel(got, want) <= TOL


def test_merge_attention():
    rng = np.random.default_rng(3)
    o1, o2 = _randn(rng, (2, 5, 4, 8)), _randn(rng, (2, 5, 4, 8))
    m1, m2 = _randn(rng, (2, 4, 5)), _randn(rng, (2, 4, 5))
    l1, l2 = (np.abs(_randn(rng, (2, 4, 5))) + 0.1 for _ in range(2))
    got = attention.merge_attention(*(torch.from_numpy(a)
                                      for a in (o1, m1, l1, o2, m2, l2)))
    want = jattn.merge_attention(*(jnp.asarray(a)
                                   for a in (o1, m1, l1, o2, m2, l2)))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("qk_norm,qkv_bias", [(False, False), (True, True)])
def test_attention_block_in_both_cache_modes(qk_norm, qkv_bias):
    """No cache; the per-layer ``cache`` (a prefill then a decode step, the
    updated cache against the reference's); ``cache_stack`` (old pages and
    the new segment merged, the stacks written)."""
    rng = np.random.default_rng(4)
    B, S, d, H, KV, hd, smax = 2, 6, 32, 4, 2, 8, 16
    p, _ = jattn.init_attention(jax.random.PRNGKey(2), d, H, KV, hd,
                                qkv_bias=qkv_bias, qk_norm=qk_norm)
    if qkv_bias:
        for w in ("wq", "wk", "wv"):
            p[w]["b"] = jnp.asarray(_randn(rng, p[w]["b"].shape, 0.1))
    mod = load_tree(attention.Attention(d, H, KV, hd, qkv_bias=qkv_bias,
                                        qk_norm=qk_norm), _tree(p))
    kw = dict(compute_dtype=torch.float32)
    jkw = dict(n_heads=H, n_kv=KV, head_dim=hd, compute_dtype=jnp.float32)
    x = _randn(rng, (B, S, d))
    pos = np.arange(S)[None]
    y, _ = mod(torch.from_numpy(x), positions=torch.from_numpy(pos), **kw)
    yj, _ = jattn.attention_block(p, jnp.asarray(x),
                                  positions=jnp.asarray(pos), **jkw)
    assert _rel(y, yj) <= TOL

    cache = attention.init_kv_cache(B, smax, KV, hd)
    jcache = jattn.init_kv_cache(B, smax, KV, hd)
    for start, n in ((0, S), (S, 1)):
        xs = _randn(rng, (B, n, d))
        ps = (start + np.arange(n))[None]
        y, cache = mod(torch.from_numpy(xs), positions=torch.from_numpy(ps),
                       cache=cache, update_cache=True, **kw)
        yj, jcache = jattn.attention_block(
            p, jnp.asarray(xs), positions=jnp.asarray(ps), cache=jcache,
            update_cache=True, **jkw)
        assert _rel(y, yj) <= TOL and cache["pos"] == int(jcache["pos"])
        for key in ("k", "v"):
            assert _rel(cache[key], jcache[key]) <= TOL

    L, li, pos0 = 3, 1, 5
    ks = _randn(rng, (L, B, smax, KV, hd))
    vs = _randn(rng, (L, B, smax, KV, hd))
    x = _randn(rng, (B, 2, d))
    ps = (pos0 + np.arange(2))[None]
    tk, tv = torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())
    y, (tk, tv) = mod(torch.from_numpy(x), positions=torch.from_numpy(ps),
                      cache_stack=(tk, tv, li, pos0), **kw)
    yj, (jk, jv) = jattn.attention_block(
        p, jnp.asarray(x), positions=jnp.asarray(ps),
        cache_stack=(jnp.asarray(ks), jnp.asarray(vs), li, pos0), **jkw)
    assert _rel(y, yj) <= TOL
    assert _rel(tk, jk) <= TOL and _rel(tv, jv) <= TOL


def _ssd_inputs(rng, B, L, H, P, G, N):
    return (_randn(rng, (B, L, H, P)),
            np.abs(_randn(rng, (B, L, H))) * 0.1 + 0.01,
            -np.abs(_randn(rng, (H,))) - 0.1,
            _randn(rng, (B, L, G, N)), _randn(rng, (B, L, G, N)))


@pytest.mark.parametrize("L,G,init", [(300, 1, False), (512, 2, True),
                                      (70, 2, False), (256, 1, True)])
def test_ssd_chunked(L, G, init):
    """The plain version at the reference's chunk (256) and at 128 against
    the reference at 256, and the kernel route (``ops.ssd_chunks`` through
    the wrappers, so their plain versions on the CPU) in chunks of 128: G
    groups, an initial state, a padded last chunk."""
    rng = np.random.default_rng(L + G)
    B, H, P, N = 2, 4, 8, 16
    args = _ssd_inputs(rng, B, L, H, P, G, N)
    h0 = _randn(rng, (B, H, N, P)) if init else None
    want_y, want_h = jmamba.ssd_chunked(
        *(jnp.asarray(a) for a in args), chunk=256,
        init_state=None if h0 is None else jnp.asarray(h0))
    targs = [torch.from_numpy(a) for a in args]
    th0 = None if h0 is None else torch.from_numpy(h0)
    for chunk in (256, 128):
        y, h = mamba2.ssd_chunked(*targs, chunk=chunk, init_state=th0)
        assert _rel(y, want_y) <= TOL and _rel(h, want_h) <= TOL
    y, h = ops.ssd_chunks(*targs, chunk=128, init_state=th0)
    assert _rel(y, want_y) <= TOL and _rel(h, want_h) <= TOL


def test_ssd_decode_step_and_causal_conv():
    rng = np.random.default_rng(5)
    B, H, P, G, N = 2, 4, 8, 2, 16
    x, dt = _randn(rng, (B, H, P)), np.abs(_randn(rng, (B, H))) * 0.1
    A = -np.abs(_randn(rng, (H,)))
    Bm, Cm = _randn(rng, (B, G, N)), _randn(rng, (B, G, N))
    st = _randn(rng, (B, H, N, P))
    got = mamba2.ssd_decode_step(*(torch.from_numpy(a)
                                   for a in (x, dt, A, Bm, Cm, st)))
    want = jmamba.ssd_decode_step(*(jnp.asarray(a)
                                    for a in (x, dt, A, Bm, Cm, st)))
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL
    xc, w, b = _randn(rng, (B, 9, 12)), _randn(rng, (4, 12)), \
        _randn(rng, (12,))
    prev = _randn(rng, (B, 3, 12))
    for pv in (None, prev):
        got = mamba2._causal_conv(*(torch.from_numpy(a) for a in (xc, w, b)),
                                  None if pv is None else torch.from_numpy(pv))
        want = jmamba._causal_conv(*(jnp.asarray(a) for a in (xc, w, b)),
                                   None if pv is None else jnp.asarray(pv))
        for a, b2 in zip(got, want):
            assert _rel(a, b2) <= TOL


@pytest.mark.parametrize("G", [1, 2])
def test_mamba2_block_with_cache(G):
    """No cache; then a prefill into an SSM cache and two decode steps,
    the outputs and the updated caches against the reference's."""
    rng = np.random.default_rng(6 + G)
    d, N, hd, chunk = 32, 16, 8, 8
    p, _ = jmamba.init_mamba2(jax.random.PRNGKey(3), d, d_state=N,
                              headdim=hd, n_groups=G)
    mod = load_tree(mamba2.Mamba2(d, d_state=N, headdim=hd, n_groups=G,
                                  chunk=chunk), _tree(p))
    kw = dict(compute_dtype=torch.float32)
    jkw = dict(d_state=N, headdim=hd, n_groups=G, chunk=chunk,
               compute_dtype=jnp.float32)
    x = _randn(rng, (2, 20, d))
    y, _ = mod(torch.from_numpy(x), **kw)
    yj, _ = jmamba.mamba2_block(p, jnp.asarray(x), **jkw)
    assert _rel(y, yj) <= TOL
    cache = mamba2.init_ssm_cache(2, d, d_state=N, headdim=hd, n_groups=G)
    jcache = jmamba.init_ssm_cache(2, d, d_state=N, headdim=hd, n_groups=G)
    for n in (13, 1, 1):
        xs = _randn(rng, (2, n, d))
        y, cache = mod(torch.from_numpy(xs), cache=cache, update_cache=True,
                       **kw)
        yj, jcache = jmamba.mamba2_block(p, jnp.asarray(xs), cache=jcache,
                                         update_cache=True, **jkw)
        assert _rel(y, yj) <= TOL
        assert cache["conv"].dtype == torch.bfloat16
        for key in ("conv", "state"):
            assert _rel(cache[key], jcache[key]) <= TOL


@pytest.mark.parametrize("T,groups,cf,top_k", [
    (32, 0, 1.25, 2),       # flat dispatch
    (64, 4, 1.25, 2),       # group-local dispatch
    (64, 0, 0.25, 1),       # capacity drops (flat)
    (64, 8, 0.5, 2),        # drops, grouped
    (18, 4, 1.25, 2),       # T % groups != 0: flat
])
def test_moe_block(T, groups, cf, top_k):
    rng = np.random.default_rng(T + groups)
    d, f, E = 16, 32, 4
    p, _ = jmoe.init_moe(jax.random.PRNGKey(4), d, f, E)
    mod = load_tree(moe.MoE(d, f, E), _tree(p))
    x = _randn(rng, (2, T // 2, d))
    kw = dict(n_experts=E, top_k=top_k, capacity_factor=cf,
              dispatch_groups=groups)
    out, aux = mod(torch.from_numpy(x), compute_dtype=torch.float32, **kw)
    jout, jaux = jmoe.moe_block(p, jnp.asarray(x),
                                compute_dtype=jnp.float32, **kw)
    assert _rel(out, jout) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))
