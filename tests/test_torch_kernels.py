"""PyTorch port kernels: the plain versions against the reference Pallas
kernels (interpret mode on the CPU), the CPU dispatch of the wrappers and
their refusal of inputs that require grad, the 3xTF32 arithmetic of the
CUDA kernels emulated on the CPU, the state pass's route rules and shared
memory, and the build's library naming.  The CUDA kernels themselves are held against
the plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.

Inputs are drawn with numpy and handed to both packages.  Tolerances are
those of ``tests/test_kernels.py``: atol 1e-3 / rtol 1e-4 for the f32 GEMM,
2e-5 for f32 attention, 2e-2 for bf16 attention, 0.5 / 5e-2 for the
bf16 GEMM, 1e-4 for the SSD chunk kernel and 2e-4 for the chunked SSD.
"""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mamba_ssd import ssd_chunk_dual as jssd_chunk_dual
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_mha
from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
from repro_torch.kernels import ssd_state
from repro_torch.kernels.ssd_state import smem_bytes, ssd_state_pass
from repro_torch.kernels.tiled_matmul import tiled_matmul


def _randn(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# plain versions vs the reference Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (64, 64, 64, 32, 32, 32),
    (100, 300, 50, 64, 64, 64),     # ragged
    (256, 128, 512, 128, 128, 128),
])
def test_matmul_ref_vs_pallas(M, K, N, bm, bn, bk):
    rng = np.random.default_rng(M + K + N)
    a, b = _randn(rng, (M, K)), _randn(rng, (K, N))
    want = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b),
                                  bm=bm, bn=bn, bk=bk, interpret=True))
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)


def test_matmul_ref_vs_pallas_bf16():
    rng = np.random.default_rng(1)
    a, b = _randn(rng, (128, 128)), _randn(rng, (128, 128))
    want = jops.matmul(jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16), bm=64, bn=64, bk=64,
                       interpret=True)
    got = ref.matmul_ref(torch.from_numpy(a).bfloat16(),
                         torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=0.5, rtol=5e-2)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D", [
    (1, 2, 2, 64, 64, 32),
    (2, 4, 2, 96, 96, 64),      # GQA + non-multiple of block
    (1, 2, 1, 128, 256, 32),    # Sq != Sk
    (2, 8, 8, 64, 64, 128),     # MHA wide head
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_vs_pallas(B, H, KV, Sq, Sk, D, causal):
    rng = np.random.default_rng(B * 1000 + Sq + Sk + D)
    q = _randn(rng, (B, Sq, H, D))
    k = _randn(rng, (B, Sk, KV, D))
    v = _randn(rng, (B, Sk, KV, D))
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=64, bk=64, interpret=True))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert tuple(got.shape) == (B, Sq, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_attention_ref_dtypes_vs_pallas(dtype, atol):
    rng = np.random.default_rng(7)
    q, k, v = (_randn(rng, (1, 2, 64, 32)) for _ in range(3))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(x.transpose(0, 2, 1, 3), jdt) for x in (q, k, v)),
        causal=True, bq=32, bk=32, interpret=True), np.float32)
    got = ref.attention_ref(*(torch.from_numpy(x).to(dtype)
                              for x in (q, k, v)), causal=True)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 1, 3),
                               want, atol=atol, rtol=atol)


def test_attention_ref_equals_reference_oracle():
    """The port's oracle and the JAX oracle agree on the same inputs."""
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, (2, 3, 40, 16)) for _ in range(3))
    for causal in (True, False):
        want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), causal=causal))
        got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def _ssd_inputs(rng, BC, Q, H, P, N):
    """x, cum, Bm, Cm as ``tests/test_kernels.py`` draws them: cum is a
    running sum of negative log-decays."""
    x = _randn(rng, (BC, Q, H, P))
    cum = np.cumsum(-np.abs(_randn(rng, (BC, Q, H))) * 0.1,
                    axis=1).astype(np.float32)
    return x, cum, _randn(rng, (BC, Q, N)), _randn(rng, (BC, Q, N))


@pytest.mark.parametrize("BC,Q,H,P,N", [
    (2, 16, 2, 8, 4),
    (4, 64, 4, 32, 16),
    (1, 128, 8, 64, 32),
    (2, 128, 16, 128, 64),      # the mamba2-370m path's per-chunk shape
    (2, 128, 8, 64, 128),       # mamba2-370m's own state width, P = 64
    (2, 100, 3, 64, 100),       # N between 64 and 128, Q off 16
])
def test_ssd_chunk_ref_vs_pallas(BC, Q, H, P, N):
    rng = np.random.default_rng(BC * Q + H + P + N)
    args = _ssd_inputs(rng, BC, Q, H, P, N)
    yw, sw = jssd_chunk_dual(*(jnp.asarray(a) for a in args), interpret=True)
    y, s = ssd_chunk_dual(*(torch.from_numpy(a) for a in args))
    assert tuple(y.shape) == (BC, Q, H, P) and tuple(s.shape) == (BC, H, N, P)
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), atol=1e-4,
                               rtol=1e-4)


def test_ssd_chunk_ref_equals_reference_oracle():
    """The port's oracle and the JAX oracle agree, and neither the port's
    masked decay nor its output is ever non-finite, also where
    cum_i - cum_j above the diagonal would overflow exp."""
    rng = np.random.default_rng(5)
    x, cum, Bm, Cm = _ssd_inputs(rng, 2, 32, 3, 8, 4)
    want = jref.ssd_chunk_ref(*(jnp.asarray(a) for a in (x, cum, Bm, Cm)))
    got = ref.ssd_chunk_ref(*(torch.from_numpy(a) for a in (x, cum, Bm, Cm)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    steep = np.cumsum(np.full((1, 32, 1), -50.0, np.float32), axis=1)
    y, s = ref.ssd_chunk_ref(*(torch.from_numpy(a) for a in (
        x[:1, :, :1], steep, Bm[:1], Cm[:1])))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


@pytest.mark.parametrize("L,chunk", [(64, 16), (96, 32), (70, 32)])
def test_ssd_forward_vs_pallas(L, chunk):
    rng = np.random.default_rng(L + chunk)
    B, H, P, N = 2, 4, 16, 8
    x = _randn(rng, (B, L, H, P))
    dt = np.abs(_randn(rng, (B, L, H))) * 0.1
    A = -np.abs(_randn(rng, (H,)))
    Bm, Cm = _randn(rng, (B, L, 1, N)), _randn(rng, (B, L, 1, N))
    want, _ = jops.ssd_forward(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                               chunk=chunk, interpret=True)
    got, none = ops.ssd_forward(*(torch.from_numpy(a)
                                  for a in (x, dt, A, Bm, Cm)), chunk=chunk)
    assert none is None and tuple(got.shape) == (B, L, H, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("Sq,Sk,q_offset", [(16, 48, 32), (5, 9, 4),
                                            (8, 8, 0), (6, 30, 10)])
def test_attention_ref_q_offset_vs_reference_attention(Sq, Sk, q_offset):
    """The plain version's causal mask ``q_offset + i >= j`` against the
    reference model's attention at that ``q_offset`` (f32, 2e-5)."""
    from repro.nn.attention import multihead_attention as jmha
    rng = np.random.default_rng(Sq + Sk)
    B, H, D = 2, 3, 16
    q, k, v = (_randn(rng, (B, n, H, D)) for n in (Sq, Sk, Sk))
    want = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_kv=H,
                causal=True, q_offset=q_offset, force_flash=False)
    t = lambda a: torch.from_numpy(a).transpose(1, 2)
    got = ref.attention_ref(t(q), t(k), t(v), causal=True,
                            q_offset=q_offset).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert torch.equal(flash_attention_mha(t(q), t(k), t(v),
                                           q_offset=q_offset),
                       ref.attention_ref(t(q), t(k), t(v),
                                         q_offset=q_offset))


def _state_inputs(rng, B, nc, Q, H, P, N, G, init):
    return [torch.from_numpy(a) for a in (
        _randn(rng, (B, nc, Q, H, P)), _randn(rng, (B, nc, H, N, P)) * 0.1,
        np.cumsum(-np.abs(_randn(rng, (B, nc, Q, H))) * 0.05, axis=2),
        _randn(rng, (B, nc, Q, G, N)))] \
        + [torch.from_numpy(_randn(rng, (B, H, N, P))) if init else None]


@pytest.mark.parametrize("nc,G,init", [(1, 1, False), (3, 2, True),
                                       (4, 1, True)])
def test_ssd_state_ref_vs_reference_ssd_chunked(nc, G, init):
    """``ops.ssd_chunks`` (the kernel route, here through the plain
    versions: ``ssd_chunk_ref`` per group, then ``ssd_state_ref``) gives
    the reference's ``ssd_chunked`` y and final state (f32, 2e-4 as the
    chunked SSD): G groups, an initial state, nc = 1."""
    from repro.nn.mamba2 import ssd_chunked as jssd_chunked
    rng = np.random.default_rng(nc + G)
    B, Q, H, P, N = 2, 16, 4, 8, 12
    L = nc * Q - 3
    x = _randn(rng, (B, L, H, P))
    dt = np.abs(_randn(rng, (B, L, H))) * 0.1
    A = -np.abs(_randn(rng, (H,)))
    Bm, Cm = _randn(rng, (B, L, G, N)), _randn(rng, (B, L, G, N))
    h0 = _randn(rng, (B, H, N, P)) if init else None
    want_y, want_h = jssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=Q,
        init_state=None if h0 is None else jnp.asarray(h0))
    y, h = ops.ssd_chunks(
        *(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=Q,
        init_state=None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=2e-4,
                               rtol=2e-4)


def _split_state_ref(y_intra, S, cum, Cm, init_state=None):
    """The split route's plain versions composed: the states of every
    chunk, then the outputs."""
    h_before, h = ref.ssd_state_scan_ref(S, cum, init_state)
    return ref.ssd_state_out_ref(y_intra, h_before, cum, Cm), h


@pytest.mark.parametrize("nc,G,init,Q", [(1, 1, False, 20), (3, 2, True, 20),
                                         (4, 3, True, 16), (2, 1, True, 36),
                                         (3, 3, False, 12)])
def test_ssd_state_split_refs_vs_reference_ssd_chunked(nc, G, init, Q):
    """``ops.ssd_chunks`` with the split's plain versions as its state pass
    (``ssd_state_scan_ref``, then ``ssd_state_out_ref``) against the
    reference's ``ssd_chunked`` (f32, 1e-4): G 1-3, an initial state,
    nc = 1, Q off 16; and each half against the whole pass's plain
    version (equal)."""
    from repro.nn.mamba2 import ssd_chunked as jssd_chunked
    rng = np.random.default_rng(nc * 10 + G + Q)
    B, H, P, N = 2, 6, 8, 12
    L = nc * Q - 3
    x = _randn(rng, (B, L, H, P))
    dt = np.abs(_randn(rng, (B, L, H))) * 0.1
    A = -np.abs(_randn(rng, (H,)))
    Bm, Cm = _randn(rng, (B, L, G, N)), _randn(rng, (B, L, G, N))
    h0 = _randn(rng, (B, H, N, P)) if init else None
    want_y, want_h = jssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=Q,
        init_state=None if h0 is None else jnp.asarray(h0))
    y, h = ops.ssd_chunks(
        *(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=Q,
        init_state=None if h0 is None else torch.from_numpy(h0),
        chunk_dual=ref.ssd_chunk_ref, state_pass=_split_state_ref)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-4,
                               rtol=1e-4)
    args = _state_inputs(rng, B, nc, Q, H, P, N, G, init)
    for a, b in zip(_split_state_ref(*args), ref.ssd_state_ref(*args)):
        assert torch.equal(a, b)


def test_ssd_state_split_refs_vs_reference_ssd_forward():
    """The split's plain versions under ``ops.ssd_forward`` against the
    reference's jitted ``ssd_forward`` with its Pallas chunk kernel in
    interpret mode (f32, 1e-4), at a padded last chunk."""
    rng = np.random.default_rng(77)
    B, L, H, P, N, chunk = 2, 70, 4, 16, 8, 32
    x = _randn(rng, (B, L, H, P))
    dt = np.abs(_randn(rng, (B, L, H))) * 0.1
    A = -np.abs(_randn(rng, (H,)))
    Bm, Cm = _randn(rng, (B, L, 1, N)), _randn(rng, (B, L, 1, N))
    want, _ = jops.ssd_forward(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                               chunk=chunk, interpret=True)
    got, _ = ops.ssd_forward(*(torch.from_numpy(a)
                               for a in (x, dt, A, Bm, Cm)), chunk=chunk,
                             state_pass=_split_state_ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_state_route_rule_and_declared_kernels():
    """The walk where its B * H * ceil(P / 64) blocks fill their last wave
    of resident walks (two an SM at N <= 64, one above) to at least 5/6,
    else the split; a device that is not a card counts an H100's 132."""
    route = ssd_state.state_route
    assert route(1, 16, 128, 64, 132) == "split"    # 32 of 264
    assert route(4, 64, 64, 64, 132) == "walk"      # zamba2 wave: 256 of 264
    assert route(4, 32, 64, 128, 132) == "walk"     # mamba2-370m: 128 of 132
    assert route(4, 32, 64, 64, 132) == "split"     # 128 of 264
    assert route(2, 56, 64, 128, 132) == "walk"     # 112 of 132
    assert route(3, 32, 64, 128, 132) == "split"    # 96 of 132
    assert route(5, 32, 64, 128, 132) == "split"    # 160: 28 in a second wave
    assert route(4, 64, 64, 128, 132) == "walk"     # 256 in two of 132
    assert route(4, 32, 64, 128, 114) == "split"    # fewer SMs: 128 of 228
    assert ssd_state.walk_slots(64, 132) == 264
    assert ssd_state.walk_slots(128, 132) == 132
    assert ssd_state.sm_count("cpu") == ssd_state.H100_SMS == 132
    assert ssd_state.route_kernels(1, 16, 128, 64, "cpu") == \
        ("ssd_state_scan", "ssd_state_out")
    assert ssd_state.route_kernels(4, 64, 64, 64, "cpu") == \
        ("ssd_state_walk",)
    assert ssd_state.route_kernels(4, 32, 64, 128, "cpu") == \
        ("ssd_state_walk",)


def test_ssd_state_split_wrappers_on_the_cpu_and_off_it():
    """The split's wrappers run their plain versions on CPU tensors,
    uncounted, and raise for a tensor off the CPU."""
    rng = np.random.default_rng(3)
    y, S, cum, C, h0 = _state_inputs(rng, 2, 3, 16, 4, 8, 12, 2, True)
    n0 = (ssd_state.ssd_state_scan.launches, ssd_state.ssd_state_out.launches)
    hb, h = ssd_state.ssd_state_scan(S, cum, h0)
    for a, b in zip((hb, h), ref.ssd_state_scan_ref(S, cum, h0)):
        assert torch.equal(a, b)
    assert torch.equal(ssd_state.ssd_state_out(y, hb, cum, C),
                       ref.ssd_state_out_ref(y, hb, cum, C))
    assert (ssd_state.ssd_state_scan.launches,
            ssd_state.ssd_state_out.launches) == n0
    meta = lambda t: torch.empty(t.shape, device="meta")
    with pytest.raises(ValueError, match="one card"):
        ssd_state.ssd_state_scan(meta(S), meta(cum))
    with pytest.raises(ValueError, match="one card"):
        ssd_state.ssd_state_out(meta(y), meta(hb), meta(cum), meta(C))
    with pytest.raises(ValueError, match="do not agree"):
        ssd_state.ssd_state_out(y, hb[:, :2], cum, C)


def test_ssd_state_pass_cpu_dispatch_and_refusals():
    """CPU tensors run the plain version uncounted; a tensor off the CPU
    goes to the kernel or raises; shapes that do not agree raise on every
    device; the shared memory a shape needs is bounded."""
    rng = np.random.default_rng(0)
    args = _state_inputs(rng, 2, 3, 16, 4, 8, 12, 2, True)
    launches = lambda: [k.launches for k in (ssd_state.ssd_state_walk,
                                             ssd_state.ssd_state_scan,
                                             ssd_state.ssd_state_out)]
    n0 = launches()
    for a, b in zip(ssd_state_pass(*args), ref.ssd_state_ref(*args)):
        assert torch.equal(a, b)
    assert launches() == n0
    meta = [torch.empty(a.shape, device="meta") for a in args]
    with pytest.raises(ValueError, match="one card"):
        ssd_state_pass(*meta)
    with pytest.raises(ValueError, match="one card"):
        ssd_state_pass(meta[0], *args[1:])
    y, S, cum, C, h0 = args
    for bad in ((y[:, :, :, :3], S, cum, C, h0),       # H differs
                (y, S, cum[..., :2], C, h0),
                (y, S, cum, C[:, :, :, :1].repeat(1, 1, 1, 3, 1), h0),
                (y, S[:, :2], cum, C, h0),
                (y, S, cum, C, h0[..., :4]),
                (y[0], S, cum, C, None)):
        with pytest.raises(ValueError, match="ssd_state_pass: shapes"):
            ssd_state_pass(*bad)
    assert launches() == n0
    assert smem_bytes(128, 64) == 4 * (2 * 64 * 72 + 2 * 128 * 68 + 256)
    assert smem_bytes(128, 128) <= 232448 < smem_bytes(128, 256)


def test_state_pass_shared_memory_of_the_split_state_layout():
    """The walk's shared memory: the state tile split in hi and lo (N
    padded to 8, rows of 72 floats), two C buffers (rows of N8 + 4 floats)
    and two cum buffers.  At Q = 128 and N = 64 (zamba2) it stays under
    113 KB, so two blocks share an SM and the 256 walks of the prefill
    wave run in one wave; N = 128 (mamba2-370m) still fits a block; N
    past 128 is out of the kernels' range on the card."""
    assert smem_bytes(128, 64) == 107_520 <= 113 * 1024
    assert smem_bytes(128, 128) == 209_920 <= ssd_state.MAX_SMEM
    assert smem_bytes(70, 13) == 4 * (2 * 16 * 72 + 2 * 70 * 20 + 140)
    assert ssd_state.MAX_STATE == 128


@pytest.mark.parametrize("BC,H,G,P,sms,heads", [
    (32, 32, 1, 64, 132, 4),    # mamba2-370m serve wave: 256 blocks
    (32, 16, 1, 128, 132, 4),   # mamba2-370m realization: 256
    (32, 64, 1, 64, 132, 4),    # zamba2-1.2b prefill wave, split: 512
    (32, 16, 1, 128, 114, 4),   # fewer SMs
    (8, 32, 1, 64, 132, 1),     # one chunk of 4 slots: 256 only at 1 head
    (32, 16, 8, 64, 132, 2),    # G = 8: groups of 2 heads
    (32, 12, 3, 130, 132, 4),   # G = 3: groups of 4, three P tiles
    (64, 12, 2, 64, 132, 2),    # G = 2: groups of 6, 4 does not divide
    (32, 12, 2, 64, 132, 1),    # G = 2: 2 a block would leave 192 blocks
    (32, 6, 3, 64, 132, 1),     # G = 3: groups of 2, too few blocks
    (6, 4, 2, 130, 132, 1),     # the edge shapes: one head a block
])
def test_out_heads_rule(BC, H, G, P, sms, heads):
    """``ssd_state_out`` takes the most of 4, 2 and 1 heads a block that
    divides a group's heads and keeps at least 15/8 blocks an SM."""
    assert ssd_state.out_heads(BC, H, G, P, sms) == heads
    assert (H // G) % heads == 0


@pytest.mark.parametrize("buf_len,copies,splits", [
    (174, 16, 1),       # moe-quick on the reference's test arch
    (952, 16, 1),       # the fused sweep's widest candidate
    (3_619, 16, 1),     # the widest row 16 copies fit
    (3_620, 15, 2),
    (6_638, 8, 2),      # grid_candidates(512), most cores
    (13_138, 4, 4),     # grid_candidates(1024), most cores
    (20_000, 2, 8),
    (57_916, 1, 16),    # the limit: one copy, 16 parts
])
def test_fused_eval_copies_and_splits(monkeypatch, buf_len, copies, splits):
    """A ``fused_eval`` block sums its entries into 16 copies of the row
    or as many as fit (57,916 cells of an H100's shared memory here); a
    row with fewer is cut into enough parts, one block each, that 16 warps
    stream it."""
    from repro_torch.kernels import fused_eval as fe
    monkeypatch.setattr(fe, "max_cells", lambda device: 57_916)
    dev = torch.device("cuda", 0)
    assert fe.copies(dev, buf_len) == copies
    assert fe.splits(dev, buf_len) == splits
    assert copies * buf_len <= 57_916 and copies * splits >= 16


def test_flash_refuses_a_negative_or_fractional_q_offset():
    q = torch.zeros((1, 1, 4, 8))
    for off in (-1, 1.5):
        with pytest.raises(ValueError, match="q_offset"):
            flash_attention_mha(q, q, q, q_offset=off)


# ---------------------------------------------------------------------------
# wrapper dispatch: plain version only for CPU tensors, never a fallback
# ---------------------------------------------------------------------------

def test_refuse_grad_rule_on_cpu_tensors():
    """The wrappers' autograd rule (``_build.refuse_grad``, called for
    tensors on the card): an input that requires grad raises, naming
    ``use_kernels=False``, where autograd is on; not under
    ``torch.no_grad()``, nor where no input requires grad (None skipped).
    CPU tensors that require grad take the plain version, which
    differentiates."""
    a = torch.ones((4, 4), requires_grad=True)
    b = torch.full((4, 3), 2.0)
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        _build.refuse_grad("tiled_matmul", (b, None, a))
    with torch.no_grad():
        _build.refuse_grad("tiled_matmul", (a, b))
    _build.refuse_grad("tiled_matmul", (a.detach(), b, None))
    tiled_matmul(a, b).sum().backward()
    assert torch.equal(a.grad, torch.full((4, 4), 6.0))
    rng = np.random.default_rng(4)
    y, S, cum, C, h0 = _state_inputs(rng, 1, 2, 16, 2, 8, 4, 1, True)
    S.requires_grad_()
    out, h = ssd_state_pass(y, S, cum, C, h0)
    (out.sum() + h.sum()).backward()
    assert S.grad is not None and torch.isfinite(S.grad).all()


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(_randn(rng, (8, 8))) for _ in range(2))
    before = (tiled_matmul.launches, flash_attention_mha.launches)
    assert torch.equal(tiled_matmul(a, b), ref.matmul_ref(a, b))
    q = a.reshape(1, 1, 8, 8)
    assert torch.equal(flash_attention_mha(q, q, q),
                       ref.attention_ref(q, q, q))
    assert (tiled_matmul.launches, flash_attention_mha.launches) == before


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU goes to the kernel or raises: here, on the meta
    device, it raises instead of running the plain version."""
    a = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="one card"):
        tiled_matmul(a, a)
    q = torch.empty((1, 1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="one card"):
        flash_attention_mha(q, q, q)


def test_ssd_chunk_dual_cpu_dispatch_and_refusals():
    """CPU tensors run the plain version uncounted; a tensor off the CPU
    goes to the kernel or raises."""
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a) for a in _ssd_inputs(rng, 2, 16, 2, 8, 4)]
    n0 = ssd_chunk_dual.launches
    for a, b in zip(ssd_chunk_dual(*args), ref.ssd_chunk_ref(*args)):
        assert torch.equal(a, b)
    assert ssd_chunk_dual.launches == n0
    meta = [torch.empty(a.shape, device="meta") for a in args]
    with pytest.raises(ValueError, match="one card"):
        ssd_chunk_dual(*meta)
    with pytest.raises(ValueError, match="one card"):
        ssd_chunk_dual(meta[0], *args[1:])


# ---------------------------------------------------------------------------
# 3xTF32: why the tensor-core kernels split every operand in two
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as the kernels' ``split`` rounds the high part
    (and as ``cvt.rna.tf32.f32`` does): to nearest, ties away from zero.
    Adding half a TF32 ulp to the bit pattern rounds the magnitude; the mask
    clears the low 13 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _cut(x: torch.Tensor) -> torch.Tensor:
    """f32 cut to TF32, the low 13 mantissa bits dropped, as the tensor
    core reads an operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    """The kernels' split (``csrc/tf32x3.cuh``) as the tensor core sees it:
    hi = tf32(x), lo = x - hi (exact) cut to TF32."""
    hi = _tf32(x)
    return hi, _cut(x - hi)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, products: int):
    """a @ b on TF32 tensor cores with f32 accumulators, emulated: one
    product of the rounded operands, or the kernels' three, lo.hi + hi.lo +
    hi.hi.  A product of two TF32 values is exact in f32, so f32 matmuls of
    the parts emulate it."""
    (ahi, alo), (bhi, blo) = _split(a), _split(b)
    if products == 1:
        return ahi @ bhi
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


def test_tf32_split_emulation():
    """Ties round away from zero, below a tie rounds down, and the two
    parts the tensor core reads give back x to about 2^-21 of its size."""
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 3.0],
                     dtype=torch.float32)
    assert _tf32(x).tolist() == [1 + 2**-10, -(1 + 2**-10), 1.0, 3.0]
    y = torch.from_numpy(_randn(np.random.default_rng(0), (4096,)))
    hi, lo = _split(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi + lo - y).abs() <= y.abs() * 2.0**-21).all()
    assert ((hi - y).abs() > y.abs() * 2.0**-13).any()


@pytest.mark.parametrize("K", [512, 1024, 2048])
def test_3xtf32_gemm_meets_the_f32_tolerance_and_one_product_does_not(K):
    """At the realization paths' contraction lengths, the GEMM kernel's
    3xTF32 product stays within the f32 reference's tolerance (atol 1e-3 /
    rtol 1e-4) of the plain f32 product; one TF32 product misses it."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(_randn(rng, (256, K)))
    b = torch.from_numpy(_randn(rng, (K, 256)))
    want = ref.matmul_ref(a, b)
    torch.testing.assert_close(_mm_tf32(a, b, 3), want, atol=1e-3,
                               rtol=1e-4)
    assert not torch.allclose(_mm_tf32(a, b, 1), want, atol=1e-3, rtol=1e-4)


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _mm_3xtf32_steps(a: torch.Tensor, b: torch.Tensor, in_tensor_core):
    """a @ b as the GEMM kernel issues it: k8 steps of three TF32 products,
    each ``mma`` adding its exact products to its accumulator with one
    rounding toward zero (the tensor core's).  ``in_tensor_core``: the
    running sum stays in the mma accumulator; else each step's three
    products go into a zeroed fragment that is added to the sum in f32,
    rounded to nearest (``tf32x3::mma3``)."""
    (ahi, alo), (bhi, blo) = _split(a), _split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        ks = slice(k, k + 8)
        d = acc if in_tensor_core else torch.zeros_like(acc)
        for x, y in ((alo, bhi), (ahi, blo), (ahi, bhi)):
            d = _round_toward_zero(d.double()
                                   + x[:, ks].double() @ y[ks].double())
        acc = d if in_tensor_core else acc + d
    return acc


def test_tensor_core_accumulation_drifts_so_each_step_is_added_in_f32():
    """At K = 2048 a 3xTF32 sum kept inside the tensor core's accumulator,
    which rounds toward zero, drifts past the GEMM tolerance (the kernel did
    so on the card, by 3.7e-3); added step by step in f32 it does not."""
    rng = np.random.default_rng(2048)
    a = torch.from_numpy(_randn(rng, (256, 2048)))
    b = torch.from_numpy(_randn(rng, (2048, 256)))
    want = ref.matmul_ref(a, b)
    torch.testing.assert_close(_mm_3xtf32_steps(a, b, False), want,
                               atol=1e-3, rtol=1e-4)
    assert not torch.allclose(_mm_3xtf32_steps(a, b, True), want,
                              atol=1e-3, rtol=1e-4)


def test_3xtf32_attention_meets_the_f32_tolerance_and_one_product_does_not():
    """At the tf-paper path's shape (4, 4, 512, 128), causal, attention
    with both products in 3xTF32 (the flash kernel's arithmetic: scores
    scaled after the product, -1e30 masking, unnormalized probabilities
    times v, divided by their sum) stays within 2e-5 of the plain version;
    with one TF32 product each it does not."""
    rng = np.random.default_rng(512)
    q, k, v = (torch.from_numpy(_randn(rng, (4, 4, 512, 128)))
               for _ in range(3))
    want = ref.attention_ref(q, k, v, causal=True)
    keep = torch.ones(512, 512, dtype=torch.bool).tril()

    def emulated(products):
        s = _mm_tf32(q, k.transpose(-1, -2), products) \
            * (1.0 / math.sqrt(128))
        s = torch.where(keep, s, torch.full_like(s, -1e30))
        p = (s - s.amax(-1, keepdim=True)).exp()
        return _mm_tf32(p, v, products) / p.sum(-1, keepdim=True)

    torch.testing.assert_close(emulated(3), want, atol=2e-5, rtol=2e-5)
    assert not torch.allclose(emulated(1), want, atol=2e-5, rtol=2e-5)


def _ssd_chunk_tf32(x, cum, Bm, Cm, products: int):
    """The SSD chunk kernel's arithmetic, emulated: scores C Bᵀ, the masked
    W = scores ⊙ exp(cum_i - cum_j) selected to 0 above the diagonal (a
    select, as the kernel does, not a product with a 0/1 mask), y = W x,
    and S = (d ⊙ B)ᵀ x with d_j = exp(cum_last - cum_j), each product in
    one or three TF32 products."""
    Q = x.shape[1]
    keep = torch.ones(Q, Q, dtype=torch.bool).tril()
    scores = _mm_tf32(Cm, Bm.transpose(1, 2), products)[:, None]
    ch = cum.transpose(1, 2)                                # (BC, H, Q)
    decay = (ch[..., :, None] - ch[..., None, :]).exp()     # inf above
    W = torch.where(keep, scores * decay, torch.zeros(()))
    y = _mm_tf32(W, x.permute(0, 2, 1, 3), products).permute(0, 2, 1, 3)
    d = (ch[..., -1:] - ch).exp()                           # (BC, H, Q)
    dB = d[..., None] * Bm[:, None]                         # (BC, H, Q, N)
    S = _mm_tf32(dB.transpose(-1, -2), x.permute(0, 2, 1, 3), products)
    return y, S


def test_3xtf32_ssd_chunk_meets_the_f32_tolerance_and_one_product_does_not():
    """At the mamba2-370m path's per-chunk shape (BC cut to 2), the SSD
    chunk kernel's three products in 3xTF32 stay within 1e-4 of the plain
    version (y about 4e-5 with |y| up to ~140, S about 3e-6); with one TF32
    product each they miss it by far (y about 7e-2, S about 6e-3)."""
    rng = np.random.default_rng(128)
    x, cum, Bm, Cm = (torch.from_numpy(a)
                      for a in _ssd_inputs(rng, 2, 128, 16, 128, 64))
    want = ref.ssd_chunk_ref(x, cum, Bm, Cm)
    got3 = _ssd_chunk_tf32(x, cum, Bm, Cm, 3)
    got1 = _ssd_chunk_tf32(x, cum, Bm, Cm, 1)
    for g3, g1, w in zip(got3, got1, want):
        torch.testing.assert_close(g3, w, atol=1e-4, rtol=1e-4)
        assert not torch.allclose(g1, w, atol=1e-4, rtol=1e-4)
    assert (got1[0] - want[0]).abs().max() > 1e-2


def _state_pass_tf32(y_intra, S, cum, Cm, products: int):
    """The walk's arithmetic, emulated (G = 1): the state held as its TF32
    split, hi and lo = h - hi whole (``csrc/ssd_state.cu`` keeps no other
    copy); per chunk y = y_intra + exp(cum) * (C . h) with the product in
    one TF32 product or the kernels' three (the state's lo cut to TF32 as
    the tensor core reads it), then h = (hi + lo) * exp(cum_last) + S in
    f32.  Returns (y, final state) and whether hi + lo gave back every
    state exactly."""
    B, nc, Q, H, P = y_intra.shape
    h = torch.zeros(B, H, S.shape[3], P)
    exact, ys = True, []
    for c in range(nc):
        hi = _tf32(h)
        lo = h - hi
        exact = exact and torch.equal(hi + lo, h)
        C = Cm[:, c, :, 0]                                  # (B, Q, N)
        e = cum[:, c].exp()                                 # (B, Q, H)
        prod = torch.stack([_mm_tf32(C, hi[:, k] + lo[:, k], products)
                            for k in range(H)], dim=2)      # (B, Q, H, P)
        ys.append(y_intra[:, c] + e[..., None] * prod)
        h = (hi + lo) * cum[:, c, -1].exp()[..., None, None] + S[:, c]
    return torch.stack(ys, dim=1), h, exact


def test_3xtf32_state_pass_meets_the_f32_tolerance_and_one_product_does_not():
    """At the mamba2-370m serve state width (Q = 128, N = 128, P = 64; 8
    chunks, 2 heads, the GPU tests' value ranges) the state pass with its
    product C . h in 3xTF32 stays within 1e-4 of the plain version (y
    about 2e-6 off, |y| up to ~6); with one TF32 product it misses (about
    1.6e-3).  The split state gives back h exactly, so
    the walk's f32 recurrence is the plain version's."""
    rng = np.random.default_rng(128)
    y, S, cum, C, _ = _state_inputs(rng, 1, 8, 128, 2, 64, 128, 1, False)
    want = ref.ssd_state_ref(y, S, cum, C)
    got3 = _state_pass_tf32(y, S, cum, C, 3)
    got1 = _state_pass_tf32(y, S, cum, C, 1)
    assert got3[2] and got1[2]
    for g3, w in zip(got3[:2], want):
        torch.testing.assert_close(g3, w, atol=1e-4, rtol=1e-4)
    assert torch.equal(got1[1], got3[1])   # the states are f32 either way
    assert not torch.allclose(got1[0], want[0], atol=1e-4, rtol=1e-4)


def _ssd_chunk_kernel_emulated(x, cum, Bm, Cm):
    """The SSD chunk kernel's arithmetic since it scores C Bᵀ once for a
    block of heads (``csrc/mamba_ssd.cu``), emulated.  C Bᵀ: from bf16 B
    and C, k16 steps of exact products, each step's sum rounded toward
    zero (the tensor core's) and added in f32; from f32 B and C, 3xTF32.
    The decays as the kernel takes them: on the diagonal 16 x 16 tiles
    exp(cum_i - cum_j), selected to 0 above the diagonal; below them the
    score tile times the column factors exp(m_J - cum_j) before the
    product and its product times the row factors exp(cum_i - m_J) after
    it, m_J the least cum of tile J.  W x and (d ⊙ B)ᵀ x in 3xTF32, one J
    tile at a time, each tile's products added in f32."""
    BC, Q, H, P = x.shape
    N = Bm.shape[2]
    QP = -(-Q // 16) * 16
    nS = QP // 16
    pad = QP - Q
    xh = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    Bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    ch = torch.cat([cum, cum[:, -1:].expand(BC, pad, H)], 1).transpose(1, 2)
    if Bm.dtype == torch.bfloat16:
        s = torch.zeros(BC, QP, QP)
        for k in range(0, N, 16):
            part = Cf[..., k:k + 16].double() \
                @ Bf[..., k:k + 16].double().transpose(1, 2)
            s = s + _round_toward_zero(part)
    else:
        s = _mm_tf32(Cf, Bf.transpose(1, 2), 3)
    s = s[:, None]                                          # (BC, 1, i, j)
    m = ch.reshape(BC, H, nS, 16).amin(-1)                  # (BC, H, nS)
    col = (m.repeat_interleave(16, -1) - ch).exp()          # (BC, H, QP)
    row = (ch[..., :, None] - m[..., None, :]).exp()        # (BC, H, i, J)
    tile = torch.arange(QP) // 16
    keep = torch.ones(QP, QP, dtype=torch.bool).tril() \
        & (tile[:, None] == tile[None, :])
    diag = torch.where(keep, (ch[..., :, None] - ch[..., None, :]).exp(),
                       torch.zeros(()))
    y = torch.zeros(BC, H, QP, P)
    for J in range(nS):
        js = slice(16 * J, 16 * J + 16)
        below = (tile > J)[:, None]
        W = torch.where(below, s[..., js] * col[..., None, js],
                        s[..., js] * diag[..., js])
        W = torch.where((tile >= J)[:, None], W, torch.zeros(()))
        d = _mm_tf32(W, xh[..., js, :], 3)
        scale = torch.where(tile > J, row[..., J], torch.ones(()))
        y = y + scale[..., None] * d
    d_end = torch.where(torch.arange(QP) < Q,
                        (ch[..., Q - 1:Q] - ch).exp(), torch.zeros(()))
    dB = d_end[..., None] * Bf[:, None]                     # (BC, H, QP, N)
    S = torch.zeros(BC, H, N, P)
    for J in range(nS):
        js = slice(16 * J, 16 * J + 16)
        S = S + _mm_tf32(dB[..., js, :].transpose(-1, -2), xh[..., js, :], 3)
    return y[:, :, :Q].permute(0, 2, 1, 3), S


@pytest.mark.parametrize("H,P,N,mixed", [
    (4, 64, 64, True),      # zamba2-1.2b's heads (P = N = 64), 4 of 64
    (4, 64, 128, True),     # mamba2-370m's (P = 64, N = 128), 4 of 32
    (4, 64, 64, False),     # the same in f32
    (2, 128, 64, False),    # the realization shape's (P = 128, N = 64)
])
def test_ssd_chunk_mixed_arithmetic_meets_the_f32_tolerance(H, P, N, mixed):
    """The kernel's arithmetic, emulated at reduced serve shapes (BC 2, Q
    128): bf16 B and C scored with exact bf16 products whose k16 sums the
    tensor core rounds toward zero and the kernel adds in f32, or f32 B and
    C in 3xTF32; the decays factored below the diagonal; W x and
    (d ⊙ B)ᵀ x in 3xTF32.  Within 1e-4 of the plain version on the upcast
    inputs (``SSD_TOL``), and the factored decays within 2e-6 of
    exp(cum_i - cum_j) relative to it."""
    rng = np.random.default_rng(H * P + N)
    x, cum, Bm, Cm = (torch.from_numpy(a)
                      for a in _ssd_inputs(rng, 2, 128, H, P, N))
    if mixed:
        Bm, Cm = Bm.bfloat16(), Cm.bfloat16()
    want = ref.ssd_chunk_ref(x, cum, Bm.float(), Cm.float())
    got = _ssd_chunk_kernel_emulated(x, cum, Bm, Cm)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    ch = cum.transpose(1, 2)
    m = ch.reshape(2, H, 8, 16).amin(-1)
    i, j = 100, 37                        # tile J = 2 below tile I = 6
    factored = (m[..., 2] - ch[..., j]).exp() * (ch[..., i] - m[..., 2]).exp()
    direct = (ch[..., i] - ch[..., j]).exp()
    assert ((factored - direct).abs() <= 2e-6 * direct).all()


def test_ssd_chunk_factored_decays_stay_finite_on_a_steep_decay():
    """cum falling by 50 a row: the row factors exp(cum_i - m_J) below the
    diagonal underflow to 0 with the decays they stand for, the column
    factors are at most 1, and the diagonal tiles select 0 above the
    diagonal: y and S stay finite and equal to the plain version."""
    rng = np.random.default_rng(7)
    x, _, Bm, Cm = (torch.from_numpy(a)
                    for a in _ssd_inputs(rng, 1, 64, 2, 8, 16))
    cum = torch.cumsum(torch.full((1, 64, 2), -50.0), dim=1)
    for bc in (torch.float32, torch.bfloat16):
        got = _ssd_chunk_kernel_emulated(x, cum, Bm.to(bc), Cm.to(bc))
        want = ref.ssd_chunk_ref(x, cum, Bm.to(bc).float(),
                                 Cm.to(bc).float())
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_ssd_chunks_hands_b_and_c_in_their_own_type():
    """``ops.ssd_chunks`` hands the chunk kernel B and C in their own type,
    as the reference's ``ssd_forward`` hands its Pallas kernel (x and cum
    f32); with bf16 B and C the chunked SSD (the plain chunk form on the
    CPU) still equals the reference's ``ssd_forward`` in interpret mode
    within 2e-4, and f32 B and C still reach it as f32."""
    rng = np.random.default_rng(29)
    B, L, H, P, N = 2, 70, 4, 16, 8
    x = _randn(rng, (B, L, H, P))
    dt = np.abs(_randn(rng, (B, L, H))) * 0.1
    A = -np.abs(_randn(rng, (H,)))
    Bm, Cm = _randn(rng, (B, L, 1, N)), _randn(rng, (B, L, 1, N))
    seen = []

    def recording(*args):
        seen.append(tuple(a.dtype for a in args))
        return ref.ssd_chunk_ref(*args)

    t = [torch.from_numpy(a) for a in (x, dt, A)]
    for bc in (torch.bfloat16, torch.float32):
        got, _ = ops.ssd_forward(*t, torch.from_numpy(Bm).to(bc),
                                 torch.from_numpy(Cm).to(bc), chunk=32,
                                 chunk_dual=recording)
        assert seen.pop() == (torch.float32, torch.float32, bc, bc)
        jbc = jnp.bfloat16 if bc == torch.bfloat16 else jnp.float32
        want, _ = jops.ssd_forward(*(jnp.asarray(a) for a in (x, dt, A)),
                                   jnp.asarray(Bm, jbc), jnp.asarray(Cm, jbc),
                                   chunk=32, interpret=True)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   atol=2e-4, rtol=2e-4)
    assert not seen


def test_ssd_chunk_mask_is_a_select_so_a_steep_decay_stays_finite():
    """With cum falling by 50 a row, exp(cum_i - cum_j) above the diagonal
    overflows to inf.  The kernel selects 0 there, so y and S stay finite
    and equal to the plain version; a product with a 0/1 mask would turn
    each inf into nan."""
    rng = np.random.default_rng(6)
    x, _, Bm, Cm = (torch.from_numpy(a)
                    for a in _ssd_inputs(rng, 1, 32, 2, 8, 4))
    cum = torch.cumsum(torch.full((1, 32, 2), -50.0), dim=1)
    y, S = _ssd_chunk_tf32(x, cum, Bm, Cm, 3)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    yr, sr = ref.ssd_chunk_ref(x, cum, Bm, Cm)
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(S, sr, atol=1e-4, rtol=1e-4)
    ch = cum.transpose(1, 2)
    decay = (ch[..., :, None] - ch[..., None, :]).exp()
    assert torch.isinf(decay).any()
    keep = torch.ones(32, 32).tril()
    assert torch.isnan(decay * keep).any()


# ---------------------------------------------------------------------------
# bf16 operands: exact in TF32, so their lo products are left out
# ---------------------------------------------------------------------------

def test_bf16_operands_split_with_a_zero_lo_part():
    """A bf16 value widened to f32 has 8 significant bits, so the kernels'
    split gives hi = x and lo = 0: the products of its lo part are zero,
    and one TF32 product of two bf16-born operands equals the three of the
    f32 path (``tf32x3::mmax``)."""
    rng = np.random.default_rng(16)
    a = torch.from_numpy(_randn(rng, (64, 512))).bfloat16().float()
    b = torch.from_numpy(_randn(rng, (512, 64))).bfloat16().float()
    hi, lo = _split(a)
    assert torch.equal(hi, a) and not lo.any()
    assert torch.equal(_mm_tf32(a, b, 1), _mm_tf32(a, b, 3))


def test_bf16_partner_keeps_the_f32_operands_split():
    """P V in flash, W x and (d .* B)^T x in SSD: the f32-computed operand
    keeps its split and only the bf16-born partner's lo product is left
    out (two products), which equals the three; dropping the f32 operand's
    lo part too would not meet the f32 attention tolerance (2e-5)."""
    rng = np.random.default_rng(17)
    p = torch.softmax(torch.from_numpy(_randn(rng, (64, 512))) * 3, dim=-1)
    v = torch.from_numpy(_randn(rng, (512, 64))).bfloat16().float()
    (phi, plo), (vhi, _) = _split(p), _split(v)
    two = plo @ vhi + phi @ vhi
    assert torch.equal(two, _mm_tf32(p, v, 3))
    want = p.double() @ v.double()
    assert (two.double() - want).abs().max() < 2e-5
    assert (_mm_tf32(p, v, 1).double() - want).abs().max() > 2e-5


def test_dtype_suffix_takes_f32_or_bf16_all_of_one_type():
    """The wrappers' type check on the card: all float32 or all bfloat16
    pick the launch function; anything else raises ``TypeError``."""
    f, h = torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)
    assert _build.dtype_suffix("k", (f, f)) == "f32"
    assert _build.dtype_suffix("k", (h, h, h)) == "bf16"
    for bad in ((f, h), (h, f), (f.double(),), (f.half(), f.half())):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            _build.dtype_suffix("k", bad)
    for name in _build.TENSOR_CORE_SOURCES:
        fns = _build.SIGNATURES[name]
        assert {fn.rsplit("_", 1)[1] for fn in fns} == (
            {"f32", "bf16", "mixed"} if name == "mamba_ssd"
            else {"f32", "bf16"})
    assert set(_build.SIGNATURES) == set(_build.SOURCES)
    assert set(_build.SIGNATURES["fused_eval"]) == {"fused_eval_f32",
                                                    "segment_replay_f64"}


def test_ssd_dtype_suffix_takes_three_combinations():
    """The SSD chunk kernel's type rule: x and cum f32 with B and C f32 or
    bf16 (the mixed launch function, what the model's bf16 compute hands
    it), or all four bf16; every other mix raises ``TypeError``."""
    f, h = torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)
    assert _build.ssd_dtype_suffix("k", f, f, f, f) == "f32"
    assert _build.ssd_dtype_suffix("k", h, h, h, h) == "bf16"
    assert _build.ssd_dtype_suffix("k", f, f, h, h) == "mixed"
    assert set(_build.SSD_DTYPE_SUFFIX.values()) == {
        fn.rsplit("_", 1)[1] for fn in _build.SIGNATURES["mamba_ssd"]}
    for bad in ((h, h, f, f), (f, h, h, h), (h, f, h, h), (f, f, h, f),
                (f, f, f, h), (f.double(),) * 4, (f.half(),) * 4,
                (f, f, f.half(), f.half())):
        with pytest.raises(TypeError, match="x and cum float32 or "
                                            "bfloat16"):
            _build.ssd_dtype_suffix("k", *bad)


# ---------------------------------------------------------------------------
# the build: a library's name digests everything it is compiled from
# ---------------------------------------------------------------------------

def test_lib_path_digests_the_shared_headers(tmp_path, monkeypatch):
    """Editing a shared header (``csrc/*.cuh``) renames every library, so a
    library built from the old header never loads; editing one source's
    ``.cu`` renames that source's library only.  No ``nvcc`` needed."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert before == {n: _build.lib_path(n) for n in _build.SOURCES}
    header = csrc / "tf32x3.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    src = csrc / "mamba_ssd.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.lib_path("mamba_ssd") != after["mamba_ssd"]
    assert _build.lib_path("tiled_matmul") == after["tiled_matmul"]


# ---------------------------------------------------------------------------
# the SASS gate: tensor-core instructions by kernel function and kind
# ---------------------------------------------------------------------------

_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_114flash_fwd_bf16ILi64ELb1ELb0EEEvPK13__nv_bfloat16S3_S3_PS1_PfS5_iiiiif
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
        /*0450*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;     /* 0x000000141418723c */
        /*0460*/                   HMMA.16816.F32.BF16 R28, R4, R22, R28 ;     /* 0x000000161c1c723c */
        /*0470*/                   LDSM.16.MT88.4 R8, [R2+0x400] ;             /* 0x000400000208783b */
\t\tFunction : _ZN12_GLOBAL__N_115gemm_wgmma_bf16INS_2WgILi128ELi256ELi4EEEEv14CUtensorMap_stS3_P13__nv_bfloat16iii
        /*0a10*/                   HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;   /* 0x0000000418187df0 */
        /*0a20*/              @!P0 HGMMA.64x256x16.F32.BF16 R24, gdesc[UR8], R24 ;        /* 0x0000000818187df0 */
\t\tFunction : _ZN12_GLOBAL__N_111gemm_3xtf32INS_4TileIfLi64ELi64ELi2ELi2ELi3EEELb1EEEvPKT_S6_PS4_iii
        /*0300*/                   HMMA.1688.F32.TF32 R8, R12, R16, R8 ;       /* 0x000000100c08723c */
\t\tFunction : _ZN12_GLOBAL__N_113ssd_state_scanEPKfS1_S1_S1_Pfiiiiiii
        /*0100*/                   FFMA R8, R12, R16, R8 ;                     /* 0x000000100c087223 */
"""


def test_tensor_core_counts_by_function_and_kind():
    """``_build.tensor_core_counts`` reads ``cuobjdump -sass`` text: each
    function's HMMA (mma.sync) and HGMMA (wgmma) instructions by operand
    kind, predicated ones too; a function with none maps to {}."""
    counts = _build.tensor_core_counts(_SASS)
    by = {fn.split("_GLOBAL__N_1")[1][:18]: c for fn, c in counts.items()}
    assert list(by.values()) == [{"HMMA.BF16": 2}, {"HGMMA.BF16": 2},
                                 {"HMMA.TF32": 1}, {}]
    assert _build.tensor_core_counts("no functions\nHMMA.1688.F32.TF32") \
        == {}


def test_tensor_core_gate_holds_the_bf16_kernels_to_bf16_products():
    """The gate: flash's and the GEMM's bf16 functions must hold their bf16
    instruction (HMMA.16816.F32.BF16, HGMMA...BF16) and no TF32 product;
    every other gated function an HMMA; every named function must exist."""
    counts = _build.tensor_core_counts(_SASS)
    flash = {fn: c for fn, c in counts.items() if "flash" in fn}
    gemm = {fn: c for fn, c in counts.items() if "gemm" in fn}
    assert _build.tensor_core_faults("flash_attention", flash) == []
    assert _build.tensor_core_faults("tiled_matmul", gemm) == []
    # a TF32 product in a bf16 function, or its bf16 instruction missing
    tf32 = _SASS.replace("HMMA.16816.F32.BF16 R28", "HMMA.1688.F32.TF32 R28")
    bad = {fn: c for fn, c in _build.tensor_core_counts(tf32).items()
           if "flash" in fn}
    assert "HMMA.BF16 only" in _build.tensor_core_faults("flash_attention",
                                                         bad)[0]
    mma_sync = _SASS.replace("HGMMA.64x256x16", "HMMA.16816")
    bad = {fn: c for fn, c in _build.tensor_core_counts(mma_sync).items()
           if "gemm" in fn}
    assert any("gemm_wgmma_bf16" in f and "HGMMA.BF16 only" in f
               for f in _build.tensor_core_faults("tiled_matmul", bad))
    # the bf16 kernel absent, a gated function without HMMA
    only_tf32 = {fn: c for fn, c in gemm.items() if "3xtf32" in fn}
    assert _build.tensor_core_faults("tiled_matmul", only_tf32) == [
        "tiled_matmul: no function named gemm_wgmma_bf16"]
    assert any("has no HMMA" in f for f in _build.tensor_core_faults(
        "ssd_state", counts, gated=("ssd_state_scan",)))
    assert _build.tensor_core_faults("ssd_state", counts,
                                     gated=("ssd_state_walk",)) == [
        "ssd_state: no kernel function",
        "ssd_state: no function named ssd_state_walk"]


_SSD_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_115ssd_chunk_mixedILi64ELb1EEEvPKfS2_PK13__nv_bfloat16S5_PfS6_iiiiiii
        /*0450*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;     /* 0x000000141418723c */
        /*0500*/                   HMMA.1688.F32.TF32 R8, R12, R16, R8 ;       /* 0x000000100c08723c */
\t\tFunction : _ZN12_GLOBAL__N_114ssd_chunk_bf16ILi64ELb1EEEvPK13__nv_bfloat16S3_S3_S3_PfS4_iiiiiii
        /*0450*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;     /* 0x000000141418723c */
        /*0500*/                   HMMA.1688.F32.TF32 R8, R12, R16, R8 ;       /* 0x000000100c08723c */
\t\tFunction : _ZN12_GLOBAL__N_113ssd_chunk_f32ILi64ELb1EEEvPKfS2_S2_S2_PfS3_iiiiiii
        /*0300*/                   HMMA.1688.F32.TF32 R8, R12, R16, R8 ;       /* 0x000000100c08723c */
"""


def test_tensor_core_gate_holds_the_mixed_ssd_kernel_to_bf16_scores():
    """The SSD chunk kernel's mixed and bf16 functions take C Bᵀ on the
    bf16 tensor cores and W x, (d ⊙ B)ᵀ x in TF32: the gate wants their
    HMMA.BF16 and lets TF32 stand beside it; the f32 function an HMMA.
    Without the bf16 instruction, or without the mixed function, it
    fails."""
    counts = _build.tensor_core_counts(_SSD_SASS)
    assert _build.tensor_core_faults("mamba_ssd", counts) == []
    no_bf16 = _SSD_SASS.replace("HMMA.16816.F32.BF16", "HMMA.1688.F32.TF32")
    faults = _build.tensor_core_faults(
        "mamba_ssd", _build.tensor_core_counts(no_bf16))
    assert len(faults) == 2 and all("takes C B^T as HMMA.BF16" in f
                                    for f in faults)
    no_mixed = {fn: c for fn, c in counts.items() if "mixed" not in fn}
    assert _build.tensor_core_faults("mamba_ssd", no_mixed) == [
        "mamba_ssd: no function named ssd_chunk_mixed"]


# ---------------------------------------------------------------------------
# the bf16 flash kernel's arithmetic: exact bf16 products, P split in two
# ---------------------------------------------------------------------------

def _flash_bf16_emulated(q, k, v, causal: bool, split: bool = True,
                         bkv: int = 64, rounded: bool = True):
    """The bf16 flash kernel's arithmetic on the CPU (kv tiles of ``bkv``
    keys): q k^T as exact products of bf16 values summed in f32, scaled
    into log2 units and masked to -1e30; the running max; p = exp2(s - m),
    0 where masked; p split into p_hi = bf16(p) and p_lo = bf16(p - p_hi)
    (``split``; else p rounded to bf16 in one piece), each multiplied by v
    and added in f32 to the output rescaled by exp2(m_old - m); the
    denominator summed from the f32 p.  The output acc / max(l, 1e-30),
    rounded to bf16 (``rounded``) or left in f32."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    Sq, D = q.shape[-2:]
    Sk = k.shape[-2]
    scale_log2 = torch.tensor(math.log2(math.e), dtype=torch.float32) \
        / torch.tensor(D, dtype=torch.float32).sqrt()
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(qf.shape)
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, bkv):
        kt, vt = kf[..., k0:k0 + bkv, :], vf[..., k0:k0 + bkv, :]
        kpos = torch.arange(k0, k0 + kt.shape[-2])[None, :]
        keep = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
        s = torch.where(keep, (qf @ kt.transpose(-1, -2)) * scale_log2,
                        torch.tensor(-1e30))
        mn = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - mn)
        p = torch.where(s > -1e30, torch.exp2(s - mn[..., None]),
                        torch.zeros(()))
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split:
            pv = (p - hi).bfloat16().float() @ vt + pv
        acc = acc * corr[..., None] + pv
        l = l * corr + p.sum(-1)
        m = mn
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.bfloat16() if rounded else out


@pytest.mark.parametrize("Sq,Sk,causal", [(256, 256, True),
                                          (1024, 1024, True),
                                          (448, 1024, False)])
def test_split_p_bf16_flash_meets_the_reference_bf16_tolerance(Sq, Sk,
                                                               causal):
    """The new bf16 flash arithmetic, emulated, against the JAX package's
    Pallas kernel in interpret mode on the same numpy-seeded bf16 inputs
    (head dim 64, the main paths'): within the reference's bf16 2e-2."""
    from repro.kernels.flash_attention import flash_attention_mha as jflash
    rng = np.random.default_rng(Sq + Sk)
    q = _randn(rng, (1, 2, Sq, 64))
    k, v = (_randn(rng, (1, 2, Sk, 64)) for _ in range(2))
    want = np.asarray(jflash(*(jnp.asarray(x, jnp.bfloat16)
                               for x in (q, k, v)), causal=causal,
                             interpret=True), np.float32)
    got = _flash_bf16_emulated(*(torch.from_numpy(x).bfloat16()
                                 for x in (q, k, v)), causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


def test_split_p_keeps_the_probabilities_f32_accurate():
    """Why P is split: with p_hi + p_lo (about 16 significant bits) the
    output before its bf16 rounding stays within 1e-5 of exact attention
    on the same bf16 inputs, as the reference's f32 product of f32
    probabilities does; p rounded to bf16 in one piece is off by more
    than 1e-4."""
    rng = np.random.default_rng(1024)
    q, k, v = (torch.from_numpy(_randn(rng, (1, 2, 1024, 64))).bfloat16()
               for _ in range(3))
    exact = ref.attention_ref(*(x.double() for x in (q, k, v)), causal=True)
    err = lambda split: (_flash_bf16_emulated(q, k, v, True, split=split,
                                              rounded=False).double()
                         - exact).abs().max().item()
    assert err(True) < 1e-5 < 1e-4 < err(False)
