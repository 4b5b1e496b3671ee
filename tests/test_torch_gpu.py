"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so it runs on the card's machine:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of ``tests/test_kernels.py``: atol 1e-3 / rtol 1e-4
for the f32 GEMM, 2e-5 for f32 attention, 1e-4 for the SSD chunk kernel and
2e-4 for the chunked SSD; for bf16 operands, GEMM atol 0.5 / rtol 5e-2 and
attention 2e-2 against the plain version on the upcast inputs (the SSD
kernel returns f32 and keeps 1e-4).  TF32 is off for the plain versions.
The three kernels compute in 3xTF32 on the tensor cores for f32 operands,
the GEMM and flash on TF32 wgmma fed by TMA where the operands are aligned
(flash at head dims 64 and 128), checked at every main-path f32 shape
beside the mma.sync kernels they replaced, their bits repeated;
for bf16 operands the GEMM runs wgmma fed by TMA (the 3xTF32 kernel on
ragged K or N) and flash bf16 m16n8k16 products, each bit-reproducible
over 50 launches.  Each tile or head-dim configuration and copy width is
driven here, for f32 and for bf16.  So do the SSD state pass's walk and outputs, whose product C . h
runs in 3xTF32 too.  The cost model's two kernels: ``fused_eval`` within
rel 1e-5 of its plain version and within the reference's parity envelope
(rel 1e-4, equal bottlenecks) of the exact numpy engine, and
bit-reproducible launch after launch (its rows sum in a fixed order; the
supervised fused sweep, with a killed child and with a duplicate dispatch,
equals a clean fused run bit for bit); ``segment_replay`` equal to
``np.bincount`` bit for bit (each cell's float64 adds in stream order) and
bit-reproducible launch after launch.  The model stack's: the SSD state
pass within 1e-4 of its plain version on each route (the walk, and the
split's two kernels), the model's chunked SSD within 2e-4 (at N = 128 too),
flash with ``q_offset`` and with its statistics at the flash tolerances,
``cache_stack`` attention within 1e-4 (below), and the reduced models'
kernel route against ``use_kernels=False`` (below), the MoE model's bf16
leg with its expert choice held fixed, the encoder-decoder's three
attention modes (flash at whisper-small's shapes in bf16, and a reduced
whisper through the kernels), and the trace replay over the model executor
on the card.  Every wrapper refuses an input that requires grad (the
kernels have no backward); the training path (below) takes the plain routes
on the card, launches no kernel, and its async checkpoint holds the state
of the step it saved. """

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, mamba_ssd, ops, ref
from repro_torch.kernels import tiled_matmul as mm
from repro_torch.kernels.flash_attention import flash_attention_mha
from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
from repro_torch.kernels.tiled_matmul import tiled_matmul


def _randn(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the route of each shape of test_tiled_matmul_kernel_vs_plain on an H100
# (132 SMs): aligned f32 operands take the TF32 wgmma kernel, its tile by
# grid fill; K or N % 4 != 0 the mma.sync kernel with 4-byte copies
_MM_ROUTES = {(2048, 512, 512): "128x64 wgmma tma tf32x3",
              (2048, 512, 2048): "128x128 wgmma tma tf32x3",
              (2048, 2048, 512): "128x64 wgmma tma tf32x3",
              (4096, 1024, 4384): "128x128 wgmma tma tf32x3",
              (4096, 2048, 1024): "128x128 wgmma tma tf32x3",
              (100, 300, 50): "64x64 cp.async4",
              (257, 129, 65): "64x64 cp.async4",
              (1000, 77, 3): "64x64 cp.async4"}


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(2048, 512, 512), (2048, 512, 2048),
                                   (2048, 2048, 512), (4096, 1024, 4384),
                                   (4096, 2048, 1024), (100, 300, 50),
                                   (257, 129, 65), (1000, 77, 3)])
def test_tiled_matmul_kernel_vs_plain(cuda, M, K, N):
    rng = np.random.default_rng(M * K + N)
    a = torch.from_numpy(_randn(rng, (M, K))).to(cuda)
    b = torch.from_numpy(_randn(rng, (K, N))).to(cuda)
    assert mm.kernel_route(a, b) == _MM_ROUTES[(M, K, N)]
    n0 = tiled_matmul.launches
    got = tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == n0 + 1
    torch.testing.assert_close(got, ref.matmul_ref(a, b),
                               atol=1e-3, rtol=1e-4)


def _on_card(rng, shape, device, offset=False):
    """A contiguous f32 tensor on the card; with ``offset`` a view one float
    into its storage, so its data pointer is 4 but not 16-byte aligned."""
    n = int(np.prod(shape))
    flat = torch.from_numpy(_randn(rng, (n + int(offset),))).to(device)
    return flat[int(offset):].view(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,offset,route", [
    (2048, 512, 512, False, "128x64 wgmma tma tf32x3"),   # 64 big tiles
    (2048, 512, 2048, False, "128x128 wgmma tma tf32x3"),
    (1000, 77, 3, False, "64x64 cp.async4"),        # K, N % 4 != 0
    (2048, 130, 2050, False, "128x128 cp.async4"),
    (512, 256, 512, True, "64x64 cp.async4"),       # A a float off 16 B
    (2048, 512, 2048, True, "128x128 cp.async4"),
])
def test_tiled_matmul_routes_vs_plain(cuda, M, K, N, offset, route):
    """Each tile configuration and copy width of the GEMM kernel against
    the plain version; the route is the one the kernel reports."""
    rng = np.random.default_rng(M + K + N + offset)
    a = _on_card(rng, (M, K), cuda, offset)
    b = _on_card(rng, (K, N), cuda)
    assert a.is_contiguous()
    assert mm.kernel_route(a, b) == route
    w0 = tiled_matmul.wgmma_f32_launches
    got = tiled_matmul(a, b)
    torch.cuda.synchronize()
    # the wrapper's tally of wgmma launches follows the kernel's own rule
    assert tiled_matmul.wgmma_f32_launches - w0 == route.endswith("tf32x3")
    torch.testing.assert_close(got, ref.matmul_ref(a, b),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,offset,route", [
    (1, 2, 128, 256, 32, True, False, "D32 kv64 cp.async16"),
    (2, 2, 192, 100, 64, True, False, "D64 q64 kv64 wgmma tma tf32x3"),
    (4, 4, 512, 512, 128, True, False, "D128 q64 kv32 wgmma tma tf32x3"),
    (1, 2, 96, 200, 256, True, False, "D256 kv32 cp.async16"),  # Sq < Sk
    (2, 2, 130, 70, 256, False, False, "D256 kv32 cp.async16"),
    (1, 3, 80, 90, 33, True, False, "D64 kv64 cp.async4"),      # D % 4 != 0
    (1, 2, 64, 96, 64, True, True, "D64 kv64 cp.async4"),       # offset q
    (1, 2, 100, 100, 128, False, True, "D128 kv64 cp.async4"),
])
def test_flash_attention_routes_vs_plain(cuda, B, H, Sq, Sk, D, causal,
                                         offset, route):
    """Each head-dim template and copy width of the flash kernel against
    the plain version; the route is the one the kernel reports."""
    rng = np.random.default_rng(B * H + Sq + Sk + D)
    q = _on_card(rng, (B, H, Sq, D), cuda, offset)
    k = _on_card(rng, (B, H, Sk, D), cuda)
    v = _on_card(rng, (B, H, Sk, D), cuda)
    assert flash_attention.kernel_route(q, k, v) == route
    w0 = flash_attention_mha.wgmma_f32_launches
    got = flash_attention_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    # the wrapper's tally of wgmma launches follows the kernel's own rule
    assert flash_attention_mha.wgmma_f32_launches - w0 \
        == route.endswith("tf32x3")
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=causal),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_gemm_and_flash_kernels_are_deterministic(cuda):
    """No split-K, no atomics, a fixed merge order: two launches on the same
    inputs agree to the bit, on the TF32 wgmma kernels (each GEMM tile,
    flash at head dims 128 and 64) and on the mma.sync ones."""
    rng = np.random.default_rng(5)
    for M, K, N, offset in [(2048, 512, 2048, False), (2048, 512, 512, False),
                            (1024, 512, 64, False), (2048, 512, 2048, True)]:
        a = _on_card(rng, (M, K), cuda, offset)
        b = _on_card(rng, (K, N), cuda)
        assert ("wgmma tma tf32x3" in mm.kernel_route(a, b)) != offset
        assert torch.equal(tiled_matmul(a, b), tiled_matmul(a, b))
    for shape, offset in [((4, 4, 512, 128), False), ((2, 4, 300, 64), False),
                          ((2, 2, 100, 128), True)]:
        q = _on_card(rng, shape, cuda, offset)
        k, v = (_on_card(rng, shape, cuda) for _ in range(2))
        assert ("wgmma tma tf32x3" in flash_attention.kernel_route(q, k, v)) \
            != offset
        assert torch.equal(flash_attention_mha(q, k, v, causal=True),
                           flash_attention_mha(q, k, v, causal=True))


# the realization paths' f32 GEMM shapes (chip_smoke.MM_PATH): tf-paper,
# mamba2-370m, granite-moe-3b-a800m (router N = 40, experts, attention
# output, qkv), mla-paper (low-rank projections, output, FFN); then ragged
# M and N (multiples of 4, off every tile)
_MM_F32_PATH = [(2048, 512, 512), (2048, 512, 2048), (2048, 2048, 512),
                (4096, 1024, 4384), (4096, 2048, 1024), (4096, 1536, 40),
                (4096, 1536, 1024), (4096, 512, 1536), (4096, 1536, 1536),
                (4096, 1536, 2560), (1024, 512, 64), (1024, 512, 128),
                (1024, 64, 512), (1024, 128, 512), (1024, 512, 512),
                (1024, 512, 2048), (1024, 1024, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", _MM_F32_PATH + [(1000, 512, 1020),
                                                  (333, 260, 68),
                                                  (4100, 1532, 36)])
def test_tiled_matmul_wgmma_route_at_the_path_shapes(cuda, M, K, N):
    """Every main-path f32 GEMM shape, and ragged M and N, takes the TF32
    wgmma kernel and meets atol 1e-3 / rtol 1e-4; the mma.sync kernel it
    replaced (``tiled_matmul_sync_f32``, 16-byte copies) meets it too."""
    rng = np.random.default_rng(M + 3 * K + 7 * N)
    a, b = _on_card(rng, (M, K), cuda), _on_card(rng, (K, N), cuda)
    route = mm.kernel_route(a, b)
    assert route.endswith("wgmma tma tf32x3"), route
    n0, w0 = tiled_matmul.launches, tiled_matmul.wgmma_f32_launches
    got = tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == n0 + 1
    assert tiled_matmul.wgmma_f32_launches == w0 + 1
    want = ref.matmul_ref(a, b)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    assert mm.kernel_route(a, b, sync=True).endswith("cp.async16")
    from repro_torch.kernels import _build
    sync = torch.empty_like(want)
    code = _build.load("tiled_matmul").tiled_matmul_sync_f32(
        a.data_ptr(), b.data_ptr(), sync.data_ptr(), M, N, K,
        cuda.index or 0, torch.cuda.current_stream().cuda_stream)
    assert code == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(sync, want, atol=1e-3, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Sk,D,q_offset", [
    (4, 4, 512, 512, 128, 0),        # tf-paper
    (1, 12, 4096, 4096, 128, 0),     # granite-moe-3b-a800m
    (2, 4, 512, 512, 128, 0),        # mla-paper
    (2, 2, 192, 100, 128, 0),        # ragged Sk below Sq
    (2, 3, 70, 45, 64, 0),           # ragged Sq and Sk
    (1, 2, 100, 300, 64, 200),       # the cache mode's q_offset
    (2, 4, 130, 1000, 128, 870),
])
def test_flash_wgmma_route_with_stats_at_the_path_shapes(cuda, B, H, Sq, Sk,
                                                         D, q_offset):
    """The realization paths' f32 flash shapes, ragged Sq and Sk and
    ``q_offset`` take the TF32 wgmma kernel: output, m and l within 2e-5
    of the plain version's, causal and not."""
    rng = np.random.default_rng(B + H + Sq + Sk + D + q_offset)
    q, k, v = (_on_card(rng, (B, H, S, D), cuda)
               for S in (Sq, Sk, Sk))
    assert flash_attention.kernel_route(q, k, v).endswith("wgmma tma tf32x3")
    for causal in (True, False):
        n0 = flash_attention_mha.launches
        w0 = flash_attention_mha.wgmma_f32_launches
        got = flash_attention_mha(q, k, v, causal=causal, q_offset=q_offset,
                                  return_stats=True)
        torch.cuda.synchronize()
        assert flash_attention_mha.launches == n0 + 1
        assert flash_attention_mha.wgmma_f32_launches == w0 + 1
        want = ref.attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                 return_stats=True)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", [
    (4, 4, 512, 512, 128, True),      # the realization path's shape
    (2, 4, 96, 96, 64, True),
    (1, 2, 128, 256, 32, False),
    (1, 2, 100, 300, 64, True),       # Sq != Sk, causal, ragged
    (2, 3, 70, 45, 100, False),       # head dim off the templates
    (1, 2, 130, 130, 256, True),
])
def test_flash_attention_kernel_vs_plain(cuda, B, H, Sq, Sk, D, causal):
    rng = np.random.default_rng(B + H + Sq + Sk + D)
    q = torch.from_numpy(_randn(rng, (B, H, Sq, D))).to(cuda)
    k = torch.from_numpy(_randn(rng, (B, H, Sk, D))).to(cuda)
    v = torch.from_numpy(_randn(rng, (B, H, Sk, D))).to(cuda)
    # f32 at head dims 64 and 128 takes the TF32 wgmma kernel, every other
    # head dim the mma.sync kernel's template
    assert flash_attention.kernel_route(q, k, v) == {
        128: "D128 q64 kv32 wgmma tma tf32x3",
        64: "D64 q64 kv64 wgmma tma tf32x3", 32: "D32 kv64 cp.async16",
        100: "D128 kv64 cp.async16", 256: "D256 kv32 cp.async16"}[D]
    n0 = flash_attention_mha.launches
    got = flash_attention_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_mha.launches == n0 + 1
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=causal),
                               atol=2e-5, rtol=2e-5)


def _ssd_inputs(rng, BC, Q, H, P, N, device, offset=False):
    """x, cum, Bm, Cm as ``tests/test_kernels.py`` draws them: cum is a
    running sum of negative log-decays.  With ``offset`` x is a view one
    float into its storage (4- but not 16-byte aligned)."""
    x = _randn(rng, (BC, Q, H, P))
    cum = np.cumsum(-np.abs(_randn(rng, (BC, Q, H))) * 0.1, axis=1)
    Bm, Cm = _randn(rng, (BC, Q, N)), _randn(rng, (BC, Q, N))
    xs = torch.zeros(x.size + int(offset), device=device)
    xs[int(offset):] = torch.from_numpy(x.ravel()).to(device)
    return [xs[int(offset):].view(x.shape)] + [
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        for a in (cum, Bm, Cm)]


@pytest.mark.gpu
@pytest.mark.parametrize("BC,Q,H,P,N,offset,route", [
    (32, 128, 16, 128, 64, False, "N64 P64 cp.async16"),   # the mamba2-370m
    (2, 16, 2, 8, 4, False, "N64 P64 cp.async16"),         # path's shape;
    (4, 64, 4, 32, 16, False, "N64 P64 cp.async16"),       # tests/test_kern
    (1, 128, 8, 64, 32, False, "N64 P64 cp.async16"),      # els.py's three
    (2, 96, 4, 64, 64, False, "N64 P64 cp.async16"),       # ragged chunks
    (3, 70, 2, 32, 16, False, "N64 P64 cp.async16"),
    (2, 70, 3, 130, 50, False, "N64 P64 cp.async4"),       # three P tiles
    (3, 70, 3, 64, 16, True, "N64 P64 cp.async4"),         # x off 16 B
    (1, 100, 5, 64, 64, False, "N64 P64 cp.async16"),      # Q % 16 != 0
    (3, 100, 1, 32, 12, False, "N64 P64 cp.async16"),      # N % 8 != 0
    (1, 128, 3, 130, 20, False, "N64 P64 cp.async4"),      # P = 130
    (1, 70, 7, 60, 50, True, "N64 P64 cp.async4"),
    # zamba2-1.2b's serve wave; 37 heads, a last group of heads ragged
    (32, 128, 64, 64, 64, False, "N64 P64 cp.async16"),
    (8, 128, 37, 64, 64, False, "N64 P64 cp.async16"),
    # the N <= 128 instance: the mamba2-370m serve shape, N = 100 (16-byte
    # copies), an odd N, x a float off 16 B, P = 130 in three tiles, 37
    # heads at Q = 100
    (32, 128, 32, 64, 128, False, "N128 P64 cp.async16"),
    (2, 128, 3, 64, 100, False, "N128 P64 cp.async16"),
    (3, 70, 3, 64, 99, False, "N128 P64 cp.async4"),
    (1, 100, 5, 64, 128, True, "N128 P64 cp.async4"),
    (1, 128, 3, 130, 72, False, "N128 P64 cp.async4"),
    (8, 100, 37, 64, 128, False, "N128 P64 cp.async16"),
])
def test_ssd_chunk_kernel_vs_plain(cuda, BC, Q, H, P, N, offset, route):
    """Each copy width of the SSD chunk kernel against the plain version,
    at ragged Q, N and P; the route is the one the kernel reports."""
    rng = np.random.default_rng(BC * Q + H + P + N)
    args = _ssd_inputs(rng, BC, Q, H, P, N, cuda, offset)
    assert all(a.is_contiguous() for a in args)
    assert mamba_ssd.kernel_route(args[0], args[2], args[3]) == route
    n0 = ssd_chunk_dual.launches
    y, s = ssd_chunk_dual(*args)
    torch.cuda.synchronize()
    assert ssd_chunk_dual.launches == n0 + 1
    yr, sr = ref.ssd_chunk_ref(*args)
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, sr, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_ssd_chunk_kernel_steep_decay_stays_finite(cuda):
    """cum falling by 50 a row: exp(cum_i - cum_j) above the diagonal would
    overflow; the kernel selects 0 there, so y and S are finite and equal
    to the plain version."""
    rng = np.random.default_rng(9)
    x, _, Bm, Cm = _ssd_inputs(rng, 2, 128, 4, 64, 64, cuda)
    cum = torch.cumsum(torch.full((2, 128, 4), -50.0, device=cuda), dim=1)
    y, s = ssd_chunk_dual(x, cum, Bm, Cm)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yr, sr = ref.ssd_chunk_ref(x, cum, Bm, Cm)
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, sr, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_ssd_forward_kernel_vs_plain(cuda):
    """The chunked SSD at L = 70, chunk 32 (a padded last chunk)."""
    rng = np.random.default_rng(70)
    B, L, H, P, N = 2, 70, 4, 64, 32
    x = _randn(rng, (B, L, H, P))
    dt = np.abs(_randn(rng, (B, L, H))) * 0.1
    A = -np.abs(_randn(rng, (H,)))
    Bm, Cm = _randn(rng, (B, L, 1, N)), _randn(rng, (B, L, 1, N))
    args = [torch.from_numpy(a).to(cuda) for a in (x, dt, A, Bm, Cm)]
    n0 = ssd_chunk_dual.launches
    got, _ = ops.ssd_forward(*args, chunk=32)
    torch.cuda.synchronize()
    assert ssd_chunk_dual.launches == n0 + 1
    want, _ = ops.ssd_forward(*args, chunk=32, chunk_dual=ref.ssd_chunk_ref)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


# bf16: the kernels take bf16 operands and compute in f32, as the
# reference's do; each is held against its plain version on the upcast
# inputs at the reference's bf16 tolerances (tests/test_kernels.py: GEMM
# atol 0.5 / rtol 5e-2, flash 2e-2).  The reference has no bf16 SSD test;
# the SSD kernel returns f32 and a bf16 input is exact in f32, so it is
# held to its f32 tolerance (1e-4).
MM_BF16_TOL = {"atol": 0.5, "rtol": 5e-2}
FLASH_BF16_TOL = {"atol": 2e-2, "rtol": 2e-2}
SSD_BF16_TOL = {"atol": 1e-4, "rtol": 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,route", [
    (2048, 512, 512, "128x64 wgmma tma bf16"),      # the paths' shapes
    (2048, 512, 2048, "128x256 wgmma tma bf16"),
    (4096, 1024, 4384, "128x256 wgmma tma bf16"),
    (1024, 512, 2048, "128x128 wgmma tma bf16"),
    (4096, 1536, 40, "64x64 wgmma tma bf16"),       # granite's router
    (128, 128, 128, "64x64 wgmma tma bf16"),        # tests/test_kernels.py
    (1000, 72, 200, "64x64 wgmma tma bf16"),        # off the tiles, K tail
    (300, 4104, 136, "64x64 wgmma tma bf16"),
    (257, 129, 65, "64x64 ld2 bf16"),               # odd K, odd N
    (2048, 131, 2048, "128x128 ld2 bf16"),          # odd K
    (1000, 64, 77, "64x64 ld2 bf16"),               # odd N
    (512, 260, 512, "64x64 ld2 bf16"),              # K % 8 == 4
])
def test_tiled_matmul_bf16_vs_plain(cuda, M, K, N, route):
    """bf16 operands launch the kernel (the counter moves), return bf16,
    and agree with the plain f32 product of the upcast operands."""
    rng = np.random.default_rng(M + 3 * K + N)
    a = torch.from_numpy(_randn(rng, (M, K))).to(cuda).bfloat16()
    b = torch.from_numpy(_randn(rng, (K, N))).to(cuda).bfloat16()
    assert mm.kernel_route(a, b) == route
    n0 = tiled_matmul.launches
    got = tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    torch.testing.assert_close(got.float(),
                               ref.matmul_ref(a.float(), b.float()),
                               **MM_BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,route", [
    (4, 4, 512, 512, 128, True,                                # the path
     "D128 q64 kv64 m16n8k16 cp.async16 bf16"),
    (1, 2, 64, 64, 32, True,                                   # test_kernels
     "D32 q64 kv64 m16n8k16 cp.async16 bf16"),
    (2, 2, 100, 70, 40, True,                                  # D = 40
     "D64 q64 kv64 m16n8k16 cp.async16 bf16"),
    (1, 3, 80, 90, 36, False, "D64 q64 kv64 m16n8k16 ld2 bf16"),  # D % 8 == 4
    (1, 2, 70, 70, 33, True, "D64 q64 kv64 m16n8k16 ld2 bf16"),   # odd D
    (1, 2, 96, 200, 256, True, "D256 q64 kv32 m16n8k16 cp.async16 bf16"),
])
def test_flash_attention_bf16_vs_plain(cuda, B, H, Sq, Sk, D, causal, route):
    rng = np.random.default_rng(B + H + Sq + 7 * D)
    q, k, v = (torch.from_numpy(_randn(rng, (B, H, S, D))).to(cuda)
               .bfloat16() for S in (Sq, Sk, Sk))
    assert flash_attention.kernel_route(q, k, v) == route
    n0 = flash_attention_mha.launches
    got = flash_attention_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_mha.launches == n0 + 1
    assert got.dtype == torch.bfloat16
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.testing.assert_close(got.float(), want, **FLASH_BF16_TOL)


# bf16 flash at the main paths' head dim 64 (cells' 4096 causal at a
# reduced B and H; whisper-small's encoder and cross-attention, Sk = 1500
# off the kv tile; the cache mode) and at the other head dims, through the
# m16n8k16 kernel, with its statistics against attention_ref's (m, l)
FLASH_BF16_SHAPES = [
    # (B, H, Sq, Sk, D, causal, q_offset, route)
    (1, 2, 4096, 4096, 64, True, 0, "D64 q64 kv64 m16n8k16 cp.async16 bf16"),
    (1, 4, 1500, 1500, 64, False, 0,
     "D64 q64 kv64 m16n8k16 cp.async16 bf16"),
    (2, 4, 448, 1500, 64, False, 0, "D64 q64 kv64 m16n8k16 cp.async16 bf16"),
    (2, 4, 128, 384, 64, True, 256, "D64 q64 kv64 m16n8k16 cp.async16 bf16"),
    (1, 3, 200, 200, 32, True, 0, "D32 q64 kv64 m16n8k16 cp.async16 bf16"),
    (1, 3, 200, 300, 128, False, 0,
     "D128 q64 kv64 m16n8k16 cp.async16 bf16"),
    (1, 2, 130, 190, 256, True, 60, "D256 q64 kv32 m16n8k16 cp.async16 bf16"),
    (2, 2, 150, 150, 40, True, 0, "D64 q64 kv64 m16n8k16 cp.async16 bf16"),
    (1, 2, 150, 170, 33, True, 20, "D64 q64 kv64 m16n8k16 ld2 bf16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_offset,route",
                         FLASH_BF16_SHAPES)
def test_flash_attention_bf16_shapes_vs_plain(cuda, B, H, Sq, Sk, D, causal,
                                              q_offset, route):
    """The bf16 kernel at the main paths' shapes and every head-dim
    template: the output at 2e-2 and, through the ``_stats`` instance,
    each row's (m, l) at 2e-2 of attention_ref's on the upcast inputs; one
    launch each."""
    rng = np.random.default_rng(Sq + Sk + D + q_offset)
    q, k, v = (_on_card(rng, (B, H, n, D), cuda).bfloat16()
               for n in (Sq, Sk, Sk))
    assert flash_attention.kernel_route(q, k, v) == route
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             q_offset=q_offset, return_stats=True)
    n0 = flash_attention_mha.launches
    got = flash_attention_mha(q, k, v, causal=causal, q_offset=q_offset)
    stats = flash_attention_mha(q, k, v, causal=causal, q_offset=q_offset,
                                return_stats=True)
    torch.cuda.synchronize()
    assert flash_attention_mha.launches == n0 + 2
    assert got.dtype == stats[0].dtype == torch.bfloat16
    assert torch.equal(got, stats[0])
    torch.testing.assert_close(got.float(), want[0], **FLASH_BF16_TOL)
    for a, b in zip(stats[1:], want[1:]):
        torch.testing.assert_close(a, b, **FLASH_BF16_TOL)


@pytest.mark.gpu
def test_bf16_gemm_repeats_its_bits(cuda):
    """No split-K, no atomics, one fixed-order sum per output: 50 launches
    of the bf16 GEMM (its widest wgmma tile) on the same inputs give one
    result, bit for bit."""
    rng = np.random.default_rng(50)
    a = _on_card(rng, (4096, 1024), cuda).bfloat16()
    b = _on_card(rng, (1024, 4384), cuda).bfloat16()
    assert mm.kernel_route(a, b) == "128x256 wgmma tma bf16"
    first = tiled_matmul(a, b)
    assert all(torch.equal(tiled_matmul(a, b), first) for _ in range(49))


@pytest.mark.gpu
def test_bf16_flash_repeats_its_bits(cuda):
    """Each output row one online-softmax sum in a fixed order, no merge
    across warps: 50 launches of bf16 flash at the pipeline's shape on the
    same inputs give one result, bit for bit."""
    rng = np.random.default_rng(51)
    q, k, v = (_on_card(rng, (2, 9, 1024, 64), cuda).bfloat16()
               for _ in range(3))
    first = flash_attention_mha(q, k, v, causal=True)
    assert all(torch.equal(flash_attention_mha(q, k, v, causal=True), first)
               for _ in range(49))


@pytest.mark.gpu
@pytest.mark.parametrize("BC,Q,H,P,N,route", [
    (32, 128, 16, 128, 64, "N64 P128 cp.async16 bf16"),  # the realization
    (2, 16, 2, 8, 4, "N64 P64 ld2 bf16"),                # N % 8 != 0
    (1, 100, 5, 64, 64, "N64 P64 cp.async16 bf16"),      # Q % 16 != 0
    (1, 128, 3, 130, 24, "N64 P128 ld2 bf16"),           # P = 130
    (3, 70, 3, 60, 50, "N64 P64 ld2 bf16"),
    (32, 128, 64, 64, 64, "N64 P64 cp.async16 bf16"),    # zamba2's wave
    (8, 128, 37, 64, 64, "N64 P64 cp.async16 bf16"),     # 37 heads
    (32, 128, 32, 64, 128, "N128 P64 cp.async16 bf16"),  # mamba2-370m
    (2, 128, 3, 64, 100, "N128 P64 ld2 bf16"),           # N % 8 != 0
    (1, 100, 5, 130, 128, "N128 P64 ld2 bf16"),          # P = 130
])
def test_ssd_chunk_kernel_bf16_vs_plain(cuda, BC, Q, H, P, N, route):
    """bf16 inputs launch the kernel and give f32 outputs, equal to the
    plain version on the upcast inputs."""
    rng = np.random.default_rng(BC * Q + H + P + 2 * N)
    args = [a.bfloat16() for a in _ssd_inputs(rng, BC, Q, H, P, N, cuda)]
    assert mamba_ssd.kernel_route(args[0], args[2], args[3]) == route
    n0 = ssd_chunk_dual.launches
    y, s = ssd_chunk_dual(*args)
    torch.cuda.synchronize()
    assert ssd_chunk_dual.launches == n0 + 1
    assert y.dtype == s.dtype == torch.float32
    yr, sr = ref.ssd_chunk_ref(*(a.float() for a in args))
    torch.testing.assert_close(y, yr, **SSD_BF16_TOL)
    torch.testing.assert_close(s, sr, **SSD_BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("BC,Q,H,P,N,offset,route", [
    (32, 128, 64, 64, 64, False, "N64 P64 cp.async16 mixed"),    # zamba2,
    (32, 128, 32, 64, 128, False, "N128 P64 cp.async16 mixed"),  # mamba2-
    (32, 128, 16, 128, 64, False, "N64 P64 cp.async16 mixed"),   # 370m,
    (2, 16, 2, 8, 4, False, "N64 P64 cp.async4+ld2 mixed"),      # realiz.
    (1, 70, 7, 60, 50, True, "N64 P64 cp.async4+ld2 mixed"),     # x off
    (1, 100, 5, 130, 128, False, "N128 P64 cp.async4+ld2 mixed"),
    (8, 128, 37, 64, 64, False, "N64 P64 cp.async16 mixed"),     # 37 heads
    (3, 70, 3, 64, 99, False, "N128 P64 cp.async4+ld2 mixed"),
])
def test_ssd_chunk_kernel_mixed_vs_plain(cuda, BC, Q, H, P, N, offset,
                                         route):
    """x and cum f32 with B and C bf16 (what ops.ssd_chunks hands the
    kernel when the model computes in bf16) launch the mixed instance, C Bᵀ
    on the bf16 tensor cores: f32 outputs within 1e-4 of the plain version
    on the upcast inputs, launched twice with the same bits."""
    rng = np.random.default_rng(BC * Q + H + P + 3 * N)
    x, cum, Bm, Cm = _ssd_inputs(rng, BC, Q, H, P, N, cuda, offset)
    Bm, Cm = Bm.bfloat16(), Cm.bfloat16()
    assert mamba_ssd.kernel_route(x, Bm, Cm) == route
    n0 = ssd_chunk_dual.launches
    y, s = ssd_chunk_dual(x, cum, Bm, Cm)
    y2, s2 = ssd_chunk_dual(x, cum, Bm, Cm)
    torch.cuda.synchronize()
    assert ssd_chunk_dual.launches == n0 + 2
    assert y.dtype == s.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(s, s2)
    yr, sr = ref.ssd_chunk_ref(x, cum, Bm.float(), Cm.float())
    torch.testing.assert_close(y, yr, **SSD_BF16_TOL)
    torch.testing.assert_close(s, sr, **SSD_BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "mixed"])
@pytest.mark.parametrize("BC,Q,H,P,N", [(32, 128, 64, 64, 64),
                                        (32, 128, 32, 64, 128),
                                        (32, 128, 16, 128, 64)])
def test_ssd_chunk_kernel_repeats_its_bits_and_groups_heads(cuda, dtype, BC,
                                                            Q, H, P, N):
    """At the serve and realization shapes, in each type, ten launches give
    one result; a block takes the heads of the grid-fill rule (zamba2's
    wave 16 a block, mamba2-370m's 8, the realization shape 4: C Bᵀ is
    computed once for that many heads)."""
    rng = np.random.default_rng(H + N)
    x, cum, Bm, Cm = _ssd_inputs(rng, BC, Q, H, P, N, cuda)
    if dtype == "bf16":
        x, cum = x.bfloat16(), cum.bfloat16()
    if dtype != "f32":
        Bm, Cm = Bm.bfloat16(), Cm.bfloat16()
    first = ssd_chunk_dual(x, cum, Bm, Cm)
    for _ in range(9):
        again = ssd_chunk_dual(x, cum, Bm, Cm)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms == 132:
        assert mamba_ssd.heads_per_block(x, Bm) == {64: 16, 32: 8,
                                                    16: 4}[H]


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [
    (torch.float64, torch.float64), (torch.float16, torch.float16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_kernels_refuse_other_and_mixed_dtypes(cuda, dtypes):
    """Only all-f32 or all-bf16 operands launch; float64, float16 and a
    mix raise ``TypeError`` without launching."""
    first, rest = dtypes
    counters = (tiled_matmul, flash_attention_mha, ssd_chunk_dual)
    n0 = [c.launches for c in counters]
    a = torch.zeros((4, 4), device=cuda, dtype=first)
    b = torch.zeros((4, 4), device=cuda, dtype=rest)
    with pytest.raises(TypeError):
        tiled_matmul(a, b)
    q = a.reshape(1, 1, 4, 4)
    kv = b.reshape(1, 1, 4, 4)
    with pytest.raises(TypeError):
        flash_attention_mha(q, kv, kv)
    x = torch.zeros((1, 16, 2, 8), device=cuda, dtype=first)
    rest3 = [torch.zeros(sh, device=cuda, dtype=rest)
             for sh in ((1, 16, 2), (1, 16, 4), (1, 16, 4))]
    with pytest.raises(TypeError):
        ssd_chunk_dual(x, *rest3)
    assert [c.launches for c in counters] == n0


def _kernel_route_vs_plain_route(cuda, fixture_name, name, spec):
    """Realize a committed fixture's plan with the kernels; return the
    launches of one pass and the largest stage-cube difference, relative
    to the cube's max, from the plain route given the same stage inputs."""
    from pathlib import Path

    from repro_torch.core.workloads import make_workload
    from repro_torch.realize.plan import load_realize_candidates, plans_for
    from repro_torch.realize.program import (build_program,
                                             draw_stage_arrays,
                                             stage_args_from_numpy)
    fixture = Path(__file__).resolve().parent / "data" / "realize" \
        / fixture_name
    g = make_workload(spec)
    (_, plan), = plans_for(load_realize_candidates(fixture, {name: g},
                                                   verbose=False))
    kern = build_program(g, plan, device=cuda)
    plain = build_program(g, plan, device=cuda, use_kernels=False)
    counters = (tiled_matmul, flash_attention_mha, ssd_chunk_dual)
    counts = [k.launches for k in counters]
    run = kern.execute(seed=0)
    launched = tuple(k.launches - n for k, n in zip(counters, counts))
    assert len(run["wall_s"]) == len(plan.stages)
    assert all(w > 0 for w in run["wall_s"])
    args = stage_args_from_numpy(draw_stage_arrays(kern, 0), cuda)
    outputs, worst = {}, 0.0
    for sk, sp, own in zip(kern.stages, plain.stages, args):
        ext = [outputs[n] for n in sk.ext_inputs]
        for cube, a, b in zip(sk.out_layers, sk.fn(*ext, *own),
                              sp.fn(*ext, *own)):
            assert torch.isfinite(a).all(), cube
            worst = max(worst, ((a - b).abs().max() / b.abs().max()).item())
            outputs[cube] = a
    return len(plan.stages), launched, worst


@pytest.mark.gpu
def test_realized_fixture_kernel_route_vs_plain_route(cuda):
    """The committed tf-paper plan on the card: one pass launches 36 GEMMs
    and 6 flash attentions, and every stage cube of the kernel route is
    within 2e-4 of the cube's max of the plain route given the same stage
    inputs (``tests/test_realize.py``'s bound)."""
    stages, launched, worst = _kernel_route_vs_plain_route(
        cuda, "tf-paper.simba.ckpt.jsonl", "TF", "tf-paper")
    assert stages == 37 and launched == (36, 6, 0)
    assert worst < 2e-4


@pytest.mark.gpu
def test_realized_mamba_fixture_kernel_route_vs_plain_route(cuda):
    """The committed mamba2-370m plan on the card: 96 stages, one pass
    launches 96 GEMMs and 48 SSD chunk kernels, every stage cube within
    2e-4 of the plain route's."""
    stages, launched, worst = _kernel_route_vs_plain_route(
        cuda, "mamba2-370m.simba.ckpt.jsonl", "MAMBA", "lm:mamba2-370m")
    assert stages == 96 and launched == (96, 0, 48)
    assert worst < 2e-4


@pytest.mark.gpu
def test_close_loop_on_the_card(cuda, tmp_path, capsys):
    """The port's ``close_loop`` on the card at the reference demo's size:
    each realized pass launches exactly its plan's kernels, the identity
    pass is bit-identical to the baseline, and the DSE passes (host numpy)
    equal a CPU run of the same loop."""
    import collections

    from repro_torch.examples.realize_demo import (close_loop,
                                                   demo_candidates,
                                                   demo_config, demo_graph)
    args = ({"TF": demo_graph()}, demo_candidates(), demo_config())
    res = close_loop(*args, device=cuda, ckpt=tmp_path / "gpu.ck.jsonl",
                     out=tmp_path / "gpu.jsonl")
    assert "identity overlay: second pass bit-identical" in \
        capsys.readouterr().out
    for r in res.realized:
        plan = collections.Counter(
            {"tiled_matmul": 0, "flash_attention_mha": 0,
             "ssd_chunk_dual": 0, "ssd_state_walk": 0, "ssd_state_scan": 0,
             "ssd_state_out": 0})
        plan.update(k for sp in r.program.stages
                    for k, _ in sp.kernel_launches)
        assert r.launches == dict(plan) and plan["tiled_matmul"] > 0
        assert all(st.wall_s > 0 for st in r.report.stages)
    cpu = close_loop(*args, device="cpu", ckpt=tmp_path / "cpu.ck.jsonl",
                     out=tmp_path / "cpu.jsonl")
    assert [p.objective for p in res.baseline] == \
        [p.objective for p in cpu.baseline]
    assert [p.objective for p in res.identity] == \
        [p.objective for p in res.baseline]


# ---------------------------------------------------------------------------
# the cost model's kernels: fused_eval and segment_replay
# ---------------------------------------------------------------------------

def _zoo_batch(spec, n):
    """A fused-pass batch of the workload zoo on the reference's test arch:
    the evaluator (fused on the card) and its requests."""
    from repro_torch.core.encoding import random_lms
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.graph_partition import partition_graph
    from repro_torch.core.hw import ArchConfig
    from repro_torch.core.workloads import make_workload
    a = ArchConfig(x_cores=4, y_cores=3, xcut=2, ycut=1, noc_bw=16.0,
                   d2d_bw=8.0, dram_bw=64.0, glb_kb=512, macs_per_core=256)
    g = make_workload(spec)
    rng = np.random.default_rng(n)
    reqs = [(grp, random_lms(grp, g, a.n_cores, a.n_dram, rng))
            for grp in partition_graph(g, a, 8) for _ in range(n)]
    return Evaluator(a, g, fused_device="cuda"), reqs


@pytest.mark.gpu
@pytest.mark.parametrize("spec,n", [("tf-quick", 1), ("moe-quick", 3),
                                    ("mla-quick", 8)])
def test_fused_eval_kernel_vs_exact_engine(cuda, spec, n):
    """The fused pass on the card within the reference's parity envelope
    (rel 1e-4, same bottleneck) of the exact numpy engine; one launch."""
    from repro_torch.kernels.fused_eval import fused_eval
    ev, reqs = _zoo_batch(spec, n)
    exact = ev.eval_requests_batch(reqs, 8)
    n0 = fused_eval.launches
    fused = ev.eval_requests_batch(reqs, 8, backend="fused")
    assert fused_eval.launches == n0 + 1
    for (ge, _), (gf, anf) in zip(exact, fused):
        assert anf is None and ge.bottleneck == gf.bottleneck
        for f in ("delay_s", "energy_j", "stage_time_s"):
            a, b = getattr(ge, f), getattr(gf, f)
            assert abs(a - b) <= 1e-4 * abs(a), f
        for k, v in ge.energy_breakdown.items():
            assert abs(gf.energy_breakdown[k] - v) <= 1e-4 * max(abs(v),
                                                                 1e-12)


def _fused_kernel_vs_plain(plan, args):
    """``fused_eval`` on the card against its plain version on the same
    inputs: rel 1e-5 (float32 sums in another order than the plain
    version's), the same bottleneck, one launch."""
    from repro_torch.kernels import fused_eval as fe
    n0 = fe.fused_eval.launches
    out, bn = fe.fused_eval(plan, *args)
    assert fe.fused_eval.launches == n0 + 1
    want, wbn = ref.fused_eval_ref(
        *args, spans=plan.spans, d2d_mask=plan.d2d_mask, consts=plan.consts,
        has_d2d=plan.has_d2d, buf_len=plan.buf_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=0.0)
    assert torch.equal(bn, wbn)


@pytest.mark.gpu
def test_fused_eval_kernel_vs_plain(cuda):
    """Kernel against its plain version on the same unpadded inputs on the
    card; a wrong dtype raises."""
    from repro_torch.kernels import fused_eval as fe
    ev, reqs = _zoo_batch("moe-quick", 4)
    x = ev._fused_inputs(reqs, 8)
    plan = ev.fused_plan()
    t = lambda a: torch.from_numpy(a.copy()).to(cuda)
    args = [t(a) for a in x]
    _fused_kernel_vs_plain(plan, args)
    with pytest.raises(TypeError, match="dtypes"):
        fe.fused_eval(plan, args[0], args[1].long(), *args[2:])


@pytest.mark.gpu
@pytest.mark.parametrize("B,empty", [(1, None), (200, None), (5, 2),
                                     (3, 0)])
def test_fused_eval_kernel_vs_plain_batch_sizes(cuda, B, empty):
    """One row, 200 rows (more blocks than the card has SMs), and a batch
    with one row's stream emptied (``off[b] == off[b+1]``)."""
    ev, reqs = _zoo_batch("mla-quick", 8)
    reqs = (reqs * (B // len(reqs) + 1))[:B]
    x = ev._fused_inputs(reqs, 8)
    off, idx, vals = (a.copy() for a in x[:3])
    if empty is not None:
        lo, hi = off[empty], off[empty + 1]
        assert hi > lo
        keep = np.r_[0:lo, hi:len(idx)]
        idx, vals = idx[keep], vals[keep]
        off[empty + 1:] -= hi - lo
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    _fused_kernel_vs_plain(ev.fused_plan(),
                           [t(a) for a in (off, idx, vals, *x[3:])])


@pytest.mark.gpu
def test_fused_eval_rows_above_48kb_and_above_the_limit(cuda):
    """A row of 20,000 cells (80 KB of shared memory, past the 48 KB a
    launch gets without opting in) and one of exactly the limit run and
    agree with the plain version; one cell more raises, naming
    ``buf_len``."""
    import dataclasses

    from repro_torch.kernels import fused_eval as fe
    ev, reqs = _zoo_batch("moe-quick", 2)
    x = ev._fused_inputs(reqs, 8)
    args = [torch.from_numpy(a.copy()).to(cuda) for a in x]
    plan = ev.fused_plan()
    limit = fe.max_cells(plan.device)
    assert 48 * 1024 // 4 < 20_000 < limit
    for cells in (20_000, limit):
        _fused_kernel_vs_plain(dataclasses.replace(plan, buf_len=cells),
                               args)
    n0 = fe.fused_eval.launches
    with pytest.raises(ValueError, match="buf_len"):
        fe.fused_eval(dataclasses.replace(plan, buf_len=limit + 1), *args)
    assert fe.fused_eval.launches == n0


def _sweep_batch(B):
    """A fused-pass batch at the supervised fused sweep's shapes: the
    ``tf-paper`` graph on the 70-core, two-chiplet candidate of the quick
    spec's 72-TOPS grid (``repro_torch.dist.supervisor.quick_spec``), at
    the sweep's batch of 8, ``B`` rows of random mappings."""
    from repro_torch.core.dse import grid_candidates
    from repro_torch.core.encoding import random_lms
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.graph_partition import partition_graph
    from repro_torch.core.workloads import make_workload
    a = grid_candidates(72.0, mac_options=[512, 1024], cut_options=[1, 2],
                        dram_per_tops=[2.0], noc_options=[16, 32],
                        d2d_ratio=[0.5], glb_options=[1024])[2]
    assert a.n_cores == 70 and a.n_chiplets == 2
    g = make_workload("tf-paper")
    rng = np.random.default_rng(B)
    groups = partition_graph(g, a, 8)
    reqs = [(groups[i % len(groups)],
             random_lms(groups[i % len(groups)], g, a.n_cores, a.n_dram,
                        rng)) for i in range(B)]
    return Evaluator(a, g, fused_device="cuda"), reqs


@pytest.mark.gpu
@pytest.mark.parametrize("B,cells", [(4, None), (64, None), (600, None),
                                     (4, 20_000), (4, "limit")])
def test_fused_eval_rows_are_bit_reproducible(cuda, B, cells):
    """``fused_eval`` on identical inputs gives identical rows, bit for
    bit, launch after launch: at the supervised fused sweep's shapes (the
    lockstep batch of 4 chains and a screen's 64 rows), at 600 rows
    (several blocks an SM: where the shared-memory atomics of the
    kernel's first design added in an order that changed from launch to
    launch) and on rows wide enough to sum in fewer shared-memory copies
    and several parts (20,000 cells) or in one copy (the limit).  A
    sweep's shard children must write the records a clean run writes, so
    no tolerance: ``torch.equal``.  The first launch's rows are also held
    against the plain version (``_fused_kernel_vs_plain``'s rel 1e-5)."""
    import dataclasses

    from repro_torch.kernels import fused_eval as fe
    ev, reqs = _sweep_batch(B)
    plan = ev.fused_plan()
    if cells is not None:
        cells = fe.max_cells(plan.device) if cells == "limit" else cells
        plan = dataclasses.replace(plan, buf_len=cells)
    args = [torch.from_numpy(a.copy()).to(cuda)
            for a in ev._fused_inputs(reqs, 8)]
    first = [t.clone() for t in fe.fused_eval(plan, *args)]
    want, wbn = ref.fused_eval_ref(
        *args, spans=plan.spans, d2d_mask=plan.d2d_mask, consts=plan.consts,
        has_d2d=plan.has_d2d, buf_len=plan.buf_len)
    torch.testing.assert_close(first[0], want, rtol=1e-5, atol=0.0)
    assert torch.equal(first[1], wbn)
    for _ in range(20):
        out = fe.fused_eval(plan, *args)
        assert all(torch.equal(a, b) for a, b in zip(first, out))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("tops,cells,parts", [(512, 6_638, 2),
                                              (1024, 13_138, 4)])
def test_fused_eval_wide_rows_in_parts(cuda, tops, cells, parts):
    """Rows too wide for 16 shared-memory copies (``tf-paper`` on the
    most-cored candidate of ``grid_candidates(tops)``, 4 rows at the
    sweep's batch of 8) are summed in parts: within the reference's
    parity envelope of the exact numpy engine (rel 1e-4, same
    bottleneck), one counted call, and the same bits launch after
    launch."""
    from repro_torch.core.dse import grid_candidates
    from repro_torch.core.encoding import random_lms
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.graph_partition import partition_graph
    from repro_torch.core.workloads import make_workload
    from repro_torch.kernels import fused_eval as fe
    a = max(grid_candidates(float(tops)), key=lambda a: a.n_cores)
    g = make_workload("tf-paper")
    rng = np.random.default_rng(tops)
    groups = partition_graph(g, a, 8)
    reqs = [(groups[i], random_lms(groups[i], g, a.n_cores, a.n_dram, rng))
            for i in rng.integers(len(groups), size=4)]
    ev = Evaluator(a, g, fused_device="cuda")
    plan = ev.fused_plan()
    assert plan.buf_len == cells and fe.splits(plan.device, cells) == parts
    exact = ev.eval_requests_batch(reqs, 8)
    n0 = fe.fused_eval.launches
    fused = ev.eval_requests_batch(reqs, 8, backend="fused")
    assert fe.fused_eval.launches == n0 + 1
    for (ge, _), (gf, _) in zip(exact, fused):
        assert ge.bottleneck == gf.bottleneck
        for f in ("delay_s", "energy_j", "stage_time_s"):
            x, y = getattr(ge, f), getattr(gf, f)
            assert abs(x - y) <= 1e-4 * abs(x), f
    args = [torch.from_numpy(x.copy()).to(cuda)
            for x in ev._fused_inputs(reqs, 8)]
    first = [t.clone() for t in fe.fused_eval(plan, *args)]
    for _ in range(5):
        out = fe.fused_eval(plan, *args)
        assert all(torch.equal(x, y) for x, y in zip(first, out))


@pytest.mark.gpu
def test_evaluate_rows_is_one_kernel_and_one_copy_each_way(cuda, tmp_path):
    """One ``evaluate_rows`` on the card, traced by ``torch.profiler``:
    exactly one kernel (``fused_rows``), one copy host to device, one
    device to host, and no memset."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import fused_eval as fe
    ev, reqs = _zoo_batch("moe-quick", 3)
    plan = ev.fused_plan()
    fe.evaluate_rows(plan, ev._fused_inputs(reqs, 8))      # buffers grown
    x = ev._fused_inputs(reqs, 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rows = fe.evaluate_rows(plan, x)
    trace = tmp_path / "evaluate_rows.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    cats = [e.get("cat") for e in events]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    copies = [e["name"] for e in events if e.get("cat") == "gpu_memcpy"]
    assert len(kernels) == 1 and "fused_rows" in kernels[0], kernels
    assert len(copies) == 2, copies
    assert sum("HtoD" in c for c in copies) == 1
    assert sum("DtoH" in c for c in copies) == 1
    assert "gpu_memset" not in cats
    assert rows.delay.shape == (len(reqs),)


@pytest.mark.gpu
@pytest.mark.parametrize("n,cells", [(500, 64), (1 << 20, 4096),
                                     (3_000_000, 1)])
def test_segment_replay_kernel_vs_bincount(cuda, n, cells):
    """Each cell's float64 entries added in stream order: equal to
    np.bincount (a serial scatter-add) bit for bit, on streams in random
    order, where every block's stretch is the whole stream, and on one
    cell."""
    from repro_torch.kernels.fused_eval import segment_replay
    rng = np.random.default_rng(n)
    idx = rng.integers(0, cells, size=n)
    vals = rng.normal(size=n)
    n0 = segment_replay.launches
    out = segment_replay(torch.from_numpy(idx).to(cuda),
                         torch.from_numpy(vals).to(cuda), cells)
    torch.cuda.synchronize()
    assert segment_replay.launches == n0 + 1
    want = np.bincount(idx, weights=vals, minlength=cells)
    assert np.array_equal(out.cpu().numpy(), want)
    with pytest.raises(TypeError, match="int64 and float64"):
        segment_replay(torch.from_numpy(idx.astype(np.int32)).to(cuda),
                       torch.from_numpy(vals).to(cuda), cells)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [4, 64, 200])
def test_segment_replay_is_bit_reproducible(cuda, B):
    """The analyzer's replay stream of ``B`` requests (at the sweep's
    shapes; 200 rows: more blocks than SMs) through ``segment_replay`` 200
    times gives one distinct result, equal to ``np.bincount``'s bits, and
    ``analyze_requests(backend="fused")`` equals the numpy backend's rows
    bit for bit."""
    from repro_torch.kernels.fused_eval import segment_replay
    ev, reqs = _sweep_batch(B)
    idx, vals, _ = ev.analyzer._request_streams(reqs, 8)
    n_cells = B * ev.analyzer._buf_len
    ti, tv = torch.from_numpy(idx).to(cuda), torch.from_numpy(vals).to(cuda)
    outs = torch.stack([segment_replay(ti, tv, n_cells) for _ in range(200)])
    assert torch.unique(outs, dim=0).shape[0] == 1
    assert np.array_equal(outs[0].cpu().numpy(),
                          np.bincount(idx, weights=vals, minlength=n_cells))
    exact = ev.analyzer.analyze_requests(reqs, 8)
    fused = ev.analyzer.analyze_requests(reqs, 8, backend="fused")
    assert np.array_equal(fused.buf, exact.buf)


@pytest.mark.gpu
def test_segment_replay_reuses_its_scratch(cuda):
    """The replay keeps its cell ranges' scratch from one call to the next
    (each launch leaves it as it found it): streams of growing, shrinking
    and empty cell counts, one after another on the same stream, each give
    ``np.bincount``'s bits."""
    from repro_torch.kernels.fused_eval import segment_replay
    rng = np.random.default_rng(3)
    for n, cells in [(5000, 300), (200_000, 70_000), (3000, 40),
                     (0, 17), (80_000, 70_000), (1000, 5000)]:
        idx = rng.integers(0, cells, size=n)
        vals = rng.normal(size=n)
        out = segment_replay(torch.from_numpy(idx).to(cuda),
                             torch.from_numpy(vals).to(cuda), cells)
        want = np.bincount(idx, weights=vals, minlength=cells)
        assert np.array_equal(out.cpu().numpy(), want), (n, cells)


@pytest.mark.gpu
def test_fused_replay_and_sa_on_the_card(cuda):
    """``analyze_requests(backend="fused")`` through the kernel within the
    reference's rtol 2e-4 / atol 1e-2 of the exact replay, and
    ``SAConfig(backend="fused")`` re-scoring its winner exactly."""
    from repro_torch.core.evaluator import CachedEvaluator, Evaluator
    from repro_torch.core.explore import replica_exchange_sa
    from repro_torch.core.graph_partition import partition_graph
    from repro_torch.core.sa import SAConfig
    ev, reqs = _zoo_batch("moe-quick", 2)
    exact = ev.analyzer.analyze_requests(reqs, 8)
    fused = ev.analyzer.analyze_requests(reqs, 8, backend="fused")
    np.testing.assert_allclose(fused.buf, exact.buf, rtol=2e-4, atol=1e-2)
    g, a = ev.g, ev.arch
    cfg = SAConfig(iters=40, seed=3, n_chains=3, backend="fused")
    res = replica_exchange_sa(g, a, partition_graph(g, a, 8), 8, cfg,
                              evaluator=CachedEvaluator(a, g))
    final = Evaluator(a, g).evaluate(res.mapping, 8)
    assert res.cost == final.cost(cfg.beta, cfg.gamma)


@pytest.mark.gpu
@pytest.mark.parametrize("fixture,name,spec,stages,launched", [
    ("granite-moe-3b-a800m.simba.ckpt.jsonl", "GRANITE",
     "lm:granite-moe-3b-a800m:seq=4096,n_layers=2", 162, (166, 2, 0)),
    ("mla-paper.simba.ckpt.jsonl", "MLA", "mla-paper", 5, (16, 2, 0))])
def test_family_fixture_kernel_route_vs_plain_route(cuda, fixture, name,
                                                    spec, stages, launched):
    """The two family fixtures realized at full width: the plan's launches
    in one pass, every stage cube within 2e-4 of the plain route's."""
    got = _kernel_route_vs_plain_route(cuda, fixture, name, spec)
    assert got[:2] == (stages, launched)
    assert got[2] < 2e-4


# ---------------------------------------------------------------------------
# the model and serving stack: the SSD state pass, flash with q_offset, the
# reduced models' kernel route (tolerances: the state pass 1e-4 as the SSD
# chunk kernel, the chunked SSD 2e-4; flash 2e-5 f32, 2e-2 bf16; the models
# in bf16 compute 2e-2 of the largest plain-route logit)
# ---------------------------------------------------------------------------

def _state_counts():
    from repro_torch.kernels import ssd_state
    return tuple(k.launches for k in (ssd_state.ssd_state_walk,
                                      ssd_state.ssd_state_scan,
                                      ssd_state.ssd_state_out))


# the state-pass kernels a route launches: (walk, scan, out)
_ROUTE_LAUNCHES = {"walk": (1, 0, 0), "split": (0, 1, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["walk", "split"])
@pytest.mark.parametrize("B,nc,Q,H,P,N,G,init,copies", [
    (4, 8, 128, 64, 64, 64, 1, False, "cp.async16"),    # zamba2 prefill
    (1, 32, 128, 16, 128, 64, 1, False, "cp.async16"),  # mamba2-370m path
    (4, 8, 128, 32, 64, 128, 1, False, "cp.async16"),   # mamba2-370m serve
    (2, 1, 128, 4, 64, 32, 1, False, "cp.async16"),     # nc = 1
    (2, 3, 70, 4, 130, 50, 2, True, "cp.async4"),       # P, N off 4; G 2
    (1, 5, 128, 6, 32, 128, 3, True, "cp.async16"),     # N 128, G 3
    (2, 4, 100, 4, 64, 13, 2, False, "cp.async4"),
    # enough blocks that the split's outputs take several heads a block
    # (ssd_state.out_heads on 132 SMs): 4 of a group of 4, Q, P, N ragged
    (4, 8, 100, 12, 130, 50, 3, True, "cp.async4"),
    (4, 8, 70, 16, 64, 13, 8, False, "cp.async4"),      # 2 of a group of 2
    # Q past 128: a block's warps take the rows in two rounds
    (1, 3, 200, 4, 64, 64, 1, True, "cp.async16"),
    (4, 8, 256, 32, 64, 32, 1, False, "cp.async16"),   # 4 heads a block
])
def test_ssd_state_pass_kernel_vs_plain(cuda, B, nc, Q, H, P, N, G, init,
                                        copies, route):
    """Each route of the state pass, forced by calling its kernels'
    wrappers, against the plain version: the route's kernels launch once
    each, with the copy width named."""
    from repro_torch.kernels import ssd_state
    rng = np.random.default_rng(B * nc + Q + N)
    y = _on_card(rng, (B, nc, Q, H, P), cuda)
    S = _on_card(rng, (B, nc, H, N, P), cuda) * 0.1
    cum = torch.cumsum(-_on_card(rng, (B, nc, Q, H), cuda).abs() * 0.05,
                       dim=2)
    C = _on_card(rng, (B, nc, Q, G, N), cuda)
    h0 = _on_card(rng, (B, H, N, P), cuda) if init else None
    n0 = _state_counts()
    if route == "walk":
        got = ssd_state.ssd_state_walk(y, S, cum, C, h0)
        rows = S
    else:
        rows, h = ssd_state.ssd_state_scan(S, cum, h0)
        got = ssd_state.ssd_state_out(y, rows, cum, C), h
    torch.cuda.synchronize()
    assert ssd_state.copy_width(C, rows) == copies
    assert tuple(a - b for a, b in zip(_state_counts(), n0)) \
        == _ROUTE_LAUNCHES[route]
    for a, b in zip(got, ref.ssd_state_ref(y, S, cum, C, h0)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_ssd_state_split_kernels_vs_their_plain_versions(cuda):
    """The split's two kernels each against its own plain version: the
    states of every chunk and the final state, then the outputs."""
    from repro_torch.kernels.ssd_state import ssd_state_out, ssd_state_scan
    rng = np.random.default_rng(11)
    B, nc, Q, H, P, N, G = 2, 5, 100, 6, 64, 128, 3
    y = _on_card(rng, (B, nc, Q, H, P), cuda)
    S = _on_card(rng, (B, nc, H, N, P), cuda) * 0.1
    cum = torch.cumsum(-_on_card(rng, (B, nc, Q, H), cuda).abs() * 0.05,
                       dim=2)
    C = _on_card(rng, (B, nc, Q, G, N), cuda)
    h0 = _on_card(rng, (B, H, N, P), cuda)
    got = ssd_state_scan(S, cum, h0)
    want = ref.ssd_state_scan_ref(S, cum, h0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ssd_state_out(y, want[0], cum, C),
                               ref.ssd_state_out_ref(y, want[0], cum, C),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,P,N,route", [
    (1, 16, 128, 64, "split"),  # the mamba2-370m realization shape: 32
    (4, 32, 64, 128, "walk"),   # its serve wave: 128 walks, one an SM
    (4, 64, 64, 64, "walk"),    # the zamba2-1.2b prefill wave: 256, two
    (1, 64, 64, 64, "split"),   # a zamba2 wave of one: 64
    (4, 32, 64, 64, "split"),   # 128 walks where two fit an SM
])
def test_state_route_rule_on_the_card(cuda, B, H, P, N, route):
    """The rule picks the walk where its B * H * ceil(P / 64) blocks fill
    their last wave of resident walks (two an SM at N <= 64, one above; an
    H100 SXM has 132 SMs) to at least 5/6, else the split; the plan
    declares the route's kernels, and ``ssd_state_pass`` launches them and
    names them in ``kernel_route``."""
    from repro_torch.kernels import ssd_state
    sms = ssd_state.sm_count(cuda)
    assert ssd_state.state_route(B, H, P, N, sms) == route
    assert ssd_state.route_kernels(B, H, P, N, cuda) \
        == ssd_state.ROUTE_KERNELS[route]
    rng = np.random.default_rng(B * H + P)
    nc, Q = 2, 64
    y = _on_card(rng, (B, nc, Q, H, P), cuda)
    S = _on_card(rng, (B, nc, H, N, P), cuda) * 0.1
    cum = torch.cumsum(-_on_card(rng, (B, nc, Q, H), cuda).abs() * 0.05,
                       dim=2)
    C = _on_card(rng, (B, nc, Q, 1, N), cuda)
    assert ssd_state.kernel_route(S, C) == f"{route} cp.async16"
    n0 = _state_counts()
    got = ssd_state.ssd_state_pass(y, S, cum, C)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_state_counts(), n0)) \
        == _ROUTE_LAUNCHES[route]
    for a, b in zip(got, ref.ssd_state_ref(y, S, cum, C)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("L,G,init,chunk", [(300, 1, False, 256),
                                            (512, 2, True, 256),
                                            (70, 2, False, 32),
                                            (1024, 1, True, 256)])
def test_ssd_chunked_kernel_route_vs_plain(cuda, L, G, init, chunk):
    """The model's chunked SSD on the card (the chunk kernel in chunks of
    at most 128, once per group, then the state pass: at B 2, H 8 the
    split's two kernels) against the plain version at the config's chunk,
    each counted once per call."""
    from repro_torch.nn.mamba2 import ssd_chunked, ssd_chunked_ref
    rng = np.random.default_rng(L + G)
    B, H, P, N = 2, 8, 64, 32
    x = _on_card(rng, (B, L, H, P), cuda)
    dt = _on_card(rng, (B, L, H), cuda).abs() * 0.1
    A = -_on_card(rng, (H,), cuda).abs()
    Bm, Cm = _on_card(rng, (B, L, G, N), cuda), _on_card(rng, (B, L, G, N),
                                                         cuda)
    h0 = _on_card(rng, (B, H, N, P), cuda) if init else None
    n0 = (ssd_chunk_dual.launches,) + _state_counts()
    y, h = ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, init_state=h0)
    torch.cuda.synchronize()
    n1 = (ssd_chunk_dual.launches,) + _state_counts()
    assert tuple(a - b for a, b in zip(n1, n0)) == (G, 0, 1, 1)
    wy, wh = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk, init_state=h0)
    torch.testing.assert_close(y, wy, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(h, wh, atol=2e-4, rtol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("L,G,init", [(300, 1, False), (512, 2, True)])
def test_ssd_chunked_n128_kernel_route_vs_plain(cuda, L, G, init):
    """The chunked SSD at mamba2-370m's state width N = 128 (heads of P =
    64) through the kernels against the plain version, within 2e-4."""
    from repro_torch.nn.mamba2 import ssd_chunked, ssd_chunked_ref
    rng = np.random.default_rng(L + 128)
    B, H, P, N = 2, 32, 64, 128
    x = _on_card(rng, (B, L, H, P), cuda)
    dt = _on_card(rng, (B, L, H), cuda).abs() * 0.1
    A = -_on_card(rng, (H,), cuda).abs()
    Bm, Cm = _on_card(rng, (B, L, G, N), cuda), _on_card(rng, (B, L, G, N),
                                                         cuda)
    h0 = _on_card(rng, (B, H, N, P), cuda) if init else None
    n0 = ssd_chunk_dual.launches
    y, h = ssd_chunked(x, dt, A, Bm, Cm, chunk=256, init_state=h0)
    torch.cuda.synchronize()
    assert ssd_chunk_dual.launches == n0 + G
    wy, wh = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=256, init_state=h0)
    torch.testing.assert_close(y, wy, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(h, wh, atol=2e-4, rtol=2e-4)


@pytest.mark.gpu
def test_ssd_chunked_refuses_a_state_past_the_chunk_kernels_range(cuda):
    """N = 129 is past ssd_chunk_dual's N <= 128: it raises, and nothing
    falls back to the plain version."""
    from repro_torch.nn.mamba2 import ssd_chunked
    x = torch.zeros((1, 64, 2, 64), device=cuda)
    dt = torch.ones((1, 64, 2), device=cuda)
    Bm = torch.zeros((1, 64, 1, 129), device=cuda)
    n0 = ssd_chunk_dual.launches
    with pytest.raises(ValueError, match="N <= 128"):
        ssd_chunked(x, dt, -torch.ones(2, device=cuda), Bm, Bm)
    assert ssd_chunk_dual.launches == n0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,Sq,Sk,D", [(2, 4, 128, 384, 64),
                                         (1, 32, 300, 1000, 64),
                                         (1, 2, 70, 200, 128),
                                         (1, 2, 33, 40, 32)])
def test_flash_attention_q_offset_vs_plain(cuda, dtype, tol, B, H, Sq, Sk,
                                           D):
    """Causal flash with ``q_offset = Sk - Sq`` (the model's cache mode:
    the queries are the last Sq positions) against the plain version on
    the upcast inputs."""
    rng = np.random.default_rng(Sq + Sk + D)
    q, k, v = (_on_card(rng, (B, H, n, D), cuda).to(dtype)
               for n in (Sq, Sk, Sk))
    got = flash_attention_mha(q, k, v, causal=True, q_offset=Sk - Sq)
    torch.cuda.synchronize()
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=True,
                             q_offset=Sk - Sq)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_offset", [
    (2, 4, 128, 384, 64, True, 256),     # cache mode: q_offset = Sk - Sq
    (1, 32, 300, 1000, 64, True, 700),
    (1, 2, 100, 300, 64, True, 0),       # Sq != Sk, top-left aligned
    (2, 3, 70, 45, 100, False, 0),       # not causal, D off the template
    (1, 2, 130, 130, 256, True, 0),      # the 256 template
    (1, 2, 33, 40, 32, True, 7),
])
def test_flash_attention_stats_vs_plain(cuda, dtype, tol, B, H, Sq, Sk, D,
                                        causal, q_offset):
    """``return_stats``: the output and each row's (m, l), f32 (B, H, Sq),
    against the plain version on the upcast inputs at the flash
    tolerances; one launch."""
    rng = np.random.default_rng(Sq + Sk + D + q_offset)
    q, k, v = (_on_card(rng, (B, H, n, D), cuda).to(dtype)
               for n in (Sq, Sk, Sk))
    n0 = flash_attention_mha.launches
    out, m, l = flash_attention_mha(q, k, v, causal=causal,
                                    q_offset=q_offset, return_stats=True)
    torch.cuda.synchronize()
    assert flash_attention_mha.launches == n0 + 1
    assert out.dtype == dtype and m.dtype == l.dtype == torch.float32
    assert m.shape == l.shape == (B, H, Sq)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             q_offset=q_offset, return_stats=True)
    for a, b in zip((out.float(), m, l), want):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_flash_attention_stats_with_no_key(cuda):
    """Sk = 0 (an empty old cache) launches nothing: zeros, m = -2e38 and
    l = 0, as the plain version gives."""
    q = torch.ones((1, 2, 70, 64), device=cuda)
    kv = torch.ones((1, 2, 0, 64), device=cuda)
    n0 = flash_attention_mha.launches
    out, m, l = flash_attention_mha(q, kv, kv, causal=False,
                                    return_stats=True)
    assert flash_attention_mha.launches == n0
    assert (out == 0).all() and (m == -2.0e38).all() and (l == 0).all()
    for a, b in zip((out, m, l), ref.attention_ref(q, kv, kv,
                                                   return_stats=True)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("pos,S", [(0, 1024), (512, 768)])
def test_attention_block_cache_stack_kernel_vs_plain(cuda, pos, S):
    """``cache_stack`` on the card (the old pages and the new segment each
    through the flash kernel with its statistics, merged) against
    ``use_kernels=False``, f32 compute: within 1e-4 (flash's 2e-5 through
    the merge and the output projection); the stacks written alike.  At
    pos = 0 the old cache is empty and only the segment launches."""
    from repro_torch.nn.attention import Attention
    rng = np.random.default_rng(pos + S)
    B, d, H, KV, hd, smax, li = 2, 256, 4, 2, 64, 2048, 1
    mod = Attention(d, H, KV, hd, device=cuda,
                    gen=torch.Generator(device=cuda).manual_seed(pos))
    x = _on_card(rng, (B, S, d), cuda)
    positions = (pos + torch.arange(S, device=cuda))[None]
    stacks = [_on_card(rng, (3, B, smax, KV, hd), cuda) for _ in range(2)]
    got = {}
    for use_kernels in (True, False):
        tk, tv = (t.clone() for t in stacks)
        n0 = flash_attention_mha.launches
        y, _ = mod(x, positions=positions, cache_stack=(tk, tv, li, pos),
                   compute_dtype=torch.float32, use_kernels=use_kernels)
        torch.cuda.synchronize()
        got[use_kernels] = (y, tk, tv, flash_attention_mha.launches - n0)
    assert got[True][3] == (1 if pos == 0 else 2) and got[False][3] == 0
    torch.testing.assert_close(got[True][0], got[False][0], atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(got[True][1], got[False][1])
    assert torch.equal(got[True][2], got[False][2])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["tiled_matmul", "flash_attention_mha",
                                    "ssd_chunk_dual", "ssd_state_walk",
                                    "ssd_state_scan", "ssd_state_out"])
def test_kernel_wrappers_refuse_an_input_that_requires_grad(cuda, kernel):
    """A kernel fills its outputs outside autograd's graph, so a CUDA input
    that requires grad raises, naming ``use_kernels=False``, and launches
    nothing; under ``torch.no_grad()`` the same call launches the kernel."""
    from repro_torch.kernels import ssd_state
    rng = np.random.default_rng(21)
    t = lambda *shape: _on_card(rng, shape, cuda)
    dec = lambda *shape: torch.cumsum(-t(*shape).abs() * 0.05, dim=-2)
    calls = {
        "tiled_matmul": (tiled_matmul, lambda: (t(64, 32), t(32, 16))),
        "flash_attention_mha": (flash_attention_mha, lambda: (
            t(1, 2, 64, 32), t(1, 2, 64, 32), t(1, 2, 64, 32))),
        "ssd_chunk_dual": (ssd_chunk_dual, lambda: (
            t(2, 16, 2, 8), dec(2, 16, 2), t(2, 16, 4), t(2, 16, 4))),
        "ssd_state_walk": (ssd_state.ssd_state_walk, lambda: (
            t(1, 2, 16, 2, 8), t(1, 2, 2, 4, 8), dec(1, 2, 16, 2),
            t(1, 2, 16, 1, 4))),
        "ssd_state_scan": (ssd_state.ssd_state_scan, lambda: (
            t(1, 2, 2, 4, 8), dec(1, 2, 16, 2))),
        "ssd_state_out": (ssd_state.ssd_state_out, lambda: (
            t(1, 2, 16, 2, 8), t(1, 2, 2, 4, 8), dec(1, 2, 16, 2),
            t(1, 2, 16, 1, 4))),
    }
    fn, make = calls[kernel]
    args = [a.clone() for a in make()]
    args[0].requires_grad_()
    n0 = fn.launches
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        fn(*args)
    assert fn.launches == n0
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1


@pytest.mark.gpu
def test_loss_fn_through_the_kernels_refuses_grad(cuda):
    """``models/lm.py::loss_fn(use_kernels=True)`` on the card, with
    parameters that require grad, raises at its first kernel (a reduced
    mamba2-370m: the SSD chunk kernel), naming ``use_kernels=False``; the
    plain route differentiates (a finite gradient on every parameter that
    gets one, the SSD layers' included); under ``torch.no_grad()`` both
    routes give the same loss (f32 compute, rel 1e-4)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_api
    cfg = get_config("mamba2-370m").reduced().replace(
        compute_dtype="float32")
    api = model_api(cfg)
    params = api.init_params(torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (2, 65)).astype(np.int64)).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params.requires_grad_(True)
    n0 = ssd_chunk_dual.launches
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        api.loss_fn(params, batch, use_kernels=True)
    assert ssd_chunk_dual.launches == n0
    loss, _ = api.loss_fn(params, batch, use_kernels=False)
    loss.backward()
    grads = {n: p.grad for n, p in params.named_parameters()}
    assert any(g is not None for n, g in grads.items() if "mamba" in n)
    assert all(torch.isfinite(g).all() for g in grads.values()
               if g is not None)
    with torch.no_grad():
        got = api.loss_fn(params, batch, use_kernels=True)[0]
        want = api.loss_fn(params, batch, use_kernels=False)[0]
    assert ssd_chunk_dual.launches > n0
    assert abs(got - want).item() <= 1e-4 * abs(want).item()


def _served_logits(api, params, toks, use_kernels, dev):
    """Prefill of ``toks`` into a 2048-position cache (so attention takes
    the flash path), then two decode steps fed ``toks``' first tokens."""
    cache = api.init_cache(toks.shape[0], 2048, device=dev)
    lg, cache = api.prefill(params, {"tokens": toks}, cache,
                            use_kernels=use_kernels)
    out = [lg]
    for t in range(2):
        lg, cache = api.decode_step(params, toks[:, t:t + 1], cache,
                                    use_kernels=use_kernels)
        out.append(lg)
    torch.cuda.synchronize()
    return torch.stack(out)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-0.6b", "mamba2-370m",
                                  "mamba2-370m:N=128", "zamba2-1.2b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_reduced_models_kernel_route_vs_plain(cuda, arch):
    """A reduced model's prefill of 300 tokens and two decode steps,
    through the kernels and with ``use_kernels=False`` on the same card.
    f32 compute: within 1e-3 of the largest plain-route logit (the caches
    are bf16: an entry that rounds the other way moves by a bf16 ulp;
    MoE with capacity factor 8, as the reference's decode test).  bf16
    compute (not MoE, whose top-k routing flips on bf16 near ties): within
    the larger of 2e-2 and the plain route's own bf16-vs-f32 gap.  The
    kernels launch on the kernel route only."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_api
    name, _, n = arch.partition(":N=")
    cfg = get_config(name).reduced()
    if n:       # reduced() cuts the state width; the config's own is 128
        cfg = cfg.replace(ssm_state=int(n))
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=8.0)
    params = model_api(cfg).init_params(
        torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 300)).astype(np.int32)).to(cuda)
    counts = lambda: (flash_attention_mha.launches, ssd_chunk_dual.launches,
                      sum(_state_counts()))
    out, launched = {}, {}
    for cdt in ("float32", "bfloat16"):
        api = model_api(cfg.replace(compute_dtype=cdt))
        for use_kernels in (True, False):
            n0 = counts()
            out[cdt, use_kernels] = _served_logits(api, params, toks,
                                                   use_kernels, cuda)
            launched[use_kernels] = [a - b for a, b in zip(counts(), n0)]
    ssm = cfg.family in ("ssm", "hybrid")
    attn = cfg.family != "ssm"
    assert launched[False] == [0, 0, 0]
    flash, chunk, state = launched[True]
    assert (flash > 0) == attn and (chunk > 0) == ssm and (state > 0) == ssm
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    got, want = out["float32", True], out["float32", False]
    assert torch.isfinite(got).all() and rel(got, want) <= 1e-3
    if cfg.family != "moe":
        gap = rel(out["bfloat16", False], want)
        assert rel(out["bfloat16", True], out["bfloat16", False]) \
            <= max(2e-2, gap)


@pytest.mark.gpu
def test_moe_bf16_kernel_route_vs_plain_with_the_routing_held(cuda,
                                                              monkeypatch):
    """The MoE model's bf16 leg, left out above because top-k routing flips
    on bf16 near ties: every MoE layer's expert choice is taken, call by
    call, from the plain route's f32 pass, in both routes and both compute
    types (each route keeps its own gate values at those experts).  The
    reduced phi3.5-moe's prefill of 300 tokens and two decode steps: f32
    within 1e-3 of the plain route, bf16 within the larger of 2e-2 and the
    plain route's own bf16-vs-f32 gap, as the other models'."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_api
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced().replace(
        capacity_factor=8.0)
    params = model_api(cfg).init_params(
        torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 300)).astype(np.int32)).to(cuda)
    topk = torch.topk
    routing = {"chosen": [], "replay": None}

    def held_topk(probs, k, dim=-1):
        if routing["replay"] is None:
            vals, idx = topk(probs, k, dim=dim)
            routing["chosen"].append(idx)
            return vals, idx
        idx = routing["replay"].pop(0)
        return probs.gather(dim, idx), idx

    monkeypatch.setattr(torch, "topk", held_topk)
    api = {c: model_api(cfg.replace(compute_dtype=c))
           for c in ("float32", "bfloat16")}
    out = {("float32", False): _served_logits(api["float32"], params, toks,
                                              False, cuda)}
    assert routing["chosen"]
    n0 = flash_attention_mha.launches
    for key in (("float32", True), ("bfloat16", False), ("bfloat16", True)):
        routing["replay"] = list(routing["chosen"])
        out[key] = _served_logits(api[key[0]], params, toks, key[1], cuda)
        assert routing["replay"] == []
    assert flash_attention_mha.launches > n0
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    want = out["float32", False]
    assert rel(out["float32", True], want) <= 1e-3
    gap = rel(out["bfloat16", False], want)
    assert torch.isfinite(out["bfloat16", True]).all()
    assert rel(out["bfloat16", True], out["bfloat16", False]) \
        <= max(2e-2, gap)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", [
    (4, 12, 1500, 1500, 64, False),     # whisper's encoder: 30 s of audio
    (4, 12, 448, 1500, 64, False),      # its cross-attention, 448 tokens
    (4, 12, 916, 916, 64, True)])       # a served wave's decoder prefill
def test_flash_attention_at_whispers_shapes_bf16_vs_plain(cuda, B, H, Sq, Sk,
                                                          D, causal):
    """bf16 flash at whisper-small's shapes (D = 64, H = 12; Sk = 1500 is
    not a multiple of the kv tile) against the plain version on the upcast
    inputs, at the bf16 tolerance."""
    rng = np.random.default_rng(Sq * Sk + causal)
    q = torch.from_numpy(_randn(rng, (B, H, Sq, D))).to(cuda).bfloat16()
    k, v = (torch.from_numpy(_randn(rng, (B, H, Sk, D))).to(cuda).bfloat16()
            for _ in range(2))
    n0 = flash_attention_mha.launches
    got = flash_attention_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_mha.launches == n0 + 1 and got.dtype == q.dtype
    torch.testing.assert_close(
        got.float(), ref.attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_reduced_whisper_kernel_route_vs_plain(cuda):
    """A reduced ``whisper-small``'s prefill of 800 frames and 700 tokens
    into a 2048-position cache (every attention mode takes the flash path:
    the encoder at 800 x 800, the decoder's self-attention at 700 x 2048,
    cross-attention at 700 x 800) and two decode steps, through the
    kernels and with ``use_kernels=False`` on the same card: within 1e-3
    of the largest plain-route logit in f32 compute, and in bf16 within
    the larger of 2e-2 and the plain route's own bf16-vs-f32 gap.  The
    kernel route launches flash 3 times a layer pair; the plain, never."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_api
    cfg = get_config("whisper-small").reduced()
    params = model_api(cfg).init_params(
        torch.Generator(device=cuda).manual_seed(0), cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    batch = {"embeds": torch.randn((2, 800, cfg.d_model), generator=gen,
                                   device=cuda) * 0.02,
             "tokens": torch.randint(1, cfg.vocab, (2, 700), generator=gen,
                                     device=cuda, dtype=torch.int32)}
    out, launched = {}, {}
    for cdt in ("float32", "bfloat16"):
        api = model_api(cfg.replace(compute_dtype=cdt))
        for use_kernels in (True, False):
            n0 = flash_attention_mha.launches
            cache = api.init_cache(2, 2048, device=cuda)
            lg, cache = api.prefill(params, batch, cache,
                                    use_kernels=use_kernels)
            steps = [lg]
            for t in range(2):
                lg, cache = api.decode_step(
                    params, batch["tokens"][:, t:t + 1], cache,
                    use_kernels=use_kernels)
                steps.append(lg)
            torch.cuda.synchronize()
            out[cdt, use_kernels] = torch.stack(steps)
            launched[use_kernels] = flash_attention_mha.launches - n0
    assert launched == {True: cfg.n_enc_layers + 2 * cfg.n_layers,
                        False: 0}
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    want = out["float32", False]
    assert torch.isfinite(out["float32", True]).all()
    assert rel(out["float32", True], want) <= 1e-3
    gap = rel(out["bfloat16", False], want)
    assert rel(out["bfloat16", True], out["bfloat16", False]) \
        <= max(2e-2, gap)


@pytest.mark.gpu
def test_trace_replay_over_the_model_executor_on_the_card(cuda):
    """``replay`` of a seeded trace over the port's ``ModelWaveExecutor``
    on the card: every request answered in the wave policy, on measured
    wall time, through the SSD kernels (a reduced ``mamba2-370m``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_api
    from repro_torch.runtime.serve_loop import ModelWaveExecutor
    from repro_torch.serve import WaveExecutor, make_trace, replay
    cfg = get_config("mamba2-370m").reduced()
    params = model_api(cfg).init_params(
        torch.Generator(device=cuda).manual_seed(0), cuda)
    ex = ModelWaveExecutor(cfg, params, max_batch=4, max_seq=512)
    assert isinstance(ex, WaveExecutor) and ex.device.type == "cuda"
    trace = make_trace("poisson:rate=50,n=10,seed=0,plen=40..300,new=2..6")
    n0 = ssd_chunk_dual.launches
    rep = replay(trace, ex, mode="wave")
    assert ssd_chunk_dual.launches > n0
    assert len(rep.requests) == 10 and rep.n_waves >= 3
    assert sorted(tl.rid for tl in rep.requests) == list(range(10))
    for tl in rep.requests:
        assert tl.enqueue_t <= tl.start_t <= tl.first_token_t <= tl.finish_t
        assert 1 <= tl.n_tokens <= trace.requests[tl.rid].max_new
    s = rep.summary()
    assert s["e2e_s"]["p99"] >= s["ttft_s"]["p99"] > 0


def _kernel_counts():
    from repro_torch.kernels import ssd_state
    return {"tiled_matmul": tiled_matmul.launches,
            "flash_attention_mha": flash_attention_mha.launches,
            "ssd_chunk_dual": ssd_chunk_dual.launches,
            **{k: getattr(ssd_state, k).launches
               for k in ("ssd_state_walk", "ssd_state_scan",
                         "ssd_state_out")}}


@pytest.mark.gpu
@pytest.mark.parametrize("arch,seq", [("smollm-135m", 768),
                                      ("mamba2-370m", 256)])
def test_trainer_steps_on_the_card_through_the_plain_routes(cuda, arch, seq,
                                                            tmp_path):
    """``Trainer`` on the card, a reduced config at a length where the
    eval forward takes the kernels (smollm: the flash rule; mamba2: the
    SSD kernels): two steps with a checkpoint after each, finite losses,
    no kernel launched; then ``loss_fn(use_kernels=True)`` with the
    trained parameters under autograd raises, and under ``torch.no_grad``
    launches the kernels and agrees with the plain route (f32 compute,
    rel 1e-4)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.steps import to_device
    from repro_torch.models import model_api
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, Trainer
    cfg = get_config(arch).reduced().replace(compute_dtype="float32",
                                             remat=True)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=2)
    tr = Trainer(cfg, data, TrainConfig(
        steps=2, ckpt_every=1, ckpt_dir=str(tmp_path), log_every=1,
        opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)),
        device=cuda)
    n0 = _kernel_counts()
    out = tr.run(resume=False)
    assert _kernel_counts() == n0
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert all(np.isfinite(r["grad_norm"]) for r in tr.metrics_log)
    assert tr.mgr.steps() == [1, 2]
    params = out["state"]["params"]
    assert params.embed.embedding.is_cuda and params.embed.embedding \
        .requires_grad
    batch = to_device(make_batch(data, 2), cuda)
    api = model_api(cfg)
    with pytest.raises(RuntimeError, match="no backward"):
        api.loss_fn(params, batch, use_kernels=True)
    with torch.no_grad():
        got = api.loss_fn(params, batch, use_kernels=True)[0]
        want = api.loss_fn(params, batch, use_kernels=False)[0]
    assert _kernel_counts() != n0
    assert abs(got - want).item() <= 1e-4 * abs(want).item()


@pytest.mark.gpu
def test_async_checkpoint_of_a_card_state_holds_the_saved_step(cuda,
                                                                tmp_path):
    """The async writer writes the state of the step ``save`` was given,
    though the next train step updates the card's tensors in place before
    the write ends."""
    from repro_torch.checkpoint.ckpt import CheckpointManager, to_host
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.steps import (make_train_step, state_tree,
                                          to_device, train_state)
    from repro_torch.models import model_api
    cfg = get_config("smollm-135m").reduced()
    params = model_api(cfg).init_params(
        torch.Generator(device=cuda).manual_seed(0), cuda)
    state = train_state(params)
    step = make_train_step(cfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2)
    state, _ = step(state, to_device(make_batch(data, 0), cuda))
    want = {k: to_host(v) for k, v in state_tree(state)["params"].items()}
    mgr = CheckpointManager(tmp_path, async_write=True)
    mgr.save(state_tree(state), 1)
    state, _ = step(state, to_device(make_batch(data, 1), cuda))
    mgr.wait()
    moved = state_tree(state)["params"]
    assert any(not np.array_equal(to_host(moved[k]), want[k]) for k in want)
    got, at = mgr.restore_latest(state_tree(state))
    assert at == 1
    for k, v in want.items():
        assert got["params"][k].is_cuda
        np.testing.assert_array_equal(to_host(got["params"][k]), v)
    assert int(got["opt"]["step"]) == 1


# ---------------------------------------------------------------------------
# the supervised sweep scoring on the card (chip_smoke.py's sweep:fused)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fused_sweep():
    """The fused sweep's spec (``chip_smoke.SWEEP_FUSED_SPEC``: tf-paper on
    the quick spec's grid, 4 chains x 200 iterations on the fused pass)
    and its clean in-process run's results, each winner's energy and delay
    equal to the bit to an independent exact evaluator's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from repro_torch.core.dse import run_dse
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.dist.supervisor import SweepSpec
    from repro_torch.launch.sweep_ctl import _sig
    spec = SweepSpec(
        workloads={"tf": "tf-paper"},
        grid=dict(tops=72.0, mac_options=[512, 1024], cut_options=[1, 2],
                  dram_per_tops=[2.0], noc_options=[16, 32],
                  d2d_ratio=[0.5], glb_options=[1024]),
        sa=dict(iters=200, seed=0, n_chains=4, backend="fused"),
        cfg=dict(batch=8), n_shards=2)
    wls, cfg = spec.build_workloads(), spec.build_cfg()
    clean = run_dse(spec.build_candidates(), wls,
                    dataclasses.replace(cfg, keep_mappings=True))
    for p in clean:
        for name, got in p.per_workload.items():
            r = Evaluator(p.arch, wls[name]).evaluate(p.mappings[name],
                                                      cfg.batch)
            assert got == (r.energy_j, r.delay_s)
    return spec, _sig(clean)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["kill", "dup"])
def test_fused_supervised_sweep_equals_the_clean_fused_run(cuda, fused_sweep,
                                                           tmp_path, kind):
    """Two shard children scoring on ``fused_eval`` on the card, one fault
    injected (a killed child's work re-dispatched; a duplicate dispatch
    whose twin records must merge without conflict): the merged results
    equal the clean fused run's bit for bit, and each child that finished
    launched the kernel once an iteration of each task it ran, less at
    most 2 a task whose proposals were all cached (its metrics
    snapshot; a killed child writes none)."""
    import json

    from repro_torch import obs
    from repro_torch.dist.hosts import LocalProcessHost
    from repro_torch.dist.supervisor import Supervisor, supervised_results
    from repro_torch.launch.sweep_ctl import _sig
    spec, want = fused_sweep
    obs.enable(tmp_path / "obs")
    try:
        s = Supervisor(spec, out_dir=tmp_path / "out",
                       hosts=[LocalProcessHost(name=f"local{i}",
                                               retry_seed=100 + i)
                              for i in range(2)],
                       poll_s=0.2, fault_kind=kind, fault_seed=0)
        merged = s.run()
    finally:
        obs.disable()
        obs.metrics.reset()
    assert _sig(supervised_results(spec, merged)) == want
    snaps = [json.loads(p.read_text())["counters"]
             for p in (tmp_path / "obs").glob("*/metrics.json")]
    iters = spec.sa["iters"]
    assert snaps and all(
        c.get("engine.tasks", 0) and (iters - 2) * c["engine.tasks"]
        <= c.get("fused_eval.launches", 0) <= iters * c["engine.tasks"]
        for c in snaps), snaps
    assert sum(c.get("group_eval_fused.misses", 0) for c in snaps) > 0


# ---------------------------------------------------------------------------
# plan execution and the data-parallel collective
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_pipeline_on_the_card_equals_monolithic(cuda):
    """``PipelineExec`` on the card (``devices=None`` is every CUDA
    device; the forward runs on ``[cuda]``) of a 4-layer
    smollm-135m-width plan at seq 1024, 2 microbatches, f32 compute:
    building it leaves the caller's params where they were, each block's
    attention takes the flash kernel once a microbatch (8 launches), and
    the logits are within the reference test's atol = rtol = 2e-3 of the
    monolithic forward through the kernels and through the plain route."""
    from repro_torch.configs import get_config
    from repro_torch.core.bridge import mesh_as_arch, plan_for_graph
    from repro_torch.core.workloads.lm_graph import lm_graph
    from repro_torch.models import lm
    from repro_torch.runtime.pipeline import PipelineExec
    cfg = get_config("smollm-135m").replace(n_layers=4, vocab=2048,
                                            compute_dtype="float32")
    plan = plan_for_graph(lm_graph(cfg, seq=1024), mesh_as_arch(2, 2, 1), 2,
                          sa_iters=100)
    params = lm.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                            device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 1024), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    before = [p.device for p in params.parameters()]
    assert PipelineExec(cfg, params, plan).devices == [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    pipe = PipelineExec(cfg, params, plan, devices=[cuda])
    assert [p.device for p in params.parameters()] == before
    n0 = flash_attention_mha.launches
    got = pipe.forward(toks, n_micro=2)
    assert flash_attention_mha.launches - n0 == cfg.n_layers * 2
    assert len(pipe.stage_times) == len(plan.stages)
    with torch.no_grad():
        for uk in (True, False):
            want, _, _ = lm.forward(cfg, params, {"tokens": toks},
                                    mode="train", use_kernels=uk)
            torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


@pytest.mark.gpu
def test_compressed_dp_step_on_one_nccl_rank(cuda):
    """``make_compressed_dp_step`` on a one-rank NCCL mesh on the card (the
    mesh starts its own group): the reference test's regression converges
    (last loss < 0.05 x the first), and one rank's synced mean is its int8
    ``q * scale``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                         init_error_state, init_opt_state)
    from repro_torch.optim.compressed_dp import (compressed_grad_sync,
                                                 make_compressed_dp_step)
    mesh = make_host_mesh((1,), ("data",))
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        rng = np.random.default_rng(0)
        W = torch.as_tensor(rng.normal(size=(16, 4)), dtype=torch.float32,
                            device=cuda)
        ocfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                           total_steps=200, min_lr_ratio=1.0, grad_clip=0.0)
        step = make_compressed_dp_step(
            lambda p, b: torch.mean((b["x"] @ p["w"] - b["y"]) ** 2),
            lambda p, g, o: adamw_update(ocfg, p, g, o), mesh, "data")
        params = {"w": torch.zeros(16, 4, device=cuda)}
        opt, err = init_opt_state(params), init_error_state(params)
        losses = []
        for _ in range(60):
            x = torch.as_tensor(rng.normal(size=(64, 16)),
                                dtype=torch.float32, device=cuda)
            params, opt, err, m = step(params, opt, err, {"x": x,
                                                          "y": x @ W})
            losses.append(m["loss"].item())
        assert losses[-1] < 0.05 * losses[0]
        g = torch.randn(333, device=cuda)
        mean, _ = compressed_grad_sync({"g": g}, {"g": torch.zeros_like(g)},
                                       mesh.get_group("data"))
        scale = g.abs().max() / 127.0
        assert torch.equal(mean["g"], torch.round(g / scale) * scale)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_flash_through_local_map_on_one_rank_equals_the_direct_call(cuda):
    """Attention on DTensors of a one-rank NCCL mesh runs the flash kernel
    on the shards through ``local_map``: one launch, and the output and
    statistics equal the direct call's bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn.attention import multihead_attention
    mesh = make_host_mesh((1, 1))
    try:
        gen = torch.Generator(device=cuda).manual_seed(0)
        q, k, v = (torch.randn(2, 1024, 4, 64, device=cuda, generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
        pl = (Shard(0), Shard(2))
        qd, kd, vd = (distribute_tensor(t, mesh, pl) for t in (q, k, v))
        flash_attention_mha.launches = 0
        got = multihead_attention(qd, kd, vd, n_kv=4, return_stats=True)
        assert flash_attention_mha.launches == 1
        want = ops.flash_attention(q, k, v, causal=True, return_stats=True)
        assert tuple(got[0].placements) == pl
        assert tuple(got[1].placements) == (Shard(0), Shard(1))
        for g, w in zip(got, want):
            assert torch.equal(g.to_local(), w)
        # context parallel: the query rows sharded, keys whole
        qs = distribute_tensor(q, mesh, (Shard(0), Shard(1)))
        kr, vr = (distribute_tensor(t, mesh, (Shard(0), Replicate()))
                  for t in (k, v))
        out = multihead_attention(qs, kr, vr, n_kv=4)
        assert torch.equal(out.to_local(), want[0])
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m"])
def test_cell_bundles_on_one_nccl_rank_equal_the_eager_route(cuda, arch):
    """The ``cells`` phase of ``chip_smoke.py`` at full width and two
    layers: the prefill and decode bundles on a one-rank NCCL mesh launch
    the eager route's kernels and give its logits bit for bit; the train
    bundle (``zero1`` on and off) gives ``make_train_step``'s losses
    within rel 1e-5 and launches no kernel."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import ssd_state
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_api
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    cfg = get_config(arch).replace(n_layers=2)
    api = model_api(cfg)
    wrappers = (flash_attention_mha, ssd_chunk_dual, ssd_state.ssd_state_walk,
                ssd_state.ssd_state_scan, ssd_state.ssd_state_out)

    def counts():
        return [w.launches for w in wrappers]

    mesh = make_host_mesh((1, 1))
    try:
        B, S, n_dec = 2, 1024, 3
        model = api.init_params(torch.Generator(device=cuda).manual_seed(0),
                                cuda).to(torch.bfloat16)
        params = {n: p.detach() for n, p in model.named_parameters()}
        toks = torch.randint(1, cfg.vocab, (B, S), device=cuda,
                             dtype=torch.int32,
                             generator=torch.Generator(device=cuda)
                             .manual_seed(1))
        for w in wrappers:
            w.launches = 0
        cache = api.init_cache(B, S + n_dec, device=cuda)
        lg, cache = api.prefill(model, {"tokens": toks}, cache)
        want, feed = [lg], []
        for _ in range(n_dec):
            feed.append(want[-1].argmax(-1).to(torch.int32)[:, None])
            lg, cache = api.decode_step(model, feed[-1], cache)
            want.append(lg)
        eager = counts()
        assert sum(eager) > 0
        pb = steps.make_prefill_bundle(cfg, ShapeConfig("p", S, B,
                                                        "prefill"), mesh)
        db = steps.make_decode_bundle(cfg, ShapeConfig("d", S + n_dec, B,
                                                       "decode"), mesh)
        for w in wrappers:
            w.launches = 0
        pd, bd, cd = pb.place(params, {"tokens": toks},
                              api.init_cache(B, S + n_dec, device=cuda))
        lg, cd = pb.fn(pd, bd, cd)
        got = [lg.to_local()]
        for cur in feed:
            lg, cd = db.fn(pd, db.place(None, cur, None)[1], cd)
            got.append(lg.to_local())
        assert counts() == eager
        for g, w in zip(got, want):
            assert torch.equal(g, w)

        S, B, n = 256, 2, 3
        data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
        batches = [{k: v for k, v in steps.to_device(
            make_batch(data, i), cuda).items() if k in ("tokens", "labels")}
            for i in range(n)]
        ocfg = AdamWConfig(lr=6e-4, warmup_steps=1, total_steps=n)
        model = api.init_params(torch.Generator(device=cuda).manual_seed(0),
                                cuda)
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        state, step = steps.train_state(model), steps.make_train_step(cfg,
                                                                      ocfg)
        eager = []
        for b in batches:
            state, m = step(state, b)
            eager.append(m["loss"].item())
        for zero1 in (True, False):
            tb = steps.make_train_bundle(cfg, ShapeConfig("t", S, B, "train"),
                                         mesh, zero1=zero1, opt_cfg=ocfg)
            p = {k: t.clone() for k, t in init.items()}
            st = tb.place({"params": p, "opt": init_opt_state(p)}, None)[0]
            for w in wrappers:
                w.launches = 0
            for b, want_loss in zip(batches, eager):
                st, m = tb.fn(st, tb.place(None, b)[1])
                assert m["loss"].to_local().item() == pytest.approx(
                    want_loss, rel=1e-5)
            assert not any(counts())
    finally:
        dist.destroy_process_group()


# the mesh realization on two ranks sharing the card (gloo): each rank's
# launches are its part's, the gathered cubes the logical route's
_MESH_RANKS = '''
import json, sys
from pathlib import Path
import torch
import torch.distributed as dist

def rank_main(out):
    from repro_torch.core.bridge import plan_from_tuples
    from repro_torch.kernels import ssd_state
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.realize.plan import hand_plans
    from repro_torch.realize.program import build_program
    wrappers = {"tiled_matmul": tiled_matmul,
                "flash_attention_mha": flash_attention_mha,
                "ssd_chunk_dual": ssd_chunk_dual,
                **{k: getattr(ssd_state, k) for k in (
                    "ssd_state_walk", "ssd_state_scan", "ssd_state_out")}}
    res = {}
    # the SSD plan's heads over two ranks in reverse order, the flash
    # plan's 128 query rows over two
    for name in ("ssd", "flash"):
        g, plan = plan_from_tuples(*hand_plans(ranks=2, seq=128)[name])
        prog = build_program(g, plan, device="cuda", mesh=[0, 1])
        for w in wrappers.values():
            w.launches = 0
        run = prog.execute(seed=0)
        torch.cuda.synchronize()
        counted = {k: w.launches for k, w in wrappers.items() if w.launches}
        declared = {}
        for sp in prog.stages:
            if sp.pos is not None:
                for k, _ in sp.launches_at(sp.pos):
                    declared[k] = declared.get(k, 0) + 1
        logical = build_program(g, plan, device="cuda").execute(seed=0)
        err = None                  # the cubes are gathered on rank 0
        if dist.get_rank() == 0:
            err = max(((run["outputs"][n] - x).abs().max()
                       / x.abs().max().clamp_min(1e-9)).item()
                      for n, x in logical["outputs"].items())
        mine = {"counted": counted, "declared": declared, "err": err,
                "dci": run["dci_bytes"] == logical["dci_bytes"],
                "ici": run["ici_bytes"], "device": str(prog.device)}
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        res[name] = ranks
    if dist.get_rank() == 0:
        Path(out).write_text(json.dumps(res))


if __name__ == "__main__":
    from repro_torch.launch.mesh import start_local_ranks
    start_local_ranks(2, rank_main, (sys.argv[1],), device_type="cuda")
'''


@pytest.mark.gpu
def test_mesh_realization_on_two_ranks_sharing_the_card(cuda, tmp_path):
    """Two gloo ranks share the card: each rank launches exactly its part's
    kernels (GEMM, flash on its query rows, the SSD chunk kernel and the
    state pass on its head), the gathered cubes are within 2e-4 of the
    logical route's on the same seed, the DCI bytes equal, and the stages
    measure all-gather bytes."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    script = tmp_path / "ranks.py"
    script.write_text(_MESH_RANKS)
    env = {**os.environ, "PYTHONPATH": str(repo / "src")}
    r = subprocess.run([sys.executable, str(script), str(tmp_path / "o.json")],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=repo)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads((tmp_path / "o.json").read_text())
    for name, ranks in res.items():
        assert ranks[0]["err"] <= 2e-4, name
        for got in ranks:
            assert got["counted"] == got["declared"] and got["counted"], name
            assert got["dci"], name
            assert got["device"] == "cuda:0"
        assert any(ranks[0]["ici"]), name
    assert "ssd_chunk_dual" in res["ssd"][0]["counted"]
    assert "flash_attention_mha" in res["flash"][0]["counted"]
