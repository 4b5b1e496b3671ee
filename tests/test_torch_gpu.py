"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so it runs on the card's machine:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of ``tests/test_kernels.py``: atol 1e-3 / rtol 1e-4
for the f32 GEMM, 2e-5 for f32 attention, 1e-4 for the SSD chunk kernel
and 2e-4 for the chunked SSD; for bf16 operands, GEMM atol 0.5 / rtol
5e-2 and attention 2e-2 against the plain version on the upcast inputs
(the SSD kernel returns f32 and keeps 1e-4).  TF32 is off for the plain
versions.  The three kernels compute in 3xTF32 on the tensor cores; each
of their tile or head-dim configurations and copy widths is driven here,
for f32 and for bf16.
"""

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


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(2048, 512, 512), (2048, 512, 2048),
                                   (2048, 2048, 512), (4096, 1024, 4384),
                                   (4096, 2048, 1024), (100, 300, 50),
                                   (257, 129, 65), (1000, 77, 3)])
def test_tiled_matmul_kernel_vs_plain(cuda, M, K, N):
    rng = np.random.default_rng(M * K + N)
    a = torch.from_numpy(_randn(rng, (M, K))).to(cuda)
    b = torch.from_numpy(_randn(rng, (K, N))).to(cuda)
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
    (2048, 512, 512, False, "64x64 cp.async16"),    # 64 big tiles: small
    (2048, 512, 2048, False, "128x128 cp.async16"),
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
    got = tiled_matmul(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.matmul_ref(a, b),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,offset,route", [
    (1, 2, 128, 256, 32, True, False, "D32 kv64 cp.async16"),
    (2, 2, 192, 100, 64, True, False, "D64 kv64 cp.async16"),   # Sq > Sk
    (4, 4, 512, 512, 128, True, False, "D128 kv64 cp.async16"),
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
    got = flash_attention_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=causal),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_gemm_and_flash_kernels_are_deterministic(cuda):
    """No split-K, no atomics, a fixed merge order: two launches on the same
    inputs agree to the bit."""
    rng = np.random.default_rng(5)
    a = _on_card(rng, (2048, 512), cuda)
    b = _on_card(rng, (512, 2048), cuda)
    assert torch.equal(tiled_matmul(a, b), tiled_matmul(a, b))
    q, k, v = (_on_card(rng, (4, 4, 512, 128), cuda) for _ in range(3))
    assert torch.equal(flash_attention_mha(q, k, v, causal=True),
                       flash_attention_mha(q, k, v, causal=True))


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
    (32, 128, 16, 128, 64, False, "P128 cp.async16"),   # the mamba2-370m
    (2, 16, 2, 8, 4, False, "P128 cp.async16"),         # path's shape;
    (4, 64, 4, 32, 16, False, "P128 cp.async16"),       # tests/test_kernels
    (1, 128, 8, 64, 32, False, "P128 cp.async16"),      # .py's three
    (2, 96, 4, 64, 64, False, "P128 cp.async16"),       # ragged chunks
    (3, 70, 2, 32, 16, False, "P128 cp.async16"),
    (2, 70, 3, 130, 50, False, "P128 cp.async4"),       # two P tiles
    # an odd number of (chunk, head) blocks, BC * H:
    (3, 70, 3, 64, 16, True, "P128 cp.async4"),         # x a float off 16 B
    (1, 100, 5, 64, 64, False, "P128 cp.async16"),      # Q % 16 != 0
    (3, 100, 1, 32, 12, False, "P128 cp.async16"),      # N % 8 != 0
    (1, 128, 3, 130, 20, False, "P128 cp.async4"),      # P = 130
    (1, 70, 7, 60, 50, True, "P128 cp.async4"),
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
    (2048, 512, 512, "64x64 cp.async16 bf16"),      # the paths' shapes
    (2048, 512, 2048, "128x128 cp.async16 bf16"),
    (4096, 1024, 4384, "128x128 cp.async16 bf16"),
    (128, 128, 128, "64x64 cp.async16 bf16"),       # tests/test_kernels.py
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
    (4, 4, 512, 512, 128, True, "D128 kv64 cp.async16 bf16"),  # the path
    (1, 2, 64, 64, 32, True, "D32 kv64 cp.async16 bf16"),  # test_kernels
    (2, 2, 100, 70, 40, True, "D64 kv64 cp.async16 bf16"),     # D = 40
    (1, 3, 80, 90, 36, False, "D64 kv64 ld2 bf16"),            # D % 8 == 4
    (1, 2, 70, 70, 33, True, "D64 kv64 ld2 bf16"),             # odd D
    (1, 2, 96, 200, 256, True, "D256 kv32 cp.async16 bf16"),
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


@pytest.mark.gpu
@pytest.mark.parametrize("BC,Q,H,P,N,route", [
    (32, 128, 16, 128, 64, "P128 cp.async16 bf16"),   # the mamba2-370m path
    (2, 16, 2, 8, 4, "P128 ld2 bf16"),                # N % 8 != 0
    (1, 100, 5, 64, 64, "P128 cp.async16 bf16"),      # Q % 16 != 0
    (1, 128, 3, 130, 24, "P128 ld2 bf16"),            # P = 130
    (3, 70, 3, 60, 50, "P128 ld2 bf16"),
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
