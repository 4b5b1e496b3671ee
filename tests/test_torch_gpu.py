"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so it runs on the card's machine:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of ``tests/test_kernels.py``: atol 1e-3 / rtol 1e-4
for the f32 GEMM, 2e-5 for f32 attention; TF32 is off for the plain
versions.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_mha
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
                                   (2048, 2048, 512), (100, 300, 50),
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


@pytest.mark.gpu
def test_kernels_refuse_other_dtypes(cuda):
    a = torch.zeros((4, 4), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tiled_matmul(a, a)
    with pytest.raises(TypeError):
        flash_attention_mha(*(a.reshape(1, 1, 4, 4),) * 3)


@pytest.mark.gpu
def test_realized_fixture_kernel_route_vs_plain_route(cuda):
    """The committed tf-paper plan on the card: one pass launches 36 GEMMs
    and 6 flash attentions, and every stage cube of the kernel route is
    within 2e-4 of the cube's max of the plain route given the same stage
    inputs (``tests/test_realize.py``'s bound)."""
    from pathlib import Path

    from repro_torch.core.workloads import make_workload
    from repro_torch.realize.plan import load_realize_candidates, plans_for
    from repro_torch.realize.program import (build_program,
                                             draw_stage_arrays,
                                             stage_args_from_numpy)
    fixture = (Path(__file__).resolve().parent / "data" / "realize"
               / "tf-paper.simba.ckpt.jsonl")
    g = make_workload("tf-paper")
    (_, plan), = plans_for(load_realize_candidates(fixture, {"TF": g},
                                                   verbose=False))
    kern = build_program(g, plan, device=cuda)
    plain = build_program(g, plan, device=cuda, use_kernels=False)
    counts = (tiled_matmul.launches, flash_attention_mha.launches)
    run = kern.execute(seed=0)
    assert (tiled_matmul.launches - counts[0],
            flash_attention_mha.launches - counts[1]) == (36, 6)
    assert len(run["wall_s"]) == 37 and all(w > 0 for w in run["wall_s"])
    args = stage_args_from_numpy(draw_stage_arrays(kern, 0), cuda)
    outputs = {}
    for sk, sp, own in zip(kern.stages, plain.stages, args):
        ext = [outputs[n] for n in sk.ext_inputs]
        for name, a, b in zip(sk.out_layers, sk.fn(*ext, *own),
                              sp.fn(*ext, *own)):
            assert torch.isfinite(a).all()
            err = ((a - b).abs().max() / b.abs().max()).item()
            assert err < 2e-4, (name, err)
            outputs[name] = a
