"""Operation and byte counts against values reckoned by hand at one small
shape."""

import pytest

from bench.lib import work

SSM = {"family": "ssm", "n_layers": 1, "d_model": 8, "ssm_expand": 2,
       "ssm_headdim": 4, "ssm_state": 2, "ssm_groups": 1, "n_heads": 2,
       "n_kv": 2, "d_ff": 0, "vocab": 300, "compute_dtype": "bfloat16",
       "attn_every": 0, "ssm_chunk": 4}


def test_ssm_counts():
    # in_proj 8 x (2*16 + 2*2 + 4) = 320, out_proj 16 x 8 = 128
    assert work.block_matmul_params(SSM) == 448
    assert work.head_params(SSM) == 512 * 8           # 300 rounded to 512
    # 4 H N P = 4*4*2*4 = 128, conv 2*4*(16 + 4) = 160
    assert work.ssd_token_flops(SSM) == 288
    assert work.prefill_flops(SSM, 10) == 2 * 448 * 10 + 288 * 10 + 2 * 4096
    # 3 x (2 (448 + 4096) 16 + 288 16) per row, 2 rows
    assert work.train_flops(SSM, 2, 16) == 3 * 2 * (2 * 4544 * 16 + 288 * 16)


def test_ssd_chunk_work():
    # B 2, L 10, the configuration's chunk Q 4: 6 chunks; H 4, P 4, N 2;
    # causal triangle 10
    # flops a chunk: C B^T 10*2*2 = 40, scores x 4*10*4*2 = 320,
    # states 4*4*2*4*2 = 256
    # elements a chunk: x 64, dt 16, B and C 2*4*2 = 16, y 64, states 32,
    # each 2 bytes (bf16)
    assert work.ssd_chunk_work(SSM, 2, 10) == (6 * 616, 6 * 384)
    # in f32 the bytes double; a chunk twice as long counts more products
    assert work.ssd_chunk_work(dict(SSM, compute_dtype="float32"), 2, 10) \
        == (6 * 616, 6 * 768)
    f8, _ = work.ssd_chunk_work(dict(SSM, ssm_chunk=8), 2, 10)
    # Q 8: 4 chunks, triangle 36: 36*2*2 + 4*36*4*2 + 4*8*2*4*2
    assert f8 == 4 * (144 + 1152 + 512)


def test_least_time_takes_the_larger_bound():
    assert work.least_time(989e12, 0) == pytest.approx(1.0)
    assert work.least_time(0, 3.35e12) == pytest.approx(1.0)
    assert work.least_time(989e12, 6.7e12) == pytest.approx(2.0)
