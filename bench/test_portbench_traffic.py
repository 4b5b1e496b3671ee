"""The traffic generator: determinism per seed, the stratified length
draw, and the packed stream against the program's own."""

import numpy as np
import pytest

from bench.lib import traffic

MIX = {"prompt_median": 1500, "prompt_sigma": 0.8, "prompt_min": 128,
       "prompt_max": 8192, "new_median": 13, "new_sigma": 0.6, "new_min": 2,
       "new_max": 64, "block": 64}
BIG_SEED = 2**31 + 12345


def test_serve_stream_is_a_function_of_the_seed():
    a = traffic.ServeStream(MIX, 32000, BIG_SEED).take(40)
    b = traffic.ServeStream(MIX, 32000, BIG_SEED).take(40)
    c = traffic.ServeStream(MIX, 32000, BIG_SEED + 1).take(40)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               for x, y in zip(a, b))
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    for r in a:
        assert r.prompt.dtype == np.int32
        assert r.prompt.min() >= 1 and r.prompt.max() < 32000


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_each_block_holds_every_quantile_once(seed):
    s = traffic.ServeStream(MIX, 50280, seed)
    sizes = [s.sizes(r) for r in range(128)]
    want_len = sorted(traffic.stratified_sizes(MIX, "prompt", 64))
    want_new = sorted(traffic.stratified_sizes(MIX, "new", 64))
    for blk in (sizes[:64], sizes[64:]):
        assert sorted(n for n, _ in blk) == want_len
        assert sorted(k for _, k in blk) == want_new
    assert sizes[:64] != [s.sizes(r) for r in range(64, 128)]


def test_waves_differ_in_make_up():
    """Within a block the order is the seed's, so waves of 16 differ in
    their longest prompt and their longest answer."""
    s = traffic.ServeStream(MIX, 50280, BIG_SEED)
    waves = [[s.sizes(r) for r in range(w * 16, w * 16 + 16)]
             for w in range(4)]
    assert len({max(n for n, _ in w) for w in waves}) > 1
    assert len({max(k for _, k in w) for w in waves}) > 1
    # prompts and answers are ordered independently
    firsts = [s.sizes(r) for r in range(64)]
    order_len = np.argsort([n for n, _ in firsts], kind="stable")
    order_new = np.argsort([k for _, k in firsts], kind="stable")
    assert not np.array_equal(order_len, order_new)


def test_lognormal_quantiles_keep_the_median_and_the_spread():
    q = traffic.lognormal_quantiles(1500, 0.8, 4)
    z = [-1.1503493803760079, -0.31863936396437515, 0.31863936396437515,
         1.1503493803760079]                 # normal quantiles at 1/8 .. 7/8
    assert np.allclose(q, [1500 * np.exp(0.8 * v) for v in z])
    assert np.isclose(np.sqrt(q[1] * q[2]), 1500)
    n = traffic.stratified_sizes(MIX, "prompt", 255)
    assert n[127] == 1500 and n.min() >= 128 and n.max() == 8192
    assert list(n) == sorted(n)
    k = traffic.stratified_sizes(MIX, "new", 255)
    assert k[127] == 13 and k.min() >= 2 and k.max() <= 64


def test_packed_batch_is_the_programs_stream():
    from repro_torch.data.pipeline import DataConfig, make_batch
    mix = {"batch": 3, "seq_len": 40, "mean_doc_len": 16, "eos_id": 0}
    for step in (0, 5):
        got = traffic.packed_batch(mix, 1000, 99, step)
        want = make_batch(DataConfig(vocab=1000, seq_len=40, global_batch=3,
                                     seed=99, mean_doc_len=16), step)
        for k in ("tokens", "labels", "mask"):
            assert np.array_equal(got[k], want[k])
    a = traffic.packed_batch(mix, 1000, BIG_SEED, 0)["tokens"]
    b = traffic.packed_batch(mix, 1000, BIG_SEED, 1)["tokens"]
    rows = np.concatenate([a, b])
    assert len({r.tobytes() for r in rows}) == len(rows)
