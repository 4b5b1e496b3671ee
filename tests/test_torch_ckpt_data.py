"""The port's data pipeline and checkpoints (``repro_torch.data.pipeline``,
``repro_torch.checkpoint.ckpt``) against the reference's.

The pipeline is a numpy copy: its batches must be bit-equal to the
reference's for every config, step and host.  The checkpoint keeps the
reference's format (one ``.npz`` with '/'-joined keys and a json
sidecar), so each package reads what the other writes; on top, the port
snapshots tensors before its async writer runs, since its train step
updates them in place."""

import json

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.data import pipeline as jpipe
from repro_torch.checkpoint.ckpt import (CheckpointManager, load_step,
                                         restore, save)
from repro_torch.data.pipeline import (DataConfig, Prefetcher, make_batch,
                                       make_embeds_batch)

# (vocab, seq_len, global_batch, n_hosts, mean_doc_len, seed)
DATA_CASES = [(300, 16, 2, 1, 256, 1234), (100, 8, 2, 1, 4, 7),
              (49152, 64, 8, 4, 32, 1234), (512, 33, 6, 3, 256, 0)]


def _cfgs(vocab, seq, batch, hosts, doc, seed):
    for host in range(hosts):
        kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed,
                  mean_doc_len=doc, n_hosts=hosts, host_id=host)
        yield DataConfig(**kw), jpipe.DataConfig(**kw)


@pytest.mark.parametrize("case", DATA_CASES)
def test_batches_bit_equal_the_references(case):
    for cfg, jcfg in _cfgs(*case):
        for step in (0, 1, 5, 1000):
            got, want = make_batch(cfg, step), jpipe.make_batch(jcfg, step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got["labels"][:, :-1],
                                          got["tokens"][:, 1:])
            for need in (False, True):
                got = make_embeds_batch(cfg, step, 16, need_tokens=need)
                want = jpipe.make_embeds_batch(jcfg, step, 16,
                                               need_tokens=need)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
        assert not (make_batch(cfg, 0)["tokens"]
                    == make_batch(cfg, 1)["tokens"]).all()


def test_prefetcher_in_order_and_resumable():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=2)
    jcfg = jpipe.DataConfig(vocab=100, seq_len=8, global_batch=2)
    for start in (0, 5):
        pf = Prefetcher(lambda s: make_batch(cfg, s), start_step=start,
                        depth=2)
        try:
            for expect in range(start, start + 3):
                step, batch = pf.next()
                assert step == expect
                np.testing.assert_array_equal(
                    batch["tokens"], jpipe.make_batch(jcfg, expect)["tokens"])
        finally:
            pf.close()


def test_prefetcher_surfaces_a_worker_error():
    def boom(step):
        raise ValueError("bad batch")
    pf = Prefetcher(boom, start_step=0)
    try:
        with pytest.raises(RuntimeError, match="worker died"):
            pf.next()
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    """Tensor leaves of three dtypes (bf16 among them) and a numpy leaf."""
    return {"a": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
            "b": torch.ones((2,), dtype=torch.int32),
            "h": (torch.arange(6, dtype=torch.float32) / 3).to(torch.bfloat16),
            "n": np.full((2, 2), 0.5, np.float32),
            "step": torch.zeros((), dtype=torch.int32)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_same(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert type(g[k]) is type(w[k]), k
        if isinstance(w[k], torch.Tensor):
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
        else:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_save_restore_roundtrip_and_sidecar(tmp_path):
    t = _tree()
    p = save(tmp_path / "ck.npz", t, step=7)
    _assert_same(restore(p, _tree()), t)
    assert load_step(p) == 7
    meta = json.loads(p.with_suffix(".json").read_text())
    assert meta["keys"] == ["a/w", "b", "h", "n", "step"]
    assert not list(tmp_path.glob("*.tmp*"))          # atomic: no leftovers


def test_restore_shape_mismatch_and_missing_key_raise(tmp_path):
    p = save(tmp_path / "ck.npz", _tree(), 1)
    bad = _tree()
    bad["a"]["w"] = torch.zeros((5, 5))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(p, bad)
    more = dict(_tree(), extra=torch.zeros(1))
    with pytest.raises(KeyError, match="extra"):
        restore(p, more)


def test_each_package_reads_what_the_other_writes(tmp_path):
    """Same format: a port checkpoint restores in the reference and a
    reference checkpoint in the port, leaf for leaf."""
    import jax.numpy as jnp
    tree = {"a": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)},
            "b": np.ones((2,), np.int32), "step": np.zeros((), np.int32)}
    p = save(tmp_path / "port.npz", tree, 3)
    got = jckpt.restore(p, tree)
    _assert_same(got, tree)
    assert jckpt.load_step(p) == 3
    jtree = {k: (jnp.asarray(v) if not isinstance(v, dict) else
                 {kk: jnp.asarray(vv) for kk, vv in v.items()})
             for k, v in tree.items()}
    q = jckpt.save(tmp_path / "ref.npz", jtree, 4)
    like = {"a": {"w": torch.zeros((3, 4))},
            "b": torch.zeros((2,), dtype=torch.int32),
            "step": torch.ones((), dtype=torch.int32)}
    got = restore(q, like)
    _assert_same(got, {"a": {"w": torch.from_numpy(tree["a"]["w"])},
                       "b": torch.from_numpy(tree["b"]),
                       "step": torch.from_numpy(tree["step"])})
    assert load_step(q) == 4
    assert json.loads(p.with_suffix(".json").read_text())["keys"] \
        == json.loads(q.with_suffix(".json").read_text())["keys"]


def test_manager_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(_tree(), s)
    assert mgr.latest_step() == 40
    assert mgr.steps() == [30, 40]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000030.json", "ckpt_00000030.npz", "ckpt_00000040.json",
        "ckpt_00000040.npz"]
    assert CheckpointManager(tmp_path / "empty").restore_latest(_tree()) \
        == (None, 0)


def test_manager_async_writes_the_state_at_save_time(tmp_path):
    """The async writer sees the snapshot taken in ``save``, not the
    tensors after the next in-place update."""
    mgr = CheckpointManager(tmp_path, keep=3, async_write=True)
    t = _tree()
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v.copy())
            if not isinstance(v, dict) else {"w": v["w"].clone()}
            for k, v in t.items()}
    mgr.save(t, 5)
    t["a"]["w"].add_(100.0)                  # the next step, in place
    t["step"].add_(1)
    mgr.wait()
    assert mgr.latest_step() == 5
    got, step = mgr.restore_latest(_tree())
    assert step == 5
    _assert_same(got, want)
