"""The port's batched evaluation engine and its fused pass
(``repro_torch.core``: ``LMSBatch`` packing, ``Analyzer.analyze_requests``
and its batched builders, ``Evaluator.eval_requests_batch`` /
``eval_groups_batched``, ``CachedEvaluator``'s fused cache, lockstep SA)
against the reference's (``repro.core``) on the workload zoo.

Tolerances, each with its reason:

* the exact ``"numpy"`` batched path equals the reference's batched path
  to the bit: the same float64 arithmetic in the same order;
* it is held to the port's scalar ``eval_group`` at rel 1e-12 only: the
  batched numpy reductions are an ulp off the scalar ones on Python 3.12,
  in the reference too (its known failures in
  ``tests/test_batched_engine.py``);
* the fused pass (here the plain PyTorch version of the ``fused_eval``
  kernel, which the wrapper runs for CPU tensors) computes in float32, so
  it is held to the reference's parity envelope, rel 1e-4 with the same
  bottleneck (``tests/test_fused_eval.py``), against the exact engine and
  against the reference's jitted ``_build_fused_fn`` itself;
* the fused replay is held to ``np.bincount`` at the reference's rtol 2e-4
  / atol 1e-2 (its kernel adds in float64 with atomics in no fixed order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.analyzer import d2d_hop_stats as ref_d2d_hop_stats
from repro.core.encoding import pack_lms_batch as ref_pack
from repro.core.encoding import random_lms as ref_random_lms
from repro.core.evaluator import CachedEvaluator as RefCachedEvaluator
from repro.core.evaluator import Evaluator as RefEvaluator
from repro.core.explore import replica_exchange_sa as ref_replica_exchange
from repro.core.graph_partition import partition_graph as ref_partition
from repro.core.hw import ArchConfig as RefArch
from repro.core.sa import SAConfig as RefSAConfig
from repro.core.workloads import make_workload as ref_workload
from repro_torch.core.analyzer import (_fused_replay, _regions_to_array,
                                       d2d_hop_stats)
from repro_torch.core.encoding import (LMS, MS, pack_lms_batch, random_lms,
                                       unpack_lms_batch)
from repro_torch.core.evaluator import CachedEvaluator, Evaluator
from repro_torch.core.explore import mapping_to_jsonable, replica_exchange_sa
from repro_torch.core.graph_partition import partition_graph
from repro_torch.core.hw import ArchConfig
from repro_torch.core.sa import SAConfig
from repro_torch.core.workloads import make_workload
from repro_torch.kernels import fused_eval as fe

REL_TOL = 1e-4          # the reference's fused parity envelope
SCALAR_REL = 1e-12      # batched numpy vs scalar (an ulp on Python 3.12)
ZOO = ("tf-quick", "moe-quick", "mla-quick")
ARCH_KW = dict(x_cores=4, y_cores=3, xcut=2, ycut=1, noc_bw=16.0,
               d2d_bw=8.0, dram_bw=64.0, glb_kb=512, macs_per_core=256)


def _pair(spec, seed=0, n=3):
    """The same requests in both packages: (port arch, graph, requests),
    (reference arch, graph, requests)."""
    a, ra = ArchConfig(**ARCH_KW), RefArch(**ARCH_KW)
    g, rg = make_workload(spec), ref_workload(spec)
    rng, rrng = np.random.default_rng(seed), np.random.default_rng(seed)
    reqs = [(grp, random_lms(grp, g, a.n_cores, a.n_dram, rng))
            for grp in partition_graph(g, a, 8) for _ in range(n)]
    rreqs = [(grp, ref_random_lms(grp, rg, ra.n_cores, ra.n_dram, rrng))
             for grp in ref_partition(rg, ra, 8) for _ in range(n)]
    return (a, g, reqs), (ra, rg, rreqs)


def _ge(ge):
    return dataclasses.asdict(ge)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# LMSBatch packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ZOO)
def test_pack_lms_batch_round_trips_and_equals_reference(spec):
    (a, g, reqs), (ra, rg, rreqs) = _pair(spec, seed=2, n=4)
    grp = reqs[0][0]
    lms_list = [lms for gr, lms in reqs if gr.names == grp.names]
    rlms = [lms for gr, lms in rreqs if gr.names == grp.names]
    packed, rpacked = pack_lms_batch(lms_list, names=grp.names), \
        ref_pack(rlms, names=grp.names)
    for f in ("part", "cg", "cg_len", "fd"):
        np.testing.assert_array_equal(getattr(packed, f),
                                      getattr(rpacked, f))
    assert unpack_lms_batch(packed) == lms_list
    rt, rrt = packed.routing_tables(), rpacked.routing_tables()
    assert rt is packed.routing_tables()
    for f in ("slot_mask", "cg_safe", "order", "cg_sorted"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rrt, f))
    # a batch analyzes as its unpacked requests do
    an = Evaluator(a, g, fused_device="cpu").analyzer
    np.testing.assert_array_equal(
        an.analyze_batch(grp, packed, 8).buf,
        an.analyze_requests([(grp, lms) for lms in lms_list], 8).buf)


def test_pack_lms_batch_refuses_bad_batches():
    (a, g, reqs), _ = _pair("tf-quick", n=1)
    grp, lms = reqs[0]
    with pytest.raises(ValueError, match="empty"):
        pack_lms_batch([])
    name = grp.names[0]
    bad = dict(lms.ms)
    bad.pop(name)
    with pytest.raises(ValueError, match="batch layers"):
        pack_lms_batch([lms, LMS(ms=bad)], names=grp.names)
    packed = pack_lms_batch([lms], names=grp.names)
    multi = [l for l, n in enumerate(grp.names) if lms.ms[n].nc > 1]
    assert multi
    packed.cg[0, multi[0], :] = 0          # duplicate cores in one CG row
    with pytest.raises(ValueError):
        unpack_lms_batch(packed)


# ---------------------------------------------------------------------------
# the exact batched path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ZOO)
def test_batched_numpy_equals_reference_batched_path(spec):
    (a, g, reqs), (ra, rg, rreqs) = _pair(spec, seed=1)
    ev, rev = Evaluator(a, g, fused_device="cpu"), RefEvaluator(ra, rg)
    ab, rab = ev.analyzer.analyze_requests(reqs, 8), \
        rev.analyzer.analyze_requests(rreqs, 8)
    np.testing.assert_array_equal(ab.buf, rab.buf)
    np.testing.assert_array_equal(ab.weight_totals, rab.weight_totals)
    assert ab.layout == rab.layout
    got, want = ev.eval_requests_batch(reqs, 8), \
        rev.eval_requests_batch(rreqs, 8)
    assert [_ge(x) for x, _ in got] == [_ge(x) for x, _ in want]
    # eval_group_batch: one group's mappings
    grp = reqs[0][0]
    one = [lms for gr, lms in reqs if gr.names == grp.names]
    rone = [lms for gr, lms in rreqs if gr.names == grp.names]
    assert [_ge(x) for x, _ in ev.eval_group_batch(grp, one, 8)] == \
        [_ge(x) for x, _ in rev.eval_group_batch(rreqs[0][0], rone, 8)]


@pytest.mark.parametrize("spec", ZOO)
def test_batched_numpy_within_an_ulp_of_the_scalar_path(spec):
    (a, g, reqs), _ = _pair(spec, seed=3)
    rows = Evaluator(a, g, fused_device="cpu").eval_requests_batch(reqs, 8)
    ev = Evaluator(a, g)
    for (ge, an), (grp, lms) in zip(rows, reqs):
        want, wan = ev.eval_group(grp, lms, 8)
        assert (ge.bottleneck, ge.depth, ge.n_passes) == \
            (want.bottleneck, want.depth, want.n_passes)
        for f in ("delay_s", "energy_j", "stage_time_s"):
            assert _rel(getattr(ge, f), getattr(want, f)) <= SCALAR_REL
        for k, v in want.energy_breakdown.items():
            assert _rel(ge.energy_breakdown[k], v) <= SCALAR_REL
        # the replayed analyses are the scalar ones, bit for bit
        np.testing.assert_array_equal(an.edge_bytes, wan.edge_bytes)
        np.testing.assert_array_equal(an.core_time_s, wan.core_time_s)


def test_region_helpers_and_hop_stats_equal_reference():
    (a, g, reqs), (ra, rg, rreqs) = _pair("moe-quick", seed=5, n=1)
    an = Evaluator(a, g, fused_device="cpu").analyzer
    ran = RefEvaluator(ra, rg).analyzer
    analyses, ranalyses = [], []
    for (grp, lms), (rgrp, rlms) in zip(reqs, rreqs):
        for name in grp.names:
            regs = an.regions(name, lms.ms[name], grp.batch_unit)
            rregs = ran.regions(name, rlms.ms[name], rgrp.batch_unit)
            assert {c: dataclasses.astuple(r) for c, r in regs.items()} == \
                {c: dataclasses.astuple(r) for c, r in rregs.items()}
            cores, arr = _regions_to_array(regs)
            assert cores.tolist() == sorted(regs)
            assert arr.shape == (len(regs), 8)
        analyses.append(an.analyze(grp, lms, 8))
        ranalyses.append(ran.analyze(rgrp, rlms, 8))
    assert d2d_hop_stats(a, analyses) == ref_d2d_hop_stats(ra, ranalyses)

    from repro.core.analyzer import Contribution as RefContribution
    from repro_torch.core.analyzer import Contribution
    c, rc = Contribution(), RefContribution()
    an._route_multicast(c, 1, 0, [3, 5, 7], 12.0)
    ran._route_multicast(rc, 1, 0, [3, 5, 7], 12.0)
    c.seal(an._offsets)
    rc.seal(ran._offsets)
    np.testing.assert_array_equal(c.flat_idx, rc.flat_idx)
    np.testing.assert_array_equal(c.flat_vals, rc.flat_vals)


# ---------------------------------------------------------------------------
# the fused pass (plain version on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ZOO)
def test_fused_parity_envelope(spec):
    (a, g, reqs), _ = _pair(spec, seed=1)
    ev = Evaluator(a, g, fused_device="cpu")
    exact = ev.eval_requests_batch(reqs, 8)
    fused = ev.eval_requests_batch(reqs, 8, backend="fused")
    assert len(fused) == len(exact)
    for (ge, an), (gf, anf) in zip(exact, fused):
        assert anf is None and an is not None
        for f in ("delay_s", "energy_j", "stage_time_s"):
            assert _rel(getattr(gf, f), getattr(ge, f)) < REL_TOL
        assert ge.bottleneck == gf.bottleneck
        assert (ge.n_passes, ge.depth) == (gf.n_passes, gf.depth)
        for k, v in ge.energy_breakdown.items():
            assert abs(gf.energy_breakdown[k] - v) <= REL_TOL * max(
                abs(v), 1e-12)


def test_fused_empty_requests_and_bad_backends():
    (a, g, reqs), _ = _pair("tf-quick", n=1)
    ev = Evaluator(a, g, fused_device="cpu")
    assert ev.eval_requests_batch([], 8, backend="fused") == []
    for bad in ("jax", "torch"):
        with pytest.raises(ValueError, match="unknown eval batch backend"):
            ev.eval_requests_batch(reqs, 8, backend=bad)
        with pytest.raises(ValueError, match="unknown analyze batch backend"):
            ev.analyzer.analyze_requests(reqs, 8, backend=bad)


def test_fused_pass_on_the_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (a, g, reqs), _ = _pair("tf-quick", n=1)
    ev = Evaluator(a, g)                    # fused_device="cuda"
    assert ev.fused_device == "cuda"
    assert ev.eval_requests_batch(reqs, 8)  # the exact path needs no card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ev.eval_requests_batch(reqs, 8, backend="fused")


@pytest.mark.parametrize("spec", ZOO)
def test_fused_pass_equals_the_reference_jax_function(spec):
    """The port's fused pass (its plain version, on the CPU) against the
    reference's jitted ``_build_fused_fn`` itself (``backend="jax"``, on
    the CPU), on the same seeded requests: rel 1e-4 on every value, the
    same bottleneck, pass count and depth."""
    (a, g, reqs), (ra, rg, rreqs) = _pair(spec, seed=5)
    ours = Evaluator(a, g, fused_device="cpu").eval_requests_batch(
        reqs, 8, backend="fused")
    theirs = RefEvaluator(ra, rg).eval_requests_batch(rreqs, 8,
                                                      backend="jax")
    assert len(ours) == len(theirs) == len(reqs)
    for (gf, anf), (gj, anj) in zip(ours, theirs):
        assert anf is None and anj is None
        for f in ("delay_s", "energy_j", "stage_time_s"):
            assert _rel(getattr(gf, f), getattr(gj, f)) < REL_TOL, f
        assert (gf.bottleneck, gf.n_passes, gf.depth) \
            == (gj.bottleneck, gj.n_passes, gj.depth)
        assert gf.energy_breakdown.keys() == gj.energy_breakdown.keys()
        for k, v in gj.energy_breakdown.items():
            assert abs(gf.energy_breakdown[k] - v) <= REL_TOL * max(
                abs(v), 1e-12), k


def test_fused_plain_version_on_padded_streams():
    """``fused_eval``'s inputs carry no padding: the offsets run from 0 up
    to the stream's length, each row's slice is its ``row_stream`` with
    row-local indices in ``[0, buf_len)`` (no dump cell), and the plain
    version on them, through the wrapper and with no kernel launch on the
    CPU, agrees with the exact engine."""
    (a, g, reqs), _ = _pair("moe-quick", seed=6, n=2)
    ev = Evaluator(a, g, fused_device="cpu")
    x = ev._fused_inputs(reqs, 8)
    B, L = len(reqs), ev.analyzer._buf_len
    streams = [ev.analyzer.row_stream(grp, lms, 8) for grp, lms in reqs]
    n = sum(i.size for i, _, _ in streams)
    assert x.off.shape == (B + 1,) and x.npass.shape == (B,)
    assert x.off[0] == 0 and x.off[-1] == n == x.idx.size == x.vals.size
    assert (np.diff(x.off) >= 0).all()
    assert 0 <= x.idx.min() and x.idx.max() < L
    for b, (i, v, wt) in enumerate(streams):
        np.testing.assert_array_equal(x.idx[x.off[b]:x.off[b + 1]], i)
        np.testing.assert_array_equal(x.vals[x.off[b]:x.off[b + 1]], v)
        assert x.wts[b] == np.float32(wt)
    plan = ev.fused_plan()
    assert plan is ev.fused_plan()                # uploaded once
    n0 = fe.fused_eval.launches
    rows = fe.evaluate_rows(plan, x)
    assert fe.fused_eval.launches == n0       # the plain version launches none
    exact = ev.eval_requests_batch(reqs, 8)
    for b, (ge, _) in enumerate(exact):
        assert _rel(float(rows.delay[b]), ge.delay_s) < REL_TOL
        assert _rel(float(rows.energy[b]), ge.energy_j) < REL_TOL
        assert ("compute", "noc", "d2d", "dram")[rows.bottleneck[b]] \
            == ge.bottleneck
    assert rows.energy_parts.shape == (5, B)


def _fused_args(ev, reqs):
    """One batch's fused inputs as CPU tensors, and the plan's keywords of
    the plain version."""
    x = ev._fused_inputs(reqs, 8)
    plan = ev.fused_plan()
    kw = dict(spans=plan.spans, d2d_mask=plan.d2d_mask, consts=plan.consts,
              has_d2d=plan.has_d2d, buf_len=plan.buf_len)
    return [torch.from_numpy(a.copy()) for a in x], kw


def test_fused_plain_version_refuses_bad_inputs():
    """An index outside ``[0, buf_len)`` of its row, and offsets that do
    not run from 0 up to the stream's length, raise in the plain version
    (and through ``evaluate_rows``); so does a batch the plan did not
    stage last."""
    (a, g, reqs), _ = _pair("tf-quick", seed=3, n=1)
    ev = Evaluator(a, g, fused_device="cpu")
    args, kw = _fused_args(ev, reqs)
    L = kw["buf_len"]
    off, idx = args[0], args[1]
    for bad in (L, -1):
        i2 = idx.clone()
        i2[len(i2) // 2] = bad
        with pytest.raises(ValueError, match="outside"):
            fe.fused_eval_ref(off, i2, *args[2:], **kw)
    for o2 in (off + 1, off.flip(0), off[:-1]):
        with pytest.raises(ValueError, match="offsets"):
            fe.fused_eval_ref(o2, *args[1:], **kw)
    x = ev._fused_inputs(reqs, 8)
    x.off[-1] -= 1
    with pytest.raises(ValueError, match="offsets"):
        fe.evaluate_rows(ev.fused_plan(), x)
    stale = ev._fused_inputs(reqs, 8)
    ev._fused_inputs(reqs, 8)
    with pytest.raises(ValueError, match="stage"):
        fe.evaluate_rows(ev.fused_plan(), stale)


def test_fused_empty_row_gives_the_zero_row_math():
    """A row with an empty stream (``off[b] == off[b+1]``) evaluates as a
    row of zeros: stage time 1e-12, compute the bottleneck (the first of
    four equal maxima), no overflow, energy the weights' DRAM energy; the
    same as a row whose one entry adds 0."""
    (a, g, reqs), _ = _pair("moe-quick", seed=8, n=1)
    ev = Evaluator(a, g, fused_device="cpu")
    args, kw = _fused_args(ev, reqs[:3])
    off, idx, vals, npass, dep, wts = args
    # row 1 emptied: its entries dropped, the offsets after it moved down
    lo, hi = int(off[1]), int(off[2])
    keep = torch.cat([torch.arange(lo), torch.arange(hi, len(idx))])
    off_e = torch.cat([off[:2], off[2:] - (hi - lo)])
    out, bn = fe.fused_eval_ref(off_e, idx[keep], vals[keep], npass, dep,
                                wts, **kw)
    full, fbn = fe.fused_eval_ref(*args, **kw)
    for b in (0, 2):                  # the other rows are untouched
        assert torch.equal(out[:, b], full[:, b]) and bn[b] == fbn[b]
    stage = np.float32(1e-12)
    e_dram = np.float32(wts[1]) * np.float32(kw["consts"][-1])
    want = [stage * np.float32(npass[1] + dep[1] - 1), e_dram, stage, 0.0,
            0.0, 0.0, 0.0, 0.0, e_dram]
    np.testing.assert_allclose(out[:, 1].numpy(), want, rtol=1e-6)
    assert bn[1] == 0
    # one entry of 0.0 in row 1 gives the same row
    idx_z = torch.cat([idx[keep][:lo], torch.zeros(1, dtype=idx.dtype),
                       idx[keep][lo:]])
    vals_z = torch.cat([vals[keep][:lo], torch.zeros(1), vals[keep][lo:]])
    off_z = torch.cat([off_e[:2], off_e[2:] + 1])
    out_z, bn_z = fe.fused_eval_ref(off_z, idx_z, vals_z, npass, dep, wts,
                                    **kw)
    assert torch.equal(out_z[:, 1], out[:, 1]) and bn_z[1] == bn[1]


def test_cached_evaluator_keeps_fused_results_separate():
    """Parity-grade fused values never satisfy an exact-path lookup."""
    (a, g, reqs), (ra, rg, rreqs) = _pair("tf-quick", seed=2, n=2)
    ce = CachedEvaluator(a, g, fused_device="cpu")
    fused = ce.eval_groups_batched(reqs, 8, backend="fused")
    assert len(ce._fused_cache) > 0 and len(ce._cache) == 0
    fused2 = ce.eval_groups_batched(reqs, 8, backend="fused")
    assert [ge for ge, _ in fused2] == [ge for ge, _ in fused]
    exact = ce.eval_groups_batched(reqs, 8)
    ref = RefEvaluator(ra, rg).eval_requests_batch(rreqs, 8)
    assert [_ge(x) for x, _ in exact] == [_ge(x) for x, _ in ref]
    info = ce.cache_info()
    rce = RefCachedEvaluator(ra, rg)
    rce.eval_groups_batched(rreqs, 8, backend="jax")
    rce.eval_groups_batched(rreqs, 8, backend="jax")
    rce.eval_groups_batched(rreqs, 8)
    assert info == rce.cache_info()
    # the exact cache serves eval_group afterwards, the same objects
    grp, lms = reqs[0]
    assert ce.eval_group(grp, lms, 8) is exact[0]


# ---------------------------------------------------------------------------
# the fused replay (analyze_requests(backend="fused"))
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ZOO)
def test_fused_replay_zoo_parity(spec):
    (a, g, reqs), _ = _pair(spec, seed=4, n=2)
    if spec == "moe-quick":
        assert g.is_scaled                 # routed experts present
    an = Evaluator(a, g, fused_device="cpu").analyzer
    ab_np = an.analyze_requests(reqs, 8)
    ab_fu = an.analyze_requests(reqs, 8, backend="fused")
    np.testing.assert_allclose(ab_fu.buf, ab_np.buf, rtol=2e-4, atol=1e-2)
    np.testing.assert_array_equal(ab_fu.weight_totals, ab_np.weight_totals)


def test_fused_replay_refuses_bad_dtypes():
    with pytest.raises(TypeError, match="int64 index stream"):
        _fused_replay(np.array([0, 1], np.int32), np.array([1.0, 2.0]), 4,
                      "cpu")
    with pytest.raises(TypeError, match="float64 value stream"):
        _fused_replay(np.array([0, 1], np.int64),
                      np.array([1.0, 2.0], np.float32), 4, "cpu")


def test_fused_replay_matches_bincount():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 64, size=500)
    vals = rng.normal(size=500)
    out = _fused_replay(idx.astype(np.int64), vals, 64, "cpu")
    ref = np.bincount(idx, weights=vals, minlength=64)
    assert out.shape == ref.shape and out.dtype == np.float64
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def _replay_constants():
    """(the most and the fewest cells a block, threads a block, entries a
    thread a tile) of ``segment_replay`` as ``csrc/fused_eval.cu`` builds
    it."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "fused_eval.cu").read_text()
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                     src).group(1))
    return (get("kReplayCells"), get("kReplayMinCells"),
            get("kReplayThreads"), get("kReplayPer"))


def _replay_emulated(idx: np.ndarray, vals: np.ndarray, n_cells: int,
                     K: int):
    """``segment_replay``'s order, emulated: each block of K cells (the
    launch picks K, 32 to 512, by the grid) walks
    the stretch between the first and last stream position of its cells
    in tiles of R x T entries (entry t of a tile is round t // T of thread
    t % T: slot 16 round + warp, and its lane); per tile each slot counts
    its entries of each owner warp (local cell % 16) and ranks its own by
    lane, a scan of the counts owner-major gives each entry its place in
    its owner's stretch, and each owner walks its stretch in order, the
    cell's lane adding to its running float64 sum.  Also checks that
    those places are a stable sort of the tile by owner."""
    _, _, threads, per = _replay_constants()
    T = threads * per
    warps = threads // 32
    out = np.zeros(n_cells)
    blocks = -(-n_cells // K)
    ok = (idx >= 0) & (idx < n_cells)
    pos = np.nonzero(ok)[0]
    rng_of = idx[ok] // K
    first = np.full(blocks, idx.size)
    last = np.full(blocks, -1)
    np.minimum.at(first, rng_of, pos)
    np.maximum.at(last, rng_of, pos)
    for b in range(blocks):
        c0, nc = b * K, min(K, n_cells - b * K)
        acc = np.zeros(K)
        for base in range(first[b], last[b] + 1, T):
            c = idx[base:min(base + T, last[b] + 1)] - c0
            v = vals[base:base + c.size]
            kept = np.nonzero((c >= 0) & (c < nc))[0]
            slot = (kept // threads) * warps + kept % threads // 32
            lane = kept % 32
            owner = c[kept] % 16
            counts = np.zeros((16, per * warps), np.int64)
            np.add.at(counts, (owner, slot), 1)
            rank = np.array([np.sum((owner == o) & (slot == s_)
                                    & (lane < ln))
                             for o, s_, ln in zip(owner, slot, lane)], int)
            flat = counts.ravel()
            offsets = (np.cumsum(flat) - flat).reshape(counts.shape)
            dest = offsets[owner, slot] + rank
            assert np.array_equal(np.sort(dest), np.arange(kept.size))
            order = kept[np.argsort(owner, kind="stable")]
            assert np.array_equal(kept[np.argsort(dest)], order)
            run_c = np.empty(kept.size, int)
            run_v = np.empty(kept.size)
            run_c[dest], run_v[dest] = c[kept], v[kept]
            for k in range(kept.size):
                acc[run_c[k]] += run_v[k]
        out[c0:c0 + nc] = acc[:nc]
    return out


def _analyzer_stream(arch, spec, batch, B, seed):
    """The analyzer's replay stream of ``B`` random (group, LMS)
    requests: (idx, vals, cells)."""
    g = make_workload(spec)
    rng = np.random.default_rng(seed)
    groups = partition_graph(g, arch, batch)
    reqs = [(groups[int(i)], random_lms(groups[int(i)], g, arch.n_cores,
                                        arch.n_dram, rng))
            for i in rng.integers(len(groups), size=B)]
    an = Evaluator(arch, g, fused_device="cpu").analyzer
    idx, vals, _ = an._request_streams(reqs, batch)
    return idx, vals, B * an._buf_len


@pytest.mark.parametrize("stream", ["granite", "sweep:tf-paper", "random",
                                    "one cell"])
def test_segment_replay_order_equals_bincount_bits(stream):
    """The kernel's replay order (per-tile stable sort by owner warp, one
    running sum a cell), emulated, gives ``np.bincount``'s bits on the
    analyzer's streams (granite on S-Arch at the fused phase's batch, and
    the supervised sweep's ``tf-paper`` rows on its 70-core candidate), on
    a stream in random order over more cells than a block owns, and on
    one cell."""
    from repro_torch.core.dse import grid_candidates
    from repro_torch.core.hw import simba_arch
    if stream == "granite":
        idx, vals, n = _analyzer_stream(
            simba_arch(), "lm:granite-moe-3b-a800m:seq=4096,n_layers=2",
            4, 4, seed=4)
    elif stream == "sweep:tf-paper":
        arch = grid_candidates(72.0, mac_options=[512, 1024],
                               cut_options=[1, 2], dram_per_tops=[2.0],
                               noc_options=[16, 32], d2d_ratio=[0.5],
                               glb_options=[1024])[2]
        idx, vals, n = _analyzer_stream(arch, "tf-paper", 8, 4, seed=4)
    else:
        rng = np.random.default_rng(11)
        n = 1300 if stream == "random" else 1
        idx = rng.integers(0, n, size=3000)
        vals = rng.normal(size=3000)
    want = np.bincount(idx, weights=vals, minlength=n)
    most, fewest, _, _ = _replay_constants()
    for cells in (most, fewest):        # the launch picks one by the grid
        assert np.array_equal(_replay_emulated(idx, vals, n, cells), want)


# ---------------------------------------------------------------------------
# lockstep SA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,seed", [("tf-quick", 3), ("moe-quick", 1),
                                       ("mla-quick", 2)])
def test_lockstep_replica_exchange_equals_reference_lockstep(spec, seed):
    """The port's batched lockstep against the reference's
    ``lockstep=True``: the same trajectories, to the bit."""
    (a, g, _), (ra, rg, _) = _pair(spec)
    kw = dict(iters=60, seed=seed, n_chains=3, log_every=5, swap_every=10)
    mine = replica_exchange_sa(g, a, partition_graph(g, a, 8), 8,
                               SAConfig(**kw))
    ref = ref_replica_exchange(rg, ra, ref_partition(rg, ra, 8), 8,
                               RefSAConfig(**kw))
    from repro.core.explore import mapping_to_jsonable as ref_jsonable
    assert mapping_to_jsonable(mine.mapping) == ref_jsonable(ref.mapping)
    assert (mine.cost, mine.energy_j, mine.delay_s, mine.history) == \
        (ref.cost, ref.energy_j, ref.delay_s, ref.history)
    assert (mine.accepted, mine.proposed, mine.swap_attempts,
            mine.swap_accepts) == (ref.accepted, ref.proposed,
                                   ref.swap_attempts, ref.swap_accepts)


def test_sa_fused_backend_rescores_winners_exact():
    """SAConfig(backend="fused"): proposals scored fused, best re-scored
    exactly at finalize — the reported cost equals an independent exact
    evaluation of the returned mapping."""
    (a, g, _), _ = _pair("tf-quick")
    groups = partition_graph(g, a, 8)
    cfg = SAConfig(iters=40, seed=3, n_chains=2, backend="fused")
    ev = CachedEvaluator(a, g, fused_device="cpu")
    with pytest.warns(RuntimeWarning, match="n_chains=3"):
        from repro_torch.core.sa import sa_optimize
        res = sa_optimize(g, a, groups, 8, cfg, evaluator=ev)
    assert len(ev._fused_cache) > 0
    final = Evaluator(a, g).evaluate(res.mapping, 8)
    assert res.cost == final.cost(cfg.beta, cfg.gamma)
    assert res.energy_j == final.energy_j
    assert res.delay_s == final.delay_s
