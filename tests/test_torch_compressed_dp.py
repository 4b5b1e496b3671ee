"""The port's compressed data-parallel sync and its meshes
(``repro_torch.optim.compressed_dp``, ``repro_torch.launch.mesh``) against
the reference's ``shard_map`` sync on 8 forced host devices.

The port's side runs 8 gloo ranks, spawned from one subprocess; the
reference's side is one subprocess with ``XLA_FLAGS`` forcing 8 host
devices, as ``tests/test_compressed_dp.py`` runs it.  Both start once for
the module, side by side, each with its own timeout, and write their
arrays to ``.npz`` files that the tests compare: the synced means and new
error states of two rounds (bit for bit), the 60-step regression's losses
(``LOSS_RTOL``, beside the reference's own losses under one-ulp targets)
and the bytes each rank handed to ``all_reduce``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
RANKS = 8
SUB_TIMEOUT = 240       # seconds, each subprocess
SHAPES = {"b": (7,), "w": (33, 5), "z": (4,)}   # odd counts; "z" all zeros
STEPS = 60
# The free-running 60-step losses are held to rel 2e-4 of the reference's.
# Both steps are f32 but not bit-equal (the matmuls and AdamW's fused
# multiply-adds round differently), and an ulp that moves a value across
# an int8 rounding boundary moves the trajectory by a quantization step:
# the reference's own losses move by rel 7.5e-5 when every other target
# moves by one ulp (test_loss_tolerance_is_the_references_own_sensitivity
# computes it), and the port's are within 1.05e-4 of them.
LOSS_RTOL = 2e-4


def _inputs():
    """Per-rank gradients and error states of two sync rounds."""
    rng = np.random.default_rng(7)
    out = {}
    for rnd in (0, 1):
        for k, shp in SHAPES.items():
            spread = (1 + np.arange(RANKS)).reshape((-1,) + (1,) * len(shp))
            g = rng.normal(size=(RANKS,) + shp) * spread
            if k == "z":
                g = np.zeros_like(g)
            out[f"g{rnd}_{k}"] = g.astype(np.float32)
    for k, shp in SHAPES.items():
        out[f"e0_{k}"] = (rng.normal(size=(RANKS,) + shp) * 0.01
                          ).astype(np.float32) if k != "z" else \
            np.zeros((RANKS,) + shp, np.float32)
    rng = np.random.default_rng(0)
    out["W_true"] = rng.normal(size=(16, 4)).astype(np.float32)
    xs = np.stack([rng.normal(size=(64, 16)) for _ in range(STEPS)])
    out["xs"] = xs.astype(np.float32)
    # the targets, made once in f64 and handed to both packages
    out["ys"] = (xs @ out["W_true"].astype(np.float64)).astype(np.float32)
    return out


REF_CODE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map
    from repro.optim.compressed_dp import (compressed_grad_sync,
                                           make_compressed_dp_step)
    from repro.optim.adamw import (AdamWConfig, adamw_update,
                                   init_opt_state, init_error_state)

    d = dict(np.load(sys.argv[1]))
    keys = sorted(k[3:] for k in d if k.startswith("g0_"))
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("data",))

    def one(g, e):
        g = {k: v[0] for k, v in g.items()}
        e = {k: v[0] for k, v in e.items()}
        m, ne = compressed_grad_sync(g, e, "data")
        return ({k: v[None] for k, v in m.items()},
                {k: v[None] for k, v in ne.items()})

    sync = jax.jit(shard_map(one, mesh=mesh,
                             in_specs=(P("data"), P("data")),
                             out_specs=(P("data"), P("data")),
                             check_vma=False))
    res = {}
    err = {k: jnp.asarray(d["e0_" + k]) for k in keys}
    for rnd in (0, 1):
        g = {k: jnp.asarray(d[f"g{rnd}_{k}"]) for k in keys}
        mean, err = sync(g, err)
        for k in keys:
            res[f"mean{rnd}_{k}"] = np.asarray(mean[k])
            res[f"err{rnd}_{k}"] = np.asarray(err[k])

    def loss_fn(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    ocfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                       total_steps=200, min_lr_ratio=1.0, grad_clip=0.0)

    def opt_update(params, grads, opt):
        return adamw_update(ocfg, params, grads, opt)

    step = make_compressed_dp_step(loss_fn, opt_update, mesh, "data")

    def run(ys):
        params = {"w": jnp.zeros((16, 4), jnp.float32)}
        opt = init_opt_state(params)
        e = init_error_state(params)
        losses = []
        for x, y in zip(d["xs"], ys):
            params, opt, e, metrics = step(params, opt, e,
                                           {"x": jnp.asarray(x),
                                            "y": jnp.asarray(y)})
            losses.append(float(metrics["loss"]))
        return np.asarray(losses)

    res["losses"] = run(d["ys"])
    # the witness for LOSS_RTOL: every other target moved up by one ulp
    ys = d["ys"].copy()
    flat = ys.reshape(-1)
    flat[::2] = np.nextafter(flat[::2], np.float32(np.inf))
    res["losses_ulp"] = run(ys)
    np.savez(sys.argv[2], **res)
    print("done")
""")


PORT_CODE = textwrap.dedent("""
    import sys
    from pathlib import Path
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, world, port, inp, out_dir):
        torch.set_num_threads(1)
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.optim import compressed_dp as cdp
        from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                             init_opt_state, init_error_state)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        wire = []
        plain_all_reduce = dist.all_reduce

        def counted(t, *a, **kw):
            wire.append(t.numel() * t.element_size())
            return plain_all_reduce(t, *a, **kw)

        d = dict(np.load(inp))
        keys = sorted(k[3:] for k in d if k.startswith("g0_"))
        mesh = make_host_mesh((world,), ("data",), device_type="cpu")
        # a mesh over the first 4 of the 8 ranks, as the reference takes
        # the first devices of a larger pool
        sub = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
        coord = sub.get_coordinate()
        res = {"world": np.asarray(world),
               "mesh_shape": np.asarray(tuple(mesh.shape)),
               "sub_mesh": sub.mesh.numpy(),
               "sub_coord": np.asarray(coord if coord is not None
                                       else [-1, -1])}
        err = {k: torch.from_numpy(d["e0_" + k][rank]) for k in keys}
        group = mesh.get_group("data")
        for rnd in (0, 1):
            g = {k: torch.from_numpy(d[f"g{rnd}_{k}"][rank]) for k in keys}
            mean, err = cdp.compressed_grad_sync(g, err, group)
            for k in keys:
                res[f"mean{rnd}_{k}"] = mean[k].numpy()
                res[f"err{rnd}_{k}"] = err[k].numpy()

        # bytes handed to all_reduce: the compressed sync against the f32
        # sync of the same (1024, 256) leaf
        dist.all_reduce = counted
        big = {"w": torch.ones(1024, 256)}
        cdp.compressed_grad_sync(big, {"w": torch.zeros(1024, 256)}, group)
        res["wire_comp"] = np.asarray(sum(wire))
        wire.clear()
        dist.all_reduce(big["w"].clone(), group=group)
        res["wire_plain"] = np.asarray(sum(wire))
        dist.all_reduce = plain_all_reduce

        def loss_fn(params, batch):
            return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

        ocfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                           total_steps=200, min_lr_ratio=1.0, grad_clip=0.0)

        def opt_update(params, grads, opt):
            return adamw_update(ocfg, params, grads, opt)

        params = {"w": torch.zeros(16, 4)}
        opt = init_opt_state(params)
        e = init_error_state(params)
        step = cdp.make_compressed_dp_step(loss_fn, opt_update, mesh, "data")
        losses = []
        for x, y in zip(d["xs"], d["ys"]):
            params, opt, e, metrics = step(params, opt, e,
                                           {"x": torch.from_numpy(x),
                                            "y": torch.from_numpy(y)})
            losses.append(float(metrics["loss"]))
        res["losses"] = np.asarray(losses)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
        dist.destroy_process_group()

    if __name__ == "__main__":
        from repro_torch.launch.mesh import free_port
        mp.start_processes(rank_main, nprocs=int(sys.argv[1]),
                           args=(int(sys.argv[1]), free_port(), sys.argv[2],
                                 sys.argv[3]),
                           start_method="spawn")
        print("done")
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cdp")
    inp = tmp / "inputs.npz"
    np.savez(inp, **_inputs())
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    (tmp / "port").mkdir()
    (tmp / "port_ranks.py").write_text(PORT_CODE)     # spawn imports it
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, "-c", REF_CODE, str(inp), str(tmp / "ref.npz")],
            env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "port": subprocess.Popen(
            [sys.executable, str(tmp / "port_ranks.py"), str(RANKS),
             str(inp), str(tmp / "port")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
    }
    for name, p in procs.items():
        try:
            _, err = p.communicate(timeout=SUB_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, f"{name} stderr:\n{err[-3000:]}"
    ref = dict(np.load(tmp / "ref.npz"))
    port = [dict(np.load(tmp / "port" / f"rank{r}.npz"))
            for r in range(RANKS)]
    return ref, port


def test_compressed_sync_bit_equal_to_reference(runs):
    ref, port = runs
    assert all(int(p["world"]) == RANKS for p in port)
    assert all(tuple(p["mesh_shape"]) == (RANKS,) for p in port)
    for rnd in (0, 1):
        for k in SHAPES:
            for r, p in enumerate(port):
                want_mean = ref[f"mean{rnd}_{k}"][r]
                want_err = ref[f"err{rnd}_{k}"][r]
                assert p[f"mean{rnd}_{k}"].dtype == np.float32
                assert np.array_equal(p[f"mean{rnd}_{k}"], want_mean), \
                    (rnd, k, r, np.abs(p[f"mean{rnd}_{k}"] - want_mean).max())
                assert np.array_equal(p[f"err{rnd}_{k}"], want_err), \
                    (rnd, k, r)
            # the mean is one tensor on every rank; zeros stay zeros
            assert all(np.array_equal(p[f"mean{rnd}_{k}"],
                                      port[0][f"mean{rnd}_{k}"])
                       for p in port)
    assert not port[0]["mean0_z"].any()


def test_mesh_over_the_first_ranks_of_a_larger_pool(runs):
    """``make_host_mesh((2, 2))`` in a group of 8 ranks lays out ranks 0-3;
    the other ranks are in no coordinate of it."""
    _, port = runs
    for r, p in enumerate(port):
        assert p["sub_mesh"].tolist() == [[0, 1], [2, 3]]
        assert p["sub_coord"].tolist() == ([r // 2, r % 2] if r < 4
                                           else [-1, -1])


def test_compressed_dp_regression_converges_like_reference(runs):
    ref, port = runs
    got = port[0]["losses"]
    assert all(np.array_equal(p["losses"], got) for p in port)
    assert got[-1] < 0.05 * got[0], (got[0], got[-1])
    rel = np.abs(got - ref["losses"]) / np.abs(ref["losses"])
    print(f"max rel loss difference, port vs reference: {rel.max():.3e}")
    assert rel.max() < LOSS_RTOL, rel.max()


def test_loss_tolerance_is_the_references_own_sensitivity(runs):
    """``LOSS_RTOL``'s witness, computed by the reference itself: its
    60-step losses when every other target moves up by one ulp.  The
    tolerance is held to at most three times that move, so it stays of
    the order of the reference's own rounding noise."""
    ref, _ = runs
    own = (np.abs(ref["losses_ulp"] - ref["losses"])
           / np.abs(ref["losses"])).max()
    print(f"max rel loss move of the reference under one-ulp targets: "
          f"{own:.3e}")
    assert 0 < own and LOSS_RTOL <= 3 * own, own


def test_compressed_sync_wire_bytes_smaller(runs):
    _, port = runs
    for p in port:
        comp, plain = int(p["wire_comp"]), int(p["wire_plain"])
        assert plain == 1024 * 256 * 4
        assert comp == 4 + 1024 * 256 * 2          # one f32 max + the words
        assert comp < 0.75 * plain


@pytest.mark.parametrize("n", [1023, 1024])
def test_packed_lanes_exact_at_256_ranks(n):
    from repro_torch.optim.compressed_dp import (MAX_RANKS, pack_lanes,
                                                 unpack_lanes)
    rng = np.random.default_rng(n)
    q = rng.integers(-127, 128, size=(MAX_RANKS, n))
    q[:, 0], q[:, 1], q[:, 2] = 127, -127, 127        # the extremes
    q[:, 3] = -127
    qt = torch.from_numpy(q.astype(np.int8))
    words = torch.stack([pack_lanes(qt[r]) for r in range(MAX_RANKS)])
    assert words.dtype == torch.int32 and words.shape == (MAX_RANKS,
                                                          (n + 1) // 2)
    total = words.sum(0, dtype=torch.int32)     # what an int32 sum returns
    assert torch.equal(total.long(), words.long().sum(0))   # no wrap
    got = unpack_lanes(total, n)
    assert torch.equal(got.long(), torch.from_numpy(q.sum(0)))
    assert got[0] == 127 * MAX_RANKS and got[1] == -127 * MAX_RANKS


def test_mesh_raises_on_too_few_ranks():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="need 2 devices for mesh \\(2,\\)"
                       ".*torchrun"):
        make_host_mesh((2,), ("data",), device_type="cpu")
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="need 512 devices"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh((1,), ("data",))
    assert not dist.is_initialized()


def test_one_rank_mesh_starts_its_own_group():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.compressed_dp import compressed_grad_sync
    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"), device_type="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model")
        g = {"w": torch.tensor([0.5, -1.0, 0.25])}
        mean, err = compressed_grad_sync(g, {"w": torch.zeros(3)},
                                         mesh.get_group("data"))
        scale = torch.tensor(1.0) / 127.0
        q = torch.round(g["w"] / scale)
        assert torch.equal(mean["w"], q * scale)
        # the residual rounded once (a fused multiply-add)
        assert torch.equal(err["w"], (g["w"].double() - q.double()
                                      * scale.double()).float())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
