"""Compressed data-parallel gradient synchronization on
``torch.distributed``.

Port of ``src/repro/optim/compressed_dp.py``.  Each leaf is scaled by a
scale the ranks agree on (the all-reduced max of ``|g + e|`` over 127),
quantized to int8 with round-half-even, summed exactly over the group and
dequantized to the mean; error feedback carries each rank's quantization
residual into its next step, so the scheme is unbiased over time.  The
arithmetic is the reference's, step for step, in f32; the residual is
rounded once, as the reference's compiled fused multiply-add rounds it, so
means and residuals equal the reference's bit for bit.

Wire format.  gloo and NCCL take no int16, and an int8 sum wraps, so the
reference's int16 ``psum`` cannot be carried over as written.  The int8
values travel as two signed 16-bit lanes packed in one int32 word, ``lo +
hi * 2**16`` (an odd count is padded with one zero lane), summed with one
int32 ``all_reduce``.  For up to 256 ranks each lane's sum stays within
±127 * 256 = ±32,512, and 32,512 * 2**16 + 32,512 < 2**31, so the packed
sum is exact and unpacks by sign-extending its low 16 bits.  That keeps
the reference's limit of 256 summands and half the f32 sync's bytes (plus
one f32 max a leaf); a larger group raises.

A tree is a dict of tensors keyed by parameter name, as in
:mod:`repro_torch.optim.adamw`.  ``group`` is a process group (a mesh
axis's, ``mesh.get_group(axis)``) or None, the default group.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch
import torch.distributed as dist

Tree = Mapping[str, torch.Tensor]

MAX_RANKS = 256           # exactness limit of the 16-bit lanes


def pack_lanes(q: torch.Tensor) -> torch.Tensor:
    """int8 values (any shape) -> int32 words ``lo + hi * 2**16`` over
    consecutive pairs of the flat values, an odd count padded with 0."""
    flat = q.reshape(-1).to(torch.int32)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    pairs = flat.view(-1, 2)
    return pairs[:, 0] + pairs[:, 1] * 65536


def unpack_lanes(words: torch.Tensor, n: int) -> torch.Tensor:
    """The two lanes' sums of int32 words, interleaved back, the first
    ``n`` (int32)."""
    lo = ((words & 0xFFFF) ^ 0x8000) - 0x8000
    hi = (words - lo) // 65536
    return torch.stack([lo, hi], dim=1).reshape(-1)[:n]


def _sync_leaf(g: torch.Tensor, e: torch.Tensor, group
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf: error-feedback int8 quantize -> exact packed sum -> mean
    (``src/repro/optim/compressed_dp.py:28-42``)."""
    n = dist.get_world_size(group)
    if n > MAX_RANKS:
        raise ValueError(f"compressed sync is exact for at most {MAX_RANKS} "
                         f"ranks, the group has {n}")
    gf = g.float() + e
    pmax = gf.abs().max()
    dist.all_reduce(pmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(pmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    # gf - q * scale rounded once, as XLA's fused multiply-add gives it
    # (the product is exact in f64, and so is the difference: q * scale is
    # within one scale of gf)
    new_e = (gf.double() - q.double() * scale.double()).float()
    words = pack_lanes(q)
    dist.all_reduce(words, op=dist.ReduceOp.SUM, group=group)
    total = unpack_lanes(words, q.numel()).reshape(q.shape)
    mean = total.float() * scale / float(n)
    return mean, new_e


def compressed_grad_sync(grads: Tree, error: Tree, group=None
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """Mean-reduce ``grads`` over ``group`` in the int8 wire format.
    Every rank of the group calls it.  Returns (synced grads, new
    error-feedback state)."""
    outs = {k: _sync_leaf(g, error[k], group) for k, g in grads.items()}
    return ({k: o[0] for k, o in outs.items()},
            {k: o[1] for k, o in outs.items()})


def make_compressed_dp_step(loss_fn: Callable, opt_update: Callable, mesh,
                            axis: str = "data") -> Callable:
    """A DP train step with compressed gradient sync over ``mesh``'s
    ``axis``.

    ``loss_fn(params, batch) -> scalar``; ``opt_update(params, grads, opt)
    -> (params, opt, metrics)``.  Params, opt and error state are
    replicated over ``axis``; the step takes the GLOBAL batch and each rank
    keeps its rows along dim 0 (``shard_map``'s ``P(axis)`` in the
    reference).  Returns ``step(params, opt, err, batch) -> (params, opt,
    err, metrics)``, ``metrics["loss"]`` the group's mean loss."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    r = mesh.get_local_rank(axis)

    def step(params, opt, err, batch):
        local = {}
        for k, x in batch.items():
            if x.shape[0] % n:
                raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, not "
                                 f"a multiple of the {n} ranks of {axis!r}")
            rows = x.shape[0] // n
            local[k] = x[r * rows:(r + 1) * rows]
        names = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        with torch.enable_grad():
            loss = loss_fn(dict(zip(names, leaves)), local)
            grads = torch.autograd.grad(loss, leaves)
        grads, err = compressed_grad_sync(dict(zip(names, grads)), err,
                                          group)
        loss = loss.detach().float()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        loss = loss / float(n)
        params, opt, metrics = opt_update(params, grads, opt)
        return params, opt, err, {"loss": loss, **metrics}

    return step
