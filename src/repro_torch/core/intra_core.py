"""Intra-core dataflow exploration (paper Sec. V-B1, last stage).

Reduced copy of ``src/repro/core/intra_core.py``: ``CoreDataflow``, the
vectorized ``explore_intra_core`` (memoized on the workload signature),
its batch API ``explore_intra_core_many`` and ``core_workload_signature``.
The scalar triple-loop oracle (``explore_intra_core_reference``) stays in
the reference, whose tests hold the vectorized search to it; the port's
tests hold this copy to the reference's.

For the partitioned workload landing on one core, the search enumerates
NVDLA-style tilings: tile sizes (tk, tc, th, tw) over a power-of-two grid
and three loop orders (weight- / output- / input-stationary), masks the
candidates whose buffer need exceeds the GLB and argmins total GLB traffic
(``np.argmin``: the first minimum in C order over (tk, tc, thw, order)).
The PE array is the NVDLA Kvec x Cvec MAC tree (16 x 64 for 1024 MACs).
Outputs per workload: GLB traffic in bytes (for energy), the achieved MAC
utilization (array padding loss), and the chosen tile.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class CoreDataflow:
    tile: Tuple[int, int, int, int]       # (tk, tc, thw, tw)
    order: str                            # ws | os | is
    glb_read_bytes: float
    glb_write_bytes: float
    utilization: float                    # MAC array utilization in [0,1]


# A full workload signature, in ``explore_intra_core`` argument order.
Signature = Tuple[int, int, int, int, int, int, int, int, str]


def _pow2_tiles(dim: int, cap: int) -> Tuple[int, ...]:
    out = []
    t = 1
    while t < min(dim, cap):
        out.append(t)
        t *= 2
    out.append(min(dim, cap))
    return tuple(sorted(set(out)))


_ORDERS = ("ws", "os", "is")
_PSUM_BYTES = 4                           # 32-bit partial sums


def _stream_dataflow(K: int, HW: int, bytes_per_elem: int,
                     kind: str) -> CoreDataflow:
    # streaming ops: one read + one write per element, trivially tiled
    vol = K * HW * bytes_per_elem
    return CoreDataflow((K, 1, HW, 1), "stream",
                        glb_read_bytes=float(vol * (2 if kind == "eltwise" else 1)),
                        glb_write_bytes=float(vol),
                        utilization=1.0)


def _spill_dataflow(w_elems: int, if_elems: int, of_elems: int, K: int,
                    C_eff: int, HW: int, bytes_per_elem: int,
                    kvec: int, cvec: int) -> CoreDataflow:
    # nothing fits: fall back to minimum tiles with spill multipliers
    rd = (w_elems * HW + if_elems * K) * bytes_per_elem
    wr = of_elems * C_eff * _PSUM_BYTES
    return CoreDataflow((1, 1, 1, 1), "spill", float(rd), float(wr),
                        utilization=1.0 / (kvec * cvec))


@lru_cache(maxsize=200_000)
def explore_intra_core(K: int, C: int, HW: int, R: int, S: int,
                       bytes_per_elem: int, glb_bytes: int,
                       macs_per_core: int, kind: str) -> CoreDataflow:
    """Vectorized tiling/loop-order search for one per-core workload.

    K: ofmap channels on this core; C: contraction channels; HW: spatial
    positions (H*W*B collapsed — they are fully parallel); RxS kernel.
    """
    kvec = 16
    cvec = max(1, macs_per_core // kvec)
    if kind in ("eltwise", "pool", "depthwise"):
        return _stream_dataflow(K, HW, bytes_per_elem, kind)

    C_eff = max(1, C)
    w_elems = K * C_eff * R * S if kind in ("conv", "fc") else 0
    if_elems = C_eff * HW * (R * S if kind == "conv" else 1)
    of_elems = K * HW
    bpe = bytes_per_elem

    tk = np.asarray(_pow2_tiles(K, 512), dtype=np.int64)[:, None, None]
    tc = np.asarray(_pow2_tiles(C_eff, 512), dtype=np.int64)[None, :, None]
    thw = np.asarray(_pow2_tiles(HW, 4096), dtype=np.int64)[None, None, :]

    # buffer need: weights tile + ifmap tile + psum tile (dbl buf fmaps)
    buf = (tk * tc * (R * S * bpe)
           + tc * thw * (bpe * 2)
           + tk * thw * _PSUM_BYTES)
    feasible = buf <= glb_bytes
    if not feasible.any():
        return _spill_dataflow(w_elems, if_elems, of_elems, K, C_eff, HW,
                               bpe, kvec, cvec)

    nk = -(-K // tk)
    nc = -(-C_eff // tc)
    nhw = -(-HW // thw)

    # same expressions (and the same int->float promotion points) as the
    # scalar reference, evaluated over the whole grid at once
    rd_ws = (w_elems * 1.0 + if_elems * nk) * bpe \
        + of_elems * (nc - 1) * _PSUM_BYTES
    wr_ws = (of_elems * nc * _PSUM_BYTES).astype(np.float64)
    rd_os = ((w_elems * nhw + if_elems * nk) * bpe).astype(np.float64)
    wr_os = np.float64(of_elems * _PSUM_BYTES)
    rd_is = (w_elems * nhw + if_elems * 1.0) * bpe \
        + of_elems * (nc - 1) * _PSUM_BYTES
    wr_is = wr_ws

    shape = np.broadcast_shapes(tk.shape, tc.shape, thw.shape)
    total = np.empty(shape + (3,), dtype=np.float64)
    total[..., 0] = rd_ws + wr_ws
    total[..., 1] = rd_os + wr_os
    total[..., 2] = rd_is + wr_is
    total[~feasible, :] = np.inf

    flat_i = int(np.argmin(total.reshape(-1)))
    i, j, k, o = np.unravel_index(flat_i, total.shape)
    rd = (rd_ws, rd_os, rd_is)[o]
    wr = (wr_ws, wr_os, wr_is)[o]
    rd_v = float(np.broadcast_to(rd, shape)[i, j, k])
    wr_v = float(np.broadcast_to(wr, shape)[i, j, k])

    # MAC array padding loss on the vectorized dims (tile-independent)
    uk = K / (-(-K // kvec) * kvec)
    uc = C_eff / (-(-C_eff // cvec) * cvec)
    return CoreDataflow((int(tk[i, 0, 0]), int(tc[0, j, 0]),
                         int(thw[0, 0, k]), 1),
                        _ORDERS[o], rd_v, wr_v, uk * uc)


def explore_intra_core_many(signatures: Sequence[Signature]
                            ) -> List[CoreDataflow]:
    """Batch API: dedupe signatures, dispatch each unique one once.

    Returns one ``CoreDataflow`` per input signature, aligned with the
    input order.  The SA evaluator collects every per-core signature of a
    layer group and resolves them through this single call.
    """
    uniq: dict = {}
    for sig in signatures:
        if sig not in uniq:
            uniq[sig] = explore_intra_core(*sig)
    return [uniq[sig] for sig in signatures]


def core_workload_signature(layer_K: int, layer_C: int, region_elems: int,
                            region_k: int, R: int, S: int) -> Tuple[int, int, int, int, int]:
    """Collapse a Region into the intra-core search signature."""
    hwb = max(1, region_elems // max(1, region_k))
    return (region_k, layer_C, hwb, R, S)
