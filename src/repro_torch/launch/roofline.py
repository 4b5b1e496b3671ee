"""Roofline terms of one cell from its per-device counts.

Port of ``src/repro/launch/roofline.py``, for one NVIDIA H100 SXM a
device:

compute term    = per-device FLOPs / bf16 dense peak        (989e12 FLOP/s)
memory term     = per-device bytes / HBM3 bandwidth          (3.35e12 B/s)
collective term = per-device collective bytes / NVLink       (900e9 B/s)

The three rates are NVIDIA's H100 SXM data sheet figures (dense, without
sparsity; NVLink the fourth generation's total a GPU).  The reference's
single-link model is kept: one bandwidth for every collective, so on a
cluster whose mesh spans several nodes (the 256-device mesh is 32 nodes
of 8) the collective term is a floor: traffic between nodes runs slower.

The counts are per device (:mod:`repro_torch.launch.costs`: the local ops
of this rank's shards; a 256-way-sharded matmul counts 1/256 of the
global FLOPs), so the terms match the global/(devices x peak) formulas.
:func:`analyze` builds the record where the reference's
``analyze_compiled`` reads a compiled executable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops_bf16: float       # FLOP/s
    hbm_bw: float                # bytes/s
    link_bw: float               # bytes/s, the collective term's one link


# NVIDIA H100 SXM data sheet: bf16 dense tensor-core peak, HBM3 bandwidth,
# fourth-generation NVLink bandwidth a GPU
H100_SXM = Chip("NVIDIA H100 SXM", 989e12, 3.35e12, 900e9)


@dataclass
class Roofline:
    name: str
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_by_kind: Dict[str, int] = field(default_factory=dict)
    # memory proof
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    model_flops: float = 0.0           # 6*N*D (or 2*N*D serve), GLOBAL
    n_devices: int = 256
    compile_s: float = 0.0
    chip: Chip = field(default_factory=lambda: H100_SXM)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.chip.peak_flops_bf16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.chip.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / self.chip.link_bw

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global counted FLOPs (remat/redundancy waste)."""
        counted_global = self.flops_per_device * self.n_devices
        return self.model_flops / counted_global if counted_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute share of the bound: (model-FLOPs time) / t_bound."""
        t_useful = (self.model_flops / self.n_devices
                    / self.chip.peak_flops_bf16)
        return t_useful / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_by_kind": self.coll_by_kind,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "model_flops": self.model_flops,
            "n_devices": self.n_devices,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "compile_s": self.compile_s,
        }


def flash_kernel_adjustment(cfg, shape, data_ax: int = 16,
                            model_ax: int = 16, n_pod: int = 1,
                            block: int = 1024) -> float:
    """Bytes/device the flash kernel saves vs the plain block-scan route.

    The dry-run traces the plain flash scan (it runs on a ``"cpu"`` mesh,
    where no kernel runs); its per-kv-block score/prob tensors are written
    and read between ops, but the kernel keeps them on chip.  This
    analytic adjustment = (scan-internal s/p traffic) minus (ideal kernel
    q/k/v/o traffic), with x4 for train (fwd + remat-fwd + 2-pass bwd), x1
    for prefill, 0 for decode (einsum path, no scan).  Napkin math,
    reported alongside the as-traced term, never in place of it.
    """
    if cfg.family == "ssm" or shape.kind == "decode":
        return 0.0
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    B, S = shape.global_batch, shape.seq_len
    if S * S <= 256 * 2048:
        return 0.0                              # einsum path, no scan
    bshard = 1
    for ax in (n_pod, data_ax):
        if B % (bshard * ax) == 0:
            bshard *= ax
    B_loc = B // bshard
    # attention layout (mirrors launch.steps.derive_attn_rules)
    if KV % model_ax == 0 or H % model_ax == 0:
        heads_loc = max(1, H // model_ax)
        Sq_loc = S
    else:
        heads_loc = H
        Sq_loc = max(1, S // model_ax)
    nblocks = -(-S // block)
    per_call = nblocks * 2 * B_loc * heads_loc * Sq_loc * block * 4 * 2
    ideal = B_loc * S * (H + 2 * KV) * hd * 2 * 2
    n_attn = cfg.n_layers if cfg.family != "hybrid" else cfg.n_shared_attn()
    if cfg.family == "encdec":
        n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    passes = 4.0 if shape.kind == "train" else 1.0
    return max(0.0, (per_call - ideal) * n_attn * passes)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for inference tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n * tokens


def analyze(name: str, costs, argument_bytes: float, output_bytes: float,
            temp_bytes: float, model_flops: float, n_devices: int,
            compile_s: float = 0.0) -> Roofline:
    """The record of a traced step's per-device counts
    (:class:`repro_torch.launch.costs.Costs`) and memory."""
    return Roofline(
        name=name,
        flops_per_device=costs.flops,
        bytes_per_device=costs.bytes,
        coll_bytes_per_device=costs.coll_bytes,
        coll_by_kind={k: int(v) for k, v in costs.coll_by_kind.items()},
        argument_bytes=float(argument_bytes),
        output_bytes=float(output_bytes),
        temp_bytes=float(temp_bytes),
        model_flops=model_flops,
        n_devices=n_devices,
        compile_s=compile_s)
