"""Export the registered LM architectures into the Gemini mapping IR.

Copy of ``src/repro/core/workloads/lm_graph.py``.  Each transformer block
becomes fc/matmul/eltwise layers with H = sequence length; Mamba2 blocks
map to in/out projections plus an SSD mixing layer whose contraction dim
approximates the SSD arithmetic (2*d_state state I/O + chunk-local
quadratic).  bf16 serving feature maps (bytes_per_elem=2).  Layer names,
dims, ``bytes_per_elem`` and edge order follow the reference line for line,
so a port-built graph has the reference's fingerprint.

Routed-MoE blocks (``family="moe"``) export the routed structure through
:func:`.moe.add_moe_ffn`: a router, ``n_experts`` expert branches carrying
``traffic_scale = top_k / n_experts``, and an expected-active-width
combine.  The legacy ``family="moe-dense"`` collapses the routing into one
dense FFN of the active width ``top_k * d_ff``.  The registered configs
have no shared experts, so no block adds any (the reference reads an
``n_shared_experts`` field that no config defines).
"""

from __future__ import annotations

from ...configs.base import ModelConfig
from ..workload import Graph, Layer
from .moe import add_moe_ffn


def _fc(g, name, src, K, C, seq, bpe=2):
    g.add(Layer(name=name, kind="fc", K=K, H=seq, C=C, bytes_per_elem=bpe),
          [src] if src else ())
    return name


def lm_graph(cfg: ModelConfig, seq: int = 4096, n_layers: int = 0) -> Graph:
    """Layer DAG of one LM architecture (optionally truncated depth)."""
    L = n_layers or cfg.n_layers
    g = Graph(cfg.name)
    d = cfg.d_model
    prev = None
    for i in range(L):
        t = f"l{i}"
        if cfg.family in ("ssm", "hybrid"):
            d_in = cfg.ssm_expand * d
            gn = 2 * cfg.ssm_groups * cfg.ssm_state
            nh = d_in // cfg.ssm_headdim
            inp = _fc(g, f"{t}_in", prev, 2 * d_in + gn + nh, d, seq)
            c_eff = 2 * cfg.ssm_state + cfg.ssm_chunk
            g.add(Layer(name=f"{t}_ssd", kind="matmul", K=d_in, H=seq,
                        C=c_eff, bytes_per_elem=2), [inp])
            out = _fc(g, f"{t}_out", f"{t}_ssd", d, d_in, seq)
            prev = g.add(Layer(name=f"{t}_add", kind="eltwise", K=d, H=seq,
                               n_inputs=2, bytes_per_elem=2),
                         [out, prev] if prev else [out]).name
            is_attn = (cfg.family == "hybrid" and cfg.attn_every
                       and i % cfg.attn_every == 0)
            if not is_attn:
                continue
        # attention block (dense/moe/hybrid-shared)
        hd = cfg.hd
        qkv = _fc(g, f"{t}_qkv", prev, (cfg.n_heads + 2 * cfg.n_kv) * hd,
                  d, seq)
        g.add(Layer(name=f"{t}_qk", kind="matmul", K=seq, H=seq,
                    C=cfg.n_heads * hd, bytes_per_elem=2), [qkv])
        g.add(Layer(name=f"{t}_av", kind="matmul", K=cfg.n_heads * hd, H=seq,
                    C=seq, bytes_per_elem=2), [f"{t}_qk"])
        o = _fc(g, f"{t}_o", f"{t}_av", d, cfg.n_heads * hd, seq)
        a1 = g.add(Layer(name=f"{t}_add1", kind="eltwise", K=d, H=seq,
                         n_inputs=2, bytes_per_elem=2),
                   [o, prev] if prev else [o]).name
        if cfg.family == "moe":
            # routed MoE: expected-traffic expert branches
            prev = add_moe_ffn(g, t, a1, d, cfg.d_ff, cfg.n_experts,
                               cfg.top_k, seq)
            continue
        # legacy "moe-dense": routing collapsed into one dense FFN of the
        # active width
        ff = (cfg.top_k * cfg.d_ff) if cfg.family == "moe-dense" else cfg.d_ff
        if ff:
            up = _fc(g, f"{t}_up", a1, 2 * ff, d, seq)
            down = _fc(g, f"{t}_down", up, d, ff, seq)
            prev = g.add(Layer(name=f"{t}_add2", kind="eltwise", K=d, H=seq,
                               n_inputs=2, bytes_per_elem=2),
                         [down, a1]).name
        else:
            prev = a1
    g.validate()
    return g
