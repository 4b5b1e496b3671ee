"""Multi-head Latent Attention (MLA) blocks in the cube IR.

Copy of ``src/repro/core/workloads/mla.py``.

DeepSeek-style MLA replaces the dense QKV projection with low-rank
compressions: queries project down to ``q_rank`` and back up; keys/values
share ONE compressed ``kv_rank`` cube (the latent KV cache) from which
per-head K and V are re-expanded.  In the cube IR that is a chain of thin
``fc`` layers — the ``kv_down`` cube with ``K = kv_rank`` is the low-rank
KV compression cube whose small ofmap is exactly why MLA shrinks KV traffic
— followed by the usual activation-activation score/context matmuls.

All layers are dense (``traffic_scale = 1.0``): MLA changes the *shape* of
the traffic, not its data-dependence, so it exercises the workload zoo's
coverage of skinny-cube mappings rather than the expected-traffic scales.
Pair with :func:`repro_torch.core.workloads.moe.add_moe_ffn` for a
DeepSeek-shaped block (``moe_ffn=True``).
"""

from __future__ import annotations

from ..workload import Graph, Layer
from .moe import add_moe_ffn


def add_mla_attention(g: Graph, t: str, src: str, d_model: int,
                      n_heads: int, q_rank: int, kv_rank: int, seq: int,
                      head_dim: int = 0, bpe: int = 2) -> str:
    """Append one MLA attention block (+ residual add); returns its output."""
    hd = head_dim or max(1, d_model // n_heads)
    dh = n_heads * hd
    inputs = [src] if src else ()
    qd = g.add(Layer(name=f"{t}_qdown", kind="fc", K=q_rank, H=seq,
                     C=d_model, bytes_per_elem=bpe), inputs).name
    qu = g.add(Layer(name=f"{t}_qup", kind="fc", K=dh, H=seq, C=q_rank,
                     bytes_per_elem=bpe), [qd]).name
    # the latent KV cube: one shared low-rank compression for K and V
    kvd = g.add(Layer(name=f"{t}_kvdown", kind="fc", K=kv_rank, H=seq,
                      C=d_model, bytes_per_elem=bpe), inputs).name
    ku = g.add(Layer(name=f"{t}_kup", kind="fc", K=dh, H=seq, C=kv_rank,
                     bytes_per_elem=bpe), [kvd]).name
    vu = g.add(Layer(name=f"{t}_vup", kind="fc", K=dh, H=seq, C=kv_rank,
                     bytes_per_elem=bpe), [kvd]).name
    qk = g.add(Layer(name=f"{t}_qk", kind="matmul", K=seq, H=seq, C=dh,
                     bytes_per_elem=bpe), [qu, ku]).name
    av = g.add(Layer(name=f"{t}_av", kind="matmul", K=dh, H=seq, C=seq,
                     bytes_per_elem=bpe), [qk, vu]).name
    o = g.add(Layer(name=f"{t}_o", kind="fc", K=d_model, H=seq, C=dh,
                    bytes_per_elem=bpe), [av]).name
    out = g.add(Layer(name=f"{t}_add1", kind="eltwise", K=d_model, H=seq,
                      n_inputs=2, bytes_per_elem=bpe),
                [o, src] if src else [o]).name
    return out


def mla_transformer(n_layers: int = 2, d_model: int = 512, n_heads: int = 8,
                    q_rank: int = 0, kv_rank: int = 0, d_ff: int = 1024,
                    seq: int = 512, name: str = "MLA", bpe: int = 2,
                    moe_ffn: bool = False, n_experts: int = 8,
                    top_k: int = 2) -> Graph:
    """MLA transformer stack; ``moe_ffn=True`` makes it DeepSeek-shaped
    (MLA attention + routed-MoE FFN).  Default ranks follow the published
    proportions: ``q_rank ~ d/4``, ``kv_rank ~ d/8``.
    """
    q_rank = q_rank or max(1, d_model // 4)
    kv_rank = kv_rank or max(1, d_model // 8)
    g = Graph(name)
    prev = None
    for i in range(n_layers):
        t = f"l{i}"
        a1 = add_mla_attention(g, t, prev, d_model, n_heads, q_rank,
                               kv_rank, seq, bpe=bpe)
        if moe_ffn:
            prev = add_moe_ffn(g, t, a1, d_model, d_ff, n_experts, top_k,
                               seq, n_shared=1, bpe=bpe)
        else:
            up = g.add(Layer(name=f"{t}_up", kind="fc", K=2 * d_ff, H=seq,
                             C=d_model, bytes_per_elem=bpe), [a1]).name
            down = g.add(Layer(name=f"{t}_down", kind="fc", K=d_model,
                               H=seq, C=d_ff, bytes_per_elem=bpe), [up]).name
            prev = g.add(Layer(name=f"{t}_add2", kind="eltwise", K=d_model,
                               H=seq, n_inputs=2, bytes_per_elem=bpe),
                         [down, a1]).name
    g.validate()
    return g
