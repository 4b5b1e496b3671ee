"""Sparse Mixture-of-Experts blocks in the expected-traffic cube IR.

Copy of ``src/repro/core/workloads/moe.py``.

A routed MoE FFN with ``E`` experts and ``top_k`` active per token is
data-dependent: which expert a token visits is decided at runtime by the
router.  The expected-traffic IR models it exactly in expectation under the
standard uniform-load assumption (what capacity-factor training targets):

* ``router``  — a dense ``d -> E`` gate projection (tiny, always-on);
* each routed expert ``e`` — its up/down projections carry
  ``traffic_scale = top_k / E`` (the expected fraction of tokens it
  processes: MACs, activation DRAM fetches and emitted ofmap all scale),
  while its *weights* stay dense (``weight_traffic_scale = 1.0`` — the full
  expert must be resident/loaded regardless of routing);
* the dispatch edges (block input -> expert, router gates -> expert) carry
  edge multiplicity ``top_k / E`` — the producer is dense but each expert
  only reads its expected share;
* optional shared experts are plain dense FFNs;
* ``combine`` — an eltwise reduction whose ``n_inputs`` is the *expected*
  number of active contributions per token (``top_k`` + shared + residual),
  fed by all ``E`` expert outputs, each arriving pre-scaled through its
  producer's ``traffic_scale``.

Summing over experts, expected routed-FFN MACs equal a dense FFN of width
``top_k * d_ff`` — the legacy ``family="moe-dense"`` approximation in
``lm_graph`` — but the *graph* now exposes the real structure: E thin
parallel branches with dense-resident weights, which is what makes MoE
mappings (expert-parallel core allocation, weight-capacity pressure)
different from a fat dense FFN.
"""

from __future__ import annotations

from ..workload import Graph, Layer


def add_moe_ffn(g: Graph, t: str, src: str, d_model: int, d_ff: int,
                n_experts: int, top_k: int, seq: int,
                n_shared: int = 0, d_shared: int = 0, bpe: int = 2) -> str:
    """Append one routed-MoE FFN block to ``g``; returns the output layer.

    ``src`` is the block input (e.g. the post-attention residual add).
    ``n_shared`` dense shared experts of width ``d_shared or d_ff`` run
    always-on next to the routed ones (DeepSeek/Granite style).  Gated-MLP
    convention: ``up`` produces ``2 * d_ff`` (gate + value), ``down``
    contracts ``d_ff``.
    """
    if not 1 <= top_k <= n_experts:
        raise ValueError(f"top_k={top_k} must be in [1, n_experts={n_experts}]")
    frac = top_k / n_experts
    router = g.add(Layer(name=f"{t}_router", kind="fc", K=n_experts, H=seq,
                         C=d_model, bytes_per_elem=bpe), [src]).name
    combine_in = []
    for e in range(n_experts):
        up = g.add(Layer(name=f"{t}_e{e}_up", kind="fc", K=2 * d_ff, H=seq,
                         C=d_model, bytes_per_elem=bpe, traffic_scale=frac),
                   [(src, frac), (router, frac)]).name
        down = g.add(Layer(name=f"{t}_e{e}_down", kind="fc", K=d_model,
                           H=seq, C=d_ff, bytes_per_elem=bpe,
                           traffic_scale=frac), [up]).name
        combine_in.append(down)
    ds = d_shared or d_ff
    for s in range(n_shared):
        sup = g.add(Layer(name=f"{t}_s{s}_up", kind="fc", K=2 * ds, H=seq,
                          C=d_model, bytes_per_elem=bpe), [src]).name
        sdown = g.add(Layer(name=f"{t}_s{s}_down", kind="fc", K=d_model,
                            H=seq, C=ds, bytes_per_elem=bpe), [sup]).name
        combine_in.append(sdown)
    # expected active inputs per token: top_k routed + shared + residual
    out = g.add(Layer(name=f"{t}_combine", kind="eltwise", K=d_model, H=seq,
                      n_inputs=top_k + n_shared + 1, bytes_per_elem=bpe),
                combine_in + [src]).name
    return out


def moe_transformer(n_layers: int = 2, d_model: int = 512, d_ff: int = 1024,
                    n_experts: int = 8, top_k: int = 2, n_shared: int = 1,
                    seq: int = 512, name: str = "MoE", bpe: int = 2) -> Graph:
    """Transformer encoder stack with a routed-MoE FFN in every block."""
    g = Graph(name)
    prev = None
    for i in range(n_layers):
        t = f"l{i}"
        qkv = g.add(Layer(name=f"{t}_qkv", kind="fc", K=3 * d_model, H=seq,
                          C=d_model, bytes_per_elem=bpe),
                    [prev] if prev else ()).name
        qk = g.add(Layer(name=f"{t}_qk", kind="matmul", K=seq, H=seq,
                         C=d_model, bytes_per_elem=bpe), [qkv]).name
        av = g.add(Layer(name=f"{t}_av", kind="matmul", K=d_model, H=seq,
                         C=seq, bytes_per_elem=bpe), [qk]).name
        o = g.add(Layer(name=f"{t}_o", kind="fc", K=d_model, H=seq,
                        C=d_model, bytes_per_elem=bpe), [av]).name
        a1 = g.add(Layer(name=f"{t}_add1", kind="eltwise", K=d_model, H=seq,
                         n_inputs=2, bytes_per_elem=bpe),
                   [o, prev] if prev else [o]).name
        prev = add_moe_ffn(g, t, a1, d_model, d_ff, n_experts, top_k, seq,
                           n_shared=n_shared, bpe=bpe)
    g.validate()
    return g
