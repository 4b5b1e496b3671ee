"""Transformer workload (the paper's default DSE workload, [Vaswani'17]).

Copy of ``src/repro/core/workloads/transformer.py``.  Encoder stack at
inference, int8 feature maps.  Attention score/context matmuls are
activation-activation ``matmul`` layers; projections and FFN are ``fc``
layers with H = sequence length.
"""

from __future__ import annotations

from ..workload import Graph, Layer


def transformer(n_layers: int = 6, d_model: int = 512, d_ff: int = 2048,
                seq: int = 512, name: str = "TF") -> Graph:
    g = Graph(name)
    prev = None
    for i in range(n_layers):
        t = f"l{i}"
        inputs = [prev] if prev else ()
        q = g.add(Layer(name=f"{t}_q", kind="fc", K=d_model, H=seq,
                        C=d_model), inputs).name
        k = g.add(Layer(name=f"{t}_k", kind="fc", K=d_model, H=seq,
                        C=d_model), inputs).name
        v = g.add(Layer(name=f"{t}_v", kind="fc", K=d_model, H=seq,
                        C=d_model), inputs).name
        # scores = Q K^T : ofmap (seq x seq), contraction over d_model
        s = g.add(Layer(name=f"{t}_qk", kind="matmul", K=seq, H=seq,
                        C=d_model), [q, k]).name
        # context = scores V : ofmap (seq x d_model), contraction over seq
        c = g.add(Layer(name=f"{t}_av", kind="matmul", K=d_model, H=seq,
                        C=seq), [s, v]).name
        o = g.add(Layer(name=f"{t}_o", kind="fc", K=d_model, H=seq,
                        C=d_model), [c]).name
        a1 = g.add(Layer(name=f"{t}_add1", kind="eltwise", K=d_model, H=seq,
                         n_inputs=2), [o, prev] if prev else [o]).name
        f1 = g.add(Layer(name=f"{t}_ff1", kind="fc", K=d_ff, H=seq,
                         C=d_model), [a1]).name
        f2 = g.add(Layer(name=f"{t}_ff2", kind="fc", K=d_model, H=seq,
                         C=d_ff), [f1]).name
        prev = g.add(Layer(name=f"{t}_add2", kind="eltwise", K=d_model, H=seq,
                           n_inputs=2), [f2, a1]).name
    g.validate()
    return g
