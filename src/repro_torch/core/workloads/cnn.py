"""CNN workload DAGs: ResNet-50, ResNeXt-50 (32x4d), Inception-ResNet-v1,
PNASNet (representative cell structure).

Copy of ``src/repro/core/workloads/cnn.py``.

All for 224x224 (299x299 for IRes) ImageNet inference, int8 feature maps.
PNASNet-5-large's full cell genotype is approximated with its five-branch
separable-conv cell skeleton at matching channel counts — the paper uses it
as a "complex dependency" workload, so dependency structure and op mix are
what matter (noted in DESIGN.md).
"""

from __future__ import annotations

from typing import List, Optional

from ..workload import Graph, Layer


def _conv(g: Graph, name: str, src: Optional[List[str]], K: int, H: int, W: int,
          C: int, R: int = 1, S: int = None, stride: int = 1,
          groups: int = 1) -> str:
    S = R if S is None else S
    g.add(Layer(name=name, kind="conv", K=K, H=H, W=W, C=C, R=R, S=S,
                stride=stride, groups=groups), src or ())
    return name


def _pool(g: Graph, name: str, src: str, K: int, H: int, W: int,
          stride: int = 2) -> str:
    g.add(Layer(name=name, kind="pool", K=K, H=H, W=W, stride=stride), [src])
    return name


def _add(g: Graph, name: str, srcs: List[str], K: int, H: int, W: int) -> str:
    g.add(Layer(name=name, kind="eltwise", K=K, H=H, W=W, n_inputs=len(srcs)),
          srcs)
    return name


def _fc(g: Graph, name: str, src: str, K: int, C: int) -> str:
    g.add(Layer(name=name, kind="fc", K=K, C=C), [src])
    return name


# ---------------------------------------------------------------------------
def _resnet_backbone(name: str, groups: int, width: int) -> Graph:
    """ResNet-50 skeleton; groups=32/width=4 gives ResNeXt-50 (32x4d)."""
    g = Graph(name)
    _conv(g, "conv1", None, 64, 112, 112, 3, R=7, stride=2)
    prev = _pool(g, "pool1", "conv1", 64, 56, 56, stride=2)

    stages = [  # (n_blocks, mid_channels, out_channels, spatial)
        (3, 64 * width // 4 if groups > 1 else 64, 256, 56),
        (4, 128 * width // 4 if groups > 1 else 128, 512, 28),
        (6, 256 * width // 4 if groups > 1 else 256, 1024, 14),
        (3, 512 * width // 4 if groups > 1 else 512, 2048, 7),
    ]
    in_ch = 64
    for si, (n_blocks, mid, out, hw) in enumerate(stages):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and si > 0) else 1
            tag = f"s{si}b{b}"
            c1 = _conv(g, f"{tag}_c1", [prev], mid, hw, hw, in_ch)
            c2 = _conv(g, f"{tag}_c2", [c1], mid, hw, hw, mid, R=3,
                       stride=stride, groups=groups)
            c3 = _conv(g, f"{tag}_c3", [c2], out, hw, hw, mid)
            if b == 0:
                skip = _conv(g, f"{tag}_down", [prev], out, hw, hw, in_ch,
                             stride=stride)
            else:
                skip = prev
            prev = _add(g, f"{tag}_add", [c3, skip], out, hw, hw)
            in_ch = out
    p = _pool(g, "avgpool", prev, 2048, 1, 1, stride=7)
    _fc(g, "fc", p, 1000, 2048)
    g.validate()
    return g


def resnet50() -> Graph:
    return _resnet_backbone("RN-50", groups=1, width=4)


def resnext50() -> Graph:
    return _resnet_backbone("RNX", groups=32, width=8)


# ---------------------------------------------------------------------------
def inception_resnet_v1() -> Graph:
    """Inception-ResNet-v1 (299x299): stem + 5xA + redA + 10xB + redB + 5xC."""
    g = Graph("IRes")
    # stem
    _conv(g, "stem1", None, 32, 149, 149, 3, R=3, stride=2)
    _conv(g, "stem2", ["stem1"], 32, 147, 147, 32, R=3)
    _conv(g, "stem3", ["stem2"], 64, 147, 147, 32, R=3)
    _pool(g, "stem_pool", "stem3", 64, 73, 73, stride=2)
    _conv(g, "stem4", ["stem_pool"], 80, 73, 73, 64)
    _conv(g, "stem5", ["stem4"], 192, 71, 71, 80, R=3)
    prev = _conv(g, "stem6", ["stem5"], 256, 35, 35, 192, R=3, stride=2)

    def block_a(i: int, src: str) -> str:  # 35x35, 256ch
        b0 = _conv(g, f"a{i}_b0", [src], 32, 35, 35, 256)
        b1a = _conv(g, f"a{i}_b1a", [src], 32, 35, 35, 256)
        b1b = _conv(g, f"a{i}_b1b", [b1a], 32, 35, 35, 32, R=3)
        b2a = _conv(g, f"a{i}_b2a", [src], 32, 35, 35, 256)
        b2b = _conv(g, f"a{i}_b2b", [b2a], 32, 35, 35, 32, R=3)
        b2c = _conv(g, f"a{i}_b2c", [b2b], 32, 35, 35, 32, R=3)
        up = _conv(g, f"a{i}_up", [b0, b1b, b2c], 256, 35, 35, 96)
        return _add(g, f"a{i}_add", [up, src], 256, 35, 35)

    for i in range(5):
        prev = block_a(i, prev)

    # reduction A -> 17x17, 896ch
    ra_p = _pool(g, "redA_pool", prev, 256, 17, 17, stride=2)
    ra_c = _conv(g, "redA_c", [prev], 384, 17, 17, 256, R=3, stride=2)
    ra_b1 = _conv(g, "redA_b1a", [prev], 192, 35, 35, 256)
    ra_b2 = _conv(g, "redA_b1b", [ra_b1], 192, 35, 35, 192, R=3)
    ra_b3 = _conv(g, "redA_b1c", [ra_b2], 256, 17, 17, 192, R=3, stride=2)
    prev = _conv(g, "redA_join", [ra_p, ra_c, ra_b3], 896, 17, 17, 896)

    def block_b(i: int, src: str) -> str:  # 17x17, 896ch
        b0 = _conv(g, f"b{i}_b0", [src], 128, 17, 17, 896)
        b1a = _conv(g, f"b{i}_b1a", [src], 128, 17, 17, 896)
        b1b = _conv(g, f"b{i}_b1b", [b1a], 128, 17, 17, 128, R=1, S=7)
        b1c = _conv(g, f"b{i}_b1c", [b1b], 128, 17, 17, 128, R=7, S=1)
        up = _conv(g, f"b{i}_up", [b0, b1c], 896, 17, 17, 256)
        return _add(g, f"b{i}_add", [up, src], 896, 17, 17)

    for i in range(10):
        prev = block_b(i, prev)

    # reduction B -> 8x8, 1792ch
    rb_p = _pool(g, "redB_pool", prev, 896, 8, 8, stride=2)
    rb_1a = _conv(g, "redB_1a", [prev], 256, 17, 17, 896)
    rb_1b = _conv(g, "redB_1b", [rb_1a], 384, 8, 8, 256, R=3, stride=2)
    rb_2a = _conv(g, "redB_2a", [prev], 256, 17, 17, 896)
    rb_2b = _conv(g, "redB_2b", [rb_2a], 256, 8, 8, 256, R=3, stride=2)
    rb_3a = _conv(g, "redB_3a", [prev], 256, 17, 17, 896)
    rb_3b = _conv(g, "redB_3b", [rb_3a], 256, 17, 17, 256, R=3)
    rb_3c = _conv(g, "redB_3c", [rb_3b], 256, 8, 8, 256, R=3, stride=2)
    prev = _conv(g, "redB_join", [rb_p, rb_1b, rb_2b, rb_3c], 1792, 8, 8, 1792)

    def block_c(i: int, src: str) -> str:  # 8x8, 1792ch
        b0 = _conv(g, f"c{i}_b0", [src], 192, 8, 8, 1792)
        b1a = _conv(g, f"c{i}_b1a", [src], 192, 8, 8, 1792)
        b1b = _conv(g, f"c{i}_b1b", [b1a], 192, 8, 8, 192, R=1, S=3)
        b1c = _conv(g, f"c{i}_b1c", [b1b], 192, 8, 8, 192, R=3, S=1)
        up = _conv(g, f"c{i}_up", [b0, b1c], 1792, 8, 8, 384)
        return _add(g, f"c{i}_add", [up, src], 1792, 8, 8)

    for i in range(5):
        prev = block_c(i, prev)

    p = _pool(g, "avgpool", prev, 1792, 1, 1, stride=8)
    _fc(g, "fc", p, 1000, 1792)
    g.validate()
    return g


# ---------------------------------------------------------------------------
def pnasnet(n_cells: int = 9) -> Graph:
    """PNASNet-style five-branch separable-conv cells with skip inputs."""
    g = Graph("PNas")
    _conv(g, "stem", None, 96, 112, 112, 3, R=3, stride=2)
    hw, ch = 56, 270
    prev = _conv(g, "stem_red", ["stem"], ch, hw, hw, 96, R=3, stride=2)
    prev2 = "stem"

    def sep(name: str, src: str, K: int, C: int, H: int, W: int,
            R: int, stride: int = 1) -> str:
        d = g.add(Layer(name=f"{name}_dw", kind="depthwise", K=C, H=H, W=W,
                        R=R, S=R, stride=stride), [src]).name
        return _conv(g, f"{name}_pw", [d], K, H, W, C)

    for cell in range(n_cells):
        red = cell in (n_cells // 3, 2 * n_cells // 3)
        if red:
            hw //= 2
            ch *= 2
        tag = f"cell{cell}"
        s = 2 if red else 1
        # five branches, PNASNet-5 cell op mix (sep5, sep3, sep7, pool, iden)
        b1 = sep(f"{tag}_s5", prev, ch // 5, ch // (2 if red else 1), hw, hw, 5, s)
        b2 = sep(f"{tag}_s3", prev, ch // 5, ch // (2 if red else 1), hw, hw, 3, s)
        b3 = sep(f"{tag}_s7", prev2, ch // 5, g.layers[prev2].K, hw, hw, 7,
                 max(1, (g.layers[prev2].H // hw)))
        b4 = _pool(g, f"{tag}_mp", prev, g.layers[prev].K, hw, hw,
                   stride=max(1, g.layers[prev].H // hw))
        b4 = _conv(g, f"{tag}_mp_pw", [b4], ch // 5, hw, hw, g.layers[prev].K)
        b5 = sep(f"{tag}_s3b", prev, ch - 4 * (ch // 5), ch // (2 if red else 1),
                 hw, hw, 3, s)
        join = _conv(g, f"{tag}_join", [b1, b2, b3, b4, b5], ch, hw, hw, ch)
        prev2, prev = prev, join
    p = _pool(g, "avgpool", prev, ch, 1, 1, stride=hw)
    _fc(g, "fc", p, 1000, ch)
    g.validate()
    return g
