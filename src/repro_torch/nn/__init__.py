"""Model layers as ``nn.Module``s whose parameter names are the reference's
pytree keys (port of ``src/repro/nn``)."""

from .attention import (Attention, init_kv_cache, merge_attention,
                        multihead_attention)
from .layers import (Embedding, LayerNorm, Linear, RMSNorm, gelu, make_norm,
                     softmax_cross_entropy, swiglu)
from .mamba2 import (Mamba2, init_ssm_cache, ssd_chunked, ssd_chunked_ref,
                     ssd_decode_step)
from .moe import MoE
from .params import count_params, param_bytes
from .rope import apply_rope
