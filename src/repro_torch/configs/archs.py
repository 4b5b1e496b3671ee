"""The registered architectures, as data.

Copy of ``src/repro/configs/archs.py`` reduced to the fields of
:class:`.base.ModelConfig`; every value is the reference's.
"""

from .base import ModelConfig, register

mamba2_370m = register(ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=32, n_kv=32, d_ff=0,
    ssm_state=128, ssm_headdim=64, ssm_expand=2,
    source="arXiv:2405.21060 (SSD); attn-free"))

llava_next_34b = register(ModelConfig(
    name="llava-next-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480,
    source="hf:llava-hf/llava-v1.6 (anyres tiling frontend stubbed)"))

zamba2_1p2b = register(ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_ff=8192,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, attn_every=6,
    source="arXiv:2411.15242; Mamba2 trunk + shared attn/mlp blocks"))

qwen15_110b = register(ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=49152,
    source="hf:Qwen/Qwen1.5 series; QKV bias"))

smollm_135m = register(ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv=3, d_ff=1536,
    source="hf:HuggingFaceTB/SmolLM-135M; llama-arch small"))

qwen3_0p6b = register(ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv=8, d_ff=3072,
    head_dim=128,
    source="hf:Qwen/Qwen3; qk_norm + GQA"))

qwen3_32b = register(ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv=8, d_ff=25600,
    head_dim=128,
    source="hf:Qwen/Qwen3; qk_norm + GQA"))

phi35_moe = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400,
    n_experts=16, top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct; 16e top-2"))

granite_moe = register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=512,
    n_experts=40, top_k=8,
    source="hf:ibm-granite/granite-3.0 series; 40e top-8"))

whisper_small = register(ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072,
    source="arXiv:2212.04356; conv frontend stubbed (frame embeddings)"))

# the paper's own default workload (Vaswani'17 base Transformer)
paper_transformer = register(ModelConfig(
    name="paper-transformer", family="dense",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048,
    source="arXiv:1706.03762; the paper's Sec. VI-A default DSE workload"))

ALL = [mamba2_370m, llava_next_34b, zamba2_1p2b, qwen15_110b, smollm_135m,
       qwen3_0p6b, qwen3_32b, phi35_moe, granite_moe, whisper_small,
       paper_transformer]
