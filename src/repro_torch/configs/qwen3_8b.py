"""qwen3-8b — dense GQA with QK-norm.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936. [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ATTN, DENSE, LayerKind, ModelConfig, Segment

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    segments=(Segment((LayerKind(ATTN, DENSE),), 36),),
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
).validate()
