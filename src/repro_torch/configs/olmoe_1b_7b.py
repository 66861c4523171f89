"""olmoe-1b-7b — 64-expert top-8 MoE with QK-norm.

16L d_model=2048 16H (kv=16, MHA) d_ff_expert=1024 vocab=50304, MoE 64e top-8.
[arXiv:2409.02060; hf]
"""
from repro_torch.configs.base import (ATTN, MOE, LayerKind, ModelConfig,
                                      MoEConfig, Segment)

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    segments=(Segment((LayerKind(ATTN, MOE),), 16),),
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                  norm_topk_probs=False),
    qk_norm=True,
    rope_theta=10000.0,
    source="arXiv:2409.02060",
).validate()
