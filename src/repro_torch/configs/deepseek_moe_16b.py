"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts, top-6.

28L d_model=2048 16H (kv=16, MHA) d_ff_expert=1408 vocab=102400, MoE 64e top-6.
First layer uses a dense FFN (d_ff=10944) per the released model.
[arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import (ATTN, DENSE, MOE, LayerKind, ModelConfig,
                                      MoEConfig, Segment)

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense FFN width (layer 0)
    vocab_size=102400,
    segments=(
        Segment((LayerKind(ATTN, DENSE),), 1),
        Segment((LayerKind(ATTN, MOE),), 27),
    ),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, d_ff_shared=2816,
                  norm_topk_probs=False),
    rope_theta=10000.0,
    source="arXiv:2401.06066",
).validate()
