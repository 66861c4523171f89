"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE every 2 layers.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
[arXiv:2403.19887; hf]. Attention at layer i where i % 8 == 4; MoE on odd layers.
"""
from repro_torch.configs.base import (ATTN, DENSE, MAMBA, MOE, LayerKind,
                                      ModelConfig, MoEConfig, SSMConfig, Segment)

_PATTERN = tuple(
    LayerKind(ATTN if i % 8 == 4 else MAMBA, MOE if i % 2 == 1 else DENSE)
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    segments=(Segment(_PATTERN, 4),),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=64, chunk_size=256),
    rope_theta=10000.0,
    source="arXiv:2403.19887",
).validate()
