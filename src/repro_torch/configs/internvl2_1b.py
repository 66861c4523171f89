"""internvl2-1b — VLM: InternViT frontend (stub) + Qwen2-0.5B-class LM backbone.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. [arXiv:2404.16821; hf]

Its inputs are ``frontend_embeds`` precomputed patch embeddings (batch, 1024,
d_model) prepended to the text-token embeddings; only the LM backbone runs
(the modality frontend is a stub).
"""
from repro_torch.configs.base import ATTN, DENSE, LayerKind, ModelConfig, Segment

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    segments=(Segment((LayerKind(ATTN, DENSE),), 24),),
    attn_bias=True,
    tie_embeddings=True,
    frontend_embeds=1024,
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821",
).validate()
