"""command-r-35b — dense GQA, parallel attn+ffn blocks, no bias, tied embeddings.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ATTN, DENSE, LayerKind, ModelConfig, Segment

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    segments=(Segment((LayerKind(ATTN, DENSE),), 40),),
    parallel_block=True,
    tie_embeddings=True,
    norm_eps=1e-5,
    rope_theta=8_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-v01",
).validate()
