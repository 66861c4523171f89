"""whisper-small — encoder-decoder audio transformer (conv frontend stubbed).

12L encoder + 12L decoder, d_model=768 12H (kv=12, MHA) d_ff=3072 vocab=51865.
[arXiv:2212.04356; unverified]

Only the transformer backbone runs: its inputs are precomputed log-mel frame
embeddings (batch, frames, d_model); the strided-conv frontend is a stub.
RoPE stands in for learned positions, as in the reference configuration.
"""
from repro_torch.configs.base import (ATTN_BIDIR, ATTN_CROSS, DENSE, LayerKind,
                                      ModelConfig, Segment)

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,   # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    segments=(Segment((LayerKind(ATTN_CROSS, DENSE),), 12),),
    is_encoder_decoder=True,
    enc_segments=(Segment((LayerKind(ATTN_BIDIR, DENSE),), 12),),
    enc_num_layers=12,
    tie_embeddings=True,
    norm_eps=1e-5,
    rope_theta=10000.0,
    source="arXiv:2212.04356",
).validate()
