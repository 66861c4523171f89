"""gemma3-4b — dense with 5:1 local (sliding-window 1024) : global attention.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, head_dim=256, qk-norm.
29 of the 34 layers attend a window of 1024 positions and keep a ring cache
of window + 1 slots; the 5 global layers keep a full-length one.
[hf:google/gemma-3-4b-pt; unverified]
"""
from repro_torch.configs.base import (ATTN, ATTN_LOCAL, DENSE, LayerKind, ModelConfig,
                                      Segment)

_LOCAL = LayerKind(ATTN_LOCAL, DENSE)
_GLOBAL = LayerKind(ATTN, DENSE)
# layers 0..33: 5 locals then 1 global, repeated; the final partial period is local
_PERIOD = (_LOCAL,) * 5 + (_GLOBAL,)

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    segments=(
        Segment(_PERIOD, 5),          # 30 layers
        Segment((_LOCAL,), 4),        # tail: 4 local layers
    ),
    sliding_window=1024,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="hf:google/gemma-3-4b-pt",
).validate()
