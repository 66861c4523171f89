"""mamba2-2.7b — pure SSM (attention-free), SSD (state-space duality).

64L d_model=2560 vocab=50280, ssm_state=128, headdim=64, expand=2
(d_inner=5120, 80 heads). No FFN sublayer (the Mamba block is the whole layer).
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import MAMBA, NONE, LayerKind, ModelConfig, Segment, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,          # unused by the mamba mixer
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    segments=(Segment((LayerKind(MAMBA, NONE),), 64),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, chunk_size=256),
    tie_embeddings=True,
    norm_eps=1e-5,
    source="arXiv:2405.21060",
).validate()
