"""The paper's Table I model configurations (§VI) as ModelConfig
instances, and its default system sizes. Port of
``repro/sim/paper_models.py`` on the port's ``configs/base.py``."""
from __future__ import annotations

from repro_torch.configs.base import (ATTN, DENSE, MOE, LayerKind, ModelConfig, MoEConfig,
                                      Segment)


def _lm(name, layers, hidden, interm, heads, deg_grp, n_ex, top_k, *,
        gated: bool = True) -> ModelConfig:
    kv = heads // deg_grp
    if n_ex:
        if name == "glam":
            # GLaM alternates dense decoder and MoE decoder blocks
            pattern = (LayerKind(ATTN, DENSE), LayerKind(ATTN, MOE))
            segments = (Segment(pattern, layers // 2),)
        else:
            segments = (Segment((LayerKind(ATTN, MOE),), layers),)
        moe = MoEConfig(num_experts=n_ex, top_k=top_k, d_ff_expert=interm)
    else:
        segments = (Segment((LayerKind(ATTN, DENSE),), layers),)
        moe = None
    return ModelConfig(
        name=name, family="moe" if n_ex else "dense", num_layers=layers,
        d_model=hidden, num_heads=heads, num_kv_heads=kv, d_ff=interm,
        vocab_size=32000, segments=segments, moe=moe, gated_ffn=gated,
    ).validate()


# Table I: Model / Param / #layer / Hidden / Interm / #head / deg_grp / N_ex / top-k
# GLaM and OPT use classic 2-matrix FFNs; the rest are SwiGLU.
MIXTRAL = _lm("mixtral", 32, 4096, 14336, 32, 4, 8, 2)               # 47B
GLAM = _lm("glam", 32, 4096, 16384, 32, 1, 64, 2, gated=False)       # 143B
GROK1 = _lm("grok1", 64, 6144, 32768, 48, 6, 8, 2)                   # 314B
OPT = _lm("opt", 64, 9216, 36864, 72, 1, 0, 0, gated=False)          # 66B
LLAMA3 = _lm("llama3", 80, 8192, 28672, 64, 8, 0, 0)                 # 70B

PAPER_MODELS = {m.name: m for m in (MIXTRAL, GLAM, GROK1, OPT, LLAMA3)}

# default system size (paper §VI): (nodes, devices per node)
PAPER_SYSTEMS = {
    "mixtral": (1, 4), "opt": (1, 4), "llama3": (1, 4),
    "glam": (1, 8), "grok1": (2, 8),
}
