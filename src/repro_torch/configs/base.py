"""Model configuration dataclasses (the subset the port serves).

Own copy of ``repro/configs/base.py``'s ``LayerKind`` / ``Segment`` /
``MoEConfig`` / ``SSMConfig`` / ``ModelConfig`` / ``small_test_config`` with
the same field
names and defaults, so a configuration reads the same in both packages.
Layer stacking is described by *segments*: each segment is ``repeats``
copies of a pattern, and its parameters carry a leading stacked ``layers``
axis that the port walks with a Python loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# mixer kinds
ATTN = "attn"              # global self attention (causal for LM)
ATTN_LOCAL = "attn_local"  # sliding-window self attention
ATTN_BIDIR = "attn_bidir"  # bidirectional (encoder) attention
ATTN_CROSS = "attn_cross"  # decoder block with self + cross attention
MAMBA = "mamba"            # Mamba-2 SSD mixer

# ffn kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"


@dataclass(frozen=True)
class LayerKind:
    mixer: str
    ffn: str

    def __post_init__(self):
        assert self.mixer in (ATTN, ATTN_LOCAL, ATTN_BIDIR, ATTN_CROSS, MAMBA), self.mixer
        assert self.ffn in (DENSE, MOE, NONE), self.ffn


@dataclass(frozen=True)
class Segment:
    """A run of identical super-blocks: ``repeats`` stacked copies of the
    ``pattern`` (a tuple of LayerKind applied in order)."""
    pattern: Tuple[LayerKind, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    router_jitter: float = 0.0
    capacity_factor: float = 1.25   # grouped-path capacity factor
    aux_loss_coef: float = 0.01
    norm_topk_probs: bool = True


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk_size: int = 256
    ngroups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    segments: Tuple[Segment, ...] = ()
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    qk_norm: bool = False
    sliding_window: int = 0
    attn_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    parallel_block: bool = False
    gated_ffn: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_bias: bool = False
    is_encoder_decoder: bool = False
    dtype: str = "bfloat16"         # activation dtype
    param_dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        out = []
        for seg in self.segments:
            out.extend(list(seg.pattern) * seg.repeats)
        return tuple(out)

    def validate(self) -> "ModelConfig":
        kinds = self.layer_kinds()
        assert len(kinds) == self.num_layers, (
            f"{self.name}: segments give {len(kinds)} layers, want {self.num_layers}")
        if any(k.ffn == MOE for k in kinds):
            assert self.moe is not None
        if any(k.mixer == MAMBA for k in kinds):
            assert self.ssm is not None
        assert self.num_heads % self.num_kv_heads == 0
        return self


def small_test_config(name: str = "tiny", *, family: str = "dense",
                      num_layers: int = 2, d_model: int = 64, num_heads: int = 4,
                      num_kv_heads: int = 2, d_ff: int = 128, vocab_size: int = 256,
                      moe: Optional[MoEConfig] = None,
                      ssm: Optional[SSMConfig] = None, **kw) -> ModelConfig:
    """Reduced config helper used by tests (float32, as the reference's):
    ``family="ssm"`` stacks Mamba mixers without an FFN."""
    ffn_kind = MOE if moe is not None else (NONE if family == "ssm" else DENSE)
    mixer = MAMBA if family == "ssm" else ATTN
    seg = Segment((LayerKind(mixer, ffn_kind),), num_layers)
    return ModelConfig(
        name=name, family=family, num_layers=num_layers, d_model=d_model,
        num_heads=num_heads, num_kv_heads=num_kv_heads, d_ff=d_ff,
        vocab_size=vocab_size, segments=(seg,), moe=moe, ssm=ssm,
        dtype="float32", param_dtype="float32", **kw).validate()
