"""Model configuration dataclasses.

Own copy of ``repro/configs/base.py``'s ``LayerKind`` / ``Segment`` /
``MoEConfig`` / ``SSMConfig`` / ``ModelConfig`` / ``small_test_config`` with
the same field names and defaults, so a configuration reads the same in
both packages. Layer stacking is described by *segments*: each segment is ``repeats``
copies of a pattern, and its parameters carry a leading stacked ``layers``
axis that the port walks with a Python loop.
"""
from __future__ import annotations

import dataclasses
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
    # encoder-decoder (whisper): the encoder's stack of segments
    is_encoder_decoder: bool = False
    enc_segments: Tuple[Segment, ...] = ()
    enc_num_layers: int = 0
    # modality frontend stub: precomputed embeddings of this many positions
    # prepended to the text tokens (vlm)
    frontend_embeds: int = 0
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
        if self.is_encoder_decoder:
            n_enc = sum(seg.num_layers for seg in self.enc_segments)
            assert n_enc == self.enc_num_layers, (
                f"{self.name}: encoder segments give {n_enc} layers, "
                f"want {self.enc_num_layers}")
        assert self.num_heads % self.num_kv_heads == 0
        return self

    # ---- parameter counting (the roofline's MODEL_FLOPS and the dry run) ----
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _ffn_params(cfg: ModelConfig, kind: str, active_only: bool) -> int:
    d = cfg.d_model
    mats = 3 if cfg.gated_ffn else 2
    if kind == DENSE:
        return mats * d * cfg.d_ff
    if kind == MOE:
        m = cfg.moe
        per_expert = mats * d * m.d_ff_expert
        shared = mats * d * m.d_ff_shared if m.num_shared_experts else 0
        router = d * m.num_experts
        n_active = m.top_k if active_only else m.num_experts
        return per_expert * n_active + shared + router
    return 0


def _mixer_params(cfg: ModelConfig, kind: str) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    if kind in (ATTN, ATTN_LOCAL, ATTN_BIDIR):
        q = d * cfg.num_heads * hd
        kv = 2 * d * cfg.num_kv_heads * hd
        o = cfg.num_heads * hd * d
        return q + kv + o
    if kind == ATTN_CROSS:  # self + cross attention
        return 2 * _mixer_params(cfg, ATTN)
    if kind == MAMBA:
        s = cfg.ssm
        d_in = s.d_inner(d)
        nh = s.nheads(d)
        in_proj = d * (2 * d_in + 2 * s.ngroups * s.d_state + nh)
        conv = s.d_conv * (d_in + 2 * s.ngroups * s.d_state)
        out_proj = d_in * d
        extras = 3 * nh  # A_log, D, dt_bias
        return in_proj + conv + out_proj + extras
    raise ValueError(kind)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """The reference's analytic count (``repro/configs/base.py::_param_count``):
    embedding, LM head unless tied, per layer its mixer, FFN (top-k experts
    with ``active_only``) and two norm vectors, the encoder's layers alike,
    and the final norm. Biases and QK-norm scales are not counted, as
    there."""
    total = cfg.vocab_size * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model
    for k in cfg.layer_kinds():
        total += _mixer_params(cfg, k.mixer)
        total += _ffn_params(cfg, k.ffn, active_only)
        total += 2 * cfg.d_model  # norms
    if cfg.is_encoder_decoder:
        for seg in cfg.enc_segments:
            for k in seg.pattern:
                total += (_mixer_params(cfg, k.mixer)
                          + _ffn_params(cfg, k.ffn, active_only)
                          + 2 * cfg.d_model) * seg.repeats
    total += cfg.d_model  # final norm
    return total


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the cell grid: a train, prefill or decode step of
    ``global_batch`` sequences of ``seq_len`` positions (a decode step
    attends a cache of ``seq_len`` positions)."""
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# the architectures a long_500k cell runs: sub-quadratic (Mamba), hybrid or
# mostly windowed attention
LONG_CONTEXT_ARCHS = ("jamba-v0.1-52b", "mamba2-2.7b", "gemma3-4b")


def shape_applicable(arch_name: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_name in LONG_CONTEXT_ARCHS
    return True


@dataclass(frozen=True)
class RunConfig:
    """Training and serving knobs that change what a step computes, with the
    reference's names and defaults: the microbatch size (0: chosen by
    ``launch/steps.py::auto_num_micro``), activation rematerialisation per
    super-block ("full", "dots" or "none"), the MoE layout ("ep", "tp" or
    "auto"), the optimizer's settings, the cross-pod gradient compression
    ("none" or "int8_ef"), sequence-sharded activations, the int8 KV
    cache of decode cells, and the flash core's tiles and bf16 score
    chain. ``scan_layers`` is kept for the reference's field set: the
    port walks layers in a Python loop either way."""
    microbatch_size: int = 0
    remat_policy: str = "full"
    moe_sharding: str = "auto"
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    adam_dtype: str = "float32"
    grad_compression: str = "none"
    seq_shard_activations: bool = False
    scan_layers: bool = True
    kv_quant: bool = False
    attn_q_block: int = 512
    attn_kv_block: int = 512
    attn_score_bf16: bool = False


def reduced_config(cfg: ModelConfig, *, layers: int = 2, d_model: int = 128,
                   d_ff: int = 256, vocab: int = 512) -> ModelConfig:
    """Scale an architecture down to CPU size, keeping its structure (the
    reference's ``launch/train.py::reduced_config``): the encoder's
    segments and ``d_ff_shared`` stay as they are, as there."""
    scale = d_model / cfg.d_model
    heads = max(2, int(cfg.num_heads * scale))
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, d_ff_expert=max(32, int(moe.d_ff_expert * scale)))
    segs = []
    need = layers
    for seg in cfg.segments:
        if need <= 0:
            break
        reps = max(1, min(seg.repeats, need // max(len(seg.pattern), 1) or 1))
        segs.append(Segment(seg.pattern, reps))
        need -= reps * len(seg.pattern)
    total = sum(s.num_layers for s in segs)
    return dataclasses.replace(
        cfg, name=cfg.name + "-reduced", num_layers=total, d_model=d_model,
        num_heads=heads, num_kv_heads=kv, head_dim=max(16, d_model // heads),
        d_ff=d_ff, vocab_size=vocab, segments=tuple(segs), moe=moe,
        dtype="float32", param_dtype="float32").validate()


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
