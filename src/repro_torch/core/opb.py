"""Per-layer, per-stage arithmetic intensity (Op/B) of a continuous-batching
stage: FLOPs, off-chip bytes and Op/B of every layer component.

Own copy of ``repro/core/opb.py``: the same stage composition, the same
cost of each component and the same order of every sum, so each float
equals the reference's. Byte counts assume 2-byte (bf16) weights and
activations and count the off-chip traffic of the operands (weights plus
streamed activations), the paper's roofline methodology. In short:

  * GQA decode attention: Op/B ~ the query heads per KV head;
  * MoE decode: Op/B ~ 2 x (tokens per selected expert), moving with the
    batch and with prefill arrivals;
  * the FC/QKV/proj GEMMs: Op/B ~ the stage's tokens.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import (ATTN_CROSS, ATTN_LOCAL, DENSE, MAMBA, MOE,
                                      LayerKind, ModelConfig)

BYTES = 2  # bf16 / fp16


# ---------------------------------------------------------------------------
# Stage composition
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StageMix:
    """One continuous-batching stage.

    ``decode_ctx``  — context length (KV entries attended) per decode sequence.
    ``prefill_len`` — prompt length per whole-prompt prefill sequence.
    ``chunk_spans`` — (start, end) per chunked-prefill sequence: queries
                      [start, end) over the written [0, start) prefix plus the
                      chunk itself.
    ``spec_spans``  — (start, end) per speculative verify sequence: a decode
                      row carrying its last token and its draft, attending as
                      a chunk span does, with every position's logits sampled.
    Empty prefill_len, chunk_spans and spec_spans => decoding-only stage.
    """
    decode_ctx: Tuple[int, ...] = ()
    prefill_len: Tuple[int, ...] = ()
    chunk_spans: Tuple[Tuple[int, int], ...] = ()
    spec_spans: Tuple[Tuple[int, int], ...] = ()

    @property
    def is_mixed(self) -> bool:
        return (len(self.prefill_len) > 0 or len(self.chunk_spans) > 0
                or len(self.spec_spans) > 0)

    @property
    def num_tokens(self) -> int:
        """Tokens passing through the FC/MoE layers this stage."""
        return (len(self.decode_ctx) + sum(self.prefill_len)
                + sum(e - s for s, e in self.chunk_spans)
                + sum(e - s for s, e in self.spec_spans))

    @property
    def batch_size(self) -> int:
        return (len(self.decode_ctx) + len(self.prefill_len)
                + len(self.chunk_spans) + len(self.spec_spans))


def decoding_only(batch: int, ctx: int) -> StageMix:
    return StageMix(decode_ctx=(ctx,) * batch)


def mixed(batch_decode: int, ctx: int, new_requests: int, l_in: int) -> StageMix:
    return StageMix(decode_ctx=(ctx,) * batch_decode,
                    prefill_len=(l_in,) * new_requests)


# ---------------------------------------------------------------------------
# Per-component cost records
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OpCost:
    """FLOPs + off-chip bytes of one layer component in one stage."""
    name: str
    flops: float
    weight_bytes: float
    act_bytes: float

    @property
    def bytes(self) -> float:
        return self.weight_bytes + self.act_bytes

    @property
    def opb(self) -> float:
        return self.flops / max(self.bytes, 1.0)

    def merged(self, other: "OpCost", name: Optional[str] = None) -> "OpCost":
        return OpCost(name or self.name, self.flops + other.flops,
                      self.weight_bytes + other.weight_bytes,
                      self.act_bytes + other.act_bytes)


def _gemm(name: str, tokens: int, d_in: int, d_out: int) -> OpCost:
    """Batched tokens x weight GEMM: weights read once (batching effect)."""
    flops = 2.0 * tokens * d_in * d_out
    w = BYTES * d_in * d_out
    a = BYTES * tokens * (d_in + d_out)
    return OpCost(name, flops, w, a)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _kv_elem_bytes(hd: int, kv_quant: bool) -> float:
    """K-or-V bytes one cached token occupies per KV head: int8 caches
    stream 1-byte values plus a float32 per-(token, KV head) scale."""
    return hd + 4.0 if kv_quant else float(BYTES * hd)


def attention_decode_cost(cfg: ModelConfig, ctx: int, *, window: int = 0,
                          kv_quant: bool = False) -> OpCost:
    """One decode sequence: one query token against ``ctx`` cached entries.
    KV bytes dominate, so Op/B ~ 2 x the query heads per KV head, doubled by
    int8 KV."""
    eff_ctx = min(ctx, window) if window > 0 else ctx
    hd = cfg.resolved_head_dim
    kv, qpk = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    flops = 2.0 * kv * qpk * eff_ctx * hd * 2          # QK^T and PV
    kv_bytes = 2 * kv * eff_ctx * _kv_elem_bytes(hd, kv_quant)  # K + V read
    act = BYTES * kv * qpk * hd * 2                    # q in, out
    return OpCost("attn_decode", flops, 0.0, kv_bytes + act)


def _window_pairs(n: int, window: int) -> int:
    """sum_{i<n} min(i + 1, window) in closed form: the score pairs of n
    causal queries under a sliding window (the reference sums them one
    query at a time)."""
    if n <= window:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def attention_prefill_cost(cfg: ModelConfig, s: int, *, window: int = 0,
                           causal: bool = True,
                           kv_quant: bool = False) -> OpCost:
    """One prefill sequence of length s (triangular or banded score work)."""
    hd = cfg.resolved_head_dim
    h = cfg.num_heads
    if window > 0:
        pairs = _window_pairs(s, window)
    elif causal:
        pairs = s * (s + 1) // 2
    else:
        pairs = s * s
    flops = 2.0 * h * pairs * hd * 2
    kv_bytes = 2 * cfg.num_kv_heads * s * _kv_elem_bytes(hd, kv_quant)
    act = BYTES * h * s * hd * 2
    return OpCost("attn_prefill", flops, 0.0, kv_bytes + act)


def attention_chunk_cost(cfg: ModelConfig, start: int, end: int, *,
                         window: int = 0, kv_quant: bool = False) -> OpCost:
    """One chunked-prefill sequence: queries [start, end) against the written
    [0, start) prefix plus the chunk's own causal K/V (only the in-window
    prefix under a sliding window). Op/B moves from prefill's (start 0) to
    decode's (end = start + 1)."""
    hd = cfg.resolved_head_dim
    h = cfg.num_heads
    if window > 0:
        pairs = _window_pairs(end, window) - _window_pairs(start, window)
        kv_read = min(end, window + (end - start))
    else:
        # sum_{q=start}^{end-1} (q+1) causal pairs
        pairs = (end * (end + 1) - start * (start + 1)) // 2
        kv_read = end
    flops = 2.0 * h * pairs * hd * 2
    kv_bytes = 2 * cfg.num_kv_heads * kv_read * _kv_elem_bytes(hd, kv_quant)
    act = BYTES * h * (end - start) * hd * 2
    return OpCost("attn_chunk", flops, 0.0, kv_bytes + act)


def qkv_proj_cost(cfg: ModelConfig, tokens: int) -> OpCost:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    qkv = _gemm("qkv", tokens, d, (cfg.num_heads + 2 * cfg.num_kv_heads) * hd)
    proj = _gemm("proj", tokens, cfg.num_heads * hd, d)
    return qkv.merged(proj, "qkv+proj")


# ---------------------------------------------------------------------------
# FFN / MoE
# ---------------------------------------------------------------------------

def ffn_cost(cfg: ModelConfig, tokens: int, d_ff: Optional[int] = None) -> OpCost:
    f = d_ff if d_ff is not None else cfg.d_ff
    d = cfg.d_model
    mats = 3 if cfg.gated_ffn else 2
    flops = 2.0 * tokens * d * f * mats
    w = BYTES * mats * d * f
    a = BYTES * tokens * (2 * d + mats * f)
    return OpCost("ffn", flops, w, a)


def expert_cost(cfg: ModelConfig, tokens: int) -> OpCost:
    """One expert FFN over ``tokens`` tokens; Op/B ~ 2 x tokens / 3 while
    the weights dominate."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    mats = 3 if cfg.gated_ffn else 2
    flops = 2.0 * tokens * d * f * mats
    w = BYTES * mats * d * f
    a = BYTES * tokens * (2 * d + mats * f)
    return OpCost("expert", flops, w, a)


def expected_tokens_per_expert(cfg: ModelConfig, tokens: int) -> float:
    """Uniform-routing expectation."""
    m = cfg.moe
    return tokens * m.top_k / m.num_experts


def moe_cost(cfg: ModelConfig, tokens: int,
             counts: Optional[Sequence[int]] = None) -> OpCost:
    """Whole MoE layer; ``counts`` = per-expert token counts (default
    uniform). The weights of every selected expert are read once."""
    m = cfg.moe
    if counts is None:
        t_e = expected_tokens_per_expert(cfg, tokens)
        counts = [t_e] * m.num_experts
    total = OpCost("moe", 0.0, 0.0, 0.0)
    for c in counts:
        if c <= 0:
            continue
        total = total.merged(expert_cost(cfg, c), "moe")
    total = total.merged(_gemm("router", tokens, cfg.d_model, m.num_experts), "moe")
    if m.num_shared_experts:
        total = total.merged(ffn_cost(cfg, tokens, m.d_ff_shared), "moe")
    return total


# ---------------------------------------------------------------------------
# Mamba (SSD)
# ---------------------------------------------------------------------------

def mamba_decode_cost(cfg: ModelConfig, batch: int) -> OpCost:
    """Single-token SSD state update per sequence: read and write the
    (H, N, P) state. Op/B ~ 2."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    nheads = s.nheads(d)
    state = nheads * s.d_state * s.headdim
    flops = batch * (2.0 * 3 * state + 2 * d * (2 * d_in + 2 * s.d_state + nheads)
                     + 2 * d_in * d)
    proj_w = BYTES * (d * (2 * d_in + 2 * s.ngroups * s.d_state + nheads)
                      + d_in * d)
    state_bytes = BYTES * 2 * batch * 2 * state      # fp32 read + write
    return OpCost("mamba_decode", flops, proj_w, state_bytes)


def mamba_prefill_cost(cfg: ModelConfig, tokens: int) -> OpCost:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    nheads = s.nheads(d)
    proj = _gemm("ssm_proj", tokens, d,
                 2 * d_in + 2 * s.ngroups * s.d_state + nheads)
    out = _gemm("ssm_out", tokens, d_in, d)
    # chunked SSD: intra-chunk (Q x Q per head) + state propagation
    q = s.chunk_size
    nchunks = max(tokens // q, 1)
    intra = 2.0 * nchunks * nheads * q * q * s.headdim * 2
    inter = 2.0 * tokens * nheads * s.d_state * s.headdim * 2
    ssd = OpCost("ssd", intra + inter, 0.0, BYTES * tokens * d_in * 3)
    return proj.merged(out, "mamba_prefill").merged(ssd, "mamba_prefill")


# ---------------------------------------------------------------------------
# Whole-stage analysis
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerStageCost:
    """Costs of one layer kind in one stage, split by component."""
    kind: LayerKind
    components: Tuple[OpCost, ...]

    def total(self) -> OpCost:
        t = OpCost("total", 0.0, 0.0, 0.0)
        for c in self.components:
            t = t.merged(c, "total")
        return t


def layer_stage_cost(cfg: ModelConfig, kind: LayerKind, mix: StageMix,
                     counts: Optional[Sequence[int]] = None, *,
                     kv_quant: bool = False) -> LayerStageCost:
    comps: List[OpCost] = []
    T = mix.num_tokens
    window = cfg.sliding_window if kind.mixer == ATTN_LOCAL else 0
    if kind.mixer == MAMBA:
        if mix.decode_ctx:
            comps.append(mamba_decode_cost(cfg, len(mix.decode_ctx)))
        pre_tokens = (sum(mix.prefill_len)
                      + sum(e - s for s, e in mix.chunk_spans)
                      + sum(e - s for s, e in mix.spec_spans))
        if pre_tokens:
            comps.append(mamba_prefill_cost(cfg, pre_tokens))
    else:
        comps.append(qkv_proj_cost(cfg, T))
        dec = OpCost("attn_decode", 0.0, 0.0, 0.0)
        for ctx in mix.decode_ctx:
            dec = dec.merged(attention_decode_cost(cfg, ctx, window=window,
                                                   kv_quant=kv_quant), "attn_decode")
        if mix.decode_ctx:
            comps.append(dec)
        pre = OpCost("attn_prefill", 0.0, 0.0, 0.0)
        for s in mix.prefill_len:
            pre = pre.merged(attention_prefill_cost(cfg, s, window=window,
                                                    kv_quant=kv_quant), "attn_prefill")
        if mix.prefill_len:
            comps.append(pre)
        # verify spans cost exactly as chunk spans do
        chk = OpCost("attn_chunk", 0.0, 0.0, 0.0)
        for s0, s1 in (*mix.chunk_spans, *mix.spec_spans):
            chk = chk.merged(attention_chunk_cost(cfg, s0, s1, window=window,
                                                  kv_quant=kv_quant), "attn_chunk")
        if mix.chunk_spans or mix.spec_spans:
            comps.append(chk)
        if kind.mixer == ATTN_CROSS:
            # decoder cross-attention reads encoder KV: decode ~ attn_decode
            comps.append(dataclasses.replace(dec, name="cross_attn"))
    if kind.ffn == DENSE:
        comps.append(ffn_cost(cfg, T))
    elif kind.ffn == MOE:
        comps.append(moe_cost(cfg, T, counts))
    return LayerStageCost(kind, tuple(comps))


def stage_cost_breakdown(cfg: ModelConfig, mix: StageMix,
                         counts: Optional[Sequence[int]] = None, *,
                         kv_quant: bool = False) -> Dict[str, OpCost]:
    """Component costs summed over every layer of the model."""
    agg: Dict[str, OpCost] = {}
    for kind in cfg.layer_kinds():
        lc = layer_stage_cost(cfg, kind, mix, counts, kv_quant=kv_quant)
        for c in lc.components:
            key = c.name
            agg[key] = agg[key].merged(c) if key in agg else c
    # LM head: a token per decode and prefill sequence, every position of a
    # verify span
    out_tokens = (len(mix.decode_ctx) + len(mix.prefill_len)
                  + sum(e - s for s, e in mix.spec_spans))
    agg["lm_head"] = _gemm("lm_head", out_tokens, cfg.d_model, cfg.vocab_size)
    return agg
