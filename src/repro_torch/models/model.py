"""Model assembly for serving: embeddings -> segments -> final norm -> LM head.

Port of the serving entry points of ``repro/models/model.py``:
``init_cache`` (dense or paged), ``prefill`` (whole prompts into a dense
cache), ``decode_step`` (either layout) and ``mixed_step`` (paged). The
cache is a list (one entry per segment) of ``{"blocks": (block cache, ...)}``
with stacked leaves: paged (layers, P, KV, page, hd) pools (int8 pools add
"k_scale_pages"/"v_scale_pages" (layers, P, KV, page)); dense attention
"k"/"v" (layers, B, Smax, KV, hd), "pos" (layers, B, Smax), "len" (layers,
B); Mamba {"mamba": {"conv" (layers, B, K-1, conv_dim), "ssm" (layers, B,
H, N, P)}}. Caches are updated in place; the functions still return them so
call sites read like the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.execution import DEFAULT_PLAN, ExecutionPlan
from repro_torch.models.blocks import (segment_decode_step, segment_init_cache,
                                       segment_mixed_step, segment_prefill)
from repro_torch.models.layers import embed_lookup, rmsnorm
from repro_torch.models.params import DTYPES


def _lm_head(params, cfg: ModelConfig, x):
    """float32 logits. The reference casts the table to float32 on every
    call; the serving engine stores one float32 copy at load time under
    ``lm_head_f32`` (412 MB at OLMoE-1B-7B) and it is used when present."""
    table = params.get("lm_head_f32")
    if table is None:
        table = (params["embed"]["table"] if cfg.tie_embeddings
                 else params["lm_head"]["table"]).float()
    return torch.matmul(x.float(), table.t())


def init_cache(cfg: ModelConfig, batch: int = 0, max_len: int = 0, *,
               page_size: int = 0, num_pages: int = 0, device="cuda",
               kv_quant: bool = False) -> list:
    """Decode cache. Dense (no ``page_size``): per-slot (batch, max_len)
    attention leaves and per-slot Mamba state. Paged (``page_size`` > 0):
    each attention layer holds a (num_pages, KV, page_size, hd) pool share in
    the model's dtype, or with ``kv_quant`` in int8 plus float32 (num_pages,
    KV, page_size) scale pools; capacity is owned by the KVManager."""
    dtype = DTYPES[cfg.dtype]
    return [segment_init_cache(cfg, seg, batch, max_len, dtype=dtype, device=device,
                               kv_quant=kv_quant, page_size=page_size,
                               num_pages=num_pages)
            for seg in cfg.segments]


def prefill(params, cfg: ModelConfig, batch, cache, true_len, *,
            plan: ExecutionPlan = DEFAULT_PLAN):
    """Process whole prompts, fill the dense cache (in place) and return the
    logits at each sequence's last valid position. batch {"tokens" (B,S)};
    true_len (B,). Returns (logits (B,1,V), cache)."""
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens).to(DTYPES[cfg.dtype])
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"], cache):
        x = segment_prefill(seg_params, cfg, seg, x, positions, true_len, seg_cache,
                            plan)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    last = torch.clamp(true_len.long() - 1, min=0)
    x_last = x[torch.arange(B, device=x.device), last][:, None, :]
    return _lm_head(params, cfg, x_last), cache


def _counts(cfg, device):
    return (torch.zeros((cfg.moe.num_experts,), dtype=torch.float32, device=device)
            if cfg.moe else None)


def decode_step(params, cfg: ModelConfig, tokens, cache, attn_ctx, *,
                plan: ExecutionPlan = DEFAULT_PLAN):
    """tokens (B,1) -> logits (B,1,V). Paged: ``attn_ctx`` = {"lengths" (B,),
    "block_tables" (B,maxp), optional "valid" (B,)} maps the stage's rows
    onto the page pool. Dense: the rows are the cache's rows and
    ``attn_ctx`` = {"valid" (B,)} marks the live ones (dead rows are kept out
    of MoE routing). Returns (logits, cache, counts) where counts are the
    per-expert routed-token counts summed over MoE layers ((E,) float32)."""
    x = embed_lookup(params["embed"], tokens).to(DTYPES[cfg.dtype])
    counts = _counts(cfg, x.device)
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"], cache):
        x = segment_decode_step(seg_params, cfg, seg, x, seg_cache, attn_ctx,
                                plan, counts)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, cfg, x), cache, counts


def mixed_step(params, cfg: ModelConfig, dec_tokens, chunk_tokens, cache, *,
               attn_ctx, chunk_ctx, plan: ExecutionPlan = DEFAULT_PLAN):
    """One unified mixed stage: decode rows (Bd,1) and prefill-chunk rows
    (Bc,Sc) through the stack as one token stream. ``chunk_ctx`` =
    {"starts", "chunk_lens", "block_tables"}. Returns (dec_logits (Bd,1,V),
    chunk_logits (Bc,1,V) at each chunk's last live position, cache, moe
    counts (E,) float32 or None)."""
    dtype = DTYPES[cfg.dtype]
    xd = embed_lookup(params["embed"], dec_tokens).to(dtype)
    xc = embed_lookup(params["embed"], chunk_tokens).to(dtype)
    counts = _counts(cfg, xd.device)
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"], cache):
        xd, xc = segment_mixed_step(seg_params, cfg, seg, xd, xc, seg_cache,
                                    attn_ctx, chunk_ctx, plan, counts)
    xd = rmsnorm(params["final_norm"], xd, cfg.norm_eps)
    xc = rmsnorm(params["final_norm"], xc, cfg.norm_eps)
    dec_logits = _lm_head(params, cfg, xd)
    Bc = xc.shape[0]
    last = torch.clamp(chunk_ctx["chunk_lens"].long() - 1, min=0)
    xc_last = xc[torch.arange(Bc, device=xc.device), last][:, None, :]
    chunk_logits = _lm_head(params, cfg, xc_last)
    return dec_logits, chunk_logits, cache, counts
