"""Model assembly for serving: embeddings -> segments -> final norm -> LM head.

Port of the serving entry points of ``repro/models/model.py`` on the paged
KV layout: ``init_cache`` (paged), ``decode_step`` and ``mixed_step``.
The cache is a list (one entry per segment) of ``{"blocks": ({"k_pages",
"v_pages"}, ...)}`` with stacked (layers, P, KV, page, hd) pools (int8 pools
add "k_scale_pages"/"v_scale_pages" (layers, P, KV, page)), updated in
place; the functions still return it so call sites read like the
reference's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.execution import DEFAULT_PLAN, ExecutionPlan
from repro_torch.models.blocks import (segment_decode_step, segment_init_cache,
                                       segment_mixed_step)
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


def init_cache(cfg: ModelConfig, *, page_size: int, num_pages: int,
               device="cuda", kv_quant: bool = False) -> list:
    """The paged KV cache (the only layout the port serves): each attention
    layer holds a (num_pages, KV, page_size, hd) pool share in the model's
    dtype, or with ``kv_quant`` in int8 plus float32 (num_pages, KV,
    page_size) scale pools; capacity is owned by the KVManager."""
    dtype = DTYPES[cfg.dtype]
    return [segment_init_cache(cfg, seg, page_size=page_size,
                               num_pages=num_pages, dtype=dtype, device=device,
                               kv_quant=kv_quant)
            for seg in cfg.segments]


def _counts(cfg, device):
    return (torch.zeros((cfg.moe.num_experts,), dtype=torch.float32, device=device)
            if cfg.moe else None)


def decode_step(params, cfg: ModelConfig, tokens, cache, attn_ctx, *,
                plan: ExecutionPlan = DEFAULT_PLAN):
    """tokens (B,1) -> logits (B,1,V). ``attn_ctx`` = {"lengths" (B,),
    "block_tables" (B,maxp), optional "valid" (B,)} maps the stage's rows
    onto the page pool. Returns (logits, cache, counts) where counts are the
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
