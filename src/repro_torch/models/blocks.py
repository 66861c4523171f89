"""Decoder blocks on the paged KV layout, and the segment loops.

Port of the paged subset of ``repro/models/blocks.py``. A segment's
parameters and cache carry a stacked ``layers`` axis; where the reference
``jax.lax.scan``s over it, the port loops over it in Python and hands each
block the layer's slices (views, so cache writes land in the stacked pools).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, MOE, NONE, LayerKind, ModelConfig
from repro_torch.core.execution import ExecutionPlan, moe_execute
from repro_torch.models.attention import (paged_attention_chunk_step,
                                          paged_attention_decode_step)
from repro_torch.models.ffn import ffn_apply
from repro_torch.models.layers import rmsnorm


def _check_kind(kind: LayerKind) -> None:
    if kind.mixer != ATTN or kind.ffn == NONE:
        raise NotImplementedError(
            f"the port serves full self-attention blocks with an FFN, got {kind}")


def block_init_cache(cfg: ModelConfig, kind: LayerKind, *, page_size: int,
                     num_pages: int, dtype, device, layers: int = 1,
                     kv_quant: bool = False) -> dict:
    """The page pools of ``layers`` stacked copies of this block:
    (layers, num_pages, KV, page, hd) each; page 0 is the null page. With
    ``kv_quant`` the value pools are int8 and float32 per-(token, KV head)
    scale pools (layers, num_pages, KV, page) ride beside them."""
    _check_kind(kind)
    shape = (layers, num_pages, cfg.num_kv_heads, page_size,
             cfg.resolved_head_dim)
    if not kv_quant:
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    return {"k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale_pages": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale_pages": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _ffn(params, cfg, kind, h, plan, valid, counts):
    if kind.ffn != MOE:
        return ffn_apply(params["ffn"], h)
    out, router = moe_execute(params["ffn"], cfg, h, plan, token_valid=valid)
    counts += router.counts.float()
    return out


def block_decode_step(params, cfg: ModelConfig, kind: LayerKind, x, cache,
                      attn_ctx, plan: ExecutionPlan, counts):
    """Single-token decode. x (B,1,d). Adds the layer's per-expert routed
    counts into ``counts`` ((E,) float32). Returns x."""
    _check_kind(kind)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    mixer_out, _ = paged_attention_decode_step(params["mixer"], cfg, h, cache,
                                               attn_ctx, use_kernels=plan.use_kernels)
    if cfg.parallel_block:
        return x + mixer_out + _ffn(params, cfg, kind, h, plan,
                                    attn_ctx.get("valid"), counts)
    x = x + mixer_out
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + _ffn(params, cfg, kind, h, plan, attn_ctx.get("valid"), counts)


def block_mixed_step(params, cfg: ModelConfig, kind: LayerKind, xd, xc, cache,
                     attn_ctx, chunk_ctx, plan: ExecutionPlan, counts):
    """One block of a unified mixed stage: decode rows xd (Bd,1,d) write and
    attend first, then chunk rows xc (Bc,Sc,d) write their span and attend;
    norms and the FFN/MoE run over the concatenated token stream, so the
    duplex MoE covers both halves. Returns (xd, xc)."""
    _check_kind(kind)
    Bd = xd.shape[0]
    Bc, Sc, d = xc.shape
    h_d = rmsnorm(params["norm1"], xd, cfg.norm_eps)
    h_c = rmsnorm(params["norm1"], xc, cfg.norm_eps)
    mixer_d, _ = paged_attention_decode_step(params["mixer"], cfg, h_d, cache,
                                             attn_ctx, use_kernels=plan.use_kernels)
    mixer_c, _ = paged_attention_chunk_step(params["mixer"], cfg, h_c, cache,
                                            chunk_ctx, use_kernels=plan.use_kernels)
    if cfg.parallel_block:
        ffn_in_d, ffn_in_c = h_d, h_c
        base_d, base_c = xd + mixer_d, xc + mixer_c
    else:
        xd = xd + mixer_d
        xc = xc + mixer_c
        ffn_in_d = rmsnorm(params["norm2"], xd, cfg.norm_eps)
        ffn_in_c = rmsnorm(params["norm2"], xc, cfg.norm_eps)
        base_d, base_c = xd, xc
    flat = torch.cat([ffn_in_d.reshape(Bd, d), ffn_in_c.reshape(Bc * Sc, d)])
    dec_valid = attn_ctx.get("valid")
    if dec_valid is None:
        dec_valid = torch.ones((Bd,), dtype=torch.bool, device=xd.device)
    chunk_valid = (torch.arange(Sc, device=xc.device)[None]
                   < chunk_ctx["chunk_lens"].long()[:, None])
    valid = torch.cat([dec_valid, chunk_valid.reshape(-1)])
    y = _ffn(params, cfg, kind, flat, plan, valid, counts)
    return base_d + y[:Bd].reshape(Bd, 1, d), base_c + y[Bd:].reshape(Bc, Sc, d)


def segment_init_cache(cfg: ModelConfig, seg, *, page_size: int, num_pages: int,
                       dtype, device, kv_quant: bool = False) -> dict:
    return {"blocks": tuple(
        block_init_cache(cfg, kind, page_size=page_size, num_pages=num_pages,
                         dtype=dtype, device=device, layers=seg.repeats,
                         kv_quant=kv_quant)
        for kind in seg.pattern)}


def segment_decode_step(params, cfg: ModelConfig, seg, x, cache, attn_ctx,
                        plan: ExecutionPlan, counts):
    for i in range(seg.repeats):
        for j, kind in enumerate(seg.pattern):
            x = block_decode_step(_layer(params["blocks"][j], i), cfg, kind, x,
                                  _layer(cache["blocks"][j], i), attn_ctx, plan,
                                  counts)
    return x


def segment_mixed_step(params, cfg: ModelConfig, seg, xd, xc, cache, attn_ctx,
                       chunk_ctx, plan: ExecutionPlan, counts):
    for i in range(seg.repeats):
        for j, kind in enumerate(seg.pattern):
            xd, xc = block_mixed_step(_layer(params["blocks"][j], i), cfg, kind,
                                      xd, xc, _layer(cache["blocks"][j], i),
                                      attn_ctx, chunk_ctx, plan, counts)
    return xd, xc
