"""Decoder blocks and the segment loops: decode steps on the paged and
dense KV layouts, unified mixed stages (paged), and whole-prompt prefill.

Port of ``repro/models/blocks.py`` for full self-attention and Mamba-2
mixers with a dense, MoE or no FFN. A segment's parameters and cache carry
a stacked ``layers`` axis; where the reference ``jax.lax.scan``s over it,
the port loops over it in Python and hands each block the layer's slices
(views, so cache writes land in the stacked leaves). Cache leaves are laid
out (layers, batch or pages, ...), as the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (ATTN, DENSE, MAMBA, MOE, NONE, LayerKind,
                                      ModelConfig)
from repro_torch.core.execution import ExecutionPlan, moe_execute
from repro_torch.models.attention import (POS_EMPTY, AttnCall, attention_decode_step,
                                          attention_forward,
                                          paged_attention_chunk_step,
                                          paged_attention_decode_step,
                                          write_prefill_cache)
from repro_torch.models.ffn import ffn_apply
from repro_torch.models.layers import rmsnorm
from repro_torch.models.ssm import mamba_decode_step, mamba_forward, mamba_init_cache


def _check_kind(kind: LayerKind) -> None:
    if kind.mixer not in (ATTN, MAMBA) or kind.ffn not in (DENSE, MOE, NONE):
        raise NotImplementedError(
            f"the port serves full self-attention and Mamba-2 blocks, got {kind}; "
            f"windowed (queue 1 item 2), cross-attention (item 6) and "
            f"bidirectional mixers come in later slices (ROADMAP queue 1)")


def block_init_cache(cfg: ModelConfig, kind: LayerKind, batch: int = 0,
                     max_len: int = 0, *, dtype, device, layers: int = 1,
                     kv_quant: bool = False, page_size: int = 0,
                     num_pages: int = 0) -> dict:
    """The decode cache of ``layers`` stacked copies of this block.

    Dense: an attention block holds "k"/"v" (layers, batch, max_len, KV, hd),
    "pos" (layers, batch, max_len) int32 (the empty marker until written)
    and "len" (layers, batch) int32; a Mamba block holds {"mamba": {"conv",
    "ssm"}} (``ssm.mamba_init_cache``). Paged (``page_size`` > 0, attention
    blocks only): the page pools (layers, num_pages, KV, page, hd); page 0 is the null page.
    With ``kv_quant`` the value pools are int8 and float32 per-(token, KV
    head) scale pools (layers, num_pages, KV, page) ride beside them."""
    _check_kind(kind)
    if page_size == 0:
        if kind.mixer == MAMBA:
            return {"mamba": mamba_init_cache(cfg, batch, dtype, device, layers)}
        if kv_quant:
            raise NotImplementedError("int8 dense caches are not ported yet; they "
                                      "come with the int8 dense-cache slice "
                                      "(ROADMAP queue 1, item 3)")
        shape = (layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.full(shape[:3], POS_EMPTY, dtype=torch.int32,
                                  device=device),
                "len": torch.zeros(shape[:2], dtype=torch.int32, device=device)}
    if kind.mixer != ATTN:
        raise ValueError(f"paged KV cache supports full self-attention decoder "
                         f"layers only, got mixer={kind.mixer}")
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
    """The block's FFN; an MoE layer adds its routed counts into ``counts``
    unless that is None (prefill collects none)."""
    if kind.ffn != MOE:
        return ffn_apply(params["ffn"], h)
    out, router = moe_execute(params["ffn"], cfg, h, plan, token_valid=valid)
    if counts is not None:
        counts += router.counts.float()
    return out


def block_decode_step(params, cfg: ModelConfig, kind: LayerKind, x, cache,
                      attn_ctx, plan: ExecutionPlan, counts):
    """Single-token decode. x (B,1,d). The mixer follows the cache: Mamba
    state, page pools ("k_pages") or a dense cache. Adds the layer's
    per-expert routed counts into ``counts`` ((E,) float32). Returns x."""
    _check_kind(kind)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    valid = attn_ctx.get("valid") if attn_ctx else None
    if kind.mixer == MAMBA:
        mixer_out, _ = mamba_decode_step(params["mixer"], cfg, h, cache["mamba"],
                                         use_kernels=plan.use_kernels)
    elif "k_pages" in cache:
        mixer_out, _ = paged_attention_decode_step(params["mixer"], cfg, h, cache,
                                                   attn_ctx, use_kernels=plan.use_kernels)
    else:
        mixer_out, _ = attention_decode_step(params["mixer"], cfg, h, cache,
                                             use_kernels=plan.use_kernels)
    if cfg.parallel_block and kind.ffn != NONE:
        return x + mixer_out + _ffn(params, cfg, kind, h, plan, valid, counts)
    x = x + mixer_out
    if kind.ffn == NONE:
        return x
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + _ffn(params, cfg, kind, h, plan, valid, counts)


def block_prefill(params, cfg: ModelConfig, kind: LayerKind, x, positions,
                  true_len, cache, plan: ExecutionPlan):
    """Whole-prompt prefill that also fills the block's dense decode cache
    (in place). x (B,S,d); true_len (B,) valid prompt lengths. A Mamba
    mixer's cache takes the state after the last position of x, padding
    included (``ssm.mamba_forward``); the MoE routes every position,
    padding included, as the reference's prefill does. Returns x."""
    _check_kind(kind)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if kind.mixer == MAMBA:
        mixer_out, mcache = mamba_forward(params["mixer"], cfg, h, return_state=True)
        cache["mamba"]["conv"].copy_(mcache["conv"])
        cache["mamba"]["ssm"].copy_(mcache["ssm"])
    else:
        mixer_out, (k, v) = attention_forward(params["mixer"], cfg, h, positions,
                                              AttnCall(causal=True), return_kv=True)
        write_prefill_cache(cache, k, v, true_len)
    if cfg.parallel_block and kind.ffn != NONE:
        return x + mixer_out + _ffn(params, cfg, kind, h, plan, None, None)
    x = x + mixer_out
    if kind.ffn == NONE:
        return x
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + _ffn(params, cfg, kind, h, plan, None, None)


def block_mixed_step(params, cfg: ModelConfig, kind: LayerKind, xd, xc, cache,
                     attn_ctx, chunk_ctx, plan: ExecutionPlan, counts):
    """One block of a unified mixed stage: decode rows xd (Bd,1,d) write and
    attend first, then chunk rows xc (Bc,Sc,d) write their span and attend;
    norms and the FFN/MoE run over the concatenated token stream, so the
    duplex MoE covers both halves. Full self-attention mixers with an FFN
    on the paged layout only. Returns (xd, xc)."""
    _check_kind(kind)
    if kind.mixer != ATTN or kind.ffn == NONE or "k_pages" not in cache:
        raise NotImplementedError(
            f"unified mixed stages are ported for paged full self-attention "
            f"blocks with an FFN, got {kind}")
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


def segment_init_cache(cfg: ModelConfig, seg, batch: int = 0, max_len: int = 0, *,
                       dtype, device, kv_quant: bool = False, page_size: int = 0,
                       num_pages: int = 0) -> dict:
    return {"blocks": tuple(
        block_init_cache(cfg, kind, batch, max_len, dtype=dtype, device=device,
                         layers=seg.repeats, kv_quant=kv_quant,
                         page_size=page_size, num_pages=num_pages)
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


def segment_prefill(params, cfg: ModelConfig, seg, x, positions, true_len, cache,
                    plan: ExecutionPlan):
    for i in range(seg.repeats):
        for j, kind in enumerate(seg.pattern):
            x = block_prefill(_layer(params["blocks"][j], i), cfg, kind, x, positions,
                              true_len, _layer(cache["blocks"][j], i), plan)
    return x
