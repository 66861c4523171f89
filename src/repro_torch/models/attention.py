"""Attention on the paged KV layout: decode rows and prefill-chunk rows.

Port of the paged subset of ``repro/models/attention.py``. The page pools
are updated IN PLACE (advanced-index assignment, i.e. ``index_put_``) —
unlike JAX's functional ``.at[].set()``, which builds a new pool per layer,
the port never copies a pool. Write rules kept from the reference:

* padded decode rows (length 0) and dead chunk positions write into the
  reserved null page 0, which is never read as live;
* a decode write clamps to the last position the block table can hold
  (``bt.shape[1] * page - 1``);
* a chunk's K/V is written before the chunk attends.

int8 page pools (``k_scale_pages`` present in the layer's cache): K/V are
quantized per (token, KV head) before the scatter (``quantize_kv``), all
four pools are updated in place, and attention runs on int8 operands with
the scales folded in — the int8 kernels, or off the kernel path
``decode_attention_int8`` / ``chunk_attention_int8`` over the gathered
view, which requantize p * v_scale once over the whole row as the
reference's XLA path does (the kernels do it per page). No float copy of
the cache is built.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quant import int8_quantize
from repro_torch.models.layers import apply_rope, rmsnorm

NEG_INF = -1e30


def _linear(params, x):
    y = torch.matmul(x, params["kernel"])
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def _project_qkv(params, cfg: ModelConfig, x, positions):
    """x (B,S,D) -> q (B,S,H,hd), k,v (B,S,KV,hd); qk-norm before rope."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _linear(params["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k = _linear(params["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = _linear(params["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def paged_gather_kv(pages, block_tables):
    """Sequence-contiguous view of the block-table pages: pool
    (P, KV, page, hd), tables (B, maxp) -> (B, maxp*page, KV, hd)."""
    B, maxp = block_tables.shape
    _, KV, page, hd = pages.shape
    g = pages[block_tables.long()]                  # (B, maxp, KV, page, hd)
    return g.permute(0, 1, 3, 2, 4).reshape(B, maxp * page, KV, hd)


def paged_gather_scale(scale_pages, block_tables):
    """Scale-pool counterpart of ``paged_gather_kv``: (P, KV, page) float32
    pool -> (B, maxp*page, KV)."""
    B, maxp = block_tables.shape
    _, KV, page = scale_pages.shape
    g = scale_pages[block_tables.long()]            # (B, maxp, KV, page)
    return g.permute(0, 1, 3, 2).reshape(B, maxp * page, KV)


def quantize_kv(x):
    """x (..., hd) -> (int8 values, float32 scale (...)) per (token, head):
    the one recipe of ``kernels/quant.py``."""
    return int8_quantize(x)


def _int_dot(a8, b8):
    """int8 x int8 product with exact integer sums, as float32: the sums are
    taken in float64 (exact far past int32 range), then rounded to float32
    as an int32 -> float32 cast rounds them."""
    return torch.matmul(a8.double(), b8.double()).float()


def decode_attention_int8(q, k_q, k_scale, v_q, v_scale, cache_len, *,
                          window: int = 0, softcap: float = 0.0):
    """Plain int8 decode path. q (B,1,H,hd); k_q/v_q (B,Smax,KV,hd) int8;
    k_scale/v_scale (B,Smax,KV) float32; cache_len (B,). Folded-scale int8
    QK^T; p * v_scale requantized per row over the whole context.
    -> (B,1,H,hd) in q's dtype."""
    B, _, H, hd = q.shape
    Smax, KV = k_q.shape[1], k_q.shape[2]
    scale = 1.0 / math.sqrt(hd)
    q8, q_sc = quantize_kv(q.reshape(B, KV, H // KV, hd))     # (B,KV,qpk,.)
    s = _int_dot(q8, k_q.permute(0, 2, 3, 1))                  # (B,KV,qpk,Smax)
    s = (s * q_sc[..., None] * k_scale.permute(0, 2, 1)[:, :, None, :]) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(Smax, device=q.device)[None]
    lens = cache_len.long()[:, None]
    valid = pos < lens
    if window > 0:
        valid = valid & (pos > lens - 1 - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    pv8, pv_sc = quantize_kv(p * v_scale.permute(0, 2, 1)[:, :, None, :])
    out = _int_dot(pv8, v_q.permute(0, 2, 1, 3)) * pv_sc[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


def chunk_attention_int8(q, k_q, k_scale, v_q, v_scale, q_positions,
                         kv_positions, kv_len, *, softcap: float = 0.0):
    """Plain int8 chunk path, the chunk counterpart of
    ``decode_attention_int8``. q (B,Sc,H,hd); k_q/v_q (B,Skv,KV,hd) int8;
    scales (B,Skv,KV) float32; positions and masking as ``chunk_attention``.
    -> (B,Sc,H,hd) in q's dtype."""
    B, Sc, H, hd = q.shape
    KV = k_q.shape[2]
    qpk = H // KV
    scale = 1.0 / math.sqrt(hd)
    q8, q_sc = quantize_kv(q.reshape(B, Sc, KV, qpk, hd))    # (B,Sc,KV,qpk,.)
    s = _int_dot(q8.permute(0, 2, 3, 1, 4),                   # (B,KV,qpk,Sc,Skv)
                 k_q.permute(0, 2, 3, 1)[:, :, None])
    s = (s * q_sc.permute(0, 2, 3, 1)[..., None]
         * k_scale.permute(0, 2, 1)[:, :, None, None, :]) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    valid = kv_positions[:, None, :] <= q_positions[:, :, None]          # causal
    valid = valid & (kv_positions < kv_len.long()[:, None])[:, None, :]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # fully-masked rows (chunk padding) would softmax to uniform: zero them
    p = torch.where(valid[:, None, None], p, torch.zeros_like(p))
    pv8, pv_sc = quantize_kv(p * v_scale.permute(0, 2, 1)[:, :, None, None, :])
    out = _int_dot(pv8, v_q.permute(0, 2, 1, 3)[:, :, None])  # (B,KV,qpk,Sc,hd)
    out = out * pv_sc[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sc, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     softcap: float = 0.0):
    """Plain decode path. q (B,1,H,hd); caches (B,Smax,KV,hd); cache_len (B,)
    valid entries including the current token. -> (B,1,H,hd)."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bgph,bkgh->bgpk", qg.float(), k_cache.float()) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(Smax, device=q.device)[None]
    lens = cache_len.long()[:, None]
    valid = pos < lens
    if window > 0:
        valid = valid & (pos > lens - 1 - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgpk,bkgh->bgph", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)


def chunk_attention(q, k_ctx, v_ctx, q_positions, kv_positions, kv_len, *,
                    softcap: float = 0.0):
    """Plain chunk path. q (B,Sc,H,hd); contexts (B,Skv,KV,hd); positions of
    queries (B,Sc) and keys (B,Skv); kv_len (B,) including the chunk.
    -> (B,Sc,H,hd)."""
    B, Sc, H, hd = q.shape
    KV = k_ctx.shape[2]
    qg = q.reshape(B, Sc, KV, H // KV, hd)
    s = torch.einsum("bqgph,bkgh->bgpqk", qg.float(), k_ctx.float()) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    valid = kv_positions[:, None, :] <= q_positions[:, :, None]          # causal
    valid = valid & (kv_positions < kv_len.long()[:, None])[:, None, :]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # fully-masked rows (chunk padding) would softmax to uniform: zero them
    p = torch.where(valid[:, None, None], p, torch.zeros_like(p))
    out = torch.einsum("bgpqk,bkgh->bqgph", p.to(v_ctx.dtype), v_ctx)
    return out.reshape(B, Sc, H, hd)


def paged_attention_decode_step(params, cfg: ModelConfig, x, cache, attn_ctx,
                                *, window: int = 0, use_kernels: bool = False):
    """One-token decode against the layer's page pools (updated in place).
    x (B,1,D); cache {"k_pages", "v_pages"} (P,KV,page,hd) (int8 pools add
    "k_scale_pages", "v_scale_pages" (P,KV,page)); attn_ctx {"lengths" (B,),
    "block_tables" (B,maxp)}. Returns (y, cache)."""
    B = x.shape[0]
    lengths = attn_ctx["lengths"].long()
    bt = attn_ctx["block_tables"]
    q, k, v = _project_qkv(params, cfg, x, lengths[:, None])
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    page = k_pages.shape[2]
    wpos = torch.clamp(lengths, max=bt.shape[1] * page - 1)
    page_ids = bt.long()[torch.arange(B, device=x.device), wpos // page]
    offs = wpos % page
    new_len = lengths + 1
    if "k_scale_pages" in cache:                         # int8 page pools
        ks_pages, vs_pages = cache["k_scale_pages"], cache["v_scale_pages"]
        k_pages[page_ids, :, offs], ks_pages[page_ids, :, offs] = quantize_kv(k[:, 0])
        v_pages[page_ids, :, offs], vs_pages[page_ids, :, offs] = quantize_kv(v[:, 0])
        if use_kernels:
            from repro_torch.kernels.ops import paged_decode_attention
            out = paged_decode_attention(q, k_pages, v_pages, new_len, bt,
                                         k_scales=ks_pages, v_scales=vs_pages,
                                         window=window,
                                         softcap=cfg.attn_logit_softcap)
        else:
            out = decode_attention_int8(
                q, paged_gather_kv(k_pages, bt), paged_gather_scale(ks_pages, bt),
                paged_gather_kv(v_pages, bt), paged_gather_scale(vs_pages, bt),
                new_len, window=window, softcap=cfg.attn_logit_softcap)
        y = torch.matmul(out.reshape(B, 1, -1), params["wo"]["kernel"])
        return y, cache
    k_pages[page_ids, :, offs] = k[:, 0].to(k_pages.dtype)
    v_pages[page_ids, :, offs] = v[:, 0].to(v_pages.dtype)
    if use_kernels:
        from repro_torch.kernels.ops import paged_decode_attention
        out = paged_decode_attention(q, k_pages, v_pages, new_len, bt,
                                     window=window,
                                     softcap=cfg.attn_logit_softcap)
    else:
        out = decode_attention(q, paged_gather_kv(k_pages, bt),
                               paged_gather_kv(v_pages, bt), new_len,
                               window=window, softcap=cfg.attn_logit_softcap)
    y = torch.matmul(out.reshape(B, 1, -1), params["wo"]["kernel"])
    return y, cache


def paged_attention_chunk_step(params, cfg: ModelConfig, x, cache, chunk_ctx,
                               *, use_kernels: bool = False):
    """Chunked prefill against the layer's page pools (updated in place).
    x (Bc,Sc,D); chunk_ctx {"starts", "chunk_lens", "block_tables"}. The
    chunk's K/V is written into its pages first (dead positions and padded
    rows into null page 0), then the queries attend prefix + chunk.
    Returns (y, cache)."""
    Bc, Sc, _ = x.shape
    dev = x.device
    starts = chunk_ctx["starts"].long()
    clens = chunk_ctx["chunk_lens"].long()
    bt = chunk_ctx["block_tables"]
    positions = starts[:, None] + torch.arange(Sc, device=dev)[None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    page = k_pages.shape[2]
    maxp = bt.shape[1]
    valid = torch.arange(Sc, device=dev)[None] < clens[:, None]
    col = torch.clamp(positions // page, max=maxp - 1)
    page_ids = torch.where(valid, bt.long()[torch.arange(Bc, device=dev)[:, None], col],
                           torch.zeros_like(col))
    offs = positions % page
    total = starts + clens
    if "k_scale_pages" in cache:                         # int8 page pools
        ks_pages, vs_pages = cache["k_scale_pages"], cache["v_scale_pages"]
        k_pages[page_ids, :, offs], ks_pages[page_ids, :, offs] = quantize_kv(k)
        v_pages[page_ids, :, offs], vs_pages[page_ids, :, offs] = quantize_kv(v)
        if use_kernels:
            from repro_torch.kernels.ops import chunked_prefill_attention
            out = chunked_prefill_attention(q, k_pages, v_pages, total, starts, bt,
                                            k_scales=ks_pages, v_scales=vs_pages,
                                            softcap=cfg.attn_logit_softcap)
        else:
            kv_pos = torch.arange(maxp * page, device=dev)[None].expand(Bc, -1)
            out = chunk_attention_int8(
                q, paged_gather_kv(k_pages, bt), paged_gather_scale(ks_pages, bt),
                paged_gather_kv(v_pages, bt), paged_gather_scale(vs_pages, bt),
                positions, kv_pos, total, softcap=cfg.attn_logit_softcap)
        y = torch.matmul(out.reshape(Bc, Sc, -1), params["wo"]["kernel"])
        return y, cache
    k_pages[page_ids, :, offs] = k.to(k_pages.dtype)
    v_pages[page_ids, :, offs] = v.to(v_pages.dtype)
    if use_kernels:
        from repro_torch.kernels.ops import chunked_prefill_attention
        out = chunked_prefill_attention(q, k_pages, v_pages, total, starts, bt,
                                        softcap=cfg.attn_logit_softcap)
    else:
        kv_pos = torch.arange(maxp * page, device=dev)[None].expand(Bc, -1)
        out = chunk_attention(q, paged_gather_kv(k_pages, bt),
                              paged_gather_kv(v_pages, bt), positions, kv_pos,
                              total, softcap=cfg.attn_logit_softcap)
    y = torch.matmul(out.reshape(Bc, Sc, -1), params["wo"]["kernel"])
    return y, cache
