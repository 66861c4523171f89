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
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
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
    x (B,1,D); cache {"k_pages", "v_pages"} (P,KV,page,hd); attn_ctx
    {"lengths" (B,), "block_tables" (B,maxp)}. Returns (y, cache)."""
    B = x.shape[0]
    lengths = attn_ctx["lengths"].long()
    bt = attn_ctx["block_tables"]
    q, k, v = _project_qkv(params, cfg, x, lengths[:, None])
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    page = k_pages.shape[2]
    wpos = torch.clamp(lengths, max=bt.shape[1] * page - 1)
    page_ids = bt.long()[torch.arange(B, device=x.device), wpos // page]
    offs = wpos % page
    k_pages[page_ids, :, offs] = k[:, 0].to(k_pages.dtype)
    v_pages[page_ids, :, offs] = v[:, 0].to(v_pages.dtype)
    new_len = lengths + 1
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
    k_pages[page_ids, :, offs] = k.to(k_pages.dtype)
    v_pages[page_ids, :, offs] = v.to(v_pages.dtype)
    total = starts + clens
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
