"""Attention: the paged KV layout (decode rows and prefill-chunk rows), the
dense KV layout (decode rows, prefill cache writes) and the prefill
attention over whole prompts.

Port of ``repro/models/attention.py`` without ring (sliding-window) caches,
cross-attention, int8 dense caches, segment ids and the backward pass. The
prefill attention (``attention_forward``: ``full_attention``, or
``blockwise_attention`` — the forward of the reference's ``_flash_core``)
is plain PyTorch, the counterpart of the reference's XLA path. Dense
caches ({"k", "v"} (B, Smax, KV, hd), "pos" (B, Smax), "len" (B,)) are
updated in place like the page pools. The page pools
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
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quant import int8_quantize
from repro_torch.models.layers import apply_rope, rmsnorm

NEG_INF = -1e30
POS_EMPTY = 2 ** 31 - 1     # "pos" of a dense-cache slot never written


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
                     softcap: float = 0.0, kv_positions=None):
    """Plain decode path. q (B,1,H,hd); caches (B,Smax,KV,hd); cache_len (B,)
    valid entries including the current token; ``kv_positions`` (B,Smax)
    the absolute position each slot holds (a dense cache's "pos" leaf),
    default the slot index. -> (B,1,H,hd)."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bgph,bkgh->bgpk", qg.float(), k_cache.float()) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    pos = (torch.arange(Smax, device=q.device)[None] if kv_positions is None
           else kv_positions.long())
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


# ---------------------------------------------------------------------------
# Prefill attention over whole prompts (the reference's XLA path)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttnCall:
    causal: bool = True
    window: int = 0          # > 0 for sliding-window layers
    q_block: int = 512
    kv_block: int = 512


def _block_pairs(n_q: int, n_kv: int, *, causal: bool, window_blocks: int):
    """Static (qi, ki) schedule of the blocks that intersect the mask."""
    pairs = []
    for qi in range(n_q):
        for ki in range(n_kv):
            if causal and ki > qi:
                continue
            if window_blocks > 0 and ki < qi - window_blocks:
                continue
            pairs.append((qi, ki))
    return pairs


def _pair_mask(qi, ki, q_block, kv_block, S, causal, window, device):
    qpos = qi * q_block + torch.arange(q_block, device=device)
    kpos = ki * kv_block + torch.arange(kv_block, device=device)
    mask = torch.ones((q_block, kv_block), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask &= (kpos < S)[None, :] & (qpos < S)[:, None]
    return mask


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        softcap: float = 0.0, q_block: int = 512,
                        kv_block: int = 512):
    """q (B,S,H,hd); k, v (B,S,KV,hd) -> (B,S,H,hd) in q's dtype. Online
    softmax over the static triangular / banded block schedule, the forward
    of the reference's ``_flash_core`` (no segment ids): float32 scores and
    accumulators, p rounded to v's dtype before PV, p not gated by the mask
    (a row masked out of a whole block is reset by the next block's max)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qpk = H // KV
    q_block = min(q_block, S + (-S) % 8)
    kv_block = min(kv_block, S + (-S) % 8)
    scale = 1.0 / math.sqrt(hd)
    pad_q, pad_kv = (-S) % q_block, (-S) % kv_block
    nq, nkv = (S + pad_q) // q_block, (S + pad_kv) // kv_block
    # (B, KV, qpk, nq, q_block, hd) / (B, KV, nkv, kv_block, hd)
    qb = F.pad(q, (0, 0, 0, 0, 0, pad_q)).reshape(B, nq, q_block, KV, qpk, hd)
    qb = qb.permute(0, 3, 4, 1, 2, 5)
    kb = F.pad(k, (0, 0, 0, 0, 0, pad_kv)).reshape(B, nkv, kv_block, KV, hd)
    kb = kb.permute(0, 3, 1, 2, 4)
    vb = F.pad(v, (0, 0, 0, 0, 0, pad_kv)).reshape(B, nkv, kv_block, KV, hd)
    vb = vb.permute(0, 3, 1, 2, 4)
    window_blocks = (window + q_block - 1) // kv_block + 1 if window > 0 else 0
    pairs = _block_pairs(nq, nkv, causal=causal, window_blocks=window_blocks)
    acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
    m = torch.full(qb.shape[:5], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(qb.shape[:5], dtype=torch.float32, device=q.device)
    for qi, ki in pairs:
        qt, kt, vt = qb[:, :, :, qi], kb[:, :, ki], vb[:, :, ki]
        s = torch.einsum("bgpqh,bgkh->bgpqk", qt.float(), kt.float()) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        mask = _pair_mask(qi, ki, q_block, kv_block, S, causal, window, q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_old, l_old = m[:, :, :, qi], l[:, :, :, qi]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        alpha = torch.exp(m_old - m_new)
        p = torch.exp(s - m_new[..., None])
        l[:, :, :, qi] = l_old * alpha + p.sum(dim=-1)
        acc[:, :, :, qi] = acc[:, :, :, qi] * alpha[..., None] + torch.einsum(
            "bgpqk,bgkh->bgpqh", p.to(vt.dtype).float(), vt.float())
        m[:, :, :, qi] = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    out = out.permute(0, 3, 4, 1, 2, 5).reshape(B, nq * q_block, H, hd)[:, :S]
    return out.to(q.dtype)


def full_attention(q, k, v, *, causal: bool, window: int = 0,
                   softcap: float = 0.0):
    """Unblocked prefill attention (materializes the scores). q (B,S,H,hd);
    k, v (B,Skv,KV,hd) -> (B,S,H,hd) in v's dtype."""
    B, S, H, hd = q.shape
    KV, Skv = k.shape[2], k.shape[1]
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqgph,bkgh->bgpqk", qg.float(), k.float()) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgpqk,bkgh->bqgph", p.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def attention_forward(params, cfg: ModelConfig, x, positions, call: AttnCall,
                      return_kv: bool = False):
    """Prefill attention over whole sequences. x (B,S,D); positions (B,S).
    The blockwise path for S > ``call.q_block``, else the unblocked one.
    Returns y (B,S,D), and (k, v) (B,S,KV,hd) with ``return_kv``."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    if S > call.q_block:
        out = blockwise_attention(q, k, v, causal=call.causal, window=call.window,
                                  softcap=cfg.attn_logit_softcap,
                                  q_block=call.q_block, kv_block=call.kv_block)
    else:
        out = full_attention(q, k, v, causal=call.causal, window=call.window,
                             softcap=cfg.attn_logit_softcap)
    y = torch.matmul(out.reshape(B, S, -1), params["wo"]["kernel"])
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# Dense KV layout
# ---------------------------------------------------------------------------

def _dense_only(cache, window: int, what: str) -> None:
    if window > 0 and cache["k"].shape[1] == window + 1:
        raise NotImplementedError(
            f"{what}: ring (sliding-window) caches are not ported yet; they come "
            f"with the ATTN_LOCAL slice (ROADMAP queue 1, item 2)")
    if "k_scale" in cache:
        raise NotImplementedError(
            f"{what}: int8 dense caches are not ported yet; they come with the "
            f"int8 dense-cache slice (ROADMAP queue 1, item 3)")


def write_prefill_cache(cache, k, v, true_len, *, window: int = 0):
    """Write prefill K/V (B,S,KV,hd) into a dense decode cache in place:
    token t at slot t ("pos" gets t for t < true_len, the empty marker
    past it; the padding's K/V is written too and is never read as live),
    "len" = true_len. Returns the cache."""
    _dense_only(cache, window, "write_prefill_cache")
    B, S = k.shape[0], k.shape[1]
    size = cache["k"].shape[1]
    pos = torch.arange(S, device=k.device)[None].expand(B, S)
    valid = pos < true_len.long()[:, None]
    idx = torch.clamp(pos, max=size - 1)
    bidx = torch.arange(B, device=k.device)[:, None]
    cache["pos"][bidx, idx] = torch.where(valid, pos, torch.full_like(pos, POS_EMPTY)
                                          ).to(cache["pos"].dtype)
    cache["k"][bidx, idx] = k.to(cache["k"].dtype)
    cache["v"][bidx, idx] = v.to(cache["v"].dtype)
    cache["len"].copy_(true_len)
    return cache


def attention_decode_step(params, cfg: ModelConfig, x, cache, *, window: int = 0,
                          use_kernels: bool = False):
    """One-token decode against a dense cache (updated in place). x (B,1,D);
    cache {"k", "v"} (B,Smax,KV,hd), "pos" (B,Smax), "len" (B,) — the new
    token's position. K/V are cast to the cache dtype before the write, which
    clamps to slot Smax-1 past the end. With ``use_kernels`` the dense decode
    kernel attends the positions < len + 1; the plain path masks by "pos".
    Returns (y, cache)."""
    _dense_only(cache, window, "attention_decode_step")
    B = x.shape[0]
    positions = cache["len"].long()                      # (B,)
    q, k, v = _project_qkv(params, cfg, x, positions[:, None])
    Smax = cache["k"].shape[1]
    write_idx = torch.clamp(positions, max=Smax - 1)
    bidx = torch.arange(B, device=x.device)
    cache["pos"][bidx, write_idx] = positions.to(cache["pos"].dtype)
    new_len = positions + 1
    cache["k"][bidx, write_idx] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, write_idx] = v[:, 0].to(cache["v"].dtype)
    if use_kernels:
        from repro_torch.kernels.ops import decode_attention as decode_attn_kernel
        out = decode_attn_kernel(q, cache["k"], cache["v"], new_len, window=window,
                                 softcap=cfg.attn_logit_softcap)
    else:
        out = decode_attention(q, cache["k"], cache["v"], new_len, window=window,
                               softcap=cfg.attn_logit_softcap,
                               kv_positions=cache["pos"])
    cache["len"].copy_(new_len)
    y = torch.matmul(out.reshape(B, 1, -1), params["wo"]["kernel"])
    return y, cache
