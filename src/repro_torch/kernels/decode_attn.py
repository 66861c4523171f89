"""Paged attention kernels (CUDA, ``csrc/decode_attn.cu``) and their plain
PyTorch versions, in the kernel layouts.

* ``paged_decode_attention_kernel`` — GQA decode: one query token per
  sequence, ``qpk`` query heads per KV head, online softmax over the pages
  ``block_tables[b]`` names up to ``lengths[b]``; optional sliding window and
  tanh softcap. Port of ``repro/kernels/decode_attn.py::
  paged_decode_attention_kernel`` (fp body).
* ``chunked_prefill_attention_kernel`` — chunk queries (heads innermost, row
  r = position ``start + r // qpk``) against the paged prefix plus the chunk
  just written; mask ``kpos <= qpos and kpos < total``. Port of
  ``chunked_prefill_attention_kernel`` (fp body).

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30


def _gather_pages(pages, block_tables):
    """(P, KV, page, hd) pool -> (B, KV, maxp*page, hd) per-sequence view."""
    B, maxp = block_tables.shape
    _, KV, page, hd = pages.shape
    g = pages[block_tables.long()]                  # (B, maxp, KV, page, hd)
    return g.permute(0, 2, 1, 3, 4).reshape(B, KV, maxp * page, hd)


def _attend(q, k, v, valid, softcap):
    """Masked attention in the kernels' arithmetic: float32 scores, p
    normalised after PV and rounded to the pool dtype before it, rows with
    nothing valid come back 0. q (..., R, hd); k, v (..., S, hd); valid
    broadcastable to (..., R, S)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-37)).to(q.dtype)


def paged_decode_attention_plain(q, k_pages, v_pages, lengths, block_tables, *,
                                 window: int = 0, softcap: float = 0.0):
    """q (B, KV, qpk, hd); pools (P, KV, page, hd); lengths (B,);
    block_tables (B, maxp). -> (B, KV, qpk, hd)."""
    k = _gather_pages(k_pages, block_tables)
    v = _gather_pages(v_pages, block_tables)
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    lens = lengths.long()[:, None]
    valid = kpos < lens
    if window > 0:
        valid = valid & (kpos > lens - 1 - window)
    return _attend(q, k, v, valid[:, None, None, :], softcap)


def chunked_prefill_attention_plain(q, k_pages, v_pages, totals, starts,
                                    block_tables, *, qpk: int,
                                    softcap: float = 0.0):
    """q (B, KV, R, hd), R = Sc*qpk with heads innermost; pools
    (P, KV, page, hd); totals, starts (B,); block_tables (B, maxp).
    -> (B, KV, R, hd)."""
    k = _gather_pages(k_pages, block_tables)
    v = _gather_pages(v_pages, block_tables)
    R = q.shape[2]
    qpos = starts.long()[:, None] + torch.arange(R, device=q.device)[None] // qpk
    kpos = torch.arange(k.shape[2], device=q.device)
    valid = ((kpos[None, None, :] <= qpos[:, :, None])
             & (kpos[None, None, :] < totals.long()[:, None, None]))
    return _attend(q, k, v, valid[:, None], softcap)


def _check_pools(q, k_pages, v_pages, block_tables, *ints):
    if q.device.type != "cuda":
        raise ValueError(f"paged attention kernels run on CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged attention kernels take float32/bfloat16, got {q.dtype}")
    for t in (k_pages, v_pages):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError("page pools must be contiguous, on q's device, in q's dtype")
    if k_pages.shape != v_pages.shape or k_pages.shape[1] != q.shape[1] \
            or k_pages.shape[3] != q.shape[3]:
        raise ValueError(f"pool shape {tuple(k_pages.shape)} does not match q "
                         f"{tuple(q.shape)}")
    for t in (block_tables, *ints):
        if t.dtype != torch.int32 or t.device != q.device or not t.is_contiguous():
            raise ValueError("lengths/block tables must be contiguous int32 on q's device")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")


def paged_decode_attention_kernel(q, k_pages, v_pages, lengths, block_tables, *,
                                  window: int = 0, softcap: float = 0.0):
    """Kernel layout as ``paged_decode_attention_plain``; runs the CUDA
    kernel for CUDA tensors and the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, lengths,
                                            block_tables, window=window,
                                            softcap=softcap)
    _check_pools(q, k_pages, v_pages, block_tables, lengths)
    B, KV, qpk, hd = q.shape
    page = k_pages.shape[2]
    if hd > 256:
        raise ValueError(f"head_dim {hd} > 256 is not supported by the kernel")
    if (2 * qpk * hd + qpk * page + 3 * qpk) * 4 > 227 * 1024:
        raise ValueError("qpk/head_dim/page too large for one block's shared memory")
    out = torch.empty_like(q)
    fn = build.bind("decode_attn.cu", "paged_decode_attention", 6, 7, 2)
    err = fn(build.DTYPE_CODES[str(q.dtype).split(".")[1]], q.data_ptr(),
             k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
             block_tables.data_ptr(), out.data_ptr(), B, KV, qpk, hd, page,
             block_tables.shape[1], int(window), float(softcap),
             1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    build.launch_counts["paged_decode_attention"] += 1
    return out


def chunked_prefill_attention_kernel(q, k_pages, v_pages, totals, starts,
                                     block_tables, *, qpk: int,
                                     softcap: float = 0.0):
    """Kernel layout as ``chunked_prefill_attention_plain``; runs the CUDA
    kernel for CUDA tensors and the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return chunked_prefill_attention_plain(q, k_pages, v_pages, totals,
                                               starts, block_tables, qpk=qpk,
                                               softcap=softcap)
    _check_pools(q, k_pages, v_pages, block_tables, totals, starts)
    B, KV, R, hd = q.shape
    page = k_pages.shape[2]
    if R % qpk:
        raise ValueError(f"rows {R} not a multiple of qpk {qpk}")
    smem = (2 * 16 * hd + 16 * page + 48) * 4 + 2 * page * hd * q.element_size()
    if smem > 227 * 1024:
        raise ValueError("page/head_dim too large for one block's shared memory")
    out = torch.empty_like(q)
    fn = build.bind("decode_attn.cu", "chunked_prefill_attention", 7, 7, 2)
    err = fn(build.DTYPE_CODES[str(q.dtype).split(".")[1]], q.data_ptr(),
             k_pages.data_ptr(), v_pages.data_ptr(), totals.data_ptr(),
             starts.data_ptr(), block_tables.data_ptr(), out.data_ptr(), B, KV,
             R, qpk, hd, page, block_tables.shape[1], float(softcap),
             1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "chunked_prefill_attention")
    build.launch_counts["chunked_prefill_attention"] += 1
    return out
