"""Flash attention for the training path (CUDA, ``csrc/flash_fwd_sm90.cu``,
``csrc/flash_bwd_sm90.cu`` and ``csrc/flash_attn.cu``) and its plain
PyTorch versions, in the model
layout: q (B, S, H, hd), k, v (B, S, KV, hd), heads ``g*qpk .. g*qpk + qpk
- 1`` sharing KV head g.

* ``flash_attention_kernel`` -> (out (B, S, H, hd), lse (B, H, S) float32
  [, out_f32]) — causal / windowed / softcapped GQA attention with online
  softmax. Port of ``repro/kernels/flash_attn.py::flash_attention_kernel``
  (the forward of ``repro/models/attention.py::_flash_core``); it also
  writes the row log-sum-exp ``m + log(l)`` (0 where l == 0), which the
  backward needs and the Pallas kernel does not emit, and, when asked, the
  float32 output before its cast, from which the backward takes D. Two
  kernels, one a dtype: bfloat16 runs the tensor-core (wgmma) kernel of
  ``flash_fwd_sm90.cu``, float32 the scalar kernel of ``flash_attn.cu``.
* ``flash_attention_bwd_kernel`` -> (dq, dk, dv) in the inputs' dtype —
  ``_flash_core_bwd``: the scores recomputed from (q, k, v, lse), three
  launches (D = rowsum(dO * O) from the float32 output, dK/dV, dQ), no
  float atomics. Two routes, one a dtype, as the forward's: bfloat16 runs
  the tensor-core (wgmma) kernels of ``flash_bwd_sm90.cu``, which round P
  and dS to bf16 as the operands of the dV, dK and dQ products, float32
  the scalar kernels of ``flash_attn.cu``.

The plain versions are the reference's blockwise loops over a static
(q block, kv block) schedule: ``flash_attention_plain`` is ``_flash_core``'s
forward (p not gated by the mask, as there), ``flash_attention_bwd_plain``
a line-for-line port of ``_flash_core_bwd``, which takes D from the float32
output ``out_b`` as the reference does. The block sizes are the plain
versions' own; the kernels tile by themselves.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

NEG_INF = -1e30


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


def _schedule(S, q_block, kv_block, causal, window):
    """The reference's block sizes (clamped to S rounded up to 8) and pairs."""
    q_block = min(q_block, S + (-S) % 8)
    kv_block = min(kv_block, S + (-S) % 8)
    nq, nkv = -(-S // q_block), -(-S // kv_block)
    window_blocks = (window + q_block - 1) // kv_block + 1 if window > 0 else 0
    return q_block, kv_block, nq, nkv, _block_pairs(nq, nkv, causal=causal,
                                                    window_blocks=window_blocks)


def _q_blocks(x, KV, q_block):
    """(B, S, H, ...) -> (B, KV, qpk, nq, q_block, ...), S padded."""
    B, S, H = x.shape[:3]
    pad = (-S) % q_block
    x = F.pad(x, (0, 0) * (x.dim() - 3) + (0, 0, 0, pad))
    x = x.reshape(B, (S + pad) // q_block, q_block, KV, H // KV, *x.shape[3:])
    return x.permute(0, 3, 4, 1, 2, *range(5, x.dim()))


def _kv_blocks(x, kv_block):
    """(B, S, KV, hd) -> (B, KV, nkv, kv_block, hd), S padded."""
    B, S, KV, hd = x.shape
    pad = (-S) % kv_block
    x = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(B, (S + pad) // kv_block, kv_block, KV, hd)
    return x.permute(0, 3, 1, 2, 4)


def _unblock_q(x, S):
    """(B, KV, qpk, nq, q_block, hd) -> (B, S, H, hd)."""
    B, KV, qpk, nq, qb, hd = x.shape
    return x.permute(0, 3, 4, 1, 2, 5).reshape(B, nq * qb, KV * qpk, hd)[:, :S]


def _unblock_kv(x, S):
    """(B, KV, nkv, kv_block, hd) -> (B, S, KV, hd)."""
    B, KV, nkv, kb, hd = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(B, nkv * kb, KV, hd)[:, :S]


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, q_block: int = 512, kv_block: int = 512,
                          f32_out: bool = False):
    """q (B, S, H, hd); k, v (B, S, KV, hd) -> (out (B, S, H, hd) in q's
    dtype, lse (B, H, S) float32), and with ``f32_out`` also the float32
    output ``acc / max(l, 1e-37)`` before the cast (the reference's
    ``out_b``, from which the backward takes D). Online softmax over the static
    triangular / banded block schedule, the forward of the reference's
    ``_flash_core``: float32 scores and accumulators, p rounded to v's dtype
    before PV, p not gated by the mask (a row masked out of a whole block
    is reset by the next block's max)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    q_block, kv_block, nq, nkv, pairs = _schedule(S, q_block, kv_block, causal, window)
    qb, kb, vb = _q_blocks(q, KV, q_block), _kv_blocks(k, kv_block), _kv_blocks(v, kv_block)
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
    out32 = _unblock_q(acc / torch.clamp(l[..., None], min=1e-37), S).contiguous()
    out = out32.to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-37)), torch.zeros_like(l))
    lse = lse.reshape(B, H, nq * q_block)[:, :, :S].contiguous()
    return (out, lse, out32) if f32_out else (out, lse)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0, q_block: int = 512,
                              kv_block: int = 512):
    """The reference's ``_flash_core_bwd``: per (q block, kv block) pair,
    recompute the scores, p = exp(s - lse), and accumulate dq, dk, dv in
    float32. out (B, S, H, hd) is the forward's float32 output (D =
    rowsum(dout * out) is taken from it, as the reference takes it from
    ``out_b``), lse (B, H, S) float32, dout like q.
    -> (dq, dk, dv) in dout's dtype."""
    if out.dtype != torch.float32:
        raise TypeError(f"the flash backward takes D from the forward's float32 output, "
                        f"got out in {out.dtype}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    q_block, kv_block, nq, nkv, pairs = _schedule(S, q_block, kv_block, causal, window)
    qb, kb, vb = _q_blocks(q, KV, q_block), _kv_blocks(k, kv_block), _kv_blocks(v, kv_block)
    dout_b = _q_blocks(dout.float(), KV, q_block)          # (B, KV, qpk, nq, qb, hd)
    out_b = _q_blocks(out, KV, q_block)
    lse_b = _q_blocks(F.pad(lse, (0, nq * q_block - S)).transpose(1, 2).reshape(
        B, nq * q_block, H), KV, q_block)                   # (B, KV, qpk, nq, qb)
    D = torch.sum(dout_b * out_b, dim=-1)
    dq = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kb.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vb.shape, dtype=torch.float32, device=q.device)
    for qi, ki in pairs:
        qt, kt, vt = qb[:, :, :, qi].float(), kb[:, :, ki].float(), vb[:, :, ki].float()
        do, lse_i, D_i = dout_b[:, :, :, qi], lse_b[:, :, :, qi], D[:, :, :, qi]
        s_raw = torch.einsum("bgpqh,bgkh->bgpqk", qt, kt) * scale
        if softcap > 0.0:
            t = torch.tanh(s_raw / softcap)
            s = softcap * t
        else:
            s = s_raw
        mask = _pair_mask(qi, ki, q_block, kv_block, S, causal, window, q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse_i[..., None])
        dv_blk = torch.einsum("bgpqk,bgpqh->bgkh", p, do)
        dp = torch.einsum("bgpqh,bgkh->bgpqk", do, vt)
        ds = p * (dp - D_i[..., None])
        if softcap > 0.0:
            ds = ds * (1.0 - t * t)
        ds = torch.where(mask, ds, torch.zeros_like(ds))
        dq[:, :, :, qi] += torch.einsum("bgpqk,bgkh->bgpqh", ds, kt) * scale
        dk[:, :, ki] += torch.einsum("bgpqk,bgpqh->bgkh", ds, qt) * scale
        dv[:, :, ki] += dv_blk
    dtype = dout.dtype
    return (_unblock_q(dq, S).to(dtype), _unblock_kv(dk, S).to(dtype),
            _unblock_kv(dv, S).to(dtype))


def _dtype_code(t):
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention kernels take float32/bfloat16, got {t.dtype}")
    return build.DTYPE_CODES[str(t.dtype).split(".")[1]]


def _check_aligned(**tensors):
    """The bf16 kernels read q, k, v (and the backward dout) by TMA, whose
    base address and strides must be multiples of 16 bytes: every row must
    start on a 16-byte boundary."""
    for name, t in tensors.items():
        step = 16 // t.element_size()
        if t.data_ptr() % 16 or t.stride(0) % step or t.stride(1) % step:
            raise ValueError(f"the bf16 flash kernels need {name}'s rows 16-byte aligned "
                             f"(data pointer and batch / sequence strides), got strides "
                             f"{t.stride()}")


# flash_bwd_sm90.cu pads the rows of D and lse to a multiple of this many
# positions (its PAD), so that a tile of either is one aligned bulk copy
BWD_PAD = 64


def _check(q, k, v):
    """Shapes, strides and the card; returns the kernels' integer arguments
    (B, S, H, KV, hd, qsb, qss, ksb, kss)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernels run on CUDA tensors, got {q.device}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device or tuple(t.shape) != (B, S, KV, hd):
            raise ValueError(f"k, v must be {q.dtype} (B, S, KV, hd) = {(B, S, KV, hd)} on "
                             f"q's device, got {t.dtype} {tuple(t.shape)}")
    if H % KV or H // KV > 64:
        raise ValueError(f"the kernels take H a multiple of KV with H / KV <= 64, got "
                         f"{H} over {KV}")
    if hd not in (64, 128):
        raise ValueError(f"the kernels take head_dim 64 or 128, got {hd}")
    if q.stride()[2:] != (hd, 1) or k.stride() != v.stride() or k.stride()[2:] != (hd, 1):
        raise ValueError(f"q, k, v need their (heads, hd) contiguous and k, v equal "
                         f"strides, got {q.stride()}, {k.stride()}, {v.stride()}")
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1))
    if max(strides) >= 2 ** 31 or B * S * H * hd >= 2 ** 31:
        raise ValueError("tensor too large for the kernels' int32 strides")
    return (B, S, H, KV, hd) + strides


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           softcap: float = 0.0, q_block: int = 512, kv_block: int = 512,
                           f32_out: bool = False):
    """Layout and outputs as ``flash_attention_plain``. For CUDA tensors it
    runs one of two kernels, chosen by dtype (their own tiles;
    ``q_block``/``kv_block`` are the plain version's): bfloat16 the
    tensor-core kernel (``flash_fwd_sm90.cu``: wgmma products, TMA loads,
    persistent blocks), which writes the float32 output in its epilogue
    when ``f32_out`` asks; float32 the scalar kernel
    (``flash_attn.cu``), whose output is already float32 and is returned
    for both. CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_block=q_block, kv_block=kv_block,
                                     f32_out=f32_out)
    code = _dtype_code(q)
    ints = _check(q, k, v)
    B, S, H = ints[:3]
    out = torch.empty((B, S, H, q.shape[3]), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    tail = (*ints, int(causal), int(window), float(softcap), 1.0 / math.sqrt(q.shape[3]),
            torch.cuda.current_stream(q.device).cuda_stream)
    if q.dtype == torch.bfloat16:
        _check_aligned(q=q, k=k, v=v)
        out32 = torch.empty(out.shape, dtype=torch.float32, device=q.device) if f32_out else None
        fn = build.bind("flash_fwd_sm90.cu", "flash_attention_fwd_sm90", 6, 11, 2)
        err = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if out32 is None else out32.data_ptr(), lse.data_ptr(), *tail)
        build.check(err, "flash_attention_fwd_sm90")
    else:
        out32 = out
        fn = build.bind("flash_attn.cu", "flash_attention_fwd", 5, 11, 2)
        err = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), *tail)
        build.check(err, "flash_attention_fwd")
    build.launch_counts["flash_attention"] += 1
    return (out, lse, out32) if f32_out else (out, lse)


def flash_attention_bwd_kernel(q, k, v, out, lse, dout, *, causal: bool = True,
                               window: int = 0, softcap: float = 0.0, q_block: int = 512,
                               kv_block: int = 512):
    """Arguments as ``flash_attention_bwd_plain`` -> (dq, dk, dv). For
    CUDA tensors (out contiguous float32, dout contiguous in q's dtype) it
    runs three launches of one of two routes, chosen by dtype: bfloat16 the
    tensor-core kernels (``flash_bwd_sm90.cu``: wgmma products, TMA loads),
    float32 the scalar ones (``flash_attn.cu``). CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                                         window=window, softcap=softcap, q_block=q_block,
                                         kv_block=kv_block)
    code = _dtype_code(q)
    ints = _check(q, k, v)
    B, S, H = ints[:3]
    for name, t, dtype in (("out", out, torch.float32), ("dout", dout, q.dtype)):
        if t.dtype != dtype or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {tuple(q.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 (B, H, S) = {(B, H, S)}")
    dq = torch.empty_like(dout)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if q.dtype == torch.bfloat16:
        _check_aligned(q=q, k=k, v=v, dout=dout, out=out)
        s_pad = -(-S // BWD_PAD) * BWD_PAD
        scratch = torch.empty(2 * B * H * s_pad, dtype=torch.float32, device=q.device)
        name = "flash_attention_bwd_sm90"
        fn = build.bind("flash_bwd_sm90.cu", name, 10, 11, 2)
    else:
        scratch = torch.empty_like(lse)            # D
        name = "flash_attention_bwd"
        fn = build.bind("flash_attn.cu", name, 10, 11, 2)
    err = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *ints, int(causal), int(window), float(softcap), 1.0 / math.sqrt(q.shape[3]),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    build.launch_counts["flash_attention_bwd"] += 1
    return dq, dk, dv
