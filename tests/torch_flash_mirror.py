"""A bf16 mirror of the flash backward kernel's rounding, for the tests.

``flash_bwd_sm90.cu`` rounds P and dS to bf16 as the operands of the dV,
dK and dQ products (wgmma takes bf16 operands); the reference's
``_flash_core_bwd`` and the port's ``flash_attention_bwd_plain`` keep them
in float32. ``flash_bwd_rounded`` is the plain backward with that rounding,
so a test can hold it against the reference on the CPU
(``tests/test_torch_train_parts.py``) and against kernel 9b on the card
(``tests/test_torch_cuda.py``). Not a ``test_`` file: nothing is collected
here."""
import math

import torch

from repro_torch.kernels.flash_attn import (NEG_INF, _kv_blocks, _pair_mask, _q_blocks,
                                            _schedule, _unblock_kv, _unblock_q)


def flash_bwd_rounded(q, k, v, out, lse, dout, *, causal=True, window=0, softcap=0.0,
                      q_block=512, kv_block=512):
    """``flash_attention_bwd_plain`` with P and dS (before the scale)
    rounded to bf16 where the kernel rounds them: P as dV's operand, dS as
    dQ's and dK's. Same arguments; -> (dq, dk, dv) in dout's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    q_block, kv_block, nq, _, pairs = _schedule(S, q_block, kv_block, causal, window)
    qb, kb, vb = _q_blocks(q, KV, q_block), _kv_blocks(k, kv_block), _kv_blocks(v, kv_block)
    dout_b = _q_blocks(dout.float(), KV, q_block)
    out_b = _q_blocks(out, KV, q_block)
    lse_b = _q_blocks(torch.nn.functional.pad(lse, (0, nq * q_block - S)).transpose(1, 2)
                      .reshape(B, nq * q_block, H), KV, q_block)
    D = torch.sum(dout_b * out_b, dim=-1)
    dq = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kb.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vb.shape, dtype=torch.float32, device=q.device)
    bf = lambda x: x.to(torch.bfloat16).float()
    for qi, ki in pairs:
        qt, kt, vt = qb[:, :, :, qi].float(), kb[:, :, ki].float(), vb[:, :, ki].float()
        do, lse_i, D_i = dout_b[:, :, :, qi], lse_b[:, :, :, qi], D[:, :, :, qi]
        s = torch.einsum("bgpqh,bgkh->bgpqk", qt, kt) * scale
        if softcap > 0.0:
            t = torch.tanh(s / softcap)
            s = softcap * t
        mask = _pair_mask(qi, ki, q_block, kv_block, S, causal, window, q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse_i[..., None])
        dp = torch.einsum("bgpqh,bgkh->bgpqk", do, vt)
        ds = p * (dp - D_i[..., None])
        if softcap > 0.0:
            ds = ds * (1.0 - t * t)
        ds = bf(torch.where(mask, ds, torch.zeros_like(ds)))
        dv[:, :, ki] += torch.einsum("bgpqk,bgpqh->bgkh", bf(p), do)
        dq[:, :, :, qi] += torch.einsum("bgpqk,bgkh->bgpqh", ds, kt) * scale
        dk[:, :, ki] += torch.einsum("bgpqk,bgpqh->bgkh", ds, qt) * scale
    return (_unblock_q(dq, S).to(dout.dtype), _unblock_kv(dk, S).to(dout.dtype),
            _unblock_kv(dv, S).to(dout.dtype))
