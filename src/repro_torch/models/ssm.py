"""Mamba-2 (SSD) mixer: chunked prefill and single-token decode.

Port of ``repro/models/ssm.py`` (ngroups fixed to 1, as there). The
prefill runs the SSD chunked block decomposition: dense (Q x Q) work inside
a chunk and a state carried from chunk to chunk — the reference's
``lax.scan`` over chunks is a Python loop here, one chunk at a time. The
decode step is the single-token recurrence over the (B, H, N, P) float32
state; with ``use_kernels`` it runs the SSD decode kernel, which adds
``D * x`` in float32 before the cast, while the plain branch casts y first
and adds ``D * x`` in the model dtype, as the reference's two branches do.

Decode caches are updated in place (``conv`` and ``ssm`` leaves, views of
the stacked cache).

Kept from the reference as it is: ``mamba_forward(..., return_state=True)``
takes the final SSM state and the conv tail after the LAST position of the
input, padding included. The serving engine pads prompts to a length
bucket, so a padded prompt's decode cache holds the state after its padding
tokens, and the first decode steps differ from an unpadded run
(ROADMAP queue 3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rmsnorm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nheads = s.nheads(cfg.d_model)
    conv_dim = d_in + 2 * s.ngroups * s.d_state
    return s, d_in, nheads, conv_dim


def _split_proj(cfg: ModelConfig, zxbcdt):
    s, d_in, nheads, conv_dim = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + conv_dim]
    dt = zxbcdt[..., d_in + conv_dim:]
    return z, xBC, dt


def _causal_conv(params, xBC):
    """Depthwise causal conv over the sequence. xBC (B, S, conv_dim)."""
    w = params["conv_w"]                                   # (K, conv_dim)
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + pad[:, i:i + S, :] * w[i][None, None, :]
    return out + params["conv_b"][None, None, :]


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """SSD chunked algorithm (ngroups = 1). x (Bt, S, H, P); dt (Bt, S, H)
    after softplus; A (H,) negative; B, C (Bt, S, N). Returns (y (Bt, S, H, P)
    in x's dtype, final state (Bt, H, N, P) float32)."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    xc = x.reshape(Bt, nc, chunk, H, P)
    dtc = dt.reshape(Bt, nc, chunk, H).float()
    Bc = B.reshape(Bt, nc, chunk, N).float()
    Cc = C.reshape(Bt, nc, chunk, N).float()
    cum = torch.cumsum(dtc * A[None, None, None, :], dim=2)   # inclusive log-decay
    ii = torch.arange(chunk, device=x.device)
    tri = (ii[:, None] >= ii[None, :])[None, :, :, None]
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device))
    ys = []
    for c in range(nc):
        x_c, dt_c, cum_c = xc[:, c].float(), dtc[:, c], cum[:, c]
        B_c, C_c = Bc[:, c], Cc[:, c]
        CB = torch.einsum("biN,bjN->bij", C_c, B_c)
        diff = cum_c[:, :, None, :] - cum_c[:, None, :, :]        # (Bt, i, j, H)
        diff = torch.where(tri, diff, torch.full_like(diff, float("-inf")))
        W = CB[..., None] * torch.exp(diff) * dt_c[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", W, x_c)
        # inter-chunk output from the state entering this chunk
        y_int = torch.einsum("bih,biN,bhNp->bihp", torch.exp(cum_c), C_c, state)
        # state update: decay to the chunk's end plus this chunk's share
        dec_end = torch.exp(cum_c[:, -1:, :] - cum_c)             # (Bt, Q, H)
        s_c = torch.einsum("bjh,bjN,bjhp->bhNp", dec_end * dt_c, B_c, x_c)
        state = state * torch.exp(cum_c[:, -1, :])[:, :, None, None] + s_c
        ys.append(y_intra + y_int)
    y = torch.stack(ys, dim=1).reshape(Bt, nc * chunk, H, P)[:, :S]
    return y.to(x.dtype), state


def mamba_forward(params, cfg: ModelConfig, x, *, return_state: bool = False):
    """x (B, S, d_model) -> (B, S, d_model); with ``return_state`` also the
    decode cache {"conv" (B, K-1, conv_dim), "ssm" (B, H, N, P) float32}
    taken after the last position of x (padding included)."""
    s, d_in, nheads, conv_dim = _dims(cfg)
    Bt, S, _ = x.shape
    zxbcdt = torch.matmul(x, params["in_proj"])
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(params, xBC)
    xBC = F.silu(xBC.float()).to(x.dtype)
    xs = xBC[..., :d_in].reshape(Bt, S, nheads, s.headdim)
    Bmat = xBC[..., d_in:d_in + s.d_state]
    Cmat = xBC[..., d_in + s.d_state:]
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    y, final_state = ssd_chunked(xs, dt, A, Bmat, Cmat, s.chunk_size)
    y = y + params["D"][None, None, :, None].to(y.dtype) * xs
    y = y.reshape(Bt, S, d_in)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(y.dtype), cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"])
    if not return_state:
        return out
    # decode cache: the last (d_conv - 1) pre-conv xBC inputs + final state
    zx = torch.matmul(x[:, max(0, S - (s.d_conv - 1)):], params["in_proj"])
    _, tail, _ = _split_proj(cfg, zx)
    if tail.shape[1] < s.d_conv - 1:
        tail = F.pad(tail, (0, 0, s.d_conv - 1 - tail.shape[1], 0))
    return out, {"conv": tail.to(x.dtype), "ssm": final_state.float()}


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype, device, layers: int = 1) -> dict:
    """Zeroed decode caches of ``layers`` stacked Mamba layers:
    conv (layers, batch, K-1, conv_dim) in ``dtype``, ssm (layers, batch, H,
    N, P) float32."""
    s, d_in, nheads, conv_dim = _dims(cfg)
    return {"conv": torch.zeros((layers, batch, s.d_conv - 1, conv_dim), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((layers, batch, nheads, s.d_state, s.headdim),
                               dtype=torch.float32, device=device)}


def mamba_decode_step(params, cfg: ModelConfig, x, cache, *, use_kernels: bool = False):
    """x (B, 1, d_model); cache {"conv", "ssm"} of this layer, updated in
    place. Returns (out (B, 1, d_model), cache)."""
    s, d_in, nheads, conv_dim = _dims(cfg)
    Bt = x.shape[0]
    zxbcdt = torch.matmul(x, params["in_proj"])[:, 0]            # (B, k)
    z, xBC_new, dt = _split_proj(cfg, zxbcdt)
    w = params["conv_w"]                                         # (K, conv_dim)
    buf = torch.cat([cache["conv"], xBC_new[:, None, :]], dim=1)  # (B, K, conv_dim)
    conv_out = torch.einsum("bkc,kc->bc", buf, w) + params["conv_b"][None]
    xBC = F.silu(conv_out.float()).to(x.dtype)
    xh = xBC[..., :d_in].reshape(Bt, nheads, s.headdim)
    Bmat = xBC[..., d_in:d_in + s.d_state].float()               # (B, N)
    Cmat = xBC[..., d_in + s.d_state:].float()
    dt = F.softplus(dt.float() + params["dt_bias"][None, :])
    state = cache["ssm"]                                         # (B, H, N, P)
    if use_kernels:
        from repro_torch.kernels.ops import ssd_decode
        y, state = ssd_decode(state, xh, dt, params["A_log"], Bmat, Cmat, params["D"])
        y = y.to(x.dtype)
    else:
        A = -torch.exp(params["A_log"])                          # (H,)
        a = torch.exp(dt * A[None, :])                           # (B, H)
        upd = torch.einsum("bh,bN,bhp->bhNp", dt, Bmat, xh.float())
        state = state * a[:, :, None, None] + upd
        y = torch.einsum("bN,bhNp->bhp", Cmat, state)            # (B, H, P)
        y = y.to(x.dtype) + params["D"][None, :, None].to(x.dtype) * xh
    y = y.reshape(Bt, d_in)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(y.dtype), cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"])[:, None, :]
    cache["ssm"].copy_(state)          # a no-op when the kernel updated it in place
    cache["conv"].copy_(buf[:, 1:])
    return out, cache
