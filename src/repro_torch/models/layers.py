"""Basic layers: RMSNorm, rotary embeddings, embedding lookup."""
from __future__ import annotations

import torch


def rmsnorm(params, x, eps: float = 1e-6):
    """float32 inside, cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                           # (head_dim/2,)


def apply_rope(x, positions, theta: float):
    """Half-split rotary embedding (first half / second half of head_dim,
    not interleaved pairs). x (..., S, n_heads, head_dim); positions
    broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]                     # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def linear(x, w):
    """``torch.matmul(x, w)`` of an activation and a weight; a >= 3-D DTensor
    activation times a 2-D DTensor weight runs shard by shard
    (``sharding/rules.py::sharded_linear``)."""
    if x.dim() >= 3 and w.dim() == 2 and hasattr(x, "device_mesh") \
            and hasattr(w, "device_mesh"):
        from repro_torch.sharding.rules import sharded_linear
        return sharded_linear(x, w)
    return torch.matmul(x, w)


def embed_lookup(params, tokens):
    return params["table"][tokens.long()]
