"""Dense gated FFN (SwiGLU)."""
from __future__ import annotations

import torch


def ffn_apply(params, x):
    """silu(x Wg) in float32, cast to x's dtype, times x Wu, then Wo — the
    reference's XLA rounding points."""
    g = torch.matmul(x, params["wi_gate"])
    u = torch.matmul(x, params["wi_up"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, params["wo"])
