"""Dense gated FFN (SwiGLU)."""
from __future__ import annotations

import torch

from repro_torch.models.layers import linear
from repro_torch.sharding.rules import logical_constraint


def ffn_apply(params, x):
    """silu(x Wg) in float32, cast to x's dtype, times x Wu, then Wo — the
    reference's XLA rounding points — under its sharding constraints (the
    down projection's output lands batch-sharded, not replicated)."""
    g = linear(x, params["wi_gate"])
    u = linear(x, params["wi_up"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    h = logical_constraint(h, ("act_batch", "act_seq", "act_mlp"))
    y = linear(h, params["wo"])
    if y.dim() == 3:
        y = logical_constraint(y, ("act_batch", "act_seq", "act_embed"))
    return y
