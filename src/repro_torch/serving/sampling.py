"""Token sampling: greedy, temperature, top-k and top-p (port of
``repro/serving/sampling.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => full distribution
    top_p: float = 1.0           # nucleus sampling threshold


def sample(logits, params: SamplingParams = SamplingParams(),
           generator: Optional[torch.Generator] = None):
    """logits (B, 1, V) -> (B,) int32 next tokens.

    Greedy: argmax over float32 logits; ``torch.argmax`` returns the first
    maximum, as ``jnp.argmax`` does, so ties break the same way.

    At temperature > 0, the reference's steps in its order: divide by the
    temperature, drop the logits under the k-th largest (``top_k``), keep
    the smallest prefix of the sorted distribution whose mass reaches
    ``top_p`` (the argmax always kept), then draw from the softmax of what
    is left. The draw is Gumbel-max, argmax(logits + G) with G = -log(-log
    U) and U uniform from ``generator`` (on the logits' device): it never
    waits for the device, as a multinomial draw's host check would.
    ``jax.random`` cannot be matched bit for bit, so the tokens follow the
    reference's distribution, not its stream."""
    logits = logits[:, -1, :].float()
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / params.temperature
    if params.top_k > 0:
        thresh = torch.topk(logits, params.top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < thresh, float("-inf"))
    if params.top_p < 1.0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < params.top_p      # the prefix, first included
        keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
        logits = logits.masked_fill(~keep, float("-inf"))
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
