"""Token sampling: the greedy branch of ``repro/serving/sampling.py``."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0
    top_p: float = 1.0


def sample(logits, params: SamplingParams = SamplingParams()):
    """logits (B, 1, V) -> (B,) int32 next tokens. Greedy: argmax over
    float32 logits; ``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does, so ties break the same way."""
    if params.temperature > 0.0:
        raise NotImplementedError("sampling at temperature > 0 is not ported yet")
    return torch.argmax(logits[:, -1, :].float(), dim=-1).to(torch.int32)
