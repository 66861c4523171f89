"""Stage composition (the scheduler's ``StageMix``).

Own copy of ``repro/core/opb.py::StageMix``; the per-layer Op/B cost model
of that module is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class StageMix:
    """One continuous-batching stage: context length per decode sequence,
    (start, end) per chunked-prefill span and (start, end) per speculative
    verify span (a decode row carrying its last token and its draft)."""
    decode_ctx: Tuple[int, ...] = ()
    chunk_spans: Tuple[Tuple[int, int], ...] = ()
    spec_spans: Tuple[Tuple[int, int], ...] = ()

    @property
    def is_mixed(self) -> bool:
        return len(self.chunk_spans) > 0 or len(self.spec_spans) > 0

    @property
    def num_tokens(self) -> int:
        """Tokens passing through the FFN/MoE layers this stage."""
        return (len(self.decode_ctx) + sum(e - s for s, e in self.chunk_spans)
                + sum(e - s for s, e in self.spec_spans))
