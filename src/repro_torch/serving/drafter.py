"""Self-speculative drafting by n-gram prompt lookup (port of
``repro/serving/drafter.py``).

No second model: natural-language and code streams repeat themselves, so the
continuation that followed the most recent earlier occurrence of the
stream's tail n-gram is a good guess for what follows it now. Drafting is
host-side list matching over ``Request.token_stream()``; the engine sends
each proposal through the mixed stage as a verify span (a chunk row of
``len(draft) + 1`` positions) and commits the longest prefix the verifier's
argmax agrees with. Greedy only: acceptance compares argmaxes, which
reproduces the unspeculated greedy stream exactly.
"""
from __future__ import annotations

from typing import List, Sequence


class NgramDrafter:
    """Propose up to ``k`` tokens by matching the stream's tail n-gram,
    longest first (``n = ngram .. 1``), at its most recent earlier
    occurrence. Returns ``[]`` when nothing matches."""

    def __init__(self, k: int = 4, ngram: int = 3):
        assert k >= 1 and ngram >= 1, (k, ngram)
        self.k = k
        self.ngram = ngram

    def draft(self, tokens: Sequence[int]) -> List[int]:
        """``tokens`` is the whole processed stream including the latest
        sampled, not yet verified token; the proposal predicts what follows
        ``tokens[-1]``. A match at distance ``p`` behind the tail models the
        stream as locally period-``p``: positions past the stream's end read
        the proposal's own earlier entries, so a stream stuck on one token
        still drafts the full ``k``."""
        toks = list(tokens)
        length = len(toks)
        if length < 2:
            return []
        for n in range(min(self.ngram, length - 1), 0, -1):
            tail = toks[length - n:]
            # the match may not be the tail itself, but its continuation may
            # run into the tail: those are known tokens too
            for start in range(length - n - 1, -1, -1):
                if toks[start:start + n] == tail:
                    out: List[int] = []
                    for j in range(self.k):
                        idx = start + n + j
                        out.append(toks[idx] if idx < length else out[idx - length])
                    return out
        return []
