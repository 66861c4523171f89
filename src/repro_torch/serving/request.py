"""Inference request lifecycle (port of ``repro/serving/request.py``, without
deadlines, priorities and preemption state, which this slice does not
serve)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"     # scheduled for the next mixed stage
    DECODE = "decode"
    DONE = "done"           # completed generation (eos / length)


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival_time: float = 0.0
    eos_id: Optional[int] = None
    state: RequestState = RequestState.QUEUED
    slot: int = -1
    output: List[int] = field(default_factory=list)
    # chunked prefill (scheduler-owned): positions [0, prefill_pos) are
    # processed and their KV written; prefill_target is frozen at admission
    prefill_pos: int = 0
    prefill_target: Optional[int] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    @property
    def l_in(self) -> int:
        return len(self.prompt)

    def token_stream(self, upto: Optional[int] = None) -> List[int]:
        """Prompt followed by generated tokens (what prefill covers)."""
        toks = list(self.prompt) + list(self.output)
        return toks if upto is None else toks[:upto]

    @property
    def prefill_total(self) -> int:
        if self.prefill_target is not None:
            return self.prefill_target
        return len(self.prompt) + len(self.output)

    @property
    def prefill_done(self) -> bool:
        return (self.prefill_target is not None
                and self.prefill_pos >= self.prefill_target)

    @property
    def done(self) -> bool:
        """Completed generation (end-of-sequence id or max_new_tokens)."""
        return self.state == RequestState.DONE

    def record_token(self, token: int, now: float) -> None:
        self.output.append(token)
        self.token_times.append(now)
        if self.first_token_time is None:
            self.first_token_time = now
        if ((self.eos_id is not None and token == self.eos_id)
                or len(self.output) >= self.max_new_tokens):
            self.state = RequestState.DONE
            self.finish_time = now

    def t2ft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def tbts(self) -> List[float]:
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]
