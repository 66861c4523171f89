"""Inference request lifecycle (port of ``repro/serving/request.py``): the
states, the priority, preemption and prefix-sharing state, deadlines and
the first-token SLO, and the reason a request reached its terminal state."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"     # scheduled for the next mixed stage
    DECODE = "decode"
    DONE = "done"           # completed generation (eos / length)
    CANCELLED = "cancelled"  # caller cancel / queue shed / admission reject
    EXPIRED = "expired"      # deadline or TTFT SLO passed


#: states a request never leaves; ``finish_reason`` says why it got there
TERMINAL_STATES = frozenset({RequestState.DONE, RequestState.CANCELLED,
                             RequestState.EXPIRED})


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
    # absolute finish deadline and first-token SLO (seconds after arrival),
    # on the clock of ``arrival_time``; the engine's per-stage expiry sweep
    # moves a request past either to EXPIRED, and preemption prefers a
    # victim already past its deadline
    deadline: Optional[float] = None
    ttft_slo: Optional[float] = None
    # higher is more important: admitted ahead of lower priorities, evicted
    # last; ``queue_seq`` is the scheduler's submit sequence number (the
    # FIFO tiebreak within a band); ``aging_skips`` counts the stages formed
    # while the request sat queued (priority aging promotes on it)
    priority: int = 0
    aging_skips: int = 0
    queue_seq: int = 0
    # why the request is terminal: "stop" (eos), "length", "cancelled",
    # "shed", "rejected" or "expired"; None while live
    finish_reason: Optional[str] = None
    # chunked prefill (scheduler-owned): positions [0, prefill_pos) are
    # processed and their KV written; prefill_target is frozen at admission
    prefill_pos: int = 0
    prefill_target: Optional[int] = None
    # preemption: the slot's cache saved to the host (migrate), and the mark
    # that keeps a preempted queue head from evicting in turn
    saved_cache: Optional[list] = None
    was_preempted: bool = False
    # prefix sharing: page ids matched and pinned while queued, mapped into
    # the slot's block table at admission; ``match_version`` is the index
    # version the last match ran against
    shared_pages: Optional[List[int]] = None
    match_version: int = -1
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
        """Terminal: completed, cancelled or expired (``completed`` tells the
        requests that finished generating)."""
        return self.state in TERMINAL_STATES

    @property
    def completed(self) -> bool:
        return self.state == RequestState.DONE

    def past_deadline(self, now: float) -> bool:
        """True when ``now`` is at or past the deadline of a live request, or
        its TTFT SLO has lapsed without a first token."""
        if self.state in TERMINAL_STATES:
            return False
        if self.deadline is not None and now >= self.deadline:
            return True
        return (self.ttft_slo is not None and self.first_token_time is None
                and now >= self.arrival_time + self.ttft_slo)

    def finish(self, reason: str, now: float) -> None:
        """Abnormal termination: cancel, shed, reject or expire. The engine
        releases the request's slot, pages and pins."""
        self.state = (RequestState.EXPIRED if reason == "expired"
                      else RequestState.CANCELLED)
        self.finish_reason = reason
        self.finish_time = now

    def record_token(self, token: int, now: float) -> None:
        self.output.append(token)
        self.token_times.append(now)
        if self.first_token_time is None:
            self.first_token_time = now
        if self.eos_id is not None and token == self.eos_id:
            self.state = RequestState.DONE
            self.finish_reason = "stop"
            self.finish_time = now
        elif len(self.output) >= self.max_new_tokens:
            self.state = RequestState.DONE
            self.finish_reason = "length"
            self.finish_time = now

    def t2ft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def e2e(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    def tbts(self) -> List[float]:
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]
