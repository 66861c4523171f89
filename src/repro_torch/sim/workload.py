"""Synthesized request workloads (paper §VI): Gaussian lengths, Poisson
arrivals. Port of ``repro/sim/workload.py``, numpy's generator drawn in
the reference's order."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class SimRequest:
    rid: int
    l_in: int
    l_out: int
    arrival: float = 0.0
    # filled by the simulator
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = None

    def __post_init__(self):
        if self.token_times is None:
            self.token_times = []

    @property
    def t2ft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    @property
    def e2e(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival

    def tbts(self) -> List[float]:
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]


def gaussian_requests(n: int, l_in: int, l_out: int, *, seed: int = 0,
                      std_frac: float = 0.1) -> List[SimRequest]:
    """Input/output lengths ~ N(mean, (std_frac*mean)^2), clipped >= 16."""
    rng = np.random.default_rng(seed)
    lin = np.maximum(rng.normal(l_in, std_frac * l_in, n), 16).astype(int)
    lout = np.maximum(rng.normal(l_out, std_frac * l_out, n), 16).astype(int)
    return [SimRequest(i, int(lin[i]), int(lout[i])) for i in range(n)]


def poisson_arrivals(reqs: List[SimRequest], qps: float, *,
                     seed: int = 0) -> List[SimRequest]:
    """Set each request's arrival: exponential gaps of mean 1/qps."""
    rng = np.random.default_rng(seed)
    t = 0.0
    for r in reqs:
        t += rng.exponential(1.0 / qps)
        r.arrival = t
    return reqs
