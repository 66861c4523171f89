"""Latency metric helpers (T2FT / TBT / E2E percentiles, paper Fig. 2).
Port of ``repro/sim/metrics.py``."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.sim.workload import SimRequest


def percentile(xs: Sequence[float], p: float) -> float:
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs), p))


def latency_summary(reqs: List[SimRequest]) -> Dict[str, float]:
    t2ft = [r.t2ft for r in reqs if r.t2ft is not None]
    e2e = [r.e2e for r in reqs if r.e2e is not None]
    tbts = [t for r in reqs for t in r.tbts()]
    return {
        "t2ft_p50": percentile(t2ft, 50), "t2ft_p90": percentile(t2ft, 90),
        "t2ft_p99": percentile(t2ft, 99),
        "tbt_p50": percentile(tbts, 50), "tbt_p90": percentile(tbts, 90),
        "tbt_p99": percentile(tbts, 99),
        "e2e_p50": percentile(e2e, 50), "e2e_p90": percentile(e2e, 90),
        "e2e_p99": percentile(e2e, 99),
    }
