"""Expert co-processing partitioner (paper §V-B) and the serving planner.

Own copy of ``repro/core/partition.py``'s ``build_lut(s)``,
``partition_experts``, ``optimal_partition_bruteforce`` (its exhaustive
test oracle) and ``DuplexPlanner``: latency lookup tables per
expert token count on each path, the greedy makespan split (start with all
experts on the xPU path, move the fewest-token experts to the PIM path one
at a time, keep the best makespan), and the static ``k_cold`` snapped to a
small set of buckets. Identical arithmetic, so the port and the reference
choose the same ``k_cold`` from the same counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import DeviceSpec, DuplexSpec


@dataclass(frozen=True)
class ExpertLUT:
    """times[t] = seconds to run one expert FFN over t tokens on this path."""
    device: str
    times: np.ndarray

    def __call__(self, tokens) -> np.ndarray:
        t = np.clip(np.asarray(tokens, dtype=np.int64), 0, len(self.times) - 1)
        return self.times[t]


def build_lut(dev: DeviceSpec, d_model: int, d_ff: int, max_tokens: int,
              mats: int = 3, *, block: Optional[int] = None,
              capacity: Optional[int] = None) -> ExpertLUT:
    """Expert FFN cost: default = live tokens, weights read once (GEMV
    path); ``capacity`` = the capacity-padded grouped GEMM; ``block`` alone
    = the ragged grouped GEMM (live tokens rounded up to token blocks,
    weights re-read per live block)."""
    t = np.arange(max_tokens + 1, dtype=np.float64)
    w_once = 2.0 * mats * d_model * d_ff
    if capacity is not None:
        nb = np.where(t > 0, float(-(-capacity // (block or capacity))), 0.0)
        t_eff = np.where(t > 0, float(capacity), 0.0)
    elif block is not None:
        nb = np.ceil(t / block)
        t_eff = nb * block
    else:
        nb = (t > 0).astype(np.float64)
        t_eff = t
    flops = 2.0 * mats * t_eff * d_model * d_ff
    w_bytes = w_once * nb
    a_bytes = 2.0 * t_eff * (2 * d_model + mats * d_ff)
    bytes_ = np.where(t > 0, w_bytes + a_bytes, 0.0)
    times = np.maximum(flops / dev.peak_flops, bytes_ / dev.mem_bw)
    times = np.where(t > 0, times + dev.t_launch, 0.0)
    return ExpertLUT(dev.name, times)


def build_luts(duplex: DuplexSpec, d_model: int, d_ff: int, max_tokens: int,
               mats: int = 3, *, hot_block: Optional[int] = None,
               hot_capacity: Optional[int] = None) -> Tuple[ExpertLUT, ExpertLUT]:
    """(xPU LUT, PIM LUT); the hot-path mode follows the hot kernel."""
    return (build_lut(duplex.xpu, d_model, d_ff, max_tokens, mats,
                      block=hot_block, capacity=hot_capacity),
            build_lut(duplex.pim, d_model, d_ff, max_tokens, mats))


@dataclass(frozen=True)
class Partition:
    cold: Tuple[int, ...]          # expert ids, ascending token count
    hot: Tuple[int, ...]
    t_xpu: float
    t_pim: float

    @property
    def makespan(self) -> float:
        return max(self.t_xpu, self.t_pim)

    @property
    def k_cold(self) -> int:
        return len(self.cold)


def partition_experts(counts: Sequence[int], lut_xpu: ExpertLUT,
                      lut_pim: ExpertLUT) -> Partition:
    counts = np.asarray(counts, dtype=np.int64)
    E = len(counts)
    order = np.argsort(counts, kind="stable")
    tx = lut_xpu(counts)
    tp = lut_pim(counts)
    t_xpu = float(tx.sum())
    t_pim = 0.0
    best = Partition(cold=(), hot=tuple(int(e) for e in order), t_xpu=t_xpu, t_pim=0.0)
    for k in range(1, E + 1):
        e = int(order[k - 1])
        t_xpu -= float(tx[e])
        t_pim += float(tp[e])
        if max(t_xpu, t_pim) < best.makespan:
            best = Partition(cold=tuple(int(x) for x in order[:k]),
                             hot=tuple(int(x) for x in order[k:]),
                             t_xpu=t_xpu, t_pim=t_pim)
    return best


def optimal_partition_bruteforce(counts: Sequence[int], lut_xpu: ExpertLUT,
                                 lut_pim: ExpertLUT) -> float:
    """Exhaustive best makespan over all 2^E subsets: the partitioner's
    test oracle, for E <= 16."""
    counts = np.asarray(counts, dtype=np.int64)
    E = len(counts)
    if E > 16:
        raise ValueError(f"the brute-force oracle takes at most 16 experts, got {E}")
    tx = lut_xpu(counts)
    tp = lut_pim(counts)
    best = float(tx.sum())
    for mask in range(1, 1 << E):
        t_pim = sum(float(tp[e]) for e in range(E) if mask >> e & 1)
        t_xpu = sum(float(tx[e]) for e in range(E) if not mask >> e & 1)
        best = min(best, max(t_xpu, t_pim))
    return best


@dataclass
class DuplexPlanner:
    """Picks the next stage's static ``k_cold`` from (EMA) router counts and
    snaps it to the buckets {0, E/8, E/4, E/2, 3E/4, E}."""
    lut_xpu: ExpertLUT
    lut_pim: ExpertLUT
    num_experts: int

    def __post_init__(self):
        E = self.num_experts
        self.buckets = tuple(sorted({0, E // 8, E // 4, E // 2, 3 * E // 4, E}))

    def plan(self, counts: Sequence[int]) -> Partition:
        return partition_experts(counts, self.lut_xpu, self.lut_pim)

    def k_cold_static(self, counts: Sequence[int]) -> int:
        k = self.plan(counts).k_cold
        return min(self.buckets, key=lambda b: (abs(b - k), b))
