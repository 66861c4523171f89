"""Device roofline constants the Duplex planner's latency tables use.

Own copy of the part of ``repro/core/costmodel.py`` the planner needs:
``DeviceSpec``, ``DuplexSpec`` and ``DUPLEX`` (an H100 xPU path beside the
paper's Logic-PIM path). These are the paper's modelled devices; they pick
``k_cold`` exactly as the reference does and say nothing about the port's
measured speed.
"""
from __future__ import annotations

from dataclasses import dataclass

HBM3_BW = 3.35e12           # H100 per-device HBM3 bandwidth
HBM3_CAP = 80e9
H100_FLOPS = 989.4e12       # FP16 tensor dense


@dataclass(frozen=True)
class DeviceSpec:
    """One execution resource (a whole device or one path inside Duplex)."""
    name: str
    peak_flops: float          # FLOP/s
    mem_bw: float              # B/s usable by this path
    mem_capacity: float        # bytes
    t_launch: float = 3e-6     # fixed per-op overhead, s


H100 = DeviceSpec("h100", H100_FLOPS, HBM3_BW, HBM3_CAP)
# Logic-PIM (paper §VI): 4x internal bandwidth, compute sized at 8 Op/B
LOGIC_PIM = DeviceSpec("logic_pim", 8 * 4 * HBM3_BW, 4 * HBM3_BW, HBM3_CAP,
                       t_launch=2e-6)


@dataclass(frozen=True)
class DuplexSpec:
    name: str
    xpu: DeviceSpec
    pim: DeviceSpec


DUPLEX = DuplexSpec("duplex", H100, LOGIC_PIM)
