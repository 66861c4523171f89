"""Device roofline + overhead cost model (paper §IV, §VI).

Own copy of ``repro/core/costmodel.py``, shared by:
  * ``core/partition.py`` — the expert co-processing latency tables,
  * ``core/dispatch.py``  — the Op/B-driven path selection,
  * ``sim/``              — the cluster and serving simulator behind the
                            paper's figures.

Execution time of an operation = max(flops / peak_flops, bytes / bw) +
t_launch (a roofline with a fixed launch overhead). Energy follows the
paper's §VI model: DRAM access energy (activation + column read +
transport) plus a per-FLOP compute term; the Logic-PIM paths skip the
off-chip I/O and PHY energy, the source of the paper's 28-42% energy
saving. These are the paper's modelled devices: they pick ``k_cold`` and
the modelled path exactly as the reference does and say nothing of the
port's measured speed.

Hardware constants:
  * H100 (the paper's baseline xPU): 989.4 TFLOP/s FP16 tensor dense,
    3.35 TB/s HBM3, 80 GB (NVIDIA H100 SXM datasheet).
  * Logic-PIM: 4x internal bandwidth through extra TSVs, processing units
    sized at 8 Op/B => 21.3 TFLOP/s a stack x 5 stacks.
  * Bank-PIM: 16x internal bandwidth, 1 Op/B (2x HBM-PIM).
  * BankGroup-PIM: Logic-PIM's bandwidth and compute with the units on the
    DRAM die (more area, so a worse EDAP, Fig. 8).

The reference's TPU v5e device and ICI link rate are left out: they are
its JAX runtime's roofline target, and the port's roofline targets the
H100 (``launch/roofline.py``).

DRAM energy per bit (pJ/bit), after O'Connor et al. (HBM2 measurements, the
paper's activate/read/write/TSV energies): activate 0.95, column read/write
1.25, off-chip I/O+PHY 1.28, TSV 0.35.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

# energy constants (pJ/bit, pJ/flop)
E_ACT = 0.95          # row activation, pJ/bit
E_RD = 1.25           # column read, pJ/bit
E_IO_EXT = 1.28       # off-chip I/O + PHY (interposer), pJ/bit
E_TSV = 0.35          # through-silicon-via transport, pJ/bit
E_FLOP_XPU = 0.65     # pJ/FLOP fp16 incl. SRAM movement (GPU-class, 7nm)
E_FLOP_PIM = 0.45     # pJ/FLOP on the logic die (shorter datapath, 650 MHz)


@dataclass(frozen=True)
class DeviceSpec:
    """One execution resource (a whole device or one path inside Duplex)."""
    name: str
    peak_flops: float          # FLOP/s
    mem_bw: float              # B/s usable by this path
    mem_capacity: float        # bytes (device-level)
    t_launch: float = 3e-6     # fixed per-op overhead, s
    e_bit_mem: float = E_ACT + E_RD + E_IO_EXT   # pJ per DRAM bit moved
    e_flop: float = E_FLOP_XPU                   # pJ per FLOP
    pu_area_mm2: float = 0.0   # processing-unit area, the EDAP's (Fig. 8)

    @property
    def knee_opb(self) -> float:
        return self.peak_flops / self.mem_bw

    def time(self, flops: float, bytes_: float) -> float:
        """Roofline seconds of one operation plus the launch overhead."""
        if flops <= 0 and bytes_ <= 0:
            return 0.0
        return max(flops / self.peak_flops, bytes_ / self.mem_bw) + self.t_launch

    def energy(self, flops: float, bytes_: float) -> float:
        """Joules."""
        return (flops * self.e_flop + bytes_ * 8.0 * self.e_bit_mem) * 1e-12


# ---------------------------------------------------------------------------
# The paper's devices (§VI)
# ---------------------------------------------------------------------------

HBM3_BW = 3.35e12           # H100 per-device HBM3 bandwidth
HBM3_CAP = 80e9
H100_FLOPS = 989.4e12       # FP16 tensor dense
N_STACKS = 5                # HBM stacks per device

H100 = DeviceSpec("h100", H100_FLOPS, HBM3_BW, HBM3_CAP,
                  e_bit_mem=E_ACT + E_RD + E_IO_EXT, e_flop=E_FLOP_XPU,
                  pu_area_mm2=814.0)  # the H100 die

# Logic-PIM: 4x internal bandwidth, compute sized at 8 Op/B
# (8 x 4 x 0.67 TB/s a stack = 21.4 TFLOP/s a stack, 5 stacks)
LOGIC_PIM = DeviceSpec("logic_pim", 8 * 4 * HBM3_BW, 4 * HBM3_BW, HBM3_CAP,
                       t_launch=2e-6,
                       e_bit_mem=E_ACT + E_RD + E_TSV, e_flop=E_FLOP_PIM,
                       pu_area_mm2=N_STACKS * 17.80)  # §VII-E per-stack units

# Bank-PIM: 16x internal bandwidth, 1 Op/B peak (2x HBM-PIM)
BANK_PIM = DeviceSpec("bank_pim", 1 * 16 * HBM3_BW, 16 * HBM3_BW, HBM3_CAP,
                      t_launch=2e-6,
                      e_bit_mem=E_ACT + E_RD, e_flop=E_FLOP_PIM * 1.4,
                      pu_area_mm2=N_STACKS * 121.0 * 0.25)  # 25% of DRAM dies

# BankGroup-PIM: Logic-PIM's ratios, units on the DRAM die
BANKGROUP_PIM = dataclasses.replace(
    LOGIC_PIM, name="bankgroup_pim", e_flop=E_FLOP_PIM * 1.2,
    pu_area_mm2=N_STACKS * 17.80 * 2.5)

NVLINK_BW = 900e9           # bidirectional, HGX (paper §VI)
IB_BW = 400e9               # inter-node Infiniband (paper §VI)

DEVICES: Dict[str, DeviceSpec] = {d.name: d for d in
                                  (H100, LOGIC_PIM, BANK_PIM, BANKGROUP_PIM)}


# ---------------------------------------------------------------------------
# Duplex device = xPU path + Logic-PIM path sharing one memory (paper §IV)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DuplexSpec:
    name: str
    xpu: DeviceSpec
    pim: DeviceSpec
    mem_capacity: float = HBM3_CAP

    def path(self, which: str) -> DeviceSpec:
        return self.xpu if which == "xpu" else self.pim


DUPLEX = DuplexSpec("duplex", H100, LOGIC_PIM)
DUPLEX_BANKPIM = DuplexSpec("duplex_bankpim", H100, BANK_PIM)


def gemm_time(dev: DeviceSpec, m: int, k: int, n: int,
              bytes_override: Optional[float] = None) -> float:
    flops = 2.0 * m * k * n
    bytes_ = bytes_override if bytes_override is not None else \
        2.0 * (m * k + k * n + m * n)
    return dev.time(flops, bytes_)


def edap(dev: DeviceSpec, flops: float, bytes_: float) -> float:
    """Energy-delay-area product of one op (Fig. 8)."""
    t = dev.time(flops, bytes_)
    e = dev.energy(flops, bytes_)
    return e * t * dev.pu_area_mm2
