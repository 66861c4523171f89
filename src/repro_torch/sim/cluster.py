"""Cluster/system model: devices, interconnect, model distribution
(paper §III, §VI). Port of ``repro/sim/cluster.py``.

Distribution follows the paper's methodology (Fig. 3): tensor parallelism
for the non-expert FC layers within a node, data parallelism across nodes;
expert parallelism for MoE (or expert tensor parallelism under C4 "+ET");
attention distributed by request/head parallelism.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import IB_BW, NVLINK_BW, DeviceSpec, DuplexSpec

BYTES = 2


@dataclass(frozen=True)
class SystemSpec:
    """A serving system: homogeneous devices in nodes."""
    name: str
    nodes: int
    devs_per_node: int
    device: object                     # DeviceSpec (GPU) or DuplexSpec
    nvlink_bw: float = NVLINK_BW
    ib_bw: float = IB_BW
    # expert distribution: "ep" (paper default) or "et" (C4: TP within node)
    moe_dist: str = "ep"

    @property
    def n_dev(self) -> int:
        return self.nodes * self.devs_per_node

    @property
    def is_duplex(self) -> bool:
        return isinstance(self.device, DuplexSpec)

    def xpu(self) -> DeviceSpec:
        return self.device.xpu if self.is_duplex else self.device

    def pim(self) -> Optional[DeviceSpec]:
        return self.device.pim if self.is_duplex else None

    @property
    def mem_capacity(self) -> float:
        # DeviceSpec and DuplexSpec both carry one: a device without one
        # raises here rather than fitting no request
        return self.n_dev * self.device.mem_capacity


def weight_bytes(cfg: ModelConfig) -> float:
    return BYTES * cfg.param_count()


def kv_bytes_per_token(cfg: ModelConfig) -> float:
    """KV-cache bytes one context token costs (all layers)."""
    hd = cfg.resolved_head_dim
    n_attn = sum(1 for k in cfg.layer_kinds()
                 if k.mixer != "mamba")
    return BYTES * 2 * cfg.num_kv_heads * hd * n_attn


def max_batch_size(system: SystemSpec, cfg: ModelConfig, max_ctx: int,
                   *, weight_copies: int = 1) -> int:
    """Requests that fit after weights (paper §III-B / Fig. 5(c))."""
    free = system.mem_capacity - weight_copies * weight_bytes(cfg)
    per_req = kv_bytes_per_token(cfg) * max_ctx
    return max(int(free / per_req), 0)
