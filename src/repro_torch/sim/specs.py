"""Pre-built systems for the paper's evaluated configurations (§VI). Port
of ``repro/sim/specs.py``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import DUPLEX, DUPLEX_BANKPIM, H100
from repro_torch.sim.cluster import SystemSpec
from repro_torch.sim.paper_models import PAPER_SYSTEMS


def gpu_system(nodes: int, devs: int, *, name: str = "gpu") -> SystemSpec:
    return SystemSpec(name, nodes, devs, H100)


def duplex_system(nodes: int, devs: int, *, moe_dist: str = "ep",
                  name: str = "duplex") -> SystemSpec:
    return SystemSpec(name, nodes, devs, DUPLEX, moe_dist=moe_dist)


def bankpim_system(nodes: int, devs: int) -> SystemSpec:
    return SystemSpec("bankpim", nodes, devs, DUPLEX_BANKPIM)


def default_system(cfg: ModelConfig, kind: str) -> SystemSpec:
    """The paper's §VI default size for ``cfg``; kind in {gpu, gpu2x,
    duplex, duplex_et, bankpim}."""
    nodes, devs = PAPER_SYSTEMS.get(cfg.name, (1, 4))
    if kind == "gpu":
        return gpu_system(nodes, devs)
    if kind == "gpu2x":
        # double devices: grow within the node to 8 first, then nodes
        total = nodes * devs * 2
        if total <= 8:
            return gpu_system(1, total, name="gpu2x")
        return gpu_system(total // 8, 8, name="gpu2x")
    if kind == "duplex":
        return duplex_system(nodes, devs)
    if kind == "duplex_et":
        return duplex_system(nodes, devs, moe_dist="et", name="duplex_et")
    if kind == "bankpim":
        return bankpim_system(nodes, devs)
    raise ValueError(kind)
