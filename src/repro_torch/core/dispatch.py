"""Op/B-driven layer dispatch: the path of every layer component of a
continuous-batching stage.

Own copy of ``repro/core/dispatch.py``. Each component's Op/B
(``core/opb.py``) selects its path:

  * ``bandwidth`` (the paper's Logic-PIM) for components whose Op/B falls
    in the Logic-PIM band (at most ``OPB_THRESHOLD``),
  * ``compute`` (the paper's xPU) otherwise,

with the projections and the LM head pinned to compute and decode
attention, cross attention and the Mamba state update pinned to bandwidth,
as the paper's stage policy does. The engine reports each stage's
bandwidth-path FLOP fraction from this model; no kernel choice reads it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.core import opb as opb_mod
from repro_torch.core.costmodel import DuplexSpec
from repro_torch.core.opb import OpCost, StageMix

COMPUTE = "compute"      # xPU analogue
BANDWIDTH = "bandwidth"  # Logic-PIM analogue

# Logic-PIM's effective band: "low-Op/B (1-32) operations"
OPB_THRESHOLD = 32.0


@dataclass(frozen=True)
class ComponentRoute:
    component: str     # opb.OpCost.name
    opb: float
    path: str          # COMPUTE | BANDWIDTH
    flops: float
    bytes: float


@dataclass(frozen=True)
class StagePlan:
    """Routing decision for every layer component of one stage."""
    mix: StageMix
    routes: Tuple[Tuple[LayerKind, Tuple[ComponentRoute, ...]], ...]

    def path_of(self, kind: LayerKind, component: str) -> str:
        for k, comps in self.routes:
            if k == kind:
                for c in comps:
                    if c.component == component:
                        return c.path
        raise KeyError((kind, component))

    def bandwidth_fraction(self) -> float:
        """Fraction of stage FLOPs routed to the bandwidth path."""
        tot = bw = 0.0
        for _, comps in self.routes:
            for c in comps:
                tot += c.flops
                if c.path == BANDWIDTH:
                    bw += c.flops
        return bw / max(tot, 1.0)


def route_component(cost: OpCost, *, threshold: float = OPB_THRESHOLD,
                    duplex: Optional[DuplexSpec] = None) -> str:
    """Op/B rule. With a DuplexSpec, the modelled times on the two paths
    decide instead (equivalent at the knee)."""
    if duplex is not None:
        t_x = duplex.xpu.time(cost.flops, cost.bytes)
        t_p = duplex.pim.time(cost.flops, cost.bytes)
        return BANDWIDTH if t_p <= t_x else COMPUTE
    return BANDWIDTH if cost.opb <= threshold else COMPUTE


# Always on the compute path whatever their Op/B: the projections and the LM
# head batch over every token of the stage. "attn_chunk" is not pinned: a
# whole-prompt chunk is compute-bound, a short chunk or verify span over a
# long prefix bandwidth-bound, so the Op/B rule places it per stage.
_ALWAYS_COMPUTE = {"qkv+proj", "lm_head"}
# Pinned to the bandwidth path by the stage policy even at a borderline Op/B
_DECODE_BOUND = {"attn_decode", "cross_attn", "mamba_decode"}


def plan_stage(cfg: ModelConfig, mix: StageMix, *,
               counts: Optional[Sequence[int]] = None,
               threshold: float = OPB_THRESHOLD,
               duplex: Optional[DuplexSpec] = None,
               kv_quant: bool = False) -> StagePlan:
    """Route every component of every (unique) layer kind. ``kv_quant``
    halves the modelled KV stream (int8 and scales), doubling the decode
    and chunk attention's Op/B."""
    seen: Dict[LayerKind, Tuple[ComponentRoute, ...]] = {}
    for kind in cfg.layer_kinds():
        if kind in seen:
            continue
        lc = opb_mod.layer_stage_cost(cfg, kind, mix, counts, kv_quant=kv_quant)
        routes = []
        for c in lc.components:
            if c.name in _ALWAYS_COMPUTE:
                path = COMPUTE
            elif c.name in _DECODE_BOUND:
                path = BANDWIDTH
            else:
                path = route_component(c, threshold=threshold, duplex=duplex)
            routes.append(ComponentRoute(c.name, c.opb, path, c.flops, c.bytes))
        seen[kind] = tuple(routes)
    return StagePlan(mix, tuple(seen.items()))


def describe_plan(plan: StagePlan) -> str:
    lines = [f"stage: {'mixed' if plan.mix.is_mixed else 'decoding-only'} "
             f"(decode={len(plan.mix.decode_ctx)}, "
             f"prefill={len(plan.mix.prefill_len)})"]
    for kind, comps in plan.routes:
        for c in comps:
            lines.append(f"  {kind.mixer:>10s}/{kind.ffn:<5s} {c.component:<14s}"
                         f" opb={c.opb:9.2f} -> {c.path}")
    lines.append(f"  bandwidth-path FLOP fraction: "
                 f"{plan.bandwidth_fraction():.3f}")
    return "\n".join(lines)
