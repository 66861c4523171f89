"""Execution plan: which MoE path a stage runs and whether the kernels run.

Port of ``repro/core/execution.py``. The reference keeps the active plan in
a context variable read during tracing; the port passes the plan down as an
argument (``mixed_step(..., plan=...)`` -> blocks -> ``moe_execute``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ExecutionPlan:
    moe_impl: str = "grouped"        # grouped | duplex
    k_cold: int = 0                  # duplex: number of cold (GEMV) experts
    c_hot: Optional[int] = None      # duplex: hot capacity (None = auto)
    c_cold: Optional[int] = None     # duplex: cold capacity (None = auto)
    # duplex + kernels: thread per-expert live counts into the ragged MoE
    # kernels; off, the capacity-padded MoE kernels run
    moe_ragged: bool = False
    use_kernels: bool = False        # CUDA kernels (plain versions on CPU)
    # flash-core tile shapes of the plain attention path; the flash core runs
    # for sequences longer than attn_q_block (the kernels tile by themselves)
    attn_q_block: int = 512
    attn_kv_block: int = 512


DEFAULT_PLAN = ExecutionPlan()


def moe_execute(params, cfg: ModelConfig, x, plan: ExecutionPlan = DEFAULT_PLAN,
                *, token_valid=None):
    """Route the MoE layer through the plan's path. Returns (y, router)."""
    # the ragged kernels live on the count-threaded duplex path, so a duplex
    # plan with k_cold == 0 still routes there when ragged is on
    if plan.moe_impl == "duplex" and (plan.k_cold > 0 or plan.moe_ragged):
        from repro_torch.core.duplex_moe import duplex_moe_apply
        return duplex_moe_apply(params, cfg, x, k_cold=plan.k_cold,
                                c_hot=plan.c_hot, c_cold=plan.c_cold,
                                use_kernels=plan.use_kernels,
                                ragged=plan.moe_ragged,
                                token_valid=token_valid)
    from repro_torch.models.moe import moe_apply
    return moe_apply(params, cfg, x, token_valid=token_valid)
