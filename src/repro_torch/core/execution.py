"""Execution plan: which MoE path a stage runs, whether the kernels run,
and the attention's tiles and score precision.

Port of ``repro/core/execution.py``. The reference keeps the active plan in
a context variable read during tracing; the port passes the plan down as an
argument (``mixed_step(..., plan=...)`` -> blocks -> ``moe_execute``), and
``shard_blocks`` takes it as an argument too.
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
    # (batch-shard count, seq-shard count) of the activation layout that
    # ``shard_blocks`` tiles by; (1, 1) on one device
    dispatch_grid: tuple = (1, 1)
    # flash-core tile shapes of the plain attention path; the flash core runs
    # for sequences longer than attn_q_block (the kernels tile by themselves)
    attn_q_block: int = 512
    attn_kv_block: int = 512
    # the flash core's scores in bf16 with float32 softmax statistics (the
    # plain version's torch ops, or the flash forwards' chain with
    # use_kernels on CUDA tensors)
    attn_score_bf16: bool = False


DEFAULT_PLAN = ExecutionPlan()


def shard_blocks(x, plan: ExecutionPlan = DEFAULT_PLAN):
    """(B, S, d) -> (n, Tl, d), each row one (batch-block, seq-block) tile
    of ``plan.dispatch_grid`` (each count cut to the largest divisor of its
    dimension). Returns (xb, restore), ``restore`` undoing the blocking on
    a (T, d) tensor."""
    grid = plan.dispatch_grid
    B, S, d = x.shape

    def divisor(dim, limit):
        n = max(1, min(limit, dim))
        while dim % n:
            n -= 1
        return n

    nb, ns = divisor(B, grid[0]), divisor(S, grid[1])
    if nb * ns == 1:
        return x.reshape(1, B * S, d), lambda y: y.reshape(B, S, d)
    xb = x.reshape(nb, B // nb, ns, S // ns, d)
    xb = xb.permute(0, 2, 1, 3, 4).reshape(nb * ns, -1, d)

    def restore(y_flat):
        y = y_flat.reshape(nb, ns, B // nb, S // ns, d)
        return y.permute(0, 2, 1, 3, 4).reshape(B, S, d)

    return xb, restore


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
                                token_valid=token_valid, plan=plan)
    from repro_torch.models.moe import moe_apply
    return moe_apply(params, cfg, x, token_valid=token_valid, plan=plan)
