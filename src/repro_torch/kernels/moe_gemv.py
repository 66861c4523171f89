"""Gather-GEMVs for cold experts (CUDA, ``csrc/moe_gemv_sm90.cu`` and
``csrc/moe_gemv.cu``) and their plain PyTorch versions: ragged
(``ragged_moe_gemv_kernel``) and capacity-padded (``moe_gemv_kernel``).

The same SwiGLU FFN as the hot path for the ``k_cold`` least-loaded experts:
small (Cc, d) token slabs, each occupied expert's weights streamed once,
experts with ``counts == 0`` skipped, dead rows zeroed. Port of
``repro/kernels/moe_gemv.py::ragged_moe_gemv_kernel``. The
capacity-padded ``moe_gemv_kernel`` (port of ``moe_gemv_kernel``) streams
every cold expert's weights and computes all Cc slots: no counts.

Two routes, chosen before the launch by dtype: bfloat16 runs the
tensor-core kernels of ``moe_gemv_sm90.cu`` (weights by TMA, the live rows
as the M dimension of ``mma.sync``; counted under ``ragged_moe_gemv_sm90``
or ``moe_gemv_sm90`` as well), float32 the scalar kernels of
``moe_gemv.cu``.
"""
from __future__ import annotations

from repro_torch.kernels.moe_gemm import (check_expert_operands, launch, moe_gemm_plain,
                                          zero_dead_rows)


def moe_gemv_plain(x, w_gate, w_up, w_out, perm):
    """Capacity-padded: x (Ec, Cc, d) cold slot buffers in rank order;
    w_gate/w_up (E, d, f) and w_out (E, f, d) for all experts; perm (Ec,)
    expert id per cold rank. Every slot is computed. -> (Ec, Cc, d)."""
    return moe_gemm_plain(x, w_gate, w_up, w_out, perm)


def ragged_moe_gemv_plain(x, w_gate, w_up, w_out, perm, counts):
    """As ``moe_gemv_plain`` with counts (Ec,) live rows: slots at or past
    each count come back zeroed."""
    return zero_dead_rows(moe_gemv_plain(x, w_gate, w_up, w_out, perm), counts.long())


def _check_gemv_operands(x, w_gate, w_up, w_out, perm, counts=None):
    check_expert_operands(x, w_gate, w_up, w_out, perm, counts)
    d, f = w_gate.shape[1], w_gate.shape[2]
    if d % 64 or f % 64:
        raise ValueError(f"cold GEMV kernel needs d, d_ff multiples of 64, got {d}, {f}")
    if any(t.data_ptr() % 16 for t in (w_gate, w_up, w_out)):
        raise ValueError("cold GEMV kernel needs 16-byte aligned expert weights")


# weight stages a block of the bf16 kernels keeps in flight (2 leaves room
# for more blocks an SM, which was faster than deeper rings)
STAGES = 2


def ragged_moe_gemv_kernel(x, w_gate, w_up, w_out, perm, counts):
    """Layout as ``ragged_moe_gemv_plain`` (counts already clamped to Cc);
    runs a CUDA kernel for CUDA tensors (bfloat16: ``moe_gemv_sm90.cu``,
    float32: ``moe_gemv.cu``) and the plain version for CPU tensors. The
    kernels need d and d_ff multiples of 64 and 16-byte aligned weights."""
    if x.device.type == "cpu":
        return ragged_moe_gemv_plain(x, w_gate, w_up, w_out, perm, counts)
    _check_gemv_operands(x, w_gate, w_up, w_out, perm, counts)
    return launch("ragged_moe_gemv", STAGES, x, w_gate, w_up, w_out, perm, counts)


def moe_gemv_kernel(x, w_gate, w_up, w_out, perm):
    """Layout as ``moe_gemv_plain``; runs a CUDA kernel for CUDA tensors
    (the routes and shapes of the ragged kernel) and the plain version for
    CPU tensors."""
    if x.device.type == "cpu":
        return moe_gemv_plain(x, w_gate, w_up, w_out, perm)
    _check_gemv_operands(x, w_gate, w_up, w_out, perm)
    return launch("moe_gemv", STAGES, x, w_gate, w_up, w_out, perm)
