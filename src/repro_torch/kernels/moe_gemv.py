"""Gather-GEMVs for cold experts (CUDA, ``csrc/moe_gemv.cu``) and their
plain PyTorch versions: ragged (``ragged_moe_gemv_kernel``) and
capacity-padded (``moe_gemv_kernel``).

The same SwiGLU FFN as the hot path for the ``k_cold`` least-loaded experts:
small (Cc, d) token slabs, each occupied expert's weights streamed once,
experts with ``counts == 0`` skipped, dead rows zeroed. Port of
``repro/kernels/moe_gemv.py::ragged_moe_gemv_kernel``. The
capacity-padded ``moe_gemv_kernel`` (port of ``moe_gemv_kernel``) streams
every cold expert's weights and computes all Cc slots: no counts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gemm import (check_expert_operands, moe_gemm_plain,
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


def ragged_moe_gemv_kernel(x, w_gate, w_up, w_out, perm, counts):
    """Layout as ``ragged_moe_gemv_plain`` (counts already clamped to Cc);
    runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors. The kernel needs d and d_ff multiples of 64 and 16-byte aligned
    weights (it streams them with 16-byte loads)."""
    if x.device.type == "cpu":
        return ragged_moe_gemv_plain(x, w_gate, w_up, w_out, perm, counts)
    _check_gemv_operands(x, w_gate, w_up, w_out, perm, counts)
    Ec, Cc, d = x.shape
    f = w_gate.shape[2]
    h = torch.empty((Ec, Cc, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    fn = build.bind("moe_gemv.cu", "ragged_moe_gemv", 8, 4)
    err = fn(build.DTYPE_CODES[str(x.dtype).split(".")[1]], x.data_ptr(),
             w_gate.data_ptr(), w_up.data_ptr(), w_out.data_ptr(),
             perm.data_ptr(), counts.data_ptr(), h.data_ptr(), y.data_ptr(),
             Ec, Cc, d, f, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ragged_moe_gemv")
    build.launch_counts["ragged_moe_gemv"] += 1
    return y


def moe_gemv_kernel(x, w_gate, w_up, w_out, perm):
    """Layout as ``moe_gemv_plain``; runs the CUDA kernel for CUDA tensors
    and the plain version for CPU tensors. Needs d and d_ff multiples of 64
    and 16-byte aligned weights, as the ragged kernel."""
    if x.device.type == "cpu":
        return moe_gemv_plain(x, w_gate, w_up, w_out, perm)
    _check_gemv_operands(x, w_gate, w_up, w_out, perm)
    Ec, Cc, d = x.shape
    f = w_gate.shape[2]
    h = torch.empty((Ec, Cc, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    fn = build.bind("moe_gemv.cu", "moe_gemv", 7, 4)
    err = fn(build.DTYPE_CODES[str(x.dtype).split(".")[1]], x.data_ptr(),
             w_gate.data_ptr(), w_up.data_ptr(), w_out.data_ptr(),
             perm.data_ptr(), h.data_ptr(), y.data_ptr(), Ec, Cc, d, f,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "moe_gemv")
    build.launch_counts["moe_gemv"] += 1
    return y
