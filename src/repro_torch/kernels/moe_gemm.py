"""Grouped GEMMs for hot experts (CUDA, ``csrc/moe_gemm.cu``) and their
plain PyTorch versions: ragged (``ragged_moe_gemm_kernel``) and
capacity-padded (``moe_gemm_kernel``).

Computes, per hot rank e with expert id ``perm[e]``, the SwiGLU FFN
``(silu(x Wg) * (x Wu)) Wo`` over the live rows ``c < counts[e]`` of its slot
buffer, with float32 accumulation and ``silu * up`` rounded to the
activation dtype before ``Wo`` (the TPU kernel's rounding point); rows at or
past each count come back zeroed. Port of ``repro/kernels/moe_gemm.py::
ragged_moe_gemm_kernel``. The expert weights are read in place through
``perm`` — no permuted weight copy is built.

The capacity-padded ``moe_gemm_kernel`` (port of ``moe_gemm.py::
moe_gemm_kernel``) computes the same FFN over every slot of the capacity:
no counts, nothing skipped or zeroed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def swiglu_ffn_plain(x, w_gate, w_up, w_out):
    """The kernels' FFN recipe on grouped tokens: x (e, C, d); weights
    (e, d, f) / (e, f, d) already in x's expert order. float32 products,
    silu(g) * u rounded to x's dtype before Wo, result in x's dtype."""
    g = torch.matmul(x.float(), w_gate.float())
    u = torch.matmul(x.float(), w_up.float())
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return torch.matmul(h.float(), w_out.float()).to(x.dtype)


def zero_dead_rows(y, counts):
    """Zero slots at or past each expert's count: y (e, C, d); counts (e,)."""
    live = torch.arange(y.shape[1], device=y.device)[None, :] < counts[:, None]
    return torch.where(live[..., None], y, torch.zeros((), dtype=y.dtype,
                                                       device=y.device))


def moe_gemm_plain(x, w_gate, w_up, w_out, perm):
    """Capacity-padded: x (Eh, C, d) slot buffers in rank order; w_gate/w_up
    (E, d, f) and w_out (E, f, d) for all experts; perm (Eh,) expert id per
    rank. Every slot is computed. -> (Eh, C, d)."""
    idx = perm.long()
    return swiglu_ffn_plain(x, w_gate[idx], w_up[idx], w_out[idx])


def ragged_moe_gemm_plain(x, w_gate, w_up, w_out, perm, counts):
    """As ``moe_gemm_plain`` with counts (Eh,) live rows: slots at or past
    each count come back zeroed."""
    return zero_dead_rows(moe_gemm_plain(x, w_gate, w_up, w_out, perm), counts.long())


def check_expert_operands(x, w_gate, w_up, w_out, perm, counts=None):
    """Refuse what the MoE kernels do not take (``counts`` None: the padded
    variants)."""
    if x.device.type != "cuda":
        raise ValueError(f"MoE kernels run on CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"MoE kernels take float32/bfloat16, got {x.dtype}")
    E, d, f = w_gate.shape
    if x.ndim != 3 or x.shape[2] != d or w_up.shape != (E, d, f) \
            or w_out.shape != (E, f, d):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_out {tuple(w_out.shape)}")
    for t in (x, w_gate, w_up, w_out):
        if t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError("x and expert weights must be contiguous, one dtype, one device")
    for t in (perm,) if counts is None else (perm, counts):
        if t.dtype != torch.int32 or t.device != x.device or not t.is_contiguous() \
                or t.shape != (x.shape[0],):
            raise ValueError("perm/counts must be contiguous int32 (experts,) on x's device")


def ragged_moe_gemm_kernel(x, w_gate, w_up, w_out, perm, counts):
    """Layout as ``ragged_moe_gemm_plain`` (counts already clamped to C);
    runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return ragged_moe_gemm_plain(x, w_gate, w_up, w_out, perm, counts)
    check_expert_operands(x, w_gate, w_up, w_out, perm, counts)
    Eh, C, d = x.shape
    f = w_gate.shape[2]
    h = torch.empty((Eh, C, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    fn = build.bind("moe_gemm.cu", "ragged_moe_gemm", 8, 4)
    err = fn(build.DTYPE_CODES[str(x.dtype).split(".")[1]], x.data_ptr(),
             w_gate.data_ptr(), w_up.data_ptr(), w_out.data_ptr(),
             perm.data_ptr(), counts.data_ptr(), h.data_ptr(), y.data_ptr(),
             Eh, C, d, f, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ragged_moe_gemm")
    build.launch_counts["ragged_moe_gemm"] += 1
    return y


def moe_gemm_kernel(x, w_gate, w_up, w_out, perm):
    """Layout as ``moe_gemm_plain``; runs the CUDA kernel for CUDA tensors
    and the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return moe_gemm_plain(x, w_gate, w_up, w_out, perm)
    check_expert_operands(x, w_gate, w_up, w_out, perm)
    Eh, C, d = x.shape
    f = w_gate.shape[2]
    h = torch.empty((Eh, C, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    fn = build.bind("moe_gemm.cu", "moe_gemm", 7, 4)
    err = fn(build.DTYPE_CODES[str(x.dtype).split(".")[1]], x.data_ptr(),
             w_gate.data_ptr(), w_up.data_ptr(), w_out.data_ptr(),
             perm.data_ptr(), h.data_ptr(), y.data_ptr(), Eh, C, d, f,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "moe_gemm")
    build.launch_counts["moe_gemm"] += 1
    return y
