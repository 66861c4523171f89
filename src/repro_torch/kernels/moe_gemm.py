"""Grouped GEMMs for hot experts (CUDA, ``csrc/moe_gemm_sm90.cu`` and
``csrc/moe_gemm.cu``) and their plain PyTorch versions: ragged
(``ragged_moe_gemm_kernel``) and capacity-padded (``moe_gemm_kernel``).

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

Two routes, chosen before the launch by dtype: bfloat16 runs the
tensor-core kernels of ``moe_gemm_sm90.cu`` (each live expert's weights by
TMA once for up to 128 live rows, ``wgmma`` with the rows as N; counted
under ``ragged_moe_gemm_sm90`` or ``moe_gemm_sm90`` as well), float32 the
scalar kernels of ``moe_gemm.cu``.
"""
from __future__ import annotations

import numpy as np
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


# weight stages a block of the bf16 kernels keeps in flight (2 was the
# fastest of 2-5 on the card; at C <= 64 it leaves room for two blocks an SM)
STAGES = 2


def launch(name, stages, x, w_gate, w_up, w_out, perm, counts=None):
    """The expert FFN kernels' launch (the hot GEMMs here, the cold GEMVs in
    ``moe_gemv``), operands already checked: the route by dtype, h and y
    allocated here. bfloat16 runs ``<name>_sm90`` of ``<kind>_sm90.cu`` and
    counts it under that name too, float32 ``<name>`` of ``<kind>.cu``
    (kind: ``name`` without ``ragged_``)."""
    n, C, d = x.shape
    f = w_gate.shape[2]
    h = torch.empty((n, C, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    ptrs = [x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_out.data_ptr(),
            perm.data_ptr()] + ([] if counts is None else [counts.data_ptr()])
    ptrs += [h.data_ptr(), y.data_ptr()]
    ints = (n, C, d, f)
    kind = name.removeprefix("ragged_")
    sm90 = x.dtype == torch.bfloat16
    if sm90:
        if d % 64 or f % 64:
            raise ValueError(f"the bf16 {name} kernel needs d, d_ff multiples of 64, "
                             f"got {d}, {f}")
        if any(t.data_ptr() % 16 for t in (x, w_gate, w_up, w_out, h)):
            raise ValueError(f"the bf16 {name} kernel reads x and the expert weights by "
                             f"TMA: their bases must be 16-byte aligned")
        source, entry = f"{kind}_sm90.cu", f"{name}_sm90"
        ints = (w_gate.shape[0], *ints, stages)
    else:
        source, entry = f"{kind}.cu", name
    fn = build.bind(source, entry, len(ptrs), len(ints))
    err = fn(build.DTYPE_CODES[str(x.dtype).split(".")[1]], *ptrs, *ints,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, entry)
    build.launch_counts[name] += 1
    if sm90:
        build.launch_counts[entry] += 1
    return y


def ragged_moe_gemm_kernel(x, w_gate, w_up, w_out, perm, counts):
    """Layout as ``ragged_moe_gemm_plain`` (counts already clamped to C);
    runs a CUDA kernel for CUDA tensors (bfloat16: ``moe_gemm_sm90.cu``,
    which needs d and d_ff multiples of 64 and 16-byte aligned operands;
    float32: ``moe_gemm.cu``) and the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return ragged_moe_gemm_plain(x, w_gate, w_up, w_out, perm, counts)
    check_expert_operands(x, w_gate, w_up, w_out, perm, counts)
    return launch("ragged_moe_gemm", STAGES, x, w_gate, w_up, w_out, perm, counts)


def moe_gemm_kernel(x, w_gate, w_up, w_out, perm):
    """Layout as ``moe_gemm_plain``; runs a CUDA kernel for CUDA tensors
    (the routes and shapes of the ragged kernel) and the plain version for
    CPU tensors."""
    if x.device.type == "cpu":
        return moe_gemm_plain(x, w_gate, w_up, w_out, perm)
    check_expert_operands(x, w_gate, w_up, w_out, perm)
    return launch("moe_gemm", STAGES, x, w_gate, w_up, w_out, perm)


def moe_gemm_traffic(counts, *, capacity: int, d_model: int, d_ff: int,
                     c_block: int, itemsize: int = 2, mats: int = 3) -> dict:
    """Modelled per-layer HBM bytes + FLOPs of the hot grouped GEMM, padded
    (every token block) vs ragged (live blocks only): each executed block
    streams the expert's ``mats`` weight matrices (d x f) once and moves
    c_block x d of activations in and out. Host numpy, no launch. Returns
    ``{padded,ragged}_{bytes,weight_bytes,flops}``."""
    counts = np.minimum(np.asarray(counts, dtype=np.int64), capacity)
    E = len(counts)
    cb = min(c_block, capacity)
    nc = -(-capacity // cb)
    nb_live = -(-counts // cb)
    w_block = mats * d_model * d_ff * itemsize
    a_block = 2 * cb * d_model * itemsize
    flops_block = 2 * mats * cb * d_model * d_ff
    padded, ragged = E * nc, int(nb_live.sum())
    return {"padded_weight_bytes": padded * w_block,
            "ragged_weight_bytes": ragged * w_block,
            "padded_bytes": padded * (w_block + a_block),
            "ragged_bytes": ragged * (w_block + a_block),
            "padded_flops": padded * flops_block,
            "ragged_flops": ragged * flops_block}
