"""Mamba-2 single-token state update (CUDA, ``csrc/ssd_decode.cu``) and its
plain PyTorch version.

``state' = state * exp(dt * -exp(A_log)) + dt * (B outer x)`` and
``y = C . state' + D * x`` per (sequence, head), with the float32 state
read once and written once. Port of ``repro/kernels/ssd_decode.py::
ssd_decode_kernel``; the plain version is the math of
``repro/kernels/ref.py::ssd_decode_ref``. ``D * x`` is added in float32
before y is cast to x's dtype, as both do.

The CUDA kernel updates ``state`` in place and returns it as the new state
(JAX returns a new array); the plain version returns a new tensor. A
wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def ssd_decode_plain(state, x, dt, a_log, b, c, d):
    """state (B, H, N, P) float32; x (B, H, P); dt (B, H); a_log, d (H,);
    b, c (B, N). Returns (y (B, H, P) in x's dtype, new state float32)."""
    dt = dt.float()
    a = torch.exp(dt * (-torch.exp(a_log.float()))[None, :])
    upd = torch.einsum("bh,bN,bhp->bhNp", dt, b.float(), x.float())
    new_state = state * a[:, :, None, None] + upd
    y = torch.einsum("bN,bhNp->bhp", c.float(), new_state)
    y = y + d.float()[None, :, None] * x.float()
    return y.to(x.dtype), new_state


def _check(state, x, dt, a_log, b, c, d):
    if state.device.type != "cuda":
        raise ValueError(f"the SSD decode kernel runs on CUDA tensors, got {state.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the SSD decode kernel takes float32/bfloat16 x, got {x.dtype}")
    B, H, N, P = state.shape
    want = {"state": (state, (B, H, N, P)), "dt": (dt, (B, H)), "a_log": (a_log, (H,)),
            "b": (b, (B, N)), "c": (c, (B, N)), "d": (d, (H,))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or t.device != state.device \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be contiguous float32 {shape} on the state's "
                             f"device, got {t.dtype} {tuple(t.shape)}")
    if tuple(x.shape) != (B, H, P) or x.device != state.device or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (B, H, P) = {(B, H, P)}, got {tuple(x.shape)}")
    if P > 256:
        raise ValueError(f"headdim {P} > 256 is not supported by the kernel")


def ssd_decode_kernel(state, x, dt, a_log, b, c, d):
    """Layout as ``ssd_decode_plain``. For CUDA tensors the kernel runs and
    ``state`` is updated in place and returned as the new state; for CPU
    tensors the plain version runs."""
    if state.device.type == "cpu":
        return ssd_decode_plain(state, x, dt, a_log, b, c, d)
    _check(state, x, dt, a_log, b, c, d)
    B, H, N, P = state.shape
    y = torch.empty_like(x)
    fn = build.bind("ssd_decode.cu", "ssd_decode", 8, 4)
    err = fn(build.DTYPE_CODES[str(x.dtype).split(".")[1]], state.data_ptr(),
             x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
             d.data_ptr(), y.data_ptr(), B, H, N, P,
             torch.cuda.current_stream(state.device).cuda_stream)
    build.check(err, "ssd_decode")
    build.launch_counts["ssd_decode"] += 1
    return y, state
