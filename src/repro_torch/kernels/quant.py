"""The one int8 recipe of the port: abs-max / 127 steps with a 1e-8 scale
floor, over the last axis. Port of ``repro/kernels/__init__.py::
int8_quantize``, bit for bit: the scale is ``amax / 127`` floored at 1e-8,
the values are ``round(x / scale)`` (a division, not a multiplication by a
reciprocal; ``torch.round`` rounds half to even as ``jnp.round`` does),
clamped to +-127. The KV pools (``models/attention.py::quantize_kv``), the
int8 attention kernels' q and p*v requantization (``csrc/decode_attn.cu``)
and their plain versions all quantize with it."""
from __future__ import annotations

import torch


def int8_quantize(x, *, keepdims: bool = False):
    """x (..., n) -> (int8 values (..., n), float32 scale (...) or (..., 1)
    with ``keepdims``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiplication by its reciprocal, off by one ulp for some amax
    scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, (scale if keepdims else scale[..., 0])
