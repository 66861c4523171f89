"""Parameters: the seeded initialiser and the bridge from numpy trees.

The tree has the reference's nesting (``repro/models/model.py::model_specs``):
``embed.table``, ``segments[i].blocks[j].{norm1, mixer, norm2, ffn}``,
``final_norm.scale`` and ``lm_head.table``; every leaf under a segment has a
leading stacked ``layers`` axis, so layer i of a segment is ``leaf[i]``.

* :func:`init_model` draws a fresh tree from its own ``torch.Generator``
  with the reference's init kinds (``normal`` scaled by 1/sqrt(fan-in),
  ``small_normal`` = 0.02, ``ones``, ``zeros``, and the Mamba-2 ``ssm_a`` /
  ``ssm_dt``) and dtypes (router and the SSM's A_log / D / dt_bias in
  float32). Its numbers differ from ``jax.random``'s for the same seed.
* :func:`from_numpy_tree` converts a tree of numpy arrays — e.g. the JAX
  package's parameters passed through ``np.asarray`` — into the port's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DENSE, MAMBA, MOE, NONE, ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: str
    init: str = "normal"       # normal | small_normal | ones | zeros | ssm_a | ssm_dt


def _dense(d_in, d_out, pd, bias=False):
    out = {"kernel": Spec((d_in, d_out), pd)}
    if bias:
        out["bias"] = Spec((d_out,), pd, "zeros")
    return out


def mamba_specs(cfg: ModelConfig) -> dict:
    """The Mamba-2 mixer (``repro/models/ssm.py::mamba_specs``): in_proj
    emits z, xBC and dt; a depthwise causal conv over xBC; per-head A_log,
    D and dt_bias in float32; a gated RMSNorm over d_inner; out_proj."""
    s, d, pd = cfg.ssm, cfg.d_model, cfg.param_dtype
    d_in, nheads = s.d_inner(d), s.nheads(d)
    conv_dim = d_in + 2 * s.ngroups * s.d_state
    d_proj = 2 * d_in + 2 * s.ngroups * s.d_state + nheads
    return {"in_proj": Spec((d, d_proj), pd),
            "conv_w": Spec((s.d_conv, conv_dim), pd),
            "conv_b": Spec((conv_dim,), pd, "zeros"),
            "A_log": Spec((nheads,), "float32", "ssm_a"),
            "D": Spec((nheads,), "float32", "ones"),
            "dt_bias": Spec((nheads,), "float32", "ssm_dt"),
            "norm": {"scale": Spec((d_in,), pd, "ones")},
            "out_proj": Spec((d_in, d), pd)}


def _block_specs(cfg: ModelConfig, kind) -> dict:
    d, hd, pd = cfg.d_model, cfg.resolved_head_dim, cfg.param_dtype
    if kind.mixer == MAMBA:
        return _ffn_specs(cfg, kind, {"norm1": {"scale": Spec((d,), pd, "ones")},
                                      "mixer": mamba_specs(cfg)})
    mixer = {"wq": _dense(d, cfg.num_heads * hd, pd, cfg.attn_bias),
             "wk": _dense(d, cfg.num_kv_heads * hd, pd, cfg.attn_bias),
             "wv": _dense(d, cfg.num_kv_heads * hd, pd, cfg.attn_bias),
             "wo": _dense(cfg.num_heads * hd, d, pd)}
    if cfg.qk_norm:
        mixer["q_norm"] = {"scale": Spec((hd,), pd, "ones")}
        mixer["k_norm"] = {"scale": Spec((hd,), pd, "ones")}
    return _ffn_specs(cfg, kind, {"norm1": {"scale": Spec((d,), pd, "ones")},
                                  "mixer": mixer})


def _ffn_specs(cfg: ModelConfig, kind, specs: Dict[str, Any]) -> dict:
    """Add norm2 and the FFN (dense or MoE); a block with ffn NONE has
    neither, as in the reference."""
    d, pd = cfg.d_model, cfg.param_dtype
    if kind.ffn != NONE and not cfg.parallel_block:
        specs["norm2"] = {"scale": Spec((d,), pd, "ones")}
    if kind.ffn == DENSE:
        specs["ffn"] = {"wi_gate": Spec((d, cfg.d_ff), pd),
                        "wi_up": Spec((d, cfg.d_ff), pd),
                        "wo": Spec((cfg.d_ff, d), pd)}
    elif kind.ffn == MOE:
        m = cfg.moe
        specs["ffn"] = {"router": Spec((d, m.num_experts), "float32", "small_normal"),
                        "wo": Spec((m.num_experts, m.d_ff_expert, d), pd),
                        "wi_gate": Spec((m.num_experts, d, m.d_ff_expert), pd),
                        "wi_up": Spec((m.num_experts, d, m.d_ff_expert), pd)}
    return specs


def _stack(tree, n: int):
    if isinstance(tree, Spec):
        return Spec((n,) + tree.shape, tree.dtype, tree.init)
    if isinstance(tree, tuple):
        return tuple(_stack(v, n) for v in tree)
    return {k: _stack(v, n) for k, v in tree.items()}


def model_specs(cfg: ModelConfig) -> dict:
    """The parameter tree as :class:`Spec` leaves (gated SwiGLU FFNs, no
    shared experts — the architectures the port serves)."""
    assert cfg.gated_ffn and not (cfg.moe and cfg.moe.num_shared_experts), \
        "the port serves gated FFNs without shared experts"
    specs: Dict[str, Any] = {
        "embed": {"table": Spec((cfg.vocab_size, cfg.d_model), cfg.param_dtype,
                                "small_normal")},
        "segments": tuple(
            _stack({"blocks": tuple(_block_specs(cfg, k) for k in seg.pattern)},
                   seg.repeats) for seg in cfg.segments),
        "final_norm": {"scale": Spec((cfg.d_model,), cfg.param_dtype, "ones")},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"table": Spec((cfg.vocab_size, cfg.d_model),
                                          cfg.param_dtype, "small_normal")}
    return specs


def _materialize(spec: Spec, gen: torch.Generator, device) -> torch.Tensor:
    dtype = DTYPES[spec.dtype]
    if spec.init == "ssm_a":         # A_log = log of uniform [1, 16] (Mamba-2)
        u = torch.rand(spec.shape, generator=gen, device=device) * 15.0 + 1.0
        return torch.log(u).to(dtype)
    if spec.init == "ssm_dt":        # inverse softplus of log-uniform [1e-3, 0.1]
        u = torch.rand(spec.shape, generator=gen, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = 0.02 if spec.init == "small_normal" else 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    # one leading slice at a time bounds the float32 staging buffer
    for i in range(spec.shape[0] if len(spec.shape) >= 3 else 1):
        dst = out[i] if len(spec.shape) >= 3 else out
        src = torch.randn(dst.shape, generator=gen, device=device, dtype=torch.float32)
        dst.copy_(src.mul_(std))
    return out


def tree_map(tree, fn):
    """``fn`` over the leaves of a tree of dicts / tuples / lists, keeping
    its nesting (a :class:`Spec` is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        return type(tree)(tree_map(v, fn) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a tree of dicts / tuples / lists, in its order."""
    out = []
    tree_map(tree, out.append)
    return out


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters at ``cfg``'s widths, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_model(device='cuda') but no CUDA device is "
                           "available; pass device='cpu' explicitly")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tree_map(model_specs(cfg), lambda s: _materialize(s, gen, device))


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")                 # writable, contiguous copy
    if a.dtype.name == "bfloat16":             # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_numpy_tree(tree, device="cuda"):
    """Convert a parameter tree of numpy arrays (dicts / tuples / lists of
    arrays, the reference's nesting) into the port's tensors on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_numpy_tree(device='cuda') but no CUDA device "
                           "is available; pass device='cpu' explicitly")
    return tree_map(tree, lambda a: _to_tensor(a, device))
