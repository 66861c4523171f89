"""Step builders for sharded runs and the dry run.

Port of ``repro/launch/steps.py`` over ``torch.distributed`` device meshes,
with DTensor (``Shard``/``Replicate`` placements, ``redistribute``) where
the reference has GSPMD shardings. Each builder returns the step, its
input stand-ins (``meta`` tensors) and its input and output placements:

  * ``make_train_step``   — microbatched gradient accumulation in float32,
    then the port's AdamW (remat per ``RunConfig``; with
    ``grad_compression="int8_ef"`` on a "pod" mesh dimension, the int8
    error-feedback cross-pod mean on each device's local shards);
  * ``make_prefill_step`` — whole prompts through ``prefill`` into a fresh
    dense cache (the serving compute path);
  * ``make_serve_step``   — one decode token against the cache (the
    bandwidth path; the duplex MoE's plain route when the plan says so).

Every step runs under a ``sharding_context`` (the models' logical
constraints resolve against the cell's rules) and DTensor's
``implicit_replication`` (tensors the models make, such as positions and
masks, are replicated). Parameters, optimizer state, batch and cache are
placed by ``placements(fit_pspec_to_shape(resolve_pspec(axes, rules),
shape, mesh))``. The kernels are off, as in the reference's steps.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core.execution import ExecutionPlan
from repro_torch.launch.specs import (batch_axes, batch_specs, cache_axes,
                                      cell_input_axes, cell_input_specs, decode_max_len)
from repro_torch.models.attention import POS_EMPTY
from repro_torch.models.model import decode_step, init_cache, loss_fn, prefill
from repro_torch.models.params import (abstract_params, logical_axes, model_specs,
                                       tree_leaves, tree_map)
from repro_torch.sharding.rules import (fit_pspec_to_shape, is_axes, mesh_sizes,
                                        placements, resolve_pspec, rules_for,
                                        sharding_context)
from repro_torch.training.optimizer import OptConfig, adamw_update


def build_rules(cfg: ModelConfig, shape: ShapeConfig, mesh, run: RunConfig) -> Dict[str, Any]:
    sizes = mesh_sizes(mesh)
    multi_pod = "pod" in sizes
    model_ways = sizes["model"]
    rules = rules_for(shape.kind, shape.global_batch, multi_pod=multi_pod,
                      moe_sharding=(run.moe_sharding if run.moe_sharding != "auto"
                                    else ("auto" if multi_pod else "tp")))
    batch_axes_ = ("pod", "data") if multi_pod else ("data",)
    if shape.kind == "decode":
        if shape.global_batch == 1:
            # long-context decode: context parallelism, the KV sequence over
            # every axis (the batch cannot shard)
            rules["act_batch"] = None
            rules["act_kv_seq"] = batch_axes_ + ("model",)
            rules["act_kv_heads"] = None
        else:
            rules["act_batch"] = batch_axes_ if len(batch_axes_) > 1 else batch_axes_[0]
            if cfg.num_kv_heads % model_ways == 0:
                # TP attention: KV heads shard cleanly
                rules["act_kv_heads"] = "model"
                rules["act_kv_seq"] = None
            else:
                # context-parallel fallback: shard the cache sequence instead
                rules["act_kv_heads"] = None
                rules["act_kv_seq"] = "model"
    else:
        rules["act_batch"] = batch_axes_ if len(batch_axes_) > 1 else batch_axes_[0]
        if run.seq_shard_activations:
            # sequence parallelism: activations shard their sequence over model
            rules["act_seq"] = "model"
    return rules


def dispatch_grid(mesh, rules) -> tuple:
    """(batch-shard, seq-shard) tile counts of the hierarchical MoE dispatch,
    mirroring the activation layout the rules produce."""
    sizes = mesh_sizes(mesh)

    def ways(rule):
        if rule is None:
            return 1
        w = 1
        for a in ((rule,) if isinstance(rule, str) else rule):
            w *= sizes[a]
        return w

    return (ways(rules.get("act_batch")), ways(rules.get("act_seq")))


def _map(fn, tree, is_leaf, *others):
    """``fn(leaf, *other leaves)`` over ``tree``'s leaves (``is_leaf``) and
    the parallel ``others``; a None in ``tree`` (a host scalar's
    placements) passes the first other's leaf through."""
    if tree is None:
        return others[0] if others else None
    if is_leaf(tree):
        return fn(tree, *others)
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf, *(o[k] for o in others)) for k, v in tree.items()}
    return type(tree)(_map(fn, v, is_leaf, *(o[i] for o in others))
                      for i, v in enumerate(tree))


def _is_pl(x) -> bool:
    from torch.distributed.tensor import Placement
    return isinstance(x, tuple) and all(isinstance(p, Placement) for p in x)


def leaf_placements(mesh, rules, axes, shape) -> tuple:
    return placements(fit_pspec_to_shape(resolve_pspec(axes, rules), shape, mesh), mesh)


def tree_placements(mesh, rules, axes_tree, spec_tree):
    """The placements tree of (logical axes, stand-ins)."""
    return _map(lambda a, s: leaf_placements(mesh, rules, a, s.shape), axes_tree, is_axes,
                spec_tree)


def distribute_tree(tree, placements_tree, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` with its placements,
    every rank taking its own shard of the (identical) full tensor it
    holds, with no communication; DTensors are redistributed."""
    from torch.distributed.tensor import distribute_tensor

    def one(pl, t):
        if hasattr(t, "redistribute"):
            return t.redistribute(mesh, pl)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return _map(one, placements_tree, _is_pl, tree)


def empty_like_specs(spec_tree, placements_tree, mesh):
    """DTensors of the stand-ins' global shapes and dtypes, allocated as
    local shards only (under ``FakeTensorMode``, not at all)."""
    from torch.distributed.tensor import empty
    return _map(lambda pl, s: empty(tuple(s.shape), dtype=s.dtype, device_mesh=mesh,
                                    placements=pl), placements_tree, _is_pl, spec_tree)


def sharded_cache(spec, pl, mesh):
    """``init_cache``'s dense cache (``spec``: its ``meta`` stand-ins, made
    once when the step is built) as DTensors placed ``pl``, made shard by
    shard: "pos" holds the empty marker, every other leaf zeros."""
    from torch.distributed.tensor import full

    def fill(tree, pls):
        if isinstance(tree, dict):
            return {k: (full(tuple(v.shape), POS_EMPTY if k == "pos" else 0,
                             dtype=v.dtype, device_mesh=mesh, placements=pls[k])
                        if isinstance(v, torch.Tensor) else fill(v, pls[k]))
                    for k, v in tree.items()}
        return type(tree)(fill(t, p) for t, p in zip(tree, pls))

    return fill(spec, pl)


def _micro(x, i: int, n: int):
    """Rows [i*B/n, (i+1)*B/n) of x, the reference's microbatch split; a
    DTensor sharded by batch is gathered along it first and the slice
    placed as x was."""
    mb = x.shape[0] // n
    if not hasattr(x, "redistribute") or not any(p.is_shard(0) for p in x.placements):
        return x[i * mb:(i + 1) * mb]
    from torch.distributed.tensor import Replicate
    whole = x.redistribute(x.device_mesh, [Replicate() if p.is_shard(0) else p
                                           for p in x.placements])
    return whole[i * mb:(i + 1) * mb].redistribute(x.device_mesh, x.placements)


def auto_num_micro(cfg: ModelConfig, shape: ShapeConfig, mesh, run: RunConfig, *,
                   target_bytes: float = 1.2e9) -> int:
    """The microbatch count: the smallest n (dividing GB, with GB/n still
    divisible by the data ways when possible) whose per-device saved
    residual estimate fits the target."""
    if run.microbatch_size:
        return max(1, shape.global_batch // run.microbatch_size)
    sizes = mesh_sizes(mesh)
    dp = sizes["data"] * sizes.get("pod", 1)
    mp = sizes["model"] if run.seq_shard_activations else 1
    S = shape.seq_len if not cfg.is_encoder_decoder else shape.seq_len // 2
    per_seq = cfg.num_layers * S * cfg.d_model * 2 / mp
    moe_per_seq = 0.0
    if cfg.moe is not None:
        m = cfg.moe
        moe_per_seq = S * m.top_k * m.capacity_factor * cfg.d_model * 2 * 2
    n = 1
    while n < shape.global_batch:
        mb = shape.global_batch // n
        if mb % dp == 0 and (mb / dp) * (per_seq + moe_per_seq) <= target_bytes:
            break
        n *= 2
    return min(n, max(shape.global_batch // dp, 1))


def _plan(mesh, rules, run: RunConfig, **kw) -> ExecutionPlan:
    return ExecutionPlan(use_kernels=False, dispatch_grid=dispatch_grid(mesh, rules),
                         attn_q_block=run.attn_q_block, attn_kv_block=run.attn_kv_block,
                         attn_score_bf16=run.attn_score_bf16, **kw)


def _context(mesh, rules):
    from contextlib import ExitStack

    from torch.distributed.tensor.experimental import implicit_replication
    stack = ExitStack()
    stack.enter_context(sharding_context(mesh, rules))
    stack.enter_context(implicit_replication())
    return stack


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh, run: RunConfig,
                    opt: OptConfig):
    """Returns (step(state, batch) -> (state, metrics), in_specs, in_placements,
    out_placements, n_micro, rules). The state is {"params", "opt": {"mu",
    "nu", "count"}, "step"} (and "ef_err" with compression) as
    ``training/train_state.py`` makes it; the step updates it in place and
    returns it. metrics: "loss", "grad_norm" (replicated) and "lr"."""
    rules = build_rules(cfg, shape, mesh, run)
    n_micro = auto_num_micro(cfg, shape, mesh, run)
    use_compression = run.grad_compression == "int8_ef" and "pod" in mesh_sizes(mesh)
    specs = model_specs(cfg)
    paxes = logical_axes(specs)
    plan = _plan(mesh, rules, run, moe_impl="grouped")
    ab_params = abstract_params(specs)
    param_pl = tree_placements(mesh, rules, paxes, ab_params)
    param_pls = []
    _map(param_pls.append, param_pl, _is_pl)

    def accumulate(acc, grads):
        out = []
        for a, g, pl in zip(acc, grads, param_pls):
            g = g.float()
            if hasattr(g, "redistribute") and tuple(g.placements) != pl:
                g = g.redistribute(mesh, pl)
            out.append(g if a is None else a + g)
        return out

    def train_step(state, batch):
        with _context(mesh, rules):
            params = state["params"]
            leaves = tree_leaves(params)
            if n_micro == 1:
                loss, _ = loss_fn(params, cfg, batch, plan=plan, remat=run.remat_policy)
                acc = accumulate([None] * len(leaves), torch.autograd.grad(loss, leaves))
            else:
                acc, loss = [None] * len(leaves), None
                for i in range(n_micro):
                    mb = {k: _micro(v, i, n_micro) for k, v in batch.items()}
                    l, _ = loss_fn(params, cfg, mb, plan=plan, remat=run.remat_policy)
                    acc = accumulate(acc, torch.autograd.grad(l, leaves))
                    l = l.detach()
                    loss = l if loss is None else loss + l
                acc = [a / n_micro for a in acc]
                loss = loss / n_micro
            it = iter(acc)
            grads = tree_map(params, lambda _: next(it))
            new_state = {}
            if use_compression:
                grads, new_state["ef_err"] = _cross_pod_int8(grads, state["ef_err"], mesh)
            _, new_opt, om = adamw_update(params, grads, state["opt"], opt,
                                          step=state["step"])
            new_state.update(params=params, opt=new_opt, step=state["step"] + 1)
            return new_state, {"loss": loss.detach(), **om}

    f32 = lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta")
    ab_state = {"params": ab_params,
                "opt": {"mu": tree_map(ab_params, f32), "nu": tree_map(ab_params, f32),
                        "count": 0},
                "step": 0}
    state_pl = {"params": param_pl, "opt": {"mu": param_pl, "nu": param_pl, "count": None},
                "step": None}
    if use_compression:
        ab_state["ef_err"] = tree_map(ab_params, f32)
        state_pl["ef_err"] = param_pl
    b_specs = batch_specs(cfg, shape)
    batch_pl = tree_placements(mesh, rules, batch_axes(cfg, shape), b_specs)
    rep = leaf_placements(mesh, rules, (), ())
    in_specs = (ab_state, b_specs)
    return (train_step, in_specs, (state_pl, batch_pl),
            (state_pl, {"loss": rep, "grad_norm": rep, "lr": None}), n_micro, rules)


def _cross_pod_int8(grads, err, mesh):
    """The reference's int8 error-feedback cross-pod mean: its ``shard_map``
    takes each gradient replicated over "pod" (a leaf sharded there, the
    experts under EP, is gathered first) and its scale over the whole
    tensor. Each leaf runs ``training/compression.py::cross_pod_mean_int8``
    on its local shard with the max-reduce spanning the mesh dimensions
    that shard it, and the results are placed back as the gradients were;
    the error state stays with its shards."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.training.compression import cross_pod_mean_int8
    names = tuple(mesh.mesh_dim_names)
    pod = names.index("pod")

    def one(g, e):
        pl = [Replicate() if i == pod else p for i, p in enumerate(g.placements)]
        groups = [mesh.get_group(names[i]) for i, p in enumerate(pl) if p.is_shard()]
        mean_l, err_l = cross_pod_mean_int8(g.redistribute(mesh, pl).to_local(),
                                            e.redistribute(mesh, pl).to_local(), mesh,
                                            axis="pod", scale_groups=groups)
        wrap = lambda t: DTensor.from_local(t, mesh, pl, run_check=False).redistribute(
            mesh, g.placements)
        return wrap(mean_l), wrap(err_l)

    pairs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    means, errs = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return tree_map(grads, lambda _: next(means)), tree_map(grads, lambda _: next(errs))


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh, run: RunConfig):
    """Returns (step(params, batch) -> (next_tok (B,), cache), in_specs,
    in_placements, out_placements, rules)."""
    rules = build_rules(cfg, shape, mesh, run)
    plan = _plan(mesh, rules, run, moe_impl="grouped")
    max_len = decode_max_len(cfg, shape)
    B = shape.global_batch

    cache_spec = init_cache(cfg, B, max_len, device="meta")
    cache_pl = tree_placements(mesh, rules, cache_axes(cfg), cache_spec)

    def prefill_step(params, batch):
        with _context(mesh, rules), torch.no_grad():
            cache = sharded_cache(cache_spec, cache_pl, mesh)
            true_len = batch.get("true_len")
            if true_len is None:
                key = "dec_tokens" if cfg.is_encoder_decoder else "tokens"
                true_len = torch.full((B,), batch[key].shape[1], dtype=torch.int32,
                                      device=batch[key].device)
            logits, cache = prefill(params, cfg, batch, cache, true_len, plan=plan)
            return _next_tokens(logits), cache

    specs = model_specs(cfg)
    ab_params = abstract_params(specs)
    params_pl = tree_placements(mesh, rules, logical_axes(specs), ab_params)
    b_specs = batch_specs(cfg, shape)
    batch_pl = tree_placements(mesh, rules, batch_axes(cfg, shape), b_specs)
    tok_pl = leaf_placements(mesh, rules, ("act_batch",), (B,))
    return (prefill_step, (ab_params, b_specs), (params_pl, batch_pl), (tok_pl, cache_pl),
            rules)


def _next_tokens(logits):
    """Greedy tokens (B,) int32 at the last position; a DTensor's vocab is
    gathered first (an argmax over a sharded dim has no shard-local
    answer)."""
    last = logits[:, -1]
    if hasattr(last, "device_mesh") and any(p.is_shard(1) for p in last.placements):
        from torch.distributed.tensor import Replicate
        last = last.redistribute(last.device_mesh, [Replicate() if p.is_shard(1) else p
                                                    for p in last.placements])
    return torch.argmax(last, dim=-1).to(torch.int32)


def duplex_k_cold(cfg: ModelConfig, num_tokens: int) -> int:
    """The planner's static cold-expert count for a decode stage of
    ``num_tokens`` (uniform expected routing, paper section VI)."""
    if cfg.moe is None:
        return 0
    import numpy as np

    from repro_torch.core.costmodel import DUPLEX
    from repro_torch.core.partition import DuplexPlanner, build_luts
    m = cfg.moe
    lut_x, lut_p = build_luts(DUPLEX, cfg.d_model, m.d_ff_expert,
                              max_tokens=max(num_tokens * m.top_k, 64))
    planner = DuplexPlanner(lut_x, lut_p, m.num_experts)
    rng = np.random.default_rng(0)
    counts = rng.multinomial(num_tokens * m.top_k,
                             np.full(m.num_experts, 1.0 / m.num_experts))
    return planner.k_cold_static(counts)


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh, run: RunConfig, *,
                    moe_impl: str = "duplex"):
    """Returns (step(params, batch, cache) -> (next_tok (B,), cache),
    in_specs, in_placements, out_placements, plan, rules). The cache is
    updated in place."""
    rules = build_rules(cfg, shape, mesh, run)
    k_cold = duplex_k_cold(cfg, shape.global_batch) if moe_impl == "duplex" else 0
    plan = ExecutionPlan(moe_impl="duplex" if k_cold > 0 else "grouped", k_cold=k_cold,
                         use_kernels=False, dispatch_grid=dispatch_grid(mesh, rules))
    kv_quant = run.kv_quant
    B = shape.global_batch

    def serve_step(params, batch, cache):
        with _context(mesh, rules), torch.no_grad():
            tokens = batch["tokens"]
            valid = torch.ones((B,), dtype=torch.bool, device=tokens.device)
            logits, cache, _ = decode_step(params, cfg, tokens, cache, {"valid": valid},
                                           plan=plan)
            return _next_tokens(logits), cache

    specs = model_specs(cfg)
    ab_params = abstract_params(specs)
    params_pl = tree_placements(mesh, rules, logical_axes(specs), ab_params)
    cell = cell_input_specs(cfg, shape, kv_quant=kv_quant)
    cell_ax = cell_input_axes(cfg, shape, kv_quant=kv_quant)
    batch_pl = tree_placements(mesh, rules, cell_ax["batch"], cell["batch"])
    cache_pl = tree_placements(mesh, rules, cell_ax["cache"], cell["cache"])
    tok_pl = leaf_placements(mesh, rules, ("act_batch",), (B,))
    return (serve_step, (ab_params, cell["batch"], cell["cache"]),
            (params_pl, batch_pl, cache_pl), (tok_pl, cache_pl), plan, rules)


def make_cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh, run: RunConfig,
                   opt: Optional[OptConfig] = None, *, moe_impl: str = "duplex"):
    """One entry point for the dry run: (fn, in_specs, in_placements,
    out_placements, meta)."""
    if shape.kind == "train":
        fn, specs, in_pl, out_pl, n_micro, _ = make_train_step(
            cfg, shape, mesh, run, opt or OptConfig())
        return fn, specs, in_pl, out_pl, {"kind": "train", "n_micro": n_micro}
    if shape.kind == "prefill":
        fn, specs, in_pl, out_pl, _ = make_prefill_step(cfg, shape, mesh, run)
        return fn, specs, in_pl, out_pl, {"kind": "prefill"}
    fn, specs, in_pl, out_pl, plan, _ = make_serve_step(cfg, shape, mesh, run,
                                                        moe_impl=moe_impl)
    return fn, specs, in_pl, out_pl, {"kind": "decode", "k_cold": plan.k_cold,
                                      "moe_impl": plan.moe_impl}
