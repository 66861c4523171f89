"""The port's trainer, from the command line.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-moe --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --reduced --steps 20

Port of ``repro/launch/train.py``: the same flags, plus ``--device`` (the
card by default; ``cpu`` runs the kernels' plain versions). ``--ckpt-dir``
raises ``NotImplementedError`` (checkpoints are not ported yet).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import resolve_config
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.execution import ExecutionPlan
from repro_torch.models.model import loss_fn
from repro_torch.models.params import init_model, tree_leaves, tree_map
from repro_torch.training.data import DataConfig, SyntheticLMData
from repro_torch.training.loop import LoopConfig, train_loop
from repro_torch.training.optimizer import OptConfig, adamw_update
from repro_torch.training.train_state import make_train_state

TRAIN_PLAN = ExecutionPlan(moe_impl="grouped", use_kernels=True)


def make_step(cfg: ModelConfig, opt: OptConfig, run: RunConfig,
              plan: ExecutionPlan = TRAIN_PLAN):
    """``step(state, batch) -> (state, metrics)``: the loss and its
    gradients by autograd, then AdamW, in place on the state's tensors.
    The plan runs the grouped MoE and, with ``use_kernels``, the flash
    kernels (their plain versions for CPU tensors). metrics: "loss" (a
    device scalar), "grad_norm" (a device scalar) and "lr" (a float)."""

    def step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        loss, _ = loss_fn(params, cfg, batch, plan=plan, remat=run.remat_policy)
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(params, lambda _: next(grads))
        _, opt_state, om = adamw_update(params, grads, state["opt"], opt,
                                        step=state["step"])
        return ({"params": params, "opt": opt_state, "step": state["step"] + 1},
                {"loss": loss.detach(), **om})

    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="tiny-moe")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where to train: the card (default) or cpu")
    args = p.parse_args(argv)

    cfg = resolve_config(args.arch, args.reduced)
    opt = OptConfig(learning_rate=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 10, 1))
    state = make_train_state(init_model(cfg, seed=args.seed, device=args.device), opt)
    data = SyntheticLMData(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed))

    def batch_fn(step):
        return {"tokens": torch.from_numpy(data.batch_at(step)["tokens"]).to(args.device)}

    step_fn = make_step(cfg, opt, RunConfig(remat_policy="none"))
    loop = train_loop(state, step_fn, batch_fn,
                      LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                                 ckpt_every=args.ckpt_every))
    first = np.mean(loop.losses[:5]) if loop.losses else float("nan")
    last = np.mean(loop.losses[-5:]) if loop.losses else float("nan")
    print(f"[train] {cfg.name}: steps={loop.step} loss {first:.3f} -> "
          f"{last:.3f} stragglers={loop.stragglers}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
