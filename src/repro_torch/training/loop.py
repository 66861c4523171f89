"""Fault-tolerant training loop.

Port of ``repro/training/loop.py``:

  * checkpoint/restart: atomic keep-k checkpoints (``training/checkpoint.py``)
    every ``ckpt_every`` steps and at the last step, restored at start from
    the newest one in ``ckpt_dir`` onto the state's devices (elastic: a
    checkpoint written on the card restores on the CPU and the reverse);
    ``async_ckpt`` writes them on a background thread;
  * SIGTERM/SIGINT-safe: a signal asks for a checkpoint at the next step
    boundary, then the loop stops (preemption);
  * straggler watchdog: a per-step wall-time EWMA; steps slower than
    ``straggler_factor`` x the EWMA are logged and counted.

Each step's wall time ends in ``float(metrics["loss"])``, which waits for
the device, as the reference's does.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from repro_torch.training.checkpoint import (AsyncCheckpointer, latest_checkpoint,
                                             restore_checkpoint, save_checkpoint)


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    async_ckpt: bool = False      # background-thread saves (overlap with steps)
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2


@dataclass
class LoopState:
    step: int = 0
    ewma_step_s: float = 0.0
    stragglers: int = 0
    losses: List[float] = field(default_factory=list)
    interrupted: bool = False


def train_loop(state, step_fn: Callable, batch_fn: Callable[[int], Any], cfg: LoopConfig,
               *, state_template=None, log: Callable[[str], None] = print) -> LoopState:
    """Run ``step_fn(state, batch) -> (state, metrics)`` up to
    ``cfg.total_steps``, ``batch_fn(step)`` giving each batch. With a
    checkpoint in ``cfg.ckpt_dir`` it resumes from the newest one, copied
    into the tensors of ``state_template`` (default ``state`` itself, so a
    resume holds one copy of the state on the device)."""
    loop = LoopState()
    start = 0
    if cfg.ckpt_dir and latest_checkpoint(cfg.ckpt_dir) is not None:
        state, start = restore_checkpoint(
            cfg.ckpt_dir, state if state_template is None else state_template)
        loop.step = start
        log(f"[loop] restored step {start} from {cfg.ckpt_dir}")

    async_ck = (AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
                if cfg.ckpt_dir and cfg.async_ckpt else None)
    stop_requested = {"flag": False}
    prev_handlers = {}

    def _handler(signum, frame):
        stop_requested["flag"] = True
        log(f"[loop] signal {signum}: checkpoint-and-exit at next boundary")

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _handler)
        except ValueError:   # not the main thread (tests)
            pass

    try:
        for step in range(start, cfg.total_steps):
            t0 = time.monotonic()
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            loop.step = step + 1
            loop.losses.append(loss)
            if loop.ewma_step_s == 0.0:
                loop.ewma_step_s = dt
            else:
                if dt > cfg.straggler_factor * loop.ewma_step_s:
                    loop.stragglers += 1
                    log(f"[loop] straggler step {step}: {dt:.3f}s vs "
                        f"EWMA {loop.ewma_step_s:.3f}s")
                loop.ewma_step_s = ((1 - cfg.ewma_alpha) * loop.ewma_step_s
                                    + cfg.ewma_alpha * dt)
            if step % cfg.log_every == 0:
                log(f"[loop] step {step} loss {loss:.4f} ({dt:.3f}s)")
            boundary = (cfg.ckpt_dir and
                        ((step + 1) % cfg.ckpt_every == 0
                         or step + 1 == cfg.total_steps
                         or stop_requested["flag"]))
            if boundary:
                if async_ck is not None:
                    async_ck.save(step + 1, state)
                else:
                    save_checkpoint(cfg.ckpt_dir, step + 1, state, keep=cfg.keep)
            if stop_requested["flag"]:
                loop.interrupted = True
                break
    finally:
        if async_ck is not None:
            async_ck.wait()
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
    return loop
