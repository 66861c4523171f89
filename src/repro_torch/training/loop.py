"""Training loop with a straggler watchdog and signal handling.

Port of ``repro/training/loop.py`` without checkpoints (a ``ckpt_dir``
raises ``NotImplementedError``; ``training/checkpoint.py`` is not ported
yet):

  * SIGTERM/SIGINT-safe: a signal stops the loop at the next step
    boundary;
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


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
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
               *, log: Callable[[str], None] = print) -> LoopState:
    """Run ``step_fn(state, batch) -> (state, metrics)`` for
    ``cfg.total_steps`` steps, ``batch_fn(step)`` giving each batch."""
    if cfg.ckpt_dir:
        raise NotImplementedError(
            "checkpointing (ckpt_dir) is not ported yet; training/checkpoint.py comes "
            "with the next training slice (ROADMAP queue 1)")
    loop = LoopState()
    stop_requested = {"flag": False}
    prev_handlers = {}

    def _handler(signum, frame):
        stop_requested["flag"] = True
        log(f"[loop] signal {signum}: stopping at the next step boundary")

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _handler)
        except ValueError:   # not the main thread (tests)
            pass

    try:
        for step in range(cfg.total_steps):
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
            if stop_requested["flag"]:
                loop.interrupted = True
                break
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
    return loop
