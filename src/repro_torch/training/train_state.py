"""Train state: parameters, optimizer moments and the step.

Port of ``repro/training/train_state.py::make_train_state``. The reference
draws the parameters from a key; the port takes a parameter tree (from
``models/params.py::init_model`` on the card, or ``from_numpy_tree`` of the
reference's in the tests), marks its leaves as taking gradients, and adds
the AdamW state. The step is a host integer.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.models.params import trainable
from repro_torch.training.optimizer import OptConfig, init_opt_state


def make_train_state(params, opt: OptConfig) -> Dict[str, Any]:
    params = trainable(params)
    return {"params": params, "opt": init_opt_state(params, opt), "step": 0}
