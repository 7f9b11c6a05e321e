"""Train state: counterpart of ``distributeddeeplearning_tpu/train/state.py``
for one card.

``step`` counts finished steps (consumed batches); ``updates`` counts the
updates the optimizer applied, which a skipped step (a loss-scale overflow
or a bad step) does not advance. The schedule is a pure function of
``updates`` (train/optim.py), as optax reads its own count from the
optimizer state that a skip restores. ``ema`` holds the float32 shadow
parameters (``optimizer.ema_decay`` > 0) by parameter name, ``loss_scale``
the dynamic loss scale's ``{"scale", "good_steps"}`` device scalars when the
precision policy arms it; each is None otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    updates: int = 0
    ema: Optional[dict[str, torch.Tensor]] = None
    loss_scale: Optional[dict[str, torch.Tensor]] = None

    def state_dict(self) -> dict:
        return {"step": self.step, "updates": self.updates,
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema": self.ema, "loss_scale": self.loss_scale}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.updates = int(state.get("updates", self.step))
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.ema = _copy_into(self.ema, state.get("ema"))
        self.loss_scale = _copy_into(self.loss_scale, state.get("loss_scale"))


def _copy_into(live: Optional[dict], saved: Optional[dict]
               ) -> Optional[dict]:
    """``saved``'s values in ``live``'s tensors (device and dtype kept);
    None when either is None: the run's configuration decides whether the
    state carries an EMA or a loss scale."""
    if live is None or saved is None:
        return live
    with torch.no_grad():
        for key, tensor in live.items():
            tensor.copy_(saved[key])
    return live
