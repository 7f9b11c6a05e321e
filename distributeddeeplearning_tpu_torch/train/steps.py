"""The train step: the one-card counterpart of the replicated branch of
``make_dp_train_step`` (``distributeddeeplearning_tpu/train/steps.py``) with
one data-parallel replica, no ZeRO, no loss scaling and no bad-step guard.

Forward, causal-LM loss, backward, optional global-norm clip and the
optimizer update. Dropout draws from a CPU generator seeded by (seed, step),
as the JAX step folds the step into its dropout key, so a resumed run
drops what an unbroken one would.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data.synthetic import step_seed
from distributeddeeplearning_tpu_torch.train.losses import causal_lm_loss
from distributeddeeplearning_tpu_torch.train.optim import (
    Schedule, clip_by_global_norm_)
from distributeddeeplearning_tpu_torch.train.state import TrainState

_DROPOUT_STREAM = 1  # keeps dropout draws apart from the data's


def dropout_rng(seed: int, step: int) -> torch.Generator:
    """The CPU generator every dropout site of step ``step`` draws its seed
    from."""
    return torch.Generator().manual_seed(
        step_seed(seed, step, _DROPOUT_STREAM))


def make_train_step(config: TrainConfig, schedule: Schedule
                    ) -> Callable[[TrainState, dict], dict]:
    """``train_step(state, batch) -> {"loss", "lr"}``: one update of
    ``state`` in place. ``loss`` stays a device tensor (reading it waits for
    the device); ``lr`` is the rate this update used."""
    clip = config.optimizer.grad_clip_norm

    def train_step(state: TrainState, batch: dict) -> dict:
        model, opt = state.model, state.optimizer
        ids, mask = batch["input_ids"], batch.get("attention_mask")
        logits = model(ids, attention_mask=mask,
                       rng=dropout_rng(config.seed, state.step))
        loss = causal_lm_loss(logits, ids, mask)
        del logits
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if clip:
            clip_by_global_norm_((p.grad for p in model.parameters()), clip)
        lr = schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return {"loss": loss.detach(), "lr": lr}

    return train_step
