"""The train step: the one-card counterpart of the replicated branch of
``make_dp_train_step`` (``distributeddeeplearning_tpu/train/steps.py``) with
one data-parallel replica, no ZeRO, no loss scaling and no bad-step guard.

Forward, loss, backward, optional global-norm clip and the optimizer
update. The loss follows the model's input kind, as the JAX package's
``_image_loss_fn``/``_token_loss_fn`` do: label-smoothed cross entropy for
image models (whose train-mode forward also updates the BatchNorm running
buffers), causal-LM loss for token models. Dropout draws from a CPU
generator seeded by (seed, step), as the JAX step folds the step into its
dropout key, so a resumed run drops what an unbroken one would.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data.synthetic import step_seed
from distributeddeeplearning_tpu_torch.models import model_spec
from distributeddeeplearning_tpu_torch.train.losses import (
    causal_lm_loss, smoothed_softmax_ce, top1_accuracy)
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
    """``train_step(state, batch) -> {"loss", "lr"}`` (and ``accuracy``
    for image models): one update of ``state`` in place. ``loss`` and
    ``accuracy`` stay device tensors (reading them waits for the device);
    ``lr`` is the rate this update used."""
    clip = config.optimizer.grad_clip_norm
    smoothing = config.optimizer.label_smoothing
    image = model_spec(config.model).input_kind == "image"

    def forward(model, step: int, batch: dict) -> dict:
        if image:
            logits = model(batch["image"])
            return {"loss": smoothed_softmax_ce(logits, batch["label"],
                                                smoothing),
                    "accuracy": top1_accuracy(logits.detach(),
                                              batch["label"])}
        ids, mask = batch["input_ids"], batch.get("attention_mask")
        logits = model(ids, attention_mask=mask,
                       rng=dropout_rng(config.seed, step))
        return {"loss": causal_lm_loss(logits, ids, mask)}

    def train_step(state: TrainState, batch: dict) -> dict:
        model, opt = state.model, state.optimizer
        metrics = forward(model, state.step, batch)
        loss = metrics["loss"]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if clip:
            clip_by_global_norm_((p.grad for p in model.parameters()), clip)
        lr = schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return {**metrics, "loss": loss.detach(), "lr": lr}

    return train_step
