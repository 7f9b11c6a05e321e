"""Optimizers and learning-rate schedules: counterpart of
``distributeddeeplearning_tpu/train/optim.py`` for the optimizers the
one-card slices carry (sgd with momentum, adamw) and global-norm clipping.

The JAX package builds optax chains; the port builds ``torch.optim``
optimizers whose parameter groups reproduce the same update:

- ``chain(add_decayed_weights(wd, mask), sgd(lr, momentum))`` is
  ``torch.optim.SGD`` with ``weight_decay=wd`` in the decayed group and 0 in
  the other: both add ``wd * p`` to the gradient before the momentum trace
  ``t = g + momentum * t`` and step ``p - lr * t``;
- ``optax.adamw(..., mask=)`` is ``torch.optim.AdamW`` with the same group
  split: both step ``p - lr * (adam(g) + wd * p)``;
- the decay mask (``_decay_mask``) decays only leaves whose flax name is
  ``kernel`` or contains ``embedding``: Dense and Conv weights. GPT's
  ``wte``/``wpe``, Llama's ``embed_tokens``, biases and norm scales
  (BatchNorm's too) are not decayed;
- the schedule is read at the update's count, from 0: with warmup the first
  update has learning rate 0, as optax's ``scale_by_schedule`` gives it.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch
from torch import nn

from distributeddeeplearning_tpu_torch.config import OptimizerConfig
from distributeddeeplearning_tpu_torch.utils.weights import flax_leaf

Schedule = Callable[[int], float]


def scaled_lr(cfg: OptimizerConfig, global_batch: int) -> float:
    """Linear-scaling rule: lr = base_lr * batch / reference_batch."""
    return cfg.learning_rate * global_batch / cfg.reference_batch


def _polynomial(init: float, end: float, power: float,
                steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac ** power + end
    return schedule


def _cosine(init: float, decay_steps: int) -> Schedule:
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init * 0.5 * (1 + math.cos(math.pi * count / decay_steps))
    return schedule


def _join(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, later in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = later(count - boundary)
        return out
    return schedule


def make_schedule(cfg: OptimizerConfig, global_batch: int,
                  total_steps: int) -> Schedule:
    """The learning rate of update ``count`` (0-based), as the JAX
    package's optax schedule of the same name gives it for a run without an
    epoch length: warmup over 5% of the steps."""
    peak = scaled_lr(cfg, global_batch)
    warmup = min(max(int(0.05 * total_steps), 1), max(total_steps - 1, 1))
    if cfg.schedule == "constant":
        return lambda count: peak
    if cfg.schedule == "linear":
        return _join([_polynomial(0.0, peak, 1, warmup),
                      _polynomial(peak, 0.0, 1, max(total_steps - warmup, 1))],
                     [warmup])
    if cfg.schedule == "warmup_cosine":
        decay_steps = max(total_steps, warmup + 1)
        return _join([_polynomial(0.0, peak, 1, warmup),
                      _cosine(peak, decay_steps - warmup)], [warmup])
    if cfg.schedule == "warmup_poly":
        return _join([_polynomial(0.0, peak, 1, warmup),
                      _polynomial(peak, 0.0, 2, max(total_steps - warmup, 1))],
                     [warmup])
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def decays(name: str, param: torch.Tensor) -> bool:
    """``_decay_mask``: True for leaves whose flax name is ``kernel`` or
    contains ``embedding``."""
    leaf = flax_leaf(name, param.dim())
    return leaf == "kernel" or "embedding" in leaf


def param_groups(model: nn.Module, weight_decay: float) -> list[dict]:
    """Two groups: the decayed leaves with ``weight_decay``, the rest with
    none."""
    named = list(model.named_parameters())
    return [
        {"params": [p for n, p in named if decays(n, p)],
         "weight_decay": weight_decay},
        {"params": [p for n, p in named if not decays(n, p)],
         "weight_decay": 0.0},
    ]


def make_optimizer(cfg: OptimizerConfig, model: nn.Module, global_batch: int,
                   total_steps: int
                   ) -> tuple[torch.optim.Optimizer, Schedule]:
    """The optimizer over ``model``'s parameters and its schedule. The
    caller sets each group's ``lr`` to ``schedule(count)`` before update
    ``count`` (train/steps.py)."""
    sched = make_schedule(cfg, global_batch, total_steps)
    groups = param_groups(model, cfg.weight_decay)
    if cfg.name == "sgd":
        opt = torch.optim.SGD(groups, lr=0.0, momentum=cfg.momentum,
                              nesterov=False)
    elif cfg.name == "adamw":
        opt = torch.optim.AdamW(groups, lr=0.0, betas=(cfg.beta1, cfg.beta2),
                                eps=cfg.eps)
    elif cfg.name in ("lars", "lamb"):
        raise NotImplementedError(
            f"optimizer {cfg.name!r} (layer-wise trust ratios for large "
            f"batches) comes with the data-parallel slice; use sgd or adamw")
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    return opt, sched


def clip_by_global_norm_(grads: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: when the global norm g of all
    gradients reaches ``max_norm``, each becomes (t / g) * max_norm. Stays
    on the device (no host read). Returns g."""
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm
