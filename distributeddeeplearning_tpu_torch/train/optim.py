"""Optimizers and learning-rate schedules: counterpart of
``distributeddeeplearning_tpu/train/optim.py`` on one card (sgd with
momentum, lars, adamw, lamb), global-norm clipping and the staged batch
ramp.

The JAX package builds optax chains; the port builds ``torch.optim``
optimizers whose parameter groups reproduce the same update:

- ``chain(add_decayed_weights(wd, mask), sgd(lr, momentum))`` is
  ``torch.optim.SGD`` with ``weight_decay=wd`` in the decayed group and 0 in
  the other: both add ``wd * p`` to the gradient before the momentum trace
  ``t = g + momentum * t`` and step ``p - lr * t``;
- ``optax.adamw(..., mask=)`` is ``torch.optim.AdamW`` with the same group
  split: both step ``p - lr * (adam(g) + wd * p)``;
- ``optax.lars`` is :class:`Lars` and ``optax.lamb`` is :class:`Lamb`,
  optimizers of this module that follow optax's chains in their order (a
  torch optimizer of that name would not: torch's momentum holds
  gradients, optax's trace holds lr-scaled updates);
- the decay mask (``_decay_mask``) decays only leaves whose flax name is
  ``kernel`` or contains ``embedding``: Dense and Conv weights. GPT's
  ``wte``/``wpe``, Llama's ``embed_tokens``, biases and norm scales
  (BatchNorm's too) are not decayed; LARS takes its trust ratio on the same
  leaves;
- the schedule is read at the update's count, from 0: with warmup the first
  update has learning rate 0, as optax's ``scale_by_schedule`` gives it.
  The count is the optimizer's own (``TrainState.updates``): a skipped
  update does not advance it, as optax's count stays in the restored
  optimizer state.

The trust-ratio norms are ``torch._foreach_norm``: the JAX package computes
them in XLA, not in a kernel of its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from distributeddeeplearning_tpu_torch.config import OptimizerConfig
from distributeddeeplearning_tpu_torch.utils.weights import flax_leaf

Schedule = Callable[[int], float]


def scaled_lr(cfg: OptimizerConfig, global_batch: int) -> float:
    """Linear-scaling rule: lr = base_lr * batch / reference_batch."""
    return cfg.learning_rate * global_batch / cfg.reference_batch


# Staged global-batch ramp: the loop (train/loop.py ``run_ramp``) splits
# the horizon into stages, each a run segment at its own batch whose lr
# follows the linear-scaling rule, resuming from the previous stage's
# checkpoint. Every boundary lands on the checkpoint cadence, so a stage
# transition is an ordinary resume.

@dataclasses.dataclass(frozen=True)
class RampStage:
    """One stage of a staged batch ramp: run ``[start_step, end_step)`` at
    ``batch`` examples per optimizer step (``end_step=None`` = to the
    horizon)."""

    batch: int
    start_step: int
    end_step: Optional[int]


def parse_batch_ramp(spec: Optional[str], *, final_batch: int,
                     checkpoint_every: int) -> Optional[list[RampStage]]:
    """Parse a ``batch:steps,...,batch`` ramp spec into stages.

    ``"8192:600,16384:600,32768"`` = 600 steps at 8192, 600 at 16384, then
    32768 to the horizon. Every stage but the last carries a step count and
    the last must not; the last stage's batch must equal ``final_batch``;
    batches must be positive and non-decreasing; every boundary must be a
    multiple of ``checkpoint_every`` (when positive).

    Returns None for an absent spec or a single stage at the final batch.
    """
    if not spec:
        return None
    stages: list[RampStage] = []
    parts = [s.strip() for s in spec.split(",") if s.strip()]
    if not parts:
        raise ValueError(f"batch_ramp {spec!r}: empty spec")
    step = 0
    for i, part in enumerate(parts):
        last = i == len(parts) - 1
        if ":" in part:
            if last:
                raise ValueError(
                    f"batch_ramp {spec!r}: the last stage must not carry a "
                    f"step count (it runs to the horizon)")
            b_str, n_str = part.split(":", 1)
            try:
                batch, n = int(b_str), int(n_str)
            except ValueError:
                raise ValueError(f"batch_ramp {spec!r}: stage {part!r} is "
                                 f"not 'batch:steps'") from None
            if n < 1:
                raise ValueError(f"batch_ramp {spec!r}: stage {part!r} must "
                                 f"run >= 1 step")
            stages.append(RampStage(batch=batch, start_step=step,
                                    end_step=step + n))
            step += n
        else:
            if not last:
                raise ValueError(
                    f"batch_ramp {spec!r}: only the last stage may omit "
                    f":steps (got {part!r} at position {i})")
            try:
                batch = int(part)
            except ValueError:
                raise ValueError(f"batch_ramp {spec!r}: stage {part!r} is "
                                 f"not an int batch") from None
            stages.append(RampStage(batch=batch, start_step=step,
                                    end_step=None))
    for st in stages:
        if st.batch < 1:
            raise ValueError(f"batch_ramp {spec!r}: batch {st.batch} < 1")
    for a, b in zip(stages, stages[1:]):
        if b.batch < a.batch:
            raise ValueError(
                f"batch_ramp {spec!r}: batches must be non-decreasing "
                f"(got {a.batch} -> {b.batch}); a ramp shrinks the step "
                f"count, never the batch")
    if stages[-1].batch != final_batch:
        raise ValueError(
            f"batch_ramp {spec!r}: final stage batch {stages[-1].batch} != "
            f"global_batch_size {final_batch} — the ramp describes how to "
            f"reach the configured batch, not a different one")
    if checkpoint_every > 0:
        for st in stages[:-1]:
            if st.end_step % checkpoint_every:
                raise ValueError(
                    f"batch_ramp {spec!r}: boundary at step {st.end_step} "
                    f"is not a multiple of checkpoint_every_steps="
                    f"{checkpoint_every} — stage transitions must ride an "
                    f"existing checkpoint save so resume and elastic "
                    f"re-formation compose unchanged")
    if len(stages) == 1:
        return None
    return stages


def ramp_final_batch(config) -> int:
    """The batch the run ends at: ``global_batch_size``, or, inside a ramp
    stage's segment (whose ``global_batch_size`` is the stage's), the
    ramp's final batch."""
    spec = config.batch_ramp
    if not spec:
        return config.global_batch_size
    last = [s.strip() for s in spec.split(",") if s.strip()][-1]
    try:
        return int(last.split(":", 1)[0])
    except ValueError:
        return config.global_batch_size


def ramp_describe(config) -> str:
    """The ramp spec, or ``none``."""
    return config.batch_ramp or "none"


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
                  total_steps: int,
                  steps_per_epoch: Optional[int] = None) -> Schedule:
    """The learning rate of update ``count`` (0-based), as the JAX
    package's optax schedule of the same name gives it: warmup over
    ``warmup_epochs`` epochs of ``steps_per_epoch`` steps, or over 5% of
    the steps when the run has no epoch length, and at most the run's
    length less one step."""
    peak = scaled_lr(cfg, global_batch)
    warmup = (int(cfg.warmup_epochs * steps_per_epoch) if steps_per_epoch
              else max(int(0.05 * total_steps), 1))
    warmup = min(warmup, max(total_steps - 1, 1))
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


def _with_grads(group: dict) -> tuple[list, list]:
    params = [p for p in group["params"] if p.grad is not None]
    return params, [p.grad for p in params]


def _trust_scaled(updates: list, params: list, coefficient: float,
                  eps: float) -> list:
    """``optax.scale_by_trust_ratio`` on each leaf: the update times
    coefficient * |p| / (|u| + eps), or times 1 where |p| or |u| is 0."""
    p_norm = torch.stack(torch._foreach_norm(params))
    u_norm = torch.stack(torch._foreach_norm(updates))
    ratio = coefficient * p_norm / (u_norm + eps)
    ratio = torch.where((p_norm == 0) | (u_norm == 0),
                        torch.ones_like(ratio), ratio)
    return torch._foreach_mul(updates, list(ratio.unbind()))


class Lars(torch.optim.Optimizer):
    """``optax.lars``: ``add_decayed_weights(wd)``, then
    ``scale_by_trust_ratio(trust_coefficient, eps)`` on the groups with
    ``trust_ratio``, then ``scale_by_learning_rate``, then ``trace
    (momentum)`` without Nesterov: the trace holds lr-scaled updates and is
    added to the parameters as it stands."""

    def __init__(self, params, lr: float = 0.0, momentum: float = 0.9,
                 trust_coefficient: float = 0.001, eps: float = 0.0):
        super().__init__(params, dict(
            lr=lr, momentum=momentum, trust_coefficient=trust_coefficient,
            eps=eps, weight_decay=0.0, trust_ratio=True))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Lars.step takes no closure")
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            wd = group["weight_decay"]
            u = torch._foreach_add(grads, params, alpha=wd) if wd else grads
            if group["trust_ratio"]:
                u = _trust_scaled(u, params, group["trust_coefficient"],
                                  group["eps"])
            u = torch._foreach_mul(u, -group["lr"])
            traces = []
            for p in params:
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p)
                traces.append(state["trace"])
            torch._foreach_mul_(traces, group["momentum"])
            torch._foreach_add_(traces, u)
            torch._foreach_add_(params, traces)


class Lamb(torch.optim.Optimizer):
    """``optax.lamb``: ``scale_by_adam`` (bias-corrected, eps outside the
    root), then ``add_decayed_weights(wd)``, then ``scale_by_trust_ratio``
    with coefficient 1 on every parameter, then ``scale_by_learning_rate``.
    The count of the bias correction is the optimizer's, kept per
    parameter as ``step``."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=0.0))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Lamb.step takes no closure")
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            b1, b2 = group["betas"]
            mu, nu = [], []
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                mu.append(state["exp_avg"])
                nu.append(state["exp_avg_sq"])
            count = self.state[params[0]]["step"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            # optax's bias corrections, in float32.
            bc1 = float(np.float32(1.0) - np.float32(b1) ** count)
            bc2 = float(np.float32(1.0) - np.float32(b2) ** count)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, group["eps"])
            u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if group["weight_decay"]:
                u = torch._foreach_add(u, params, alpha=group["weight_decay"])
            u = _trust_scaled(u, params, 1.0, 0.0)
            torch._foreach_add_(params, torch._foreach_mul(u, -group["lr"]))


def check_ema_decay(cfg: OptimizerConfig) -> None:
    if not 0.0 <= cfg.ema_decay < 1.0:
        raise ValueError(
            f"ema_decay={cfg.ema_decay}: need 0 <= decay < 1 "
            f"(1.0 would freeze the shadow params at init "
            f"forever; evals would score random weights)")


def make_optimizer(cfg: OptimizerConfig, model: nn.Module, global_batch: int,
                   total_steps: int, steps_per_epoch: Optional[int] = None
                   ) -> tuple[torch.optim.Optimizer, Schedule]:
    """The optimizer over ``model``'s parameters and its schedule. The
    caller sets each group's ``lr`` to ``schedule(count)`` before update
    ``count`` (train/steps.py)."""
    check_ema_decay(cfg)
    sched = make_schedule(cfg, global_batch, total_steps, steps_per_epoch)
    groups = param_groups(model, cfg.weight_decay)
    if cfg.name == "sgd":
        opt = torch.optim.SGD(groups, lr=0.0, momentum=cfg.momentum,
                              nesterov=False)
    elif cfg.name == "adamw":
        opt = torch.optim.AdamW(groups, lr=0.0, betas=(cfg.beta1, cfg.beta2),
                                eps=cfg.eps)
    elif cfg.name == "lars":
        # The trust ratio is masked as the decay is: decayed group only.
        groups[1]["trust_ratio"] = False
        opt = Lars(groups, momentum=cfg.momentum,
                   trust_coefficient=cfg.trust_coefficient)
    elif cfg.name == "lamb":
        opt = Lamb(groups, betas=(cfg.beta1, cfg.beta2), eps=cfg.eps)
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
