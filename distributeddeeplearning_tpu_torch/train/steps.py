"""The train and eval steps: counterparts of ``make_dp_train_step``'s
replicated branch (no ZeRO) in ``distributeddeeplearning_tpu/train/
steps.py``, with ``accumulated_grads``, and of its ``make_dp_eval_step``
and ``make_token_eval_step``. Without a process group the step runs one
replica on one card; with one (``parallel/process_group.py``) each rank
holds a full replica and its shard of the global batch.

Forward, loss, backward, optional global-norm clip and the optimizer
update. The loss follows the model's objective, as the JAX package's
``_image_loss_fn``/``_token_loss_fn``/``_causal_loss_fn`` do:
label-smoothed cross entropy for image models (whose train-mode forward
also updates the BatchNorm running buffers), masked-LM loss for BERT (over
the dense ``labels``, or the gather head's ``masked_positions`` and
``masked_labels``), causal-LM loss for the other token models. Dropout
draws from a CPU generator seeded by (seed, step, rank, microbatch)
(``dropout_rng``), as the JAX DP step folds the rank and the step into its
dropout key and ``accumulated_grads`` the microbatch index, so a resumed
run drops what an unbroken one would and no two ranks or microbatches
drop the same positions.

Token models under ``dp`` are the JAX package's ``make_gspmd_train_step``
on a mesh with only the data axis: one logical step over the global
batch, whose loss is the mean over the global batch's scored tokens (the
masked positions of BERT, the predicted real tokens of a causal LM), not
the mean of the ranks' means. So each microbatch's counts are summed over
the ranks (one small all-reduce a step, before any forward), each rank
backpropagates its sum of token losses over that global count times the
world size, and the gradients' sum all-reduce followed by the division by
the world size gives the gradient of the global mean; the reported loss is
that global mean. Microbatch i is rows i of each rank's shard (the
shard-local grouping, ``split_microbatches`` on each rank): the grouping
the comment in JAX's ``make_gspmd_train_step`` reports GSPMD realised,
though JAX's step on a CPU mesh takes consecutive rows of the global
batch. The two differ only under both ``dp`` and accumulation, when the
microbatches' counts differ. Image losses are per-example means over
equal shards, so their ranks' mean is the global mean already.

A step, in the JAX step's order:

1. **gradients** (``accumulated_grads``): backward on the loss (times the
   loss scale when scaling); with ``grad_accum_steps`` > 1 the shard's
   batch splits into that many microbatches whose gradients are summed
   and divided once, the BatchNorm running buffers updated in sequence
   through them and the metrics averaged over them;
2. **data parallelism**: the bucketed all-reduce of the gradients
   (``parallel/collectives.py``, by ``config.allreduce``; an explicit
   precision policy sets the payload to its ``reduce_dtype``), then
   division by the world size;
3. **dynamic loss scaling** (``PrecisionPolicy.loss_scale`` > 0): the
   overflow check on the reduced, still scaled gradients (a non-finite
   squared norm, ``tree_sq_norm``), then division by the scale; an
   overflow skips the update and ``next_loss_scale`` halves the scale,
   ``growth_interval`` good steps double it;
4. **data parallelism**: the metrics and the running buffers are averaged
   over the ranks;
5. **the bad-step guard** (``bad_step_guard``): a non-finite (averaged)
   loss or (reduced) gradient skips the update and reports ``bad_step``;
   it is not armed on a step the scaler already skipped. Both read values
   every rank holds alike, so every rank skips together;
6. **update or skip**: a skip keeps the parameters, the optimizer state
   (and so its count, ``TrainState.updates``, which the schedule reads),
   the BatchNorm running buffers (restored from a copy taken before the
   forward) and the EMA; ``step`` still advances. Whether to skip is read
   on the host, one wait for the device a step, as ``torch.amp.
   GradScaler`` does;
7. **the EMA** (``optimizer.ema_decay`` > 0): ``e <- d * e + (1 - d) * p``
   after each applied update, over the parameters only.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from distributeddeeplearning_tpu_torch.config import (
    PrecisionPolicy, TrainConfig, resolve_precision)
from distributeddeeplearning_tpu_torch.data.synthetic import step_seed
from distributeddeeplearning_tpu_torch.models import model_spec
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.parallel.process_group import (
    DataParallel)
from distributeddeeplearning_tpu_torch.train.losses import (
    causal_lm_loss_sums, causal_lm_weights, mlm_loss_sums,
    smoothed_softmax_ce, top1_accuracy)
from distributeddeeplearning_tpu_torch.train.optim import (
    Schedule, clip_by_global_norm_)
from distributeddeeplearning_tpu_torch.train.state import TrainState

_DROPOUT_STREAM = 1  # keeps dropout draws apart from the data's


def dropout_rng(seed: int, step: int, rank: int = 0,
                micro: int = 0) -> torch.Generator:
    """The CPU generator every dropout site of step ``step`` draws its seed
    from, on rank ``rank``'s microbatch ``micro``. Rank 0's microbatch 0
    draws from the generator of (seed, step) alone, which a one-card step
    without accumulation has always used; any other rank or microbatch
    folds both into the seed, as the JAX step folds the rank index and
    ``accumulated_grads`` the microbatch index into the key."""
    fold = () if rank == 0 and micro == 0 else (rank, micro)
    return torch.Generator().manual_seed(
        step_seed(seed, step, _DROPOUT_STREAM, *fold))


def init_loss_scale(config: TrainConfig, device) -> Optional[dict]:
    """The dynamic loss scale's initial ``{"scale", "good_steps"}``
    (float32 and int32 scalars on ``device``) when the policy arms scaling,
    else None."""
    policy = resolve_precision(config)
    if policy.loss_scale <= 0:
        return None
    return {"scale": torch.tensor(policy.loss_scale, dtype=torch.float32,
                                  device=device),
            "good_steps": torch.zeros((), dtype=torch.int32, device=device)}


def next_loss_scale(policy: PrecisionPolicy, scale: torch.Tensor,
                    good_steps: torch.Tensor, overflow: torch.Tensor
                    ) -> tuple[dict, dict]:
    """The dynamic-scale automaton (JAX ``_next_loss_scale``): an overflow
    halves the scale, floored at ``loss_scale_min``; ``growth_interval``
    consecutive good steps double it, capped at ``loss_scale_max``. Returns
    (new state, metrics ``loss_scale`` and ``loss_scale_skip``)."""
    good = good_steps + 1
    grow = good >= policy.loss_scale_growth_interval
    new_scale = torch.where(
        overflow, torch.clamp_min(scale * 0.5, policy.loss_scale_min),
        torch.where(grow, torch.clamp_max(scale * 2.0,
                                          policy.loss_scale_max), scale))
    new_good = torch.where(overflow | grow, torch.zeros_like(good), good)
    return ({"scale": new_scale, "good_steps": new_good},
            {"loss_scale": new_scale,
             "loss_scale_skip": overflow.to(torch.float32)})


def tree_sq_norm(tensors) -> torch.Tensor:
    """The squared norm of all ``tensors`` in float32: finite iff every
    element is (a sum that overflows float32 flags too)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.stack(norms).square().sum()


def ema_init(model) -> dict[str, torch.Tensor]:
    """The EMA's start: a float32 copy of the parameters."""
    return {n: p.detach().float().clone()
            for n, p in model.named_parameters()}


def ema_update_(ema: dict, model, decay: float) -> None:
    """``e <- d * e + (1 - d) * p`` in place, with d and 1 - d rounded to
    float32 as the JAX package's ``_ema_update`` takes them."""
    d = np.float32(decay)
    names = list(ema)
    params = dict(model.named_parameters())
    shadow = [ema[n] for n in names]
    torch._foreach_mul_(shadow, float(d))
    torch._foreach_add_(shadow, [params[n].detach() for n in names],
                        alpha=float(np.float32(1.0) - d))


def allreduce_options(config: TrainConfig):
    """The run's all-reduce options: ``config.allreduce``, its payload
    dtype replaced by an explicit precision policy's ``reduce_dtype``."""
    if config.precision is None:
        return config.allreduce
    return dataclasses.replace(config.allreduce,
                               dtype=resolve_precision(config).reduce_dtype)


def split_microbatches(batch: dict, accum: int) -> list[dict]:
    """``batch`` as ``accum`` equal microbatches of consecutive rows
    (views, no copy), as the JAX step reshapes its leading dimension."""
    if accum <= 1:
        return [batch]
    rows = next(iter(batch.values())).shape[0] // accum
    return [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            for i in range(accum)]


def takes_rng(model) -> bool:
    """Whether ``model``'s forward takes the dropout generator ``rng``."""
    return "rng" in inspect.signature(type(model).forward).parameters


def gather_head(batch: dict) -> dict:
    """BERT's gather-head argument: the batch's ``masked_positions``, when
    it has them (the JAX steps pass them the same way)."""
    if "masked_positions" in batch:
        return {"masked_positions": batch["masked_positions"]}
    return {}


def mlm_labels(batch: dict):
    """The masked-LM targets: ``masked_labels`` of a gathered batch, else
    the dense ``labels``."""
    return batch.get("masked_labels", batch.get("labels"))


def token_count(batch: dict, mlm: bool) -> torch.Tensor:
    """The positions a token loss scores in ``batch``, as a float32 scalar
    on its device: the masked-LM targets, or the causal LM's predictions
    whose query and target are both real tokens. Known before the
    forward."""
    if mlm:
        return (mlm_labels(batch) >= 0).float().sum()
    return causal_lm_weights(batch["input_ids"],
                             batch.get("attention_mask")).sum()


def make_train_step(config: TrainConfig, schedule: Schedule,
                    dp: Optional[DataParallel] = None
                    ) -> Callable[[TrainState, dict], dict]:
    """``train_step(state, batch) -> {"loss", "lr", ...}``: one step of
    ``state`` in place on ``batch`` (this rank's shard under ``dp``).
    ``loss`` (unscaled, averaged over microbatches and ranks; a token
    model's is each microbatch's mean over every rank's scored tokens) and
    ``accuracy`` (image models) stay device tensors; ``lr`` is the rate of
    this step's update (of the update it would have made, when skipped).
    With loss scaling the metrics add ``loss_scale`` and
    ``loss_scale_skip``, with the guard ``bad_step``."""
    clip = config.optimizer.grad_clip_norm
    smoothing = config.optimizer.label_smoothing
    ema_decay = config.optimizer.ema_decay
    spec = model_spec(config.model)
    image = spec.input_kind == "image"
    policy = resolve_precision(config)
    scaling = policy.loss_scale > 0
    guard = config.bad_step_guard
    accum = max(config.grad_accum_steps, 1)
    options = allreduce_options(config)
    mlm = spec.objective == "mlm"
    rank = 0 if dp is None else dp.rank

    def forward(model, step: int, batch: dict, micro: int, count) -> dict:
        """The microbatch ``micro``'s loss: an image model's mean, or a
        token model's sum over ``count``, the microbatch's scored
        positions over every rank (times the world size under ``dp``)."""
        if image:
            # A ViT's dropout draws from the generator; a CNN has none.
            kw = ({"rng": dropout_rng(config.seed, step, rank, micro)}
                  if takes_rng(model) else {})
            logits = model(batch["image"], **kw)
            return {"loss": smoothed_softmax_ce(logits, batch["label"],
                                                smoothing),
                    "accuracy": top1_accuracy(logits.detach(),
                                              batch["label"])}
        ids, mask = batch["input_ids"], batch.get("attention_mask")
        rng = dropout_rng(config.seed, step, rank, micro)
        if mlm:
            logits = model(ids, attention_mask=mask, rng=rng,
                           **gather_head(batch))
            total, _ = mlm_loss_sums(logits, mlm_labels(batch))
        else:
            logits = model(ids, attention_mask=mask, rng=rng)
            total, _ = causal_lm_loss_sums(logits, ids, mask)
        loss = total / count
        return {"loss": loss if dp is None else loss * dp.world}

    def token_counts(micros: list) -> list:
        """Each microbatch's scored positions, summed over the ranks under
        ``dp`` (one all-reduce of ``accum`` floats), clamped at 1."""
        counts = torch.stack([token_count(m, mlm) for m in micros])
        if dp is not None:
            collectives.psum_(counts)
        return list(counts.clamp_min(1.0))

    def accumulated_grads(state: TrainState, batch: dict) -> dict:
        """Backward on each microbatch's loss (times the scale), summed
        into ``.grad`` and divided once; the metrics' mean."""
        model = state.model
        scale = state.loss_scale["scale"] if scaling else None
        micros = split_microbatches(batch, accum)
        counts = [None] * accum if image else token_counts(micros)
        outs = []
        for i, (micro, count) in enumerate(zip(micros, counts)):
            metrics = forward(model, state.step, micro, i, count)
            loss = metrics["loss"]
            (loss * scale if scaling else loss).backward()
            outs.append({k: v.detach() for k, v in metrics.items()})
        if accum == 1:
            return outs[0]
        torch._foreach_div_([p.grad for p in model.parameters()
                             if p.grad is not None], accum)
        return {k: torch.stack([o[k] for o in outs]).mean() for k in outs[0]}

    def train_step(state: TrainState, batch: dict) -> dict:
        model, opt = state.model, state.optimizer
        buffers = saved = None
        if scaling or guard:
            buffers = list(model.buffers())
            saved = [b.detach().clone() for b in buffers]
        opt.zero_grad(set_to_none=True)
        metrics = accumulated_grads(state, batch)
        named = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        grads = list(named.values())
        if dp is not None:
            collectives.all_reduce_gradients(named, options=options)
            torch._foreach_div_(grads, dp.world)
        skip = None
        if scaling:
            scale = state.loss_scale["scale"]
            overflow = ~torch.isfinite(tree_sq_norm(grads))
            torch._foreach_div_(grads, scale)
            state.loss_scale, ls_metrics = next_loss_scale(
                policy, scale, state.loss_scale["good_steps"], overflow)
            skip = overflow
        if dp is not None:
            pmean_([*metrics.values(), *(b for b in model.buffers()
                                         if b.is_floating_point())],
                   dp.world)
        if scaling:
            metrics.update(ls_metrics)
        if guard:
            bad = ~torch.isfinite(metrics["loss"]) | ~torch.isfinite(
                tree_sq_norm(grads))
            if scaling:
                bad = bad & ~overflow
            metrics["bad_step"] = bad.to(torch.float32)
            skip = bad if skip is None else skip | bad
        lr = schedule(state.updates)
        if skip is not None and bool(skip):
            with torch.no_grad():
                torch._foreach_copy_(buffers, saved)
        else:
            if clip:
                clip_by_global_norm_(grads, clip)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            state.updates += 1
            if state.ema is not None:
                ema_update_(state.ema, model, ema_decay)
        state.step += 1
        return {**metrics, "lr": lr}

    return train_step


def pmean_(tensors: list, world: int) -> None:
    """Each floating tensor of ``tensors`` replaced in place by its mean
    over the ranks: one sum all-reduce of their float32 concatenation,
    divided by ``world``."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def _eval_forward(state: TrainState, *args, **kwargs):
    """The model in eval mode on ``args``, with the EMA's parameters in
    place of the live ones when the state keeps an EMA (the live BatchNorm
    running buffers either way); the model's mode is restored after."""
    model = state.model
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            if state.ema is not None:
                return functional_call(model, state.ema, args, kwargs)
            return model(*args, **kwargs)
    finally:
        model.train(was_training)


def make_eval_step(config: TrainConfig, dp: Optional[DataParallel] = None
                   ) -> Callable[[TrainState, dict], dict]:
    """Held-out top-1 of an image model: ``eval_step(state, batch) ->
    {"correct", "total"}`` (device int64 scalars) with the running
    statistics (eval mode) and, when kept, the EMA parameters. Under ``dp``
    each rank scores its shard and both counts are summed over the ranks
    before anyone divides, as ``make_dp_eval_step`` psums them."""
    del config

    def eval_step(state: TrainState, batch: dict) -> dict:
        logits = _eval_forward(state, batch["image"])
        label = batch["label"]
        counts = torch.stack([(logits.argmax(dim=-1) == label).sum(),
                              torch.tensor(label.shape[0],
                                           device=label.device)])
        if dp is not None:
            dist.all_reduce(counts)
        return {"correct": counts[0], "total": counts[1]}

    return eval_step


def make_token_eval_step(config: TrainConfig, objective: str = "causal",
                         dp: Optional[DataParallel] = None
                         ) -> Callable[[TrainState, dict], dict]:
    """Held-out LM loss: ``eval_step(state, batch) -> {"loss_sum",
    "count"}``, masked-LM sums for the ``mlm`` objective (BERT) and
    causal-LM sums otherwise, as JAX ``make_token_eval_step`` takes them,
    with dropout off and, when kept, the EMA parameters, so the mean over
    any number of batches is exact. Under ``dp`` each rank scores its rows
    and both sums are summed over the ranks (one all-reduce)."""
    del config
    mlm = objective == "mlm"

    def eval_step(state: TrainState, batch: dict) -> dict:
        ids, mask = batch["input_ids"], batch.get("attention_mask")
        if mlm:
            logits = _eval_forward(state, ids, attention_mask=mask,
                                   **gather_head(batch))
            total, count = mlm_loss_sums(logits, mlm_labels(batch))
        else:
            logits = _eval_forward(state, ids, attention_mask=mask)
            total, count = causal_lm_loss_sums(logits, ids, mask)
        if dp is not None:
            total, count = collectives.psum_(torch.stack([total, count]))
        return {"loss_sum": total, "count": count}

    return eval_step
