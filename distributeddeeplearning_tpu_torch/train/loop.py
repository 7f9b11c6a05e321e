"""The training loop of the port: counterpart of
``distributeddeeplearning_tpu/train/loop.py`` for one card.

Builds the model (float32 masters, compute dtype from the config), the
optimizer and schedule, the synthetic source of the model's input kind
(token ids or images) and the checkpointer; resumes
from the newest checkpoint; runs the steps; prints one JSON metric line per
log step and returns the run summary. Throughput excludes the first
``warmup_steps`` steps (first-call and allocation costs), as the JAX loop
does.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Callable, Optional

import torch

from distributeddeeplearning_tpu_torch import resolve_device
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data.synthetic import (
    SyntheticCausalTokens, SyntheticImages)
from distributeddeeplearning_tpu_torch.models import get_model, model_spec
from distributeddeeplearning_tpu_torch.train.checkpoint import Checkpointer
from distributeddeeplearning_tpu_torch.train.optim import make_optimizer
from distributeddeeplearning_tpu_torch.train.state import TrainState
from distributeddeeplearning_tpu_torch.train.steps import make_train_step

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_state(config: TrainConfig, device
                ) -> tuple[TrainState, Callable]:
    """(state at step 0, schedule): the model in training mode on
    ``device``, initialised from ``config.seed``, and its optimizer over
    ``config.total_steps``."""
    if _is_image(config):
        kw: dict[str, Any] = {"num_classes": config.data.num_classes,
                              "fused_bn": config.fused_bn,
                              "fused_block": config.fused_block,
                              "fused_conv3": config.fused_conv3}
    else:
        kw = {"seq_len": config.data.seq_len}
        if config.attention_impl:
            kw["attention_impl"] = config.attention_impl
    # Weights from the seed alone; the caller's global RNG state is kept.
    with torch.random.fork_rng(
            devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(config.seed)
        model = get_model(config.model, dtype=_DTYPES[config.dtype],
                          device=device, **kw).train()
    opt, sched = make_optimizer(config.optimizer, model,
                                config.global_batch_size, config.total_steps)
    return TrainState(step=0, model=model, optimizer=opt), sched


def _is_image(config: TrainConfig) -> bool:
    return model_spec(config.model).input_kind == "image"


def make_source(config: TrainConfig, model, device):
    """The synthetic batches of the model's input kind."""
    if _is_image(config):
        return SyntheticImages(config.global_batch_size,
                               config.data.image_size,
                               config.data.num_classes, config.seed, device)
    return SyntheticCausalTokens(config.global_batch_size,
                                 config.data.seq_len, model.cfg.vocab_size,
                                 config.seed, device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(config: TrainConfig, *, device=None, warmup_steps: int = 2,
        emit: Callable[[str], None] = print) -> dict:
    """Train to ``config.total_steps``; returns the summary (also emitted
    as the last ``{"summary": ...}`` line). ``device``: ``cuda`` unless
    ``cpu`` is asked for."""
    total_steps = config.total_steps
    if not total_steps or total_steps <= 0:
        raise ValueError(f"total_steps must be positive (got {total_steps})")
    device = resolve_device(device)
    state, sched = build_state(config, device)
    ckpt: Optional[Checkpointer] = None
    if config.checkpoint_dir:
        ckpt = Checkpointer(config.checkpoint_dir,
                            config.checkpoint_every_steps)
        if config.resume and ckpt.restore(state):
            print(f"# resumed from step {state.step}", file=sys.stderr,
                  flush=True)
    start = state.step
    source = make_source(config, state.model, device)
    train_step = make_train_step(config, sched)
    warmup = min(warmup_steps, max(total_steps - start - 1, 0))
    metrics: dict[str, Any] = {}
    t_timed = time.perf_counter() if warmup == 0 else None
    t_last, step_last = time.perf_counter(), start
    while state.step < total_steps:
        metrics = train_step(state, source.batch(state.step))
        i = state.step
        if i - start == warmup and t_timed is None:
            _sync(device)
            t_timed = time.perf_counter()
        if ckpt is not None and i < total_steps:
            ckpt.maybe_save(state)
        if i % config.log_every == 0 or i == total_steps:
            record = {"step": i, "loss": float(metrics["loss"]),
                      "lr": metrics["lr"]}
            if "accuracy" in metrics:
                record["accuracy"] = float(metrics["accuracy"])
            now = time.perf_counter()  # float(loss) waited for the device
            dt = (now - t_last) / max(i - step_last, 1)
            record["step_time_s"] = round(dt, 6)
            record["examples_per_sec"] = round(
                config.global_batch_size / dt, 2)
            t_last, step_last = now, i
            emit(json.dumps(record))
    _sync(device)
    if ckpt is not None and total_steps > start:
        ckpt.maybe_save(state, force=True)

    summary: dict[str, Any] = {
        "final_step": state.step, "start_step": start,
        "final_metrics": {k: float(v) for k, v in metrics.items()},
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    timed_steps = total_steps - start - warmup
    if t_timed is not None and timed_steps > 0:
        elapsed = time.perf_counter() - t_timed
        examples = timed_steps * config.global_batch_size
        summary["examples_per_sec"] = examples / elapsed
        if not _is_image(config):
            summary["tokens_per_sec"] = (examples * config.data.seq_len
                                         / elapsed)
        summary["steps_per_sec"] = timed_steps / elapsed
    emit(json.dumps({"summary": summary}))
    return summary
