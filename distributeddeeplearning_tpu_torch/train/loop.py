"""The training loop of the port: counterpart of
``distributeddeeplearning_tpu/train/loop.py`` for one card, and for the
data-parallel path over a ``torch.distributed`` process group
(``torchrun``; ``parallel/process_group.py``): the JAX package's explicit
DP step for image models, its GSPMD step on a data-only mesh for token
models.

Builds the model (float32 masters, compute dtype from the precision
policy), the optimizer and schedule (warmup in epochs of
``steps_per_epoch``), the EMA and loss-scale state, the source of the
model's input kind (token ids or images: synthetic, or read from
``data.data_dir`` through ``data.make_source``, from the resumed step) and
the checkpointer, which pins the resolved loader; resumes from the newest
checkpoint; runs the steps; prints one JSON metric line per log step;
evaluates on a held-out set (synthetic, or the data's ``val/`` split or
``validation-*`` shards) every ``eval_every_epochs`` and at the end; and
returns the run summary, whose ``input_pipeline`` block holds the loader and
the seconds the steps waited for host batches.
Throughput excludes the first ``warmup_steps`` steps (first-call and
allocation costs), the evals and the final checkpoint. A ``batch_ramp``
runs as one segment a stage (``run_ramp``).

Data parallel: every rank builds the same weights from the seed and trains
on its rows of each step's global batch: rows ``[r B / N, (r + 1) B / N)``
of a synthetic batch (eval batches likewise), or a streamed source's own
rows (every N-th image or token row, from rank r); the step all-reduces
the gradients
(``train/steps.py``). Only rank 0 prints and writes checkpoints, with a
barrier after each save; every rank restores. Throughput counts the global
batch.

``profile_steps`` = (A, B) profiles steps [A, B) with ``torch.profiler``
and writes, per rank, the kernel and range totals (each bucket's
``allreduce/bucketNN`` among them) to ``profile_dir``. On the card the
summary adds the port's kernel launches over the run (``ops.
launch_counts``) and the peak device memory.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import math
import sys
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from distributeddeeplearning_tpu_torch import resolve_device
from distributeddeeplearning_tpu_torch import data as datalib
from distributeddeeplearning_tpu_torch.config import (
    TrainConfig, resolve_precision)
from distributeddeeplearning_tpu_torch.data.imagenet import (
    TRAIN_SPLIT_SIZE, folder_index)
from distributeddeeplearning_tpu_torch.models import get_model, model_spec
from distributeddeeplearning_tpu_torch.models.resnet import (
    SYNC_BN_WITH_FUSED_BN)
from distributeddeeplearning_tpu_torch.ops import launch_counts
from distributeddeeplearning_tpu_torch.parallel import process_group
from distributeddeeplearning_tpu_torch.parallel.process_group import (
    DataParallel, launch_world)
from distributeddeeplearning_tpu_torch.train import optim
from distributeddeeplearning_tpu_torch.train.checkpoint import Checkpointer
from distributeddeeplearning_tpu_torch.train.state import TrainState
from distributeddeeplearning_tpu_torch.train.steps import (
    ema_init, init_loss_scale, make_eval_step, make_token_eval_step,
    make_train_step)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Mesh axes the port refuses above 1, with the slice that brings each.
_GSPMD = "the GSPMD slice (FSDP and tensor parallelism)"
_LATER_AXES = (
    ("fsdp", None, _GSPMD),
    ("model", "--tp", _GSPMD),
    ("seq", "--sp", "ring and zigzag attention"),
    ("expert", None, "mixture-of-experts models"),
    ("pipeline", "--pp", "pipeline parallelism"),
)
_FUSED = ("fused_bn", "fused_block", "fused_conv3")
# The datasets whose epochs the port knows (config.DataConfig.dataset).
_DATASETS = ("imagenet", "mlm")
# Model families by name prefix, for the refusals' messages.
_FAMILIES = (("bert", "BERT"), ("vit", "ViT"), ("densenet", "DenseNet"),
             ("gpt", "GPT"), ("llama", "Llama"), ("resnet", "ResNet"))


def _family(model: str) -> str:
    return next((fam for prefix, fam in _FAMILIES
                 if model.startswith(prefix)), model)


def steps_per_epoch(config: TrainConfig) -> Optional[int]:
    """Explicit ``config.steps_per_epoch``, else the images of an
    image-folder ``data_dir``'s ``train/`` split over the global batch,
    else the dataset's training split over it (ImageNet: 1,281,167 images,
    for token models and token shards too, as the JAX loop counts it),
    else None."""
    if config.steps_per_epoch:
        return config.steps_per_epoch
    if config.data.data_dir:
        # The loaders' own listing, so the epoch agrees with the batches
        # they yield; a directory of token shards has no train/ split.
        try:
            n = len(folder_index(config.data.data_dir, "train")[0])
            return max(n // config.global_batch_size, 1)
        except FileNotFoundError:
            pass
    if config.data.dataset == "imagenet":
        return max(TRAIN_SPLIT_SIZE // config.global_batch_size, 1)
    return None


def check_layout(config: TrainConfig, world: Optional[int] = None) -> None:
    """Refuse a layout the port does not carry, naming the flag, the model
    and its family, and the slice that brings it. ``world``: the run's
    process-group size (None: no group, one card). Every model shards
    ``--dp`` = ``world`` ranks (1 without a group) and takes ``--accum``
    (a token model as the JAX package's GSPMD step on a data-only mesh,
    ``train/steps.py``); every other mesh axis stays 1 (FSDP and tensor
    parallelism are the GSPMD slice's); the global batch must split over
    the ranks and each shard over ``--accum``; ``--sync-bn`` needs a
    BatchNorm model without ``fused_bn`` and a process group. Also refuses
    a dataset other than ImageNet and BERT's MLM data, a model of a later
    slice (``models.LATER_MODELS``), ring or zigzag attention (the
    sequence-parallel slice) and a fused BatchNorm flag on a model without
    that path (any but a ResNet). The data source is checked apart
    (``data.check_loader``): any ``data_dir`` and loader the port reads
    splits over the ranks as a synthetic batch does."""
    family = _family(config.model)
    for axis, flag, later in _LATER_AXES:
        size = getattr(config.parallel, axis)
        if size > 1:
            name = flag or f"parallel.{axis}"
            raise ValueError(
                f"{name} {size}: {config.model} ({family}): the port shards "
                f"only the data axis; {later} comes with a later slice. Set "
                f"{name} to 1")
    if config.data.dataset not in _DATASETS:
        raise ValueError(
            f"dataset {config.data.dataset!r}: the port knows "
            f"{' and '.join(map(repr, _DATASETS))}")
    try:
        spec = model_spec(config.model)
    except KeyError as e:
        raise ValueError(e.args[0]) from None
    if config.attention_impl in ("ring", "zigzag"):
        raise ValueError(
            f"attention_impl={config.attention_impl!r}: {config.model} "
            f"({family}) would shard the sequence over the 'seq' mesh axis; "
            f"ring and zigzag attention come with the sequence-parallel "
            f"slice. Use --attn dense or flash")
    if spec.input_kind != "image" and config.sync_bn:
        raise ValueError(
            "sync_bn requires the pure-DP shard_map path (image model, "
            "no tp/sp/fsdp axes); this config takes the GSPMD path")
    if not config.model.startswith("resnet"):
        on = [f for f in _FUSED if getattr(config, f)]
        if on:
            raise ValueError(
                f"{', '.join(on)}: {config.model} has no fused BatchNorm "
                f"path (neither has the JAX {family})")
    data = config.parallel.data
    have = 1 if world is None else world
    if data != have:
        raise ValueError(
            f"--dp {data} needs a world of {data} processes (torchrun "
            f"--nproc-per-node {data}) to train {config.model} ({family}); "
            f"this run has {have}")
    config.per_device_batch  # noqa: B018 - raises on an uneven split
    if config.sync_bn:
        if "bn_axis_name" not in inspect.signature(spec.build).parameters:
            raise ValueError(
                f"--sync-bn: model {config.model!r} has no BatchNorm to "
                f"synchronize (supported: resnet*/densenet* families)")
        if config.fused_bn:
            raise ValueError(SYNC_BN_WITH_FUSED_BN)
        if world is None:
            raise ValueError(
                "--sync-bn averages BatchNorm statistics over the ranks of "
                "a process group, and this run has none: launch it with "
                "torchrun (python -m torch.distributed.run "
                "--nproc-per-node N ... --dp N --sync-bn)")


def warn_small_bn_batch(config: TrainConfig) -> None:
    """Warn when a BatchNorm's statistics see 1 example, or fewer than 32
    under accumulation (the JAX loop's warning): the shard's microbatch,
    times the ranks under ``sync_bn``."""
    bn_batch = config.per_device_batch // max(config.grad_accum_steps, 1)
    if config.sync_bn:
        bn_batch *= config.parallel.data * config.parallel.fsdp
    if bn_batch == 1 or (config.grad_accum_steps > 1 and bn_batch < 32):
        detail = ("training can silently stall at uniform logits; increase "
                  "--batch-size, reduce the data-parallel axis, or pool "
                  "statistics across shards with --sync-bn"
                  if bn_batch == 1 else "consider lowering --accum")
        warnings.warn(
            f"BatchNorm statistics will be computed over only {bn_batch} "
            f"example(s) (per_device_batch={config.per_device_batch}, "
            f"grad_accum_steps={config.grad_accum_steps}); {detail}",
            UserWarning, stacklevel=3)


def run_schedule(config: TrainConfig) -> Callable[[int], float]:
    """The run's schedule: ``config.optimizer``'s at the global batch over
    ``total_steps``, warming up over ``warmup_epochs`` of
    ``steps_per_epoch(config)``, as the JAX loop builds it."""
    return optim.make_schedule(config.optimizer, config.global_batch_size,
                               config.total_steps, steps_per_epoch(config))


def build_state(config: TrainConfig, device,
                carried: Optional[TrainState] = None
                ) -> tuple[TrainState, Callable]:
    """(state, schedule): the model in training mode on ``device``,
    initialised from ``config.seed``, its optimizer, EMA and loss scale at
    step 0, and the schedule over ``config.total_steps``. A ``carried``
    state (the previous stage of a batch ramp) is kept, and only the
    schedule is made for this config's batch and horizon."""
    if carried is not None:
        return carried, run_schedule(config)
    spec = model_spec(config.model)
    takes = inspect.signature(spec.build).parameters
    if spec.input_kind == "image":
        kw: dict[str, Any] = {"num_classes": config.data.num_classes}
        kw.update({f: True for f in _FUSED if getattr(config, f)})
        if config.sync_bn:
            kw["bn_axis_name"] = "data"
    else:
        kw = {"seq_len": config.data.seq_len}
        if spec.objective == "mlm":
            # BERT's vocabulary is the data's, as the JAX loop builds it.
            kw["vocab_size"] = config.data.vocab_size
    if "image_size" in takes:   # ViT sizes its position table from it
        kw["image_size"] = config.data.image_size
    if config.attention_impl and (spec.input_kind == "tokens"
                                  or "image_size" in takes):
        kw["attention_impl"] = config.attention_impl
    dtype = _DTYPES[resolve_precision(config).compute_dtype]
    # Weights from the seed alone; the caller's global RNG state is kept.
    with torch.random.fork_rng(
            devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(config.seed)
        model = get_model(config.model, dtype=dtype, device=device,
                          **kw).train()
    opt, sched = optim.make_optimizer(
        config.optimizer, model, config.global_batch_size,
        config.total_steps, steps_per_epoch(config))
    state = TrainState(
        step=0, model=model, optimizer=opt,
        ema=ema_init(model) if config.optimizer.ema_decay > 0 else None,
        loss_scale=init_loss_scale(config, device))
    return state, sched


def _is_image(config: TrainConfig) -> bool:
    return model_spec(config.model).input_kind == "image"


def make_source(config: TrainConfig, model, device,
                dp: Optional[DataParallel] = None, start_step: int = 0,
                train: bool = True):
    """This rank's batches of the model's input kind (``data.make_source``):
    synthetic (the whole global batch without ``dp``), or read from
    ``config.data.data_dir`` from ``start_step`` (``train=False``: the
    held-out split, once)."""
    spec = model_spec(config.model)
    return datalib.make_source(
        config, spec.input_kind, device, dp=dp, start_step=start_step,
        train=train, objective=spec.objective,
        vocab_size=(None if spec.input_kind == "image"
                    else model.cfg.vocab_size))


def _close(source) -> None:
    close = getattr(source, "close", None)
    if close is not None:
        close()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _EvaluatorBase:
    """Held-out eval over ``num_batches`` batches, the rank's rows of each.
    Synthetic data: the batches at index ``SYNTHETIC_EVAL_OFFSET`` on,
    disjoint from every training step's batch, the same set at every
    eval. Real data: the held-out split read from its start at every eval
    (a fresh source that reads nothing ahead); a split that runs dry
    scores the batches it has, with a warning, and under ``dp`` every rank
    stops where the first one ran dry."""

    SYNTHETIC_EVAL_OFFSET = 1 << 30
    metric_name: str
    best: Callable

    def __init__(self, make: Callable[..., Any], synthetic: bool,
                 num_batches: int, eval_step, dp: Optional[DataParallel],
                 device):
        self.num_batches, self.eval_step, self.dp = num_batches, eval_step, dp
        self.synthetic, self.device = synthetic, device
        self._make = make
        self._synth_source = make() if synthetic else None

    def __call__(self, state: TrainState) -> float:
        if self.synthetic:
            return self._accumulate([
                self.eval_step(state, self._synth_source.batch(
                    self.SYNTHETIC_EVAL_OFFSET + j))
                for j in range(self.num_batches)])
        source = self._make()
        outs = []
        try:
            for j in range(self.num_batches):
                try:
                    batch = source.batch(j)
                except StopIteration:
                    batch = None
                if not self._all_have(batch is not None):
                    if not outs:
                        raise RuntimeError(
                            "validation split yielded no full batch; "
                            "shrink the batch or provide more held-out "
                            "data")
                    warnings.warn(
                        f"validation split exhausted after {j} of "
                        f"{self.num_batches} eval batches; scoring the "
                        f"available ones")
                    break
                outs.append(self.eval_step(state, batch))
        finally:
            _close(source)
        return self._accumulate(outs)

    def _all_have(self, have: bool) -> bool:
        if self.dp is None:
            return have
        flag = torch.tensor([int(have)], dtype=torch.int32,
                            device=self.device)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN)
        return bool(flag.item())


class _Evaluator(_EvaluatorBase):
    """Top-1 of an image model; ``best`` is ``max``."""

    metric_name = "eval_top1"
    best = staticmethod(max)

    def _accumulate(self, outs) -> float:
        correct = sum(int(o["correct"]) for o in outs)
        total = sum(int(o["total"]) for o in outs)
        return correct / max(total, 1)


class _TokenEvaluator(_EvaluatorBase):
    """Mean per-token loss of a causal LM, or per masked position of BERT
    (perplexity = exp of it), exact over the batches' (loss sum, token
    count); ``best`` is ``min``."""

    metric_name = "eval_loss"
    best = staticmethod(min)

    def _accumulate(self, outs) -> float:
        loss_sum = sum(float(o["loss_sum"]) for o in outs)
        count = sum(float(o["count"]) for o in outs)
        return loss_sum / max(count, 1.0)


def make_evaluator(config: TrainConfig, model, device, num_batches: int,
                   dp: Optional[DataParallel] = None) -> _EvaluatorBase:
    """The held-out evaluator; under ``dp`` each rank scores its rows of
    every eval batch and the counts are summed over the ranks."""
    synthetic = datalib.resolve_loader(
        config, model_spec(config.model).input_kind) == "synthetic"
    held_out = config.replace(data=dataclasses.replace(config.data,
                                                       prefetch_depth=0))

    def make():
        if synthetic:
            return make_source(config, model, device, dp)
        return make_source(held_out, model, device, dp, 0, False)

    if _is_image(config):
        return _Evaluator(make, synthetic, num_batches,
                          make_eval_step(config, dp), dp, device)
    return _TokenEvaluator(make, synthetic, num_batches,
                           make_token_eval_step(
                               config, model_spec(config.model).objective,
                               dp),
                           dp, device)


class _BadStepTracker:
    """Counts the skipped updates the guard reports (``bad_step``) and
    aborts after ``limit`` consecutive ones. A flag is read two steps after
    its step, so the tracker itself never waits on the device; the rest is
    read at the end of the run."""

    _LAG = 2

    def __init__(self, limit: int):
        self.limit = max(int(limit), 1)
        self.total = 0
        self._consecutive = 0
        self._window: list = []

    def push(self, metrics: dict) -> None:
        flag = metrics.get("bad_step")
        if flag is None:
            return
        self._window.append(flag)
        if len(self._window) > self._LAG:
            self._check(self._window.pop(0))

    def drain(self) -> None:
        while self._window:
            self._check(self._window.pop(0))

    def _check(self, flag) -> None:
        if float(flag) > 0:
            self.total += 1
            self._consecutive += 1
            if self._consecutive >= self.limit:
                raise RuntimeError(
                    f"aborting: {self._consecutive} consecutive non-finite "
                    f"update steps (bad_step_limit={self.limit}) — the run "
                    f"is diverging, not hitting stray bad batches; lower "
                    f"the learning rate or inspect the data shards. "
                    f"{self.total} update(s) were skipped in total.")
        else:
            self._consecutive = 0


def run_ramp(config: TrainConfig, stages: list, *, device, warmup_steps: int,
             emit: Callable[[str], None], eval_batches: int,
             return_state: bool, dp: Optional[DataParallel] = None,
             profile: Optional["StepProfiler"] = None) -> dict:
    """A staged batch ramp: each stage a segment of ``run`` at the stage's
    batch, whose schedule is the linear-scaling rule's at that batch over
    the horizon of the stage's end. Segments chain through the checkpoint
    directory when there is one (every boundary is a checkpoint step), else
    carry the state in process. Returns the last segment's summary with a
    ``batch_ramp`` block, and emits it."""
    total_steps = config.total_steps
    live = [st for st in stages if st.start_step < total_steps] or stages[-1:]
    carried = None
    summary: dict[str, Any] = {}
    stage_meta = []
    for k, st in enumerate(live):
        end = total_steps if st.end_step is None else min(st.end_step,
                                                          total_steps)
        cfg_s = config.replace(global_batch_size=st.batch, total_steps=end)
        if k > 0 and config.checkpoint_dir:
            cfg_s = cfg_s.replace(resume=True)
        last = k == len(live) - 1
        want_state = (return_state and last) or (
            not config.checkpoint_dir and not last)
        summary = _run_segment(cfg_s, device=device, dp=dp,
                               warmup_steps=warmup_steps, emit=emit,
                               eval_batches=eval_batches,
                               return_state=want_state, ramp_stage=True,
                               carried=carried, profile=profile)
        carried = summary.get("state")
        if not (return_state and last):
            summary.pop("state", None)
        stage_meta.append({"batch": int(st.batch),
                           "start_step": int(st.start_step),
                           "end_step": int(end),
                           "examples_per_sec": summary.get(
                               "examples_per_sec")})
    summary["batch_ramp"] = {"spec": config.batch_ramp, "stages": stage_meta}
    emit(json.dumps({"summary": {k: v for k, v in summary.items()
                                 if k != "state"}}))
    return summary


class StepProfiler:
    """``torch.profiler`` over steps [start, stop) of a run (``state.step``
    before the step). When the window closes it writes
    ``<directory>/profile_rank<r>.json``: the steps, the device, each
    ``record_function`` range (``allreduce/bucketNN``, the optimizer's)
    with its call count, host ms and the device ms of the kernels launched
    inside it, and each device kernel with its count and ms. The window is
    closed before a step's timing is read, so it should end within the
    run's ``warmup_steps``."""

    def __init__(self, start: int, stop: int, directory: str, rank: int):
        self.start, self.stop = start, stop
        self.path = Path(directory) / f"profile_rank{rank}.json"
        self._prof = None

    def before(self, step: int, device: torch.device) -> None:
        if step == self.start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()

    def after(self, step: int, device: torch.device) -> None:
        if self._prof is None or step < self.stop:
            return
        _sync(device)
        self._prof.__exit__(None, None, None)
        ranges: dict[str, dict] = {}
        kernels: dict[str, dict] = {}
        for e in self._prof.events():
            host = e.device_type == torch.autograd.DeviceType.CPU
            if getattr(e, "is_user_annotation", False) and host:
                entry = ranges.setdefault(e.name, {"count": 0, "cpu_ms": 0.0,
                                                   "device_ms": 0.0})
                entry["cpu_ms"] += e.cpu_time_total / 1e3
                entry["device_ms"] += e.device_time_total / 1e3
            elif not host and not getattr(e, "is_user_annotation", False):
                entry = kernels.setdefault(e.name, {"count": 0,
                                                    "device_ms": 0.0})
                entry["device_ms"] += e.time_range.elapsed_us() / 1e3
            else:
                continue
            entry["count"] += 1
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps({
            "steps": [self.start, self.stop], "device": _device_name(device),
            "ranges": ranges, "kernels": kernels}))
        self._prof = None
        self.start = -1  # one window a run


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run(config: TrainConfig, *, device=None, warmup_steps: int = 2,
        emit: Callable[[str], None] = print, eval_batches: int = 0,
        restore_for_eval: bool = False, return_state: bool = False,
        profile_steps: Optional[tuple[int, int]] = None,
        profile_dir: str = "profile") -> dict:
    """Train to ``config.total_steps``; returns the summary (also emitted
    as the last ``{"summary": ...}`` line). ``device``: ``cuda`` unless
    ``cpu`` is asked for; a rank of a ``torchrun`` launch joins its process
    group (NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU) and leaves it at
    the end. ``eval_batches`` > 0 evaluates every ``eval_every_epochs`` and
    at the end (top-1 for image models, loss and perplexity for token
    models). ``restore_for_eval``: restore the newest checkpoint's
    parameters, buffers, step and EMA, train nothing, and evaluate.
    ``return_state`` adds the state under ``"state"``. ``profile_steps``:
    profile steps [A, B) into ``profile_dir`` (``StepProfiler``)."""
    total_steps = config.total_steps or 0
    if restore_for_eval:
        if not (config.checkpoint_dir and config.resume):
            raise ValueError("restore_for_eval needs a checkpoint_dir to "
                             "restore from, with resume on")
    elif total_steps <= 0:
        raise ValueError(f"total_steps must be positive (got {total_steps})")
    check_layout(config, launch_world())
    datalib.check_loader(config, model_spec(config.model).input_kind)
    dp, device = process_group.join(resolve_device(device))
    rank = 0 if dp is None else dp.rank
    if rank != 0:
        emit = _silent
    if _is_image(config) and rank == 0:
        warn_small_bn_batch(config)
    profile = (None if profile_steps is None
               else StepProfiler(*profile_steps, profile_dir, rank))
    try:
        ramp = None if restore_for_eval else optim.parse_batch_ramp(
            config.batch_ramp, final_batch=config.global_batch_size,
            checkpoint_every=(config.checkpoint_every_steps
                              if config.checkpoint_dir else 0))
        if ramp is not None:
            for st in ramp:  # every stage's batch splits as the last's does
                config.replace(global_batch_size=st.batch).per_device_batch
            return run_ramp(config, ramp, device=device, dp=dp,
                            warmup_steps=warmup_steps, emit=emit,
                            eval_batches=eval_batches,
                            return_state=return_state, profile=profile)
        return _run_segment(config, device=device, dp=dp,
                            warmup_steps=warmup_steps, emit=emit,
                            eval_batches=eval_batches,
                            restore_for_eval=restore_for_eval,
                            return_state=return_state, profile=profile)
    finally:
        if dp is not None:
            dp.close()


def _silent(line: str) -> None:
    del line


def _run_segment(config: TrainConfig, *, device: torch.device,
                 dp: Optional[DataParallel], warmup_steps: int,
                 emit: Callable[[str], None], eval_batches: int,
                 restore_for_eval: bool = False, return_state: bool = False,
                 ramp_stage: bool = False,
                 carried: Optional[TrainState] = None,
                 profile: Optional[StepProfiler] = None) -> dict:
    """``run`` at one global batch: the whole run, or one stage of a
    ramp (``ramp_stage``, which starts from the ``carried`` state when the
    stages do not chain through checkpoints and emits no summary)."""
    total_steps = config.total_steps or 0
    rank = 0 if dp is None else dp.rank
    loader = datalib.check_loader(config, model_spec(config.model).input_kind)
    state, sched = build_state(config.replace(total_steps=max(total_steps,
                                                              1)),
                               device, carried)
    ckpt: Optional[Checkpointer] = None
    if config.checkpoint_dir:
        ckpt = Checkpointer(config.checkpoint_dir,
                            config.checkpoint_every_steps)
        # A resume under another loader would read another sample stream.
        ckpt.verify_or_record_stream_meta({"loader": loader}, dp)
        restored = config.resume and (ckpt.restore_for_eval(state)
                                      if restore_for_eval
                                      else ckpt.restore(state))
        if restored and rank == 0:
            print(f"# resumed from step {state.step}", file=sys.stderr,
                  flush=True)
    start = state.step
    if rank == 0:
        print(f"# model={config.model} "
              f"global_batch={config.global_batch_size} "
              f"precision={resolve_precision(config).describe()} "
              f"loader={loader} "
              f"optimizer={config.optimizer.name} "
              f"batch_ramp={optim.ramp_describe(config)}"
              + (f" | dp={dp.world} sync_bn={config.sync_bn} allreduce="
                 f"{config.allreduce.describe()}" if dp is not None else "")
              + (f" accum={config.grad_accum_steps}"
                 if config.grad_accum_steps > 1 else "")
              + (f" | resumed@{start}" if start else ""), file=sys.stderr,
              flush=True)
    source = (make_source(config, state.model, device, dp, start)
              if start < total_steps else None)
    try:
        return _train(config, state, source, sched, ckpt, loader,
                      device=device, dp=dp, warmup_steps=warmup_steps,
                      emit=emit, eval_batches=eval_batches,
                      return_state=return_state, ramp_stage=ramp_stage,
                      profile=profile)
    finally:
        _close(source)


def _train(config: TrainConfig, state: TrainState, source, sched,
           ckpt: Optional[Checkpointer], loader: str, *,
           device: torch.device, dp: Optional[DataParallel],
           warmup_steps: int, emit: Callable[[str], None], eval_batches: int,
           return_state: bool, ramp_stage: bool,
           profile: Optional[StepProfiler]) -> dict:
    """The steps of ``_run_segment`` from ``state.step`` on ``source``,
    the evals and the summary."""
    total_steps = config.total_steps or 0
    start = state.step
    end_step = max(total_steps, start)
    train_step = make_train_step(config, sched, dp)
    evaluator = None
    eval_every_steps = 0
    evals: list[tuple[int, float]] = []
    if eval_batches > 0:
        evaluator = make_evaluator(config, state.model, device, eval_batches,
                                   dp)
        spe = steps_per_epoch(config)
        if config.eval_every_epochs > 0 and spe is not None:
            eval_every_steps = max(int(config.eval_every_epochs * spe), 1)
    bad_tracker = _BadStepTracker(config.bad_step_limit)
    warmup = min(warmup_steps, max(total_steps - start - 1, 0))
    metrics: dict[str, Any] = {}
    launches0 = launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_timed = time.perf_counter() if warmup == 0 else None
    t_last, step_last = time.perf_counter(), start
    wait_s = timed_wait_s = 0.0   # host seconds in source.batch
    while state.step < total_steps:
        if profile is not None:
            profile.before(state.step, device)
        t0 = time.perf_counter()
        batch = source.batch(state.step)
        waited = time.perf_counter() - t0
        wait_s += waited
        if t_timed is not None:
            timed_wait_s += waited
        metrics = train_step(state, batch)
        del batch   # the stream's next batch may take its memory
        bad_tracker.push(metrics)
        i = state.step
        if profile is not None:
            profile.after(i, device)
        if i - start == warmup and t_timed is None:
            _sync(device)
            t_timed = time.perf_counter()
        if ckpt is not None and i < total_steps:
            _save(ckpt, state, dp)
        if i % config.log_every == 0 or i == total_steps:
            record = {"step": i}
            record.update({k: float(v) for k, v in metrics.items()})
            now = time.perf_counter()  # float(loss) waited for the device
            dt = (now - t_last) / max(i - step_last, 1)
            record["step_time_s"] = round(dt, 6)
            record["examples_per_sec"] = round(
                config.global_batch_size / dt, 2)
            t_last, step_last = now, i
            emit(json.dumps(record))
        if eval_every_steps and i % eval_every_steps == 0 and i < total_steps:
            t_eval = time.perf_counter()
            val = evaluator(state)
            evals.append((i, val))
            emit(json.dumps({"step": i, evaluator.metric_name: val}))
            shift = time.perf_counter() - t_eval
            if t_timed is not None:
                t_timed += shift
            t_last += shift
    bad_tracker.drain()
    _sync(device)
    t_end = time.perf_counter()
    if ckpt is not None and total_steps > start:
        _save(ckpt, state, dp, force=True)

    summary: dict[str, Any] = {
        "final_step": state.step, "start_step": start,
        "final_metrics": {k: float(v) for k, v in metrics.items()},
        "device": _device_name(device),
        "precision": resolve_precision(config).describe(),
        "bad_steps": bad_tracker.total,
        "input_pipeline": {
            "loader": loader,
            "prefetch_depth": datalib.effective_prefetch_depth(config),
            "data_wait_s": wait_s},
    }
    if dp is not None:
        summary["data_parallel"] = {
            "world": dp.world, "backend": torch.distributed.get_backend(),
            "allreduce": config.allreduce.describe()}
    if device.type == "cuda":
        summary["kernel_launches"] = {
            k: v - launches0[k] for k, v in launch_counts().items()}
        summary["peak_memory_gb"] = (
            torch.cuda.max_memory_allocated(device) / 1e9)
    timed_steps = total_steps - start - warmup
    if t_timed is not None and timed_steps > 0:
        elapsed = t_end - t_timed
        examples = timed_steps * config.global_batch_size
        summary["examples_per_sec"] = examples / elapsed
        if not _is_image(config):
            summary["tokens_per_sec"] = (examples * config.data.seq_len
                                         / elapsed)
        summary["steps_per_sec"] = timed_steps / elapsed
        summary["input_pipeline"]["data_wait_frac"] = min(
            timed_wait_s / elapsed, 1.0)
    if evaluator is not None:
        final_val = evaluator(state)
        evals.append((end_step, final_val))
        name = evaluator.metric_name
        summary[name] = final_val
        summary["best_" + name.removeprefix("eval_")] = evaluator.best(
            v for _, v in evals)
        summary["evals"] = evals
        if name == "eval_loss":
            summary["eval_ppl"] = math.exp(min(final_val, 30.0))
    if not ramp_stage:
        emit(json.dumps({"summary": summary}))
    if return_state:
        summary["state"] = state
    return summary


def _save(ckpt: Checkpointer, state: TrainState,
          dp: Optional[DataParallel], force: bool = False) -> None:
    """Rank 0 writes the checkpoint; under ``dp`` every rank then waits at a
    barrier, so no rank reads a checkpoint before it exists."""
    if not ckpt.due(state.step, force=force):
        return
    if dp is None or dp.rank == 0:
        ckpt.save(state)
    if dp is not None:
        dp.barrier()
