"""Spawned gloo workers for the port's data-parallel tests
(``tests/test_torch_collectives.py``, ``tests/test_torch_dp.py``,
``tests/test_torch_token_dp.py``).

This module imports only torch and the port, never JAX: a spawned
worker imports it afresh. ``World`` starts ``world`` processes, each of
which joins a gloo group through a ``file://`` rendezvous in a directory
of the test's own (no TCP port to collide under xdist), runs one function
of this module on torch's one thread, and writes what it returns (numpy
arrays, floats, strings) where the parent reads it back. A test module
starts one world for all its cases and reads the results when its first
case needs them, so JAX can compile its reference steps meanwhile.
"""

from __future__ import annotations

import contextlib
import io
import multiprocessing as mp
import pickle
import traceback
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

from distributeddeeplearning_tpu_torch import config as tconfig
from distributeddeeplearning_tpu_torch.models import model_spec
from distributeddeeplearning_tpu_torch.models import resnet as tresnet
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.parallel.process_group import (
    DataParallel)
from distributeddeeplearning_tpu_torch.train import cli as tcli
from distributeddeeplearning_tpu_torch.train import optim as topt
from distributeddeeplearning_tpu_torch.train import steps as tsteps
from distributeddeeplearning_tpu_torch.train.state import TrainState

CLASSES = 10
JOIN_TIMEOUT_S = 240


def _entry(rank: int, world: int, directory: str, fn_name: str) -> None:
    torch.set_num_threads(1)
    out = Path(directory)
    try:
        payload = pickle.loads((out / "payload.pkl").read_bytes())
        dist.init_process_group(
            "gloo", init_method=f"file://{out / 'rendezvous'}", rank=rank,
            world_size=world)
        result = globals()[fn_name](rank, world, payload)
        (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1) from None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """``world`` spawned ranks running ``fn_name(rank, world, payload)``
    in a gloo group; ``results()`` joins them and returns each rank's
    return value."""

    def __init__(self, world: int, fn_name: str, payload: Any,
                 directory: Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        # Through a file: a large argument would hold start() until the
        # child has imported torch and read it.
        (self.dir / "payload.pkl").write_bytes(pickle.dumps(payload))
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry, args=(
            rank, world, str(self.dir), fn_name), daemon=True)
            for rank in range(world)]
        for proc in self.procs:
            proc.start()
        self._results = None

    def results(self) -> list:
        if self._results is None:
            for proc in self.procs:
                proc.join(JOIN_TIMEOUT_S)
            for proc in self.procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
            errors = [p.read_text() for p in sorted(self.dir.glob("*.err"))]
            codes = [proc.exitcode for proc in self.procs]
            if errors or any(code != 0 for code in codes):
                raise AssertionError(f"workers exited {codes}:\n"
                                     + "\n".join(errors))
            self._results = [
                pickle.loads((self.dir / f"rank{r}.pkl").read_bytes())
                for r in range(len(self.procs))]
        return self._results


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def collective_cases(rank: int, world: int, values: dict) -> dict:
    """Rank ``rank``'s slice of each tree of ``values`` ({name: (world,
    *shape) arrays}) reduced every way the module offers."""

    def local():
        return {n: torch.tensor(v[rank]) for n, v in values.items()}

    def run(**kw):
        out = collectives.all_reduce(local(), **kw)
        return {n: t.numpy() for n, t in out.items()}

    res = {"fused": run(bucket_bytes=64 * 1024),
           "perleaf": run(bucket_bytes=0),
           "default": run(),
           "bf16": run(bucket_bytes=64 * 1024, payload_dtype=torch.bfloat16),
           "ring": run(bucket_bytes=64 * 1024, algorithm="ring"),
           "ring_perleaf": run(bucket_bytes=0, algorithm="ring")}
    opts = tconfig.AllReduceConfig(bucket_mb=0.0625, dtype="float32",
                                   algorithm="psum")
    res["options"] = {n: t.numpy() for n, t in
                      collectives.all_reduce_gradients(
                          local(), options=opts).items()}
    try:
        collectives.all_reduce_gradients(
            local(), options=tconfig.AllReduceConfig(dtype="float16"))
        res["bad_dtype"] = ""
    except ValueError as e:
        res["bad_dtype"] = str(e)
    # SyncBN's mean: forward the mean over the ranks, backward the mean of
    # the ranks' cotangents.
    x = torch.tensor(values["bn1.scale"][rank], requires_grad=True)
    y = collectives.cross_replica_mean(x)
    (y * (rank + 1.0)).sum().backward()
    res["pmean"], res["pmean_grad"] = y.detach().numpy(), x.grad.numpy()
    return res


# ---------------------------------------------------------------------------
# The data-parallel train step
# ---------------------------------------------------------------------------

def nano_config(world: int = 1, **kw) -> tconfig.TrainConfig:
    """resnet_nano at batch 8 in float32 with a constant-rate sgd (the
    JAX default momentum and decay), ``world`` data-parallel ranks."""
    base = dict(
        model="resnet_nano", global_batch_size=8, dtype="float32",
        parallel=tconfig.ParallelConfig(data=world),
        data=tconfig.DataConfig(image_size=16, num_classes=CLASSES),
        optimizer=tconfig.OptimizerConfig(
            learning_rate=0.1, reference_batch=8, schedule="constant",
            warmup_epochs=0.0))
    base.update(kw)
    return tconfig.TrainConfig(**base)


def nano_state(cfg: tconfig.TrainConfig, weights: dict, total: int
               ) -> tuple[TrainState, Any]:
    """(state, schedule) of ``cfg``'s resnet_nano loaded with ``weights``
    (a state_dict of numpy arrays)."""
    model = tresnet.resnet_nano(
        num_classes=CLASSES, dtype=torch.float32,
        fused_block=cfg.fused_block, fused_conv3=cfg.fused_conv3,
        bn_axis_name="data" if cfg.sync_bn else None)
    model.load_state_dict({k: torch.tensor(v) for k, v in weights.items()})
    opt, sched = topt.make_optimizer(cfg.optimizer, model.train(),
                                     cfg.global_batch_size, total)
    return TrainState(step=0, model=model, optimizer=opt,
                      loss_scale=tsteps.init_loss_scale(cfg, "cpu")), sched


def train_steps(cfg: tconfig.TrainConfig, weights: dict, batches: list,
                dp=None) -> dict:
    """``cfg``'s steps on ``batches`` (global (image, label) numpy pairs;
    this rank's rows of each under ``dp``): each step's metrics, then the
    state_dict, the last step's gradients and the update count."""
    state, sched = nano_state(cfg, weights, len(batches))
    step = tsteps.make_train_step(cfg, sched, dp)
    metrics = []
    for image, label in batches:
        batch = {"image": torch.tensor(image), "label": torch.tensor(label)}
        if dp is not None:
            batch = dp.shard(batch)
        metrics.append({k: float(v) for k, v in step(state, batch).items()})
    model = state.model
    return {"metrics": metrics,
            "state": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()},
            "grads": {n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()},
            "updates": state.updates}


def dp_cases(rank: int, world: int, payload: dict) -> dict:
    """Every data-parallel case of ``tests/test_torch_dp.py`` on this
    rank: ``payload["cases"]`` maps a name to (config overrides, batches);
    ``payload["eval"]`` holds eval batches, ``payload["cli"]`` a pair of
    CLI runs (the second resumes the first's checkpoints)."""
    dp = DataParallel(rank, world)
    weights = payload["weights"]
    out = {}
    for name, (overrides, batches) in payload["cases"].items():
        out[name] = train_steps(nano_config(world, **overrides), weights,
                                batches, dp)
    state, _ = nano_state(nano_config(world), weights, 1)
    evaluate = tsteps.make_eval_step(nano_config(world), dp)
    out["eval"] = []
    for image, label in payload["eval"]:
        counts = evaluate(state, dp.shard({"image": torch.tensor(image),
                                           "label": torch.tensor(label)}))
        out["eval"].append((int(counts["correct"]), int(counts["total"])))
    out["cli"] = []
    for argv in payload["cli"]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tcli.main(argv)
        out["cli"].append(buf.getvalue())
    return out



# ---------------------------------------------------------------------------
# Token models (and ViT) on the data axis
# ---------------------------------------------------------------------------

def build_model(cfg: tconfig.TrainConfig, build_kw: dict, weights: dict):
    """The registry's ``cfg.model`` in float32, built with ``build_kw``
    and loaded with ``weights`` (a state_dict of numpy arrays), training
    mode."""
    model = model_spec(cfg.model).build(dtype=torch.float32, **build_kw)
    model.load_state_dict({k: torch.tensor(v) for k, v in weights.items()})
    return model.train()


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def model_steps(cfg: tconfig.TrainConfig, build_kw: dict, weights: dict,
                batches: list, dp=None) -> dict:
    """``cfg``'s steps of ``build_model(cfg, build_kw, weights)`` on
    ``batches`` (global batches, dicts of numpy arrays; this rank's rows of
    each under ``dp``): each step's metrics and the parameters after it,
    and the last step's gradients."""
    model = build_model(cfg, build_kw, weights)
    opt, sched = topt.make_optimizer(cfg.optimizer, model,
                                     cfg.global_batch_size, len(batches))
    state = TrainState(step=0, model=model, optimizer=opt,
                       loss_scale=tsteps.init_loss_scale(cfg, "cpu"))
    step = tsteps.make_train_step(cfg, sched, dp)
    out: dict = {"metrics": [], "params": []}
    for batch in batches:
        batch = tensors(batch)
        if dp is not None:
            batch = dp.shard(batch)
        out["metrics"].append({k: float(v)
                               for k, v in step(state, batch).items()})
        out["params"].append({n: p.detach().numpy().copy()
                              for n, p in model.named_parameters()})
    out["grads"] = {n: p.grad.numpy().copy()
                    for n, p in model.named_parameters()}
    return out


def dropout_masks(cfg: tconfig.TrainConfig, build_kw: dict, weights: dict,
                  batch: dict, dp=None) -> list:
    """The keep masks of every dropout site of BERT's residual stream (the
    embeddings' first) in one step of ``model_steps``, in call order."""
    from distributeddeeplearning_tpu_torch.models import bert as tbert

    masks = []
    real = tbert.dropout

    def recording(x, rate, rng):
        out = real(x, rate, rng)
        if rng is not None and rate:
            masks.append((out != 0).numpy())
        return out

    tbert.dropout = recording
    try:
        model_steps(cfg, build_kw, weights, [batch], dp)
    finally:
        tbert.dropout = real
    return masks


def token_eval(cfg: tconfig.TrainConfig, build_kw: dict, weights: dict,
               batch: dict, dp=None) -> tuple[float, float]:
    """(loss sum, count) of the token eval step on ``batch`` (this rank's
    rows under ``dp``, the sums over the ranks)."""
    model = build_model(cfg, build_kw, weights)
    state = TrainState(step=0, model=model, optimizer=None)
    evaluate = tsteps.make_token_eval_step(
        cfg, model_spec(cfg.model).objective, dp)
    batch = tensors(batch)
    out = evaluate(state, batch if dp is None else dp.shard(batch))
    return float(out["loss_sum"]), float(out["count"])


def token_dp_cases(rank: int, world: int, payload: dict) -> dict:
    """Every case of ``tests/test_torch_token_dp.py`` on this rank:
    ``payload["cases"]`` maps a name to (config overrides, build kwargs,
    weights, batches) for ``model_steps``, ``payload["eval"]`` a name to
    (overrides, build kwargs, weights, batch) for ``token_eval``,
    ``payload["dropout"]`` holds one such tuple for ``dropout_masks`` and
    ``payload["cli"]`` a CLI run's arguments."""
    dp = DataParallel(rank, world)
    out: dict = {}
    for name, (overrides, build_kw, weights, batches) in (
            payload["cases"].items()):
        out[name] = model_steps(nano_config(world, **overrides), build_kw,
                                weights, batches, dp)
    out["eval"] = {name: token_eval(nano_config(world, **overrides),
                                    build_kw, weights, batch, dp)
                   for name, (overrides, build_kw, weights, batch) in (
                       payload["eval"].items())}
    overrides, build_kw, weights, batch = payload["dropout"]
    out["dropout"] = dropout_masks(nano_config(world, **overrides), build_kw,
                                   weights, batch, dp)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main(payload["cli"])
    out["cli"] = buf.getvalue()
    return out


# ---------------------------------------------------------------------------
# Streamed data
# ---------------------------------------------------------------------------

def data_cases(rank: int, world: int, payload: dict) -> dict:
    """This rank's first ``payload["steps"]`` image batches of
    ``payload["folder"]`` at ``payload["seed"]`` through the loop's source
    from step ``payload["start"]`` (numpy), and the output of the CLI run
    ``payload["cli"]``."""
    import os

    from distributeddeeplearning_tpu_torch.train import loop

    os.cpu_count = lambda: 3   # the loader's default: two threads a rank
    cfg = nano_config(world, data=tconfig.DataConfig(
        data_dir=payload["folder"], synthetic=False,
        image_size=payload["image_size"], num_classes=CLASSES),
        global_batch_size=payload["batch"], seed=payload["seed"])
    start = payload["start"]
    source = loop.make_source(cfg, None, "cpu", DataParallel(rank, world),
                              start)
    batches = [{k: v.numpy() for k, v in source.batch(step).items()}
               for step in range(start, start + payload["steps"])]
    source.close()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main(payload["cli"])
    return {"batches": batches, "cli": buf.getvalue()}
