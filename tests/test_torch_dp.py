"""The port's data-parallel training (train/steps.py, train/loop.py,
parallel/) on two spawned gloo ranks, against the JAX package
(``tests/test_dp.py`` mirrored; its SyncBN and accumulation counterparts
are ``tests/test_torch_sync_bn.py`` and ``tests/test_torch_accum.py``,
which share this module's references and keep each file near 15 s).

One spawn for the module (``tests/torch_dist_helpers.py``) runs every
case on both ranks while JAX compiles its references here:

- two sgd steps of ``resnet_nano`` at world 2 against JAX
  ``make_dp_train_step`` on a 2-device CPU mesh, from the same weights and
  global batches: each step's loss, every parameter and running buffer
  within F32 (per-shard BatchNorm, running buffers averaged); the
  parameters identical on both ranks, bit for bit;
- the eval counts against ``make_dp_eval_step``;
- a NaN planted in one rank's shard skips the update on both ranks, under
  the bad-step guard and under loss scaling;
- the CLI at ``--dp 2 --sync-bn`` through checkpoints and a resume: only
  rank 0 prints, and its losses are the one-card run's on the whole batch;
- the layout refusals of ``check_layout`` (a token model at ``--tp 2`` or
  ``parallel.fsdp 2``: the GSPMD slice's; token models at ``--dp`` and
  ``--accum`` are ``tests/test_torch_token_dp.py``'s) and the
  BatchNorm-batch warning.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu import config as jconfig
from distributeddeeplearning_tpu.models import resnet as jresnet
from distributeddeeplearning_tpu.parallel import mesh as jmesh
from distributeddeeplearning_tpu.train import optim as jopt
from distributeddeeplearning_tpu.train import steps as jsteps
from distributeddeeplearning_tpu.train.state import TrainState as JState
from distributeddeeplearning_tpu_torch import config as tconfig
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.train import cli as tcli
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.utils.weights import (
    batch_stats_to_flax, params_from_flax, params_to_flax)
from tests.test_torch_resnet import seeded_variables
from tests.torch_dist_helpers import CLASSES, World, nano_config
from tests.torch_port_helpers import (F32, close_rel, flat_params,
                                      one_torch_thread)  # noqa: F401

WORLD, BATCH, SIZE = 2, 8, 16
SCALED = tconfig.PrecisionPolicy(compute_dtype="float32",
                                 reduce_dtype="float32", loss_scale=32768.0)
CLI = ["--device", "cpu", "--model", "resnet_nano", "--image-size",
       str(SIZE), "--num-classes", str(CLASSES), "--batch-size", str(BATCH),
       "--synthetic", "--dtype", "float32", "--log-every", "1", "--seed",
       "3", "--checkpoint-every", "1", "--eval-batches", "1",
       "--warmup-steps", "0"]


def make_batches(seed: int, n: int, batch: int = BATCH) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, SIZE, SIZE, 3)).astype(np.float32),
             rng.integers(0, CLASSES, batch)) for _ in range(n)]


def with_nan_rows(batches: list, rows: slice) -> list:
    """The first batch with its ``rows`` (one rank's shard) set to NaN."""
    image, label = batches[0]
    bad = image.copy()
    bad[rows] = np.nan
    return [(bad, label)]


VARIABLES = seeded_variables("bottleneck", 11)
WEIGHTS = {k: v.numpy() for k, v in params_from_flax(VARIABLES).items()}
BATCHES = make_batches(12, 2)
EVAL = make_batches(13, 2)
CASES = {
    "plain": ({}, BATCHES),
    "nan_guard": ({"bad_step_guard": True},
                  with_nan_rows(BATCHES, slice(BATCH // 2, BATCH))),
    "nan_scale": ({"precision": SCALED},
                  with_nan_rows(BATCHES, slice(BATCH // 2, BATCH))),
}


def spawn(directory, cases: dict, eval_batches=(), cli=()) -> World:
    """Both ranks running ``cases`` (and the eval batches and CLI runs);
    a module's first test that reads the results waits for them."""
    return World(WORLD, "dp_cases", {"weights": WEIGHTS, "cases": cases,
                                     "eval": list(eval_batches),
                                     "cli": list(cli)}, directory)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp")
    cli = [[*CLI, "--dp", str(WORLD), "--sync-bn", "--steps", str(steps),
            "--checkpoint-dir", str(base / "ckpt")] for steps in (2, 3)]
    return spawn(base / "world", CASES, EVAL, cli)


def jax_dp(batches: list, *, sync=False, accum=1, world=WORLD):
    """JAX ``make_dp_train_step`` on a ``world``-device mesh over
    ``batches``: each step's loss, then the params and batch_stats,
    flat."""
    batch = batches[0][0].shape[0]
    cfg = jconfig.TrainConfig(
        model="resnet18", global_batch_size=batch, dtype="float32",
        grad_accum_steps=accum, parallel=jconfig.ParallelConfig(data=world),
        optimizer=jconfig.OptimizerConfig(
            learning_rate=0.1, reference_batch=BATCH, schedule="constant",
            warmup_epochs=0.0))
    model = jresnet.ResNet([1, 1], jresnet.BottleneckBlock,
                           num_classes=CLASSES, width=8, dtype=jnp.float32,
                           bn_axis_name=jsteps.DATA_AXES if sync else None)
    tx, _ = jopt.make_optimizer(cfg.optimizer, batch, len(batches))
    state = JState.create(params=VARIABLES["params"],
                          opt_state=tx.init(VARIABLES["params"]),
                          batch_stats=VARIABLES["batch_stats"])
    step = jsteps.make_dp_train_step(model, tx, jmesh.make_mesh(cfg.parallel),
                                     cfg, "image")
    losses = []
    for image, label in batches:
        state, metrics = step(state, {"image": image, "label": label},
                              jax.random.key(0))
        losses.append(float(metrics["loss"]))
    return (losses, flat_params(jax.device_get(state.params)),
            flat_params(jax.device_get(state.batch_stats)))


def assert_matches(out: dict, ref) -> None:
    """A port run's losses, params and running buffers against a JAX
    run's (``jax_dp``) or another port run's."""
    if isinstance(ref, dict):
        ref = ([m["loss"] for m in ref["metrics"]],
               params_to_flax(_tensors(ref["state"])),
               batch_stats_to_flax(_tensors(ref["state"])))
    losses, params, stats = ref
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]], losses,
                               rtol=1e-5)
    state = _tensors(out["state"])
    close_rel(params_to_flax(state), params, F32)
    close_rel(batch_stats_to_flax(state), stats, F32)


def _tensors(state: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in state.items()}


def assert_replicated(ranks: World, cases) -> None:
    """Each case left both ranks with the same state, bit for bit."""
    out = ranks.results()
    for case in cases:
        a, b = out[0][case]["state"], out[1][case]["state"]
        for key in a:
            assert np.array_equal(a[key], b[key], equal_nan=True), (case, key)


def test_dp_sgd_steps_match_jax(ranks):
    ref = jax_dp(BATCHES)
    out = ranks.results()
    assert_matches(out[0]["plain"], ref)


def test_params_stay_replicated(ranks):
    assert_replicated(ranks, CASES)


def test_eval_counts_match_jax(ranks):
    mesh = jmesh.make_mesh(jconfig.ParallelConfig(data=WORLD))
    model = jresnet.ResNet([1, 1], jresnet.BottleneckBlock,
                           num_classes=CLASSES, width=8, dtype=jnp.float32)
    step = jsteps.make_dp_eval_step(model, mesh, None)
    state = JState.create(params=VARIABLES["params"], opt_state=None,
                          batch_stats=VARIABLES["batch_stats"])
    for rank in ranks.results():
        for (image, label), (correct, total) in zip(EVAL, rank["eval"]):
            ref = jax.device_get(step(state, {"image": image,
                                              "label": label}))
            assert (correct, total) == (int(ref["correct"]),
                                        int(ref["total"]))
            assert total == BATCH


@pytest.mark.parametrize("case,flag", [("nan_guard", "bad_step"),
                                       ("nan_scale", "loss_scale_skip")])
def test_nan_in_one_shard_skips_every_rank(ranks, case, flag):
    """Rank 1's rows are NaN: the averaged loss and the reduced gradients
    are not finite on both ranks, so both skip and keep their state."""
    for rank in ranks.results():
        out = rank[case]
        assert out["metrics"][0][flag] == 1.0
        assert out["updates"] == 0
        if case == "nan_scale":
            assert out["metrics"][0]["loss_scale"] == 16384.0
        for key, value in WEIGHTS.items():
            assert np.array_equal(out["state"][key], value), (case, key)


def test_cli_data_parallel_run(ranks, capsys, tmp_path):
    """``--dp 2 --sync-bn`` through a checkpoint and a resume: rank 0
    prints every line, rank 1 none; the losses are those of one rank on
    the whole batch, and the eval counts every held-out image."""
    runs = [r["cli"] for r in ranks.results()]
    assert all(out == "" for out in runs[1])
    ref = []
    for steps in (2, 3):
        tcli.main([*CLI, "--steps", str(steps), "--checkpoint-dir",
                   str(tmp_path / "ckpt")])
        ref.append(capsys.readouterr().out)
    for out, one in zip(runs[0], ref):
        lines = [json.loads(x) for x in out.splitlines()]
        one_lines = [json.loads(x) for x in one.splitlines()]
        steps = [x["step"] for x in lines if "loss" in x]
        assert steps == [x["step"] for x in one_lines if "loss" in x]
        np.testing.assert_allclose(
            [x["loss"] for x in lines if "loss" in x],
            [x["loss"] for x in one_lines if "loss" in x], rtol=1e-5)
        summary = lines[-1]["summary"]
        assert summary["data_parallel"]["world"] == WORLD
        assert summary["eval_top1"] == one_lines[-1]["summary"]["eval_top1"]
    assert [x["step"] for x in map(json.loads, runs[0][1].splitlines())
            if "loss" in x] == [3]   # the second run resumed at step 2


@pytest.mark.parametrize("overrides,world,match", [
    ({"model": "gpt_nano", "parallel": tconfig.ParallelConfig(data=2,
                                                              model=2)}, 2,
     "GSPMD"),
    ({"model": "gpt_nano", "parallel": tconfig.ParallelConfig(fsdp=2)}, None,
     "GSPMD"),
    ({"model": "gpt_nano", "sync_bn": True}, 1, "shard_map"),
    ({"sync_bn": True, "fused_bn": True}, 1,
     "sync_bn is not supported with fused_bn"),
    ({"sync_bn": True}, None, "process group"),
    ({"parallel": tconfig.ParallelConfig(data=2)}, None,
     "--dp 2 needs a world of 2 processes"),
    ({}, 2, "--dp 1 needs a world of 1 processes"),
    ({"parallel": tconfig.ParallelConfig(data=2), "global_batch_size": 9}, 2,
     r"shards=2 \(--dp 2\)"),
    ({"grad_accum_steps": 3}, None, r"grad_accum_steps=3 \(--accum 3\)"),
    ({"parallel": tconfig.ParallelConfig(data=2, fsdp=2)}, 2,
     "parallel.fsdp 2"),
])
def test_layout_refusals(overrides, world, match):
    with pytest.raises(ValueError, match=match):
        tloop.check_layout(nano_config(**overrides), world)


def test_layout_accepts_data_parallel_and_accum():
    tloop.check_layout(nano_config(world=2, sync_bn=True,
                                   grad_accum_steps=2), 2)
    tloop.check_layout(nano_config(grad_accum_steps=4), None)


def test_sync_bn_outside_a_group_raises():
    with pytest.raises(RuntimeError, match="process group"):
        collectives.cross_replica_mean(torch.ones(3))


@pytest.mark.parametrize("overrides,warns", [
    ({"global_batch_size": 2, "parallel": tconfig.ParallelConfig(data=2)},
     "only 1 example"),
    ({"global_batch_size": 2, "parallel": tconfig.ParallelConfig(data=2),
      "sync_bn": True}, None),
    ({"grad_accum_steps": 4}, "consider lowering --accum"),
    ({}, None),
])
def test_small_batchnorm_batch_warns(overrides, warns):
    """JAX's warning: statistics over 1 example, or under 32 with
    accumulation; sync_bn pools the ranks' shards."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tloop.warn_small_bn_batch(nano_config(**overrides))
    messages = [str(w.message) for w in caught]
    if warns is None:
        assert not messages
    else:
        assert any(warns in m for m in messages), messages
