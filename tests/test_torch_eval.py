"""The port's held-out eval and batch ramp (distributeddeeplearning_tpu_torch/
train/steps.py, loop.py, cli.py) on the CPU.

- The image eval step against the JAX package's ``make_dp_eval_step`` on
  one CPU device, on the same numpy weights, statistics and batches, with
  the live parameters and with EMA parameters in their place (as the JAX
  evaluator swaps them in): correct counts and totals, exact.
- The token eval step against ``make_token_eval_step`` on ``gpt_tiny``:
  the loss sum within 1e-5, the token count exact.
- Periodic eval every ``eval_every_epochs``, the summary's keys
  (``eval_top1``/``best_top1`` or ``eval_loss``/``best_loss``/``eval_ppl``,
  ``evals``) through the CLI, and ``--eval-only`` from a checkpoint.
- A batch ramp: each stage's lr is the JAX schedule at the stage's batch
  over the horizon of the stage's end (as JAX ``_run_ramp`` builds its
  segments), and a ramp resumed across its boundary, or carried in process
  without checkpoints, ends bit for bit where an unbroken one does.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributeddeeplearning_tpu import config as jconfig
from distributeddeeplearning_tpu.models import gpt as jgpt
from distributeddeeplearning_tpu.models import resnet as jresnet
from distributeddeeplearning_tpu.parallel import mesh as jmesh
from distributeddeeplearning_tpu.train import loop as jloop
from distributeddeeplearning_tpu.train import optim as jopt
from distributeddeeplearning_tpu.train import steps as jsteps
from distributeddeeplearning_tpu.train.state import TrainState as JState
from distributeddeeplearning_tpu_torch import config as tconfig
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.models import gpt as tgpt
from distributeddeeplearning_tpu_torch.models import resnet as tresnet
from distributeddeeplearning_tpu_torch.train import cli as tcli
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import steps as tsteps
from distributeddeeplearning_tpu_torch.train.state import TrainState
from distributeddeeplearning_tpu_torch.utils.weights import params_from_flax
from tests.test_torch_resnet import seeded_variables
from tests.torch_port_helpers import (one_torch_thread,  # noqa: F401
                                      tiny_lm_params)

CLASSES, SIZE, VOCAB = 10, 16, 97


def _mesh():
    return jmesh.make_mesh(jconfig.ParallelConfig(),
                           devices=jax.devices()[:1])


def _port_state(model, ema=None) -> TrainState:
    return TrainState(step=0, model=model,
                      optimizer=torch.optim.SGD(model.parameters(), lr=0.0),
                      ema=ema)


@pytest.mark.parametrize("use_ema", [False, True], ids=["live", "ema"])
def test_image_eval_step_matches_jax(use_ema):
    variables = seeded_variables("bottleneck", 4)
    ema_vars = seeded_variables("bottleneck", 5)
    rng = np.random.default_rng(6)
    batches = [(rng.standard_normal((8, SIZE, SIZE, 3)).astype(np.float32),
                rng.integers(0, CLASSES, 8)) for _ in range(2)]
    jmodel = jresnet.ResNet([1, 1], jresnet.BottleneckBlock,
                            num_classes=CLASSES, width=8, dtype=jnp.float32)
    jstep = jsteps.make_dp_eval_step(jmodel, _mesh(), None)
    # The JAX evaluator scores the EMA by swapping it in for the params.
    jstate = JState.create(
        params=(ema_vars if use_ema else variables)["params"],
        opt_state=None, batch_stats=variables["batch_stats"])
    model = tresnet.ResNet([1, 1], tresnet.BottleneckBlock,
                           num_classes=CLASSES, width=8,
                           dtype=torch.float32)
    model.load_state_dict(params_from_flax(variables))
    ema = ({n: v for n, v in params_from_flax(ema_vars["params"]).items()}
           if use_ema else None)
    state = _port_state(model.train(), ema)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    step = tsteps.make_eval_step(None)
    for image, label in batches:
        ref = jax.device_get(jstep(jstate, {"image": image, "label": label}))
        out = step(state, {"image": torch.from_numpy(image),
                           "label": torch.from_numpy(label)})
        assert int(out["correct"]) == int(ref["correct"])
        assert int(out["total"]) == int(ref["total"]) == 8
    # Eval changes nothing: mode, buffers, live parameters.
    assert model.training
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k])
    live = params_from_flax(variables["params"])
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), live[n])


def test_token_eval_step_matches_jax():
    params = tiny_lm_params("gpt", VOCAB)
    rng = np.random.default_rng(7)
    ids = rng.integers(1, VOCAB, (3, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    jcfg = jconfig.TrainConfig(model="gpt_tiny")
    jmodel = jgpt.tiny_gpt(vocab_size=VOCAB)
    mesh = _mesh()
    jstate = JState.create(params=params, opt_state=None)
    shardings = jax.tree.map(lambda _: NamedSharding(mesh, P()), jstate)
    jstep = jsteps.make_token_eval_step(jmodel, mesh, jcfg, shardings,
                                        objective="causal")
    ref = jax.device_get(jstep(jstate, {"input_ids": ids,
                                        "attention_mask": mask}))
    model = tgpt.tiny_gpt(vocab_size=VOCAB)
    model.load_state_dict(params_from_flax(params), strict=False)
    out = tsteps.make_token_eval_step(None)(
        _port_state(model.train()),
        {"input_ids": torch.from_numpy(ids).long(),
         "attention_mask": torch.from_numpy(mask)})
    assert float(out["count"]) == float(ref["count"]) == 3 * 11 - 3
    np.testing.assert_allclose(float(out["loss_sum"]),
                               float(ref["loss_sum"]), rtol=1e-5)


def _cli(capsys, *argv) -> list[dict]:
    tcli.main(["--device", "cpu", "--synthetic", "--log-every", "1",
               "--warmup-steps", "1", *argv])
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_cli_eval_batches_reports_top1_and_perplexity(capsys):
    lines = _cli(capsys, "--model", "resnet_nano", "--image-size", "16",
                 "--num-classes", str(CLASSES), "--batch-size", "4",
                 "--steps", "2", "--eval-batches", "2")
    summary = lines[-1]["summary"]
    assert 0.0 <= summary["eval_top1"] <= 1.0
    assert summary["best_top1"] == summary["eval_top1"]
    assert summary["evals"] == [[2, summary["eval_top1"]]]
    lines = _cli(capsys, "--model", "gpt_nano", "--seq-len", "16",
                 "--batch-size", "2", "--steps", "2", "--eval-batches", "2")
    summary = lines[-1]["summary"]
    vocab = get_model("gpt_nano", device="cpu").cfg.vocab_size
    assert abs(summary["eval_loss"] - math.log(vocab)) < 1.0
    assert summary["eval_ppl"] == pytest.approx(
        math.exp(summary["eval_loss"]))
    assert summary["best_loss"] == summary["eval_loss"]


def test_periodic_eval_every_epoch_and_eval_only(tmp_path, capsys):
    """Evals at every epoch boundary inside the run and at its end; then
    ``--eval-only`` scores the last checkpoint (with its EMA) as the run's
    final eval did."""
    lines = []
    cfg = tconfig.TrainConfig(
        model="resnet_nano", global_batch_size=4, total_steps=5, seed=2,
        steps_per_epoch=2, log_every=1, checkpoint_dir=str(tmp_path),
        checkpoint_every_steps=2,
        optimizer=tconfig.OptimizerConfig(ema_decay=0.5),
        data=tconfig.DataConfig(image_size=SIZE, num_classes=CLASSES))
    summary = tloop.run(cfg, device="cpu", emit=lines.append,
                        eval_batches=2)
    records = [json.loads(x) for x in lines]
    assert [r["step"] for r in records if "eval_top1" in r] == [2, 4]
    assert [s for s, _ in summary["evals"]] == [2, 4, 5]
    assert summary["best_top1"] == max(v for _, v in summary["evals"])
    capsys.readouterr()
    out = _cli(capsys, "--model", "resnet_nano", "--image-size", "16",
               "--num-classes", str(CLASSES), "--batch-size", "4",
               "--seed", "2", "--checkpoint-dir", str(tmp_path),
               "--eval-only", "--eval-batches", "2")
    assert out[-1]["summary"]["eval_top1"] == summary["eval_top1"]
    assert out[-1]["summary"]["start_step"] == 5
    with pytest.raises(SystemExit, match="no checkpoint"):
        tcli.main(["--device", "cpu", "--model", "resnet_nano",
                   "--checkpoint-dir", str(tmp_path / "none"),
                   "--eval-only", "--eval-batches", "1"])
    with pytest.raises(SystemExit, match="trains nothing"):
        tcli.main(["--device", "cpu", "--model", "resnet_nano", "--steps",
                   "1", "--checkpoint-dir", str(tmp_path), "--eval-only",
                   "--eval-batches", "1"])


def _ramp_config(tmp_path, name):
    return tconfig.TrainConfig(
        model="resnet_nano", global_batch_size=4, batch_ramp="2:2,4",
        total_steps=4, seed=5, log_every=1, dtype="float32",
        checkpoint_dir=None if name is None else str(tmp_path / name),
        checkpoint_every_steps=2,
        precision=tconfig.PrecisionPolicy(
            compute_dtype="float32", reduce_dtype="float32",
            loss_scale=256.0),
        optimizer=tconfig.OptimizerConfig(name="lars", learning_rate=2.0,
                                          ema_decay=0.5),
        data=tconfig.DataConfig(image_size=SIZE, num_classes=CLASSES))


def test_ramp_lr_per_stage_and_resume_across_the_boundary(tmp_path):
    straight, resumed = [], []
    cfg = _ramp_config(tmp_path, "a")
    summary = tloop.run(cfg, device="cpu", emit=straight.append,
                        return_state=True)
    stages = summary["batch_ramp"]["stages"]
    assert [(s["batch"], s["start_step"], s["end_step"]) for s in stages] \
        == [(2, 0, 2), (4, 2, 4)]
    records = [json.loads(x) for x in straight]
    lrs = [r["lr"] for r in records if "lr" in r]
    # JAX _run_ramp: stage k runs at its batch, over the horizon of its
    # end, with the epoch warmup of its batch.
    ref = []
    for batch, start, end in ((2, 0, 2), (4, 2, 4)):
        jcfg = jconfig.TrainConfig(global_batch_size=batch,
                                   optimizer=jconfig.OptimizerConfig(
                                       name="lars", learning_rate=2.0))
        sched = jopt.make_schedule(jcfg.optimizer, batch, end,
                                   jloop.steps_per_epoch(jcfg))
        ref += [float(sched(c)) for c in range(start, end)]
    assert lrs == pytest.approx(ref, rel=1e-6, abs=1e-12)
    assert json.loads(straight[-1])["summary"]["batch_ramp"]["spec"] == \
        "2:2,4"

    tloop.run(_ramp_config(tmp_path, "b").replace(total_steps=2),
              device="cpu", emit=resumed.append)
    assert (tmp_path / "b" / "step_2.pt").exists()
    tloop.run(_ramp_config(tmp_path, "b"), device="cpu", emit=resumed.append)
    loss = [[r["loss"] for r in map(json.loads, run) if "loss" in r]
            for run in (straight, resumed)]
    assert loss[0] == loss[1] and len(loss[0]) == 4
    a, b = (torch.load(tmp_path / d / "step_4.pt", weights_only=True)
            for d in ("a", "b"))
    assert a["updates"] == b["updates"] == 4
    for part in ("model", "ema", "loss_scale"):
        for key, value in a[part].items():
            assert torch.equal(value, b[part][key]), (part, key)
    for sa, sb in zip(a["optimizer"]["state"].values(),
                      b["optimizer"]["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)

    # Without a checkpoint directory the state is carried in process.
    carried = tloop.run(_ramp_config(tmp_path, None), device="cpu",
                        emit=lambda line: None, return_state=True)
    for key, value in a["model"].items():
        assert torch.equal(value, carried["state"].model.state_dict()[key])


def test_ramp_is_refused_off_the_checkpoint_cadence(tmp_path):
    cfg = _ramp_config(tmp_path, "c").replace(checkpoint_every_steps=3)
    with pytest.raises(ValueError, match="checkpoint_every_steps=3"):
        tloop.run(cfg, device="cpu", emit=lambda line: None)


def test_eval_batches_never_replay_training_batches():
    source = tloop.make_source(
        tconfig.TrainConfig(model="resnet_nano", global_batch_size=2,
                            data=tconfig.DataConfig(image_size=8)),
        None, "cpu")
    offset = tloop._EvaluatorBase.SYNTHETIC_EVAL_OFFSET
    held_out = source.batch(offset)["image"]
    assert torch.equal(held_out, source.batch(offset)["image"])
    assert not any(torch.equal(held_out, source.batch(i)["image"])
                   for i in range(4))
