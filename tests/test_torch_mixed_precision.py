"""The port's mixed precision with dynamic loss scaling and its bad-step
guard (distributeddeeplearning_tpu_torch/train/steps.py, loop.py) on the
CPU.

- ``next_loss_scale`` against the JAX package's ``_next_loss_scale`` over a
  scripted run of overflows and good steps: exact.
- An injected ``inf`` gradient under loss scaling skips the update: the
  parameters, the optimizer state, the BatchNorm running buffers and the
  EMA keep their values, the scale halves, the update count stays, so the
  next update's lr is the JAX schedule's at that count.
- The guard skips a non-finite step and is not armed on an overflow step;
  ``_BadStepTracker`` aborts after ``bad_step_limit`` consecutive skips as
  the JAX tracker does, and a run of non-finite batches aborts.
- A scaled f32 step's unscaled gradients and running buffers equal the
  unscaled step's bit for bit on ``resnet_nano``, plain, with ``fused_bn``
  and with ``fused_block`` + ``fused_conv3`` (the kernels' plain versions).
- The CLI refuses what the run's layout does not carry (a preset's ``--dp
  8`` in a world of 1, DenseNet's and BERT's, whose refusal names the
  model's family; a shard that ``--accum 16`` does not split; BERT's ring
  attention, ``--sp 4``), and
  runs ``--config densenet121_dp --dp 1 --precision
  mixed``.
"""

import copy
import json

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu import config as jconfig
from distributeddeeplearning_tpu.train import loop as jloop
from distributeddeeplearning_tpu.train import optim as jopt
from distributeddeeplearning_tpu.train import steps as jsteps
from distributeddeeplearning_tpu_torch import config as tconfig
from distributeddeeplearning_tpu_torch.train import cli as tcli
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import steps as tsteps
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

SCALED = dict(compute_dtype="float32", reduce_dtype="float32")


def test_next_loss_scale_matches_jax():
    kw = dict(loss_scale=2.0 ** 15, loss_scale_growth_interval=3,
              loss_scale_min=2.0 ** 13, loss_scale_max=2.0 ** 16)
    tpol, jpol = tconfig.PrecisionPolicy(**kw), jconfig.PrecisionPolicy(**kw)
    flags = [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0]
    t_scale, t_good = torch.tensor(2.0 ** 15), torch.tensor(0,
                                                            dtype=torch.int32)
    j_scale, j_good = np.float32(2.0 ** 15), np.int32(0)
    seen = set()
    for flag in flags:
        t_state, t_metrics = tsteps.next_loss_scale(
            tpol, t_scale, t_good, torch.tensor(bool(flag)))
        j_state, j_metrics = jsteps._next_loss_scale(
            jpol, j_scale, j_good, np.bool_(flag))
        t_scale, t_good = t_state["scale"], t_state["good_steps"]
        j_scale, j_good = j_state["scale"], j_state["good_steps"]
        assert float(t_scale) == float(j_scale)
        assert int(t_good) == int(j_good)
        assert t_good.dtype == torch.int32 and t_scale.dtype == torch.float32
        for key in ("loss_scale", "loss_scale_skip"):
            assert float(t_metrics[key]) == float(j_metrics[key])
        seen.add(float(t_scale))
    # The run reached the cap, the floor and the start between them.
    assert {2.0 ** 13, 2.0 ** 15, 2.0 ** 16} <= seen


def _config(**kw) -> tconfig.TrainConfig:
    base = dict(model="resnet_nano", global_batch_size=4, total_steps=6,
                seed=3, steps_per_epoch=1, dtype="float32",
                optimizer=tconfig.OptimizerConfig(warmup_epochs=1.0,
                                                  ema_decay=0.9),
                data=tconfig.DataConfig(image_size=16, num_classes=10))
    base.update(kw)
    return tconfig.TrainConfig(**base)


def _snapshot(state) -> dict:
    return copy.deepcopy({"model": state.model.state_dict(),
                          "opt": state.optimizer.state_dict(),
                          "ema": state.ema})


def _assert_same(a: dict, b: dict) -> None:
    for key in a["model"]:
        assert torch.equal(a["model"][key], b["model"][key]), key
    for key in a["ema"]:
        assert torch.equal(a["ema"][key], b["ema"][key]), key
    for sa, sb in zip(a["opt"]["state"].values(), b["opt"]["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def _inf_grad(state):
    """A hook that makes the classifier's gradient infinite."""
    return state.model.classifier.weight.register_hook(
        lambda g: torch.full_like(g, float("inf")))


def test_overflow_skips_the_update_and_the_schedule_waits():
    cfg = _config(precision=tconfig.PrecisionPolicy(loss_scale=1024.0,
                                                    **SCALED))
    state, sched = tloop.build_state(cfg, torch.device("cpu"))
    step = tsteps.make_train_step(cfg, sched)
    source = tloop.make_source(cfg, state.model, "cpu")
    for _ in range(2):
        metrics = step(state, source.batch(state.step))
        assert float(metrics["loss_scale_skip"]) == 0.0
    before = _snapshot(state)
    hook = _inf_grad(state)
    metrics = step(state, source.batch(state.step))
    hook.remove()
    assert float(metrics["loss_scale_skip"]) == 1.0
    assert float(metrics["loss_scale"]) == 512.0
    assert np.isfinite(float(metrics["loss"]))
    assert state.step == 3 and state.updates == 2
    _assert_same(before, _snapshot(state))
    # The next update reads the schedule at the update count (2), as optax's
    # count stays in the restored optimizer state; not at the step (3).
    jcfg = jconfig.TrainConfig(
        global_batch_size=4, steps_per_epoch=1,
        optimizer=jconfig.OptimizerConfig(warmup_epochs=1.0))
    ref = jopt.make_schedule(jcfg.optimizer, 4, 6, jloop.steps_per_epoch(jcfg))
    metrics = step(state, source.batch(state.step))
    assert metrics["lr"] == pytest.approx(float(ref(2)), rel=1e-6)
    assert float(ref(2)) != pytest.approx(float(ref(3)))
    assert state.updates == 3 and float(metrics["loss_scale_skip"]) == 0.0
    assert not torch.equal(before["model"]["classifier.weight"],
                           state.model.classifier.weight)


def test_guard_skips_a_non_finite_step():
    cfg = _config(bad_step_guard=True)
    state, sched = tloop.build_state(cfg, torch.device("cpu"))
    step = tsteps.make_train_step(cfg, sched)
    batch = tloop.make_source(cfg, state.model, "cpu").batch(0)
    before = _snapshot(state)
    metrics = step(state, {**batch, "image": torch.full_like(
        batch["image"], float("nan"))})
    assert float(metrics["bad_step"]) == 1.0
    assert state.step == 1 and state.updates == 0
    _assert_same(before, _snapshot(state))
    metrics = step(state, batch)
    assert float(metrics["bad_step"]) == 0.0 and state.updates == 1


def test_guard_is_not_armed_on_an_overflow_step():
    cfg = _config(bad_step_guard=True, precision=tconfig.PrecisionPolicy(
        loss_scale=1024.0, **SCALED))
    state, sched = tloop.build_state(cfg, torch.device("cpu"))
    step = tsteps.make_train_step(cfg, sched)
    hook = _inf_grad(state)
    metrics = step(state, tloop.make_source(cfg, state.model,
                                            "cpu").batch(0))
    hook.remove()
    assert float(metrics["loss_scale_skip"]) == 1.0
    assert float(metrics["bad_step"]) == 0.0


@pytest.mark.parametrize("flags", [[1, 1, 1], [1, 0, 1, 1, 0, 1, 1, 1, 0],
                                   [0, 1, 1, 0, 1, 1, 0]])
def test_bad_step_tracker_matches_jax(flags):
    def feed(tracker):
        for i, flag in enumerate(flags):
            try:
                tracker.push({"bad_step": float(flag)})
            except RuntimeError as e:
                return i, str(e)
        try:
            tracker.drain()
        except RuntimeError as e:
            return len(flags), str(e)
        return None, tracker.total

    assert feed(tloop._BadStepTracker(3)) == feed(jloop._BadStepTracker(3))


def test_run_of_bad_batches_aborts(monkeypatch):
    class NanImages:
        def __init__(self, source):
            self.source = source

        def batch(self, step):
            out = self.source.batch(step)
            return {**out, "image": torch.full_like(out["image"],
                                                    float("nan"))}

    make_source = tloop.make_source
    monkeypatch.setattr(tloop, "make_source",
                        lambda *a: NanImages(make_source(*a)))
    cfg = _config(bad_step_guard=True, bad_step_limit=3, total_steps=8)
    with pytest.raises(RuntimeError, match="3 consecutive non-finite"):
        tloop.run(cfg, device="cpu", emit=lambda line: None)


@pytest.mark.parametrize("fused", [{}, {"fused_bn": True},
                                   {"fused_block": True,
                                    "fused_conv3": True}],
                         ids=["plain", "fused_bn", "fused_block_conv3"])
def test_scaled_step_gradients_are_bitwise(fused):
    """Loss scale 2^15 against none, one f32 step on the same weights and
    batch: every backward op is linear in the incoming gradient, and a
    power-of-two scale is exact, so the unscaled gradients and the running
    buffers agree bit for bit."""
    grads, buffers = [], []
    for scale in (2.0 ** 15, 0.0):
        cfg = _config(precision=tconfig.PrecisionPolicy(loss_scale=scale,
                                                        **SCALED),
                      optimizer=tconfig.OptimizerConfig(), **fused)
        state, sched = tloop.build_state(cfg, torch.device("cpu"))
        step = tsteps.make_train_step(cfg, sched)
        metrics = step(state, tloop.make_source(cfg, state.model,
                                                "cpu").batch(0))
        assert metrics["lr"] == 0.0   # update 0 of the warmup: no change
        grads.append({n: p.grad for n, p in state.model.named_parameters()})
        buffers.append(dict(state.model.named_buffers()))
    assert grads[0].keys() == grads[1].keys()
    for name in grads[1]:
        assert torch.equal(grads[0][name], grads[1][name]), name
    for name in buffers[1]:
        assert torch.equal(buffers[0][name], buffers[1][name]), name
    assert any(g.abs().max() > 0 for g in grads[1].values())


@pytest.mark.parametrize("argv,match", [
    (["--model", "densenet_nano", "--fused-bn"], "no fused BatchNorm"),
    (["--config", "densenet121_dp"], "--dp 8"),
    (["--config", "resnet50_lars_32k", "--dp", "1", "--batch-size", "40"],
     "--accum 16"),
    (["--config", "bert_base_mlm"], "BERT"),
    (["--config", "bert_base_mlm_longctx", "--dp", "1", "--sp", "1"],
     "BERT"),
    (["--config", "bert_base_mlm_longctx", "--dp", "1"], "--sp 4"),
    (["--config", "no_such_preset"], "unknown preset"),
    (["--model", "densenet_nano", "--ema-decay", "1.0"], "ema_decay"),
])
def test_cli_refuses(argv, match):
    with pytest.raises(SystemExit, match=match):
        tcli.main(["--device", "cpu", "--steps", "1", *argv])


def test_densenet_preset_runs_mixed_on_cpu(capsys):
    tcli.main(["--config", "densenet121_dp", "--dp", "1", "--device", "cpu",
               "--synthetic", "--batch-size", "2", "--image-size", "32",
               "--num-classes", "10", "--precision", "mixed", "--steps", "2",
               "--log-every", "1", "--ema-decay", "0.999"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines[:-1]] == [1, 2]
    assert all(np.isfinite(x["loss"]) and x["loss_scale"] == 32768.0
               for x in lines[:-1])
    summary = lines[-1]["summary"]
    assert summary["precision"] == "bf16/f32/bf16+dls32768"
