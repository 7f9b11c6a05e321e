"""The port's large-batch pieces (distributeddeeplearning_tpu_torch/train/
optim.py, steps.py, loop.py, config.py) against the JAX package's, on the
CPU.

- LARS and LAMB: five updates of ``make_optimizer``'s optimizer against the
  JAX package's ``make_optimizer`` (``optax.lars``/``optax.lamb`` with the
  decay mask) on ``resnet_nano``'s and ``gpt_tiny``'s f32 parameters from
  shared numpy gradients. One decayed kernel starts at zero (a zero
  parameter norm: ratio 1) and one undecayed leaf has zero gradients
  throughout (a zero update norm under LAMB: ratio 1). Parameters within
  1e-5 of each tensor's largest |ref| (``close_rel``).
- The EMA against ``_ema_update``.
- ``parse_batch_ramp`` with every error case of the JAX function, and
  ``ramp_final_batch``/``ramp_describe``.
- The epoch rule: the schedule the CLI's config gives (``loop.
  run_schedule``) against JAX ``loop.steps_per_epoch`` + ``make_schedule``
  for ResNet-50 at batch 512 and GPT-2 at batch 16, over 1, 6 and 40 steps.
- ``preset()``: every field the port carries equals the JAX preset's, for
  all seven names; ``--config resnet50_synthetic`` runs on the CPU.
"""

import copy
import dataclasses
import json

import jax
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearning_tpu import config as jconfig
from distributeddeeplearning_tpu.train import loop as jloop
from distributeddeeplearning_tpu.train import optim as jopt
from distributeddeeplearning_tpu.train import steps as jsteps
from distributeddeeplearning_tpu_torch import config as tconfig
from distributeddeeplearning_tpu_torch.models import gpt as tgpt
from distributeddeeplearning_tpu_torch.models import resnet as tresnet
from distributeddeeplearning_tpu_torch.train import cli as tcli
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import optim as topt
from distributeddeeplearning_tpu_torch.train import steps as tsteps
from distributeddeeplearning_tpu_torch.utils.weights import (
    params_from_flax, params_to_flax)
from tests.test_torch_train import resnet_nano_params
from tests.torch_port_helpers import (close_rel, flat_params,  # noqa: F401
                                      one_torch_thread, tiny_lm_params)

VOCAB = 97
# Leaves set apart (flax paths): a decayed kernel that starts at zero, an
# undecayed leaf whose gradient is zero at every update.
SPECIAL = {"resnet": ("stage1_block1/conv2/kernel", "bn_stem/bias"),
           "gpt": ("layer0/attention/output/kernel", "ln_f/bias")}


def _five_updates(name: str, family: str, lr: float):
    params = (resnet_nano_params() if family == "resnet"
              else tiny_lm_params("gpt", VOCAB))
    model = (tresnet.resnet_nano(dtype=torch.float32) if family == "resnet"
             else tgpt.tiny_gpt(vocab_size=VOCAB))
    zero_param, zero_grad = SPECIAL[family]
    flat = flat_params(params)
    assert zero_param in flat and zero_grad in flat
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (np.zeros_like(p) if "/".join(
            k.key for k in path) == zero_param else np.asarray(p)), params)
    kw = dict(name=name, learning_rate=lr, weight_decay=0.05,
              warmup_epochs=1.0)
    jcfg, tcfg = jconfig.OptimizerConfig(**kw), tconfig.OptimizerConfig(**kw)
    tx, jsched = jopt.make_optimizer(jcfg, 128, 10, steps_per_epoch=2)
    opt_state, update = tx.init(params), jax.jit(tx.update)
    model.load_state_dict(params_from_flax(params), strict=False)
    opt, sched = topt.make_optimizer(tcfg, model, 128, 10, steps_per_epoch=2)
    rng = np.random.default_rng(11)

    def draw(path, p):
        key = "/".join(k.key for k in path)
        g = rng.standard_normal(p.shape).astype(np.float32)
        return np.zeros_like(g) if key == zero_grad else g

    for count in range(5):
        assert sched(count) == pytest.approx(float(jsched(count)), rel=1e-6)
        grads = jax.tree_util.tree_map_with_path(draw, params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tgrads = params_from_flax(grads)
        for n, p in model.named_parameters():
            p.grad = tgrads[n].clone()
        for group in opt.param_groups:
            group["lr"] = sched(count)
        opt.step()
        out = params_to_flax(model.state_dict())
        ref = flat_params(jax.tree.map(np.asarray, params))
        close_rel(out, ref)
        assert np.isfinite(out[zero_grad]).all()
    # The zero-norm kernel moved (ratio 1, not 0 or NaN) as optax moved it.
    assert np.abs(out[zero_param]).max() > 0
    return opt


@pytest.mark.parametrize("family", ["resnet", "gpt"])
@pytest.mark.parametrize("name,lr", [("lars", 2.0), ("lamb", 0.02)])
def test_trust_ratio_optimizers_match_optax(name, lr, family):
    opt = _five_updates(name, family, lr)
    # The optimizer state rides in state_dict (checkpoints carry it).
    state = opt.state_dict()["state"]
    keys = {"lars": {"trace"}, "lamb": {"step", "exp_avg", "exp_avg_sq"}}
    assert state and all(set(s) == keys[name] for s in state.values())


def test_lars_state_round_trips_through_state_dict():
    """A LARS optimizer restored from another's state_dict continues with
    the same update."""
    torch.manual_seed(0)
    models = [tresnet.resnet_nano(dtype=torch.float32) for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    cfg = tconfig.OptimizerConfig(name="lars", learning_rate=1.0)
    opts = [topt.make_optimizer(cfg, m, 256, 10)[0] for m in models]
    grads = [torch.randn_like(p) for p in models[0].parameters()]
    for _ in range(2):
        for p, g in zip(models[0].parameters(), grads):
            p.grad = g.clone()
        opts[0].param_groups[0]["lr"] = opts[0].param_groups[1]["lr"] = 0.5
        opts[0].step()
    models[1].load_state_dict(models[0].state_dict())
    # A copy, as a checkpoint holds: state_dict() shares the live tensors.
    opts[1].load_state_dict(copy.deepcopy(opts[0].state_dict()))
    for m, o in zip(models, opts):
        for p, g in zip(m.parameters(), grads):
            p.grad = g.clone()
        o.step()
    for a, b in zip(*(m.parameters() for m in models)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_ema_matches_jax(decay):
    params = resnet_nano_params()
    model = tresnet.resnet_nano(dtype=torch.float32)
    model.load_state_dict(params_from_flax(params), strict=False)
    ema_ref = params
    ema = tsteps.ema_init(model)
    rng = np.random.default_rng(3)
    for _ in range(4):
        new = jax.tree.map(
            lambda p: p + rng.standard_normal(p.shape).astype(np.float32),
            params)
        ema_ref = jsteps._ema_update(ema_ref, new, decay)
        model.load_state_dict(params_from_flax(new), strict=False)
        tsteps.ema_update_(ema, model, decay)
        close_rel(params_to_flax(ema),
                  flat_params(jax.tree.map(np.asarray, ema_ref)),
                  dict(rtol=1e-6, atol=1e-6))


def test_ema_decay_range_is_checked():
    model = tresnet.resnet_nano(dtype=torch.float32)
    for bad in (1.0, -0.1):
        cfg = tconfig.OptimizerConfig(ema_decay=bad)
        with pytest.raises(ValueError, match="ema_decay"):
            topt.make_optimizer(cfg, model, 256, 10)
        with pytest.raises(ValueError, match="ema_decay"):
            jopt.make_optimizer(jconfig.OptimizerConfig(ema_decay=bad), 256,
                                10)


RAMPS = [
    ("256:3,512", 512, 3), ("8192:600,16384:600,32768", 32768, 600),
    ("512", 512, 0), ("", 512, 0), (None, 512, 0), (" 4:2 , 8 ", 8, 2),
    ("4:2,4", 4, 0),
    # Every error case of the JAX parser:
    (",", 8, 0), ("4:2,8:2", 8, 0), ("4:x,8", 8, 0), ("4:0,8", 8, 0),
    ("4,8", 8, 0), ("4:2,x", 8, 0), ("0:2,8", 8, 0), ("8:2,4", 4, 0),
    ("4:2,16", 8, 0), ("4:3,8", 8, 2),
]


@pytest.mark.parametrize("spec,final,every", RAMPS)
def test_parse_batch_ramp_matches_jax(spec, final, every):
    def parse(module):
        try:
            stages = module.parse_batch_ramp(spec, final_batch=final,
                                             checkpoint_every=every)
        except ValueError as e:
            return "error", str(e)
        return "ok", (None if stages is None else
                      [dataclasses.astuple(s) for s in stages])

    out, ref = parse(topt), parse(jopt)
    assert out == ref
    if out[0] == "error":
        return
    jcfg = jconfig.TrainConfig(global_batch_size=final, batch_ramp=spec)
    tcfg = tconfig.TrainConfig(global_batch_size=final, batch_ramp=spec)
    assert topt.ramp_final_batch(tcfg) == jopt.ramp_final_batch(jcfg)
    assert topt.ramp_describe(tcfg) == jopt.ramp_describe(jcfg)


@pytest.mark.parametrize("argv,batch", [
    (["--model", "resnet50"], 512), (["--model", "gpt2_small"], 16),
    (["--config", "resnet50_lars_32k", "--dp", "1", "--accum", "1"], 32768),
])
@pytest.mark.parametrize("total", [1, 6, 40])
def test_cli_schedule_warms_up_in_epochs_as_jax(argv, batch, total):
    """The epoch rule: warmup over warmup_epochs x steps_per_epoch
    (ImageNet's split over the batch, for token models too), capped at the
    run's length less one step, as the JAX loop builds its schedule."""
    cfg = tcli.build_config(tcli.parse_args(
        [*argv, "--batch-size", str(batch), "--steps", str(total)]))
    jcfg = (jconfig.preset(cfg_name) if (cfg_name := dict(
        zip(argv, argv[1:])).get("--config")) else jconfig.TrainConfig(
            model=cfg.model))
    jcfg = jcfg.replace(global_batch_size=batch)
    spe = jloop.steps_per_epoch(jcfg)
    assert tloop.steps_per_epoch(cfg) == spe
    ref = jopt.make_schedule(jcfg.optimizer, batch, total, spe)
    out = tloop.run_schedule(cfg)
    for count in range(total + 2):
        np.testing.assert_allclose(out(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-9)
    if argv[1] == "resnet50" and total == 6:
        # The warmup the port had before the epoch rule ended after one
        # step (5% of the run); JAX's climbs for five.
        np.testing.assert_allclose([out(c) for c in range(6)],
                                   [0.0, 0.04, 0.08, 0.12, 0.16, 0.2],
                                   rtol=1e-6, atol=1e-12)


def test_build_state_takes_the_run_schedule():
    cfg = tconfig.TrainConfig(model="resnet_nano", global_batch_size=4,
                              total_steps=7, steps_per_epoch=3,
                              optimizer=tconfig.OptimizerConfig(
                                  warmup_epochs=1.0),
                              data=tconfig.DataConfig(image_size=16,
                                                      num_classes=10))
    _, sched = tloop.build_state(cfg, torch.device("cpu"))
    ref = jopt.make_schedule(jconfig.OptimizerConfig(warmup_epochs=1.0), 4,
                             7, 3)
    assert [sched(c) for c in range(8)] == pytest.approx(
        [float(ref(c)) for c in range(8)], rel=1e-6, abs=1e-12)


def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        out[f.name] = (_fields(value) if dataclasses.is_dataclass(value)
                       else value)
    return out


def _pick(ref, fields: dict) -> dict:
    return {k: (_pick(getattr(ref, k), v) if isinstance(v, dict)
                else getattr(ref, k)) for k, v in fields.items()}


@pytest.mark.parametrize("name", list(jconfig.PRESETS))
def test_presets_match_jax(name):
    assert tconfig.PRESETS == jconfig.PRESETS
    out = _fields(tconfig.preset(name))
    assert out == _pick(jconfig.preset(name), out)


def test_policies_match_jax():
    for make in ("mixed", "fp32"):
        out = getattr(tconfig.PrecisionPolicy, make)()
        ref = getattr(jconfig.PrecisionPolicy, make)()
        assert dataclasses.asdict(out) == dataclasses.asdict(ref)
        assert out.describe() == ref.describe()
    for bad in (dict(param_dtype="bfloat16"), dict(loss_scale=-1.0),
                dict(compute_dtype="float16"),
                dict(loss_scale=8.0, loss_scale_min=16.0),
                dict(loss_scale=8.0, loss_scale_growth_interval=0)):
        msgs = []
        for lib in (tconfig, jconfig):
            cfg = lib.TrainConfig(precision=lib.PrecisionPolicy(**bad))
            with pytest.raises(ValueError) as info:
                lib.resolve_precision(cfg)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]
    assert (tconfig.resolve_precision(tconfig.TrainConfig(dtype="float32"))
            .describe() == "f32/f32/f32")


def test_resnet50_synthetic_preset_runs_on_cpu(capsys):
    tcli.main(["--config", "resnet50_synthetic", "--device", "cpu",
               "--synthetic", "--batch-size", "2", "--image-size", "32",
               "--steps", "1", "--num-classes", "10"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["step"] == 1 and np.isfinite(lines[0]["loss"])
    assert lines[-1]["summary"]["final_step"] == 1


@pytest.mark.parametrize("argv,eval_key", [
    (["--model", "resnet_nano", "--image-size", "16", "--num-classes", "10",
      "--batch-size", "4", "--optimizer", "lars", "--batch-ramp", "2:2,4",
      "--steps", "4"], "eval_top1"),
    (["--model", "gpt_nano", "--seq-len", "16", "--batch-size", "2",
      "--optimizer", "lamb", "--steps", "3"], "eval_loss"),
], ids=["lars_resnet_ramp", "lamb_gpt"])
def test_cli_runs_the_large_batch_recipes_on_cpu(argv, eval_key, capsys):
    tcli.main(["--device", "cpu", "--synthetic", "--log-every", "1",
               "--precision", "mixed", "--ema-decay", "0.9",
               "--eval-batches", "1", *argv])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    metrics, summary = lines[:-1], lines[-1]["summary"]
    assert [x["step"] for x in metrics] == list(
        range(1, int(argv[-1]) + 1))
    assert all(np.isfinite(x["loss"]) and x["loss_scale"] == 32768.0
               and x["loss_scale_skip"] == 0.0 for x in metrics)
    assert np.isfinite(summary[eval_key])
    if "--batch-ramp" in argv:
        assert [s["batch"] for s in summary["batch_ramp"]["stages"]] == [2, 4]
