"""The port's trainer (distributeddeeplearning_tpu_torch/train/) on the
CPU: three sgd/adamw updates against the JAX package's
``optim.make_optimizer`` optax chain on the same gradients (schedule, decay
mask and clipping included) for a GPT and for ``resnet_nano``, the
schedules alone, and the trainer alone: a resumed run equals an unbroken
one bitwise (for the ResNet with its BatchNorm running buffers), the
synthetic batches depend only on their step, and the CLI prints its lines
on ``--device cpu`` and refuses to run without a card or with flags of
later slices.

Parameters are compared relative to each tensor's largest |ref| at F32
(``close_rel``): both sides update in f32 and round in other places.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearning_tpu import config as jconfig
from distributeddeeplearning_tpu.models import resnet as jresnet
from distributeddeeplearning_tpu.train import optim as jopt
from distributeddeeplearning_tpu_torch import config as tconfig
from distributeddeeplearning_tpu_torch.data.synthetic import (
    SyntheticCausalTokens, SyntheticImages)
from distributeddeeplearning_tpu_torch.models import gpt as tgpt
from distributeddeeplearning_tpu_torch.models import llama as tllama
from distributeddeeplearning_tpu_torch.models import resnet as tresnet
from distributeddeeplearning_tpu_torch.train import cli as tcli
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import optim as topt
from distributeddeeplearning_tpu_torch.utils.weights import (
    params_from_flax, params_to_flax)
from tests.torch_port_helpers import (close_rel, flat_params,  # noqa: F401
                                      one_torch_thread, tiny_lm_params)

VOCAB = 97


@pytest.mark.parametrize("schedule", ["constant", "linear", "warmup_cosine",
                                      "warmup_poly"])
def test_schedules_match_optax(schedule):
    jcfg = jconfig.OptimizerConfig(schedule=schedule, learning_rate=0.3)
    tcfg = tconfig.OptimizerConfig(schedule=schedule, learning_rate=0.3)
    for total in (1, 7, 40):
        ref = jopt.make_schedule(jcfg, 64, total)
        out = topt.make_schedule(tcfg, 64, total)
        for count in range(total + 3):
            np.testing.assert_allclose(out(count), float(ref(count)),
                                       rtol=1e-6, atol=1e-9)
    if schedule != "constant":
        assert topt.make_schedule(tcfg, 64, 40)(0) == 0.0


def test_decay_mask_matches_jax():
    for family, tbuild in (("gpt", tgpt.tiny_gpt),
                           ("llama", tllama.tiny_llama)):
        params = tiny_lm_params(family, VOCAB)
        ref = flat_params(jax.tree.map(np.asarray, jopt._decay_mask(params)))
        model = tbuild(vocab_size=VOCAB)
        out = params_to_flax({n: torch.tensor(float(topt.decays(n, p)))
                              .expand(p.shape)
                              for n, p in model.named_parameters()})
        assert {k: bool(v.all()) for k, v in out.items()} == \
            {k: bool(v) for k, v in ref.items()}, family
        assert not any(ref[k] for k in ("wte", "wpe", "embed_tokens")
                       if k in ref)


def resnet_nano_params() -> dict:
    """numpy params of the JAX tree of ``resnet_nano`` (two stages of one
    bottleneck, width 8, 1000 classes), at random: no compile needed."""
    shapes = jax.eval_shape(lambda: jresnet.ResNet(
        [1, 1], jresnet.BottleneckBlock, width=8).init(
            jax.random.key(0), np.ones((1, 16, 16, 3), np.float32),
            train=False))["params"]
    rng = np.random.default_rng(8)
    return jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.1,
        shapes)


def test_resnet_decay_mask_matches_jax():
    """Conv and classifier kernels are decayed; BatchNorm scale/bias and
    the classifier bias are not."""
    ref = flat_params(jax.tree.map(np.asarray,
                                   jopt._decay_mask(resnet_nano_params())))
    model = tresnet.resnet_nano(dtype=torch.float32)
    out = {n: topt.decays(n, p) for n, p in model.named_parameters()}
    flax_out = params_to_flax({n: torch.tensor(float(out[n])).expand(p.shape)
                               for n, p in model.named_parameters()})
    assert {k: bool(v.all()) for k, v in flax_out.items()} == \
        {k: bool(v) for k, v in ref.items()}
    assert out["conv_stem.weight"] and out["classifier.weight"]
    assert out["stage2_block1.downsample_conv.weight"]
    assert not any(out[k] for k in ("bn_stem.weight", "bn_stem.bias",
                                    "stage1_block1.bn3.weight",
                                    "classifier.bias"))


def _three_updates(name, clip, params, model):
    kw = dict(name=name, learning_rate=0.4, weight_decay=0.05,
              grad_clip_norm=clip)
    jcfg, tcfg = jconfig.OptimizerConfig(**kw), tconfig.OptimizerConfig(**kw)
    tx, _ = jopt.make_optimizer(jcfg, 128, 10)
    opt_state, update = tx.init(params), jax.jit(tx.update)
    missing, unexpected = model.load_state_dict(params_from_flax(params),
                                                strict=False)
    # Only BatchNorm buffers stay as the model made them: they are not params.
    assert not unexpected and all(
        k.endswith(("running_mean", "running_var")) for k in missing)
    opt, sched = topt.make_optimizer(tcfg, model, 128, 10)
    rng = np.random.default_rng(5)
    before = params_to_flax(model.state_dict())
    for count in range(3):
        grads = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tgrads = params_from_flax(grads)
        for n, p in model.named_parameters():
            p.grad = tgrads[n].clone()
        if clip:
            topt.clip_by_global_norm_((p.grad for p in model.parameters()),
                                      clip)
        for group in opt.param_groups:
            group["lr"] = sched(count)
        opt.step()
        out = params_to_flax(model.state_dict())
        close_rel(out, flat_params(jax.tree.map(np.asarray, params)))
        if count == 0:  # warmup: the first update has lr 0
            assert all(np.array_equal(out[k], before[k]) for k in out)


@pytest.mark.parametrize("name,clip", [("sgd", None), ("sgd", 0.5),
                                       ("adamw", None)])
def test_three_updates_match_optax(name, clip):
    """Three updates on the same gradients: warmup_cosine over 10 steps
    (update 0 at lr 0), decay mask, and global-norm clipping."""
    _three_updates(name, clip, tiny_lm_params("gpt", VOCAB),
                   tgpt.tiny_gpt(vocab_size=VOCAB))


def test_resnet_three_sgd_updates_match_optax():
    """The same for resnet_nano with the JAX default sgd: conv and
    classifier kernels decayed, BatchNorm parameters not."""
    _three_updates("sgd", None, resnet_nano_params(),
                   tresnet.resnet_nano(dtype=torch.float32))


def _train(tmp_path, name, steps, lines, model="gpt_tiny"):
    cfg = tconfig.TrainConfig(
        model=model, global_batch_size=2, total_steps=steps, seed=7,
        log_every=1, attention_impl="flash" if model == "gpt_tiny" else None,
        fused_bn=model == "resnet_nano",
        checkpoint_dir=str(tmp_path / name), checkpoint_every_steps=2,
        data=tconfig.DataConfig(seq_len=16, image_size=16))
    return tloop.run(cfg, device="cpu", emit=lines.append)


def test_resume_is_bitwise(tmp_path):
    """Four straight steps equal two steps, a checkpoint, a resume and two
    more: parameters, optimizer state and per-step losses, bit for bit
    (dropout on, drawn from (seed, step))."""
    _resume_is_bitwise(tmp_path, "gpt_tiny")


def test_resnet_resume_is_bitwise(tmp_path):
    """The same for resnet_nano with --fused-bn: its BatchNorm running
    buffers too."""
    _resume_is_bitwise(tmp_path, "resnet_nano")


def _resume_is_bitwise(tmp_path, model):
    straight, resumed = [], []
    _train(tmp_path, "a", 4, straight, model)
    _train(tmp_path, "b", 2, resumed, model)
    summary = _train(tmp_path, "b", 4, resumed, model)
    assert summary["start_step"] == 2 and summary["final_step"] == 4
    losses = [[json.loads(x)["loss"] for x in run if '"step"' in x]
              for run in (straight, resumed)]
    assert losses[0] == losses[1] and len(losses[0]) == 4
    a, b = (torch.load(tmp_path / d / "step_4.pt", weights_only=True)
            for d in ("a", "b"))
    if model == "resnet_nano":
        assert "bn_stem.running_var" in a["model"]
        assert not torch.equal(a["model"]["bn_stem.running_var"],
                               torch.ones(8))
    for key, value in a["model"].items():
        assert torch.equal(value, b["model"][key]), key
    for sa, sb in zip(a["optimizer"]["state"].values(),
                      b["optimizer"]["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_synthetic_tokens_depend_only_on_the_step():
    src = SyntheticCausalTokens(3, 10, VOCAB, seed=4)
    a, b = src.batch(5), SyntheticCausalTokens(3, 10, VOCAB, seed=4).batch(5)
    assert torch.equal(a["input_ids"], b["input_ids"])
    assert not torch.equal(a["input_ids"], src.batch(6)["input_ids"])
    ids = torch.cat([src.batch(i)["input_ids"] for i in range(20)])
    assert ids.min() >= 1 and ids.max() < VOCAB
    assert a["attention_mask"].dtype == torch.int32
    assert bool(a["attention_mask"].all())


def test_cli_on_cpu_prints_metrics_and_summary(capsys):
    tcli.main(["--model", "gpt_nano", "--device", "cpu", "--synthetic",
               "--steps", "3", "--seq-len", "16", "--batch-size", "2",
               "--log-every", "1", "--attn", "flash", "--warmup-steps", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines[:-1]] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in lines[:-1])
    summary = lines[-1]["summary"]
    assert summary["final_step"] == 3 and summary["device"] == "cpu"
    assert summary["tokens_per_sec"] == pytest.approx(
        16 * summary["examples_per_sec"])


def test_synthetic_images_depend_only_on_the_step():
    src = SyntheticImages(3, 8, 5, seed=4)
    a, b = src.batch(5), SyntheticImages(3, 8, 5, seed=4).batch(5)
    assert torch.equal(a["image"], b["image"])
    assert torch.equal(a["label"], b["label"])
    assert not torch.equal(a["image"], src.batch(6)["image"])
    assert a["image"].shape == (3, 8, 8, 3)
    assert a["image"].dtype == torch.bfloat16
    labels = torch.cat([src.batch(i)["label"] for i in range(20)])
    assert labels.min() >= 0 and labels.max() < 5


def test_resnet_cli_on_cpu(capsys):
    tcli.main(["--model", "resnet_nano", "--fused-bn", "--image-size", "16",
               "--device", "cpu", "--synthetic", "--steps", "3",
               "--batch-size", "4", "--num-classes", "10", "--log-every",
               "1", "--warmup-steps", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines[:-1]] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) and 0 <= x["accuracy"] <= 1
               for x in lines[:-1])
    # Random logits of a fresh net: the loss sits near ln(classes).
    assert abs(lines[0]["loss"] - np.log(10)) < 0.5
    summary = lines[-1]["summary"]
    assert summary["final_step"] == 3 and summary["device"] == "cpu"
    assert summary["examples_per_sec"] > 0
    assert "tokens_per_sec" not in summary


def test_resnet_fused_block_cli_on_cpu(capsys):
    """--fused-block: resnet_nano's bottlenecks through the matmul kernels'
    plain versions, with the stem's BatchNorm plain."""
    tcli.main(["--model", "resnet_nano", "--fused-block", "--image-size",
               "16", "--device", "cpu", "--synthetic", "--steps", "3",
               "--batch-size", "4", "--num-classes", "10", "--log-every",
               "1", "--warmup-steps", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines[:-1]] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in lines[:-1])
    assert abs(lines[0]["loss"] - np.log(10)) < 0.5
    assert lines[-1]["summary"]["final_step"] == 3


def test_resnet_fused_conv3_cli_on_cpu(capsys):
    """--fused-block --fused-conv3: resnet_nano's stride-1 3x3 through the
    conv kernels' plain versions, the rest as --fused-block."""
    tcli.main(["--model", "resnet_nano", "--fused-block", "--fused-conv3",
               "--image-size", "16", "--device", "cpu", "--synthetic",
               "--steps", "2", "--batch-size", "4", "--num-classes", "10",
               "--log-every", "1", "--warmup-steps", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines[:-1]] == [1, 2]
    assert all(np.isfinite(x["loss"]) for x in lines[:-1])
    assert abs(lines[0]["loss"] - np.log(10)) < 0.5
    assert lines[-1]["summary"]["final_step"] == 2


def test_cli_fused_conv3_needs_fused_block():
    with pytest.raises(SystemExit, match="requires --fused-block"):
        tcli.main(["--model", "resnet_nano", "--device", "cpu", "--steps",
                   "1", "--fused-conv3"])


def test_cli_refuses_fused_block_without_batchnorm():
    with pytest.raises(SystemExit, match="no BatchNorm"):
        tcli.main(["--model", "gpt_nano", "--device", "cpu", "--steps", "1",
                   "--fused-block"])


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--model", "gpt_nano", "--steps", "1"])


def test_resnet_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--model", "resnet_nano", "--fused-bn", "--steps", "1"])


@pytest.mark.parametrize("argv", [["--dp", "2"], ["--accum", "4"],
                                  ["--precision", "mixed"],
                                  ["--pp", "2"],
                                  ["--tp", "2"],
                                  ["--optimizer", "lars"], ["--fused-conv3"],
                                  ["--sync-bn"]])
def test_cli_refuses_flags_of_later_slices(argv):
    with pytest.raises((SystemExit, NotImplementedError)):
        tcli.main(["--model", "resnet_nano", "--device", "cpu", "--steps",
                   "1", *argv])


def test_cli_refuses_fused_bn_without_batchnorm():
    with pytest.raises(SystemExit, match="no BatchNorm"):
        tcli.main(["--model", "gpt_nano", "--device", "cpu", "--steps", "1",
                   "--fused-bn"])
