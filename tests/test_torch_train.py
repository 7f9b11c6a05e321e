"""The port's trainer (distributeddeeplearning_tpu_torch/train/) on the
CPU: three sgd/adamw updates against the JAX package's
``optim.make_optimizer`` optax chain on the same gradients (schedule, decay
mask and clipping included), the schedules alone, and the trainer alone: a
resumed run equals an unbroken one bitwise, the synthetic batches depend
only on their step, and the CLI prints its lines on ``--device cpu`` and
refuses to run without a card or with flags of later slices.

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
from distributeddeeplearning_tpu.train import optim as jopt
from distributeddeeplearning_tpu_torch import config as tconfig
from distributeddeeplearning_tpu_torch.data.synthetic import (
    SyntheticCausalTokens)
from distributeddeeplearning_tpu_torch.models import gpt as tgpt
from distributeddeeplearning_tpu_torch.models import llama as tllama
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


@pytest.mark.parametrize("name,clip", [("sgd", None), ("sgd", 0.5),
                                       ("adamw", None)])
def test_three_updates_match_optax(name, clip):
    """Three updates on the same gradients: warmup_cosine over 10 steps
    (update 0 at lr 0), decay mask, and global-norm clipping."""
    kw = dict(name=name, learning_rate=0.4, weight_decay=0.05,
              grad_clip_norm=clip)
    jcfg, tcfg = jconfig.OptimizerConfig(**kw), tconfig.OptimizerConfig(**kw)
    params = tiny_lm_params("gpt", VOCAB)
    tx, _ = jopt.make_optimizer(jcfg, 128, 10)
    opt_state, update = tx.init(params), jax.jit(tx.update)
    model = tgpt.tiny_gpt(vocab_size=VOCAB)
    model.load_state_dict(params_from_flax(params))
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


def _train(tmp_path, name, steps, lines):
    cfg = tconfig.TrainConfig(
        model="gpt_tiny", global_batch_size=2, total_steps=steps, seed=7,
        log_every=1, attention_impl="flash",
        checkpoint_dir=str(tmp_path / name), checkpoint_every_steps=2,
        data=tconfig.DataConfig(seq_len=16))
    return tloop.run(cfg, device="cpu", emit=lines.append)


def test_resume_is_bitwise(tmp_path):
    """Four straight steps equal two steps, a checkpoint, a resume and two
    more: parameters, optimizer state and per-step losses, bit for bit
    (dropout on, drawn from (seed, step))."""
    straight, resumed = [], []
    _train(tmp_path, "a", 4, straight)
    _train(tmp_path, "b", 2, resumed)
    summary = _train(tmp_path, "b", 4, resumed)
    assert summary["start_step"] == 2 and summary["final_step"] == 4
    losses = [[json.loads(x)["loss"] for x in run if '"step"' in x]
              for run in (straight, resumed)]
    assert losses[0] == losses[1] and len(losses[0]) == 4
    a, b = (torch.load(tmp_path / d / "step_4.pt", weights_only=True)
            for d in ("a", "b"))
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


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--model", "gpt_nano", "--steps", "1"])


@pytest.mark.parametrize("argv", [["--dp", "2"], ["--accum", "4"],
                                  ["--precision", "mixed"], ["--fused-bn"],
                                  ["--tp", "2"], ["--optimizer", "lars"]])
def test_cli_refuses_flags_of_later_slices(argv):
    with pytest.raises((SystemExit, NotImplementedError)):
        tcli.main(["--model", "gpt_nano", "--device", "cpu", "--steps", "1",
                   *argv])
