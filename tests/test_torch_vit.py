"""The port's ViT (distributeddeeplearning_tpu_torch/models/vit.py, the
loop and CLI on ``vit_tiny``) against the JAX package on the CPU.

- vit_tiny's logits through the port's dense impl and the flash kernels'
  plain versions against the JAX model through its Pallas flash kernel in
  interpret mode, at S = 17 and 26 (32 and 40 px images, 8 px patches) and
  at S = 145, which the JAX wrapper pads to 256 before its kernel and the
  port's plain version takes as it is: f32, within 1e-5;
- loss and every gradient against ``jax.value_and_grad`` of the
  label-smoothed loss, each within 1e-4 of its tensor's largest |ref|;
- attention dropout 0.1 with each block's seed fed to both sides, the
  other dropout sites off on both (torch's RNG cannot replay flax's);
- the registry's full-size counts on the meta device, the weights' round
  trip through the flax tree (``block{i}``, the patch kernel's permute),
  and the CLI training vit_tiny two steps with ``--attn flash``.
"""

import functools
import json

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import vit as jvit
from distributeddeeplearning_tpu.ops import hash_dropout as jhash
from distributeddeeplearning_tpu.train import losses as jlosses
from distributeddeeplearning_tpu_torch.models import model_spec
from distributeddeeplearning_tpu_torch.models import vit as tvit
from distributeddeeplearning_tpu_torch.ops import attention as tattn
from distributeddeeplearning_tpu_torch.train import cli as tcli
from distributeddeeplearning_tpu_torch.train.losses import (
    smoothed_softmax_ce)
from distributeddeeplearning_tpu_torch.utils.weights import (
    params_from_flax, params_to_flax)
from tests.torch_port_helpers import (F32, close_rel,  # noqa: F401
                                      flat_params, flax_params,
                                      one_torch_thread)

B, CLASSES = 2, 10
GRAD = dict(rtol=1e-4, atol=1e-4)


def _images(size: int) -> np.ndarray:
    return np.random.default_rng(size).standard_normal(
        (B, size, size, 3)).astype(np.float32)


def _labels() -> np.ndarray:
    return np.array([3, 7], np.int32)


@functools.lru_cache(maxsize=None)
def _params(size: int) -> dict:
    """JAX-initialised vit_tiny params for ``size`` px images, with a
    random classifier (the JAX init zeroes it, which would hide the
    features from the logits)."""
    model = jvit.tiny_vit(num_classes=CLASSES)
    init = jax.jit(lambda key: model.init(
        {"params": key}, jnp.zeros((1, size, size, 3)), train=False))
    params = flax_params(init(jax.random.key(0)))
    params["classifier"]["kernel"] = np.random.default_rng(1).standard_normal(
        params["classifier"]["kernel"].shape).astype(np.float32) * 0.1
    return params


def _port(size, impl, rate=0.0):
    model = tvit.tiny_vit(num_classes=CLASSES, image_size=size,
                          attention_impl=impl, dropout_rate=rate)
    model.load_state_dict(params_from_flax(_params(size)))
    return model


@functools.lru_cache(maxsize=None)
def _jax_logits(size: int) -> np.ndarray:
    model = jvit.tiny_vit(num_classes=CLASSES, attention_impl="flash")
    return np.asarray(model.apply({"params": _params(size)},
                                  jnp.asarray(_images(size)), train=False))


@pytest.mark.parametrize("size", [32, 40, 96])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_match_jax_flash(impl, size):
    """S = (size / 8)^2 + 1: 17, 26 and 145 tokens, none a tile
    multiple."""
    with torch.no_grad():
        out = _port(size, impl).eval()(torch.from_numpy(_images(size)))
    ref = _jax_logits(size)
    assert out.shape == ref.shape == (B, CLASSES)
    np.testing.assert_allclose(out.numpy(), ref, **F32)


def _jax_loss_and_grads(impl, rate, size=40):
    model = jvit.tiny_vit(num_classes=CLASSES, attention_impl=impl,
                          dropout_rate=rate)

    def loss_fn(params):
        logits = model.apply({"params": params}, jnp.asarray(_images(size)),
                             train=True, rngs={"dropout": jax.random.key(1)})
        return jlosses.smoothed_softmax_ce(logits, jnp.asarray(_labels()),
                                           0.1)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(_params(size))
    return float(loss), flat_params(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(impl, rate, size=40):
    model = _port(size, impl, rate).train()
    logits = model(torch.from_numpy(_images(size)),
                   rng=torch.Generator().manual_seed(0))
    loss = smoothed_softmax_ce(logits, torch.from_numpy(_labels()), 0.1)
    loss.backward()
    grads = params_to_flax({n: p.grad for n, p in model.named_parameters()})
    return loss.item(), grads


_jax_flash_loss_and_grads = functools.lru_cache(maxsize=None)(
    lambda: _jax_loss_and_grads("flash", 0.0))


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_loss_and_grads_match_jax(impl):
    """S = 26: the flash kernels' ragged last tile, forward and backward."""
    ref_loss, ref_grads = _jax_flash_loss_and_grads()
    loss, grads = _port_loss_and_grads(impl, 0.0)
    np.testing.assert_allclose(loss, ref_loss, **F32)
    close_rel(grads, ref_grads, GRAD)


class _NoDropout:
    def __init__(self, rate):
        del rate

    def __call__(self, x, deterministic=True):
        return x


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_attention_dropout_matches_jax(impl, monkeypatch):
    seeds = [424242, -77]
    jseeds, tseeds = iter(seeds), iter(seeds)
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(jhash, "seed_from_key",
                        lambda key: jnp.int32(next(jseeds)))
    monkeypatch.setattr(tvit, "dropout", lambda x, rate, rng: x)
    monkeypatch.setattr(tattn, "draw_seed", lambda rng: next(tseeds))
    ref_loss, ref_grads = _jax_loss_and_grads("dense", 0.1)
    loss, grads = _port_loss_and_grads(impl, 0.1)
    np.testing.assert_allclose(loss, ref_loss, **F32)
    close_rel(grads, ref_grads, GRAD)
    plain_loss, _ = _port_loss_and_grads(impl, 0.0)
    assert abs(plain_loss - ref_loss) > 1e-5


@pytest.mark.parametrize("name,count", [("vit_b16", 86_567_656),
                                        ("vit_l16", 304_326_632)])
def test_param_counts(name, count):
    spec = model_spec(name)
    assert spec.param_count == count and spec.input_kind == "image"
    with torch.device("meta"):
        model = spec.build(dtype=torch.float32)
    assert sum(p.numel() for p in model.parameters()) == count
    assert model.pos_embedding.shape[0] == 197   # 14 x 14 patches + cls


def test_weights_round_trip_flax_tree():
    params = flat_params(_params(32))
    assert "block1/attention/query/kernel" in params
    state = params_from_flax(_params(32))
    assert state["patch_embed.weight"].shape == (64, 3, 8, 8)
    model = tvit.tiny_vit(num_classes=CLASSES)
    model.load_state_dict(state)          # strict: every name maps
    back = params_to_flax(model.state_dict())
    assert back.keys() == params.keys()
    for key, value in params.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_position_table_must_fit_the_image():
    with pytest.raises(ValueError, match="image_size"):
        tvit.tiny_vit(image_size=32)(torch.zeros((1, 40, 40, 3)))
    with pytest.raises(ValueError, match="patch size"):
        tvit.tiny_vit(image_size=36)


def test_cli_trains_vit_tiny(capsys):
    tcli.main(["--model", "vit_tiny", "--device", "cpu", "--synthetic",
               "--image-size", "40", "--num-classes", str(CLASSES),
               "--batch-size", "4", "--steps", "2", "--log-every", "1",
               "--attn", "flash", "--dtype", "float32"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    metrics, summary = lines[:-1], lines[-1]["summary"]
    assert [x["step"] for x in metrics] == [1, 2]
    # The zero classifier gives uniform logits: the first loss is ln K.
    assert metrics[0]["loss"] == pytest.approx(np.log(CLASSES), abs=1e-5)
    assert all(np.isfinite(x["loss"]) for x in metrics)
    assert summary["examples_per_sec"] > 0
