"""Shared pieces of the PyTorch port's tests (tests/test_torch_*.py other
than the ResNet parity test).

Every port test feeds the same numpy arrays to the JAX function and its
port on the CPU. Torch runs on one thread in these modules, so a port test
never takes the cores the timing-sensitive JAX tests of other workers need.
"""

from __future__ import annotations

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta as flax_meta

from distributeddeeplearning_tpu.models import gpt as jgpt
from distributeddeeplearning_tpu.models import llama as jllama
from distributeddeeplearning_tpu.models import resnet as jresnet

# f32: both sides compute in f32 and differ only in summation order.
F32 = dict(rtol=1e-5, atol=1e-5)
# bf16: the inputs are bf16 and the two sides round at different places.
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def flax_params(variables) -> dict:
    """The ``params`` collection of a flax ``init`` as numpy arrays, with
    the logical-partitioning boxes removed."""
    return jax.tree.map(np.asarray, flax_meta.unbox(variables["params"]))


def flat_params(tree, prefix: str = "") -> dict:
    """A nested params dict flattened to ``/``-joined paths (np.savez's)."""
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(flat_params(value, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = np.asarray(value)
    return flat


def close_rel(out: dict, ref: dict, tol=F32) -> None:
    """Each tensor of ``out`` against ``ref`` relative to the tensor's
    largest |ref|. A tensor whose gradient is zero in exact arithmetic (the
    key bias: softmax ignores a constant added to a row's scores) holds only
    rounding noise on both sides, so no scale is taken below 1e-4 of the
    largest |ref| of all tensors."""
    assert out.keys() == ref.keys()
    floor = 1e-4 * max(float(np.abs(v).max()) for v in ref.values())
    for key in ref:
        scale = max(float(np.abs(ref[key]).max()), floor, 1e-30)
        np.testing.assert_allclose(out[key] / scale, ref[key] / scale,
                                   err_msg=key, **tol)


@functools.lru_cache(maxsize=None)
def tiny_lm_params(family: str, vocab: int) -> dict:
    """JAX-initialised params of gpt_tiny or llama_tiny, as numpy."""
    build = {"gpt": jgpt.tiny_gpt, "llama": jllama.tiny_llama}[family]
    init = jax.jit(lambda key: build(vocab_size=vocab).init(
        {"params": key}, jnp.ones((1, 8), jnp.int32), train=False))
    return flax_params(init(jax.random.key(0)))


def unfused_bottleneck(filters: int, strides: int, train: bool):
    """The JAX unfused bottleneck with the ResNet's f32 conv and
    BatchNorm (its ``norm_act`` without ``fused_bn``)."""
    conv = functools.partial(nn.Conv, use_bias=False, dtype=jnp.float32,
                             param_dtype=jnp.float32, padding="SAME")

    def norm_act(y, *, name, residual=None, relu=True,
                 scale_init=nn.initializers.ones):
        y = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                         epsilon=1e-5, dtype=jnp.float32,
                         param_dtype=jnp.float32, scale_init=scale_init,
                         name=name)(y)
        if residual is not None:
            y = y + residual
        return nn.relu(y) if relu else y

    return jresnet.BottleneckBlock(filters, strides, conv, norm_act)


def seeded_block_variables(block, x, seed: int) -> dict:
    """flax variables drawn with numpy: conv kernels at the init scale,
    nonzero BN scales (zero-init would silence the residual branch) and
    biases, non-trivial batch_stats."""
    shapes = jax.eval_shape(lambda: block.init(jax.random.key(0), x,
                                               train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0, np.sqrt(2.0 / (np.prod(shape[:2])
                                                * shape[-1])), shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.uniform(-0.3, 0.3, shape)   # bias, mean

    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(draw(p, a), np.float32), shapes)
