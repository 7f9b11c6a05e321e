"""The port's DenseNet (distributeddeeplearning_tpu_torch/models/densenet.py)
against the JAX package's, on the CPU.

``densenet_nano`` (two blocks of two layers, growth 8, 16 initial
features) at 32x32, batch 4, f32, against a flax ``DenseNet((2, 2),
growth_rate=8, num_init_features=16)`` with the same numpy-drawn params and
batch_stats, carried across by ``utils/weights.py``. Compared, within the
limits ``test_torch_resnet.py`` holds the unfused ResNet to: the train-mode
logits, the updated batch_stats, the label-smoothed loss and every gradient
(one jitted ``value_and_grad``), and the eval-mode logits. Also: the weight
round trip with batch_stats, and the registry's DenseNet parameter counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import _registry as jax_registry
from distributeddeeplearning_tpu.models import densenet as jdensenet
from distributeddeeplearning_tpu.train import losses as jlosses
from distributeddeeplearning_tpu_torch.models import _registry, densenet
from distributeddeeplearning_tpu_torch.train.losses import (
    smoothed_softmax_ce)
from distributeddeeplearning_tpu_torch.utils.weights import (
    batch_stats_to_flax, params_from_flax, params_to_flax)
from tests.torch_port_helpers import (close_rel, flat_params,  # noqa: F401
                                      one_torch_thread)

CLASSES, BATCH, SIZE = 10, 4, 32
# As test_torch_resnet.py: f32 on both sides, convolutions and reductions
# summed in other orders.
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(rtol=1e-5, atol=1e-5)


def jax_model():
    return jdensenet.DenseNet((2, 2), growth_rate=8, num_init_features=16,
                              num_classes=CLASSES, dtype=jnp.float32)


def seeded_variables(seed: int) -> dict:
    """flax variables drawn with numpy: conv kernels at the init scale,
    BN scales in [0.5, 1.5], biases and means in [-0.3, 0.3], variances in
    [0.5, 1.5]."""
    shapes = jax.eval_shape(
        lambda: jax_model().init(jax.random.key(0),
                                 jnp.ones((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan = (np.prod(shape[:2]) * shape[-1] if len(shape) == 4
                   else shape[0])
            return rng.normal(0, np.sqrt(2.0 / fan), shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.uniform(-0.3, 0.3, shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(draw(p, x), np.float32), shapes)


@pytest.fixture(scope="module")
def jax_ref() -> dict:
    model = jax_model()
    variables = seeded_variables(1)
    rng = np.random.default_rng(2)
    image = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    label = rng.integers(0, CLASSES, BATCH)

    @jax.jit
    def run(params, stats, image, label):
        def loss_fn(p):
            logits, mutated = model.apply(
                {"params": p, "batch_stats": stats}, image, train=True,
                mutable=["batch_stats"])
            return (jlosses.smoothed_softmax_ce(logits, label, 0.1),
                    (logits, mutated["batch_stats"]))

        (loss, (logits, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        evals = model.apply({"params": params, "batch_stats": new_stats},
                            image, train=False)
        return loss, logits, new_stats, grads, evals

    out = jax.tree.map(np.asarray, run(variables["params"],
                                       variables["batch_stats"], image,
                                       label))
    return dict(zip(("loss", "logits", "stats", "grads", "evals"), out),
                variables=variables, image=image, label=label)


def port_model(variables: dict):
    model = densenet.densenet_nano(num_classes=CLASSES, dtype=torch.float32)
    model.load_state_dict(params_from_flax(variables), strict=True)
    return model


def test_densenet_matches_jax(jax_ref):
    ref = jax_ref
    model = port_model(ref["variables"]).train()
    logits = model(torch.from_numpy(ref["image"]))
    loss = smoothed_softmax_ce(logits, torch.from_numpy(ref["label"]), 0.1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], **TOL)
    close_rel({"logits": logits.detach().numpy()},
              {"logits": ref["logits"]}, TOL)
    close_rel(params_to_flax({n: p.grad for n, p in
                              model.named_parameters()}),
              flat_params(ref["grads"]), TOL)
    close_rel(batch_stats_to_flax(model.state_dict()),
              flat_params(ref["stats"]), F32)


def test_densenet_eval_matches_jax(jax_ref):
    """Eval mode with the statistics the train step left: running
    statistics, no update."""
    ref = jax_ref
    model = port_model(ref["variables"]).train()
    model(torch.from_numpy(ref["image"]))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        evals = model.eval()(torch.from_numpy(ref["image"]))
    close_rel({"logits": evals.numpy()}, {"logits": ref["evals"]}, TOL)
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())


def test_densenet_weights_round_trip():
    """flax -> port -> flax, bit for bit, under the flax names."""
    variables = seeded_variables(3)
    state = port_model(variables).state_dict()
    params = flat_params(variables["params"])
    assert params_to_flax(state).keys() == params.keys()
    for key, value in params_to_flax(state).items():
        assert np.array_equal(value, params[key]), key
    stats = flat_params(variables["batch_stats"])
    for key, value in batch_stats_to_flax(state).items():
        assert np.array_equal(value, stats[key]), key
    assert {"block2_layer2/conv2/kernel", "transition1_conv/kernel",
            "bn_final/scale", "classifier/kernel"} <= params.keys()
    kernel = params["block1_layer1/conv2/kernel"]          # (kh, kw, in, out)
    weight = state["block1_layer1.conv2.weight"].numpy()   # (out, in, kh, kw)
    assert np.array_equal(weight, kernel.transpose(3, 2, 0, 1))


def test_densenet_parameter_counts_match_jax():
    jreg, reg = jax_registry(), _registry()
    for name, count in (("densenet121", 7_978_856),
                        ("densenet169", 14_149_480)):
        with torch.device("meta"):
            model = reg[name].build(dtype=torch.float32)
        assert sum(p.numel() for p in model.parameters()) == count, name
        assert reg[name].param_count == jreg[name].param_count == count
        assert reg[name].input_kind == "image"


def test_densenet_is_channels_last_and_refuses_sync_bn():
    model = densenet.densenet_nano(num_classes=CLASSES, dtype=torch.float32)
    x = torch.randn(2, SIZE, SIZE, 3).permute(0, 3, 1, 2)
    y = model.block1_layer1(model.bn_stem(model.conv_stem(x)))
    assert y.is_contiguous(memory_format=torch.channels_last)
    # Cross-replica statistics outside a process group raise; they never
    # fall back to this replica's own.
    synced = densenet.densenet_nano(num_classes=CLASSES, dtype=torch.float32,
                                    bn_axis_name="data").train()
    with pytest.raises(RuntimeError, match="process group"):
        synced(torch.randn(2, SIZE, SIZE, 3))
