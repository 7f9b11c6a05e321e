"""The port's ResNet (distributeddeeplearning_tpu_torch/models/resnet.py)
against the JAX package's, on the CPU.

Two-stage, width-8 nets (one Bottleneck or Basic block a stage) at 16x16,
batch 4, f32, with the same numpy-drawn params and batch_stats on both
sides, carried across by ``utils/weights.py``. The port runs with
``fused_bn`` on (the kernels' plain versions), off, and with
``fused_block`` (the matmul kernels' plain versions; bottleneck nets only,
a basic-block net raises); all are held to the JAX model without fusion,
which the JAX package's own tests show equal to its fused ones. Compared:
the train-mode logits, the updated batch_stats,
the label-smoothed loss and every gradient (against one jitted
``value_and_grad`` a block type), and the eval-mode logits. Also: the
weight round trip with batch_stats, and the registry's parameter counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import _registry as jax_registry
from distributeddeeplearning_tpu.models import resnet as jresnet
from distributeddeeplearning_tpu.train import losses as jlosses
from distributeddeeplearning_tpu_torch.models import _registry, resnet
from distributeddeeplearning_tpu_torch.train.losses import (
    smoothed_softmax_ce)
from distributeddeeplearning_tpu_torch.utils.weights import (
    batch_stats_to_flax, params_from_flax, params_to_flax)
from tests.torch_port_helpers import (close_rel, flat_params,  # noqa: F401
                                      one_torch_thread)

BLOCKS = {"bottleneck": (jresnet.BottleneckBlock, resnet.BottleneckBlock),
          "basic": (jresnet.BasicBlock, resnet.BasicBlock)}
CLASSES, BATCH, SIZE = 10, 4, 16
# Train-mode logits, loss and gradients: f32 on both sides, convolutions
# and reductions summed in other orders; 1e-4 of each tensor's scale.
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(rtol=1e-5, atol=1e-5)


def jax_model(kind: str):
    return jresnet.ResNet([1, 1], BLOCKS[kind][0], num_classes=CLASSES,
                          width=8, dtype=jnp.float32)


def seeded_variables(kind: str, seed: int) -> dict:
    """flax variables of the two-stage net drawn with numpy: conv kernels
    at the model's init scale, nonzero BN scales (zero-init would silence
    the residual branch) and biases, non-trivial batch_stats."""
    shapes = jax.eval_shape(
        lambda: jax_model(kind).init(jax.random.key(0),
                                     jnp.ones((1, SIZE, SIZE, 3)),
                                     train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan = (np.prod(shape[:2]) * shape[-1] if len(shape) == 4
                   else shape[0])
            return rng.normal(0, np.sqrt(2.0 / fan), shape)
        if name == "scale" or name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return rng.uniform(-0.3, 0.3, shape)   # bias, mean

    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(draw(p, x), np.float32), shapes)


def batch(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32),
            rng.integers(0, CLASSES, BATCH))


@pytest.fixture(scope="module", params=list(BLOCKS))
def jax_ref(request) -> dict:
    """One jitted program a block type: train-mode loss, logits, updated
    batch_stats and gradients, then eval-mode logits with the updated
    statistics."""
    kind = request.param
    model = jax_model(kind)
    variables = seeded_variables(kind, 1)
    image, label = batch(2)

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
                kind=kind, variables=variables, image=image, label=label)


def port_model(kind: str, fused, variables: dict):
    """``fused``: True (``fused_bn``), False, or "block" (``fused_block``)."""
    model = resnet.ResNet([1, 1], BLOCKS[kind][1], num_classes=CLASSES,
                          width=8, dtype=torch.float32, fused_bn=fused is True,
                          fused_block=fused == "block")
    model.load_state_dict(params_from_flax(variables), strict=True)
    return model


@pytest.mark.parametrize("fused", [True, False, "block"],
                         ids=["fused", "unfused", "fused_block"])
def test_resnet_matches_jax(jax_ref, fused):
    ref = jax_ref
    if fused == "block" and ref["kind"] == "basic":
        with pytest.raises(ValueError, match="bottleneck"):
            port_model(ref["kind"], fused, ref["variables"])
        return
    model = port_model(ref["kind"], fused, ref["variables"]).train()
    logits = model(torch.from_numpy(ref["image"]))
    loss = smoothed_softmax_ce(logits, torch.from_numpy(ref["label"]), 0.1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], **TOL)
    close_rel({"logits": logits.detach().numpy()},
              {"logits": ref["logits"]}, TOL)
    close_rel(params_to_flax({n: p.grad for n, p in
                              model.named_parameters()}),
              flat_params(ref["grads"]), TOL)
    stats = batch_stats_to_flax(model.state_dict())
    close_rel(stats, flat_params(ref["stats"]), F32)
    with torch.no_grad():
        evals = model.eval()(torch.from_numpy(ref["image"]))
    close_rel({"logits": evals.numpy()}, {"logits": ref["evals"]}, TOL)


def test_weights_round_trip_with_batch_stats():
    """flax -> port -> flax, bit for bit, and each conv kernel lands in
    torch's (out, in, kh, kw) layout with its spatial axes unswapped."""
    variables = seeded_variables("basic", 3)
    model = port_model("basic", True, variables)
    state = model.state_dict()
    assert params_to_flax(state).keys() == flat_params(
        variables["params"]).keys()
    for key, value in params_to_flax(state).items():
        assert np.array_equal(value, flat_params(variables["params"])[key])
    for key, value in batch_stats_to_flax(state).items():
        assert np.array_equal(value,
                              flat_params(variables["batch_stats"])[key])
    for name, k in (("conv_stem", 7), ("stage1_block1.conv1", 3)):
        path = name.replace(".", "/") + "/kernel"
        kernel = flat_params(variables["params"])[path]   # (kh, kw, in, out)
        assert kernel.shape[:2] == (k, k)
        assert not np.array_equal(kernel, kernel.transpose(1, 0, 2, 3))
        weight = state[f"{name}.weight"].numpy()          # (out, in, kh, kw)
        assert np.array_equal(weight, kernel.transpose(3, 2, 0, 1))
    mean = state["stage2_block1.downsample_bn.running_mean"].numpy()
    assert np.array_equal(mean, variables["batch_stats"]["stage2_block1"]
                          ["downsample_bn"]["mean"])


def test_registry_parameter_counts_match_jax():
    """Every image model of the port's registry (the ResNets, the
    DenseNets and the ViTs), built on the meta device, has the JAX
    registry's parameter count; the test-sized entries (count 0,
    unchecked in both registries) are the only ones without one."""
    jreg, reg = jax_registry(), _registry()
    images = [n for n, s in reg.items() if s.input_kind == "image"]
    assert "resnet50" in images and "vit_b16" in images
    for name in images:
        with torch.device("meta"):
            model = reg[name].build(dtype=torch.float32)
        count = sum(p.numel() for p in model.parameters())
        if name in jreg and jreg[name].param_count:
            assert reg[name].param_count == jreg[name].param_count, name
            assert count == jreg[name].param_count, name
        else:
            assert reg[name].param_count == 0, name
            assert name in ("resnet_nano", "densenet_nano", "vit_tiny")


def test_later_slice_options_raise():
    # Cross-replica statistics with the fused BatchNorm kernels: refused
    # with the JAX model's ValueError.
    with pytest.raises(ValueError, match="sync_bn is not supported with "
                                         "fused_bn"):
        resnet.resnet_nano(bn_axis_name="data", fused_bn=True)
