"""The port's fused bottleneck block with ``conv3_fused`` (distributed
deeplearning_tpu_torch/models/fused_block.py) and the ResNet built with
``fused_conv3``, against the JAX package, on the CPU.

A width-8 bottleneck (filters 8, out 32) at batch 2, f32, in three cases:
stride 1 with a downsample (8 input channels), stride 1 with the identity
shortcut (32), and stride 2 (16), where the block keeps the library 3x3 as
the reference does. Parameters and batch_stats are drawn with numpy and
carried across by ``utils/weights.py``.

- The train-mode output and the updated batch_stats against the JAX
  ``FusedBottleneckBlock(conv3_fused=True)``, whose kernels run in Pallas
  interpret mode; at stride 1 the port's block must go through
  ``bn_conv3x3_stats``, at stride 2 not.
- Every parameter gradient and the input's against ``jax.vjp`` of the JAX
  *unfused* ``BottleneckBlock``, under one random cotangent: the JAX
  package's own tests hold its fused block equal to the unfused one, and
  differentiating its fused block in interpret mode costs tens of seconds.
- The eval-mode output (running statistics) against the JAX fused block's
  eval path.
- ``resnet_nano(fused_block=True, fused_conv3=True)`` against the port's
  unfused ``resnet_nano`` on the same weights and batch: loss, every
  gradient and the running buffers. ``fused_conv3`` without
  ``fused_block`` raises ``ValueError``, as the JAX model does.

Tolerance: f32 on both sides, convolutions and reductions summed in other
orders: 1e-4 of each tensor's largest |ref| (as the ResNet parity test),
the running statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import fused_block as jfb
from distributeddeeplearning_tpu_torch.models import fused_block as tfb
from distributeddeeplearning_tpu_torch.models import resnet as tresnet
from distributeddeeplearning_tpu_torch.ops import fused_conv_bn as tfc
from distributeddeeplearning_tpu_torch.train.losses import (
    smoothed_softmax_ce)
from distributeddeeplearning_tpu_torch.utils.weights import (
    batch_stats_to_flax, params_from_flax, params_to_flax)
from tests.torch_port_helpers import (  # noqa: F401
    close_rel, flat_params, one_torch_thread, seeded_block_variables,
    unfused_bottleneck)

FILTERS, BATCH = 8, 2
# (input channels, stride, spatial side)
CASES = {"stride1_downsample": (8, 1, 8), "identity": (32, 1, 8),
         "stride2": (16, 2, 8)}
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """A CPU tensor takes the plain versions: no conv kernel is counted."""
    names = ("fwd_launches", "bwd_dx_launches", "bwd_dw_launches")
    before = [getattr(tfc, n) for n in names]
    yield
    assert [getattr(tfc, n) for n in names] == before


@pytest.fixture(scope="module", params=list(CASES))
def case(request) -> dict:
    """The JAX side of one case, one jitted program: fused (conv3_fused)
    train output and batch_stats, unfused gradients under a random
    cotangent, fused eval output with the updated statistics."""
    cin, stride, side = CASES[request.param]
    rng = np.random.default_rng(len(request.param) + 100)
    x = rng.standard_normal((BATCH, side, side, cin)).astype(np.float32)
    fused = jfb.FusedBottleneckBlock(FILTERS, stride, dtype=jnp.float32,
                                     conv3_fused=True)
    unfused = unfused_bottleneck(FILTERS, stride, train=True)
    variables = seeded_block_variables(fused, x, 2)
    out_side = -(-side // stride)
    cot = rng.standard_normal((BATCH, out_side, out_side, 4 * FILTERS)
                              ).astype(np.float32)

    @jax.jit
    def run(params, stats, x, cot):
        out, mutated = fused.apply({"params": params, "batch_stats": stats},
                                   x, train=True, mutable=["batch_stats"])
        _, vjp = jax.vjp(
            lambda p, xx: unfused.apply({"params": p, "batch_stats": stats},
                                        xx, mutable=["batch_stats"])[0],
            params, x)
        grads, dx = vjp(cot)
        evals = fused.apply({"params": params,
                             "batch_stats": mutated["batch_stats"]}, x,
                            train=False)
        return out, mutated["batch_stats"], grads, dx, evals

    res = jax.tree.map(np.asarray, run(variables["params"],
                                       variables["batch_stats"], x, cot))
    return dict(zip(("out", "stats", "grads", "dx", "evals"), res),
                cin=cin, stride=stride, x=x, cot=cot, variables=variables)


def _port_block(case) -> tfb.FusedBottleneckBlock:
    block = tfb.FusedBottleneckBlock(case["cin"], FILTERS, case["stride"],
                                     dtype=torch.float32, conv3_fused=True)
    block.load_state_dict(params_from_flax(case["variables"]), strict=True)
    return block


def _nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the channels_last (N, C, H, W) view of its copy."""
    return torch.from_numpy(a.copy()).permute(0, 3, 1, 2)


def test_train_output_and_stats_match_jax_fused(case, monkeypatch):
    block = _port_block(case).train()
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return tfc.bn_conv3x3_stats(*args)

    monkeypatch.setattr(tfb, "bn_conv3x3_stats", counted)
    with torch.no_grad():
        out = block(_nchw(case["x"]))
    assert out.is_contiguous(memory_format=torch.channels_last)
    # The 3x3 goes through the conv op at stride 1 only.
    assert len(calls) == (case["stride"] == 1)
    close_rel({"out": out.permute(0, 2, 3, 1).numpy()},
              {"out": case["out"]}, TOL)
    close_rel(batch_stats_to_flax(block.state_dict()),
              flat_params(case["stats"]), F32)


def test_gradients_match_jax_unfused(case):
    block = _port_block(case).train()
    x = _nchw(case["x"]).requires_grad_()
    out = block(x)
    out.backward(_nchw(case["cot"]))
    close_rel(params_to_flax({n: p.grad for n, p in
                              block.named_parameters()}),
              flat_params(case["grads"]), TOL)
    close_rel({"x": x.grad.permute(0, 2, 3, 1).numpy()}, {"x": case["dx"]},
              TOL)


def test_eval_matches_jax_fused(case):
    block = _port_block(case).train()
    with torch.no_grad():
        block(_nchw(case["x"]))          # the running update, as in JAX
        out = block.eval()(_nchw(case["x"]))
    close_rel({"out": out.permute(0, 2, 3, 1).numpy()},
              {"out": case["evals"]}, TOL)


def test_resnet_nano_fused_conv3_matches_unfused():
    """One f32 training step's loss, gradients and running buffers of
    resnet_nano with fused_block and fused_conv3 (stage 1's block through
    the conv op, stage 2's at stride 2 on the library 3x3) against the
    port's unfused net on the same weights and batch."""
    torch.manual_seed(0)
    fused = tresnet.resnet_nano(num_classes=10, dtype=torch.float32,
                                fused_block=True, fused_conv3=True).train()
    plain = tresnet.resnet_nano(num_classes=10, dtype=torch.float32).train()
    plain.load_state_dict(fused.state_dict())
    rng = np.random.default_rng(7)
    image = torch.from_numpy(rng.standard_normal((4, 16, 16, 3)).astype(
        np.float32))
    label = torch.from_numpy(rng.integers(0, 10, 4))
    results = []
    for model in (fused, plain):
        loss = smoothed_softmax_ce(model(image), label, 0.1)
        loss.backward()
        results.append((loss.item(), {n: p.grad.numpy() for n, p in
                                      model.named_parameters()},
                        {n: b.numpy() for n, b in model.named_buffers()}))
    (loss_f, grads_f, bufs_f), (loss_u, grads_u, bufs_u) = results
    assert loss_f == pytest.approx(loss_u, rel=1e-5)
    close_rel(grads_f, grads_u, TOL)
    close_rel(bufs_f, bufs_u, F32)


def test_fused_conv3_needs_fused_block():
    with pytest.raises(ValueError, match="fused_block"):
        tresnet.resnet_nano(fused_conv3=True)
    with pytest.raises(ValueError, match="fused_block"):
        tresnet.resnet18(fused_conv3=True)
