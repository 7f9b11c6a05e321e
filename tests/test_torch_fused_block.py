"""The port's fused bottleneck block (distributeddeeplearning_tpu_torch/
models/fused_block.py) against the JAX package's, on the CPU.

A width-8 bottleneck (filters 8, out 32) at batch 2, f32, in four cases:
stride 1 with a downsample (8 input channels), stride 1 with the identity
shortcut (32), stride 2 (16), and stride 2 at 7x7 (output 4x4: the strided
shortcut slice agrees with the strided 3x3, not with floor division).
Parameters and batch_stats are drawn with numpy and carried across by
``utils/weights.py``.

- The train-mode output and the updated batch_stats against the JAX
  ``FusedBottleneckBlock``, whose matmul kernels run in Pallas interpret
  mode.
- Every parameter gradient and the input's against ``jax.vjp`` of the JAX
  *unfused* ``BottleneckBlock`` (the composition of flax convolutions and
  BatchNorms), under one random cotangent: the JAX package's own tests hold
  its fused block equal to the unfused one, and differentiating its fused
  block in interpret mode costs tens of seconds.
- The eval-mode output (running statistics) against the JAX fused block's
  eval path.
- At init (gamma3 = beta3 = 0) the block exit is the shortcut, exactly 0
  wherever the block's input is: its ReLU passes no gradient there, as the
  unfused block's does.
- ``fused_block`` on a basic-block net raises ``ValueError``, as the JAX
  model does.

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
from distributeddeeplearning_tpu_torch.ops import fused_linear_bn as tflb
from distributeddeeplearning_tpu_torch.utils.weights import (
    batch_stats_to_flax, params_from_flax, params_to_flax)
from tests.torch_port_helpers import (  # noqa: F401
    close_rel, flat_params, one_torch_thread, seeded_block_variables,
    unfused_bottleneck)

FILTERS, BATCH = 8, 2
# (input channels, stride, spatial side)
CASES = {"stride1_downsample": (8, 1, 8), "identity": (32, 1, 8),
         "stride2": (16, 2, 8), "stride2_7x7": (16, 2, 7)}
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=list(CASES))
def case(request) -> dict:
    """The JAX side of one case, one jitted program: fused train output and
    batch_stats, unfused gradients under a random cotangent, fused eval
    output with the updated statistics."""
    cin, stride, side = CASES[request.param]
    rng = np.random.default_rng(len(request.param))
    x = rng.standard_normal((BATCH, side, side, cin)).astype(np.float32)
    fused = jfb.FusedBottleneckBlock(FILTERS, stride, dtype=jnp.float32)
    unfused = unfused_bottleneck(FILTERS, stride, train=True)
    variables = seeded_block_variables(fused, x, 1)
    out_side = -(-side // stride)
    cot = rng.standard_normal((BATCH, out_side, out_side, 4 * FILTERS)
                              ).astype(np.float32)

    @jax.jit
    def run(params, stats, x, cot):
        out, mutated = fused.apply({"params": params, "batch_stats": stats},
                                   x, train=True, mutable=["batch_stats"])
        ref_out, vjp = jax.vjp(
            lambda p, xx: unfused.apply({"params": p, "batch_stats": stats},
                                        xx, mutable=["batch_stats"])[0],
            params, x)
        grads, dx = vjp(cot)
        evals = fused.apply({"params": params,
                             "batch_stats": mutated["batch_stats"]}, x,
                            train=False)
        return out, ref_out, mutated["batch_stats"], grads, dx, evals

    res = jax.tree.map(np.asarray, run(variables["params"],
                                       variables["batch_stats"], x, cot))
    return dict(zip(("out", "unfused_out", "stats", "grads", "dx", "evals"),
                    res), cin=cin, stride=stride, x=x, cot=cot,
                variables=variables)


def _port_block(case) -> tfb.FusedBottleneckBlock:
    block = tfb.FusedBottleneckBlock(case["cin"], FILTERS, case["stride"],
                                     dtype=torch.float32)
    block.load_state_dict(params_from_flax(case["variables"]), strict=True)
    return block


def _nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the channels_last (N, C, H, W) view of its copy."""
    return torch.from_numpy(a.copy()).permute(0, 3, 1, 2)


def test_train_output_and_stats_match_jax_fused(case):
    block = _port_block(case).train()
    before = (tflb.fwd_launches, tflb.bwd_dx_launches, tflb.bwd_dw_launches)
    with torch.no_grad():
        out = block(_nchw(case["x"]))
    assert out.is_contiguous(memory_format=torch.channels_last)
    close_rel({"out": out.permute(0, 2, 3, 1).numpy()},
              {"out": case["out"]}, TOL)
    # The JAX package's fused and unfused blocks agree on this input.
    close_rel({"out": case["unfused_out"]}, {"out": case["out"]}, TOL)
    close_rel(batch_stats_to_flax(block.state_dict()),
              flat_params(case["stats"]), F32)
    # The CPU path is the kernels' plain versions: no launch counted.
    assert (tflb.fwd_launches, tflb.bwd_dx_launches,
            tflb.bwd_dw_launches) == before


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


def test_fused_block_needs_bottlenecks():
    with pytest.raises(ValueError, match="bottleneck"):
        tresnet.resnet18(fused_block=True)
    with pytest.raises(ValueError, match="bottleneck"):
        tresnet.ResNet([1, 1], tresnet.BasicBlock, num_classes=10, width=8,
                       fused_block=True)


def test_exit_relu_passes_no_gradient_at_zero():
    """With bn3's gamma and beta at their init (0), the exit is relu(0 +
    shortcut): exactly 0 wherever the (post-ReLU) input is. The fused block
    must pass the gradient there as the unfused block does (torch.relu and
    flax's nn.relu pass none at 0; ``jnp.maximum`` in the JAX fused block
    would pass half). Held on the port's two blocks, same weights."""
    torch.manual_seed(0)
    fused = tfb.FusedBottleneckBlock(32, FILTERS, 1, dtype=torch.float32)
    plain = tresnet.BottleneckBlock(32, FILTERS, 1, dtype=torch.float32,
                                    fused_bn=False)
    plain.load_state_dict(fused.state_dict())
    assert not fused.bn3.weight.any() and not fused.bn3.bias.any()
    rng = np.random.default_rng(5)
    x0 = np.maximum(rng.standard_normal((BATCH, 8, 8, 32)), 0.0).astype(
        np.float32)
    cot = _nchw(rng.standard_normal((BATCH, 8, 8, 32)).astype(np.float32))
    grads = []
    for block in (fused, plain):
        x = _nchw(x0).requires_grad_()
        block.train()(x).backward(cot)
        grads.append({"x": x.grad.numpy(), **{
            n: p.grad.numpy() for n, p in block.named_parameters()}})
    assert (grads[1]["x"][_nchw(x0).numpy() == 0] == 0).all()
    close_rel(grads[0], grads[1], F32)
