"""The port's gradient accumulation (``--accum``: train/steps.py) against
the JAX package (``tests/test_accum.py`` mirrored; the shared references
live in ``tests/test_torch_dp.py``).

- ``--accum 4`` at world 2 on two spawned gloo ranks (global batch 16:
  microbatches of 2 a rank), two sgd steps, against JAX
  ``make_dp_train_step`` with ``grad_accum_steps=4``, whose
  ``accumulated_grads`` sums the microbatches' gradients and divides once,
  updates the running buffers in sequence and averages the metrics: each
  step's loss, every parameter and running buffer within F32; both ranks
  the same state, bit for bit.
- On one rank, batch 8 as 4 microbatches of 2: the port's gradients,
  running buffers and loss against JAX ``accumulated_grads`` called
  directly; and without BatchNorm, 4 microbatches make the big batch's
  update over 3 momentum steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from distributeddeeplearning_tpu import config as jconfig
from distributeddeeplearning_tpu.models import resnet as jresnet
from distributeddeeplearning_tpu.train import steps as jsteps
from distributeddeeplearning_tpu_torch.train import optim as topt
from distributeddeeplearning_tpu_torch.train import steps as tsteps
from distributeddeeplearning_tpu_torch.train.state import TrainState
from distributeddeeplearning_tpu_torch.utils.weights import (
    batch_stats_to_flax, params_to_flax)
from tests.test_torch_dp import (BATCH, SIZE, VARIABLES, WEIGHTS,
                                 assert_matches, assert_replicated, jax_dp,
                                 make_batches, spawn)
from tests.torch_dist_helpers import CLASSES, nano_config, train_steps
from tests.torch_port_helpers import (F32, close_rel,  # noqa: F401
                                      flat_params, one_torch_thread)

ACCUM = 4
BATCHES = make_batches(15, 2, batch=2 * BATCH)
CASES = {"accum": ({"grad_accum_steps": ACCUM,
                    "global_batch_size": 2 * BATCH}, BATCHES)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("accum"), CASES)


def test_dp_accum_matches_jax(ranks):
    ref = jax_dp(BATCHES, accum=ACCUM)
    assert_matches(ranks.results()[0]["accum"], ref)
    assert_replicated(ranks, CASES)


def test_accum_matches_jax_accumulated_grads():
    """The summed-then-divided gradients, the running buffers updated in
    sequence through the microbatches and the averaged loss of one step
    on one rank."""
    image, label = make_batches(16, 1)[0]
    model = jresnet.ResNet([1, 1], jresnet.BottleneckBlock,
                           num_classes=CLASSES, width=8, dtype=jnp.float32)
    loss_fn = jsteps.loss_fn_for(
        model, "image", jconfig.TrainConfig(model="resnet18",
                                            dtype="float32"))
    grads, new_bn, metrics = jax.jit(
        lambda p, bn, b: jsteps.accumulated_grads(
            loss_fn, p, bn, b, jax.random.key(0), ACCUM))(
        VARIABLES["params"], VARIABLES["batch_stats"],
        {"image": image, "label": label})
    out = train_steps(nano_config(grad_accum_steps=ACCUM), WEIGHTS,
                      [(image, label)])
    np.testing.assert_allclose(out["metrics"][0]["loss"],
                               float(metrics["loss"]), rtol=1e-5)
    close_rel(params_to_flax({k: torch.from_numpy(v)
                              for k, v in out["grads"].items()}),
              flat_params(jax.device_get(grads)), F32)
    close_rel(batch_stats_to_flax({k: torch.from_numpy(v)
                                   for k, v in out["state"].items()}),
              flat_params(jax.device_get(new_bn)), F32)


def test_accum_matches_big_batch_without_batchnorm():
    """Without batch statistics, 4 microbatches make the big batch's
    update (to f32 summation order), over 3 momentum steps."""
    def run(accum):
        torch.manual_seed(0)
        net = nn.Sequential(nn.Flatten(), nn.Linear(SIZE * SIZE * 3, 16),
                            nn.ReLU(), nn.Linear(16, CLASSES))
        cfg = nano_config(grad_accum_steps=accum)
        opt, sched = topt.make_optimizer(cfg.optimizer, net, BATCH, 3)
        state = TrainState(step=0, model=net, optimizer=opt)
        step = tsteps.make_train_step(cfg, sched)
        for image, label in make_batches(14, 3):
            step(state, {"image": torch.from_numpy(image),
                         "label": torch.from_numpy(label)})
        return {n: p.detach().numpy() for n, p in net.named_parameters()}

    close_rel(run(ACCUM), run(1), F32)
