"""The port's cross-replica BatchNorm (``--sync-bn``: models/resnet.py,
models/fused_block.py, parallel/collectives.py) on two spawned gloo
ranks, against the JAX package (``tests/test_sync_bn.py`` mirrored; the
shared references live in ``tests/test_torch_dp.py``).

- Two sgd steps of ``resnet_nano`` with sync at world 2 against JAX
  ``make_dp_train_step`` with ``bn_axis_name`` on a 2-device CPU mesh, and
  against one rank on the whole batch: losses, every parameter and
  running buffer within F32. Per-shard statistics miss the whole batch.
- ``--fused-block --fused-conv3`` (the kernels' plain versions here) with
  sync: the epilogue sums averaged over the ranks give the unfused sync
  step's trajectory, and JAX's.
- Both ranks end each case with the same state, bit for bit.
"""

import pytest

from tests.test_torch_dp import (BATCHES, WEIGHTS, assert_matches,
                                 assert_replicated, jax_dp, spawn)
from tests.torch_dist_helpers import nano_config, train_steps
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

CASES = {
    "plain": ({}, BATCHES),
    "sync": ({"sync_bn": True}, BATCHES),
    "fused_sync": ({"sync_bn": True, "fused_block": True,
                    "fused_conv3": True}, BATCHES),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("sync_bn"), CASES)


@pytest.fixture(scope="module")
def jax_sync():
    return jax_dp(BATCHES, sync=True)


def test_sync_bn_matches_jax_and_the_whole_batch(ranks, jax_sync):
    whole = train_steps(nano_config(), WEIGHTS, BATCHES)
    out = ranks.results()[0]
    assert_matches(out["sync"], jax_sync)
    assert_matches(out["sync"], whole)
    # Per-shard statistics (batch 4 a rank) are not the whole batch's.
    assert abs(out["plain"]["metrics"][1]["loss"]
               - whole["metrics"][1]["loss"]) > 1e-4


def test_fused_block_sync_matches_unfused_sync(ranks, jax_sync):
    out = ranks.results()[0]
    assert_matches(out["fused_sync"], out["sync"])
    assert_matches(out["fused_sync"], jax_sync)


def test_params_stay_replicated(ranks):
    assert_replicated(ranks, CASES)
