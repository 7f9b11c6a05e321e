"""The port's counter-based dropout hash (distributeddeeplearning_tpu_torch/
ops/hash_dropout.py) against the JAX package's, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops import hash_dropout as jhash
from distributeddeeplearning_tpu_torch.ops import hash_dropout as thash
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

SEEDS = [0, 1, -1, 2 ** 31 - 1, -(2 ** 31), 123456789, -987654321]


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_mask_matches_jax_bitwise(seed, rate):
    """Random coordinates, the rows near 2^32 where the uint32 arithmetic
    wraps: every bit of the mask agrees."""
    rng = np.random.default_rng(seed & 0xFFFF)
    n = 4096
    coords = [rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
              rng.integers(2 ** 32 - 2 * n, 2 ** 32, n,
                           dtype=np.uint64).astype(np.uint32),
              rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)]
    ref = np.asarray(jhash.keep_mask(jnp.int32(seed),
                                     *(jnp.asarray(c) for c in coords),
                                     rate))
    out = thash.keep_mask(seed, *(torch.from_numpy(c.astype(np.int64))
                                  for c in coords), rate)
    assert out.dtype == torch.bool
    np.testing.assert_array_equal(out.numpy(), ref)
    assert abs(out.float().mean().item() - (1 - rate)) < 0.03


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, -5, 2 ** 31 - 1])
def test_dense_keep_mask_matches_jax_bitwise(seed, rate):
    ref = np.asarray(jhash.dense_keep_mask(jnp.int32(seed), 2, 3, 37, 45,
                                           rate))
    out = thash.dense_keep_mask(seed, 2, 3, 37, 45, rate)
    assert out.shape == (2, 3, 37, 45)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_bh_offsets_place_a_shard_in_the_global_mask():
    """A (batch, head) shard with offsets sees its slice of the global
    mask, as the flash kernels' offsets make it."""
    full = thash.dense_keep_mask(11, 4, 6, 16, 16, 0.3)
    part = thash.dense_keep_mask(11, 2, 3, 16, 16, 0.3,
                                 bh_offsets=(2, 3, 6))
    np.testing.assert_array_equal(part.numpy(), full[2:, 3:].numpy())
