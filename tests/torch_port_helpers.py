"""Shared pieces of the PyTorch port's tests (tests/test_torch_*.py other
than the ResNet parity test).

Every port test feeds the same numpy arrays to the JAX function and its
port on the CPU. Torch runs on one thread in these modules, so a port test
never takes the cores the timing-sensitive JAX tests of other workers need.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from flax.linen import meta as flax_meta

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
