"""Synthetic token batches for causal-LM training: counterpart of
``SyntheticCausalTokens`` in ``distributeddeeplearning_tpu/data/synthetic.py``.

Ids are uniform in [1, vocab) with an all-ones attention mask, drawn on the
device from a ``torch.Generator`` seeded by (seed, step), so a batch depends
only on its step and a resumed run sees the batches an unbroken one would.
The bits are not JAX's PRNG bits.
"""

from __future__ import annotations

import numpy as np
import torch


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """A 63-bit generator seed mixed from (seed, step, stream)."""
    state = np.random.SeedSequence([seed & 0xFFFFFFFF, step, stream])
    return int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


class SyntheticCausalTokens:
    """Plain id sequences for causal-LM training (no masking)."""

    def __init__(self, batch_size: int, seq_len: int = 128,
                 vocab_size: int = 50257, seed: int = 0, device=None):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed
        self.device = torch.device("cpu" if device is None else device)

    def batch(self, step: int) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, step))
        ids = torch.randint(1, self.vocab_size,
                            (self.batch_size, self.seq_len), generator=gen,
                            device=self.device)
        return {"input_ids": ids,
                "attention_mask": torch.ones_like(ids, dtype=torch.int32)}
