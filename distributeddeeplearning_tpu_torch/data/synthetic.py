"""Synthetic training batches: counterparts of ``SyntheticCausalTokens``
and ``SyntheticImages`` in ``distributeddeeplearning_tpu/data/synthetic.py``.

Token ids are uniform in [1, vocab) with an all-ones attention mask; images
are NHWC bfloat16 standard normals with labels uniform in [0, classes).
Both are drawn on the device from a ``torch.Generator`` seeded by (seed,
step), so a batch depends only on its step and a resumed run sees the
batches an unbroken one would. The bits are not JAX's PRNG bits.
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


class SyntheticImages:
    """Fake ImageNet batches (pure noise: no signal, a stable step cost):
    ``{"image": (B, S, S, 3) bfloat16, "label": (B,) int64}``."""

    def __init__(self, batch_size: int, image_size: int = 224,
                 num_classes: int = 1000, seed: int = 0, device=None):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        self.device = torch.device("cpu" if device is None else device)

    def batch(self, step: int) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, step))
        size = self.image_size
        image = torch.randn((self.batch_size, size, size, 3), generator=gen,
                            device=self.device, dtype=torch.bfloat16)
        label = torch.randint(0, self.num_classes, (self.batch_size,),
                              generator=gen, device=self.device)
        return {"image": image, "label": label}
