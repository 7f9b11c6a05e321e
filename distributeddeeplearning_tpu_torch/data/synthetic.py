"""Synthetic training batches: counterparts of ``SyntheticCausalTokens``,
``SyntheticTokens`` and ``SyntheticImages`` in
``distributeddeeplearning_tpu/data/synthetic.py``.

Causal-LM ids are uniform in [1, vocab) with an all-ones attention mask;
masked-LM ids are uniform above the reserved range, with [MASK] written
at a random 15% of the positions (dense) or at exactly ``max_predictions``
positions a row (gathered); images are NHWC bfloat16 standard normals with
labels uniform in [0, classes).
Both are drawn on the device from a ``torch.Generator`` seeded by (seed,
step), so a batch depends only on its step and a resumed run sees the
batches an unbroken one would. The bits are not JAX's PRNG bits.
``learnable`` images add a class pattern keyed by (seed, label) to 0.7 of
the noise, in JAX's bf16 arithmetic (``learnable_images``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def step_seed(seed: int, step: int, stream: int = 0, *fold: int) -> int:
    """A 63-bit generator seed mixed from (seed, step, stream) and any
    further ``fold`` words (none: the seed of (seed, step, stream))."""
    state = np.random.SeedSequence([seed & 0xFFFFFFFF, step, stream, *fold])
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


MASK_TOKEN_ID = 103  # [MASK] in the BERT-base uncased vocabulary


class SyntheticTokens:
    """Masked-LM batches: ``input_ids`` (B, S) with [MASK] written in at
    the targets and an all-ones ``attention_mask``; dense, ``labels`` (B, S)
    are the original ids at the targets (each position one with
    probability ``mask_prob``) and -1 elsewhere; with ``max_predictions`` >
    0, gathered: ``masked_positions`` (B, P), P = ``max_predictions``
    distinct sorted positions a row, and ``masked_labels`` (B, P) the ids
    there, for the gather head."""

    def __init__(self, batch_size: int, seq_len: int = 128,
                 vocab_size: int = 30522, mask_prob: float = 0.15,
                 seed: int = 0, device=None, max_predictions: int = 0):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.mask_prob = mask_prob
        self.seed = seed
        self.device = torch.device("cpu" if device is None else device)
        self.max_predictions = max_predictions

    def batch(self, step: int) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, step))
        shape = (self.batch_size, self.seq_len)
        # Above the reserved ids, but inside small test vocabularies.
        lo = min(1000, self.vocab_size // 2)
        ids = torch.randint(lo, self.vocab_size, shape, generator=gen,
                            device=self.device)
        mask = torch.ones(shape, dtype=torch.int32, device=self.device)
        if self.max_predictions > 0:
            order = torch.rand(shape, generator=gen,
                               device=self.device).argsort(dim=1)
            pos = order[:, :self.max_predictions].sort(dim=1).values
            rows = torch.arange(self.batch_size, device=self.device)[:, None]
            labels = ids[rows, pos]
            input_ids = ids.clone()
            input_ids[rows, pos] = MASK_TOKEN_ID
            return {"input_ids": input_ids, "attention_mask": mask,
                    "masked_positions": pos.to(torch.int32),
                    "masked_labels": labels.to(torch.int32)}
        masked = torch.rand(shape, generator=gen,
                            device=self.device) < self.mask_prob
        return {"input_ids": torch.where(masked, MASK_TOKEN_ID, ids),
                "labels": torch.where(masked, ids, -1).to(torch.int32),
                "attention_mask": mask}


# The generator stream of the class patterns (JAX folds this into its key).
PATTERN_STREAM = 0x5157


def learnable_images(noise: torch.Tensor,
                     patterns: torch.Tensor) -> torch.Tensor:
    """``0.7 * noise + patterns`` as the JAX generator computes it in bf16:
    0.7 rounded to bf16, each product and sum rounded to bf16."""
    return noise * torch.tensor(0.7, dtype=noise.dtype) + patterns


class SyntheticImages:
    """Fake ImageNet batches: ``{"image": (B, S, S, 3) bfloat16, "label":
    (B,) int64}``. Pure noise by default (no signal, a stable step cost);
    ``learnable`` embeds a fixed class-conditioned pattern under the noise,
    the same at every step, so top-1 can rise above chance."""

    def __init__(self, batch_size: int, image_size: int = 224,
                 num_classes: int = 1000, seed: int = 0, device=None,
                 learnable: bool = False):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        self.device = torch.device("cpu" if device is None else device)
        self.learnable = learnable

    def pattern(self, label: int) -> torch.Tensor:
        """The (S, S, 3) bf16 pattern of class ``label``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, label, PATTERN_STREAM))
        size = self.image_size
        return torch.randn((size, size, 3), generator=gen,
                           device=self.device, dtype=torch.bfloat16)

    def batch(self, step: int) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, step))
        size = self.image_size
        image = torch.randn((self.batch_size, size, size, 3), generator=gen,
                            device=self.device, dtype=torch.bfloat16)
        label = torch.randint(0, self.num_classes, (self.batch_size,),
                              generator=gen, device=self.device)
        if self.learnable:
            classes, index = torch.unique(label, return_inverse=True)
            table = torch.stack([self.pattern(int(c)) for c in classes])
            image = learnable_images(image, table[index])
        return {"image": image, "label": label}


def make_source(config, input_kind: str = "image", device=None, *,
                objective: str = "classify",
                vocab_size: Optional[int] = None):
    """The synthetic source of the model's input kind and objective:
    causal-LM ids or masked-LM batches over ``vocab_size`` (the model's),
    or images of ``config.data``."""
    d = config.data
    if input_kind == "tokens" and objective == "causal":
        return SyntheticCausalTokens(config.global_batch_size, d.seq_len,
                                     vocab_size, config.seed, device)
    if input_kind == "tokens":
        return SyntheticTokens(config.global_batch_size, d.seq_len,
                               vocab_size, d.mlm_mask_prob, config.seed,
                               device,
                               max_predictions=d.mlm_max_predictions)
    return SyntheticImages(config.global_batch_size, d.image_size,
                           d.num_classes, config.seed, device,
                           learnable=d.synthetic_learnable)
