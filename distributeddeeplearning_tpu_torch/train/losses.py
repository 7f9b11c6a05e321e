"""Losses: counterpart of the causal-LM and classification functions of
``distributeddeeplearning_tpu/train/losses.py``.

Float32 loss math whatever the compute dtype (the models emit f32 logits):
bf16 softmax/CE is where mixed-precision training silently loses accuracy.
"""

from __future__ import annotations

from typing import Optional

import torch


def causal_lm_loss_sums(logits: torch.Tensor, input_ids: torch.Tensor,
                        attention_mask: Optional[torch.Tensor] = None):
    """(sum of next-token CE, predicted-token count): logits[:, t] predicts
    input_ids[:, t+1].

    Both sides of the shift must be real tokens: a padded query position
    produces a garbage logit row, so its prediction is not scored even when
    the target is real.
    """
    pred = logits[:, :-1].float()
    target = input_ids[:, 1:].long()
    per_tok = (torch.logsumexp(pred, dim=-1)
               - pred.gather(-1, target[..., None])[..., 0])
    if attention_mask is None:
        weights = torch.ones_like(per_tok)
    else:
        mask = attention_mask.float()
        weights = mask[:, :-1] * mask[:, 1:]
    return (per_tok * weights).sum(), weights.sum()


def causal_lm_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Next-token cross entropy, mean over predicted tokens (count clamped
    at 1)."""
    total, count = causal_lm_loss_sums(logits, input_ids, attention_mask)
    return total / count.clamp_min(1.0)


def smoothed_softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
                        smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed cross entropy, mean over the batch: (B, K) x (B,) ->
    (). The target is ``optax.smooth_labels``' (1 - smoothing) * one_hot +
    smoothing / K, so the loss is (1 - smoothing) * CE + smoothing * the mean
    of -log p over the classes."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if smoothing:
        nll = (1.0 - smoothing) * nll - smoothing * logp.mean(dim=-1)
    return nll.mean()


def top1_accuracy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()
