"""Losses: counterpart of the masked-LM, causal-LM and classification
functions of ``distributeddeeplearning_tpu/train/losses.py``.

Float32 loss math whatever the compute dtype (the models emit f32 logits):
bf16 softmax/CE is where mixed-precision training silently loses accuracy.
"""

from __future__ import annotations

from typing import Optional

import torch


def mlm_loss_sums(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of per-token CE over the masked positions, their count).

    ``labels`` (B, S) or (B, P) integer, -1 where a position is not a
    target (the ignore index). The sums aggregate exactly over batches
    (eval perplexity); :func:`mlm_loss` is their mean."""
    logits = logits.float()
    weights = (labels >= 0).float()
    target = labels.long().clamp_min(0)
    per_tok = (torch.logsumexp(logits, dim=-1)
               - logits.gather(-1, target[..., None])[..., 0])
    return (per_tok * weights).sum(), weights.sum()


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked-LM cross entropy: mean over the masked positions, the count
    clamped at 1 (a batch with no target gives 0)."""
    total, count = mlm_loss_sums(logits, labels)
    return total / count.clamp_min(1.0)


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
    weights = causal_lm_weights(input_ids, attention_mask)
    return (per_tok * weights).sum(), weights.sum()


def causal_lm_weights(input_ids: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The (B, S - 1) float 0/1 weights of the scored predictions: 1 where
    the query and its target are both real tokens. Their sum is the count
    :func:`causal_lm_loss_sums` returns, known before the forward."""
    if attention_mask is None:
        b, s = input_ids.shape
        return torch.ones((b, s - 1), device=input_ids.device)
    mask = attention_mask.float()
    return mask[:, :-1] * mask[:, 1:]


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
