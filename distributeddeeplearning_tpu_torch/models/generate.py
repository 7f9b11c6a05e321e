"""Autoregressive generation for the causal LM families (GPT, Llama).

Counterpart of ``distributeddeeplearning_tpu/models/generate.py``. Two paths:

- default (``use_cache=False``): one fixed-shape padded forward per emitted
  token over the whole (B, prompt + new) buffer, the attention mask marking
  the live prefix, so the attention kernel sees S = prompt + new at every
  step. Works for every attention impl. O(S^2) per token.
- ``use_cache=True``: KV-cache decoding (models/decode_cache.py): one
  batched prefill forward primes the cache with the prompt, then one
  single-token forward per emitted token. O(S) per token.

Sampling: greedy (temperature 0) or temperature softmax with optional top-k
truncation, drawn from an explicit ``torch.Generator``. It cannot match
``jax.random`` bits; greedy decoding matches the JAX package token for token.
Beam search and speculative decoding come with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def decode_capacity(model) -> Optional[int]:
    """The model's static decode position/cache bound: ``max_position``
    (GPT) or ``decode_cache_len`` (Llama). None for models without either."""
    mcfg = getattr(model, "cfg", None)
    return (getattr(mcfg, "max_position", None)
            or getattr(mcfg, "decode_cache_len", None))


def _require_decode(model, total: int) -> None:
    """use_cache preconditions: a model with a decode mode, and a cache that
    holds the whole prompt + new budget."""
    if not hasattr(model, "init_cache"):
        raise ValueError(
            f"use_cache=True needs a model with a decode (KV-cache) mode — "
            f"the GPT/Llama families; {type(model).__name__} has none. "
            f"Use the default full-refeed path.")
    max_pos = decode_capacity(model)
    if max_pos is not None and total > max_pos:
        raise ValueError(
            f"this decode needs cache/position capacity {total} (prompt + "
            f"max_new_tokens) but the model's max_position/decode_cache_len "
            f"is {max_pos}")


def _make_sampler(temperature: float, top_k: int):
    def sample(logits, generator):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        logits = logits / temperature
        k = min(top_k, logits.shape[-1])  # top_k >= vocab = full sampling
        if k > 0:
            # Ties with the k-th logit stay in (logits < kth is cut).
            kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return sample


@torch.inference_mode()
def generate(model, prompt_ids, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None, pad_id: int = 0,
             use_cache: bool = False) -> torch.Tensor:
    """Extend ``prompt_ids`` (B, P) by ``max_new_tokens`` tokens on the
    model's device; returns (B, P + max_new_tokens) int64. Puts the model in
    eval mode. ``generator`` (on the model's device) drives sampling; the
    default is seeded with 0."""
    device = next(model.parameters()).device
    prompt_ids = torch.as_tensor(prompt_ids, dtype=torch.long, device=device)
    b, p = prompt_ids.shape
    total = p + max_new_tokens
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    sample = _make_sampler(temperature, top_k)
    model.eval()

    if use_cache:
        _require_decode(model, total)
        return _generate_cached(model, prompt_ids, total=total,
                                pad_id=pad_id, sample=sample,
                                generator=generator)

    ids = torch.full((b, total), pad_id, dtype=torch.long, device=device)
    ids[:, :p] = prompt_ids
    mask = torch.zeros((b, total), dtype=torch.int32, device=device)
    mask[:, :p] = 1
    for pos in range(p, total):
        logits = model(ids, attention_mask=mask)          # (B, total, V)
        ids[:, pos] = sample(logits[:, pos - 1], generator)
        mask[:, pos] = 1
    return ids


def _generate_cached(model, prompt_ids, *, total: int, pad_id: int, sample,
                     generator):
    """KV-cache decode: ONE batched prefill forward primes the cache with
    the whole prompt (its last logits predict position p), then one
    single-token forward per emitted token; the last token is sampled from
    the carried logits without a forward nobody would consume."""
    b, p = prompt_ids.shape
    ids = torch.full((b, total), pad_id, dtype=torch.long,
                     device=prompt_ids.device)
    ids[:, :p] = prompt_ids
    if total == p:
        return ids
    cache = model.init_cache(b)
    logits = model(prompt_ids, cache=cache)[:, -1]
    for t in range(p, total):
        tok = sample(logits, generator)
        ids[:, t] = tok
        if t < total - 1:
            logits = model(tok[:, None], cache=cache)[:, -1]
    return ids
