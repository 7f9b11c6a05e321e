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

Two deterministic decoders beside it, as in the JAX package:
:func:`generate_beam` (beam search, by refeed or over per-beam KV caches)
and :func:`generate_speculative` (a drafter proposes, the target verifies a
block in one forward; exactly the target's greedy continuation).
"""

from __future__ import annotations

from typing import Optional

import torch

# A dead beam's score: far below any reachable log-probability sum.
NEG_SCORE = -1e9


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


@torch.inference_mode()
def generate_beam(model, prompt_ids, *, max_new_tokens: int,
                  num_beams: int = 4, length_penalty: float = 1.0,
                  eos_id: Optional[int] = None, pad_id: int = 0,
                  use_cache: bool = False) -> torch.Tensor:
    """Beam-search decoding: (B, P) -> (B, P + max_new_tokens) int64 on the
    model's device. Puts the model in eval mode.

    Beams live as a flattened (B*K, total) batch through the same padded
    forward the sampling path uses, so every causal variant (dense or
    flash, GPT or Llama) works unchanged. Each step, every batch row ranks
    its K*V candidate extensions by accumulated log-probability and keeps
    the top K; a beam that emitted ``eos_id`` is frozen (it extends only
    with ``pad_id`` at unchanged score). The final ranking divides scores
    by (emitted length) ** ``length_penalty``. No randomness anywhere.

    ``use_cache=True`` keeps per-beam KV caches: one prefill at batch B,
    its cache rows expanded to B*K, then each step the rows are reordered
    by surviving parent beam and one single-token forward runs, O(S) per
    token instead of the refeed's O(S^2), with the same tokens."""
    device = next(model.parameters()).device
    prompt_ids = torch.as_tensor(prompt_ids, dtype=torch.long, device=device)
    b, p = prompt_ids.shape
    k = num_beams
    if k < 1:
        raise ValueError(f"num_beams={num_beams}: need >= 1")
    total = p + max_new_tokens
    model.eval()

    # (B, K, total); beam 0 holds the prompt, beams 1..K-1 start dead so
    # step 1 fans out from the prompt alone.
    ids = torch.full((b, k, total), pad_id, dtype=torch.long, device=device)
    ids[:, :, :p] = prompt_ids[:, None, :]
    scores = torch.full((b, k), NEG_SCORE, device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=device)

    def select(next_logits, ids, scores, finished, pos):
        """Extend every live beam by its continuations, keep K per batch
        row, reorder the survivors."""
        logp = torch.log_softmax(next_logits.float(), dim=-1).reshape(b, k, -1)
        v = logp.shape[-1]
        if eos_id is not None:
            # A finished beam contributes one candidate: itself, extended
            # by pad at unchanged score (scored on the pad lane).
            frozen = torch.full_like(logp, NEG_SCORE)
            frozen[:, :, pad_id] = 0.0
            logp = torch.where(finished[:, :, None], frozen, logp)
        cand = scores[:, :, None] + logp                   # (B, K, V)
        top_scores, flat = torch.topk(cand.reshape(b, k * v), k, dim=1)
        beam_idx, tok = flat // v, flat % v
        ids = torch.gather(ids, 1, beam_idx[:, :, None].expand(-1, -1, total))
        ids[:, :, pos] = tok
        if eos_id is not None:
            finished = torch.gather(finished, 1, beam_idx) | (tok == eos_id)
        return ids, top_scores, finished, beam_idx, tok

    if use_cache:
        ids, scores, finished = _beam_cached(
            model, prompt_ids, ids, scores, finished, select, total=total,
            num_beams=k)
    else:
        mask = torch.zeros((b * k, total), dtype=torch.int32, device=device)
        mask[:, :p] = 1
        for pos in range(p, total):
            logits = model(ids.reshape(b * k, total), attention_mask=mask)
            ids, scores, finished, _, _ = select(
                logits[:, pos - 1], ids, scores, finished, pos)
            mask[:, pos] = 1

    if eos_id is not None:
        # Emitted length: tokens up to and including eos, or the whole
        # budget for an unfinished beam.
        is_eos = ids[:, :, p:] == eos_id
        first_eos = torch.argmax(is_eos.int(), dim=-1)
        length = torch.where(is_eos.any(dim=-1), first_eos + 1,
                             torch.full_like(first_eos, max_new_tokens))
    else:
        length = torch.full((b, k), max_new_tokens, device=device)
    norm = scores / length.clamp(min=1).float() ** float(length_penalty)
    best = torch.argmax(norm, dim=1)
    return ids[torch.arange(b, device=device), best]


def _beam_cached(model, prompt_ids, ids, scores, finished, select, *,
                 total: int, num_beams: int):
    """KV-cache beam search: prefill once at batch B, expand the cache rows
    to B*K, then per step reorder them by surviving parent beam and run one
    single-token forward. The last token needs a selection and no forward,
    so the loop stops one step early and the last ``select`` runs after
    it."""
    b, p = prompt_ids.shape
    k = num_beams
    if total == p:   # nothing to select or forward
        return ids, scores, finished
    _require_decode(model, total)
    cache = model.init_cache(b)
    logits = model(prompt_ids, cache=cache)[:, -1]
    # Row b*K + j is beam j of batch row b.
    cache.map_rows(lambda x: x.repeat_interleave(k, dim=0))
    next_logits = logits.repeat_interleave(k, dim=0)        # (B*K, V)
    batch_base = torch.arange(b, device=prompt_ids.device)[:, None] * k
    for t in range(p, total - 1):
        ids, scores, finished, beam_idx, tok = select(
            next_logits, ids, scores, finished, t)
        rows = (batch_base + beam_idx).reshape(-1)
        cache.map_rows(lambda x: x.index_select(0, rows))
        next_logits = model(tok.reshape(b * k, 1), cache=cache)[:, -1]
    ids, scores, finished, _, _ = select(next_logits, ids, scores, finished,
                                         total - 1)
    return ids, scores, finished


@torch.inference_mode()
def generate_speculative(target_model, draft_model, prompt_ids, *,
                         max_new_tokens: int, draft_len: int = 4,
                         pad_id: int = 0) -> torch.Tensor:
    """Speculative greedy decoding: the drafter proposes, the target
    verifies. (1, P) -> (1, P + max_new_tokens) int64.

    Each round the drafter emits ``draft_len`` greedy tokens by single-token
    forwards; the target scores them all in one block forward and accepts
    the longest prefix that matches its own greedy choices, emitting its
    correction at the first mismatch. Every round advances at least one
    token, and the output is exactly the target's greedy continuation. A
    round whose ``draft_len`` proposals are all accepted emits them without
    a bonus token, so both caches rewind to one index
    (:meth:`KVCache.rewind`).

    Batch 1 only (acceptance lengths differ per row; the cache index is
    shared by the rows), greedy only, and both models share a vocabulary.
    """
    device = next(target_model.parameters()).device
    prompt_ids = torch.as_tensor(prompt_ids, dtype=torch.long, device=device)
    b, p = prompt_ids.shape
    if b != 1:
        raise ValueError(
            f"speculative decoding is batch-1 only (got batch {b}): "
            f"per-row acceptance lengths cannot share the per-layer "
            f"scalar cache indices")
    if p < 2:
        raise ValueError("speculative decoding needs a prompt of >= 2 "
                         "tokens (the prefill feeds all but the last)")
    if draft_len < 1:
        raise ValueError(f"draft_len={draft_len}: need >= 1 proposal per "
                         f"verify round")
    total = p + max_new_tokens
    k = draft_len
    # The last verify round writes up to k cache slots past ``total``
    # before the rewind; both caches must hold them.
    _require_decode(target_model, total + k)
    _require_decode(draft_model, total + k)
    target_model.eval()
    draft_model.eval()

    # Prefill both on all but the last prompt token: the caches hold
    # positions [0, pos - 1) and ``last`` is decided but not fed.
    t_cache = target_model.init_cache(1)
    d_cache = draft_model.init_cache(1)
    target_model(prompt_ids[:, :-1], cache=t_cache)
    draft_model(prompt_ids[:, :-1], cache=d_cache)
    ids = torch.full((1, total), pad_id, dtype=torch.long, device=device)
    ids[:, :p] = prompt_ids
    pos = p
    last = prompt_ids[:, -1]
    while pos < total:
        feed, proposals = last, []
        for _ in range(k):
            feed = torch.argmax(
                draft_model(feed[:, None], cache=d_cache)[:, -1], dim=-1)
            proposals.append(feed)
        d_block = torch.stack(proposals, dim=1)             # (1, K)
        block = torch.cat([last[:, None], d_block], dim=1)  # (1, K + 1)
        greedy = torch.argmax(target_model(block, cache=t_cache), dim=-1)
        # greedy[:, j] is the target's choice for position pos + j.
        match = (d_block == greedy[:, :k])[0].tolist()
        m = match.index(False) if False in match else k
        emit = torch.cat([d_block[:, :m], greedy[:, m:m + 1]], dim=1)[:, :k]
        n_emit = min(k if m == k else m + 1, total - pos)
        ids[:, pos:pos + n_emit] = emit[:, :n_emit]
        pos += n_emit
        last = ids[:, pos - 1]
        t_cache.rewind(pos - 1)
        d_cache.rewind(pos - 1)
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
