#!/usr/bin/env python
"""Sampling CLI of the PyTorch port: load flax-layout weights, extend prompts.

    python -m distributeddeeplearning_tpu_torch.generate --model gpt2_small \
        --params gpt2_small.npz --prompt-ids 464,3290,318 \
        --max-new-tokens 32 --attn flash

The counterpart of the root ``generate.py``, with its flags where they apply.
Weights come from ``--params``: an ``.npz`` of the JAX package's ``params``
collection with ``/``-joined paths (orbax checkpoints need JAX to read).
Computes in float32. Runs on the GPU unless ``--device cpu`` is given.
Prints one ``{"tokens": [...]}`` line per prompt.

``--num-beams K`` decodes by beam search (with ``--length-penalty``,
``--eos-id`` and ``--use-cache``); ``--draft-model NAME --draft-params
FILE`` decodes speculatively, ``--draft-len`` proposals a round, batch 1
and greedy, exactly the target's greedy continuation.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional

import numpy as np
import torch

from distributeddeeplearning_tpu_torch import resolve_device
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.models.generate import (
    generate, generate_beam, generate_speculative)
from distributeddeeplearning_tpu_torch.utils.weights import params_from_flax

_EMBEDDINGS = ("wte", "embed_tokens")


def load_model(name: str, params_path: str, *, attn: str = "dense",
               seq_len: Optional[int] = None,
               vocab_size: Optional[int] = None, device=None):
    """Build registry model ``name`` in float32 and load a flax-layout
    ``.npz`` into it. The vocabulary defaults to the rows of the file's token
    embedding."""
    with np.load(params_path) as npz:
        state = params_from_flax(dict(npz))
    if vocab_size is None:
        rows = [state[k].shape[0] for k in _EMBEDDINGS if k in state]
        if not rows:
            raise ValueError(f"{params_path}: no token embedding "
                             f"({' or '.join(_EMBEDDINGS)}) in the params")
        vocab_size = rows[0]
    model = get_model(name, dtype=torch.float32, device=device,
                      vocab_size=vocab_size, seq_len=seq_len,
                      attention_impl=attn)
    model.load_state_dict(state)
    return model


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="gpt2_small")
    p.add_argument("--params", default=None,
                   help="flax-layout params .npz ('/'-joined paths)")
    p.add_argument("--prompt-ids", action="append", required=True,
                   help="comma-separated token ids; repeat for a batch "
                        "(rows must share a length)")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=None,
                   help="model context length (defaults to prompt+new)")
    p.add_argument("--vocab-size", type=int, default=None,
                   help="defaults to the params' embedding rows")
    p.add_argument("--attn", default="dense", choices=["dense", "flash"],
                   help="attention impl: dense, or the flash kernel")
    p.add_argument("--use-cache", action="store_true",
                   help="KV-cache incremental decoding: O(S) per token "
                        "instead of full-refeed O(S^2)")
    p.add_argument("--num-beams", type=int, default=0,
                   help="beam-search decoding with this many beams "
                        "(deterministic; overrides temperature/top-k; "
                        "composes with --use-cache)")
    p.add_argument("--length-penalty", type=float, default=1.0,
                   help="beam scores divide by length**alpha (>1 favors "
                        "longer hypotheses); only with --num-beams")
    p.add_argument("--eos-id", type=int, default=None,
                   help="end-of-sequence token id for beam search "
                        "(finished beams freeze and pad)")
    p.add_argument("--draft-model", default=None,
                   help="speculative decoding: draft-model name (same "
                        "vocabulary); emits the exact target greedy "
                        "continuation with fewer target forwards. "
                        "Batch 1, greedy only")
    p.add_argument("--draft-params", default=None,
                   help="flax-layout params .npz of --draft-model")
    p.add_argument("--draft-len", type=int, default=4,
                   help="draft tokens proposed per verify round")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    prompts = [[int(t) for t in row.split(",")] for row in args.prompt_ids]
    if len({len(r) for r in prompts}) != 1:
        raise SystemExit("all --prompt-ids rows must share a length")
    total = len(prompts[0]) + args.max_new_tokens
    if args.params is None:
        raise SystemExit("no --params file given; refusing to sample from "
                         "randomly initialized weights")
    if args.draft_model:
        if args.num_beams or args.temperature > 0:
            raise SystemExit("--draft-model (speculative) is greedy and "
                             "single-stream; drop --num-beams/--temperature")
        if args.use_cache:
            raise SystemExit("--draft-model decodes through KV caches "
                             "already; drop --use-cache")
        if args.draft_len < 1:
            raise SystemExit(f"--draft-len {args.draft_len}: need >= 1")
        if not args.draft_params:
            raise SystemExit("--draft-model needs --draft-params")
    # The speculative path writes up to draft_len cache slots past
    # ``total`` before each rewind: both models get that much slack.
    slack = args.draft_len if args.draft_model else 0

    model = load_model(args.model, args.params, attn=args.attn,
                       seq_len=(args.seq_len or total) + slack,
                       vocab_size=args.vocab_size, device=device)
    if not all(0 <= t < model.cfg.vocab_size for r in prompts for t in r):
        raise SystemExit(f"prompt ids must lie in [0, "
                         f"{model.cfg.vocab_size})")
    if ((args.use_cache or args.draft_model)
            and hasattr(model.cfg, "decode_cache_len")):
        # Right-size the Llama KV cache to this request (only init_cache
        # reads it): a fixed default buffer would be mostly unused.
        model.cfg = dataclasses.replace(model.cfg,
                                        decode_cache_len=total + slack)
    if args.draft_model:
        draft = load_model(args.draft_model, args.draft_params,
                           attn=args.attn, seq_len=total + slack,
                           vocab_size=model.cfg.vocab_size, device=device)
        if hasattr(draft.cfg, "decode_cache_len"):
            draft.cfg = dataclasses.replace(draft.cfg,
                                            decode_cache_len=total + slack)
        out = generate_speculative(model, draft, prompts,
                                   max_new_tokens=args.max_new_tokens,
                                   draft_len=args.draft_len)
    elif args.num_beams > 0:
        out = generate_beam(model, prompts,
                            max_new_tokens=args.max_new_tokens,
                            num_beams=args.num_beams,
                            length_penalty=args.length_penalty,
                            eos_id=args.eos_id, use_cache=args.use_cache)
    else:
        out = generate(model, prompts, max_new_tokens=args.max_new_tokens,
                       temperature=args.temperature, top_k=args.top_k,
                       generator=torch.Generator(device=device).manual_seed(
                           args.seed),
                       use_cache=args.use_cache)
    for row in out.tolist():
        print(json.dumps({"tokens": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
