"""Model registry of the port: the causal LM, BERT, ResNet, DenseNet and
ViT entries of the JAX registry (``distributeddeeplearning_tpu/models/
__init__.py``), same names, objectives and parameter counts, plus small
test entries of the port's own (``gpt_nano``, ``llama_nano``,
``resnet_nano``, ``densenet_nano``). The JAX registry's MoE and pipelined
entries (``LATER_MODELS``) are refused by name."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from distributeddeeplearning_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Registry entry: module factory, its known parameter count, its
    input kind ('tokens' or 'image', which picks the data) and its
    objective ('classify', 'mlm' or 'causal', which picks the loss and,
    for token data, masked or plain ids)."""

    name: str
    build: Callable[..., Any]          # (dtype, ...) -> nn.Module
    param_count: int                   # known-good total, 0 = unchecked
    input_kind: str = "tokens"
    objective: str = "causal"


# Entries of the JAX registry that come with later slices of the port.
_MOE = "mixture-of-experts models (expert parallelism)"
_PIPELINE = "pipeline parallelism"
LATER_MODELS = {
    "bert_base_moe": _MOE, "bert_tiny_moe": _MOE, "bert_tiny_moe2": _MOE,
    "bert_base_pp": _PIPELINE, "bert_tiny_pp": _PIPELINE,
    "bert_tiny_pp4": _PIPELINE, "bert_tiny_pp44": _PIPELINE,
    "gpt2_small_pp": _PIPELINE, "gpt_tiny_pp": _PIPELINE,
}


def _registry() -> dict[str, ModelSpec]:
    from distributeddeeplearning_tpu_torch.models import (
        bert, densenet, gpt, llama, resnet, vit)

    def lm(name, build, params):
        return ModelSpec(name=name, build=build, param_count=params)

    def mlm(name, build, params):
        return ModelSpec(name=name, build=build, param_count=params,
                         objective="mlm")

    def img(name, params, family=resnet, build=None):
        return ModelSpec(name=name, build=build or getattr(family, name),
                         param_count=params, input_kind="image",
                         objective="classify")

    return {
        "gpt2_small": lm("gpt2_small", gpt.gpt2_small, 124_439_808),
        "gpt2_medium": lm("gpt2_medium", gpt.gpt2_medium, 354_823_168),
        "gpt_tiny": lm("gpt_tiny", gpt.tiny_gpt, 0),
        "gpt_nano": lm("gpt_nano", lambda **kw: gpt.tiny_gpt(
            **{"hidden_size": 32, "num_layers": 1, "num_heads": 2, **kw}), 0),
        "llama2_7b": lm("llama2_7b", llama.llama2_7b, 6_738_415_616),
        "tinyllama_1b": lm("tinyllama_1b", llama.tinyllama_1b,
                           1_100_048_384),
        "llama_tiny": lm("llama_tiny", llama.tiny_llama, 0),
        "llama_nano": lm("llama_nano", lambda **kw: llama.tiny_llama(
            **{"hidden_size": 32, "num_layers": 1, "num_heads": 2,
               "num_kv_heads": 1, "intermediate_size": 64, **kw}), 0),
        "resnet18": img("resnet18", 11_689_512),
        "resnet18_thin": img("resnet18_thin", 831_096),
        "resnet26_thin": img("resnet26_thin", 1_392_184),
        "resnet34": img("resnet34", 21_797_672),
        "resnet50": img("resnet50", 25_557_032),
        "resnet101": img("resnet101", 44_549_160),
        "resnet152": img("resnet152", 60_192_808),
        "resnet_nano": img("resnet_nano", 0),
        "densenet121": img("densenet121", 7_978_856, densenet),
        "densenet169": img("densenet169", 14_149_480, densenet),
        "densenet_nano": img("densenet_nano", 0, densenet),
        # Counts as timm's vit_{base,large}_patch16_224 at 224 px.
        "vit_b16": img("vit_b16", 86_567_656, vit),
        "vit_l16": img("vit_l16", 304_326_632, vit),
        "vit_tiny": img("vit_tiny", 0, build=vit.tiny_vit),
        # The tied MLM head included.
        "bert_base": mlm("bert_base", bert.bert_base_mlm, 109_514_298),
        "bert_large": mlm("bert_large", bert.bert_large_mlm, 335_174_458),
        "bert_tiny": mlm("bert_tiny", bert.tiny_bert_mlm, 0),
    }


def model_spec(name: str) -> ModelSpec:
    """The registry entry of ``name``; a ``KeyError`` names the later slice
    of a JAX entry the port does not carry yet."""
    if name in LATER_MODELS:
        raise KeyError(f"model {name!r} comes with a later slice of the "
                       f"port: {LATER_MODELS[name]}")
    reg = _registry()
    if name not in reg:
        raise KeyError(f"unknown model {name!r}; have {sorted(reg)}")
    return reg[name]


def get_model(name: str, *, dtype: torch.dtype = torch.bfloat16,
              device=None, **kw: Any):
    """Build a model by registry name on ``device`` (``cuda`` unless
    ``device='cpu'`` is asked for), in eval mode."""
    spec = model_spec(name)
    with torch.device(resolve_device(device)):
        return spec.build(dtype=dtype, **kw).eval()
