"""Model registry of the port: the causal LM and ResNet entries of the JAX
registry (``distributeddeeplearning_tpu/models/__init__.py``), same names
and parameter counts, plus small test entries of the port's own
(``gpt_nano``, ``llama_nano``, ``resnet_nano``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from distributeddeeplearning_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Registry entry: module factory, its known parameter count and its
    input kind ('tokens' or 'image', which picks the data and the loss)."""

    name: str
    build: Callable[..., Any]          # (dtype, ...) -> nn.Module
    param_count: int                   # known-good total, 0 = unchecked
    input_kind: str = "tokens"


def _registry() -> dict[str, ModelSpec]:
    from distributeddeeplearning_tpu_torch.models import gpt, llama, resnet

    def lm(name, build, params):
        return ModelSpec(name=name, build=build, param_count=params)

    def img(name, params):
        return ModelSpec(name=name, build=getattr(resnet, name),
                         param_count=params, input_kind="image")

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
    }


def model_spec(name: str) -> ModelSpec:
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
