"""HuggingFace checkpoints <-> the port's ``state_dict`` (BERT, GPT-2,
Llama).

The port's copy of ``distributeddeeplearning_tpu/utils/hf_convert.py``:
each ``*_params_from_hf`` maps a HuggingFace state dict onto the flax
layout as the JAX converter does and carries it to the port's names with
``utils/weights.params_from_flax``; each ``*_params_to_hf`` reads the
port's ``state_dict`` through ``params_to_flax`` and writes the HF names.
The functions take a ``{name: numpy array}`` dict (use
:func:`state_dict_to_numpy` on a torch state dict) and never import
``transformers``.

Weight layouts handled here:
- a torch ``nn.Linear`` stores (out, in): transposed to the flax (in, out)
  kernel, which ``params_from_flax`` turns back into the port's (out, in);
- GPT-2's Conv1D stores (in, out): no transpose, and its fused
  ``c_attn`` splits into query/key/value thirds;
- Llama's projections transpose; GQA's K/V keep their narrower width;
- BERT's decoder is tied to ``word_embeddings``, so only the transform,
  its LayerNorm and the output bias are mapped for the head.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.utils.weights import (
    params_from_flax, params_to_flax)


def state_dict_to_numpy(sd: Mapping[str, Any]) -> dict:
    """A torch state dict as plain numpy arrays (what every function here
    takes)."""
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _dense_t(sd, prefix):
    """torch nn.Linear (out, in) -> flax {'kernel': (in, out), 'bias'}."""
    out = {"kernel": sd[prefix + ".weight"].T}
    if prefix + ".bias" in sd:
        out["bias"] = sd[prefix + ".bias"]
    return out


def _ln(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _llama_flax(sd: Mapping[str, Any], num_layers: int) -> dict:
    def layer(i):
        p = f"model.layers.{i}."
        return {
            "attention_norm": {"scale": sd[p + "input_layernorm.weight"]},
            "mlp_norm": {"scale": sd[p + "post_attention_layernorm.weight"]},
            "attention": {
                "q_proj": {"kernel": sd[p + "self_attn.q_proj.weight"].T},
                "k_proj": {"kernel": sd[p + "self_attn.k_proj.weight"].T},
                "v_proj": {"kernel": sd[p + "self_attn.v_proj.weight"].T},
                "o_proj": {"kernel": sd[p + "self_attn.o_proj.weight"].T},
            },
            "gate_proj": {"kernel": sd[p + "mlp.gate_proj.weight"].T},
            "up_proj": {"kernel": sd[p + "mlp.up_proj.weight"].T},
            "down_proj": {"kernel": sd[p + "mlp.down_proj.weight"].T},
        }

    params = {
        "embed_tokens": sd["model.embed_tokens.weight"],
        "final_norm": {"scale": sd["model.norm.weight"]},
        **{f"layer{i}": layer(i) for i in range(num_layers)},
    }
    # A tie_word_embeddings checkpoint has no lm_head tensor; the port's
    # model always holds the head.
    head = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])
    params["lm_head"] = {"kernel": head.T}
    return params


def _gpt2_flax(sd: Mapping[str, Any], num_layers: int) -> dict:
    def layer(i):
        p = f"transformer.h.{i}."
        qkv_w = sd[p + "attn.c_attn.weight"]
        qkv_b = sd[p + "attn.c_attn.bias"]
        h = qkv_w.shape[0]
        return {
            "ln1": _ln(sd, p + "ln_1"),
            "ln2": _ln(sd, p + "ln_2"),
            "attention": {
                "query": {"kernel": qkv_w[:, :h], "bias": qkv_b[:h]},
                "key": {"kernel": qkv_w[:, h:2 * h],
                        "bias": qkv_b[h:2 * h]},
                "value": {"kernel": qkv_w[:, 2 * h:], "bias": qkv_b[2 * h:]},
                "output": {"kernel": sd[p + "attn.c_proj.weight"],
                           "bias": sd[p + "attn.c_proj.bias"]},
            },
            "mlp_in": {"kernel": sd[p + "mlp.c_fc.weight"],
                       "bias": sd[p + "mlp.c_fc.bias"]},
            "mlp_out": {"kernel": sd[p + "mlp.c_proj.weight"],
                        "bias": sd[p + "mlp.c_proj.bias"]},
        }

    return {
        "wte": sd["transformer.wte.weight"],
        "wpe": sd["transformer.wpe.weight"],
        "ln_f": _ln(sd, "transformer.ln_f"),
        **{f"layer{i}": layer(i) for i in range(num_layers)},
    }


def _bert_flax(sd: Mapping[str, Any], num_layers: int) -> dict:
    def layer(i):
        p = f"bert.encoder.layer.{i}."
        return {
            "attention": {
                "query": _dense_t(sd, p + "attention.self.query"),
                "key": _dense_t(sd, p + "attention.self.key"),
                "value": _dense_t(sd, p + "attention.self.value"),
                "output": _dense_t(sd, p + "attention.output.dense"),
            },
            "attention_ln": _ln(sd, p + "attention.output.LayerNorm"),
            "intermediate": _dense_t(sd, p + "intermediate.dense"),
            "mlp_output": _dense_t(sd, p + "output.dense"),
            "mlp_ln": _ln(sd, p + "output.LayerNorm"),
        }

    return {
        "word_embeddings": sd["bert.embeddings.word_embeddings.weight"],
        "position_embeddings": sd[
            "bert.embeddings.position_embeddings.weight"],
        "type_embeddings": sd["bert.embeddings.token_type_embeddings.weight"],
        "embeddings_ln": _ln(sd, "bert.embeddings.LayerNorm"),
        "mlm_transform": _dense_t(sd, "cls.predictions.transform.dense"),
        "mlm_ln": _ln(sd, "cls.predictions.transform.LayerNorm"),
        "mlm_bias": sd["cls.predictions.bias"],
        **{f"layer{i}": layer(i) for i in range(num_layers)},
    }


def llama_params_from_hf(sd: Mapping[str, Any], num_layers: int
                         ) -> dict[str, torch.Tensor]:
    """transformers.LlamaForCausalLM state dict -> the port's Llama
    ``state_dict``."""
    return params_from_flax(_llama_flax(sd, num_layers))


def gpt2_params_from_hf(sd: Mapping[str, Any], num_layers: int
                        ) -> dict[str, torch.Tensor]:
    """transformers.GPT2LMHeadModel state dict -> the port's GPT
    ``state_dict`` (HF's Conv1D weights are (in, out) already)."""
    return params_from_flax(_gpt2_flax(sd, num_layers))


def bert_params_from_hf(sd: Mapping[str, Any], num_layers: int
                        ) -> dict[str, torch.Tensor]:
    """transformers.BertForMaskedLM state dict -> the port's BertMLM
    ``state_dict``."""
    return params_from_flax(_bert_flax(sd, num_layers))


def llama_params_to_hf(state_dict: Mapping[str, torch.Tensor],
                       num_layers: int) -> dict:
    """The port's Llama ``state_dict`` -> transformers.LlamaForCausalLM
    state dict (numpy values; the inverse of :func:`llama_params_from_hf`)."""
    f = params_to_flax(state_dict)
    sd = {
        "model.embed_tokens.weight": f["embed_tokens"],
        "model.norm.weight": f["final_norm/scale"],
        "lm_head.weight": f["lm_head/kernel"].T,
    }
    for i in range(num_layers):
        p, q = f"model.layers.{i}.", f"layer{i}/"
        sd[p + "input_layernorm.weight"] = f[q + "attention_norm/scale"]
        sd[p + "post_attention_layernorm.weight"] = f[q + "mlp_norm/scale"]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[p + f"self_attn.{name}.weight"] = (
                f[q + f"attention/{name}/kernel"].T)
        for name in ("gate_proj", "up_proj", "down_proj"):
            sd[p + f"mlp.{name}.weight"] = f[q + f"{name}/kernel"].T
    return sd


def gpt2_params_to_hf(state_dict: Mapping[str, torch.Tensor],
                      num_layers: int) -> dict:
    """The port's GPT ``state_dict`` -> transformers.GPT2LMHeadModel state
    dict (Conv1D layout: no transposes; qkv fused again)."""
    f = params_to_flax(state_dict)
    sd = {
        "transformer.wte.weight": f["wte"],
        "transformer.wpe.weight": f["wpe"],
        "transformer.ln_f.weight": f["ln_f/scale"],
        "transformer.ln_f.bias": f["ln_f/bias"],
        "lm_head.weight": f["wte"],  # tied head
    }
    for i in range(num_layers):
        p, q = f"transformer.h.{i}.", f"layer{i}/"
        for ln, ours in (("ln_1", "ln1"), ("ln_2", "ln2")):
            sd[p + ln + ".weight"] = f[q + ours + "/scale"]
            sd[p + ln + ".bias"] = f[q + ours + "/bias"]
        sd[p + "attn.c_attn.weight"] = np.concatenate(
            [f[q + "attention/query/kernel"], f[q + "attention/key/kernel"],
             f[q + "attention/value/kernel"]], axis=1)
        sd[p + "attn.c_attn.bias"] = np.concatenate(
            [f[q + "attention/query/bias"], f[q + "attention/key/bias"],
             f[q + "attention/value/bias"]])
        sd[p + "attn.c_proj.weight"] = f[q + "attention/output/kernel"]
        sd[p + "attn.c_proj.bias"] = f[q + "attention/output/bias"]
        sd[p + "mlp.c_fc.weight"] = f[q + "mlp_in/kernel"]
        sd[p + "mlp.c_fc.bias"] = f[q + "mlp_in/bias"]
        sd[p + "mlp.c_proj.weight"] = f[q + "mlp_out/kernel"]
        sd[p + "mlp.c_proj.bias"] = f[q + "mlp_out/bias"]
    return sd


def bert_params_to_hf(state_dict: Mapping[str, torch.Tensor],
                      num_layers: int) -> dict:
    """The port's BertMLM ``state_dict`` -> transformers.BertForMaskedLM
    state dict."""
    f = params_to_flax(state_dict)
    sd = {
        "bert.embeddings.word_embeddings.weight": f["word_embeddings"],
        "bert.embeddings.position_embeddings.weight":
            f["position_embeddings"],
        "bert.embeddings.token_type_embeddings.weight": f["type_embeddings"],
        "bert.embeddings.LayerNorm.weight": f["embeddings_ln/scale"],
        "bert.embeddings.LayerNorm.bias": f["embeddings_ln/bias"],
        "cls.predictions.transform.dense.weight": f["mlm_transform/kernel"].T,
        "cls.predictions.transform.dense.bias": f["mlm_transform/bias"],
        "cls.predictions.transform.LayerNorm.weight": f["mlm_ln/scale"],
        "cls.predictions.transform.LayerNorm.bias": f["mlm_ln/bias"],
        "cls.predictions.bias": f["mlm_bias"],
        # The tied decoder: transformers rebuilds it on load, but the saved
        # form carries it for a strict load.
        "cls.predictions.decoder.weight": f["word_embeddings"],
        "cls.predictions.decoder.bias": f["mlm_bias"],
    }
    for i in range(num_layers):
        p, q = f"bert.encoder.layer.{i}.", f"layer{i}/"
        for hf_name, ours in (
                ("attention.self.query", "attention/query"),
                ("attention.self.key", "attention/key"),
                ("attention.self.value", "attention/value"),
                ("attention.output.dense", "attention/output"),
                ("intermediate.dense", "intermediate"),
                ("output.dense", "mlp_output")):
            sd[p + hf_name + ".weight"] = f[q + ours + "/kernel"].T
            sd[p + hf_name + ".bias"] = f[q + ours + "/bias"]
        for hf_name, ours in (("attention.output.LayerNorm", "attention_ln"),
                              ("output.LayerNorm", "mlp_ln")):
            sd[p + hf_name + ".weight"] = f[q + ours + "/scale"]
            sd[p + hf_name + ".bias"] = f[q + ours + "/bias"]
    return sd


EXPORTERS: dict[str, Callable] = {
    "llama": llama_params_to_hf,
    "gpt2": gpt2_params_to_hf,
    "bert": bert_params_to_hf,
}

# model_type (HF config.json) -> (converter, its num_layers config key)
CONVERTERS: dict[str, tuple[Callable, str]] = {
    "llama": (llama_params_from_hf, "num_hidden_layers"),
    "gpt2": (gpt2_params_from_hf, "n_layer"),
    "bert": (bert_params_from_hf, "num_hidden_layers"),
}

# Tensors a checkpoint may carry that the mapping does not consume: tied
# duplicates of a mapped tensor and buffers that are not parameters.
_IGNORABLE = re.compile(
    r"(^|\.)(lm_head\.weight"               # tied head duplicate
    r"|cls\.predictions\.decoder\.(weight|bias)"  # BERT's tied decoder
    r"|.*attn\.(masked_)?bias"              # GPT-2 causal-mask buffers
    r"|.*\.position_ids"                    # legacy BERT buffer
    r"|.*rotary_emb\.inv_freq)$")           # legacy Llama RoPE buffer


class _TrackedDict(dict):
    """Records the keys read, so :func:`convert_checked` can find tensors
    the mapping left unread."""

    def __init__(self, data):
        super().__init__(data)
        self.accessed: set = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self.accessed.add(k)
        return super().get(k, default)


def convert_checked(family: str, sd: Mapping[str, Any],
                    num_layers: int) -> dict[str, torch.Tensor]:
    """The family's converter, raising on any tensor it did not consume:
    a dropped tensor means the imported model computes something other
    than the checkpoint."""
    convert, _ = CONVERTERS[family]
    tracked = _TrackedDict(sd)
    state = convert(tracked, num_layers)
    leftover = {k for k in tracked if k not in tracked.accessed
                and not _IGNORABLE.search(k)}
    if leftover:
        raise ValueError(
            f"{family} checkpoint has {len(leftover)} tensor(s) the "
            f"architecture mapping does not consume (the import would "
            f"silently change the model): {sorted(leftover)[:8]}")
    return state
