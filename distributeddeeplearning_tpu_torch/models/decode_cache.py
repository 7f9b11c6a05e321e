"""The dense KV cache of decode mode (GPT and Llama families).

The JAX models keep it as a flax ``cache`` collection: per attention layer a
``cached_key``/``cached_value`` buffer and a ``cache_index`` that advance in
lockstep, plus GPT's ``position`` counter, which equals them. Here it is one
object the caller creates with ``model.init_cache(batch)`` and passes to
every decode forward: per-layer buffers and the one shared write index.
The buffers are written in place, which saves a copy of the cache per step.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    keys: list[torch.Tensor]     # per layer (B, capacity, kv_heads, D)
    values: list[torch.Tensor]
    index: int = 0               # slots [0, index) hold the live prefix

    @classmethod
    def zeros(cls, num_layers: int, shape: tuple[int, ...], *,
              dtype: torch.dtype, device) -> "KVCache":
        def buf():
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(num_layers)]
        return cls(keys=buf(), values=buf())

    @property
    def capacity(self) -> int:
        return self.keys[0].shape[1]

    def append(self, layer: int, k: torch.Tensor, v: torch.Tensor):
        """Write a block of s new K/V at the index and return the live
        prefix (B, index + s, kv_heads, D) of both buffers. The index itself
        advances once per forward, through :meth:`advance`."""
        s = k.shape[1]
        end = self.index + s
        if end > self.capacity:
            raise ValueError(
                f"decode block of {s} at index {self.index} overflows the "
                f"cache capacity {self.capacity} (max_position / "
                f"decode_cache_len); size it to prompt + new tokens")
        self.keys[layer][:, self.index:end] = k
        self.values[layer][:, self.index:end] = v
        return self.keys[layer][:, :end], self.values[layer][:, :end]

    def advance(self, s: int) -> None:
        self.index += s


def live_mask(index: int, s: int, device) -> torch.Tensor:
    """(s, index + s) bool: query j (global position index + j) sees cache
    slots <= index + j: causal within the written block, everything before
    it."""
    slots = torch.arange(index + s, device=device)[None, :]
    return slots <= (index + torch.arange(s, device=device))[:, None]
