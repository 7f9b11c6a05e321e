"""Serving of the PyTorch port: the paged KV cache (``kv_cache``), the SLO
scheduler (``scheduler``), the continuous-batching engine (``engine``) and
its one-replica entry point (``python -m
distributeddeeplearning_tpu_torch.serve``, ``cli``). Counterpart of
``distributeddeeplearning_tpu/serve/``; its replica supervisor and request
tracing come with later slices."""
