"""Serving of the PyTorch port: the paged KV cache (``kv_cache``), the SLO
scheduler (``scheduler``), the continuous-batching engine with speculative
decoding (``engine``), per-request tracing and TTFT attribution
(``tracing``) and its one-replica entry point (``python -m
distributeddeeplearning_tpu_torch.serve``, ``cli``). Counterpart of
``distributeddeeplearning_tpu/serve/``; its replica supervisor and serve
fault plans come with a later slice."""
