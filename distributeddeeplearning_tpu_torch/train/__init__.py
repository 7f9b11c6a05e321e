"""One-card training of the causal LMs and the ResNets: losses, optimizers,
train state, the train step, checkpoints and the loop (``python -m
distributeddeeplearning_tpu_torch.train``)."""
