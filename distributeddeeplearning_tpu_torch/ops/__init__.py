"""Kernel ops: the dense/flash attention dispatch and the flash kernels, and
the fused BatchNorm kernels."""
