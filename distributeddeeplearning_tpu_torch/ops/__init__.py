"""Kernel ops: the dense/flash attention dispatch and the flash kernels, the
fused BatchNorm kernels, and the matmul+BatchNorm and 3x3 conv+BatchNorm
kernels of the fused bottleneck block."""
