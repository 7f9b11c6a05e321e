"""Kernel ops: the dense/flash attention dispatch and the flash kernels, the
fused BatchNorm kernels, and the matmul+BatchNorm and 3x3 conv+BatchNorm
kernels of the fused bottleneck block."""

# The port's kernels by name, as (module, launch counter).
KERNEL_COUNTERS = (
    ("flash_attention_fwd", "flash_attention", "launches"),
    ("flash_attention_dq", "flash_attention", "dq_launches"),
    ("flash_attention_dkv", "flash_attention", "dkv_launches"),
    ("bn_stats", "fused_batchnorm", "stats_launches"),
    ("bn_apply", "fused_batchnorm", "apply_launches"),
    ("bn_bwd_reduce", "fused_batchnorm", "bwd_reduce_launches"),
    ("bn_bwd_dx", "fused_batchnorm", "bwd_dx_launches"),
    ("linear_bn_fwd", "fused_linear_bn", "fwd_launches"),
    ("linear_bn_bwd_dx", "fused_linear_bn", "bwd_dx_launches"),
    ("linear_bn_bwd_dw", "fused_linear_bn", "bwd_dw_launches"),
    ("conv3x3_bn_fwd", "fused_conv_bn", "fwd_launches"),
    ("conv3x3_bn_bwd_dx", "fused_conv_bn", "bwd_dx_launches"),
    ("conv3x3_bn_bwd_dw", "fused_conv_bn", "bwd_dw_launches"),
)


def launch_counts() -> dict[str, int]:
    """How many times each kernel of the port has launched in this
    process: its wrapper's counter, which only a launch on the card
    advances."""
    import importlib

    return {name: getattr(importlib.import_module(f"{__name__}.{module}"),
                          counter)
            for name, module, counter in KERNEL_COUNTERS}
