"""Hand-written CUDA kernels of the port: their names and launch counts.

Each kernel's wrapper adds one to its count right after the kernel
launched, and nowhere else, so a run can show that its main path went
through the kernel and not through the kernel's plain PyTorch version
(which the wrappers use only for tensors that lie on the CPU).
"""
from __future__ import annotations

__all__ = ["KERNELS", "count_launch", "launch_counts",
           "reset_launch_counts"]

# kernel name -> (source in the package, file:line of the TPU kernel it
# replaces). Several kernels may share one source, which is built once.
KERNELS = {
    "flash_fwd": ("csrc/flash_fwd.cu",
                  "mxnet_tpu/parallel/flash_attention.py:98"),
    "flash_bwd_dq": ("csrc/flash_bwd.cu",
                     "mxnet_tpu/parallel/flash_attention.py:200"),
    "flash_bwd_dkv": ("csrc/flash_bwd.cu",
                      "mxnet_tpu/parallel/flash_attention.py:245"),
    "conv_bn_relu": ("csrc/conv_bn_relu.cu",
                     "mxnet_tpu/ops/fused_conv.py:75"),
    "conv_bn_stats": ("csrc/conv_bn_relu.cu",
                      "mxnet_tpu/ops/fused_conv.py:195"),
    "cbr_train_bwd": ("csrc/cbr_train_bwd.cu",
                      "mxnet_tpu/ops/fused_conv.py:341"),
    "flat_sgd": ("csrc/fused_optimizer.cu",
                 "mxnet_tpu/ops/fused_optimizer.py:118"),
    "flat_adam": ("csrc/fused_optimizer.cu",
                  "mxnet_tpu/ops/fused_optimizer.py:149"),
    "flat_lamb1": ("csrc/lamb.cu", "mxnet_tpu/ops/fused_optimizer.py:177"),
    "flat_lamb2": ("csrc/lamb.cu", "mxnet_tpu/ops/fused_optimizer.py:229"),
    "segment_sum": ("csrc/segment_sum.cu",
                    "mxnet_tpu/ops/sparse_ops.py:88"),
}

_launches = dict.fromkeys(KERNELS, 0)


def count_launch(name):
    _launches[name] += 1


def launch_counts():
    return dict(_launches)


def reset_launch_counts():
    for name in _launches:
        _launches[name] = 0
