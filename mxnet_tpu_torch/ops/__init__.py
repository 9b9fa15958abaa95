"""Hand-written CUDA kernels of the port: their names and launch counts.

Each kernel's wrapper adds one to its count right after the kernel
launched, and nowhere else, so a run can show that its main path went
through the kernel and not through the kernel's plain PyTorch version
(which the wrappers use only for tensors that lie on the CPU). A kernel
with several variants, chosen by shape before the launch, also records
which variant and tile each launch took (`variant_counts`).
"""
from __future__ import annotations

__all__ = ["KERNELS", "barrier_words", "count_launch", "launch_counts",
           "reset_launch_counts", "variant_counts"]

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
_variants = {}      # (kernel name, variant) -> launches
_barriers = {}      # (device, stream) -> the persistent kernels' words


def count_launch(name, variant=None):
    _launches[name] += 1
    if variant is not None:
        key = (name, variant)
        _variants[key] = _variants.get(key, 0) + 1


def launch_counts():
    return dict(_launches)


def variant_counts():
    """{(kernel name, variant): launches} since the last reset, for the
    kernels whose wrappers name a variant."""
    return dict(_variants)


def reset_launch_counts():
    for name in _launches:
        _launches[name] = 0
    _variants.clear()


def barrier_words(dev, stream):
    """32 int32 words on `dev` for the persistent kernels launched on
    `stream` (segment_sum's fused route, cbr_train_bwd's persistent
    variant): their grid barriers' words, zero at first and zero again
    after every launch, then flags a launch writes before it reads them.
    Launches on one stream run one after another, so they share them."""
    key = (dev, stream)
    words = _barriers.get(key)
    if words is None:
        import torch
        words = _barriers[key] = torch.zeros(32, dtype=torch.int32,
                                             device=dev)
    return words
