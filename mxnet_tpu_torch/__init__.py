"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

It grows slice by slice beside the JAX package, which stays the reference.
The port imports neither JAX nor anything of `mxnet_tpu`. Every kernel
that the JAX package wrote in Pallas for the TPU becomes a kernel written
by hand for the H100 (``csrc/``, built with nvcc at first use); the plain
PyTorch version of each kernel runs only for tensors that lie on the CPU.

So far: Llama inference (`models.llama`) and the serving engine
(`serve`); Llama training (`models.llama.llama_loss`,
`parallel.ShardedTrainStep`, `parallel.checkpoint`); the flash-attention
forward and backward kernels (`parallel.flash_attention`).
"""
from __future__ import annotations

from . import models, ops, parallel, serve, telemetry, util
from .base import MXNetError, resolve_device

__version__ = "0.1.0"

__all__ = ["models", "ops", "parallel", "serve", "telemetry", "util",
           "MXNetError", "resolve_device"]
