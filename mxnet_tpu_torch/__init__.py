"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

It grows slice by slice beside the JAX package, which stays the reference.
The port imports neither JAX nor anything of `mxnet_tpu`. Every kernel
that the JAX package wrote in Pallas for the TPU becomes a kernel written
by hand for the H100 (``csrc/``, built with nvcc at first use); the plain
PyTorch version of each kernel runs only for tensors that lie on the CPU.

So far: Llama inference (`models.llama`) and the serving engine
(`serve`); Llama training (`models.llama.llama_loss`,
`parallel.ShardedTrainStep`, `parallel.checkpoint`); the flash-attention
forward and backward kernels (`parallel.flash_attention`); the Gluon core
(`nd`, `gluon`, `init`, `random`, `autograd`, `cpu`/`gpu` contexts) with
the vision model zoo's ResNets and the fused conv3x3 + BN + ReLU kernels
(`ops.fused_conv`, inference and training); and Gluon training: the
autograd tape, losses, `optimizer` (SGD, Adam, with the flat update
kernels of `ops.fused_optimizer`), `lr_scheduler`, `gluon.Trainer` and
`gluon.FusedTrainStep`; BERT-base pretraining with LAMB on the ZeRO
updater (`optimizer.zero`, `kvstore`); and sparse embeddings: row-sparse
and CSR arrays (`nd.sparse`), vocab-sharded tables (`embedding`), the
kvstore's row_sparse push and pull, and the DLRM model (`models.dlrm`),
on the segment-sum kernel of `ops.sparse_ops`:

    import mxnet_tpu_torch as mx
    net = mx.gluon.model_zoo.vision.resnet50_v1(layout="NHWC")
    net.load_parameters("resnet50.params")
    net.cast("bfloat16")
    logits = net(x)           # x: an NDArray on gpu(0), the default
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    step = mx.gluon.FusedTrainStep(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), trainer)
    loss = step(x, y)         # one training step
"""
from __future__ import annotations

from . import (autograd, base, context, embedding, gluon, initializer, io,
               kvstore, lr_scheduler, models, name, ndarray, ops, optimizer,
               parallel, random, serve, telemetry, util)
from . import initializer as init
from . import kvstore as kv
from . import ndarray as nd
from . import optimizer as opt
from .base import MXNetError, resolve_device
from .context import Context, cpu, current_context, gpu

__version__ = "0.1.0"

__all__ = ["autograd", "base", "context", "embedding", "gluon", "init",
           "initializer", "io", "kv", "kvstore", "lr_scheduler", "models", "name", "nd", "ndarray", "ops",
           "opt", "optimizer", "parallel", "random", "serve", "telemetry",
           "util", "Context", "cpu", "gpu", "current_context", "MXNetError",
           "resolve_device"]
