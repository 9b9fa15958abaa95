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
autograd tape, losses, `optimizer` (the reference's 19 optimizers; SGD
and Adam on the flat update kernels of `ops.fused_optimizer`),
`lr_scheduler`, `gluon.Trainer` and `gluon.FusedTrainStep` (16 fusable
optimizers); BERT-base pretraining with LAMB on the ZeRO
updater (`optimizer.zero`, `kvstore`); and sparse embeddings: row-sparse
and CSR arrays (`nd.sparse`), vocab-sharded tables (`embedding`), the
kvstore's row_sparse push and pull, and the DLRM model (`models.dlrm`),
on the segment-sum kernel of `ops.sparse_ops`; and Gluon-sparse:
`Embedding(sparse_grad=True)`, row-sparse gradient buffers and
Parameters, the CSR `dot` with its gradient, `mx.io`'s iterators
(`LibSVMIter`) and the factorization models (`models.factorization`);
and the data and evaluation layer: `gluon.data` (samplers, datasets, the
DataLoader with spawned CPU-only workers, MNIST/CIFAR and the vision
transforms), `image` (the array augmenters), `metric`, all of the
reference's loss blocks, `gluon.utils`, `callback` and
`gluon.contrib.estimator`; and the symbolic half: `sym` (graphs built
from the op registry, their JSON, shape inference and the `Executor` with
its whole-graph route in `compiler`), `mod` (`Module`,
`BucketingModule`), `model` (checkpoints), `attribute`, `monitor`,
`viz`, and Gluon's `export` and `SymbolBlock`; and the recurrent half:
the fused `RNN` op (`ops.rnn_ops`), `gluon.rnn` (cells and the fused
RNN/LSTM/GRU layers), `gluon.contrib.rnn` and the symbolic cells of
`rnn` with `BucketSentenceIter`; and the reference's whole op set:
tensor, nn, linalg, random, image, quantization and detection ops
(`ops.contrib_vision`: the SSD MultiBox ops, NMS, ROI ops), `nd.contrib`'s control flow and custom ops (`operator`); and the data
input of the reference's C++ IO stack: `recordio`, the host helpers of
`native`, `image.imdecode`/`ImageIter`, `image_detection.ImageDetIter`,
`mx.io`'s `ImageRecordIter`, `CSVIter` and `MNISTIter`, the record
datasets of `gluon.data` and `tools.im2rec`; and the numpy namespace:
`np` (`mx.np`: the `ndarray` type and the reference's 275 `_np_*` ops,
`np.linalg`, `np.random`), `npx` (`mx.npx`) and Gluon's np mode
(`npx.set_np()`: blocks, `Parameter.data()` and the DataLoader hand out
`mx.np.ndarray`s); and `contrib` (mixed precision `amp`, INT8
`quantization`, `onnx` export and import, `svrg_optimization`, `text`
vocabularies and embeddings, the `tensorboard` callback) with
`profiler`:

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

from . import (attribute, autograd, base, callback, compiler, context,
               contrib, embedding, gluon, image, image_detection,
               initializer, io, kvstore, lr_scheduler, metric, model, models,
               module, monitor, name, native, ndarray, operator, ops,
               optimizer, parallel, profiler, random, recordio, rnn, serve,
               symbol, telemetry, util, visualization)
from . import initializer as init
from . import kvstore as kv
from . import module as mod
from . import ndarray as nd
from . import optimizer as opt
from . import symbol as sym
from . import visualization as viz
from .attribute import AttrScope
from .base import MXNetError, resolve_device
from .context import Context, cpu, current_context, gpu
from . import numpy as np  # noqa: E402 (mx.np, after the op set)
from . import numpy_extension as npx  # noqa: E402

__version__ = "0.1.0"

__all__ = ["attribute", "autograd", "base", "callback", "compiler",
           "context", "embedding", "gluon", "image", "image_detection",
           "init", "initializer", "io", "kv", "kvstore", "lr_scheduler",
           "metric", "mod", "model", "models", "module", "monitor", "name",
           "native", "nd", "ndarray", "operator", "ops", "opt", "optimizer",
           "parallel", "random", "recordio", "rnn", "serve", "sym",
           "symbol", "telemetry", "util", "visualization", "viz",
           "AttrScope", "Context", "cpu", "gpu", "current_context",
           "MXNetError", "resolve_device", "np", "npx"]
