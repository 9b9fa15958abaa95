"""`mx.contrib` (the port of `mxnet_tpu.contrib`; reference:
python/mxnet/contrib/): mixed precision (`amp`), INT8 post-training
quantization (`quantization`), text vocabularies and embeddings
(`text`), ONNX export and import (`onnx`), SVRG (`svrg_optimization`) and
the TensorBoard callback (`tensorboard`)."""
from . import amp
from . import quantization
from . import text
from . import onnx
from . import svrg_optimization
from . import tensorboard

__all__ = ["amp", "quantization", "text", "onnx", "svrg_optimization",
           "tensorboard"]
