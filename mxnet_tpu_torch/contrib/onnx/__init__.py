"""mx.contrib.onnx: ONNX model export and import (the port of
`mxnet_tpu.contrib.onnx`).

reference: python/mxnet/contrib/onnx/ (mx2onnx export_model, onnx2mx
import_model). The reference rides the `onnx` package; this one encodes
the ONNX protobuf subset itself (proto.py), so the capability has no
external dependency. Files are standard opset-13 ONNX: they load in stock
onnx/onnxruntime, and import_model accepts files from stock exporters
over the same op set.
"""
from .mx2onnx import export_model
from .onnx2mx import import_model

__all__ = ["export_model", "import_model"]
