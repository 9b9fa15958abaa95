"""Symbol graph -> ONNX export (the port of
`mxnet_tpu.contrib.onnx.mx2onnx`).

reference: python/mxnet/contrib/onnx/mx2onnx/ (export_model,
MXNetGraph.create_onnx_graph_proto): per-op converter functions walking
the symbol's JSON node list, keyed by the registry op name, emitting
opset-13 nodes; parameters become initializers (raw little-endian
bytes). The same symbol JSON and parameters give the JAX package's bytes.
A bfloat16 tensor is carried by its bits (`_Bf16Host`), so no ml_dtypes
is needed.
"""
from __future__ import annotations

import ast
import json

import numpy as _onp
import torch

from . import proto as P

__all__ = ["export_model"]

_OPSET = 13
_CONVERTERS = {}

_DTYPE_MAP = {
    "float32": P.DT.FLOAT, "float64": P.DT.DOUBLE, "float16": P.DT.FLOAT16,
    "bfloat16": P.DT.BFLOAT16, "int32": P.DT.INT32, "int64": P.DT.INT64,
    "int8": P.DT.INT8, "uint8": P.DT.UINT8, "bool": P.DT.BOOL,
}


def mx_op(*names):
    def deco(fn):
        for n in names:
            _CONVERTERS[n] = fn
        return fn
    return deco


def _parse_attrs(attrs):
    out = {}
    for k, v in (attrs or {}).items():
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def _attr_i(name, v):
    return P.AttributeProto(name=name, type=P.AT.INT, i=int(v))


def _attr_f(name, v):
    return P.AttributeProto(name=name, type=P.AT.FLOAT, f=float(v))


def _attr_s(name, v):
    return P.AttributeProto(name=name, type=P.AT.STRING,
                            s=str(v).encode("utf-8"))


def _attr_ints(name, vs):
    return P.AttributeProto(name=name, type=P.AT.INTS,
                            ints=[int(x) for x in vs])


class _Bf16Host:
    """A bfloat16 array on the host as its uint16 bits."""

    def __init__(self, bits):
        self.bits = _onp.ascontiguousarray(bits, dtype=_onp.uint16)
        self.shape = self.bits.shape

    @classmethod
    def of(cls, t):
        """From a bfloat16 tensor, or a float scalar rounded to nearest
        even."""
        if not torch.is_tensor(t):
            t = torch.tensor(t, dtype=torch.float32).to(torch.bfloat16)
        return cls(t.detach().cpu().contiguous().view(torch.int16).numpy()
                   .view(_onp.uint16))


def _host(v):
    """An NDArray, tensor or array-like as a host array (bfloat16 as
    `_Bf16Host`)."""
    t = getattr(v, "_data", v)
    if torch.is_tensor(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _Bf16Host.of(t)
        return t.numpy()
    return _onp.asarray(v)


def _tensor(name, arr):
    if isinstance(arr, _Bf16Host):
        return P.TensorProto(name=name, dims=list(arr.shape),
                             data_type=P.DT.BFLOAT16,
                             raw_data=arr.bits.tobytes())
    arr = _onp.ascontiguousarray(arr)
    dt = _DTYPE_MAP[str(arr.dtype)]
    return P.TensorProto(name=name, dims=list(arr.shape), data_type=dt,
                         raw_data=arr.tobytes())


class _Builder:
    """Accumulates nodes/initializers; converters call back into it."""

    def __init__(self, params=None):
        self.nodes = []
        self.initializers = []
        self.params = params or {}    # host numpy params, for shape lookups
        self.np_dtype = _onp.float32  # model dtype, set by export_model
        self._uid = 0

    def add(self, op_type, inputs, name, outputs=None, attrs=()):
        outs = outputs or [name]
        self.nodes.append(P.NodeProto(op_type=op_type, name=name,
                                      input=list(inputs), output=outs,
                                      attribute=list(attrs)))
        return outs[0]

    def const(self, name, arr):
        if not isinstance(arr, _Bf16Host):
            arr = _onp.asarray(arr)
        self.initializers.append(_tensor(name, arr))
        return name

    def tmp(self, base):
        self._uid += 1
        return "%s__%d" % (base, self._uid)


def _tuple2(v, default):
    """Normalize an mx stride/pad/dilate attr to len(default) entries
    (scalar attrs broadcast to the kernel rank, not to 2)."""
    if v is None:
        return default
    if isinstance(v, int):
        return (v,) * len(default)
    return tuple(v)


# ---------------------------------------------------------------- convs
@mx_op("Convolution")
def _conv(b, name, ins, a):
    kernel = tuple(a["kernel"])
    stride = _tuple2(a.get("stride"), (1,) * len(kernel))
    pad = _tuple2(a.get("pad"), (0,) * len(kernel))
    dilate = _tuple2(a.get("dilate"), (1,) * len(kernel))
    attrs = [_attr_ints("kernel_shape", kernel),
             _attr_ints("strides", stride),
             _attr_ints("pads", list(pad) * 2),
             _attr_ints("dilations", dilate),
             _attr_i("group", a.get("num_group", 1))]
    return b.add("Conv", ins, name, attrs=attrs)


@mx_op("Deconvolution")
def _deconv(b, name, ins, a):
    kernel = tuple(a["kernel"])
    if a.get("target_shape"):
        raise NotImplementedError(
            "ONNX export: Deconvolution target_shape is not supported")
    stride = _tuple2(a.get("stride"), (1,) * len(kernel))
    pad = _tuple2(a.get("pad"), (0,) * len(kernel))
    dilate = _tuple2(a.get("dilate"), (1,) * len(kernel))
    adj = _tuple2(a.get("adj"), (0,) * len(kernel))
    attrs = [_attr_ints("kernel_shape", kernel),
             _attr_ints("strides", stride),
             _attr_ints("pads", list(pad) * 2),
             _attr_ints("dilations", dilate),
             _attr_ints("output_padding", adj),
             _attr_i("group", a.get("num_group", 1))]
    return b.add("ConvTranspose", ins, name, attrs=attrs)


@mx_op("FullyConnected")
def _fc(b, name, ins, a):
    data = ins[0]
    if a.get("flatten", True):
        data = b.add("Flatten", [data], b.tmp(name + "_flat"),
                     attrs=[_attr_i("axis", 1)])
    gemm_in = [data] + ins[1:]
    return b.add("Gemm", gemm_in, name,
                 attrs=[_attr_f("alpha", 1.0), _attr_f("beta", 1.0),
                        _attr_i("transB", 1)])


@mx_op("BatchNorm", "BatchNorm_v1")
def _bn(b, name, ins, a):
    ins = list(ins)
    if a.get("fix_gamma", True):
        # mxnet's fix_gamma=True (the default) pins scale to 1; ONNX has
        # no such flag, so emit an explicit ones tensor as the scale input
        gamma = b.params.get(ins[1])
        shape = gamma.shape if gamma is not None else (1,)
        ins[1] = b.const(b.tmp(name + "_gamma1"),
                         _onp.ones(shape, _onp.float32))
    return b.add("BatchNormalization", ins, name,
                 attrs=[_attr_f("epsilon", a.get("eps", 1e-3)),
                        _attr_f("momentum", a.get("momentum", 0.9))])


@mx_op("Pooling", "pooling")
def _pool(b, name, ins, a):
    ptype = a.get("pool_type", "max")
    if a.get("global_pool", False):
        op = {"max": "GlobalMaxPool", "avg": "GlobalAveragePool"}[ptype]
        return b.add(op, ins, name)
    kernel = tuple(a["kernel"])
    stride = _tuple2(a.get("stride"), (1,) * len(kernel))
    pad = _tuple2(a.get("pad"), (0,) * len(kernel))
    attrs = [_attr_ints("kernel_shape", kernel),
             _attr_ints("strides", stride),
             _attr_ints("pads", list(pad) * 2)]
    if ptype == "avg":
        attrs.append(_attr_i("count_include_pad",
                             0 if a.get("count_include_pad",
                                        True) is False else 1))
        return b.add("AveragePool", ins, name, attrs=attrs)
    return b.add("MaxPool", ins, name, attrs=attrs)


# ------------------------------------------------------------ pointwise
_ACT = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
        "softrelu": "Softplus", "softsign": "Softsign"}


@mx_op("Activation")
def _act(b, name, ins, a):
    t = a.get("act_type", "relu")
    if t == "gelu":
        # exact-erf gelu decomposition: x * 0.5 * (1 + erf(x/sqrt(2)));
        # constants carry the model dtype — mixed-type Mul/Add is invalid
        # ONNX for fp16/bf16 models
        dt = b.np_dtype
        scaled = b.add("Mul", [ins[0], b.const(b.tmp(name + "_c"),
                                               dt(0.7071067811865476))],
                       b.tmp(name + "_sc"))
        erf = b.add("Erf", [scaled], b.tmp(name + "_erf"))
        one = b.const(b.tmp(name + "_one"), dt(1.0))
        half = b.const(b.tmp(name + "_half"), dt(0.5))
        g = b.add("Add", [erf, one], b.tmp(name + "_p1"))
        g = b.add("Mul", [g, half], b.tmp(name + "_h"))
        return b.add("Mul", [ins[0], g], name)
    if t not in _ACT:
        raise NotImplementedError(
            "ONNX export: Activation act_type %r (supported: %s, gelu)"
            % (t, ", ".join(sorted(_ACT))))
    return b.add(_ACT[t], ins, name)


@mx_op("relu")
def _relu(b, name, ins, a):
    return b.add("Relu", ins, name)


@mx_op("sigmoid")
def _sigmoid(b, name, ins, a):
    return b.add("Sigmoid", ins, name)


@mx_op("tanh")
def _tanh(b, name, ins, a):
    return b.add("Tanh", ins, name)


@mx_op("exp")
def _exp(b, name, ins, a):
    return b.add("Exp", ins, name)


@mx_op("log")
def _log(b, name, ins, a):
    return b.add("Log", ins, name)


@mx_op("sqrt")
def _sqrt(b, name, ins, a):
    return b.add("Sqrt", ins, name)


@mx_op("LeakyReLU")
def _leaky(b, name, ins, a):
    t = a.get("act_type", "leaky")
    if t == "elu":
        return b.add("Elu", ins[:1], name,
                     attrs=[_attr_f("alpha", a.get("slope", 0.25))])
    if t == "prelu":
        return b.add("PRelu", ins[:2], name)
    if t != "leaky":
        raise NotImplementedError(
            "ONNX export: LeakyReLU act_type %r (supported: leaky, elu, "
            "prelu)" % t)
    return b.add("LeakyRelu", ins[:1], name,
                 attrs=[_attr_f("alpha", a.get("slope", 0.25))])


@mx_op("softmax", "SoftmaxActivation")
def _softmax(b, name, ins, a):
    return b.add("Softmax", ins[:1], name,
                 attrs=[_attr_i("axis", a.get("axis", -1))])


@mx_op("log_softmax")
def _log_softmax(b, name, ins, a):
    return b.add("LogSoftmax", ins, name,
                 attrs=[_attr_i("axis", a.get("axis", -1))])


@mx_op("Dropout")
def _dropout(b, name, ins, a):
    ratio = b.const(b.tmp(name + "_ratio"),
                    _onp.asarray(a.get("p", 0.5), _onp.float32))
    return b.add("Dropout", [ins[0], ratio], name)


# ---------------------------------------------------------- structural
@mx_op("Flatten", "flatten")
def _flatten(b, name, ins, a):
    return b.add("Flatten", ins, name, attrs=[_attr_i("axis", 1)])


@mx_op("reshape", "Reshape")
def _reshape(b, name, ins, a):
    shape = b.const(b.tmp(name + "_shape"),
                    _onp.asarray(a["shape"], _onp.int64))
    return b.add("Reshape", [ins[0], shape], name)


@mx_op("transpose")
def _transpose(b, name, ins, a):
    axes = a.get("axes")
    attrs = [_attr_ints("perm", axes)] if axes else []
    return b.add("Transpose", ins, name, attrs=attrs)


@mx_op("expand_dims")
def _expand_dims(b, name, ins, a):
    axes = b.const(b.tmp(name + "_axes"),
                   _onp.asarray([a["axis"]], _onp.int64))
    return b.add("Unsqueeze", [ins[0], axes], name)


@mx_op("squeeze")
def _squeeze(b, name, ins, a):
    ax = a.get("axis")
    extra = []
    if ax is not None:
        ax = [ax] if isinstance(ax, int) else list(ax)
        extra = [b.const(b.tmp(name + "_axes"),
                         _onp.asarray(ax, _onp.int64))]
    return b.add("Squeeze", ins + extra, name)


@mx_op("Concat", "concat")
def _concat(b, name, ins, a):
    return b.add("Concat", ins, name,
                 attrs=[_attr_i("axis", a.get("dim", 1))])


# ------------------------------------------------------------ arithmetic
for _mx, _ox in [("elemwise_add", "Add"), ("broadcast_add", "Add"),
                 ("_plus", "Add"), ("elemwise_sub", "Sub"),
                 ("broadcast_sub", "Sub"), ("elemwise_mul", "Mul"),
                 ("broadcast_mul", "Mul"), ("elemwise_div", "Div"),
                 ("broadcast_div", "Div")]:
    def _bin(b, name, ins, a, _ox=_ox):
        return b.add(_ox, ins, name)
    _CONVERTERS[_mx] = _bin


@mx_op("dot", "batch_dot")
def _dot(b, name, ins, a):
    # MatMul has no transpose flags, and the operand rank isn't known at
    # export time, so an implicit-transpose dot cannot be lowered
    # faithfully — refuse rather than emit silently-wrong numerics
    if a.get("transpose_a") or a.get("transpose_b"):
        raise NotImplementedError(
            "ONNX export: dot/batch_dot with transpose_a/transpose_b is "
            "not supported — transpose the operand explicitly instead")
    return b.add("MatMul", ins, name)

_CONVERTERS["add_n"] = lambda b, name, ins, a: b.add("Sum", ins, name)


@mx_op("Embedding")
def _embedding(b, name, ins, a):
    idx = b.add("Cast", [ins[0]], b.tmp(name + "_cast"),
                attrs=[_attr_i("to", P.DT.INT64)])
    return b.add("Gather", [ins[1], idx], name, attrs=[_attr_i("axis", 0)])


# ---------------------------------------------------------------- driver
def export_model(sym, params, input_shapes, input_dtype="float32",
                 onnx_file_path="model.onnx", verbose=False):
    """Export a symbol + params dict to an ONNX file.

    reference: mx.contrib.onnx.export_model(sym, params, in_shapes,
    in_types, onnx_file_path). `params` maps arg/aux names (NDArray or
    numpy). Returns the file path.
    """
    graph = json.loads(sym.tojson())
    nodes = graph["nodes"]
    heads = [h[0] for h in graph["heads"]]

    params = {k.split(":", 1)[-1]: v for k, v in (params or {}).items()}
    host_params = {k: _host(v) for k, v in params.items()}

    # normalize input_shapes: dict {name: shape}, list of shapes (zipped
    # with data inputs in graph order — the reference API's form), or one
    # shape tuple for a single-input graph
    data_names = [n["name"] for n in nodes
                  if n["op"] == "null" and n["name"] not in host_params]
    if isinstance(input_shapes, dict):
        shape_of = dict(input_shapes)
    elif (isinstance(input_shapes, (list, tuple)) and input_shapes
          and isinstance(input_shapes[0], (list, tuple))):
        if len(input_shapes) != len(data_names):
            raise ValueError(
                "export_model: %d input shapes for %d data inputs %s"
                % (len(input_shapes), len(data_names), data_names))
        shape_of = dict(zip(data_names, map(tuple, input_shapes)))
    else:
        if len(data_names) != 1:
            raise ValueError(
                "export_model: a single shape tuple needs exactly one "
                "data input, graph has %s" % data_names)
        shape_of = {data_names[0]: tuple(input_shapes or ())}

    b = _Builder(host_params)
    if input_dtype == "bfloat16":
        b.np_dtype = _Bf16Host.of
    else:
        b.np_dtype = _onp.dtype(input_dtype).type
    out_name = {}              # node idx -> onnx value name
    graph_inputs = []

    for i, node in enumerate(nodes):
        op, name = node["op"], node["name"]
        if op == "null":
            out_name[i] = name
            if name in host_params:
                b.const(name, host_params[name])
            else:
                shape = shape_of.get(name)
                vi = P.ValueInfoProto(
                    name=name,
                    type=P.TypeProto(tensor_type=P.TensorTypeProto(
                        elem_type=_DTYPE_MAP[input_dtype],
                        shape=P.TensorShapeProto(dim=[
                            P.Dimension(dim_value=int(d))
                            for d in (shape or ())]))))
                graph_inputs.append(vi)
            continue
        conv = _CONVERTERS.get(op)
        if conv is None:
            raise NotImplementedError(
                "ONNX export: no converter for op %r (supported: %s)"
                % (op, ", ".join(sorted(_CONVERTERS))))
        ins = [out_name[j] for j, _, _ in node["inputs"]]
        out_name[i] = conv(b, name, ins, _parse_attrs(node.get("attrs")))
        if verbose:
            print("onnx export: %s -> %s" % (op, out_name[i]))

    outputs = [P.ValueInfoProto(name=out_name[h],
                                type=P.TypeProto(
                                    tensor_type=P.TensorTypeProto(
                                        elem_type=_DTYPE_MAP[input_dtype])))
               for h in heads]

    g = P.GraphProto(name="mxnet_tpu_exported", node=b.nodes,
                     initializer=b.initializers, input=graph_inputs,
                     output=outputs)
    model = P.ModelProto(ir_version=8, producer_name="mxnet-tpu",
                         producer_version="1.9",
                         opset_import=[P.OperatorSetIdProto(domain="",
                                                            version=_OPSET)],
                         graph=g)
    with open(onnx_file_path, "wb") as f:
        f.write(model.encode())
    return onnx_file_path
