"""ONNX -> symbol graph import (the port of
`mxnet_tpu.contrib.onnx.onnx2mx`).

reference: python/mxnet/contrib/onnx/onnx2mx/ (import_model,
GraphProto.from_onnx): walks the ONNX node list, builds the port's
symbol ops and splits the initializers into arg and aux parameters, on
the current context. Covers the op set that `mx2onnx.export_model` emits
(and the same ops in files from stock onnx tooling at opset >= 11). A
bfloat16 initializer is read by its bits, with no ml_dtypes.
"""
from __future__ import annotations

import numpy as _onp
import torch

from . import proto as P

__all__ = ["import_model"]

_NP_DTYPE = {
    P.DT.FLOAT: _onp.float32, P.DT.DOUBLE: _onp.float64,
    P.DT.FLOAT16: _onp.float16, P.DT.INT32: _onp.int32,
    P.DT.INT64: _onp.int64, P.DT.INT8: _onp.int8, P.DT.UINT8: _onp.uint8,
    P.DT.BOOL: _onp.bool_,
}


def _tensor_to_np(t):
    """An initializer as a numpy array, or a bfloat16 one as a CPU
    tensor."""
    if t.data_type == P.DT.BFLOAT16:
        bits = _onp.frombuffer(t.raw_data, dtype=_onp.int16).copy()
        out = torch.from_numpy(bits).view(torch.bfloat16)
        return out.reshape(tuple(t.dims)) if t.dims else out.reshape(())
    dtype = _NP_DTYPE[t.data_type]
    if t.raw_data:
        arr = _onp.frombuffer(t.raw_data, dtype=dtype)
    elif t.float_data:
        arr = _onp.asarray(t.float_data, dtype=dtype)
    elif t.int64_data:
        arr = _onp.asarray(t.int64_data, dtype=dtype)
    elif t.int32_data:
        arr = _onp.asarray(t.int32_data, dtype=dtype)
    else:
        arr = _onp.zeros(0, dtype)
    return arr.reshape(tuple(t.dims)) if t.dims else arr.reshape(())


def _attrs(node):
    out = {}
    for a in node.attribute:
        if a.type == P.AT.INT:
            out[a.name] = a.i
        elif a.type == P.AT.FLOAT:
            out[a.name] = a.f
        elif a.type == P.AT.STRING:
            out[a.name] = a.s.decode("utf-8")
        elif a.type == P.AT.INTS:
            out[a.name] = tuple(a.ints)
        elif a.type == P.AT.FLOATS:
            out[a.name] = tuple(a.floats)
        elif a.type == P.AT.TENSOR:
            out[a.name] = _tensor_to_np(a.t)
    return out


def import_model(onnx_file):
    """Load an ONNX file → (sym, arg_params, aux_params).

    reference: mx.contrib.onnx.import_model."""
    from ... import ndarray as nd
    from ... import symbol as _sym

    with open(onnx_file, "rb") as f:
        model = P.ModelProto.decode(f.read())
    g = model.graph

    consts = {t.name: _tensor_to_np(t) for t in g.initializer}
    sym_of = {}               # value name -> Symbol
    used_params = {}          # param name -> numpy (reached via Variable)
    aux_names = set()

    def as_sym(name):
        if name in sym_of:
            return sym_of[name]
        v = _sym.Variable(name)
        sym_of[name] = v
        if name in consts:
            used_params[name] = consts[name]
        return v

    for vi in g.input:
        if vi.name not in consts:
            as_sym(vi.name)

    # consumers per value name as (op_type, input_slot): int Casts may
    # only collapse to identity when they feed Gather's INDICES slot
    # exclusively (mx.take accepts float indices); a cast feeding data
    # carries truncation semantics
    consumer_ops = {}
    for node_ in g.node:
        for slot, x in enumerate(node_.input):
            consumer_ops.setdefault(x, []).append((node_.op_type, slot))

    def sym_pads(a, k):
        """ONNX pads = [begin..., end...]; the symmetric form maps to the
        mx `pad` attr. Asymmetric padding has no Pooling/Convolution
        equivalent — refuse instead of silently truncating."""
        pads = tuple(a.get("pads", (0,) * 2 * k))
        begin, end = pads[:k], pads[k:2 * k]
        if begin != end:
            raise NotImplementedError(
                "ONNX import: asymmetric pads %s are not supported"
                % (pads,))
        return begin

    def pool(node, a, op_kwargs):
        kernel = tuple(a["kernel_shape"])
        kw = dict(kernel=kernel,
                  stride=tuple(a.get("strides", (1,) * len(kernel))),
                  pad=sym_pads(a, len(kernel)), **op_kwargs)
        return _sym.Pooling(as_sym(node.input[0]), name=node.name, **kw)

    for node in g.node:
        op = node.op_type
        a = _attrs(node)
        ins = node.input
        name = node.name or (node.output[0] + "_op")

        if op == "Conv":
            kernel = tuple(a["kernel_shape"])
            args = [as_sym(x) for x in ins]
            num_filter = consts[ins[1]].shape[0] if ins[1] in consts else 0
            out = _sym.Convolution(
                *args, name=name, kernel=kernel,
                stride=tuple(a.get("strides", (1,) * len(kernel))),
                pad=sym_pads(a, len(kernel)),
                dilate=tuple(a.get("dilations", (1,) * len(kernel))),
                num_group=a.get("group", 1), num_filter=num_filter,
                no_bias=len(ins) == 2)
        elif op == "ConvTranspose":
            kernel = tuple(a["kernel_shape"])
            args = [as_sym(x) for x in ins]
            num_filter = consts[ins[1]].shape[1] if ins[1] in consts else 0
            out = _sym.Deconvolution(
                *args, name=name, kernel=kernel,
                stride=tuple(a.get("strides", (1,) * len(kernel))),
                pad=sym_pads(a, len(kernel)),
                num_filter=num_filter, no_bias=len(ins) == 2)
        elif op == "Gemm":
            alpha = a.get("alpha", 1.0)
            beta = a.get("beta", 1.0)
            trans_a = a.get("transA", 0)
            trans_b = a.get("transB", 0)
            w = consts.get(ins[1])
            if (trans_b and not trans_a and alpha == 1.0 and beta == 1.0
                    and w is not None):
                # the FullyConnected layout (Y = X @ W.T + b): fast path
                out = _sym.FullyConnected(
                    *[as_sym(x) for x in ins], name=name,
                    num_hidden=w.shape[0], no_bias=len(ins) == 2,
                    flatten=False)
            else:
                # general Gemm: alpha*op(A)@op(B) + beta*C
                A = as_sym(ins[0])
                if trans_a:
                    A = _sym.transpose(A, name=name + "_tA")
                B = as_sym(ins[1])
                if trans_b:
                    B = _sym.transpose(B, name=name + "_tB")
                out = _sym.dot(A, B, name=name + "_mm")
                if alpha != 1.0:
                    out = out * alpha
                if len(ins) > 2:
                    C = as_sym(ins[2])
                    out = _sym.broadcast_add(
                        out, C * beta if beta != 1.0 else C, name=name)
        elif op == "MatMul":
            out = _sym.dot(as_sym(ins[0]), as_sym(ins[1]), name=name)
        elif op == "BatchNormalization":
            for aux in ins[3:5]:
                aux_names.add(aux)
            out = _sym.BatchNorm(*[as_sym(x) for x in ins], name=name,
                                   eps=a.get("epsilon", 1e-5),
                                   momentum=a.get("momentum", 0.9),
                                   fix_gamma=False)
        elif op == "MaxPool":
            out = pool(node, a, {"pool_type": "max"})
        elif op == "AveragePool":
            # ONNX defaults count_include_pad=0; mx Pooling defaults True
            out = pool(node, a, {"pool_type": "avg", "count_include_pad":
                                 bool(a.get("count_include_pad", 0))})
        elif op == "GlobalMaxPool":
            out = _sym.Pooling(as_sym(ins[0]), name=name, kernel=(1, 1),
                                 pool_type="max", global_pool=True)
        elif op == "GlobalAveragePool":
            out = _sym.Pooling(as_sym(ins[0]), name=name, kernel=(1, 1),
                                 pool_type="avg", global_pool=True)
        elif op in ("Relu", "Sigmoid", "Tanh", "Softplus", "Softsign"):
            act = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh",
                   "Softplus": "softrelu", "Softsign": "softsign"}[op]
            out = _sym.Activation(as_sym(ins[0]), act_type=act, name=name)
        elif op == "LeakyRelu":
            out = _sym.LeakyReLU(as_sym(ins[0]), act_type="leaky",
                                   slope=a.get("alpha", 0.01), name=name)
        elif op == "Elu":
            out = _sym.LeakyReLU(as_sym(ins[0]), act_type="elu",
                                   slope=a.get("alpha", 1.0), name=name)
        elif op == "Erf":
            out = _sym.erf(as_sym(ins[0]), name=name)
        elif op == "PRelu":
            out = _sym.LeakyReLU(as_sym(ins[0]), as_sym(ins[1]),
                                   act_type="prelu", name=name)
        elif op == "Exp":
            out = _sym.exp(as_sym(ins[0]), name=name)
        elif op == "Log":
            out = _sym.log(as_sym(ins[0]), name=name)
        elif op == "Sqrt":
            out = _sym.sqrt(as_sym(ins[0]), name=name)
        elif op == "Softmax":
            out = _sym.softmax(as_sym(ins[0]), axis=a.get("axis", -1),
                                 name=name)
        elif op == "LogSoftmax":
            out = _sym.log_softmax(as_sym(ins[0]),
                                     axis=a.get("axis", -1), name=name)
        elif op == "Dropout":
            ratio = a.get("ratio", 0.5)
            if len(ins) > 1 and ins[1] in consts:
                ratio = float(consts[ins[1]])
            out = _sym.Dropout(as_sym(ins[0]), p=ratio, name=name)
        elif op == "Flatten":
            out = _sym.Flatten(as_sym(ins[0]), name=name)
        elif op == "Reshape":
            shape = tuple(int(x) for x in consts[ins[1]])
            out = _sym.reshape(as_sym(ins[0]), shape=shape, name=name)
        elif op == "Transpose":
            kw = {"axes": tuple(a["perm"])} if "perm" in a else {}
            out = _sym.transpose(as_sym(ins[0]), name=name, **kw)
        elif op == "Unsqueeze":
            axes = (tuple(a["axes"]) if "axes" in a
                    else tuple(int(x) for x in consts[ins[1]]))
            out = as_sym(ins[0])
            # ONNX axes are relative to the OUTPUT rank (negatives legal);
            # resolving them needs the input rank
            out_rank = None
            try:
                shp, _, _ = out.infer_shape()
                out_rank = len(shp[0]) + len(axes) if shp else None
            except Exception:
                pass
            norm = []
            for ax in axes:
                ax = int(ax)
                if ax < 0:
                    if out_rank is None:
                        raise NotImplementedError(
                            "ONNX import: negative Unsqueeze axes need "
                            "inferable input shape")
                    ax += out_rank
                norm.append(ax)
            for k, ax in enumerate(sorted(norm)):
                out = _sym.expand_dims(out, axis=ax,
                                         name="%s_%d" % (name, k))
        elif op == "Squeeze":
            axes = (tuple(a["axes"]) if "axes" in a
                    else (tuple(int(x) for x in consts[ins[1]])
                          if len(ins) > 1 else None))
            out = _sym.squeeze(as_sym(ins[0]),
                                 axis=(axes if axes is None else
                                       tuple(axes)), name=name)
        elif op == "Concat":
            out = _sym.concat(*[as_sym(x) for x in ins],
                                dim=a.get("axis", 1), name=name)
        elif op in ("Add", "Sub", "Mul", "Div"):
            fn = {"Add": _sym.broadcast_add, "Sub": _sym.broadcast_sub,
                  "Mul": _sym.broadcast_mul,
                  "Div": _sym.broadcast_div}[op]
            out = fn(as_sym(ins[0]), as_sym(ins[1]), name=name)
        elif op == "Sum":
            out = _sym.add_n(*[as_sym(x) for x in ins], name=name)
        elif op == "Gather":
            out = _sym.take(as_sym(ins[0]), as_sym(ins[1]),
                              axis=a.get("axis", 0), name=name)
        elif op == "Cast":
            to = a.get("to", P.DT.FLOAT)
            feeds = [c for o in node.output
                     for c in consumer_ops.get(o, [])]
            if to in (P.DT.INT64, P.DT.INT32) and feeds and \
                    all(c == ("Gather", 1) for c in feeds):
                # pure index cast (the Gather pattern): mx.take accepts
                # float indices, so the cast collapses
                out = as_sym(ins[0])
            elif to in (P.DT.INT64, P.DT.INT32):
                out = _sym.Cast(as_sym(ins[0]),
                                  dtype={P.DT.INT64: "int64",
                                         P.DT.INT32: "int32"}[to],
                                  name=name)
            else:
                dt = {P.DT.FLOAT: "float32", P.DT.FLOAT16: "float16",
                      P.DT.DOUBLE: "float64", P.DT.BFLOAT16: "bfloat16",
                      P.DT.UINT8: "uint8", P.DT.INT8: "int8",
                      P.DT.BOOL: "bool"}.get(to)
                if dt is None:
                    raise NotImplementedError(
                        "ONNX import: Cast to data_type %d" % to)
                out = _sym.Cast(as_sym(ins[0]), dtype=dt, name=name)
        elif op == "Identity":
            out = as_sym(ins[0])
        else:
            raise NotImplementedError(
                "ONNX import: unsupported op %r" % op)

        for o in node.output:
            sym_of[o] = out

    outs = [sym_of[o.name] for o in g.output]
    sym = outs[0] if len(outs) == 1 else _sym.Group(outs)

    arg_params, aux_params = {}, {}
    wanted = set(sym.list_arguments()) | set(
        getattr(sym, "list_auxiliary_states", lambda: [])())
    for pname, arr in used_params.items():
        if pname not in wanted:
            continue
        target = aux_params if pname in aux_names else arg_params
        target[pname] = (nd.array(arr) if torch.is_tensor(arr)
                         else nd.array(arr, dtype=arr.dtype))
    return sym, arg_params, aux_params
