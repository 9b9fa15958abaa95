"""`mx.npx` (the port of `mxnet_tpu.numpy_extension`): operators outside
numpy's standard (the neural-network ops) and the np-mode switches, for
`mx.np` arrays. Every function runs an existing registry op, so it takes
`mx.np.ndarray` and legacy `mx.nd.NDArray` inputs alike, records under
`autograd.record()` and gives `mx.np.ndarray` results."""
from __future__ import annotations

import numpy as _onp
import torch

from .ndarray.ndarray import invoke as _raw_invoke
from .numpy.multiarray import as_np_ndarray as _as_np

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape",
           "softmax", "log_softmax", "masked_softmax", "relu", "sigmoid",
           "one_hot", "pick", "topk", "batch_dot", "embedding", "gamma",
           "activation", "fully_connected", "convolution", "deconvolution",
           "pooling", "batch_norm", "layer_norm", "group_norm", "dropout",
           "leaky_relu", "rnn", "reshape_like", "arange_like",
           "broadcast_like", "gather_nd", "scatter_nd", "smooth_l1",
           "sequence_mask", "erf", "erfinv", "seed", "waitall", "save",
           "load", "cast", "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt"]


def invoke(*args, **kwargs):
    return _as_np(_raw_invoke(*args, **kwargs))


_np_mode = {"array": False, "shape": False}


def set_np(shape=True, array=True):
    """Turn numpy semantics on: Gluon's blocks, `Parameter.data()` and the
    DataLoader then hand out `mx.np.ndarray`s."""
    _np_mode["array"] = bool(array)
    _np_mode["shape"] = bool(shape)


def reset_np():
    set_np(shape=False, array=False)


def is_np_array():
    return _np_mode["array"]


def is_np_shape():
    return _np_mode["shape"]


def softmax(data, axis=-1, length=None, temperature=None):
    kwargs = {"axis": axis}
    if temperature is not None:
        kwargs["temperature"] = temperature
    if length is not None:
        # variable-length masking: the positions past `length` give 0
        kwargs["length"] = length
        kwargs["use_length"] = True
    return invoke("softmax", data, **kwargs)


def log_softmax(data, axis=-1):
    return invoke("log_softmax", data, axis=axis)


def masked_softmax(data, mask, axis=-1):
    """softmax over the positions where `mask` is 1; a row with no such
    position gives 0. The masked logits take half the dtype's minimum (a
    finite floor: -1e18 overflows float16 to -inf, and a row of -inf gives
    NaN)."""
    m = mask.astype(data.dtype)
    big = float(_onp.finfo(_onp.dtype(str(data.dtype))).min) / 2
    return invoke("softmax", data * m + (1.0 - m) * big, axis=axis) * m


def relu(data):
    return invoke("relu", data)


def sigmoid(data):
    return invoke("sigmoid", data)


def erf(data):
    return invoke("erf", data)


def erfinv(data):
    return invoke("erfinv", data)


def one_hot(data, depth, on_value=1.0, off_value=0.0):
    return invoke("one_hot", data, depth=depth, on_value=on_value,
                  off_value=off_value)


def pick(data, index, axis=-1, keepdims=False):
    return invoke("pick", data, index, axis=axis, keepdims=keepdims)


def topk(data, k=1, axis=-1, ret_typ="indices"):
    return invoke("topk", data, k=k, axis=axis, ret_typ=ret_typ)


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    return invoke("batch_dot", lhs, rhs, transpose_a=transpose_a,
                  transpose_b=transpose_b)


def embedding(data, weight, input_dim=None, output_dim=None):
    return invoke("Embedding", data, weight, input_dim=input_dim,
                  output_dim=output_dim)


def gamma(data):
    return invoke("gamma", data)


def activation(data, act_type="relu"):
    return invoke("Activation", data, act_type=act_type)


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    num_hidden = num_hidden or weight.shape[0]
    if bias is None or no_bias:
        return invoke("FullyConnected", x, weight, num_hidden=num_hidden,
                      no_bias=True, flatten=flatten)
    return invoke("FullyConnected", x, weight, bias, num_hidden=num_hidden,
                  no_bias=False, flatten=flatten)


def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout="NCHW"):
    args = [data, weight] + ([] if (bias is None or no_bias) else [bias])
    return invoke("Convolution", *args, kernel=kernel, stride=stride,
                  dilate=dilate, pad=pad,
                  num_filter=num_filter or weight.shape[0],
                  num_group=num_group, no_bias=bias is None or no_bias,
                  layout=layout)


def deconvolution(data, weight, bias=None, **kwargs):
    args = [data, weight] + ([] if bias is None else [bias])
    kwargs.setdefault("no_bias", bias is None)
    return invoke("Deconvolution", *args, **kwargs)


def pooling(data, kernel=None, pool_type="max", stride=None, pad=None,
            global_pool=False, layout="NCHW"):
    return invoke("Pooling", data, kernel=kernel, pool_type=pool_type,
                  stride=stride, pad=pad, global_pool=global_pool,
                  layout=layout)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               axis=1):
    return invoke("BatchNorm", x, gamma, beta, running_mean, running_var,
                  eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                  use_global_stats=use_global_stats, axis=axis)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    return invoke("LayerNorm", data, gamma, beta, axis=axis, eps=eps)


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    return invoke("GroupNorm", data, gamma, beta, num_groups=num_groups,
                  eps=eps)


def dropout(data, p=0.5, mode="training", axes=None):
    return invoke("Dropout", data, p=p, mode=mode, axes=axes)


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25, **kwargs):
    args = [data] if gamma is None else [data, gamma]
    return invoke("LeakyReLU", *args, act_type=act_type, slope=slope,
                  **kwargs)


def rnn(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0, **kwargs):
    args = [data, parameters, state]
    if state_cell is not None:
        args.append(state_cell)
    return invoke("RNN", *args, state_size=state_size,
                  num_layers=num_layers, mode=mode,
                  bidirectional=bidirectional, p=p, **kwargs)


def reshape_like(lhs, rhs):
    return invoke("reshape_like", lhs, rhs)


def arange_like(data, start=0.0, step=1.0, axis=None):
    return invoke("_contrib_arange_like", data, start=start, step=step,
                  axis=axis)


def broadcast_like(lhs, rhs):
    return invoke("broadcast_like", lhs, rhs)


def gather_nd(data, indices):
    return invoke("gather_nd", data, indices)


def scatter_nd(data, indices, shape):
    return invoke("scatter_nd", data, indices, shape=shape)


def smooth_l1(data, scalar=1.0):
    return invoke("smooth_l1", data, scalar=scalar)


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if sequence_length is not None:
        return invoke("SequenceMask", data, sequence_length,
                      use_sequence_length=True, value=value, axis=axis)
    return invoke("SequenceMask", data, use_sequence_length=False,
                  value=value, axis=axis)


def cast(data, dtype):
    return invoke("cast", data, dtype=dtype)


def seed(s):
    from . import random as _random
    _random.seed(s)


def waitall():
    """Wait for the work queued on the card (no-op without one)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def save(file, arrays):
    """Save a dict or list of arrays as a `.params` file."""
    from .ndarray.ndarray import save as _nd_save
    _nd_save(file, arrays)


def load(file):
    from .ndarray.ndarray import load as _nd_load
    out = _nd_load(file)
    if isinstance(out, dict):
        return {k: _as_np(v) for k, v in out.items()}
    return _as_np(out)


def interleaved_matmul_selfatt_qk(queries_keys_values, heads):
    """The attention scores of an interleaved (S, B, 3 * C) projection
    (GluonNLP's attention cells call it by this name)."""
    return invoke("_contrib_interleaved_matmul_selfatt_qk",
                  queries_keys_values, heads=heads)


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, heads):
    return invoke("_contrib_interleaved_matmul_selfatt_valatt",
                  queries_keys_values, attention, heads=heads)
