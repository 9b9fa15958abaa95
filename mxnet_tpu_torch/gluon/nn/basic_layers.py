"""Basic layers (the port of the part of `mxnet_tpu.gluon.nn.basic_layers`
that the ResNets and BERT use): Sequential, HybridSequential, Dense,
Dropout, BatchNorm, Embedding, LayerNorm, Flatten. Same parameter names
and deferred shapes as the reference."""
from __future__ import annotations

import torch

from ...base import dtype_name
from ..block import Block, HybridBlock, _indent, record_aux_update
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "Embedding", "LayerNorm", "Flatten"]


def update_running_stats(running_mean, running_var, mean, var, momentum):
    """running <- running * m + batch * (1 - m), from the batch statistics
    cut from the graph, in the running statistics' dtype (reference:
    BatchNorm.hybrid_forward)."""
    m = momentum
    with torch.no_grad():
        for run, batch in ((running_mean, mean), (running_var, var)):
            cur = run.data_torch
            record_aux_update(run, cur * m + batch.data_torch.detach().to(
                cur.dtype) * (1 - m))


class _SequentialMixin:
    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def _run(self, x, *args):
        for block in self._children.values():
            x = block(x, *args)
            args = []
            if isinstance(x, (tuple, list)):
                args = x[1:]
                x = x[0]
        if args:
            x = tuple([x] + list(args))
        return x

    def __repr__(self):
        modstr = "\n".join(
            "  ({key}): {block}".format(key=key, block=_indent(repr(block), 2))
            for key, block in self._children.items())
        return "{name}(\n{modstr}\n)".format(name=self.__class__.__name__,
                                             modstr=modstr)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)


class Sequential(_SequentialMixin, Block):
    """Stack of Blocks."""

    def forward(self, x, *args):
        return self._run(x, *args)


class HybridSequential(_SequentialMixin, HybridBlock):
    """Stack of HybridBlocks."""

    def hybrid_forward(self, F, x, *args):
        return self._run(x, *args)


class Dense(HybridBlock):
    """Fully-connected layer with deferred in_units."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get(
                "weight", shape=(units, in_units),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _shape_from_input(self, x, *args):
        if self._flatten:
            in_units = 1
            for d in x.shape[1:]:
                in_units *= d
        else:
            in_units = x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act


class Dropout(HybridBlock):
    """Dropout at `rate` while training (`autograd.record()` in train
    mode); the identity in predict mode or at rate 0."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F.identity(x)

    def __repr__(self):
        return "{name}(p = {_rate}, axes={_axes})".format(
            name=self.__class__.__name__, **self.__dict__)


class BatchNorm(HybridBlock):
    """Batch normalization with moving statistics. Inference (and
    `use_global_stats`) normalizes with the moving statistics; training
    with the batch's, and moves the running statistics to ``m * old +
    (1 - m) * batch`` through `record_aux_update`."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale}
        self._axis = axis
        self._momentum = momentum
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def _shape_from_input(self, x, *args):
        channels = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (channels,)

    def cast(self, dtype):
        # BN parameters and statistics stay fp32 under half-precision casts
        # (the reference's AMP keeps BatchNorm fp32)
        if dtype_name(dtype) in ("float16", "bfloat16"):
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from ... import autograd
        from ..block import is_symbol
        if is_symbol(x):
            # traced to a graph: the executor picks the statistics by its
            # mode, so use_global_stats is written only when the block
            # sets it (as upstream MXNet exports it)
            extra = {"use_global_stats": True} if self._use_global_stats \
                else {}
            return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                               **self._kwargs, **extra)
        if self._use_global_stats or not autograd.is_training():
            return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                               use_global_stats=True, **self._kwargs)
        out, mean, var = F.BatchNorm(x, gamma, beta, running_mean,
                                     running_var, output_mean_var=True,
                                     **self._kwargs)
        update_running_stats(running_mean, running_var, mean, var,
                             self._momentum)
        return out


class Embedding(HybridBlock):
    """Index -> vector lookup in an (input_dim, output_dim) table; with
    `sparse_grad` the weight's gradient is row-sparse (the rows the batch
    looked up)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim),
            init=weight_initializer, dtype=dtype, allow_deferred_init=True,
            grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)

    def __repr__(self):
        return "{block_name}({input_dim} -> {output_dim}, {dtype})".format(
            block_name=self.__class__.__name__, **self._kwargs)


class LayerNorm(HybridBlock):
    """Layer normalization over `axis` (normalized in fp32, then gamma and
    beta in the data's dtype, as the reference)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {"eps": epsilon, "axis": axis, "center": center,
                        "scale": scale}
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def _shape_from_input(self, x, *args):
        channels = x.shape[self._axis]
        self.gamma.shape = (channels,)
        self.beta.shape = (channels,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)

    def __repr__(self):
        return "{name}({content}, in_channels={in_channels})".format(
            name=self.__class__.__name__,
            content=", ".join("=".join([k, v.__repr__()])
                              for k, v in self._kwargs.items()),
            in_channels=self.gamma.shape[0])


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return self.__class__.__name__
