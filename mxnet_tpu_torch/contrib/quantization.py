"""INT8 post-training quantization: calibration and the conversion of a
Gluon network or a symbolic model (the port of
`mxnet_tpu.contrib.quantization`; reference:
python/mxnet/contrib/quantization.py and
src/operator/quantization/calibrate.cc).

The pipeline, as in the reference:
  1. collect each target layer's input statistics over calibration
     batches of the float32 net: the running absolute maximum (naive) and
     a histogram for the KL-entropy threshold (entropy). Calibration stays
     numpy on the host and gives the JAX package's thresholds;
  2. replace the Dense/Conv2D blocks with quantized twins holding int8
     weights (symmetric, per output channel) and the calibrated input
     threshold;
  3. the quantized forward quantizes its input once, forms the int8
     product or convolution's int32 accumulator, and dequantizes into the
     float32 stream.

The int32 accumulator is bit-equal to the reference's
``preferred_element_type=int32`` dot and convolution: torch has no int8
convolution that accumulates in int32 on the card, so the integer
products are summed in float64, which holds every such sum below 2^53
exactly, and cast to int32 (`ops.quantization_ops.int8_conv_acc` and
`int8_dot_acc`, the route of the quantized ops).
"""
from __future__ import annotations

import json as _json
import logging

import numpy as _np
import torch

from .. import ndarray as nd
from ..context import current_context
from ..gluon import nn as _nn
from ..gluon.block import HybridBlock
from ..ops.quantization_ops import int8_conv_acc, int8_dot_acc
from ..ops.tensor import div_once as _div

__all__ = ["quantize_net", "quantize_model", "calib_thresholds",
           "QuantizedDense", "QuantizedConv2D"]

INT8_MAX = 127.0


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
class _Collector:
    """Per-layer input statistics: the running absolute maximum and a
    histogram for the entropy mode (reference: _LayerHistogramCollector)."""

    def __init__(self, bins=2048):
        self.bins = bins
        self.absmax = {}
        self.hist = {}

    def update(self, name, arr):
        a = _np.abs(_np.asarray(arr, dtype=_np.float32)).ravel()
        m = float(a.max()) if a.size else 0.0
        old = self.absmax.get(name, 0.0)
        if name in self.hist:
            h, edges = self.hist[name]
            if m > old:  # re-bin the old histogram onto the wider range
                new_edges = _np.linspace(0, m, self.bins + 1)
                centers = (edges[:-1] + edges[1:]) / 2
                nh, _ = _np.histogram(centers, bins=new_edges, weights=h)
                h, edges = nh, new_edges
            h += _np.histogram(a, bins=edges)[0]
            self.hist[name] = (h, edges)
        else:
            edges = _np.linspace(0, max(m, 1e-12), self.bins + 1)
            self.hist[name] = (_np.histogram(a, bins=edges)[0]
                               .astype(_np.float64), edges)
        self.absmax[name] = max(old, m)


def _smooth_distribution(d, eps=1e-4):
    """Move eps mass onto the zero entries so that KL terms stay finite.
    reference: quantization.py (_smooth_distribution)."""
    d = d.astype(_np.float64).copy()
    zeros = d == 0
    n_zero, n_nonzero = zeros.sum(), (~zeros).sum()
    if n_zero and n_nonzero:
        d[~zeros] -= eps * n_zero / n_nonzero
        d[zeros] = eps
    return d


def _quantized_slice(sliced, num_quantized_bins):
    """The reference's Q: chunk j of `sliced` (bins [int(j f),
    max(int((j + 1) f), int(j f) + 1)), f = len / num_quantized_bins) is
    replaced by its mean over its nonzero bins, at those bins; where
    chunks overlap, the last one written wins. The reference writes the
    chunks one by one in Python; here they are formed at once from running
    sums, which are exact for the histogram's integer counts, so Q is the
    same array."""
    n = len(sliced)
    factor = n / num_quantized_bins
    j = _np.arange(num_quantized_bins, dtype=_np.float64)
    lo = (j * factor).astype(_np.int64)
    hi = _np.maximum(((j + 1) * factor).astype(_np.int64), lo + 1)
    csum = _np.concatenate([[0.0], _np.cumsum(sliced)])
    cnt = _np.concatenate([[0], _np.cumsum(sliced > 0)])
    total, nz = csum[hi] - csum[lo], cnt[hi] - cnt[lo]
    mean = _np.divide(total, nz, out=_np.zeros_like(total), where=nz > 0)
    pos = _np.arange(n)
    last = _np.searchsorted(lo, pos, side="right") - 1  # the last writer
    covered = (last >= 0) & (pos < hi[_np.maximum(last, 0)]) \
        & (nz[_np.maximum(last, 0)] > 0)
    return _np.where(covered & (sliced > 0),
                     mean[_np.maximum(last, 0)], 0.0)


def _entropy_threshold(hist, edges, num_quantized_bins=255):
    """The KL-divergence-optimal clip threshold of an absolute-value
    histogram. reference: calibrate.cc (GetOptimalThreshold)."""
    total = hist.sum()
    if total == 0:
        return float(edges[-1])
    best_kl, best_t = _np.inf, float(edges[-1])
    # P is the clipped distribution (the outlier mass moved onto the edge
    # bin); Q the unclipped slice quantized to num_quantized_bins, so that
    # clipped mass shows as a P/Q mismatch at the edge
    start = num_quantized_bins // 2
    for i in range(start, len(hist) + 1, max(1, len(hist) // 128)):
        t = edges[i]
        sliced = hist[:i].astype(_np.float64)
        if sliced.sum() == 0:
            continue
        p = sliced.copy()
        p[-1] += hist[i:].sum()
        q = _quantized_slice(sliced, num_quantized_bins)
        p, q = _smooth_distribution(p), _smooth_distribution(q)
        pn, qn = p / p.sum(), q / q.sum()
        kl = float((pn * _np.log(pn / qn)).sum())
        if kl < best_kl:
            best_kl, best_t = kl, float(t)
    return best_t


def calib_thresholds(collector, mode="entropy"):
    """{layer name: activation clip threshold} from collected stats."""
    if mode == "naive":
        return dict(collector.absmax)
    return {name: _entropy_threshold(h, e)
            for name, (h, e) in collector.hist.items()}


# ---------------------------------------------------------------------------
# quantized layers
# ---------------------------------------------------------------------------
def _quantize_weight(w, axis=0):
    """Symmetric per-output-channel int8 weights: (int8, thresholds), the
    rounding half to even."""
    red = tuple(i for i in range(w.ndim) if i != axis)
    t = _np.maximum(_np.abs(w).max(axis=red, keepdims=False), 1e-30)
    scale = INT8_MAX / t
    shape = [1] * w.ndim
    shape[axis] = -1
    q = _np.clip(_np.round(w * scale.reshape(shape)), -INT8_MAX,
                 INT8_MAX).astype(_np.int8)
    return q, t.astype(_np.float32)


class _QuantizedBase(HybridBlock):
    """int8 weight buffers and the input quantization, on the device of
    the float layer's weight. act_max None: the range of each batch
    (calib_mode 'none'); else the calibrated threshold."""

    def __init__(self, layer, act_max, channel_axis=0, **kw):
        super().__init__(**kw)
        w_nd = layer.weight.list_data()[0]
        dev = w_nd._data.device
        b_nd = layer.bias.list_data()[0] if layer.bias is not None else None
        q, w_t = _quantize_weight(w_nd.asnumpy(), axis=channel_axis)
        self._wq = torch.from_numpy(q).to(dev)
        self._w_t = torch.from_numpy(w_t).to(dev)   # per-channel thresholds
        self._bias = (b_nd._data.detach().to(torch.float32).clone()
                      if b_nd is not None else None)
        self._act_max = act_max                     # a Python float | None
        self._act = getattr(layer, "act", None)

    def _quant_input(self, x32):
        if self._act_max is not None:
            t = torch.tensor(self._act_max, dtype=torch.float32,
                             device=x32.device)
        else:
            t = torch.clamp(torch.abs(x32).max(), min=1e-30)
        scale = _div(INT8_MAX, t)
        xq = torch.clamp(torch.round(x32 * scale), -INT8_MAX,
                         INT8_MAX).to(torch.int8)
        return xq, t

    def _dequant(self, acc, t_x, channel_shape):
        factor = _div(t_x * self._w_t, INT8_MAX * INT8_MAX)
        deq = acc.to(torch.float32) * factor.reshape(channel_shape)
        if self._bias is not None:
            deq = deq + self._bias.reshape(channel_shape)
        return deq

    def hybrid_forward(self, F, x):
        with torch.no_grad():
            out = nd.NDArray(self._compute(x._data.to(torch.float32)),
                             ctx=x.context)
        return self._act(out) if self._act is not None else out


class QuantizedDense(_QuantizedBase):
    """The int8 twin of nn.Dense (reference: quantized_fully_connected.cc
    through quantize_net's rewrite)."""

    def __init__(self, dense, act_max, **kw):
        super().__init__(dense, act_max, channel_axis=0, **kw)
        self._flatten = dense._flatten

    def accumulate(self, x32):
        """(int32 accumulator, input threshold) of a float32 input."""
        if self._flatten and x32.dim() > 2:
            x32 = x32.reshape(x32.shape[0], -1)
        xq, t_x = self._quant_input(x32)
        return int8_dot_acc(xq, self._wq), t_x

    def _compute(self, x32):
        acc, t_x = self.accumulate(x32)
        return self._dequant(acc, t_x, (-1,))


class QuantizedConv2D(_QuantizedBase):
    """The int8 twin of nn.Conv2D, NCHW (reference: quantized_conv.cc)."""

    def __init__(self, conv, act_max, **kw):
        if conv._channels_last:
            raise NotImplementedError(
                "QuantizedConv2D: channels-first (NCHW) convolutions only, "
                "got layout %r" % conv._kwargs.get("layout"))
        super().__init__(conv, act_max, channel_axis=0, **kw)
        kw_ = conv._kwargs
        self._stride = tuple(kw_.get("stride") or (1, 1))
        self._pad = tuple(kw_.get("pad") or (0, 0))
        self._dilate = tuple(kw_.get("dilate") or (1, 1))
        self._groups = kw_.get("num_group", 1)

    def accumulate(self, x32):
        """(int32 accumulator, input threshold) of a float32 input."""
        xq, t_x = self._quant_input(x32)
        return int8_conv_acc(xq, self._wq, self._stride, self._pad,
                             self._dilate, self._groups), t_x

    def _compute(self, x32):
        acc, t_x = self.accumulate(x32)
        return self._dequant(acc, t_x, (1, -1, 1, 1))


# ---------------------------------------------------------------------------
# network conversion
# ---------------------------------------------------------------------------
_QUANTIZABLE = (_nn.Dense, _nn.Conv2D)


def _walk(block, prefix=""):
    for name, child in block._children.items():
        path = prefix + name
        yield path, block, name, child
        yield from _walk(child, path + ".")


def _batch_data(batch):
    """The data of a calibration batch: an array, or a DataBatch's first
    data array (a numpy array's own ``.data`` is its buffer)."""
    if isinstance(batch, (nd.NDArray, _np.ndarray)):
        return batch
    return batch.data[0] if hasattr(batch, "data") else batch


def quantize_net(network, quantized_dtype="int8", exclude_layers=None,
                 exclude_layers_match=None, calib_data=None,
                 calib_mode="naive", num_calib_examples=None, ctx=None,
                 logger=None):
    """Quantize a Gluon network (returns it, its Dense and Conv2D children
    swapped for quantized twins). reference: quantization.py
    (quantize_net). The network must have run a forward (shapes known).
    calib_mode: 'none' (each batch's range), 'naive' (absolute maximum) or
    'entropy' (KL-optimal thresholds, calibrate.cc); a calibration batch
    that is not an NDArray goes to `ctx` (default the current context).
    """
    if quantized_dtype != "int8":
        raise NotImplementedError("only int8 quantization is implemented")
    ctx = ctx or current_context()
    log = logger or logging.getLogger(__name__)
    exclude_layers = set(exclude_layers or ())
    exclude_layers_match = list(exclude_layers_match or ())

    targets = {}
    for path, parent, name, child in _walk(network):
        if not isinstance(child, _QUANTIZABLE):
            continue
        if child.name in exclude_layers or path in exclude_layers:
            continue
        if any(m in child.name or m in path for m in exclude_layers_match):
            continue
        if child.weight._data is None:
            raise ValueError(
                "quantize_net: layer %s has uninitialized weights — run a "
                "forward pass first" % child.name)
        targets[path] = (parent, name, child)
    if not targets:
        return network

    thresholds = {}
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise ValueError("calib_mode=%r requires calib_data" % calib_mode)
        collector = _Collector()
        # the port's hybridized forward is eager, so the probes below see
        # every call of a hybridized net as they do of an imperative one
        originals = {}

        def make_probe(path, child):
            orig = child.forward

            def probe(x, *args, **kw):
                collector.update(path, x.asnumpy())
                return orig(x, *args, **kw)
            return orig, probe

        for path, (parent, name, child) in targets.items():
            orig, probe = make_probe(path, child)
            originals[path] = orig
            child.forward = probe
        if isinstance(calib_data, (nd.NDArray, _np.ndarray)):
            # a bare array is one calibration batch
            calib_data = [calib_data]
        try:
            seen = 0
            for batch in calib_data:
                data = _batch_data(batch)
                if not isinstance(data, nd.NDArray):
                    data = nd.array(data, ctx=ctx)
                network(data)
                seen += data.shape[0]
                if num_calib_examples and seen >= num_calib_examples:
                    break
        finally:
            for path, (parent, name, child) in targets.items():
                child.forward = originals[path]
        thresholds = calib_thresholds(collector, calib_mode)
        log.info("quantize_net: calibrated %d layers over %d examples (%s)",
                 len(thresholds), seen, calib_mode)

    for path, (parent, name, child) in targets.items():
        t = thresholds.get(path)
        if isinstance(child, _nn.Conv2D):
            q = QuantizedConv2D(child, t, prefix=child.prefix + "quant_")
        else:
            q = QuantizedDense(child, t, prefix=child.prefix + "quant_")
        q._active = child._active      # keep the block's hybridization
        parent._children[name] = q
        for attr, val in list(vars(parent).items()):
            if val is child:           # an attribute child (self.fc1)
                object.__setattr__(parent, attr, q)
    return network


# ---------------------------------------------------------------------------
# symbolic quantization (reference: quantization.py quantize_model, a graph
# rewrite over the symbol's JSON, src/operator/quantization/
# quantize_graph_pass.cc)
# ---------------------------------------------------------------------------
def _json_nodes(symbol):
    return _json.loads(symbol.tojson())


def _rebuild(graph):
    from .. import symbol as _sym
    return _sym.load_json(_json.dumps(graph))


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   label_names=("softmax_label",), ctx=None,
                   excluded_sym_names=None, excluded_op_names=None,
                   calib_mode="none", calib_data=None,
                   num_calib_examples=None, quantized_dtype="int8",
                   quantize_mode="smart", logger=None):
    """Quantize a symbolic model: FullyConnected/Convolution nodes become
    `_contrib_quantize_v2 -> _contrib_quantized_* -> _contrib_dequantize`
    chains; their weights and biases become int8 parameters quantized
    offline with scalar ranges. Returns (qsym, qarg_params, aux_params).
    Calibration binds the graph's internals on `ctx` (default the current
    context). reference: quantization.py (quantize_model)."""
    if quantized_dtype != "int8":
        raise NotImplementedError("only int8 quantization is implemented")
    excluded_sym_names = set(excluded_sym_names or ())
    excluded_op_names = set(excluded_op_names or ())
    log = logger or logging.getLogger(__name__)

    graph = _json_nodes(sym)
    nodes = graph["nodes"]
    targets = {}
    for i, n in enumerate(nodes):
        if n["op"] in ("FullyConnected", "Convolution") \
                and n["op"] not in excluded_op_names \
                and n["name"] not in excluded_sym_names:
            wsrc = nodes[n["inputs"][1][0]]
            if wsrc["op"] != "null" or wsrc["name"] not in arg_params:
                continue
            if n["op"] == "Convolution":
                attrs = n.get("attrs", {})
                if attrs.get("layout") not in (None, "None", "NCHW"):
                    continue
            targets[i] = n

    # ---- calibration: each target's input range over the batches -------
    thresholds = {}
    if calib_mode in ("naive", "entropy") and targets:
        if calib_data is None:
            raise ValueError("calib_mode=%r requires calib_data" % calib_mode)
        from .. import symbol as _sym_mod
        internals = sym.get_internals()
        by_name = {s.name: s for s in internals}
        need = {}   # target node index -> the internal of its data input
        for i, n in targets.items():
            src, slot, _ = n["inputs"][0]
            sname = nodes[src]["name"]
            # a multi-output internal is registered as <name>_output<i>
            if sname + "_output%d" % slot in by_name:
                sname = sname + "_output%d" % slot
            need[i] = by_name[sname]
        group = _sym_mod.Group(list(need.values()))
        collector = _Collector()
        if isinstance(calib_data, (nd.NDArray, _np.ndarray)):
            calib_data = [calib_data]
        seen = 0
        ex, bound_shape = None, None
        for batch in calib_data:
            data = _batch_data(batch)
            if isinstance(data, nd.NDArray):
                data = data.asnumpy()
            if ex is None or data.shape != bound_shape:
                ex = group.simple_bind(ctx or current_context(),
                                       **{data_names[0]: data.shape})
                bound_shape = data.shape
                for k, v in arg_params.items():
                    if k in ex.arg_dict:
                        ex.arg_dict[k][:] = v.asnumpy()
                for k, v in (aux_params or {}).items():
                    if k in ex.aux_dict:
                        ex.aux_dict[k][:] = v.asnumpy()
            ex.forward(**{data_names[0]: data})
            for idx, out in zip(need, ex.outputs):
                collector.update(nodes[idx]["name"], out.asnumpy())
            seen += data.shape[0]
            if num_calib_examples and seen >= num_calib_examples:
                break
        thresholds = calib_thresholds(collector, calib_mode)
        log.info("quantize_model: calibrated %d layers over %d examples",
                 len(thresholds), seen)

    # ---- graph rewrite -------------------------------------------------
    qarg = {k: v for k, v in arg_params.items()}
    new_nodes = list(nodes)
    remap = {}      # original node i -> (node id, slot) of its output 0

    def _add(node):
        new_nodes.append(node)
        return len(new_nodes) - 1

    def _fix(inp):
        src, slot, x = inp
        if src in remap and slot == 0:
            return [remap[src][0], remap[src][1], x]
        return [src, slot, x]

    quantized_params = {}   # float parameter name -> its three node ids

    def _offline_quantize(pname):
        """int8-quantize one float parameter into qarg and three null
        nodes; reused where several targets tie the same variable."""
        if pname in quantized_params:
            return quantized_params[pname]
        arr = arg_params[pname].asnumpy()
        t = float(max(abs(arr.min()), abs(arr.max()), 1e-30))
        qarg[pname + "_quantize"] = nd.array(
            _np.clip(_np.round(arr * (INT8_MAX / t)), -INT8_MAX, INT8_MAX)
            .astype(_np.int8), dtype="int8")
        qarg[pname + "_quantize_min"] = nd.array(_np.array([-t],
                                                           _np.float32))
        qarg[pname + "_quantize_max"] = nd.array(_np.array([t],
                                                           _np.float32))
        del qarg[pname]
        ids = (_add({"op": "null", "name": pname + "_quantize",
                     "inputs": [],
                     "attrs": {"__shape__": str(tuple(arr.shape)),
                               "__dtype__": "int8"}}),
               _add({"op": "null", "name": pname + "_quantize_min",
                     "inputs": [], "attrs": {"__shape__": "(1,)"}}),
               _add({"op": "null", "name": pname + "_quantize_max",
                     "inputs": [], "attrs": {"__shape__": "(1,)"}}))
        quantized_params[pname] = ids
        return ids

    for i in sorted(targets):
        n = dict(targets[i])
        attrs = dict(n.get("attrs", {}))
        no_bias = str(attrs.get("no_bias", "False")).lower() in ("true", "1")
        wname = new_nodes[n["inputs"][1][0]]["name"]
        wq, wmin, wmax = _offline_quantize(wname)
        if not no_bias and len(n["inputs"]) > 2:
            bname = new_nodes[n["inputs"][2][0]]["name"]
            bq, bmin, bmax = _offline_quantize(bname)
        else:
            bq, bmin, bmax = wq, wmin, wmax  # placeholders, never read
            attrs["no_bias"] = "True"

        qv_attrs = {"out_type": "int8"}
        if n["name"] in thresholds:
            qv_attrs["min_calib_range"] = str(-thresholds[n["name"]])
            qv_attrs["max_calib_range"] = str(thresholds[n["name"]])
        qv = _add({"op": "_contrib_quantize_v2",
                   "name": n["name"] + "_quantize", "attrs": qv_attrs,
                   "inputs": [_fix(n["inputs"][0])]})
        qop = _add({"op": "_contrib_quantized_" +
                    ("fully_connected" if n["op"] == "FullyConnected"
                     else "conv"),
                    "name": n["name"] + "_quantized", "attrs": attrs,
                    "inputs": [[qv, 0, 0], [wq, 0, 0], [bq, 0, 0],
                               [qv, 1, 0], [qv, 2, 0], [wmin, 0, 0],
                               [wmax, 0, 0], [bmin, 0, 0], [bmax, 0, 0]]})
        deq = _add({"op": "_contrib_dequantize",
                    "name": n["name"] + "_dequantize", "attrs": {},
                    "inputs": [[qop, 0, 0], [qop, 1, 0], [qop, 2, 0]]})
        remap[i] = (deq, 0)

    # every consumer (and the heads) onto the dequantized outputs
    for j, n in enumerate(new_nodes):
        if n.get("inputs") and j not in (r[0] for r in remap.values()):
            if not (n["name"].endswith("_quantize")
                    or n["name"].endswith("_quantized")
                    or n["name"].endswith("_dequantize")):
                n["inputs"] = [_fix(inp) for inp in n["inputs"]]
    graph["heads"] = [list(_fix(h)) for h in graph["heads"]]

    # the rewrite appended producers after their consumers: sort the
    # nodes topologically and renumber them, as the JSON requires
    order, seen = [], set()

    def visit(j):
        if j in seen:
            return
        seen.add(j)
        for src, _, _ in new_nodes[j].get("inputs", []):
            visit(src)
        order.append(j)

    for h in graph["heads"]:
        visit(h[0])
    for j in range(len(new_nodes)):   # keep unreferenced arguments too
        visit(j)
    renum = {old: new for new, old in enumerate(order)}
    sorted_nodes = []
    for old in order:
        n = dict(new_nodes[old])
        n["inputs"] = [[renum[s], sl, x]
                       for s, sl, x in n.get("inputs", [])]
        sorted_nodes.append(n)
    graph["heads"] = [[renum[h[0]], h[1], h[2]] for h in graph["heads"]]
    graph["nodes"] = sorted_nodes
    graph["arg_nodes"] = [j for j, n in enumerate(sorted_nodes)
                          if n["op"] == "null"]
    graph["node_row_ptr"] = list(range(len(sorted_nodes) + 1))

    qsym = _rebuild(graph)
    log.info("quantize_model: %d layers quantized", len(targets))
    return qsym, qarg, dict(aux_params or {})
