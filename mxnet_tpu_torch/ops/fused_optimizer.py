"""One-pass SGD(-momentum) and Adam updates and LAMB's two passes (the
port of `mxnet_tpu.ops.fused_optimizer`).

`multi_sgd` and `multi_adam` wrap the hand-written kernels #7 and #8 of
``csrc/fused_optimizer.cu`` over a list of tensors (the reference's
aggregated `SGD`/`Adam.fused_update`): one launch (a table of up to 320
tensors in the kernel's parameters; a longer list takes consecutive
launches) reads every element of each weight, its gradient and its state
once, runs the update in fp32 and writes every output once. `flat_sgd`
and `flat_adam` launch the same kernels over one tensor. All of them
update their tensors IN PLACE (the weight, the state and the fp32
master), which saves an allocation per parameter per step; the
reference's functions return new arrays. CUDA tensors go through the
kernel (each launch counted under variant "multi" or "single"), CPU
tensors through the plain version (`_ref_flat_sgd`, `_ref_flat_adam`:
the reference's `_fused_flat_xla` arithmetic as separate fp32 torch ops,
rounded once to each output's dtype), whose results are then copied in.
On the card each torch op rounds once and the kernel uses round-to-nearest
intrinsics in the same order, so the two agree bit for bit at fp32.

`flat_update_fn(kind, momentum_on, clip_on, mp_on)` has the call signature
of the reference's (flat vectors, per-element lr/wd), for the ZeRO slice;
the per-parameter optimizer ops (`ops.optimizer_ops`) call the same
wrappers with scalar lr/wd. Unlike the reference, no dtype gate sends a
bf16 weight elsewhere: fp32 and bf16 weights, gradients and states all
launch the kernel, and the arithmetic is fp32 with one rounding per output.

LAMB (``csrc/lamb.cu``): `flat_lamb1` (kernel #9) updates the moments in
place and returns the fp32 direction and, given the bucket's key segments,
each key's squared norms of the weight and of the direction; `flat_lamb2`
(kernel #10) applies ``w32 - scale * direction`` in place. Their plain
versions are the reference's `_lamb1_xla_impl` and `_apply_xla_impl` as
separate fp32 torch ops. `lamb_flat_phase1_fn` / `lamb_flat_apply_fn` keep
the reference's call signatures for the ZeRO updater; the per-parameter
ops `lamb_update_phase1/2` call the same wrappers with a scalar wd and
scale. fp32, bf16 and fp16 tensors all launch the kernels.
"""
from __future__ import annotations

import ctypes
import itertools
import operator
import weakref

import numpy as np
import torch

from . import count_launch
from ._build import bind

__all__ = ["multi_sgd", "multi_adam", "flat_sgd", "flat_adam",
           "flat_update_fn", "flat_lamb1",
           "flat_lamb2", "lamb_chunk_table", "lamb_flat_phase1_fn",
           "lamb_flat_apply_fn", "LAMB_CHUNK"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LAMB_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LAMB_CLIP, _LAMB_MP, _LAMB_BIAS, _LAMB_VEC = 1, 2, 4, 8
_MOMENTUM, _CLIP, _MP, _VEC = 1, 2, 4, 8


def _ref_flat_sgd(w, g, mom, master, lr, wd, momentum, rescale, clip,
                  momentum_on, clip_on, mp_on):
    """SGD(-momentum) as separate fp32 ops: (new w, new mom, new master).
    lr and wd are floats or fp32 tensors of w's shape."""
    w32 = master if mp_on else w.float()
    g32 = g.float() * rescale
    if clip_on:
        g32 = torch.clamp(g32, -clip, clip)
    g32 = g32 + wd * w32
    if momentum_on:
        m = mom.float() * momentum - lr * g32
        new_mom = m.to(mom.dtype)
        w32n = w32 + m
    else:
        new_mom = mom
        w32n = w32 - lr * g32
    return w32n.to(w.dtype), new_mom, (w32n if mp_on else master)


def _ref_flat_adam(w, g, mean, var, master, lr, wd, beta1, omb1, beta2, omb2,
                   eps, rescale, clip, clip_on, mp_on):
    """Adam (bias correction folded into lr by the caller) as separate fp32
    ops: (new w, new mean, new var, new master)."""
    w32 = master if mp_on else w.float()
    g32 = g.float() * rescale
    if clip_on:
        g32 = torch.clamp(g32, -clip, clip)
    g32 = g32 + wd * w32
    m = beta1 * mean.float() + omb1 * g32
    v = beta2 * var.float() + omb2 * g32 * g32
    w32n = w32 - lr * m / (torch.sqrt(v) + eps)
    return (w32n.to(w.dtype), m.to(mean.dtype), v.to(var.dtype),
            w32n if mp_on else master)


def _scalar_or_vec(kernel, name, v, n, dev):
    """(float, None) for a scalar lr/wd, (0.0, tensor) for a per-element
    fp32 vector of n elements."""
    if torch.is_tensor(v) and v.dim() > 0:
        if v.numel() != n or v.dtype != torch.float32 or v.device != dev \
                or not v.is_contiguous():
            raise ValueError("%s: a per-element %s must be a contiguous "
                             "float32 tensor of %d elements on %s, got %s %s"
                             % (kernel, name, n, dev, v.dtype,
                                tuple(v.shape)))
        return 0.0, v
    return float(v), None


def _check(name, w, g, states, master, mp_on, dtypes=_DTYPES):
    n = w.numel()
    for label, t in [("weight", w), ("grad", g)] + states:
        if t.dtype not in dtypes:
            raise ValueError("%s: the kernel takes %s tensors, got %s %s"
                             % (name, "/".join(str(d)[6:] for d in dtypes),
                                label, t.dtype))
        if t.numel() != n or t.device != w.device or not t.is_contiguous():
            raise ValueError("%s: %s must be a contiguous tensor of %d "
                             "elements on %s" % (name, label, n, w.device))
    if mp_on and (master is None or master.dtype != torch.float32
                  or master.numel() != n or master.device != w.device
                  or not master.is_contiguous()):
        raise ValueError("%s: the master copy must be a contiguous float32 "
                         "tensor of %d elements" % (name, n))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(kernel, symbol, argtypes, args, dev):
    lib, fn = bind(kernel, symbol, argtypes)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("%s: launch failed: %s"
                           % (kernel, lib.mx_cuda_error_string(err).decode()))
    count_launch(kernel)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# One tensor of a launch of kernel #7/#8, as csrc/fused_optimizer.cu's
# HostEntry: w, g, the states (momentum, or Adam's mean and var) and the
# fp32 master as pointers (0 where absent), n, lr, wd, and the w/g/state
# dtype codes.
_ENTRY = np.dtype([("w", np.uint64), ("g", np.uint64), ("s0", np.uint64),
                   ("s1", np.uint64), ("master", np.uint64),
                   ("n", np.int64), ("lr", np.float32), ("wd", np.float32),
                   ("w_dtype", np.int32), ("g_dtype", np.int32),
                   ("s_dtype", np.int32), ("pad", np.int32)])
_SGD_ARGS = [_P, _I, _P, _P] + [_F] * 3 + [_I, _P]
_ADAM_ARGS = [_P, _I, _P, _P] + [_F] * 7 + [_I, _P]
_capacity = {}      # kernel -> tensors one launch takes
_T = torch.Tensor
_DTYPE_OF = operator.attrgetter("dtype")


def _plain_update(plain, targets, args):
    """The plain version over CPU tensors, its results copied into
    `targets` (None where an output is not kept)."""
    new = plain(*args)
    with torch.no_grad():
        for dst, src in zip(targets, new):
            if dst is not None and dst is not src:
                dst.copy_(src)


def _bad(name, label, ts, ns, dev, fp32_only=False):
    """The error for the first tensor of `ts` that is not a contiguous
    fp32/bf16 (fp32_only: fp32) tensor of its entry's element count on
    device index `dev`."""
    for j, t in enumerate(ts):
        if (t.dtype != torch.float32 if fp32_only else t.dtype not in
                _DTYPES) or t.numel() != ns[j] or t.get_device() != dev \
                or not t.is_contiguous():
            return ValueError(
                "%s: the %s of tensor %d must be a contiguous %s tensor of "
                "%d elements on the weight's device, got %s %s of %d on %s"
                % (name, label, j, "float32" if fp32_only
                   else "float32/bfloat16", ns[j], t.dtype,
                   "contiguous" if t.is_contiguous() else "strided",
                   t.numel(), t.device))
    return ValueError("%s: bad %s" % (name, label))


def _codes(name, label, ts, ns, dev, fp32_only=False):
    """Each tensor's dtype code, after checking every tensor of `ts` (a
    list at a time: C-level maps, ~0.1 ms for a step's ~200 tensors)."""
    codes = list(map(_DTYPES.get, map(_DTYPE_OF, ts)))
    if None in codes or (fp32_only and any(codes)) \
            or list(map(_T.numel, ts)) != ns \
            or set(map(_T.get_device, ts)) != {dev} \
            or not all(map(_T.is_contiguous, ts)):
        raise _bad(name, label, ts, ns, dev, fp32_only)
    return codes


class _Plan:
    """A list's weights, states and masters checked and packed into a
    table of _ENTRY (the non-empty tensors). A step passes the same live
    tensors again, updated in place, so the next call reuses the plan while
    the tensors' ids and data pointers are unchanged and none of them has
    been freed (a weak reference drops the plan then), and checks and packs
    only the gradients, lr and wd."""

    def __init__(self, name, ws, states, masters, mp_on):
        fixed = self.fixed(ws, states, masters, mp_on)
        self.ids = list(map(id, fixed))
        self.ptrs = list(map(_T.data_ptr, fixed))
        self.alive = True
        self.refs = [weakref.ref(t, self._drop) for t in fixed]
        ns = list(map(_T.numel, ws))
        self.keep = None
        if 0 in ns:
            self.keep = [j for j, n in enumerate(ns) if n]
            ws, ns = [ws[j] for j in self.keep], [ns[j] for j in self.keep]
            states = [(lab, [lst[j] for j in self.keep])
                      for lab, lst in states]
            masters = [masters[j] for j in self.keep] if mp_on else masters
        self.ns = ns
        self.table = np.zeros(len(ws), _ENTRY)
        self.g_dtypes = None
        if not ws:
            return
        self.dev = dev = ws[0].get_device()
        self.table["w_dtype"] = _codes(name, "weight", ws, ns, dev)
        self.table["w"] = list(map(_T.data_ptr, ws))
        for i, (label, lst) in enumerate(states):
            codes = _codes(name, label, lst, ns, dev)
            if i and codes != list(self.table["s_dtype"]):
                j = next(j for j, c in enumerate(codes)
                         if c != self.table["s_dtype"][j])
                raise ValueError("%s: mean and var of tensor %d must share "
                                 "one dtype, got %s %s" % (
                                     name, j, states[0][1][j].dtype,
                                     lst[j].dtype))
            self.table["s_dtype"] = codes
            self.table["s%d" % i] = list(map(_T.data_ptr, lst))
        if mp_on:
            _codes(name, "master copy", masters, ns, dev, True)
            self.table["master"] = list(map(_T.data_ptr, masters))
        self.table["n"] = ns

    @staticmethod
    def fixed(ws, states, masters, mp_on):
        return list(itertools.chain(ws, *(lst for _, lst in states),
                                    masters if mp_on else ()))

    def _drop(self, _ref):
        self.alive = False

    def matches(self, ws, states, masters, mp_on):
        fixed = self.fixed(ws, states, masters, mp_on)
        return self.alive and list(map(id, fixed)) == self.ids \
            and list(map(_T.data_ptr, fixed)) == self.ptrs


_plans = {}     # (name, state slots, mp_on) -> the last list's _Plan


def _table(name, ws, gs, states, masters, lrs, wds, mp_on):
    """The _ENTRY table of a list: every tensor checked as `_check` does,
    the empty ones left out. states: [(label, list)] for the state slots.
    The weights, states and masters are checked and packed once while the
    same live tensors come again (`_Plan`); the gradients, lr and wd on
    every call. The table is the plan's own buffer, valid until the next
    call."""
    k = len(ws)
    lists = [("grad", gs), ("lr", lrs), ("wd", wds)] + states \
        + ([("master", masters)] if mp_on else [])
    for label, lst in lists:
        if len(lst) != k:
            raise ValueError("%s: %d weights but %d %ss"
                             % (name, k, len(lst), label))
    key = (name, len(states), mp_on)
    plan = _plans.get(key)
    if plan is None or not plan.matches(ws, states, masters, mp_on):
        plan = _plans[key] = _Plan(name, ws, states, masters, mp_on)
    table = plan.table
    if not len(table):
        return table
    if plan.keep is not None:
        gs, lrs, wds = ([lst[j] for j in plan.keep] for lst in (gs, lrs, wds))
    g_dtypes = list(map(_DTYPE_OF, gs))
    if g_dtypes != plan.g_dtypes:
        table["g_dtype"] = _codes(name, "grad", gs, plan.ns, plan.dev)
        plan.g_dtypes = g_dtypes
    elif list(map(_T.numel, gs)) != plan.ns \
            or set(map(_T.get_device, gs)) != {plan.dev} \
            or not all(map(_T.is_contiguous, gs)):
        raise _bad(name, "grad", gs, plan.ns, plan.dev)
    table["g"] = list(map(_T.data_ptr, gs))
    table["lr"] = lrs
    table["wd"] = wds
    return table


def _launch_table(kernel, symbol, argtypes, table, args, dev, variant,
                  vecs=(None, None)):
    """Kernel #7/#8 over `table`, in launches of at most the kernel's
    capacity, each counted under `variant`."""
    lib, fn = bind(kernel, symbol, argtypes)
    cap = _capacity.get(kernel)
    if cap is None:
        cap = _capacity[kernel] = lib.mx_multi_capacity()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s in range(0, len(table), cap):
            part = table[s:s + cap]
            err = fn(part.ctypes.data, len(part), _ptr(vecs[0]),
                     _ptr(vecs[1]), *args, stream)
            if err:
                raise RuntimeError("%s: launch failed: %s" % (
                    kernel, lib.mx_cuda_error_string(err).decode()))
            count_launch(kernel, variant)


def _device(name, ws):
    """The one device of a list's weights; a list on the CPU must lie there
    whole (its plain version runs there, and nowhere else)."""
    dev = ws[0].device
    if dev.type == "cpu":
        if any(w.device.type != "cpu" for w in ws):
            raise ValueError("%s: a list mixes CPU and other tensors" % name)
    elif dev.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (name, dev))
    return dev


def _flags(momentum_on, clip_on, mp_on, vec=False):
    return (_MOMENTUM * bool(momentum_on) | _CLIP * bool(clip_on)
            | _MP * bool(mp_on) | _VEC * bool(vec))


def multi_sgd(ws, gs, moms, masters, lrs, wds, momentum, rescale, clip,
              momentum_on, clip_on, mp_on):
    """SGD(-momentum) over every tensor of a list, in place, in one launch
    of kernel #7 (several where the list is longer than one launch holds;
    the reference's aggregated `SGD.fused_update`). ws, gs: weights and
    their gradients; moms: momenta (ignored without momentum); masters:
    fp32 masters (mp_on); lrs, wds: one float each. Tensors with no
    elements are skipped."""
    if not ws:
        return
    dev = _device("multi_sgd", ws)
    if dev.type == "cpu":
        for j, w in enumerate(ws):
            mom = moms[j] if momentum_on else None
            master = masters[j] if mp_on else None
            _plain_update(_ref_flat_sgd, (w, mom, master), (
                w, gs[j], mom, master, lrs[j], wds[j], momentum, rescale,
                clip, momentum_on, clip_on, mp_on))
        return
    table = _table("multi_sgd", ws, gs,
                   [("momentum", moms)] if momentum_on else [], masters,
                   lrs, wds, mp_on)
    if len(table):
        _launch_table("flat_sgd", "mx_multi_sgd", _SGD_ARGS, table, [
            float(momentum), float(rescale),
            float(clip) if clip_on else 0.0,
            _flags(momentum_on, clip_on, mp_on)], dev, "multi")


def multi_adam(ws, gs, means, vars, masters, lrs, wds, beta1, omb1, beta2,
               omb2, eps, rescale, clip, clip_on, mp_on):
    """Adam over every tensor of a list, in place, in one launch of kernel
    #8 (the reference's aggregated `Adam.fused_update`): bias correction
    folded into each lr by the caller, omb1 = 1 - beta1 and omb2 = 1 -
    beta2 as the caller computes them. Each tensor's mean and var share one
    dtype. Tensors with no elements are skipped."""
    if not ws:
        return
    dev = _device("multi_adam", ws)
    if dev.type == "cpu":
        for j, w in enumerate(ws):
            master = masters[j] if mp_on else None
            _plain_update(_ref_flat_adam, (w, means[j], vars[j], master), (
                w, gs[j], means[j], vars[j], master, lrs[j], wds[j], beta1,
                omb1, beta2, omb2, eps, rescale, clip, clip_on, mp_on))
        return
    table = _table("multi_adam", ws, gs, [("mean", means), ("var", vars)],
                   masters, lrs, wds, mp_on)
    if len(table):
        _launch_table("flat_adam", "mx_multi_adam", _ADAM_ARGS, table, [
            float(beta1), float(omb1), float(beta2), float(omb2),
            float(eps), float(rescale), float(clip) if clip_on else 0.0,
            _flags(False, clip_on, mp_on)], dev, "multi")


def _one(w, g, s0, s1, master, lr, wd):
    """The one-entry table of a checked tensor (the per-parameter route:
    a new tensor each call, so no `_Plan`)."""
    return np.array([(w.data_ptr(), g.data_ptr(), _ptr(s0) or 0,
                      _ptr(s1) or 0, _ptr(master) or 0, w.numel(), lr, wd,
                      _DTYPES[w.dtype], _DTYPES[g.dtype],
                      0 if s0 is None else _DTYPES[s0.dtype], 0)], _ENTRY)


def _lrwd(name, lr, wd, w):
    """(lr, wd, lr vector, wd vector) of one tensor: scalars, or both
    per-element fp32 vectors (then the scalars are 0)."""
    n = w.numel()
    lr_s, lr_v = _scalar_or_vec(name, "lr", lr, n, w.device)
    wd_s, wd_v = _scalar_or_vec(name, "wd", wd, n, w.device)
    if (lr_v is None) != (wd_v is None):
        raise ValueError("%s: lr and wd must both be scalars or both "
                         "per-element vectors" % name)
    return lr_s, wd_s, lr_v, wd_v


def flat_sgd(w, g, mom, master, lr, wd, momentum, rescale, clip,
             momentum_on, clip_on, mp_on):
    """SGD(-momentum) over every element of w, in place, in one launch of
    kernel #7 (a one-tensor table); returns (w, mom, master). mom has w's
    element count (any of fp32/bf16; ignored without momentum); master is
    fp32 (mp_on); lr and wd are floats or fp32 per-element tensors."""
    dev = _device("flat_sgd", [w])
    if dev.type == "cpu":
        _plain_update(_ref_flat_sgd, (w, mom if momentum_on else None,
                                      master if mp_on else None),
                      (w, g, mom, master, lr, wd, momentum, rescale, clip,
                       momentum_on, clip_on, mp_on))
        return w, mom, master
    if w.numel() == 0:
        return w, mom, master
    _check("flat_sgd", w, g, [("momentum", mom)] if momentum_on else [],
           master, mp_on)
    lr_s, wd_s, lr_v, wd_v = _lrwd("flat_sgd", lr, wd, w)
    table = _one(w, g, mom if momentum_on else None, None,
                 master if mp_on else None, lr_s, wd_s)
    _launch_table("flat_sgd", "mx_multi_sgd", _SGD_ARGS, table, [
        float(momentum), float(rescale), float(clip) if clip_on else 0.0,
        _flags(momentum_on, clip_on, mp_on, lr_v is not None)], dev,
        "single", (lr_v, wd_v))
    return w, mom, master


def flat_adam(w, g, mean, var, master, lr, wd, beta1, omb1, beta2, omb2,
              eps, rescale, clip, clip_on, mp_on):
    """Adam over every element of w, in place, in one launch of kernel #8
    (a one-tensor table; bias correction folded into lr by the caller,
    omb1 = 1 - beta1 and omb2 = 1 - beta2 as the caller computes them);
    returns (w, mean, var, master). mean and var share one dtype (fp32 or
    bf16)."""
    dev = _device("flat_adam", [w])
    if dev.type == "cpu":
        _plain_update(_ref_flat_adam, (w, mean, var,
                                       master if mp_on else None),
                      (w, g, mean, var, master, lr, wd, beta1, omb1, beta2,
                       omb2, eps, rescale, clip, clip_on, mp_on))
        return w, mean, var, master
    if w.numel() == 0:
        return w, mean, var, master
    _check("flat_adam", w, g, [("mean", mean), ("var", var)], master, mp_on)
    if var.dtype != mean.dtype:
        raise ValueError("flat_adam: mean and var must share one dtype, got "
                         "%s %s" % (mean.dtype, var.dtype))
    lr_s, wd_s, lr_v, wd_v = _lrwd("flat_adam", lr, wd, w)
    table = _one(w, g, mean, var, master if mp_on else None, lr_s, wd_s)
    _launch_table("flat_adam", "mx_multi_adam", _ADAM_ARGS, table, [
        float(beta1), float(omb1), float(beta2), float(omb2), float(eps),
        float(rescale), float(clip) if clip_on else 0.0,
        _flags(False, clip_on, mp_on, lr_v is not None)], dev, "single",
        (lr_v, wd_v))
    return w, mean, var, master


def flat_update_fn(kind, momentum_on, clip_on, mp_on):
    """The flat-shard update with the reference's call signature per kind
    (`mxnet_tpu.ops.fused_optimizer.flat_update_fn`):

        sgd:  fn(w, g, mom, master, lr_vec, wd_vec, momentum, rescale, clip)
              -> (w, mom, master)
        adam: fn(w, g, mean, var, master, lr_vec, wd_vec, beta1, omb1,
                 beta2, omb2, eps, rescale, clip) -> (w, mean, var, master)

    The tensors are updated in place and returned."""
    if kind == "sgd":
        def fn(w, g, mom, master, lr_vec, wd_vec, momentum, rescale, clip):
            return flat_sgd(w, g, mom, master, lr_vec, wd_vec, momentum,
                            rescale, clip, momentum_on, clip_on, mp_on)
    elif kind == "adam":
        def fn(w, g, mean, var, master, lr_vec, wd_vec, beta1, omb1, beta2,
               omb2, eps, rescale, clip):
            return flat_adam(w, g, mean, var, master, lr_vec, wd_vec, beta1,
                             omb1, beta2, omb2, eps, rescale, clip, clip_on,
                             mp_on)
    else:
        raise KeyError(kind)
    return fn


# ---------------------------------------------------------------------------
# LAMB: pass 1 (moments + direction + per-key squared norms), the caller's
# norm exchange and trust ratio, pass 2 (apply)
# ---------------------------------------------------------------------------
LAMB_CHUNK = 8192       # elements per block of kernel #9's norm pass


def _ref_flat_lamb1(w, g, mean, var, master, wd, beta1, omb1, beta2, omb2, d1,
                    d2, eps, rescale, clip, clip_on, mp_on, bias_corr,
                    segments=None, n_keys=0):
    """LAMB pass 1 as separate fp32 ops (the reference's `_lamb1_xla_impl`):
    (direction fp32, new mean, new var, norms). norms is (2, n_keys) fp32,
    each key's sum of w32^2 and direction^2 over its (key, start, length)
    segments, or None without segments."""
    w32 = master if mp_on else w.float()
    g32 = g.float() * rescale
    if clip_on:
        g32 = torch.clamp(g32, -clip, clip)
    m = beta1 * mean.float() + omb1 * g32
    v = beta2 * var.float() + omb2 * g32 * g32
    mh, vh = m, v
    if bias_corr:
        # divide by tensors on m's device: CUDA divides by a host scalar as
        # a product with its reciprocal, which rounds differently from the
        # division the reference (and the kernel) does
        d = torch.tensor([d1, d2], dtype=torch.float32, device=m.device)
        mh, vh = m / d[0], v / d[1]
    gdir = mh / (torch.sqrt(vh) + eps) + wd * w32
    norms = None
    if segments is not None:
        norms = torch.zeros(2, n_keys, dtype=torch.float32, device=w.device)
        for k, s, ln in segments:
            ws, gs = w32[s:s + ln], gdir[s:s + ln]
            norms[0, k] += (ws * ws).sum()
            norms[1, k] += (gs * gs).sum()
    return gdir, m.to(mean.dtype), v.to(var.dtype), norms


def _ref_flat_lamb2(w, master, gdir, scale, mp_on):
    """LAMB pass 2 as fp32 ops (the reference's `_apply_xla_impl`): (new w,
    new master)."""
    w32 = master if mp_on else w.float()
    w32n = w32 - scale * gdir
    return w32n.to(w.dtype), (w32n if mp_on else master)


def lamb_chunk_table(segments, n_keys, n, device):
    """Kernel #9's chunk table for n elements with key segments (key,
    start, length): chunk starts (int64) and lengths (int32, at most
    LAMB_CHUNK) grouped by key, then chunks over the elements no segment
    covers (the padding); and each key's first chunk (int32, n_keys + 1
    entries). A caller that runs the same segments every step builds it
    once (`ZeroUpdater` does, per bucket)."""
    spans = sorted((s, s + ln) for _, s, ln in segments)
    for (s0, e0), (s1, _) in zip(spans, spans[1:]):
        if s1 < e0:
            raise ValueError("flat_lamb1: overlapping segments at %d" % s1)
    if spans and (spans[0][0] < 0 or spans[-1][1] > n):
        raise ValueError("flat_lamb1: segments outside [0, %d)" % n)
    starts, lens, first = [], [], []

    def cut(s, e):
        for a in range(s, e, LAMB_CHUNK):
            starts.append(a)
            lens.append(min(LAMB_CHUNK, e - a))

    by_key = sorted(segments, key=lambda seg: (seg[0], seg[1]))
    it = iter(by_key)
    seg = next(it, None)
    for k in range(n_keys):
        first.append(len(starts))
        while seg is not None and seg[0] == k:
            cut(seg[1], seg[1] + seg[2])
            seg = next(it, None)
    if seg is not None:
        raise ValueError("flat_lamb1: segment of key %d >= n_keys %d"
                         % (seg[0], n_keys))
    first.append(len(starts))
    pos = 0
    for s, e in spans + [(n, n)]:
        cut(pos, s)
        pos = max(pos, e)
    return (torch.tensor(starts, dtype=torch.int64, device=device),
            torch.tensor(lens, dtype=torch.int32, device=device),
            torch.tensor(first, dtype=torch.int32, device=device))


def flat_lamb1(w, g, mean, var, master, wd, beta1, omb1, beta2, omb2, d1, d2,
               eps, rescale, clip, clip_on, mp_on, bias_corr, segments=None,
               n_keys=0, table=None):
    """LAMB pass 1 over every element of w (kernel #9): mean and var are
    updated in place; returns (direction fp32, mean, var, norms). wd is a
    float or an fp32 per-element tensor; omb = 1 - beta and d = 1 - beta^t
    computed by the caller in double. With `segments` ((key, start,
    length) in w, keys < n_keys) norms is (2, n_keys) fp32: each key's
    ||w32||^2 and ||direction||^2; else None. `table` is the segments'
    `lamb_chunk_table` on w's device, built here when not given."""
    if w.device.type == "cpu":
        gdir, m, v, norms = _ref_flat_lamb1(
            w, g, mean, var, master, wd, beta1, omb1, beta2, omb2, d1, d2,
            eps, rescale, clip, clip_on, mp_on, bias_corr, segments, n_keys)
        with torch.no_grad():
            mean.copy_(m)
            var.copy_(v)
        return gdir, mean, var, norms
    if w.device.type != "cuda":
        raise ValueError("flat_lamb1: no kernel for device %s" % w.device)
    _check("flat_lamb1", w, g, [("mean", mean), ("var", var)], master, mp_on,
           _LAMB_DTYPES)
    if var.dtype != mean.dtype:
        raise ValueError("flat_lamb1: mean and var must share one dtype, got "
                         "%s %s" % (mean.dtype, var.dtype))
    n = w.numel()
    dev = w.device
    gdir = torch.empty(n, dtype=torch.float32, device=dev)
    norms = None if segments is None else torch.zeros(
        2, n_keys, dtype=torch.float32, device=dev)
    if n == 0:
        return gdir, mean, var, norms
    wd_s, wd_v = _scalar_or_vec("flat_lamb1", "wd", wd, n, dev)
    starts = lens = first = partial = None
    n_chunks = 0
    if segments is not None:
        starts, lens, first = table if table is not None else \
            lamb_chunk_table(segments, n_keys, n, dev)
        n_chunks = starts.numel()
        partial = torch.empty(2, n_chunks, dtype=torch.float32, device=dev)
    flags = (_LAMB_CLIP * bool(clip_on) | _LAMB_MP * bool(mp_on)
             | _LAMB_BIAS * bool(bias_corr) | _LAMB_VEC * (wd_v is not None))
    # w, g, mean, var, master, gdir, wd_vec, n, chunk_start, chunk_len,
    # n_chunks, key_first, n_keys, partial, norms, beta1, omb1, beta2,
    # omb2, d1, d2, eps, rescale, clip, wd, w_dtype, g_dtype, state_dtype,
    # flags, stream
    _launch("flat_lamb1", "mx_flat_lamb1",
            [_P] * 7 + [ctypes.c_longlong, _P, _P, _I, _P, _I, _P, _P]
            + [_F] * 10 + [_I] * 4 + [_P],
            [w.data_ptr(), g.data_ptr(), mean.data_ptr(), var.data_ptr(),
             _ptr(master) if mp_on else None, gdir.data_ptr(), _ptr(wd_v),
             n, _ptr(starts), _ptr(lens), n_chunks, _ptr(first),
             n_keys if segments is not None else 0, _ptr(partial),
             _ptr(norms), float(beta1), float(omb1), float(beta2),
             float(omb2), float(d1), float(d2), float(eps), float(rescale),
             float(clip) if clip_on else 0.0, wd_s,
             _LAMB_DTYPES[w.dtype], _LAMB_DTYPES[g.dtype],
             _LAMB_DTYPES[mean.dtype], flags], dev)
    return gdir, mean, var, norms


def flat_lamb2(w, master, gdir, scale, mp_on):
    """LAMB pass 2 over every element of w (kernel #10), in place: w (and
    the fp32 master, mp_on) become w32 - scale * gdir; returns (w, master).
    scale is a float, a 0-d fp32 tensor on w's device (read there, no host
    round trip) or an fp32 per-element tensor."""
    if w.device.type == "cpu":
        new_w, new_master = _ref_flat_lamb2(w, master, gdir, scale, mp_on)
        with torch.no_grad():
            w.copy_(new_w)
            if mp_on and master is not new_master:
                master.copy_(new_master)
        return w, master
    if w.device.type != "cuda":
        raise ValueError("flat_lamb2: no kernel for device %s" % w.device)
    _check("flat_lamb2", w, gdir, [], master, mp_on, _LAMB_DTYPES)
    if gdir.dtype != torch.float32:
        raise ValueError("flat_lamb2: the direction must be float32, got %s"
                         % gdir.dtype)
    n = w.numel()
    if n == 0:
        return w, master
    scale_p, stride, scale_s = None, 0, 0.0
    if torch.is_tensor(scale):
        if scale.dim() == 0:
            if scale.dtype != torch.float32 or scale.device != w.device:
                raise ValueError("flat_lamb2: a 0-d scale must be float32 "
                                 "on %s" % w.device)
            scale_p = scale
        else:
            _, scale_p = _scalar_or_vec("flat_lamb2", "scale", scale, n,
                                        w.device)
            stride = 1
    else:
        scale_s = float(scale)
    # w, master, gdir, scale_ptr, scale_stride, n, scale, w_dtype, flags,
    # stream
    _launch("flat_lamb2", "mx_flat_lamb2",
            [_P] * 4 + [ctypes.c_longlong] * 2 + [_F, _I, _I, _P],
            [w.data_ptr(), _ptr(master) if mp_on else None, gdir.data_ptr(),
             _ptr(scale_p), stride, n, scale_s, _LAMB_DTYPES[w.dtype],
             _LAMB_MP * bool(mp_on)], w.device)
    return w, master


def lamb_flat_phase1_fn(clip_on, mp_on, bias_corr, segments, n_keys):
    """LAMB pass 1 over a flat shard with the reference's call signature
    (`mxnet_tpu.ops.fused_optimizer.lamb_flat_phase1_fn`):

        fn(w, g, mean, var, master, wd_vec, seg_ids, beta1, omb1, beta2,
           omb2, d1, d2, eps, rescale, clip) -> (gdir, mean, var, norms)

    `segments` is the (key_index, start, length) tuple of the shard; the
    kernel takes its chunk table from them, so seg_ids is not read."""
    segments = tuple(tuple(s) for s in segments)
    tables = {}     # (n, device) -> this function's chunk table

    def fn(w, g, mean, var, master, wd_vec, seg_ids, beta1, omb1, beta2,
           omb2, d1, d2, eps, rescale, clip):
        table = None
        if w.device.type == "cuda":
            key = (w.numel(), w.device)
            if key not in tables:
                tables[key] = lamb_chunk_table(segments, n_keys, *key)
            table = tables[key]
        return flat_lamb1(w, g, mean, var, master, wd_vec, beta1, omb1,
                          beta2, omb2, d1, d2, eps, rescale, clip, clip_on,
                          mp_on, bias_corr, segments, n_keys, table)
    return fn


def lamb_flat_apply_fn(mp_on):
    """LAMB pass 2 with the reference's call signature: fn(w, master, gdir,
    scale) -> (w, master); `scale` carries lr x trust ratio (per element
    on the flat path, a scalar on the per-parameter path)."""
    def fn(w, master, gdir, scale):
        return flat_lamb2(w, master, gdir, scale, mp_on)
    return fn
