"""Automatic mixed precision (the port of `mxnet_tpu.contrib.amp.amp`;
reference: python/mxnet/contrib/amp/amp.py).

The reference rewrites the NNVM graph with `amp_cast`/`amp_multicast`
nodes; the JAX package and the port install a cast policy at the one
imperative dispatch point (`ndarray.ndarray.invoke`). The ops of
`lists.TARGET_DTYPE_OPS` (convolution and matmul class) get their
floating inputs cast to the target type (bf16 or fp16, the tensor cores'
types), the ops of `lists.FP32_OPS` are pinned to float32, and those of
`lists.WIDEST_TYPE_CASTS` run in the widest floating type of their
inputs. The casts run inside the op's call under torch autograd, so the
gradient of a float32 parameter flows back through its cast and arrives
in float32.

The whole-graph executor calls the ops' functions directly, past the
dispatch point, so while AMP is on `Executor` stays op by op
(``compiler.fallback.amp_active``).

Loss scaling: `init_trainer` gives float16 the dynamic `LossScaler`
(2^16, halved on an overflow, which skips that update; doubled after
2000 clean steps); bf16 shares float32's exponent range, so its scaler
stays at 1.
"""
from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from . import lists
from ...ndarray import ndarray as _nd_mod

__all__ = ["init", "init_trainer", "scale_loss", "unscale", "convert_model",
           "LossScaler", "list_lp16_ops", "list_fp32_ops"]

_initialized = False
_target_dtype = None
_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def list_lp16_ops(target_dtype=None):
    return list(lists.TARGET_DTYPE_OPS)


def list_fp32_ops(target_dtype=None):
    return list(lists.FP32_OPS)


def _is_float(raw):
    """A floating tensor (Python scalars pass through untouched)."""
    return torch.is_tensor(raw) and raw.is_floating_point()


def _make_policy(target_dtype):
    target = _TORCH[target_dtype]
    target_ops = set(lists.TARGET_DTYPE_OPS)
    fp32_ops = set(lists.FP32_OPS)
    widest_ops = set(lists.WIDEST_TYPE_CASTS)
    cache = {}

    def wrap(fn, op_name):
        key = (op_name, fn)
        hit = cache.get(key)
        if hit is None:
            hit = cache[key] = _wrap_uncached(fn, op_name)
        return hit

    def _wrap_uncached(fn, op_name):
        if op_name in target_ops:
            def cast_fn(*args, **kw):
                args = [a.to(target) if _is_float(a) else a for a in args]
                return fn(*args, **kw)
            return cast_fn
        if op_name in fp32_ops:
            def cast_fn(*args, **kw):
                args = [a.to(torch.float32) if _is_float(a) and
                        a.dtype != torch.float64 else a for a in args]
                return fn(*args, **kw)
            return cast_fn
        if op_name in widest_ops:
            def cast_fn(*args, **kw):
                fl = [a.dtype for a in args if _is_float(a)]
                if len(fl) > 1:
                    widest = fl[0]
                    for dt in fl[1:]:
                        widest = torch.promote_types(widest, dt)
                    args = [a.to(widest) if _is_float(a) else a
                            for a in args]
                return fn(*args, **kw)
            return cast_fn
        return fn

    return wrap


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn AMP on for the process (reference: amp.py (init)): 'bfloat16'
    (the default) or 'float16', the reference's default, with the dynamic
    loss scaler. A second call warns and changes nothing."""
    global _initialized, _target_dtype
    if target_dtype in (np.float16, torch.float16, "float16", "fp16"):
        target_dtype = "float16"
    elif target_dtype in (torch.bfloat16, "bfloat16", "bf16"):
        target_dtype = "bfloat16"
    else:
        raise ValueError(
            "unsupported AMP target_dtype %r: expected 'bfloat16' or "
            "'float16'" % (target_dtype,))
    if _initialized:
        warnings.warn("amp.init() is already called, ignoring.")
        return
    if target_precision_ops:
        lists.TARGET_DTYPE_OPS.extend(target_precision_ops)
    if fp32_ops:
        lists.FP32_OPS.extend(fp32_ops)
    _initialized = True
    _target_dtype = target_dtype
    _nd_mod._AMP_WRAP = _make_policy(target_dtype)


class LossScaler:
    """Dynamic loss scaler (reference: amp/loss_scaler.py): doubled after
    `scale_window` clean steps, halved on an overflow, whose update is
    skipped."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any gradient holds a non-finite value: one finite
        reduction over every gradient on its device and one host read
        (``amp.syncs_saved`` counts the reads a gradient-by-gradient check
        would have added). An overflow is noted to the integrity sentinel
        (``integrity.amp_overflow``)."""
        from ... import telemetry as _telem
        from ...resilience import integrity as _integrity
        raws = [g._data for p in params if p.grad_req != "null"
                for g in p.list_grad()]
        if not raws:
            return False
        overflow = not bool(_integrity.finite_scalar(raws))
        if len(raws) > 1:
            _telem.inc("amp.syncs_saved", len(raws) - 1)
        if overflow:
            _integrity.note_amp_overflow()
        return overflow

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0


def _divide_grads(params, scale):
    """Every gradient divided by `scale` in place (one rounding, as the
    reference's ``g / scale``)."""
    with torch.no_grad():
        for p in params:
            if p.grad_req == "null":
                continue
            for g in p.list_grad():
                g._data.div_(torch.as_tensor(scale, dtype=g._data.dtype,
                                             device=g._data.device))


def init_trainer(trainer):
    """Give a Gluon `Trainer` a loss scaler and the overflow skip: its
    update first divides the gradients by the loss scale (unless
    `unscale` did), then, under float16, skips the update when a gradient
    overflowed. reference: amp.py (init_trainer)."""
    if getattr(trainer, "_amp_loss_scaler", None) is not None:
        return
    scaler = LossScaler() if _target_dtype == "float16" else \
        LossScaler(init_scale=1.0, scale_factor=1.0)
    trainer._amp_loss_scaler = scaler
    trainer._amp_unscaled = False
    orig_update = trainer._update

    def patched_update(ignore_stale_grad=False):
        scale = scaler.loss_scale
        if scale != 1.0 and not trainer._amp_unscaled:
            _divide_grads(trainer._params, scale)
        trainer._amp_unscaled = False
        overflow = scaler.has_overflow(trainer._params) \
            if _target_dtype == "float16" else False
        scaler.update_scale(overflow)
        if overflow:
            from ...resilience import integrity as _integrity
            _integrity.note_amp_skip()
            return
        orig_update(ignore_stale_grad)

    trainer._update = patched_update


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """reference: amp.py (scale_loss)::

        with amp.scale_loss(loss, trainer) as scaled:
            autograd.backward(scaled)
    """
    if getattr(trainer, "_amp_loss_scaler", None) is None:
        init_trainer(trainer)
    scale = trainer._amp_loss_scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield [l * scale for l in loss]
    else:
        yield loss * scale


def unscale(trainer):
    """Divide the gradients by the current loss scale (to clip them before
    the step); the next `trainer.step()` does not divide again, and the
    scale is unchanged. reference: amp.py (unscale)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        return
    _divide_grads(trainer._params, scaler.loss_scale)
    trainer._amp_unscaled = True


def convert_model(net, target_dtype="bfloat16"):
    """Cast a Gluon block's floating parameters to the target type in
    place (the inference counterpart of the reference's graph conversion
    of a symbol and its parameters); a parameter not yet initialized
    takes the type when it is. Returns `net`."""
    target = _TORCH[target_dtype]
    for p in net.collect_params().values():
        if p._data is None:
            p.dtype = target_dtype
            continue
        for arr in p._data.values():
            old = arr._data
            if _is_float(old):
                arr._data = old.detach().to(target).requires_grad_(
                    old.requires_grad)
    return net
