"""Per-parameter optimizer update ops (the port of the SGD/Adam/LAMB part
of `mxnet_tpu.ops.optimizer_ops`): `sgd_update`, `sgd_mom_update`,
`mp_sgd_update`, `mp_sgd_mom_update`, `adam_update`, `lamb_update_phase1`
and `lamb_update_phase2`.

Each op takes (weight, grad, *states) and keyword scalars, and returns
(weight, *states) updated, with the reference's rules: rescale, clip,
weight decay and momentum in the reference's order. Each plain version is
the flat update's plain version (`fused_optimizer._ref_flat_*`): the
arithmetic runs in fp32 and every output is rounded once to its dtype, as
the reference's `_fused_fn`/`_fused_flat_xla` do. (The reference's
per-parameter ops compute a bf16 weight in bf16 arithmetic; see ROADMAP
Queue C.) The `cuda_impl` of each launches kernel #7 or #8 of
``csrc/fused_optimizer.cu`` once, updating the tensors in place, for fp32
and bf16 alike.
"""
from __future__ import annotations

import torch

from . import fused_optimizer as _fo
from .registry import get, register

__all__ = []


def _clip_on(clip_gradient):
    return clip_gradient is not None and clip_gradient >= 0


def _sgd(kernel, weight, grad, mom, master, lr, momentum, wd, rescale_grad,
         clip_gradient):
    clip_on = _clip_on(clip_gradient)
    return kernel(weight, grad, mom, master, lr, wd, momentum, rescale_grad,
                  clip_gradient if clip_on else 0.0, mom is not None,
                  clip_on, master is not None)


def _adam(kernel, weight, grad, mean, var, lr, beta1, beta2, epsilon, wd,
          rescale_grad, clip_gradient):
    clip_on = _clip_on(clip_gradient)
    # 1 - beta in Python double, as the reference's eager op computes it
    return kernel(weight, grad, mean, var, None, lr, wd, beta1, 1.0 - beta1,
                  beta2, 1.0 - beta2, epsilon, rescale_grad,
                  clip_gradient if clip_on else 0.0, clip_on, False)


def _lamb1(kernel, weight, grad, mean, var, beta1, beta2, epsilon, t,
           bias_correction, wd, rescale_grad, clip_gradient):
    clip_on = _clip_on(clip_gradient)
    # 1 - beta and the bias-correction complements in Python double, as
    # the reference's eager op computes them
    gdir, m, v, _ = kernel(weight.reshape(-1), grad.reshape(-1),
                           mean.reshape(-1), var.reshape(-1), None, wd, beta1,
                           1.0 - beta1, beta2, 1.0 - beta2, 1.0 - beta1 ** t,
                           1.0 - beta2 ** t, epsilon, rescale_grad,
                           clip_gradient if clip_on else 0.0, clip_on, False,
                           bool(bias_correction))
    return gdir.reshape(weight.shape), m.reshape(mean.shape), \
        v.reshape(var.shape)


def _lamb_scale(r1, r2, lr, lower_bound, upper_bound):
    """lr x trust ratio, a 0-d fp32 tensor: r1 clipped into the bounds,
    and the ratio r1 / r2 only where both are positive, else 1."""
    r1 = torch.as_tensor(r1, dtype=torch.float32)
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=r1.device)
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    return lr * ratio


def _lamb2(kernel, weight, g, r1, r2, lr, lower_bound, upper_bound):
    scale = _lamb_scale(r1, r2, lr, lower_bound, upper_bound).to(
        weight.device)
    w, _ = kernel(weight.reshape(-1), None, g.reshape(-1), scale, False)
    return w.reshape(weight.shape)


@register("sgd_update", arity=2, differentiable=False)
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """w - lr * (clip(grad * rescale) + wd * w)."""
    return _sgd(_fo._ref_flat_sgd, weight, grad, None, None, lr, 0.0, wd,
                rescale_grad, clip_gradient)[0]


@register("sgd_mom_update", arity=3, differentiable=False, num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum * mom - lr * (clip(grad * rescale) + wd * w);
    w += mom."""
    w, m, _ = _sgd(_fo._ref_flat_sgd, weight, grad, mom, None, lr, momentum,
                   wd, rescale_grad, clip_gradient)
    return w, m


@register("mp_sgd_update", arity=3, differentiable=False, num_outputs=2)
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """sgd_update on the fp32 master weight32; the weight is its
    rounding."""
    w, _, w32 = _sgd(_fo._ref_flat_sgd, weight, grad, None, weight32, lr, 0.0,
                     wd, rescale_grad, clip_gradient)
    return w, w32


@register("mp_sgd_mom_update", arity=4, differentiable=False, num_outputs=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    return _sgd(_fo._ref_flat_sgd, weight, grad, mom, weight32, lr, momentum,
                wd, rescale_grad, clip_gradient)


@register("adam_update", arity=4, differentiable=False, num_outputs=3)
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """Adam; the bias correction is folded into lr by the Optimizer."""
    w, m, v, _ = _adam(_fo._ref_flat_adam, weight, grad, mean, var, lr,
                       beta1, beta2, epsilon, wd, rescale_grad,
                       clip_gradient)
    return w, m, v


@register("lamb_update_phase1", arity=4, differentiable=False, num_outputs=3)
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's raw direction mh / (sqrt(vh) + eps) + wd * w and the new
    moments: (direction fp32, mean, var)."""
    return _lamb1(_fo._ref_flat_lamb1, weight, grad, mean, var, beta1, beta2,
                  epsilon, t, bias_correction, wd, rescale_grad,
                  clip_gradient)


@register("lamb_update_phase2", arity=4, differentiable=False)
def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """w - lr * ratio * g with the trust ratio of the norms r1 (weight,
    clipped into the bounds) and r2 (direction)."""
    return _lamb2(_fo._ref_flat_lamb2, weight, g, r1, r2, lr, lower_bound,
                  upper_bound)


# --- on a GPU context: one launch of the hand-written kernel, in place -----
@get("sgd_update").cuda_impl
def _sgd_update_cuda(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                     clip_gradient=-1.0, lazy_update=True):
    return _sgd(_fo.flat_sgd, weight, grad, None, None, lr, 0.0, wd,
                rescale_grad, clip_gradient)[0]


@get("sgd_mom_update").cuda_impl
def _sgd_mom_update_cuda(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         lazy_update=True):
    w, m, _ = _sgd(_fo.flat_sgd, weight, grad, mom, None, lr, momentum, wd,
                   rescale_grad, clip_gradient)
    return w, m


@get("mp_sgd_update").cuda_impl
def _mp_sgd_update_cuda(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, lazy_update=True):
    w, _, w32 = _sgd(_fo.flat_sgd, weight, grad, None, weight32, lr, 0.0, wd,
                     rescale_grad, clip_gradient)
    return w, w32


@get("mp_sgd_mom_update").cuda_impl
def _mp_sgd_mom_update_cuda(weight, grad, mom, weight32, lr, momentum=0.0,
                            wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                            lazy_update=True):
    return _sgd(_fo.flat_sgd, weight, grad, mom, weight32, lr, momentum, wd,
                rescale_grad, clip_gradient)


@get("adam_update").cuda_impl
def _adam_update_cuda(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                      epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                      clip_gradient=-1.0, lazy_update=True):
    w, m, v, _ = _adam(_fo.flat_adam, weight, grad, mean, var, lr, beta1,
                       beta2, epsilon, wd, rescale_grad, clip_gradient)
    return w, m, v


@get("lamb_update_phase1").cuda_impl
def _lamb_update_phase1_cuda(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                             epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                             rescale_grad=1.0, clip_gradient=-1.0):
    return _lamb1(_fo.flat_lamb1, weight, grad, mean, var, beta1, beta2,
                  epsilon, t, bias_correction, wd, rescale_grad,
                  clip_gradient)


@get("lamb_update_phase2").cuda_impl
def _lamb_update_phase2_cuda(weight, g, r1, r2, lr, lower_bound=-1.0,
                             upper_bound=-1.0):
    return _lamb2(_fo.flat_lamb2, weight, g, r1, r2, lr, lower_bound,
                  upper_bound)
