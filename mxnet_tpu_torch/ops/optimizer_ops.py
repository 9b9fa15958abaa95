"""Per-parameter optimizer update ops (the port of
`mxnet_tpu.ops.optimizer_ops`): `sgd_update`, `sgd_mom_update`,
`mp_sgd_update`, `mp_sgd_mom_update`, `adam_update`, `lamb_update_phase1`,
`lamb_update_phase2`, and the rest of the reference's family:
`nag_mom_update`, `mp_nag_mom_update`, `rmsprop_update`,
`rmspropalex_update`, `ftrl_update`, `signsgd_update`, `signum_update`,
`ftml_update`, `adagrad_update`, `adadelta_update`, `adamax_update`,
`nadam_update` and `adamw_update` (aliases `_adamw_update`,
`_contrib_adamw_update`; `_adam_update` for `adam_update`).

Each op takes (weight, grad, *states) and keyword scalars, and returns
(weight, *states) updated, with the reference's rules: rescale, clip,
weight decay and momentum in the reference's order, and each
hyperparameter expression as the reference writes it. The arithmetic runs
in fp32 and every output is rounded once to its dtype, as the reference's
`_fused_fn`/`_fused_flat_xla` do. (The reference's per-parameter ops
compute a bf16 weight in bf16 arithmetic; see ROADMAP Queue C.) Scalars
may be Python numbers or 0-d fp32 tensors on the CPU (the fused step's
per-step scalars), which torch reads as host scalars on any device.

The SGD, Adam and LAMB plain versions are the flat updates' plain versions
(`fused_optimizer._ref_flat_*`), and their `cuda_impl` launches kernel #7,
#8, #9 or #10 of ``csrc/`` once, updating the tensors in place, for fp32
and bf16 alike. The reference computes the other ops in plain XLA, with no
kernel, so they have no `cuda_impl`: their torch version runs on both
devices.
"""
from __future__ import annotations

import torch

from . import fused_optimizer as _fo
from .registry import alias, get, register

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


def _prep(grad, rescale_grad, clip_gradient):
    """The gradient in fp32, rescaled and clipped where clip >= 0."""
    g = grad.float() * rescale_grad
    if _clip_on(clip_gradient):
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _like(*pairs):
    """Each (fp32 result, tensor) pair's result rounded once to the
    tensor's dtype."""
    return tuple(new.to(ref.dtype) for new, ref in pairs)


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w


@register("nag_mom_update", arity=3, differentiable=False, num_outputs=2)
def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov momentum: g += wd * w; mom = momentum * mom + g;
    w -= lr * (g + momentum * mom)."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_gradient) + wd * w
    m = momentum * mom.float() + g
    return _like((w - lr * (g + momentum * m), weight), (m, mom))


@register("mp_nag_mom_update", arity=4, differentiable=False, num_outputs=3)
def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    """nag_mom_update on the fp32 master weight32; the weight is its
    rounding."""
    w32 = weight32.float()
    g = _prep(grad, rescale_grad, clip_gradient) + wd * w32
    m = momentum * mom.float() + g
    w32 = w32 - lr * (g + momentum * m)
    return _like((w32, weight), (m, mom), (w32, weight32))


@register("rmsprop_update", arity=3, differentiable=False, num_outputs=2)
def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    """Non-centered RMSProp."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_gradient) + wd * w
    n32 = (1.0 - gamma1) * g * g + gamma1 * n.float()
    w = _clip_weights(w - lr * g / torch.sqrt(n32 + epsilon), clip_weights)
    return _like((w, weight), (n32, n))


@register("rmspropalex_update", arity=5, differentiable=False, num_outputs=4)
def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves 2013)."""
    w = weight.float()
    gr = _prep(grad, rescale_grad, clip_gradient) + wd * w
    n32 = (1.0 - gamma1) * gr * gr + gamma1 * n.float()
    g32 = (1.0 - gamma1) * gr + gamma1 * g.float()
    d32 = gamma2 * delta.float() - lr * gr / torch.sqrt(n32 - g32 * g32
                                                        + epsilon)
    w = _clip_weights(w + d32, clip_weights)
    return _like((w, weight), (n32, n), (g32, g), (d32, delta))


@register("ftrl_update", arity=4, differentiable=False, num_outputs=3)
def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_gradient)
    n32 = n.float()
    new_n = n32 + g * g
    z32 = z.float() + g - (torch.sqrt(new_n) - torch.sqrt(n32)) / lr * w
    w = torch.where(
        torch.abs(z32) > lamda1,
        -(z32 - torch.sign(z32) * lamda1) / ((beta + torch.sqrt(new_n)) / lr
                                             + wd),
        torch.zeros_like(w))
    return _like((w, weight), (z32, z), (new_n, n))


@register("signsgd_update", arity=2, differentiable=False)
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """w -= lr * (sign(g) + wd * w)."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_gradient)
    return (w - lr * (torch.sign(g) + wd * w)).to(weight.dtype)


@register("signum_update", arity=3, differentiable=False, num_outputs=2)
def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """The sign of the momentum as the step."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_gradient)
    m = momentum * mom.float() - (1 - momentum) * g
    w = (1 - lr * wd_lh) * w + lr * torch.sign(m) - lr * wd * w
    return _like((w, weight), (m, mom))


@register("ftml_update", arity=5, differentiable=False, num_outputs=4)
def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1):
    """FTML (Zheng & Kwok 2017)."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_grad) + wd * w
    v32 = beta2 * v.float() + (1 - beta2) * g * g
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(v32 / (1 - beta2 ** t))
                                   + epsilon)
    sigma = d_t - beta1 * d.float()
    z32 = beta1 * z.float() + (1 - beta1) * g - sigma * w
    return _like((-z32 / d_t, weight), (d_t, d), (v32, v), (z32, z))


@register("adagrad_update", arity=3, differentiable=False, num_outputs=2)
def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad (the reference's dense path)."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_gradient)
    h = history.float() + g * g
    return _like((w - lr * (g / torch.sqrt(h + epsilon) + wd * w), weight),
                 (h, history))


@register("adadelta_update", arity=4, differentiable=False, num_outputs=3)
def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdaDelta (the reference's Python optimizer's rule; no lr)."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_gradient)
    ag = rho * acc_g.float() + (1 - rho) * g * g
    ad = acc_delta.float()
    delta = torch.sqrt(ad + epsilon) / torch.sqrt(ag + epsilon) * g
    ad = rho * ad + (1 - rho) * delta * delta
    return _like((w - (delta + wd * w), weight), (ag, acc_g),
                 (ad, acc_delta))


@register("adamax_update", arity=4, differentiable=False, num_outputs=3)
def adamax_update(weight, grad, mean, u, lr, beta1=0.9, beta2=0.999, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0):
    """Adamax; the first moment's bias correction is folded into lr by the
    Optimizer."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_gradient) + wd * w
    m = beta1 * mean.float() + (1 - beta1) * g
    u32 = torch.maximum(beta2 * u.float(), torch.abs(g))
    return _like((w - lr * m / u32, weight), (m, mean), (u32, u))


@register("nadam_update", arity=4, differentiable=False, num_outputs=3)
def nadam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0, t=1, m_schedule=1.0):
    """Nadam; the caller keeps the m_schedule product."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_gradient) + wd * w
    momentum_t = beta1 * (1.0 - 0.5 * 0.96 ** (t * schedule_decay))
    momentum_t_1 = beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * schedule_decay))
    m_schedule_new = m_schedule * momentum_t
    m_schedule_next = m_schedule_new * momentum_t_1
    grad_prime = g / (1.0 - m_schedule_new)
    m = beta1 * mean.float() + (1.0 - beta1) * g
    v = beta2 * var.float() + (1.0 - beta2) * g * g
    mean_prime = m / (1.0 - m_schedule_next)
    var_prime = v / (1.0 - beta2 ** t)
    mean_bar = (1.0 - momentum_t) * grad_prime + momentum_t_1 * mean_prime
    w = w - lr * mean_bar / (torch.sqrt(var_prime) + epsilon)
    return _like((w, weight), (m, mean), (v, var))


@register("adamw_update", arity=4, differentiable=False, num_outputs=3)
def adamw_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """Adam with decoupled weight decay: w -= eta * (lr * m / (sqrt(v) +
    eps) + wd * w); the bias correction is folded into lr by the
    Optimizer."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_gradient)
    m = beta1 * mean.float() + (1.0 - beta1) * g
    v = beta2 * var.float() + (1.0 - beta2) * g * g
    w = w - eta * (lr * m / (torch.sqrt(v) + epsilon) + wd * w)
    return _like((w, weight), (m, mean), (v, var))


alias("adamw_update", "_adamw_update", "_contrib_adamw_update")
alias("adam_update", "_adam_update")


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
