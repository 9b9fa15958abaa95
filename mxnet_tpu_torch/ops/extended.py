"""The multi-tensor optimizer ops of `mxnet_tpu.ops.extended` (its
"multi-tensor fused optimizer updates" section): `multi_sgd_update`,
`multi_sgd_mom_update`, `multi_mp_sgd_update`, `multi_mp_sgd_mom_update`
(alias `preloaded_multi_mp_sgd_mom_update`), `multi_all_finite`,
`multi_lars`, `mp_lamb_update_phase1` and `mp_lamb_update_phase2`. The
rest of the reference's `extended.py` (linear algebra, shape and other
ops) comes with a later slice of the port.

The four SGD ops take the reference's interleaved argument list (weight,
grad[, mom][, weight32] for each tensor) and return the updated tensors in
the same order (weight[, mom][, weight32] for each). Their plain versions
loop over the per-parameter rule (`fused_optimizer._ref_flat_sgd`: fp32,
one rounding per output); their `cuda_impl` makes ONE call to
`fused_optimizer.multi_sgd` over the whole list, which launches kernel #7
once (variant "multi") and updates the tensors in place.

The `mp_lamb` phases update with an fp32 master, through kernels #9 and
#10 on a card (one launch each, in place, as `lamb_update_phase1/2` do)
and their plain versions elsewhere. `multi_all_finite` and `multi_lars`
are plain torch on both devices, as they are plain XLA in the reference.
"""
from __future__ import annotations

import torch

from . import fused_optimizer as _fo
from .optimizer_ops import _clip_on
from .registry import alias, get, register

__all__ = []


def _groups(args, n_per):
    k = len(args) // n_per
    return [args[i * n_per:(i + 1) * n_per] for i in range(k)]


def _scalar_list(v, k):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * k


def _multi_plain(args, n_per, momentum_on, mp_on, lrs, wds, momentum,
                 rescale_grad, clip_gradient):
    """The per-tensor rule over each group of the interleaved list."""
    groups = _groups(args, n_per)
    lrs, wds = _scalar_list(lrs, len(groups)), _scalar_list(wds, len(groups))
    clip_on = _clip_on(clip_gradient)
    outs = []
    for grp, lr, wd in zip(groups, lrs, wds):
        w, g = grp[0], grp[1]
        mom = grp[2] if momentum_on else None
        master = grp[-1] if mp_on else None
        new_w, new_m, new_master = _fo._ref_flat_sgd(
            w, g, mom, master, lr, wd, momentum, rescale_grad,
            clip_gradient if clip_on else 0.0, momentum_on, clip_on, mp_on)
        outs += [new_w] + ([new_m] if momentum_on else []) \
            + ([new_master] if mp_on else [])
    return tuple(outs)


def _multi_kernel(args, n_per, momentum_on, mp_on, lrs, wds, momentum,
                  rescale_grad, clip_gradient):
    """One `multi_sgd` call over the whole list (kernel #7, in place)."""
    groups = _groups(args, n_per)
    lrs, wds = _scalar_list(lrs, len(groups)), _scalar_list(wds, len(groups))
    clip_on = _clip_on(clip_gradient)
    ws = [grp[0] for grp in groups]
    moms = [grp[2] for grp in groups] if momentum_on else []
    masters = [grp[-1] for grp in groups] if mp_on else None
    _fo.multi_sgd(ws, [grp[1] for grp in groups], moms, masters,
                  [float(v) for v in lrs], [float(v) for v in wds], momentum,
                  rescale_grad, clip_gradient if clip_on else 0.0,
                  momentum_on, clip_on, mp_on)
    return tuple(t for grp in groups for j, t in enumerate(grp) if j != 1)


# name: (tensors a group, momentum state, fp32 master)
_MULTI_SGD = {
    "multi_sgd_update": (2, False, False),
    "multi_sgd_mom_update": (3, True, False),
    "multi_mp_sgd_update": (3, False, True),
    "multi_mp_sgd_mom_update": (4, True, True),
}


def _register_multi_sgd(name, n_per, momentum_on, mp_on):
    def plain(*args, lrs=None, wds=None, momentum=0.0, rescale_grad=1.0,
              clip_gradient=-1.0, num_weights=None):
        return _multi_plain(args, n_per, momentum_on, mp_on, lrs, wds,
                            momentum, rescale_grad, clip_gradient)

    def kernel(*args, lrs=None, wds=None, momentum=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, num_weights=None):
        return _multi_kernel(args, n_per, momentum_on, mp_on, lrs, wds,
                             momentum, rescale_grad, clip_gradient)

    plain.__name__ = name
    plain.__doc__ = ("SGD%s%s over an interleaved list of %d tensors a "
                     "parameter (the reference's %s)" % (
                         "-momentum" if momentum_on else "",
                         " with fp32 masters" if mp_on else "", n_per, name))
    register(name, arity=None, differentiable=False, num_outputs=0)(plain)
    get(name).cuda_impl(kernel)


for _name, _spec in _MULTI_SGD.items():
    _register_multi_sgd(_name, *_spec)
alias("multi_mp_sgd_mom_update", "preloaded_multi_mp_sgd_mom_update")


@register("multi_all_finite", arity=None, differentiable=False)
def _multi_all_finite(*args, num_arrays=None, init_output=True):
    """1.0 (a float32 tensor of one element) when every element of every
    array is finite, else 0.0."""
    ok = None
    if init_output:
        ok = torch.ones((), dtype=torch.bool,
                        device=args[0].device if args else None)
    for a in args:
        fin = torch.isfinite(a.float()).all()
        ok = fin if ok is None else ok & fin
    return ok.float().reshape(1)


@register("multi_lars", arity=None, differentiable=False)
def _multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
                eps=1e-8, rescale_grad=1.0):
    """Each layer's lr times its LARS trust ratio eta * ||w|| / (||g|| +
    wd * ||w|| + eps), or times 1 where a norm is 0."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wds * w_norm + eps),
                        torch.ones_like(w_norm))
    return lrs * trust


def _lamb1_args(weight, weight32, beta1, beta2, t, clip_gradient):
    """(master, mp_on, clip_on, scalars) of a phase-1 call: the fp32
    master where given, and 1 - beta, 1 - beta^t in Python double (the
    reference's weakly typed constants); the clip applies where it is
    positive, as the reference's `_lamb_phase1` has it."""
    clip_on = clip_gradient is not None and clip_gradient > 0
    return (weight32, weight32 is not None, clip_on,
            (beta1, 1 - beta1, beta2, 1 - beta2, 1 - beta1 ** t,
             1 - beta2 ** t))


@register("mp_lamb_update_phase1", arity=4, differentiable=False,
          num_outputs=3)
def _mp_lamb_update_phase1(weight, grad, mean, var, weight32=None, beta1=0.9,
                           beta2=0.999, epsilon=1e-6, t=1, wd=0.0,
                           rescale_grad=1.0, clip_gradient=-1.0,
                           bias_correction=True):
    """LAMB's direction from the fp32 master (weight32, else the weight):
    (direction fp32, mean, var)."""
    master, mp_on, clip_on, sc = _lamb1_args(weight, weight32, beta1, beta2,
                                             t, clip_gradient)
    gdir, m, v, _ = _fo._ref_flat_lamb1(
        weight, grad, mean, var, master, wd, *sc, epsilon, rescale_grad,
        clip_gradient if clip_on else 0.0, clip_on, mp_on,
        bool(bias_correction))
    return gdir, m, v


@get("mp_lamb_update_phase1").cuda_impl
def _mp_lamb_update_phase1_cuda(weight, grad, mean, var, weight32=None,
                                beta1=0.9, beta2=0.999, epsilon=1e-6, t=1,
                                wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                                bias_correction=True):
    master, mp_on, clip_on, sc = _lamb1_args(weight, weight32, beta1, beta2,
                                             t, clip_gradient)
    gdir, _, _, _ = _fo.flat_lamb1(
        weight.reshape(-1), grad.reshape(-1), mean.reshape(-1),
        var.reshape(-1), None if master is None else master.reshape(-1),
        wd, *(float(s) for s in sc), epsilon, rescale_grad,
        clip_gradient if clip_on else 0.0, clip_on, mp_on,
        bool(bias_correction))
    return gdir.reshape(weight.shape), mean, var


def _lamb2_scale(r1, r2, lr, lower_bound, upper_bound, device):
    """lr x the trust ratio r1 / r2 (1 where a norm is not positive),
    the ratio clipped into the bounds: a 0-d fp32 tensor on `device`."""
    r1 = torch.as_tensor(r1, dtype=torch.float32)
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=r1.device)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    if lower_bound is not None and lower_bound > 0:
        ratio = torch.clamp(ratio, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        ratio = torch.clamp(ratio, max=upper_bound)
    return (lr * ratio).to(device)


@register("mp_lamb_update_phase2", arity=4, differentiable=False,
          num_outputs=2)
def _mp_lamb_update_phase2(weight, g, r1, r2, weight32=None, lr=0.01,
                           lower_bound=-1.0, upper_bound=-1.0):
    """w32 - lr * ratio * g on the fp32 master (weight32, else the
    weight): (the weight rounded, the fp32 result)."""
    master = weight.float() if weight32 is None else weight32
    scale = _lamb2_scale(r1, r2, lr, lower_bound, upper_bound, weight.device)
    return _fo._ref_flat_lamb2(weight, master, g, scale, True)


@get("mp_lamb_update_phase2").cuda_impl
def _mp_lamb_update_phase2_cuda(weight, g, r1, r2, weight32=None, lr=0.01,
                                lower_bound=-1.0, upper_bound=-1.0):
    master = weight.to(torch.float32, copy=True) if weight32 is None \
        else weight32
    scale = _lamb2_scale(r1, r2, lr, lower_bound, upper_bound, weight.device)
    _fo.flat_lamb2(weight.reshape(-1), master.reshape(-1), g.reshape(-1),
                   scale, True)
    return weight, master
