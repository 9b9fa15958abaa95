"""The multi-tensor optimizer ops of `mxnet_tpu.ops.extended` (its
"multi-tensor fused optimizer updates" section): `multi_sgd_update`,
`multi_sgd_mom_update`, `multi_mp_sgd_update`, `multi_mp_sgd_mom_update`
(alias `preloaded_multi_mp_sgd_mom_update`), `multi_all_finite`,
`multi_lars`, `mp_lamb_update_phase1` and `mp_lamb_update_phase2`.

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

The rest of the reference's file follows them: `rcbrt`, `reshape_like`,
`unravel_index`/`ravel_multi_index`, `argmax_channel`, `batch_take`,
`fill_element_0index`, `moments`, `make_loss`, `cast_storage`,
`IdentityAttachKLSparseReg`, `broadcast_like`, `LRN`, `SVMOutput`,
`SpatialTransformer`, the `linalg_*` family (`torch.linalg`; the
factorizations keep the reference's conventions: lower Cholesky factors,
Householder signs for `gelqf`), `im2col`/`col2im`, `linspace` and
`digamma`.
"""
from __future__ import annotations

import numpy as _np
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


# ---------------------------------------------------------------------------
# the rest of the reference's extended.py: shape and index ops, LRN,
# SVMOutput, SpatialTransformer, the KL sparsity regularizer, the linalg_*
# family, im2col/col2im, linspace and digamma
# ---------------------------------------------------------------------------
@register("rcbrt")
def _rcbrt(data):
    return 1.0 / (torch.sign(data) * torch.abs(data).pow(1.0 / 3.0))


@register("reshape_like", arity=2)
def _reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                  rhs_end=None):
    """lhs reshaped to rhs's shape, or its dims [lhs_begin, lhs_end)
    replaced by rhs's [rhs_begin, rhs_end)."""
    if lhs_begin is None and rhs_begin is None:
        return lhs.reshape(rhs.shape)
    lb = 0 if lhs_begin is None else int(lhs_begin)
    le = lhs.dim() if lhs_end is None else int(lhs_end)
    rb = 0 if rhs_begin is None else int(rhs_begin)
    re_ = rhs.dim() if rhs_end is None else int(rhs_end)
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re_])
                       + tuple(lhs.shape[le:]))


@register("unravel_index", differentiable=False)
def _unravel_index(data, shape=None):
    """Flat indices -> (ndim, N) coordinates under `shape`, in data's
    dtype."""
    idx = torch.unravel_index(data.to(torch.long), tuple(shape))
    return torch.stack(idx, dim=0).to(data.dtype)


@register("ravel_multi_index", differentiable=False)
def _ravel_multi_index(data, shape=None):
    """(ndim, N) coordinates, each clipped into its dim -> flat indices
    under `shape`, as int32."""
    out = torch.zeros(data.shape[1:], dtype=torch.long, device=data.device)
    for coord, size in zip(data.to(torch.long), tuple(shape)):
        out = out * size + coord.clamp(0, size - 1)
    return out.to(torch.int32)


@register("argmax_channel", differentiable=False)
def _argmax_channel(data):
    return data.argmax(dim=1).to(torch.float32)


@register("batch_take", arity=2)
def _batch_take(a, indices):
    """out[i] = a[i, indices[i]]."""
    idx = indices.long()
    idx = torch.where(idx < 0, idx + a.shape[1], idx)
    return torch.gather(a, 1, idx[..., None])[..., 0]


@register("fill_element_0index", arity=3, differentiable=False)
def _fill_element_0index(lhs, mhs, rhs):
    """lhs with out[i, mhs[i]] = rhs[i]."""
    out = lhs.clone()
    out[torch.arange(lhs.shape[0], device=lhs.device), mhs.long()] = \
        rhs.to(lhs.dtype)
    return out


@register("moments", num_outputs=2)
def _moments(data, axes=None, keepdims=False):
    """(mean, population variance) over `axes` (all by default)."""
    dims = tuple(axes) if axes is not None else tuple(range(data.dim()))
    return (data.mean(dim=dims, keepdim=keepdims),
            data.var(dim=dims, unbiased=False, keepdim=keepdims))


@register("make_loss")
def _make_loss_lower(data, grad_scale=1.0, valid_thresh=0.0,
                     normalization="null"):
    """`MakeLoss` under its other name: the same gradient scaling."""
    return get("MakeLoss").fn(data, grad_scale=grad_scale,
                              valid_thresh=valid_thresh,
                              normalization=normalization)


@register("cast_storage", differentiable=False)
def _cast_storage(data, stype=None):
    """The dense payload as it is; `nd.sparse.cast_storage` converts
    storage."""
    return data


class _KLSparseRegFn(torch.autograd.Function):
    """Identity forward; the backward adds the gradient of the KL
    sparsity penalty, penalty * (-rho / rho_hat + (1 - rho) /
    (1 - rho_hat)) / batch, rho_hat the batch mean clipped into
    [1e-6, 1 - 1e-6] (the reference's pure form, without the running
    average)."""

    @staticmethod
    def forward(ctx, data, target, penalty):
        ctx.rho_hat = torch.clamp(data.float().mean(dim=0), 1e-6, 1 - 1e-6)
        ctx.cfg = (target, penalty)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        target, penalty = ctx.cfg
        rho = ctx.rho_hat
        dkl = -target / rho + (1.0 - target) / (1.0 - rho)
        grad = g.float() + penalty * dkl[None] / g.shape[0]
        return grad.to(g.dtype), None, None


@register("IdentityAttachKLSparseReg")
def _identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                   penalty=0.001, momentum=0.9):
    return _KLSparseRegFn.apply(data, float(sparseness_target),
                                float(penalty))


@register("broadcast_like", arity=2)
def _broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return lhs.expand(rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[int(la)] = rhs.shape[int(ra)]
    return lhs.expand(tuple(shape))


@register("LRN")
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """x / (knorm + alpha / nsize * (sum of x^2 over a window of nsize
    channels)) ^ beta, in fp32."""
    x32 = data.float()
    half = int(nsize) // 2
    pad = torch.nn.functional.pad(
        x32.square(), (0, 0) * (data.dim() - 2) + (half, half))
    window = pad[:, 0:data.shape[1]]
    for i in range(1, int(nsize)):
        window = window + pad[:, i:i + data.shape[1]]
    norm = (knorm + (alpha / nsize) * window) ** beta
    return (x32 / norm).to(data.dtype)


class _SVMOutputFn(torch.autograd.Function):
    """Identity forward; backward the hinge (or squared hinge) gradient
    times regularization_coefficient and the cotangent."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.cfg
        k = data.shape[1]
        onehot = (label.long()[:, None] == torch.arange(
            k, device=data.device)[None]).to(data.dtype)
        correct = (data * onehot).sum(dim=1, keepdim=True)
        if use_linear:
            violf = (((data - correct + margin) > 0) & (onehot == 0)).to(
                data.dtype)
            grad = violf - onehot * violf.sum(dim=1, keepdim=True)
        else:
            m = torch.clamp(data - correct + margin, min=0) * (1 - onehot)
            grad = 2 * m - onehot * (2 * m).sum(dim=1, keepdim=True)
        return reg * grad * g, None, None, None, None


@register("SVMOutput")
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    return _SVMOutputFn.apply(data, label, float(margin),
                              float(regularization_coefficient),
                              bool(use_linear))


@register("SpatialTransformer", arity=2)
def _spatial_transformer(data, loc, target_shape=None,
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=None):
    """GridGenerator's affine grid, then BilinearSampler."""
    grid = get("GridGenerator").fn(loc, transform_type=transform_type,
                                   target_shape=target_shape)
    return get("BilinearSampler").fn(data, grid)


# -- linalg_* ---------------------------------------------------------------
def _t(x):
    return x.transpose(-1, -2)


def _solve_tri(a, b, lower, trans):
    """x with op(a) x = b, op(a) = a^T with `trans`; only a's `lower`
    (else upper) triangle is read."""
    return torch.linalg.solve_triangular(_t(a) if trans else a, b,
                                         upper=lower if trans else not lower)


@register("linalg_det")
def _linalg_det(a):
    return torch.linalg.det(a)


@register("linalg_slogdet", num_outputs=2)
def _linalg_slogdet(a):
    """(sign, log |det|)."""
    sign, logdet = torch.linalg.slogdet(a)
    return sign, logdet


@register("linalg_inverse")
def _linalg_inverse(a):
    return torch.linalg.inv(a)


@register("linalg_potri")
def _linalg_potri(a):
    """inv(L L^T) from the lower Cholesky factor L."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    linv = _solve_tri(a, eye.expand(a.shape), True, False)
    return torch.matmul(_t(linv), linv)


@register("linalg_gemm", arity=3)
def _linalg_gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, axis=-2):
    if axis != -2:
        raise NotImplementedError("linalg_gemm: only axis=-2 (got %r)" % axis)
    ta = _t(a) if transpose_a else a
    tb = _t(b) if transpose_b else b
    return alpha * torch.matmul(ta, tb) + beta * c


@register("linalg_trmm", arity=2)
def _linalg_trmm(a, b, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """alpha op(a) b (b op(a) with `rightside`); as in the reference, the
    whole of a is read (`lower` is not)."""
    t = _t(a) if transpose else a
    return alpha * (torch.matmul(b, t) if rightside else torch.matmul(t, b))


@register("linalg_trsm", arity=2)
def _linalg_trsm(a, b, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """x with op(a) x = alpha b (x op(a) = alpha b with `rightside`)."""
    if rightside:
        return _t(_solve_tri(_t(a), _t(alpha * b), not lower, transpose))
    return _solve_tri(a, alpha * b, lower, transpose)


@register("linalg_gelqf", num_outputs=2)
def _linalg_gelqf(a):
    """A = L Q with Q's rows orthonormal, from the QR factorization of A^T
    (Householder, as the reference's: L's diagonal may be negative)."""
    q, r = torch.linalg.qr(_t(a))
    return _t(r), _t(q)


@register("linalg_makediag")
def _linalg_makediag(a, offset=0):
    return torch.diag_embed(a, offset=int(offset))


@register("linalg_extractdiag")
def _linalg_extractdiag(a, offset=0):
    return torch.diagonal(a, offset=int(offset), dim1=-2, dim2=-1)


@register("linalg_sumlogdiag")
def _linalg_sumlogdiag(a):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(dim=-1)


def _tri_index(n, lower, device):
    rows, cols = _np.tril_indices(n) if lower else _np.triu_indices(n)
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(cols).to(device))


@register("linalg_maketrian")
def _linalg_maketrian(a, offset=0, lower=True):
    """Pack the last axis (n(n+1)/2 values, row by row) into an n x n
    lower (or upper) triangle."""
    if offset != 0:
        raise NotImplementedError(
            "linalg_maketrian: only offset=0 (got %r)" % offset)
    n = int((_np.sqrt(8 * a.shape[-1] + 1) - 1) / 2)
    rows, cols = _tri_index(n, lower, a.device)
    flat = a.reshape(-1, a.shape[-1])
    out = torch.zeros((flat.shape[0], n * n), dtype=a.dtype,
                      device=a.device).index_copy(1, rows * n + cols, flat)
    return out.reshape(tuple(a.shape[:-1]) + (n, n))


@register("linalg_extracttrian")
def _linalg_extracttrian(a, offset=0, lower=True):
    if offset != 0:
        raise NotImplementedError(
            "linalg_extracttrian: only offset=0 (got %r)" % offset)
    rows, cols = _tri_index(a.shape[-1], lower, a.device)
    return a[..., rows, cols]


# -- im2col / col2im, linspace, digamma -------------------------------------
def _conv_tuples(kernel, stride, dilate, pad):
    k = tuple(kernel)

    def tup(v, d):
        if v is None:
            return (d,) * len(k)
        return tuple(v) if isinstance(v, (tuple, list)) else (v,) * len(k)
    return k, tup(stride, 1), tup(dilate, 1), tup(pad, 0)


@register("im2col")
def _im2col(data, kernel=None, stride=None, dilate=None, pad=None):
    """NCHW -> (N, C * kh * kw, L) sliding patches (channel-major)."""
    k, s, d, p = _conv_tuples(kernel, stride, dilate, pad)
    return torch.nn.functional.unfold(data, k, dilation=d, padding=p,
                                      stride=s)


@register("col2im")
def _col2im(data, output_size=None, kernel=None, stride=None, dilate=None,
            pad=None):
    """The transpose of im2col: the patches summed back into (N, C,
    *output_size)."""
    k, s, d, p = _conv_tuples(kernel, stride, dilate, pad)
    return torch.nn.functional.fold(data, tuple(output_size), k, dilation=d,
                                    padding=p, stride=s)


@register("linspace", creation=True, differentiable=False)
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, ctx=None,
              dtype="float32"):
    """`num` evenly spaced values from start (to stop with `endpoint`),
    computed in float64 and cast."""
    from ..base import torch_dtype
    from ..context import current_context
    num = int(num)
    div = max(num - 1, 1) if endpoint else max(num, 1)
    i = torch.arange(num, dtype=torch.float64)
    out = float(start) + (float(stop) - float(start)) * i / div
    if endpoint and num > 1:
        out[-1] = float(stop)
    return out.to(device=(ctx or current_context()).torch_device,
                  dtype=torch_dtype(dtype))


@register("digamma")
def _digamma(data):
    return torch.digamma(data)
