"""Random sampling ops (the port of `mxnet_tpu.ops.random_ops`): the
`_random_*` draws with scalar parameters, the `_sample_*` draws with
per-element parameters, `_shuffle` and `bernoulli`, under the reference's
names and aliases.

Each op draws from the port's generator of the context it runs on
(`mxnet_tpu_torch.random.generator`), so `mx.random.seed` makes a run
repeat itself; the draws are not the reference's threefry bits. The tests
hold each op to its distribution (moments and Kolmogorov-Smirnov tests),
and to the reference's shapes and dtypes. The counts (poisson and the
negative binomials) are drawn as gamma-mixed Poisson variables, as the
reference draws them. On a `meta` tensor (symbolic shape inference) an op
draws nothing and gives only its shape.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from ..random import generator_of
from .registry import alias, register

__all__ = []


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _ctx_device(ctx):
    from ..context import current_context
    return (ctx or current_context()).torch_device


def _draw_dtype(dtype):
    """Draws are made in float32 (float64 for a float64 result) and cast
    to the op's dtype."""
    dt = torch_dtype(dtype)
    return torch.float64 if dt == torch.float64 else torch.float32


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=_draw_dtype(dtype), device=device)


def _gamma(alpha, device, gen):
    """Gamma(alpha, 1) draws, one per element of the tensor `alpha`."""
    if device.type == "meta":
        return torch.empty_like(alpha)
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(lam, gen):
    if lam.device.type == "meta":
        return torch.empty_like(lam)
    return torch.poisson(lam, generator=gen)


@register("_random_uniform", creation=True, random=True,
          differentiable=False)
def _random_uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None):
    dev = _ctx_device(ctx)
    out = _empty(_shape(shape), dtype, dev).uniform_(
        low, high, generator=generator_of(dev))
    return out.to(torch_dtype(dtype))


@register("_random_normal", creation=True, random=True,
          differentiable=False)
def _random_normal(loc=0.0, scale=1.0, shape=None, dtype="float32",
                   ctx=None):
    """N(loc, scale^2); a negative scale raises, as the reference's."""
    if float(scale) < 0:
        raise ValueError("normal: scale (sigma) must be non-negative, "
                         "got %s" % scale)
    dev = _ctx_device(ctx)
    out = _empty(_shape(shape), dtype, dev).normal_(
        generator=generator_of(dev))
    return (loc + scale * out).to(torch_dtype(dtype))


@register("_random_randint", creation=True, random=True,
          differentiable=False)
def _random_randint(low=0, high=None, shape=None, dtype="int32", ctx=None):
    """Integers uniform in [low, high)."""
    dev = _ctx_device(ctx)
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=generator_of(dev), device=dev,
                         dtype=torch_dtype(dtype))


@register("_random_gamma", creation=True, random=True, differentiable=False)
def _random_gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32",
                  ctx=None):
    """Gamma with shape alpha and scale beta."""
    dev = _ctx_device(ctx)
    a = torch.full(_shape(shape), float(alpha), dtype=_draw_dtype(dtype),
                   device=dev)
    return (beta * _gamma(a, dev, generator_of(dev))).to(torch_dtype(dtype))


@register("_random_exponential", creation=True, random=True,
          differentiable=False)
def _random_exponential(lam=1.0, shape=None, dtype="float32", ctx=None):
    """Exponential with rate lam."""
    dev = _ctx_device(ctx)
    out = _empty(_shape(shape), dtype, dev).exponential_(
        generator=generator_of(dev))
    return (out / lam).to(torch_dtype(dtype))


@register("_random_poisson", creation=True, random=True,
          differentiable=False)
def _random_poisson(lam=1.0, shape=None, dtype="float32", ctx=None):
    dev = _ctx_device(ctx)
    rate = torch.full(_shape(shape), float(lam), dtype=torch.float32,
                      device=dev)
    return _poisson(rate, generator_of(dev)).to(torch_dtype(dtype))


def _gamma_poisson(r, scale, shape, dtype, dev):
    """Poisson(Gamma(r) * scale): the negative binomial with r successes
    and success probability 1 / (1 + scale)."""
    gen = generator_of(dev)
    a = torch.full(_shape(shape), float(r), dtype=torch.float32, device=dev)
    return _poisson(_gamma(a, dev, gen) * scale, gen).to(torch_dtype(dtype))


@register("_random_negative_binomial", creation=True, random=True,
          differentiable=False)
def _random_negative_binomial(k=1, p=1.0, shape=None, dtype="float32",
                              ctx=None):
    """Failures before the k-th success, success probability p."""
    return _gamma_poisson(k, (1 - p) / p, shape, dtype, _ctx_device(ctx))


@register("_random_generalized_negative_binomial", creation=True,
          random=True, differentiable=False)
def _random_gen_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None):
    """The negative binomial of mean mu and dispersion alpha."""
    r = 1.0 / alpha
    p = r / (r + mu)
    return _gamma_poisson(r, (1 - p) / p, shape, dtype, _ctx_device(ctx))


@register("_sample_unique_zipfian", creation=True, random=True,
          differentiable=False)
def _sample_unique_zipfian(range_max=1, shape=None, ctx=None):
    """Log-uniform integers in [0, range_max): floor(range_max ^ u) - 1,
    as int32 (the reference's draw; repeats are not removed)."""
    dev = _ctx_device(ctx)
    u = torch.empty(_shape(shape), dtype=torch.float32, device=dev).uniform_(
        generator=generator_of(dev))
    s = torch.exp(u * torch.log(torch.tensor(float(range_max),
                                             device=dev))).to(torch.int32) - 1
    return s.clamp(0, range_max - 1)


def _per_element(param, sh):
    return param.reshape(tuple(param.shape) + (1,) * len(sh))


@register("_sample_uniform", random=True, differentiable=False)
def _sample_uniform(low, high, shape=None, dtype="float32"):
    """U(low, high) per element of low/high, `shape` draws each: the
    result is low.shape + shape."""
    sh = _shape(shape)
    u = _empty(tuple(low.shape) + sh, dtype, low.device).uniform_(
        generator=generator_of(low.device)).to(torch_dtype(dtype))
    return _per_element(low, sh) + u * _per_element(high - low, sh)


@register("_sample_normal", random=True, differentiable=False)
def _sample_normal(mu, sigma, shape=None, dtype="float32"):
    sh = _shape(shape)
    z = _empty(tuple(mu.shape) + sh, dtype, mu.device).normal_(
        generator=generator_of(mu.device)).to(torch_dtype(dtype))
    return _per_element(mu, sh) + z * _per_element(sigma, sh)


@register("_sample_gamma", random=True, differentiable=False)
def _sample_gamma(alpha, beta, shape=None, dtype="float32"):
    sh = _shape(shape)
    a = _per_element(alpha, sh).expand(tuple(alpha.shape) + sh).to(
        _draw_dtype(dtype))
    g = _gamma(a.contiguous(), alpha.device, generator_of(alpha.device))
    return g.to(torch_dtype(dtype)) * _per_element(beta, sh)


@register("_sample_multinomial", random=True, differentiable=False)
def _sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """Category draws from a probability vector (or each row of a batch):
    `shape` draws each (one, without the axis, when shape is None). With
    `get_prob` also the log-probability of each draw."""
    sh = _shape(shape)
    n = 1
    for s in sh:
        n *= s
    logits = torch.log(torch.clamp(data, min=1e-38))
    rows = data.reshape(-1, data.shape[-1])
    if data.device.type == "meta":
        draws = torch.empty((rows.shape[0], n), dtype=torch.long,
                            device=data.device)
    else:
        draws = torch.multinomial(rows.float(), n, replacement=True,
                                  generator=generator_of(data.device))
    lead = () if data.dim() == 1 else (data.shape[0],)
    out = draws.reshape(lead + sh)
    out = out.to(torch_dtype(dtype))
    if get_prob:
        lp = torch.gather(torch.log_softmax(logits.reshape(rows.shape),
                                            dim=-1), 1, draws)
        return out, lp.reshape(out.shape)
    return out


@register("_shuffle", random=True, differentiable=False)
def _shuffle(data):
    """The rows (axis 0) in a random order."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], generator=generator_of(data.device),
                          device=data.device)
    return data[perm]


@register("bernoulli", random=True, differentiable=False)
def _bernoulli(data):
    """1 with probability data, else 0, as float32."""
    if data.device.type == "meta":
        return torch.empty_like(data, dtype=torch.float32)
    return torch.bernoulli(data.float(), generator=generator_of(data.device))


alias("_random_uniform", "uniform", "random_uniform")
alias("_random_normal", "normal", "random_normal", "randn")
alias("_random_randint", "randint", "random_randint")
alias("_random_gamma", "random_gamma")
alias("_random_exponential", "random_exponential")
alias("_random_poisson", "random_poisson")
alias("_random_negative_binomial", "random_negative_binomial")
alias("_random_generalized_negative_binomial",
      "random_generalized_negative_binomial")
alias("_sample_multinomial", "sample_multinomial")
alias("_shuffle", "shuffle")
