"""`mx.np.random` (the port of `mxnet_tpu.numpy.random`): numpy-named
draws over the port's `_random_*` ops and its per-context generators
(`mx.random.seed` and `np.random.seed` apply). The derived distributions
are the reference's transforms of uniform, normal and gamma draws.

Deviation, as for every draw of the port: the values come from torch's
generators, so they are held to their distributions, not to the
reference's JAX random bits.
"""
from __future__ import annotations

import numpy as _onp

from .. import random as _random
from ..ndarray.ndarray import NDArray
from ..ndarray.ndarray import invoke as _raw_invoke
from .multiarray import as_np_ndarray as _as_np

__all__ = ["seed", "uniform", "normal", "randn", "rand", "randint",
           "choice", "shuffle", "permutation", "gamma", "beta",
           "exponential", "multinomial", "lognormal", "laplace",
           "logistic", "gumbel", "pareto", "power", "rayleigh", "weibull",
           "chisquare", "f", "poisson", "standard_normal",
           "standard_exponential", "standard_gamma", "standard_cauchy",
           "multivariate_normal", "bernoulli", "binomial",
           "negative_binomial"]


def invoke(*args, **kwargs):
    return _as_np(_raw_invoke(*args, **kwargs))


seed = _random.seed


def _size(size):
    return () if size is None else size


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None):
    return invoke("_random_uniform", low=float(low), high=float(high),
                  shape=_size(size), ctx=ctx, dtype=dtype or "float32")


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    return invoke("_random_normal", loc=float(loc), scale=float(scale),
                  shape=_size(size), ctx=ctx, dtype=dtype or "float32")


def randn(*size, **kwargs):
    return normal(size=size or (), **kwargs)


def rand(*size, **kwargs):
    return uniform(size=size or (), **kwargs)


def randint(low, high=None, size=None, dtype=None, ctx=None):
    if high is None:
        low, high = 0, low
    return invoke("_random_randint", low=int(low), high=int(high),
                  shape=_size(size), ctx=ctx, dtype=dtype or "int32")


def exponential(scale=1.0, size=None, ctx=None):
    return invoke("_random_exponential", lam=1.0 / scale,
                  shape=_size(size), ctx=ctx)


def gamma(shape, scale=1.0, size=None, ctx=None):
    return invoke("_random_gamma", alpha=float(shape), beta=float(scale),
                  shape=_size(size), ctx=ctx)


def beta(a, b, size=None, ctx=None):
    """ga / (ga + gb) of two gamma draws."""
    ga = gamma(a, 1.0, size=size, ctx=ctx)
    gb = gamma(b, 1.0, size=size, ctx=ctx)
    return ga / (ga + gb)


def poisson(lam=1.0, size=None, ctx=None):
    return invoke("_random_poisson", lam=float(lam), shape=_size(size),
                  ctx=ctx)


def negative_binomial(n, p, size=None, ctx=None):
    return invoke("_random_negative_binomial", k=int(n), p=float(p),
                  shape=_size(size), ctx=ctx)


def standard_normal(size=None, ctx=None):
    return normal(0.0, 1.0, size=size, ctx=ctx)


def standard_exponential(size=None, ctx=None):
    return exponential(1.0, size=size, ctx=ctx)


def standard_gamma(shape, size=None, ctx=None):
    return gamma(shape, 1.0, size=size, ctx=ctx)


def _clip_open(u, eps=1e-7):
    """Uniforms kept strictly inside (0, 1), so the log and power
    transforms stay finite."""
    from . import clip
    return clip(u, eps, 1.0 - eps)


def _u(size, ctx):
    return _clip_open(uniform(0.0, 1.0, size=size, ctx=ctx))


def standard_cauchy(size=None, ctx=None):
    from . import tan, pi
    return tan(pi * (_u(size, ctx) - 0.5))


def lognormal(mean=0.0, sigma=1.0, size=None, ctx=None):
    from . import exp
    return exp(normal(mean, sigma, size=size, ctx=ctx))


def laplace(loc=0.0, scale=1.0, size=None, ctx=None):
    from . import sign, log1p, abs as _abs, clip
    # |u| strictly below 0.5: u = -0.5 would give log1p(-1) = -inf
    u = clip(uniform(-0.5, 0.5, size=size, ctx=ctx), -0.5 + 1e-7,
             0.5 - 1e-7)
    return loc - scale * sign(u) * log1p(-2.0 * _abs(u))


def logistic(loc=0.0, scale=1.0, size=None, ctx=None):
    from . import log
    u = _u(size, ctx)
    return loc + scale * log(u / (1.0 - u))


def gumbel(loc=0.0, scale=1.0, size=None, ctx=None):
    from . import log
    return loc - scale * log(-log(_u(size, ctx)))


def pareto(a, size=None, ctx=None):
    """numpy's Pareto II (Lomax): (1 - u)^(-1/a) - 1."""
    from . import power as _pow
    return _pow(1.0 - _u(size, ctx), -1.0 / float(a)) - 1.0


def power(a, size=None, ctx=None):
    from . import power as _pow
    return _pow(_u(size, ctx), 1.0 / float(a))


def rayleigh(scale=1.0, size=None, ctx=None):
    from . import sqrt, log
    return scale * sqrt(-2.0 * log(_u(size, ctx)))


def weibull(a, size=None, ctx=None):
    from . import power as _pow, log
    return _pow(-log(_u(size, ctx)), 1.0 / float(a))


def chisquare(df, size=None, ctx=None):
    return gamma(df / 2.0, 2.0, size=size, ctx=ctx)


def f(dfnum, dfden, size=None, ctx=None):
    num = chisquare(dfnum, size=size, ctx=ctx) / float(dfnum)
    den = chisquare(dfden, size=size, ctx=ctx) / float(dfden)
    return num / den


def bernoulli(prob=0.5, size=None, ctx=None):
    u = uniform(0.0, 1.0, size=size, ctx=ctx)
    return (u < prob).astype("float32")


def binomial(n, p, size=None, ctx=None):
    """A sum of n Bernoulli draws: one (..., n) uniform draw and one
    reduction."""
    from . import zeros
    shape = tuple(size) if size is not None and not _onp.isscalar(size) \
        else ((int(size),) if size is not None else ())
    if int(n) == 0:
        return zeros(shape, ctx=ctx)
    u = uniform(0.0, 1.0, size=shape + (int(n),), ctx=ctx)
    return (u < p).astype("float32").sum(axis=-1)


def multivariate_normal(mean, cov, size=None, ctx=None):
    from . import array as _np_array
    from .linalg import cholesky
    mean = mean if isinstance(mean, NDArray) else _np_array(mean, ctx=ctx)
    cov = cov if isinstance(cov, NDArray) else _np_array(cov, ctx=ctx)
    d = mean.shape[-1]
    count = (size,) if isinstance(size, int) else (size or ())
    z = normal(0.0, 1.0, size=tuple(count) + (d,), ctx=mean.context)
    L = cholesky(cov)
    return mean + z @ L.T


def _rand_perm_idx(n, ctx=None):
    """A permutation of [0, n): the argsort of n uniform draws from the
    port's generator (seeded runs repeat it)."""
    from . import argsort
    return argsort(uniform(0.0, 1.0, size=(int(n),), ctx=ctx))


def choice(a, size=None, replace=True, p=None, ctx=None):
    from . import argsort, cumsum, searchsorted, log, array as _np_array
    n = int(a) if _onp.isscalar(a) else len(a)
    count = int(_onp.prod(size)) if size else 1
    if p is None:
        if replace:
            idx = randint(0, n, size=size, ctx=ctx)
        else:
            idx = _rand_perm_idx(n, ctx)[:count].reshape(size or ())
    else:
        pv = _np_array(_onp.asarray(p, dtype=_onp.float32), ctx=ctx)
        if replace:
            # inverse-CDF draws
            cdf = cumsum(pv)
            u = uniform(0.0, 1.0, size=(count,), ctx=ctx) * cdf[-1]
            idx = searchsorted(cdf, u, side="right").reshape(size or ())
        else:
            # Gumbel-top-k: weighted draws without replacement
            z = log(_clip_open(pv, 1e-12)) + gumbel(0.0, 1.0, size=(n,),
                                                    ctx=ctx)
            idx = argsort(-z)[:count].reshape(size or ())
    if _onp.isscalar(a):
        return _as_np(idx.astype("int64"))
    src = a if isinstance(a, NDArray) else _np_array(_onp.asarray(a),
                                                     ctx=ctx)
    return _as_np(src[idx.astype("int32")])


def multinomial(n, pvals, size=None, ctx=None):
    """Counts of n inverse-CDF draws per experiment, from one
    (experiments, n) draw."""
    from . import array as _np_array, cumsum, searchsorted, arange, \
        expand_dims
    pv = _np_array(_onp.asarray(pvals, dtype=_onp.float32), ctx=ctx)
    k = pv.shape[0]
    cdf = cumsum(pv)
    experiments = int(_onp.prod(size)) if size else 1
    u = uniform(0.0, 1.0, size=(experiments, int(n)), ctx=ctx) * cdf[-1]
    idx = searchsorted(cdf, u, side="right")
    counts = (expand_dims(idx, -1) == arange(k, dtype="int32",
                                              ctx=pv.context)).astype(
        "float32").sum(axis=1)
    if size is None:
        return _as_np(counts[0])
    if not _onp.isscalar(size):
        counts = counts.reshape(tuple(size) + (k,))
    return _as_np(counts)


def shuffle(x):
    """Permute `x` along axis 0 in place, by draws from the port's
    generator."""
    x[:] = x[_rand_perm_idx(x.shape[0], getattr(x, "context", None))
             .astype("int32")]


def permutation(x, ctx=None):
    from . import array as _np_array
    if _onp.isscalar(x):
        return _as_np(_rand_perm_idx(int(x), ctx))
    out = (x if isinstance(x, NDArray) else _np_array(x, ctx=ctx)).copy()
    shuffle(out)
    return _as_np(out)
