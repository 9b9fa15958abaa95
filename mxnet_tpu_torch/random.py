"""Random numbers (the port of `mxnet_tpu.random`): `seed`, the draws
the initializers make (`uniform`, `normal`), and the reference's other
draws, which call the `_random_*` / `_sample_*` ops (`randn`, `randint`,
`gamma`, `exponential`, `poisson`, `negative_binomial`,
`generalized_negative_binomial`, `multinomial`, `shuffle`).

Each context has its own explicit `torch.Generator`, made at first use
from the global seed (`seed(s)`, or 0), or reseeded alone with
`seed(s, ctx)`. Runs of the port are deterministic under a seed, but they
do not reproduce the reference's JAX random streams: weights cross between
the two packages by file (`load_parameters`) or by
`models.convert.gluon_params_from_jax`, never by seed.
"""
from __future__ import annotations

import threading

import torch

from .base import torch_dtype
from .context import current_context

__all__ = ["seed", "generator", "uniform", "normal", "randn", "randint",
           "gamma", "exponential", "poisson", "negative_binomial",
           "generalized_negative_binomial", "multinomial", "shuffle"]

_state = threading.local()


def _table():
    if not hasattr(_state, "gens"):
        _state.gens = {}
        _state.seed = 0
    return _state.gens


def seed(seed_state, ctx="all"):
    """Seed every context's generator, or only `ctx`'s."""
    gens = _table()
    if ctx == "all":
        gens.clear()
        _state.seed = int(seed_state)
    else:
        gens[ctx] = torch.Generator(device=ctx.torch_device).manual_seed(
            int(seed_state))


def generator(ctx=None):
    """The generator of `ctx` (default: the current context)."""
    ctx = ctx or current_context()
    gens = _table()
    if ctx not in gens:
        gens[ctx] = torch.Generator(device=ctx.torch_device).manual_seed(
            _state.seed)
    return gens[ctx]


def generator_of(device):
    """The generator of `device`'s context (none on `meta`, where shape
    inference draws nothing): the random ops' source."""
    if device.type == "meta":
        return None
    from .context import context_of
    return generator(context_of(device))


def _draw(fill, shape, dtype, ctx):
    from .ndarray import NDArray
    ctx = ctx or current_context()
    t = torch.empty(shape, dtype=torch.float32, device=ctx.torch_device)
    fill(t, generator(ctx))
    return NDArray(t.to(torch_dtype(dtype)), ctx=ctx)


def uniform(low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None):
    """U(low, high) drawn in fp32 on `ctx`, then cast to `dtype`."""
    return _draw(lambda t, g: t.uniform_(low, high, generator=g), shape,
                 dtype, ctx)


def normal(loc=0.0, scale=1.0, shape=(1,), dtype=None, ctx=None):
    """N(loc, scale) drawn in fp32 on `ctx`, then cast to `dtype`."""
    return _draw(lambda t, g: t.normal_(loc, scale, generator=g), shape,
                 dtype, ctx)


# the reference's `nd.random` names and the ops behind them; `sym.random`
# has SYMBOL_NAMES of them
OPS = {"uniform": "_random_uniform", "normal": "_random_normal",
       "randint": "_random_randint", "gamma": "_random_gamma",
       "exponential": "_random_exponential", "poisson": "_random_poisson",
       "negative_binomial": "_random_negative_binomial",
       "generalized_negative_binomial":
           "_random_generalized_negative_binomial",
       "multinomial": "_sample_multinomial", "shuffle": "_shuffle",
       "randn": "_random_normal"}
SYMBOL_NAMES = ("uniform", "normal", "randint", "gamma", "exponential",
                "poisson", "multinomial", "shuffle")


def _nd_random(name):
    op = OPS[name]

    def fn(*args, **kwargs):
        from .ndarray import invoke
        return invoke(op, *args, **kwargs)
    fn.__name__ = op.lstrip("_")
    fn.__doc__ = "The `%s` op." % op
    return fn


randn = _nd_random("randn")
randint = _nd_random("randint")
gamma = _nd_random("gamma")
exponential = _nd_random("exponential")
poisson = _nd_random("poisson")
negative_binomial = _nd_random("negative_binomial")
generalized_negative_binomial = _nd_random("generalized_negative_binomial")
multinomial = _nd_random("multinomial")
shuffle = _nd_random("shuffle")
