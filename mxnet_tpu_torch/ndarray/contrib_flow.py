"""Control flow of `nd.contrib` (the port of
`mxnet_tpu.ndarray.contrib_flow`): `foreach`, `while_loop` and `cond`.

They run as Python loops and branches over the port's NDArrays, so every
op of the body is an ordinary op: under `autograd.record()` torch records
it, and gradients reach whatever arrays the body reads. `while_loop` runs
its true trip count (its condition is read on the host each step) and
returns its outputs stacked in a (max_iterations, ...) buffer, zero past
the trip count, as the reference does in both of its regimes. The
reference's traced regime (`lax.scan` / `lax.while_loop` / `lax.cond`
inside a JAX trace) has no counterpart: a hybridized port block runs its
`hybrid_forward` eagerly.
"""
from __future__ import annotations

from .. import autograd
from .ndarray import NDArray, zeros

__all__ = ["foreach", "while_loop", "cond"]


def _stack(parts):
    from . import stack
    return stack(*parts, axis=0)


def _like(tree, fn):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(t, fn) for t in tree)
    return fn(tree)


def _empty_like_outputs(outs_fn, rows):
    """Zero buffers of `rows` slices shaped as what `outs_fn()` returns
    (run once, not recorded, only for its shapes)."""
    with autograd.pause():
        sample = outs_fn()
    return _like(sample, lambda o: zeros((rows,) + o.shape, ctx=o.context,
                                         dtype=o.dtype))


def _slice(data, i):
    if isinstance(data, NDArray):
        return data[i]
    return type(data)(d[i] for d in data)


def foreach(body, data, init_states):
    """Run `body(data[i], states) -> (outputs, states)` for i along axis
    0 of `data` (an array or a list of arrays); returns (the outputs
    stacked along a new axis 0, the final states)."""
    n = data.shape[0] if isinstance(data, NDArray) else data[0].shape[0]
    states = init_states
    outs = []
    for i in range(n):
        out, states = body(_slice(data, i), states)
        outs.append(out)
    if not outs:
        zero_slice = _like(data, lambda d: zeros(d.shape[1:], ctx=d.context,
                                                 dtype=d.dtype))
        return _empty_like_outputs(
            lambda: body(zero_slice, init_states)[0], 0), states
    if isinstance(outs[0], (list, tuple)):
        return type(outs[0])(_stack([o[j] for o in outs])
                             for j in range(len(outs[0]))), states
    return _stack(outs), states


def _truth(v):
    if isinstance(v, NDArray):
        return bool(v.asnumpy().reshape(()))
    return bool(v)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """`while cond(*vars): outputs, vars = func(*vars)`, at most
    `max_iterations` times. Returns (the outputs stacked in a
    (max_iterations, ...) buffer, zero past the trip count, and the final
    loop variables as a tuple)."""
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations (the output "
                         "buffer has max_iterations rows)")
    vars_ = tuple(loop_vars) if isinstance(loop_vars, (list, tuple)) \
        else (loop_vars,)
    outs = []
    while len(outs) < max_iterations and _truth(cond(*vars_)):
        out, new_vars = func(*vars_)
        vars_ = tuple(new_vars) if isinstance(new_vars, (list, tuple)) \
            else (new_vars,)
        outs.append(out)
    if not outs:
        return _empty_like_outputs(lambda: func(*vars_)[0],
                                   max_iterations), vars_

    def pad_stack(slices):
        from . import zeros_like
        pad = [zeros_like(slices[-1])] * (max_iterations - len(slices))
        return _stack(list(slices) + pad)

    if isinstance(outs[0], (list, tuple)):
        return type(outs[0])(pad_stack([o[j] for o in outs])
                             for j in range(len(outs[0]))), vars_
    return pad_stack(outs), vars_


def cond(pred, then_func, else_func, inputs=()):
    """`then_func(*inputs)` when pred holds, else `else_func(*inputs)`;
    only the branch taken runs."""
    taken = then_func if _truth(pred) else else_func
    return taken(*inputs)
