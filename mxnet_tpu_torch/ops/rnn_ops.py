"""The fused recurrent op `RNN` (the port of `mxnet_tpu.ops.rnn_ops`).

Layouts and the flat parameter vector are the reference's (and cuDNN's):

* data: TNC (seq_len, batch, input);
* parameters: one flat vector, all weights first (per layer, per
  direction: i2h then h2h), then all biases in the same order;
* gate order: LSTM [i, f, g, o], GRU [r, z, n] with
  n = tanh(x_n + r * (h W_n^T + b_n)).

The reference runs one `lax.scan` per layer and direction, plain XLA and
no Pallas kernel, so the port has no hand-written kernel here either: for
each layer and direction one `torch.matmul` projects the whole sequence,
then a Python loop over time does the recurrent product and the gate
arithmetic, under `torch.autograd`. The same route runs for every mode and
device; cuDNN's RNN is not called (it would also read
`torch.backends.cudnn.allow_tf32`).

Copied from the reference: `use_sequence_length`/`sequence_length`,
`projection_size`, `state_outputs` and `lstm_state_clip_nan` are accepted
and ignored, and the op always returns (output, state_n, cell_n); the
reverse direction flips the whole sequence; `lstm_state_clip_min/max`
clip c after each step, only when set. Kept deviation: the inter-layer
dropout (p > 0, training, every layer but the last) draws its mask from
the context's generator (`mx.random`), where the reference draws from its
JAX key.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["rnn_param_size", "rnn_solve_input_size"]


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def _lstm_step(xp, h, c, w, b):
    i, f, g, o = (xp + torch.addmm(b, h, w.t())).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _gru_step(xp, h, c, w, b):
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = torch.addmm(b, h, w.t()).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h, c


def _elman_step(act):
    def step(xp, h, c, w, b):
        return act(xp + torch.addmm(b, h, w.t())), c
    return step


_STEPS = {"lstm": _lstm_step, "gru": _gru_step,
          "rnn_tanh": _elman_step(torch.tanh),
          "rnn_relu": _elman_step(torch.relu)}


def rnn_param_size(mode, input_size, state_size, num_layers,
                   bidirectional=False):
    """Length of the flat parameter vector in the layout `_slice_params`
    reads (shape inference and `initializer.FusedRNN` use it)."""
    ng = _gates(mode)
    h = state_size
    ndir = 2 if bidirectional else 1
    return ndir * ng * h * (input_size + h) \
        + (num_layers - 1) * ndir * ng * h * (h * ndir + h) \
        + num_layers * ndir * 2 * ng * h


def rnn_solve_input_size(mode, total, state_size, num_layers,
                         bidirectional=False):
    """The input size for which `rnn_param_size` is `total`; raises if
    there is none."""
    ng = _gates(mode)
    h = state_size
    ndir = 2 if bidirectional else 1
    L = num_layers
    bias_total = L * ndir * 2 * ng * h
    deeper = (L - 1) * ndir * ng * h * (h * ndir + h)
    in_sz = (total - bias_total - deeper) // (ndir * ng * h) - h
    if in_sz <= 0 or rnn_param_size(mode, in_sz, h, L,
                                    bidirectional) != total:
        raise ValueError(
            "cannot solve input size from a %d-element packed RNN "
            "parameter vector (mode=%s, %d hidden, %d layers)"
            % (total, mode, h, L))
    return in_sz


def _slice_params(params, mode, input_size, state_size, num_layers,
                  bidirectional, projection_size=None):
    """Per layer and direction {i2h_w, h2h_w, i2h_b, h2h_b}: views of the
    flat vector (all weights, then all biases)."""
    ng = _gates(mode)
    ndir = 2 if bidirectional else 1
    h = state_size
    specs = []
    off = 0
    for layer in range(num_layers):
        for _ in range(ndir):
            in_sz = input_size if layer == 0 else h * ndir
            specs.append({"i2h_w": (off, (ng * h, in_sz))})
            off += ng * h * in_sz
            specs[-1]["h2h_w"] = (off, (ng * h, h))
            off += ng * h * h
    for spec in specs:
        spec["i2h_b"] = (off, (ng * h,))
        off += ng * h
        spec["h2h_b"] = (off, (ng * h,))
        off += ng * h
    out = []
    for spec in specs:
        entry = {}
        for k, (o, shape) in spec.items():
            n = 1
            for s in shape:
                n *= s
            entry[k] = params[o:o + n].view(shape)
        out.append(entry)
    return out


def _direction(seq, spec, h, c, step, clip):
    """One layer and direction over `seq` (T, N, C): the outputs (T, N, H)
    and the final h and c."""
    T, N, C = seq.shape
    xp = torch.matmul(seq.reshape(T * N, C), spec["i2h_w"].t()) \
        + spec["i2h_b"]
    xp = xp.view(T, N, -1)
    ys = []
    for t in range(T):
        h, c = step(xp[t], h, c, spec["h2h_w"], spec["h2h_b"])
        if clip is not None:
            c = torch.clamp(c, clip[0], clip[1])
        ys.append(h)
    return torch.stack(ys), h, c


@register("RNN", num_outputs=3, random=True)
def _rnn(data, parameters, state, state_cell=None, state_size=None,
         num_layers=1, mode="lstm", bidirectional=False, p=0.0,
         state_outputs=False, projection_size=None, use_sequence_length=False,
         sequence_length=None, lstm_state_clip_min=None,
         lstm_state_clip_max=None, lstm_state_clip_nan=False,
         _training=None):
    """Fused multi-layer (bidirectional) RNN / LSTM / GRU over TNC data:
    (output (T, N, H * directions), state_n, cell_n), the states
    (layers * directions, N, H); cell_n is the initial cell state (zeros
    without one) for every mode but LSTM."""
    from .. import autograd
    from ..context import context_of
    from ..random import generator
    training = _training if _training is not None else autograd.is_training()
    input_size = data.shape[2]
    ndir = 2 if bidirectional else 1
    specs = _slice_params(parameters, mode, input_size, state_size,
                          num_layers, bidirectional, projection_size)
    step = _STEPS[mode]
    clip = (lstm_state_clip_min, lstm_state_clip_max) \
        if mode == "lstm" and lstm_state_clip_min is not None else None
    x = data
    out_h, out_c = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(ndir):
            k = layer * ndir + d
            h0 = state[k]
            c0 = state_cell[k] if mode == "lstm" and state_cell is not None \
                else torch.zeros_like(h0)
            seq = x if d == 0 else torch.flip(x, dims=(0,))
            ys, hT, cT = _direction(seq, specs[k], h0, c0, step, clip)
            outs.append(ys if d == 0 else torch.flip(ys, dims=(0,)))
            out_h.append(hT)
            out_c.append(cT)
        x = outs[0] if ndir == 1 else torch.cat(outs, dim=-1)
        if p > 0 and training and layer < num_layers - 1:
            u = torch.rand(x.shape, generator=generator(
                context_of(x.device)), device=x.device)
            x = x * (u < 1 - p).to(x.dtype) / (1 - p)
    return x, torch.stack(out_h), torch.stack(out_c)
