"""Token sampling: temperature / top-k / top-p, replayable per position.

The port of `mxnet_tpu.serve.sampling`, drawing the JAX package's own
tokens. The draw for the token at position p depends only on (stream
seed, p, logits): the JAX package draws
``jax.random.categorical(fold_in(PRNGKey(seed), p), masked)``, and this
module computes the same bits (jax's threefry2x32 with partitionable bit
generation) with integer ops: each row's key in numpy on the host, the
(rows, V) bits in torch on the logits' device:

* ``fold_in(PRNGKey(s), p)`` is ``threefry2x32(key=(0, s), counter=(0, p))``
  (seed cast to uint32, position to int32 and then uint32);
* the (V,) draw bits are ``x0 ^ x1`` of ``threefry2x32(key, (0, iota))``;
* the uniform in [tiny, 1) is ``max(tiny, (bitcast_f32((bits >> 9) |
  0x3f800000) - 1) * (1 - tiny) + tiny)`` in fp32;
* the token is ``argmax(masked + -log(-log(u)))``.

The uint32 arithmetic runs on int64 tensors masked to 32 bits (torch's
uint32 has few operators on CUDA): adds wrap with ``& 0xffffffff``,
rotates are ``((x << r) | (x >> (32 - r))) & 0xffffffff``, and every
value stays non-negative, so ``>>`` never sign-extends. The uniforms
equal `jax.random.uniform`'s bit for bit; a token can differ from the JAX
package's only where a one-ulp difference of `log` meets a near tie.

* ``temperature <= 0`` — greedy: exactly ``argmax``;
* ``top_k > 0`` — keep only the k highest logits (ties at the boundary
  stay eligible);
* ``top_p < 1`` — nucleus: keep the smallest probability-ordered set whose
  cumulative mass reaches top_p (the top-1 token always stays).

Filter order is temperature -> top-k -> top-p, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample_tokens"]

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _add(a, b):
    return (a + b) & _M32


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors (or numpy int64 arrays)
    holding uint32 values; the four operands broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = _add(x0, k0), _add(x1, k1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = _add(x0, x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _add(x0, ks[(i + 1) % 3])
        x1 = _add(x1, ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def _uniforms(seeds, positions, vocab, device):
    """(N, vocab) fp32 uniforms in [tiny, 1), equal bit for bit to
    ``jax.random.uniform(fold_in(PRNGKey(seed), position), (vocab,),
    minval=tiny, maxval=1)`` for each row's (seed, position)."""
    seeds = np.asarray(seeds).astype(np.int64) & _M32
    positions = np.asarray(positions).astype(np.int64).astype(
        np.int32).astype(np.int64) & _M32
    # the per-row keys (N values) on the host; the (N, vocab) bits on the
    # device
    zero = np.zeros_like(seeds)
    keys = np.stack(_threefry2x32(zero, seeds, zero, positions), axis=1)
    keys = torch.as_tensor(keys, device=device)
    counter = torch.arange(vocab, device=device, dtype=torch.int64)[None]
    b0, b1 = _threefry2x32(keys[:, :1], keys[:, 1:],
                           torch.zeros_like(counter), counter)
    # (bits >> 9) | 0x3f800000 stays under 2**31: an int32 bit pattern
    one_two = ((b0 ^ b1) >> 9 | 0x3F800000).to(torch.int32).view(
        torch.float32)
    return torch.clamp_min((one_two - 1.0) * (1.0 - _TINY) + _TINY, _TINY)


def _filtered(logits, temperature, top_k, top_p):
    """Scaled logits with everything outside top-k / top-p at -1e30."""
    V = logits.shape[1]
    scaled = logits / temperature.clamp(min=1e-6)[:, None]
    order = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, V)).clamp(1, V)
    kth = order.gather(1, k[:, None] - 1)
    neg = torch.full_like(scaled, _NEG_INF)
    masked = torch.where(scaled >= kth, scaled, neg)
    # top-p over what survived top-k: keep sorted entries whose PRECEDING
    # cumulative mass is under top_p (the top-1 entry's is 0)
    order_m = torch.where(order >= kth, order, neg)
    probs = torch.softmax(order_m, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    keep_p = before < top_p.clamp(max=1.0)[:, None]
    thresh = torch.where(keep_p, order_m,
                         torch.full_like(order_m, float("inf"))).amin(dim=-1)
    return torch.where(scaled >= thresh[:, None], masked, neg)


def _host(vec, dtype):
    if torch.is_tensor(vec):
        vec = vec.cpu().numpy()
    return np.asarray(vec, dtype)


def sample_tokens(logits, seeds, positions, temperature, top_k, top_p):
    """Draw one token per row.

    logits (N, V) fp32; seeds (N,) — the stream's sampling seed;
    positions (N,) — the position the NEW token will occupy (the replay
    key); temperature (N,) (<= 0 selects greedy argmax); top_k (N,)
    (0 disables); top_p (N,) (>= 1 disables). The vectors are numpy arrays
    (or tensors, read on the host). Returns (N,) int64 on the logits'
    device.

    An all-greedy batch pays only the argmax; otherwise the sampled rows
    are filtered and drawn in one batched pass on the logits' device.
    """
    dev = logits.device
    greedy = torch.argmax(logits, dim=-1)
    temperature = _host(temperature, np.float32)
    rows = np.flatnonzero(temperature > 0)
    if not rows.size:
        return greedy
    idx = torch.as_tensor(rows, device=dev)
    masked = _filtered(
        logits.index_select(0, idx),
        torch.as_tensor(temperature[rows], device=dev),
        torch.as_tensor(_host(top_k, np.int64)[rows], device=dev),
        torch.as_tensor(_host(top_p, np.float32)[rows], device=dev))
    u = _uniforms(_host(seeds, np.int64)[rows],
                  _host(positions, np.int64)[rows], logits.shape[1], dev)
    drawn = torch.argmax(masked + -torch.log(-torch.log(u)), dim=-1)
    return greedy.index_copy(0, idx, drawn)
