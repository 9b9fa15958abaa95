"""Llama-family decoder (RMSNorm + RoPE + GQA + SwiGLU) for training and
inference on the CUDA card.

The port of `mxnet_tpu.models.llama`: the same configurations, the same
parameter tree (``layers/<i>/attn/wq`` ..., projections ``(in, out)`` so the
product is ``x @ W``, embeddings ``(vocab, dim)``) and the same functions,
on plain tensors. The compute dtype is the config's (bf16 by default) with
fp32 RMSNorm accumulation; prompt attention (`llama_forward`,
`llama_prefill_paged`) goes through the flash-attention kernels, and the
paged decode and chunk paths through plain paged attention, as in the JAX
package. `llama_forward` and `llama_loss` run under the caller's grad mode,
so a trainer differentiates them (the attention backward is the flash
backward kernels); the decoding functions never track gradients.

The paged functions write the new KV rows into the pools IN PLACE and
return the same pools dict (JAX returns new arrays and donates the old
ones; in place saves the copy). Writes whose block-table entry is
``>= num_blocks`` (unallocated), whose position is -1 (padding) or whose
position lies past the table are dropped, as ``mode="drop"`` drops them in
the JAX scatter.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..base import resolve_device
from ..parallel.flash_attention import (flash_attention, paged_attention,
                                        paged_attention_chunk)

__all__ = ["LlamaConfig", "CONFIGS", "llama_init", "rms_norm", "rope_freqs",
           "apply_rope", "llama_forward", "llama_loss", "init_kv_cache",
           "llama_decode_step", "init_kv_pools", "llama_prefill_paged",
           "llama_decode_paged", "llama_chunk_paged"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    # recompute each layer in the backward instead of keeping its
    # activations (torch.utils.checkpoint; jax.checkpoint in the JAX package)
    remat: bool = False
    # tok_embeddings doubles as the output head; no lm_head leaf
    tie_embeddings: bool = False
    # embed as one_hot(tokens) @ tok_embeddings instead of a gather: the JAX
    # package uses it where the vocab dimension is sharded (the gather's
    # scatter-add backward does not partition); kept for parity
    embed_onehot: bool = False

    @property
    def head_dim(self):
        return self.dim // self.n_heads


CONFIGS = {
    "llama3_8b": LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, hidden_dim=14336,
                             rope_theta=500000.0, max_seq_len=8192,
                             embed_onehot=True),
    "llama3_8b_dry": LlamaConfig(vocab_size=8192, dim=4096, n_layers=2,
                                 n_heads=32, n_kv_heads=8, hidden_dim=14336,
                                 rope_theta=500000.0, max_seq_len=512,
                                 remat=True, embed_onehot=True),
    "llama_110m": LlamaConfig(vocab_size=32000, dim=768, n_layers=12,
                              n_heads=12, n_kv_heads=12, hidden_dim=2048,
                              rope_theta=10000.0, max_seq_len=2048),
    "llama_tiny": LlamaConfig(vocab_size=256, dim=64, n_layers=2,
                              n_heads=4, n_kv_heads=2, hidden_dim=128,
                              rope_theta=10000.0, max_seq_len=128),
}


# ------------------------------------------------------------------- init
def llama_init(generator, cfg: LlamaConfig, device=None):
    """Random parameters from `generator` (a `torch.Generator`; values are
    drawn on its device, then moved to `device`, which defaults to cuda).
    Layout as in the JAX package: projections (in_features, out_features),
    embeddings (vocab, dim), norm scales fp32 ones; no lm_head when the
    config ties the embeddings."""
    device = resolve_device(device)
    d, hd = cfg.dim, cfg.head_dim
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * scale
        return w.to(device=device, dtype=cfg.dtype)

    def ones():
        return torch.ones(d, dtype=torch.float32, device=device)

    params = {"tok_embeddings": dense((cfg.vocab_size, d), 0.02),
              "norm": ones(), "layers": {}}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((cfg.vocab_size, d), 0.02)
    for i in range(cfg.n_layers):
        params["layers"][str(i)] = {
            "attn_norm": ones(),
            "attn": {"wq": dense((d, qd)), "wk": dense((d, kvd)),
                     "wv": dense((d, kvd)), "wo": dense((qd, d))},
            "ffn_norm": ones(),
            "mlp": {"w1": dense((d, cfg.hidden_dim)),
                    "w2": dense((cfg.hidden_dim, d)),
                    "w3": dense((d, cfg.hidden_dim))},
        }
    return params


# ----------------------------------------------------------------- layers
def rms_norm(x, scale, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope_freqs(positions, head_dim, theta):
    """positions (..., S) int -> cos/sin (..., S, head_dim/2) fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, H, S, D); cos/sin (S, D/2) or (B, S, D/2). Returns a
    contiguous tensor in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:
        c, s = cos[None, None], sin[None, None]
    else:
        c, s = cos[:, None], sin[:, None]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype).contiguous()


def _qkv(lp, x, cos, sin, cfg):
    """Normed input -> q (B, H, S, hd), k/v (B, Hkv, S, hd), RoPE applied."""
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["attn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["attn"]["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["attn"]["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2).contiguous()


def _attn_out(lp, x, o):
    B, _, S, _ = o.shape
    return x + o.transpose(1, 2).reshape(B, S, -1) @ lp["attn"]["wo"]


def _mlp(lp, x, cfg):
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    gate = F.silu(h @ lp["mlp"]["w1"])
    return x + (gate * (h @ lp["mlp"]["w3"])) @ lp["mlp"]["w2"]


def _head(params, cfg):
    return params["tok_embeddings"] if cfg.tie_embeddings \
        else params["lm_head"]


def _logits(params, x, cfg):
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    return (x @ _head(params, cfg).T.to(x.dtype)).float()


def _index(a, device):
    return torch.as_tensor(a, dtype=torch.long, device=device)


def _layer(lp, x, cos, sin, cfg):
    q, k, v = _qkv(lp, x, cos, sin, cfg)
    x = _attn_out(lp, x, flash_attention(q, k, v, causal=True))
    return _mlp(lp, x, cfg)


def llama_forward(params, tokens, cfg: LlamaConfig, positions=None):
    """tokens (B, S) int -> logits (B, S, vocab) fp32. Attention is the
    causal flash attention; `positions` ((S,) or (B, S) int) overrides the
    RoPE positions 0..S-1. Runs under the caller's grad mode; with
    `cfg.remat` each layer is recomputed in the backward."""
    emb = params["tok_embeddings"]
    tokens = _index(tokens, emb.device)
    if cfg.embed_onehot:
        x = F.one_hot(tokens, cfg.vocab_size).to(emb.dtype) @ emb
    else:
        x = emb[tokens]
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=emb.device)
    cos, sin = rope_freqs(_index(positions, emb.device), cfg.head_dim,
                          cfg.rope_theta)
    layer = functools.partial(_layer, cfg=cfg)
    for i in range(cfg.n_layers):
        lp = params["layers"][str(i)]
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(layer, lp, x, cos, sin, use_reentrant=False)
        else:
            x = layer(lp, x, cos, sin)
    return _logits(params, x, cfg)


def llama_loss(params, batch, cfg: LlamaConfig):
    """Next-token cross entropy: batch = {"tokens": (B, S+1) int} or the
    (B, S+1) array itself; inputs are tokens[:, :-1], targets tokens[:, 1:],
    the mean NLL from an fp32 log-softmax."""
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    tokens = _index(tokens, params["tok_embeddings"].device)
    logits = llama_forward(params, tokens[:, :-1], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
    return nll.mean()


# ------------------------------------------------------ unpaged decoding
def _zeros_per_layer(cfg, shape, device):
    device = resolve_device(device)
    return {str(i): {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                     "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for i in range(cfg.n_layers)}


def init_kv_cache(cfg: LlamaConfig, batch, max_len=None, device=None):
    """The unpaged decode cache: per layer, (batch, n_kv_heads, max_len,
    head_dim) for k and v."""
    return _zeros_per_layer(cfg, (batch, cfg.n_kv_heads,
                                  max_len or cfg.max_seq_len, cfg.head_dim),
                            device)


@torch.no_grad()
def llama_decode_step(params, cache, token, pos, cfg: LlamaConfig):
    """One token of KV-cached greedy-reference decode: token (B,) int, pos
    int -> (logits (B, vocab) fp32, cache updated in place)."""
    emb = params["tok_embeddings"]
    token = _index(token, emb.device)
    pos = int(pos)
    B = token.shape[0]
    x = emb[token][:, None, :]
    cos, sin = rope_freqs(torch.tensor([pos], device=emb.device),
                          cfg.head_dim, cfg.rope_theta)
    max_len = cache["0"]["k"].shape[2]
    mask = (torch.arange(max_len, device=emb.device) <= pos)
    rep = cfg.n_heads // cfg.n_kv_heads
    for i in range(cfg.n_layers):
        lp = params["layers"][str(i)]
        q, k, v = _qkv(lp, x, cos, sin, cfg)
        ck, cv = cache[str(i)]["k"], cache[str(i)]["v"]
        ck[:, :, pos] = k[:, :, 0]
        cv[:, :, pos] = v[:, :, 0]
        kk = ck.repeat_interleave(rep, dim=1) if rep > 1 else ck
        vv = cv.repeat_interleave(rep, dim=1) if rep > 1 else cv
        scores = torch.matmul(q.float(), kk.float().transpose(-1, -2)) \
            * (cfg.head_dim ** -0.5)
        scores = scores.masked_fill(~mask, float("-inf"))
        o = torch.matmul(torch.softmax(scores, dim=-1),
                         vv.float()).to(x.dtype)
        x = _attn_out(lp, x, o)
        x = _mlp(lp, x, cfg)
    return _logits(params, x, cfg)[:, 0], cache


# -------------------------------------------------------- paged decoding
def init_kv_pools(cfg: LlamaConfig, num_blocks, block_size, device=None):
    """The physical paged KV pool: per layer, (num_blocks, n_kv_heads,
    block_size, head_dim) for k (post-RoPE) and v."""
    return _zeros_per_layer(cfg, (num_blocks, cfg.n_kv_heads, block_size,
                                  cfg.head_dim), device)


def _write_slots(blk, off, keep):
    """Flattened (block, offset) pairs of the writes that land, and the
    flat row indices they come from. One host sync per call (the
    nonzero), shared by every layer."""
    sel = keep.reshape(-1).nonzero().squeeze(1)
    return blk.reshape(-1)[sel], off.reshape(-1)[sel], sel


def _scatter(pools, i, k, v, slots):
    """Write rows of k/v (B, Hkv, C, D) into layer i's pools in place."""
    wblk, woff, sel = slots
    B, Hkv, C, D = k.shape
    pools[str(i)]["k"][wblk, :, woff] = \
        k.transpose(1, 2).reshape(B * C, Hkv, D)[sel]
    pools[str(i)]["v"][wblk, :, woff] = \
        v.transpose(1, 2).reshape(B * C, Hkv, D)[sel]


@torch.no_grad()
def llama_prefill_paged(params, pools, tokens, length, block_table,
                        cfg: LlamaConfig, block_size):
    """Bucketed prefill: run the context through the stack once (flash
    attention), write its KV into the paged pool, return the next-token
    logits.

    tokens (S,) int right-padded; length: true context length; block_table
    (S // block_size,) int. Returns (logits (vocab,) fp32 at position
    length-1, pools updated in place)."""
    emb = params["tok_embeddings"]
    tokens = _index(tokens, emb.device)
    block_table = _index(block_table, emb.device)
    length = int(length)
    S = tokens.shape[0]
    num_blocks = pools["0"]["k"].shape[0]
    x = emb[tokens][None]
    positions = torch.arange(S, device=emb.device)
    cos, sin = rope_freqs(positions, cfg.head_dim, cfg.rope_theta)
    blk = block_table[positions // block_size]
    slots = _write_slots(blk, positions % block_size,
                         (positions < length) & (blk < num_blocks))
    for i in range(cfg.n_layers):
        lp = params["layers"][str(i)]
        q, k, v = _qkv(lp, x, cos, sin, cfg)
        _scatter(pools, i, k, v, slots)
        x = _attn_out(lp, x, flash_attention(q, k, v, causal=True))
        x = _mlp(lp, x, cfg)
    return _logits(params, x[:, length - 1], cfg)[0], pools


@torch.no_grad()
def llama_chunk_paged(params, pools, tokens, positions, block_tables,
                      cfg: LlamaConfig, block_size):
    """Multi-row chunk forward over the paged pool (chunked prefill).

    Row b carries C consecutive context tokens of one stream: tokens[b, c]
    at absolute position positions[b, c] (-1 = padding: no write, output
    ignored). Each layer scatters the chunk's KV into the pool BEFORE its
    attention gathers, so queries see earlier chunks, a shared prefix and
    earlier tokens of this chunk.

    tokens, positions (B, C) int; block_tables (B, nb) int. Returns
    (logits (B, vocab) fp32 at each row's last valid position, pools
    updated in place)."""
    emb = params["tok_embeddings"]
    tokens = _index(tokens, emb.device)
    positions = _index(positions, emb.device)
    block_tables = _index(block_tables, emb.device)
    B, C = tokens.shape
    nb = block_tables.shape[1]
    num_blocks = pools["0"]["k"].shape[0]
    active = positions >= 0
    pos = positions.clamp(min=0)
    x = emb[tokens]
    cos, sin = rope_freqs(pos, cfg.head_dim, cfg.rope_theta)
    lb = pos // block_size
    blk = block_tables.gather(1, lb.clamp(max=nb - 1))
    # pads drop, and so do positions past the table: a clamped index would
    # land on the stream's last real block and overwrite live KV rows
    slots = _write_slots(blk, pos % block_size,
                         active & (lb < nb) & (blk < num_blocks))
    lengths = pos + 1
    for i in range(cfg.n_layers):
        lp = params["layers"][str(i)]
        q, k, v = _qkv(lp, x, cos, sin, cfg)
        _scatter(pools, i, k, v, slots)
        o = paged_attention_chunk(q, pools[str(i)]["k"], pools[str(i)]["v"],
                                  block_tables, lengths)
        x = _attn_out(lp, x, o)
        x = _mlp(lp, x, cfg)
    # fully padded rows read column 0, which the caller never uses
    last = (active.sum(dim=1) - 1).clamp(min=0)
    x = x[torch.arange(B, device=x.device), last][:, None]
    return _logits(params, x, cfg)[:, 0], pools


@torch.no_grad()
def llama_decode_paged(params, pools, tokens, positions, block_tables,
                       cfg: LlamaConfig, block_size):
    """One continuous-batching decode step over the paged pool.

    tokens (B,) int — each stream's newest token; positions (B,) int — its
    position, or -1 for an inactive slot; block_tables (B, nb) int.
    Returns (logits (B, vocab) fp32, pools updated in place)."""
    emb = params["tok_embeddings"]
    tokens = _index(tokens, emb.device)
    positions = _index(positions, emb.device)
    block_tables = _index(block_tables, emb.device)
    nb = block_tables.shape[1]
    num_blocks = pools["0"]["k"].shape[0]
    active = positions >= 0
    pos = positions.clamp(min=0)
    x = emb[tokens][:, None, :]
    cos, sin = rope_freqs(pos[:, None], cfg.head_dim, cfg.rope_theta)
    lb = pos // block_size
    blk = block_tables.gather(1, lb.clamp(max=nb - 1)[:, None])[:, 0]
    slots = _write_slots(blk, pos % block_size,
                         active & (lb < nb) & (blk < num_blocks))
    lengths = pos + 1          # inactive slots read one masked garbage row
    for i in range(cfg.n_layers):
        lp = params["layers"][str(i)]
        q, k, v = _qkv(lp, x, cos, sin, cfg)
        _scatter(pools, i, k, v, slots)
        o = paged_attention(q, pools[str(i)]["k"], pools[str(i)]["v"],
                            block_tables, lengths)
        x = _attn_out(lp, x, o)
        x = _mlp(lp, x, cfg)
    return _logits(params, x, cfg)[:, 0], pools
