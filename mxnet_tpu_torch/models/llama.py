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

Tensor parallelism over the ``model`` axis (Megatron), when
`parallel.ShardedTrainStep` runs `llama_loss` under `LLAMA_RULES` on a
mesh with ``model`` > 1 and hands the projections and embeddings over as
this rank's ``model`` blocks (`ShardingRules.local`; the step gathers the
``fsdp`` splits before the forward):

* column-parallel ``wq/wk/wv`` and ``w1/w3``: this rank's H/m query heads
  and Hkv/m KV heads (contiguous GQA groups, as in the JAX package), its
  hidden/m columns of the MLP; their input passes
  `collectives.copy_to_group` (identity forward, its cotangent summed);
* row-parallel ``wo`` and ``w2``, then `collectives.reduce_from_group`
  (the sum forward, identity backward);
* ``tok_embeddings`` over the vocab: a masked lookup of this rank's rows
  (the one-hot product on the local range with ``embed_onehot``), then the
  sum; exactly one rank contributes each row, so it is exact;
* ``lm_head``: vocab-parallel logits, and `llama_loss`'s fp32 log-softmax
  and target pick through a max and two sum all-reduces: the full-vocab
  logits are never gathered (`llama_forward` returns this rank's vocab
  block of the logits under the split);
* a split that does not fall on a head boundary (``wk``/``wv`` at
  ``n_kv_heads`` = 1 and ``model`` = 2: `_prune_spec` keeps a split of 16
  columns mid-head) is gathered over ``model`` on use, with the
  reduce-scatter of its gradient, and each rank takes the KV heads its
  query heads read. A block whose partner is not split the same way
  (attention or MLP) is computed whole on every rank from its gathered
  leaves.

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
from ..parallel import collectives as _coll
from ..parallel.flash_attention import (flash_attention, paged_attention,
                                        paged_attention_chunk)

__all__ = ["LlamaConfig", "CONFIGS", "llama_init", "rms_norm", "rope_freqs",
           "apply_rope", "llama_forward", "llama_loss", "init_kv_cache",
           "llama_decode_step", "init_kv_pools", "llama_prefill_paged",
           "llama_decode_paged", "llama_chunk_paged", "llama_draft_loop"]


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


@dataclasses.dataclass(frozen=True)
class _ModelSplit:
    """The ``model`` axis of the current mesh: its group, size and this
    rank's index (resolved before the layers, so a recomputation in the
    backward needs no mesh scope)."""
    group: object
    world: int
    rank: int


def _model_split():
    from ..parallel.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None or mesh.axis_size("model") == 1:
        return None
    return _ModelSplit(mesh.group("model"), mesh.axis_size("model"),
                       mesh.axis_index("model"))


def _whole(w, tp, dim, full):
    """`w` whole on every rank: gathered over ``model`` (the slice of the
    cotangent backward: every rank computes the same thing) when it is
    this rank's block of a `full`-wide dimension `dim`."""
    if tp is None or w.shape[dim] == full:
        return w
    return _coll.gather_on_use(w, tp.group, dim, summed=False)


def _kv_local(w, x, tp, cfg, q_lo, q_n):
    """k or v (B, S, heads, hd) for this rank's query heads [q_lo, q_lo +
    q_n) from the column-parallel input `x`: a head-aligned block of the
    KV heads those queries read as it is, any other weight gathered (a
    block, with the reduce-scatter of its gradient) or marked (a whole
    leaf, its gradient summed) over ``model``, then sliced to those
    heads."""
    B, S, _ = x.shape
    hd, rep = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    lo, hi = q_lo // rep, (q_lo + q_n - 1) // rep + 1
    full = cfg.n_kv_heads * hd
    if w.shape[1] != full and w.shape[1] % hd == 0 \
            and w.shape[1] // hd == hi - lo:
        return (x @ w).reshape(B, S, hi - lo, hd)
    w = _coll.gather_on_use(w, tp.group, 1) if w.shape[1] != full \
        else _coll.copy_to_group(w, tp.group)
    return (x @ w[:, lo * hd:hi * hd]).reshape(B, S, hi - lo, hd)


def _attention_split(lp, x, cos, sin, cfg, tp):
    """The attention block's output added to x: Megatron over ``model``
    when wq (columns) and wo (rows) arrive as this rank's head-aligned
    blocks and the query heads split into whole GQA groups (or each rank's
    heads share one group), else computed whole on every rank."""
    a = lp["attn"]
    hd, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    wq, wo = a["wq"], a["wo"]
    q_n = wq.shape[1] // hd
    rep = H // Hkv
    aligned = (wq.shape[1] != H * hd and wq.shape[1] % hd == 0
               and wo.shape[0] == wq.shape[1]
               and (q_n % rep == 0 or rep % q_n == 0))
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    if not aligned:
        q = (h @ _whole(wq, tp, 1, H * hd)).reshape(B, S, H, hd)
        k = (h @ _whole(a["wk"], tp, 1, Hkv * hd)).reshape(B, S, Hkv, hd)
        v = (h @ _whole(a["wv"], tp, 1, Hkv * hd)).reshape(B, S, Hkv, hd)
        q = apply_rope(q.transpose(1, 2), cos, sin)
        k = apply_rope(k.transpose(1, 2), cos, sin)
        o = flash_attention(q, k, v.transpose(1, 2).contiguous(),
                            causal=True)
        return x + o.transpose(1, 2).reshape(B, S, -1) @ _whole(
            wo, tp, 0, H * hd)
    hf = _coll.copy_to_group(h, tp.group)
    q_lo = tp.rank * q_n
    q = (hf @ wq).reshape(B, S, q_n, hd)
    k = _kv_local(a["wk"], hf, tp, cfg, q_lo, q_n)
    v = _kv_local(a["wv"], hf, tp, cfg, q_lo, q_n)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    o = flash_attention(q, k, v.transpose(1, 2).contiguous(), causal=True)
    out = o.transpose(1, 2).reshape(B, S, -1) @ wo
    return x + _coll.reduce_from_group(out, tp.group)


def _mlp_split(lp, x, cfg, tp):
    """The MLP's output added to x: Megatron over ``model`` when w1/w3
    (columns) and w2 (rows) arrive as matching blocks, else whole."""
    m = lp["mlp"]
    w1, w2, w3 = m["w1"], m["w2"], m["w3"]
    full = cfg.hidden_dim
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if w1.shape[1] != full and w3.shape[1] == w1.shape[1] \
            and w2.shape[0] == w1.shape[1]:
        hf = _coll.copy_to_group(h, tp.group)
        out = (F.silu(hf @ w1) * (hf @ w3)) @ w2
        return x + _coll.reduce_from_group(out, tp.group)
    w1, w3 = _whole(w1, tp, 1, full), _whole(w3, tp, 1, full)
    return x + (F.silu(h @ w1) * (h @ w3)) @ _whole(w2, tp, 0, full)


def _layer(lp, x, cos, sin, cfg, tp=None):
    if tp is not None:
        return _mlp_split(lp, _attention_split(lp, x, cos, sin, cfg, tp),
                          cfg, tp)
    q, k, v = _qkv(lp, x, cos, sin, cfg)
    x = _attn_out(lp, x, flash_attention(q, k, v, causal=True))
    return _mlp(lp, x, cfg)


def _embed(emb, tokens, cfg, tp):
    """The token rows: this rank's vocab block masked and summed over
    ``model`` when `emb` arrives as one."""
    if tp is None or emb.shape[0] == cfg.vocab_size:
        if cfg.embed_onehot:
            return F.one_hot(tokens, cfg.vocab_size).to(emb.dtype) @ emb
        return emb[tokens]
    vl = emb.shape[0]
    local = tokens - tp.rank * vl
    mine = ((local >= 0) & (local < vl))[..., None]
    local = local.clamp(0, vl - 1)
    if cfg.embed_onehot:
        x = (F.one_hot(local, vl) * mine).to(emb.dtype) @ emb
    else:
        x = torch.where(mine, emb[local], torch.zeros((), dtype=emb.dtype,
                                                      device=emb.device))
    return _coll.reduce_from_group(x, tp.group)


def llama_forward(params, tokens, cfg: LlamaConfig, positions=None):
    """tokens (B, S) int -> logits (B, S, vocab) fp32. Attention is the
    causal flash attention; `positions` ((S,) or (B, S) int) overrides the
    RoPE positions 0..S-1. Runs under the caller's grad mode; with
    `cfg.remat` each layer is recomputed in the backward. Under a
    ``model`` split of the head (see the module docstring) the logits are
    this rank's vocab block (B, S, vocab / model)."""
    emb = params["tok_embeddings"]
    tokens = _index(tokens, emb.device)
    tp = _model_split()
    x = _embed(emb, tokens, cfg, tp)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=emb.device)
    cos, sin = rope_freqs(_index(positions, emb.device), cfg.head_dim,
                          cfg.rope_theta)
    layer = functools.partial(_layer, cfg=cfg, tp=tp)
    for i in range(cfg.n_layers):
        lp = params["layers"][str(i)]
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(layer, lp, x, cos, sin, use_reentrant=False)
        else:
            x = layer(lp, x, cos, sin)
    head = _head(params, cfg)
    if tp is None or head.shape[0] == cfg.vocab_size:
        return _logits(params, x, cfg)
    x = _coll.copy_to_group(rms_norm(x, params["norm"], cfg.norm_eps),
                            tp.group)
    return (x @ head.T.to(x.dtype)).float()


def llama_loss(params, batch, cfg: LlamaConfig):
    """Next-token cross entropy: batch = {"tokens": (B, S+1) int} or the
    (B, S+1) array itself; inputs are tokens[:, :-1], targets tokens[:, 1:],
    the mean NLL from an fp32 log-softmax."""
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    tokens = _index(tokens, params["tok_embeddings"].device)
    logits = llama_forward(params, tokens[:, :-1], cfg)
    if logits.shape[-1] == cfg.vocab_size:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
        return nll.mean()
    # vocab-parallel: the max, the sum of exponentials and the target's
    # shifted logit reduced over ``model`` (log_softmax's own max is cut
    # from the graph, as here)
    tp = _model_split()
    vl = logits.shape[-1]
    top = _coll.all_reduce_max(logits.max(dim=-1, keepdim=True).values,
                               tp.group)
    shifted = logits - top
    total = _coll.reduce_from_group(shifted.exp().sum(dim=-1), tp.group)
    local = tokens[:, 1:] - tp.rank * vl
    mine = (local >= 0) & (local < vl)
    pick = shifted.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    pick = _coll.reduce_from_group(pick * mine, tp.group)
    return (torch.log(total) - pick).mean()


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
                      cfg: LlamaConfig, block_size, logits_at="last"):
    """Multi-row chunk forward over the paged pool: the one program shape
    behind chunked prefill and speculative verify.

    Row b carries C consecutive context tokens of one stream: tokens[b, c]
    at absolute position positions[b, c] (-1 = padding: no write, output
    ignored). Each layer scatters the chunk's KV into the pool BEFORE its
    attention gathers, so queries see earlier chunks, a shared prefix and
    earlier tokens of this chunk.

    tokens, positions (B, C) int; block_tables (B, nb) int. Returns
    (logits, pools updated in place): logits_at="last" projects each
    row's last valid position ((B, vocab) fp32, the prefill read); "all"
    projects every position ((B, C, vocab), the verify read)."""
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
    if logits_at == "all":
        return _logits(params, x, cfg), pools
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


@torch.no_grad()
def llama_draft_loop(params, pools, tokens, positions, block_tables,
                     cfg: LlamaConfig, block_size, k):
    """k greedy decode steps: the speculative-decoding draft. Step i feeds
    step i-1's argmax and writes the draft model's KV as it goes
    (position -1 = inactive slot throughout); one extra write-only pass
    lands the LAST draft's KV too, or a fully accepted round would leave a
    hole the next round's draft attends through.

    tokens/positions (B,) int, block_tables (B, nb) int. Returns (draft
    tokens (B, k) int64, pools updated in place)."""
    emb = params["tok_embeddings"]
    positions = _index(positions, emb.device)
    tok, pos = _index(tokens, emb.device), positions
    drafted = []
    for _ in range(int(k)):
        logits, pools = llama_decode_paged(params, pools, tok, pos,
                                           block_tables, cfg, block_size)
        tok = torch.argmax(logits, dim=-1)
        drafted.append(tok)
        pos = torch.where(positions >= 0, pos + 1, positions)
    llama_decode_paged(params, pools, tok, pos, block_tables, cfg,
                       block_size)
    return torch.stack(drafted, dim=1), pools
