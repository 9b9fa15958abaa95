"""BERT encoder and masked-LM loss on plain tensors (the port of
`mxnet_tpu.models.bert`, the functional twin of the Gluon model zoo's
BERTModel).

The same configurations and parameter tree as the JAX package (``word_
embed``, ``layers/<i>/attn/wq`` ..., projections ``(in, out)``, layernorm
scales fp32), so `models.convert.params_from_jax` carries a JAX tree over.
Attention is the flash-attention kernels (#1 forward, #2/#3 backward) with
``causal=False``; the FFN uses the tanh GELU and the layernorm applies
gamma and beta in fp32 before the cast, as the JAX package does (the Gluon
model's GELU is exact and its LayerNorm casts first). `bert_forward` and
`bert_mlm_loss` run under the caller's grad mode.

Tensor parallelism over the ``model`` axis (Megatron), when
`parallel.ShardedTrainStep` runs `bert_mlm_loss` under `BERT_RULES` on a
mesh with ``model`` > 1 and hands the projections and embeddings over as
this rank's ``model`` blocks (`ShardingRules.local`), as `models.llama`
does:

* column-parallel ``wq/wk/wv`` (this rank's n_heads/model heads into the
  non-causal flash attention) and ``ffn/w1`` (its hidden/model columns,
  then the tanh GELU); their input passes `collectives.copy_to_group`.
  The replicated biases ``bq/bk/bv`` and ``b1`` pass
  `collectives.copy_to_group` and are read in this rank's slice, so
  their gradients are summed over ``model`` in the backward and every
  rank holds the whole gradient under any rules;
* row-parallel ``attn/wo`` and ``ffn/w2``, then
  `collectives.reduce_from_group` before ``bo``/``b2`` and the residual;
  those biases and every LayerNorm see the same values on every rank, so
  their gradients are equal there and are not summed;
* ``word_embed``, ``position_embed`` and ``token_type_embed`` split over
  rows: each is a masked lookup of this rank's rows summed over
  ``model`` (exactly one rank contributes each row, so it is exact; a
  rank that holds none of the used positions contributes zeros), and the
  three are added in the unsplit order;
* the tied decoder: vocab-parallel logits ``h @ word_embed_block.T`` and
  an fp32 log-softmax through a max and two sums over ``model``; the
  full-vocab logits are never gathered.

A table whose rows ``model`` does not divide arrives whole
(`sharding._prune_spec` replicates it) and takes the unsplit lookup and
decoder, while the layers stay split; a layer whose weights do not split
on head boundaries is computed whole on every rank from its gathered
weights. Unsplit, the forward is the single-card one.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..base import resolve_device
from ..parallel import collectives as _coll
from ..parallel.flash_attention import flash_attention
from .llama import _model_split, _whole

__all__ = ["BertConfig", "CONFIGS", "bert_init", "bert_forward",
           "bert_mlm_loss", "layer_norm"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    max_seq_len: int = 512
    n_types: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False

    @property
    def head_dim(self):
        return self.dim // self.n_heads


CONFIGS = {
    "bert_base": BertConfig(),
    "bert_large": BertConfig(dim=1024, n_layers=24, n_heads=16,
                             hidden_dim=4096),
    "bert_tiny": BertConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                            hidden_dim=128, max_seq_len=128),
}


def bert_init(generator, cfg: BertConfig, device=None):
    """Random parameters from `generator` (drawn on its device, moved to
    `device`, default cuda): embeddings N(0, 0.02^2), projections
    N(0, 1/fan_in), biases 0, layernorm gamma 1 and beta 0 in fp32."""
    device = resolve_device(device)
    d = cfg.dim

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * scale
        return w.to(device=device, dtype=cfg.dtype)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=device)

    def norm():
        return {"gamma": torch.ones(d, dtype=torch.float32, device=device),
                "beta": torch.zeros(d, dtype=torch.float32, device=device)}

    params = {"word_embed": dense((cfg.vocab_size, d), 0.02),
              "position_embed": dense((cfg.max_seq_len, d), 0.02),
              "token_type_embed": dense((cfg.n_types, d), 0.02),
              "embed_norm": norm(), "layers": {}}
    for i in range(cfg.n_layers):
        params["layers"][str(i)] = {
            "attn": {"wq": dense((d, d)), "wk": dense((d, d)),
                     "wv": dense((d, d)), "wo": dense((d, d)),
                     "bq": zeros(d), "bk": zeros(d), "bv": zeros(d),
                     "bo": zeros(d)},
            "attn_norm": norm(),
            "ffn": {"w1": dense((d, cfg.hidden_dim)),
                    "b1": zeros(cfg.hidden_dim),
                    "w2": dense((cfg.hidden_dim, d)), "b2": zeros(d)},
            "ffn_norm": norm(),
        }
    return params


def layer_norm(x, p, eps):
    """Normalized, scaled and shifted in fp32, then cast to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["gamma"]
            + p["beta"]).to(x.dtype)


def _encoder_layer(lp, x, cfg, tp=None):
    if tp is not None:
        return _ffn_split(lp, _attention_split(lp, x, cfg, tp), cfg, tp)
    B, S, _ = x.shape
    a = lp["attn"]

    def heads(w, b):
        return (x @ w + b).reshape(B, S, cfg.n_heads,
                                   cfg.head_dim).transpose(1, 2).contiguous()

    o = flash_attention(heads(a["wq"], a["bq"]), heads(a["wk"], a["bk"]),
                        heads(a["wv"], a["bv"]), causal=False)
    o = o.transpose(1, 2).reshape(B, S, -1)
    x = layer_norm(x + (o @ a["wo"] + a["bo"]), lp["attn_norm"], cfg.norm_eps)
    f = lp["ffn"]
    h = F.gelu(x @ f["w1"] + f["b1"], approximate="tanh")
    return layer_norm(x + (h @ f["w2"] + f["b2"]), lp["ffn_norm"],
                      cfg.norm_eps)


def _attention_split(lp, x, cfg, tp):
    """The attention block, its residual and LayerNorm: Megatron over
    ``model`` when wq/wk/wv (columns) and wo (rows) arrive as matching
    head-aligned blocks, else computed whole on every rank."""
    a = lp["attn"]
    B, S, D = x.shape
    hd = cfg.head_dim
    n = a["wq"].shape[1]
    aligned = (n != D and n % hd == 0 and a["wk"].shape[1] == n
               and a["wv"].shape[1] == n and a["wo"].shape[0] == n)
    if aligned:
        xf = _coll.copy_to_group(x, tp.group)
        lo = tp.rank * n

        def heads(w, b):
            b = _coll.copy_to_group(b, tp.group).narrow(0, lo, n)
            return (xf @ w + b).reshape(
                B, S, n // hd, hd).transpose(1, 2).contiguous()

        o = flash_attention(heads(a["wq"], a["bq"]), heads(a["wk"], a["bk"]),
                            heads(a["wv"], a["bv"]), causal=False)
        out = _coll.reduce_from_group(
            o.transpose(1, 2).reshape(B, S, n) @ a["wo"], tp.group)
    else:
        def heads(w, b):
            return (x @ _whole(w, tp, 1, D) + b).reshape(
                B, S, cfg.n_heads, hd).transpose(1, 2).contiguous()

        o = flash_attention(heads(a["wq"], a["bq"]), heads(a["wk"], a["bk"]),
                            heads(a["wv"], a["bv"]), causal=False)
        out = o.transpose(1, 2).reshape(B, S, D) @ _whole(a["wo"], tp, 0, D)
    return layer_norm(x + (out + a["bo"]), lp["attn_norm"], cfg.norm_eps)


def _ffn_split(lp, x, cfg, tp):
    """The FFN, its residual and LayerNorm: Megatron over ``model`` when
    w1 (columns) and w2 (rows) arrive as matching blocks, else whole."""
    f = lp["ffn"]
    full = cfg.hidden_dim
    n = f["w1"].shape[1]
    if n != full and f["w2"].shape[0] == n:
        xf = _coll.copy_to_group(x, tp.group)
        b1 = _coll.copy_to_group(f["b1"], tp.group).narrow(
            0, tp.rank * n, n)
        h = F.gelu(xf @ f["w1"] + b1, approximate="tanh")
        out = _coll.reduce_from_group(h @ f["w2"], tp.group)
    else:
        h = F.gelu(x @ _whole(f["w1"], tp, 1, full) + f["b1"],
                   approximate="tanh")
        out = h @ _whole(f["w2"], tp, 0, full)
    return layer_norm(x + (out + f["b2"]), lp["ffn_norm"], cfg.norm_eps)


def _rows(table, idx, full, tp):
    """Rows `idx` of an embedding table: under a ``model`` split of its
    `full` rows, this rank's block masked and summed over ``model``."""
    if tp is None or table.shape[0] == full:
        return table[idx]
    n = table.shape[0]
    local = idx - tp.rank * n
    mine = ((local >= 0) & (local < n))[..., None]
    rows = torch.where(mine, table[local.clamp(0, n - 1)],
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))
    return _coll.reduce_from_group(rows, tp.group)


def bert_forward(params, tokens, cfg: BertConfig, token_types=None):
    """tokens (B, S) int -> hidden states (B, S, D) in cfg.dtype (under a
    ``model`` split, the same on every rank of the axis)."""
    emb = params["word_embed"]
    dev = emb.device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    S = tokens.shape[1]
    tp = _model_split()
    x = _rows(emb, tokens, cfg.vocab_size, tp)
    x = x + _rows(params["position_embed"], torch.arange(S, device=dev),
                  cfg.max_seq_len, tp)[None]
    types = torch.zeros((), dtype=torch.long, device=dev) \
        if token_types is None \
        else torch.as_tensor(token_types, dtype=torch.long, device=dev)
    t = _rows(params["token_type_embed"], types, cfg.n_types, tp)
    x = x + (t[None, None] if token_types is None else t)
    x = layer_norm(x, params["embed_norm"], cfg.norm_eps)
    for i in range(cfg.n_layers):
        lp = params["layers"][str(i)]
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_encoder_layer, lp, x, cfg, tp,
                           use_reentrant=False)
        else:
            x = _encoder_layer(lp, x, cfg, tp)
    return x


def bert_mlm_loss(params, batch, cfg: BertConfig):
    """Masked-LM loss with the decoder tied to the word embedding (hidden @
    word_embed.T, fp32 log-softmax). batch = {"tokens", "targets", "mask"},
    each (B, S); mask is 1 at the prediction sites. The mean NLL over
    them; inside a data-parallel step, over every rank's sites
    (`collectives.batch_ratio`), as the reference's one program takes it.
    Under a ``model`` split of the word embedding's rows the logits are
    vocab-parallel (see the module docstring).
    """
    h = bert_forward(params, batch["tokens"], cfg)
    dev = h.device
    emb = params["word_embed"]
    targets = torch.as_tensor(batch["targets"], dtype=torch.long, device=dev)
    mask = torch.as_tensor(batch["mask"], device=dev).float()
    tp = _model_split()
    if tp is None or emb.shape[0] == cfg.vocab_size:
        logits = (h @ emb.T.to(h.dtype)).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        return _coll.batch_ratio((nll * mask).sum(), mask.sum())
    # vocab-parallel: the max, the sum of exponentials and the target's
    # shifted logit reduced over ``model`` (log_softmax's own max is cut
    # from the graph, as here)
    hf = _coll.copy_to_group(h, tp.group)
    logits = (hf @ emb.T.to(h.dtype)).float()
    vl = logits.shape[-1]
    top = _coll.all_reduce_max(logits.max(dim=-1, keepdim=True).values,
                               tp.group)
    shifted = logits - top
    total = _coll.reduce_from_group(shifted.exp().sum(dim=-1), tp.group)
    local = targets - tp.rank * vl
    mine = (local >= 0) & (local < vl)
    pick = shifted.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    pick = _coll.reduce_from_group(pick * mine, tp.group)
    nll = torch.log(total) - pick
    return _coll.batch_ratio((nll * mask).sum(), mask.sum())
