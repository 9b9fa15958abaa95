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
`bert_mlm_loss` run under the caller's grad mode. Under `BERT_RULES` on a
mesh, `parallel.ShardedTrainStep` gathers every split leaf on use, so each
rank computes the whole model on its slice of the batch (native Megatron
for BERT is ROADMAP work).
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


def _encoder_layer(lp, x, cfg):
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


def bert_forward(params, tokens, cfg: BertConfig, token_types=None):
    """tokens (B, S) int -> hidden states (B, S, D) in cfg.dtype."""
    emb = params["word_embed"]
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=emb.device)
    S = tokens.shape[1]
    x = emb[tokens] + params["position_embed"][None, :S]
    if token_types is None:
        x = x + params["token_type_embed"][0][None, None]
    else:
        x = x + params["token_type_embed"][torch.as_tensor(
            token_types, dtype=torch.long, device=emb.device)]
    x = layer_norm(x, params["embed_norm"], cfg.norm_eps)
    for i in range(cfg.n_layers):
        lp = params["layers"][str(i)]
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_encoder_layer, lp, x, cfg, use_reentrant=False)
        else:
            x = _encoder_layer(lp, x, cfg)
    return x


def bert_mlm_loss(params, batch, cfg: BertConfig):
    """Masked-LM loss with the decoder tied to the word embedding (hidden @
    word_embed.T, fp32 log-softmax). batch = {"tokens", "targets", "mask"},
    each (B, S); mask is 1 at the prediction sites. The mean NLL over
    them; inside a data-parallel step, over every rank's sites
    (`collectives.batch_ratio`), as the reference's one program takes it.
    """
    h = bert_forward(params, batch["tokens"], cfg)
    dev = h.device
    logits = (h @ params["word_embed"].T.to(h.dtype)).float()
    logp = torch.log_softmax(logits, dim=-1)
    targets = torch.as_tensor(batch["targets"], dtype=torch.long, device=dev)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    mask = torch.as_tensor(batch["mask"], device=dev).float()
    return _coll.batch_ratio((nll * mask).sum(), mask.sum())
