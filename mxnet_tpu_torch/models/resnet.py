"""Functional ResNet (v1 bottleneck), the port of `mxnet_tpu.models.resnet`
(the model of `bench.py`'s functional benchmark): a parameter tree of
plain tensors and NHWC activations, convolution weights HWIO, BatchNorm
statistics in fp32, XLA's "SAME" padding (the odd pixel on the high
side). Plain PyTorch: the reference computes it in XLA with no kernel of
its own. `models.convert.params_from_jax` carries a reference tree over.

`_bn` normalizes over the batch it is given. No data-parallel path of the
port reaches it: `parallel.ShardedTrainStep` takes a scalar loss, and
`resnet_loss` returns its batch statistics beside the loss for the
caller's `update_running_stats`; the global statistics of a data-mesh
step belong to `gluon.FusedTrainStep` (`collectives.batch_stats_scope`).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..base import resolve_device

__all__ = ["ResNetConfig", "CONFIGS", "resnet_init", "resnet_forward",
           "resnet_loss", "update_running_stats"]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: tuple = (3, 4, 6, 3)          # resnet50
    channels: tuple = (64, 256, 512, 1024, 2048)
    classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5


CONFIGS = {
    "resnet50": ResNetConfig(),
    "resnet101": ResNetConfig(layers=(3, 4, 23, 3)),
    "resnet152": ResNetConfig(layers=(3, 8, 36, 3)),
    "resnet_tiny": ResNetConfig(layers=(1, 1), channels=(8, 16, 32),
                                classes=10),
}


def resnet_init(generator, cfg: ResNetConfig, device=None):
    """Random parameters from `generator` (a `torch.Generator`; drawn on
    its device, then moved to `device`, which defaults to cuda), in the
    reference's layout: He-normal HWIO convolutions, BatchNorm
    {gamma, beta, mean, var} in fp32, fc {w (C, classes), b}."""
    device = resolve_device(device)

    def conv(kh, kw, cin, cout):
        std = math.sqrt(2.0 / (kh * kw * cin))
        w = torch.randn((kh, kw, cin, cout), generator=generator,
                        device=generator.device) * std
        return w.to(device=device, dtype=cfg.dtype)

    def bn(c):
        def f(v):
            return torch.full((c,), v, dtype=torch.float32, device=device)
        return {"gamma": f(1.0), "beta": f(0.0), "mean": f(0.0),
                "var": f(1.0)}

    ch = cfg.channels
    params = {"stem": {"conv": conv(7, 7, 3, ch[0]), "bn": bn(ch[0])},
              "stages": {},
              "fc": {"w": conv(1, 1, ch[-1], cfg.classes)[0, 0],
                     "b": torch.zeros((cfg.classes,), dtype=cfg.dtype,
                                      device=device)}}
    cin = ch[0]
    for si, n_blocks in enumerate(cfg.layers):
        cout = ch[si + 1]
        mid = cout // 4
        stage = {}
        for bi in range(n_blocks):
            blk = {"conv1": conv(1, 1, cin, mid), "bn1": bn(mid),
                   "conv2": conv(3, 3, mid, mid), "bn2": bn(mid),
                   "conv3": conv(1, 1, mid, cout), "bn3": bn(cout)}
            if bi == 0:
                blk["down_conv"] = conv(1, 1, cin, cout)
                blk["down_bn"] = bn(cout)
            stage[str(bi)] = blk
            cin = cout
        params["stages"][str(si)] = stage
    return params


def _same_pad(size, k, stride):
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _nchw_same(x, kh, kw, stride, value=0.0):
    """An NHWC tensor as an NCHW view, padded "SAME" for a kh x kw window
    at `stride`."""
    x = x.permute(0, 3, 1, 2)
    (hl, hh), (wl, wh) = (_same_pad(x.shape[2], kh, stride),
                          _same_pad(x.shape[3], kw, stride))
    if hl or hh or wl or wh:
        x = F.pad(x, (wl, wh, hl, hh), value=value)
    return x


def _conv(x, w, stride=1):
    kh, kw = w.shape[0], w.shape[1]
    y = F.conv2d(_nchw_same(x, kh, kw, stride), w.permute(3, 2, 0, 1),
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def _bn(x, p, cfg, train):
    xf = x.float()
    if train:
        mu = xf.mean(dim=(0, 1, 2))
        var = xf.var(dim=(0, 1, 2), unbiased=False)
        stats = (mu, var)
    else:
        mu, var = p["mean"], p["var"]
        stats = None
    y = (xf - mu) * torch.rsqrt(var + cfg.bn_eps) * p["gamma"] + p["beta"]
    return y.to(x.dtype), stats


def _bottleneck(x, blk, cfg, train, stride, stats_out, prefix):
    def conv_bn(inp, conv, bn, s=1):
        out, st = _bn(_conv(inp, blk[conv], s), blk[bn], cfg, train)
        if train:
            stats_out[prefix + "/" + bn] = st
        return out
    out = torch.relu(conv_bn(x, "conv1", "bn1"))
    out = torch.relu(conv_bn(out, "conv2", "bn2", stride))
    out = conv_bn(out, "conv3", "bn3")
    if "down_conv" in blk:
        x = conv_bn(x, "down_conv", "down_bn", stride)
    return torch.relu(out + x)


def resnet_forward(params, images, cfg: ResNetConfig, train=False):
    """images (B, H, W, 3) -> (logits (B, classes) fp32, batch statistics).
    In train mode the statistics map "stem/bn" and "stages/si/bi/bnX" to
    (batch mean, batch variance) for `update_running_stats`."""
    stats = {}
    x = images.to(cfg.dtype)
    x, s = _bn(_conv(x, params["stem"]["conv"], 2), params["stem"]["bn"],
               cfg, train)
    if train:
        stats["stem/bn"] = s
    x = torch.relu(x)
    x = F.max_pool2d(_nchw_same(x, 3, 3, 2, float("-inf")), 3, 2)
    x = x.permute(0, 2, 3, 1)
    for si in range(len(cfg.layers)):
        stage = params["stages"][str(si)]
        for bi in range(cfg.layers[si]):
            stride = 2 if (bi == 0 and si > 0) else 1
            x = _bottleneck(x, stage[str(bi)], cfg, train, stride, stats,
                            "stages/%d/%d" % (si, bi))
    x = x.float().mean(dim=(1, 2))
    logits = x @ params["fc"]["w"].float() + params["fc"]["b"].float()
    return logits, stats


def resnet_loss(params, batch, cfg: ResNetConfig):
    """Mean softmax cross-entropy of batch["images"] against
    batch["labels"] in train mode: (loss, batch statistics)."""
    logits, stats = resnet_forward(params, batch["images"], cfg, train=True)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return nll.mean(), stats


def update_running_stats(params, stats, cfg: ResNetConfig):
    """Move each BatchNorm's running mean and variance toward the batch
    statistics of `resnet_loss` (m * running + (1 - m) * batch, the
    statistics cut from the graph); returns `params`, updated in place."""
    m = cfg.bn_momentum
    for key, (mu, var) in stats.items():
        parts = key.split("/")
        if parts[0] == "stem":
            bn = params["stem"][parts[1]]
        else:
            bn = params["stages"][parts[1]][parts[2]][parts[3]]
        bn["mean"] = m * bn["mean"] + (1 - m) * mu.detach()
        bn["var"] = m * bn["var"] + (1 - m) * var.detach()
    return params
