"""Contrib vision and detection ops (the port of
`mxnet_tpu.ops.contrib_vision`): `arange_like`, `BilinearResize2D`,
`AdaptiveAvgPooling2D`, `ROIAlign`, the box ops (`box_iou`, `box_nms`,
`box_encode`, `box_decode`), the SSD ops (`MultiBoxPrior`,
`MultiBoxTarget`, `MultiBoxDetection`), `DeformableConvolution` and
`PSROIPooling`.

They are plain XLA in the reference, so they are plain PyTorch here, and
every one runs on the tensors' own device: nothing is copied to the host.

Two places differ in how, not in what they compute:

- `box_nms` sorts the candidates by score (a stable sort, as the
  reference's ``jnp.argsort``) and runs the greedy loop over the first
  ``k = topk`` of them. Only those rows can be kept (the reference masks
  every row past ``k`` at the end), and a row's fate depends only on the
  rows before it, so the port builds the ``k x k`` block of overlaps where
  the reference builds all ``n x n``. The results are the same; the memory
  is ``k^2`` per image, not ``n^2`` (6,132 anchors at batch 32 would take
  4.8 GB of fp32 IoU).
- `MultiBoxTarget` matches as the reference does: each valid ground-truth
  box first claims its best anchor, in label order, then every other
  anchor takes its best box when the overlap reaches the threshold. That
  is not upstream MXNet's bipartite matching; the port copies the
  reference. Hard negatives are ranked by a stable descending sort.
"""
from __future__ import annotations

import numpy as _np
import torch

from .registry import alias, register
from .tensor import div_once as _div

__all__ = []

_F32 = torch.float32


def _pair(v, n):
    if v is None:
        return (0,) * n
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v if len(v) == n else v * n


# ---------------------------------------------------------------------------
# arange_like
# ---------------------------------------------------------------------------
@register("_contrib_arange_like", differentiable=False)
def _arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """start + step * (i // repeat) over the whole array (in its shape) or
    along `axis`."""
    repeat = max(1, int(repeat))
    n = data.numel() if axis is None else data.shape[axis]
    idx = torch.div(torch.arange(n, device=data.device), repeat,
                    rounding_mode="floor")
    out = start + step * idx.to(data.dtype)
    return out.reshape(data.shape) if axis is None else out


# ---------------------------------------------------------------------------
# BilinearResize2D (NCHW, align-corners sampling)
# ---------------------------------------------------------------------------
def _linear_coords(out_size, in_size, device):
    if out_size == 1 or in_size == 1:
        src = torch.zeros(out_size, dtype=_F32, device=device)
    else:
        scale = (in_size - 1.0) / (out_size - 1.0)
        src = torch.arange(out_size, dtype=_F32, device=device) * scale
    lo = torch.floor(src).long().clamp(0, in_size - 1)
    hi = (lo + 1).clamp(0, in_size - 1)
    return lo, hi, src - lo.to(_F32)


@register("_contrib_BilinearResize2D")
def _bilinear_resize2d(data, height=None, width=None, scale_height=None,
                       scale_width=None, mode="size"):
    """Resize NCHW to (height, width) (or by the scales; 1 without
    either), interpolating in fp32 between the align-corners taps."""
    if mode != "size":
        raise NotImplementedError(
            "BilinearResize2D: mode=%r is not supported (only 'size', as in "
            "the reference)" % (mode,))
    n, c, h, w = data.shape
    oh = (int(height) if height else
          int(round(h * float(scale_height))) if scale_height else 1)
    ow = (int(width) if width else
          int(round(w * float(scale_width))) if scale_width else 1)
    f32 = data.to(_F32)
    ylo, yhi, yf = _linear_coords(oh, h, data.device)
    xlo, xhi, xf = _linear_coords(ow, w, data.device)
    top = f32[:, :, ylo, :] * (1 - yf)[None, None, :, None] + \
        f32[:, :, yhi, :] * yf[None, None, :, None]
    out = top[:, :, :, xlo] * (1 - xf)[None, None, None, :] + \
        top[:, :, :, xhi] * xf[None, None, None, :]
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# AdaptiveAvgPooling2D (summed-area table, as the reference)
# ---------------------------------------------------------------------------
@register("_contrib_AdaptiveAvgPooling2D")
def _adaptive_avg_pool2d(data, output_size=None):
    n, c, h, w = data.shape
    if output_size is None:
        oh = ow = 1
    elif isinstance(output_size, (tuple, list)):
        oh = int(output_size[0])
        ow = int(output_size[1] if len(output_size) > 1 else output_size[0])
    else:
        oh = ow = int(output_size)
    f32 = data.to(_F32)
    sat = torch.nn.functional.pad(f32.cumsum(2).cumsum(3), (1, 0, 1, 0))
    h0 = (_np.arange(oh) * h) // oh
    h1 = -(-(_np.arange(1, oh + 1) * h) // oh)
    w0 = (_np.arange(ow) * w) // ow
    w1 = -(-(_np.arange(1, ow + 1) * w) // ow)
    area = torch.from_numpy(((h1 - h0)[:, None] * (w1 - w0)[None, :])
                            .astype(_np.float32)).to(data.device)

    def at(rows, cols):
        r = torch.from_numpy(rows).to(data.device)
        q = torch.from_numpy(cols).to(data.device)
        return sat[:, :, r][:, :, :, q]

    out = at(h1, w1) - at(h0, w1) - at(h1, w0) + at(h0, w0)
    return (out / area[None, None]).to(data.dtype)


# ---------------------------------------------------------------------------
# ROIAlign: NCHW features, rois (R, 5) = [batch, x1, y1, x2, y2]
# ---------------------------------------------------------------------------
def _gather_rows_cols(img, rows, cols):
    """img (R, C, H, W), rows (R, P), cols (R, Q) -> (R, C, P, Q)."""
    r, c, h, w = img.shape
    t = torch.gather(img, 2, rows[:, None, :, None].expand(r, c, -1, w))
    return torch.gather(t, 3, cols[:, None, None, :].expand(
        r, c, t.shape[2], -1))


@register("_contrib_ROIAlign", arity=2)
def _roi_align(data, rois, pooled_size=None, spatial_scale=1.0,
               sample_ratio=-1, position_sensitive=False, aligned=False):
    """Each roi's (ph, pw) cells, each the mean of s x s bilinear taps
    (s = sample_ratio, 2 when <= 0); taps outside [-1, size] read 0 and
    taps inside that band clamp to the border."""
    if position_sensitive:
        raise NotImplementedError("ROIAlign: position_sensitive=True")
    ph, pw = (int(pooled_size[0]), int(pooled_size[1])) \
        if isinstance(pooled_size, (tuple, list)) else \
        (int(pooled_size), int(pooled_size))
    s = 2 if sample_ratio is None or sample_ratio <= 0 else int(sample_ratio)
    n, c, h, w = data.shape
    f32 = data.to(_F32)
    dev = data.device
    offset = 0.5 if aligned else 0.0
    r = rois.to(_F32)
    bidx = r[:, 0].long()
    x1 = r[:, 1] * spatial_scale - offset
    y1 = r[:, 2] * spatial_scale - offset
    x2 = r[:, 3] * spatial_scale - offset
    y2 = r[:, 4] * spatial_scale - offset
    floor_ = 1e-6 if aligned else 1.0
    rw = torch.clamp(x2 - x1, min=floor_)
    rh = torch.clamp(y2 - y1, min=floor_)
    bh, bw = _div(rh, ph), _div(rw, pw)
    ys = y1[:, None] + (torch.arange(ph * s, dtype=_F32, device=dev)
                        + 0.5)[None] * _div(bh, s)[:, None]
    xs = x1[:, None] + (torch.arange(pw * s, dtype=_F32, device=dev)
                        + 0.5)[None] * _div(bw, s)[:, None]
    yok = ((ys >= -1.0) & (ys <= h)).to(_F32)
    xok = ((xs >= -1.0) & (xs <= w)).to(_F32)
    ysc = ys.clamp(0, h - 1)
    xsc = xs.clamp(0, w - 1)
    y0 = torch.floor(ysc).long()
    x0 = torch.floor(xsc).long()
    y1i = (y0 + 1).clamp(0, h - 1)
    x1i = (x0 + 1).clamp(0, w - 1)
    yf = ysc - y0.to(_F32)
    xf = xsc - x0.to(_F32)
    img = f32[bidx]                                        # (R, C, H, W)
    full = torch.arange(w, device=dev)[None].expand(len(r), w)
    top = _gather_rows_cols(img, y0, full) * (1 - yf)[:, None, :, None] + \
        _gather_rows_cols(img, y1i, full) * yf[:, None, :, None]
    val = torch.gather(top, 3, x0[:, None, None, :].expand(
        -1, c, ph * s, -1)) * (1 - xf)[:, None, None, :] + \
        torch.gather(top, 3, x1i[:, None, None, :].expand(
            -1, c, ph * s, -1)) * xf[:, None, None, :]
    val = val * (yok[:, :, None] * xok[:, None, :])[:, None]
    val = val.reshape(len(r), c, ph, s, pw, s).mean(dim=(3, 5))
    return val.to(data.dtype)


# ---------------------------------------------------------------------------
# bounding boxes
# ---------------------------------------------------------------------------
def _pair_iou(a, b):
    """a: (..., N, 4), b: (..., M, 4) corner boxes -> IoU (..., N, M)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union,
                       torch.zeros((), dtype=inter.dtype,
                                   device=inter.device))


def _to_corner(x):
    xc, yc, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2],
                       dim=-1)


def _to_center(x):
    x1, y1, x2, y2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2,
                        torch.clamp(x2 - x1, min=0.0),
                        torch.clamp(y2 - y1, min=0.0)], dim=-1)


@register("_contrib_box_iou", arity=2, differentiable=False)
def _box_iou(lhs, rhs, format="corner"):
    a, b = lhs.to(_F32), rhs.to(_F32)
    if format == "center":
        a, b = _to_corner(a), _to_corner(b)
    return _pair_iou(a, b)


@register("_contrib_box_nms", differentiable=False)
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, force_suppress=False,
             in_format="corner", out_format="corner", background_id=-1):
    """Greedy NMS in score order (stable); rows come out sorted, and a
    suppressed or invalid row, or one past `topk`, gets score -1. Only the
    first k = topk rows can survive, so the greedy loop runs over their
    k x k overlaps alone, on the data's device."""
    if out_format != in_format:
        raise NotImplementedError("box_nms: in/out format conversion")
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    b, n, width = data.shape
    dev = data.device
    f32 = data.to(_F32)
    scores = f32[:, :, score_index]
    boxes = f32[:, :, coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _to_corner(boxes)
    has_id = id_index is not None and id_index >= 0
    ids = f32[:, :, id_index] if has_id else torch.zeros(
        (b, n), dtype=_F32, device=dev)
    valid = scores > valid_thresh
    if has_id and background_id >= 0:
        valid = valid & (ids != background_id)
    order = torch.argsort(-torch.where(
        valid, scores, torch.full((), float("-inf"), device=dev)),
        dim=1, stable=True)
    k = n if topk is None or topk <= 0 else min(int(topk), n)

    top = order[:, :k]
    sb = torch.gather(boxes, 1, top[..., None].expand(b, k, 4))
    sv = torch.gather(valid, 1, top)
    sid = torch.gather(ids, 1, top)
    later = torch.ones((k, k), dtype=torch.bool, device=dev).triu(1)
    sup = (_pair_iou(sb, sb) > overlap_thresh) & later
    if not force_suppress:
        sup = sup & (sid[:, :, None] == sid[:, None, :])
    keep = sv.clone()
    for i in range(k):
        # row i, if still kept, drops every later row it suppresses
        keep &= ~(sup[:, i, :] & keep[:, i:i + 1])
    keep = torch.cat([keep, torch.zeros((b, n - k), dtype=torch.bool,
                                        device=dev)], dim=1)

    out = torch.gather(f32, 1, order[..., None].expand(b, n, width))
    out[:, :, score_index] = torch.where(
        keep, out[:, :, score_index], torch.full((), -1.0, device=dev))
    out = out.to(data.dtype)
    return out[0] if squeeze else out


@register("_contrib_box_encode", arity=6, differentiable=False)
def _box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
                stds=(0.1, 0.1, 0.2, 0.2)):
    """Corner anchors and matched corner refs -> normalized center-form
    offsets, masked where samples <= 0.5; returns (targets, mask) with the
    mask's last axis 1, as the reference's."""
    a = _to_center(anchors.to(_F32))
    idx = matches.long()
    idx = torch.where(idx < 0, idx + refs.shape[1], idx)
    r = refs.to(_F32)
    lead = torch.broadcast_shapes(idx.shape[:-1], r.shape[:-2])
    idx = idx.expand(lead + idx.shape[-1:])
    r = r.expand(lead + r.shape[-2:])
    g = _to_center(torch.gather(r, -2, idx[..., None].expand(
        idx.shape + (4,))))
    t = torch.stack([(g[..., 0] - a[..., 0]) / a[..., 2],
                     (g[..., 1] - a[..., 1]) / a[..., 3],
                     torch.log(torch.clamp(g[..., 2] / a[..., 2],
                                           min=1e-12)),
                     torch.log(torch.clamp(g[..., 3] / a[..., 3],
                                           min=1e-12))], dim=-1)
    t = (t - torch.tensor(means, dtype=_F32, device=t.device)) / \
        torch.tensor(stds, dtype=_F32, device=t.device)
    mask = (samples[..., None] > 0.5).to(_F32)
    return t * mask, mask


@register("_contrib_box_decode", arity=2, differentiable=False)
def _box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
                clip=-1.0, format="corner"):
    """Offsets against anchors (corner, or center with format="center")
    -> corner boxes; the log-size offsets are capped at `clip` when it is
    positive."""
    a = anchors.to(_F32)
    if format == "corner":
        a = _to_center(a)
    d = data.to(_F32)
    x = d[..., 0] * std0 * a[..., 2] + a[..., 0]
    y = d[..., 1] * std1 * a[..., 3] + a[..., 1]
    dw = d[..., 2] * std2
    dh = d[..., 3] * std3
    if clip is not None and clip > 0:
        dw = torch.clamp(dw, max=clip)
        dh = torch.clamp(dh, max=clip)
    w = torch.exp(dw) * a[..., 2] / 2
    h = torch.exp(dh) * a[..., 3] / 2
    return torch.stack([x - w, y - h, x + w, y + h], dim=-1).to(data.dtype)


alias("_contrib_BilinearResize2D", "_contrib_bilinear_resize2d")
alias("_contrib_AdaptiveAvgPooling2D", "_contrib_adaptive_avg_pooling2d")


# ---------------------------------------------------------------------------
# the SSD ops: anchors, target matching, decode + NMS
# ---------------------------------------------------------------------------
@register("_contrib_MultiBoxPrior", differentiable=False)
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors of one feature map, read as NCHW (H = shape[2], W =
    shape[3]): (1, H*W*A, 4) corner boxes, A = len(sizes) + len(ratios) - 1,
    cell-major; in each cell every size at ratios[0], then ratios[1:] at
    sizes[0]. Widths carry the H/W aspect correction."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    sizes = [float(s) for s in sizes]
    ratios = [float(r) for r in ratios]
    step_y = 1.0 / h if steps is None or steps[0] <= 0 else float(steps[0])
    step_x = 1.0 / w if steps is None or steps[1] <= 0 else float(steps[1])
    cy = (torch.arange(h, dtype=_F32, device=dev) + float(offsets[0])) \
        * step_y
    cx = (torch.arange(w, dtype=_F32, device=dev) + float(offsets[1])) \
        * step_x
    aspect = float(h) / float(w)
    wh = []
    for s in sizes:
        sr = _np.sqrt(ratios[0])
        wh.append((s * aspect * sr / 2.0, s / sr / 2.0))
    for r in ratios[1:]:
        sr = _np.sqrt(r)
        wh.append((sizes[0] * aspect * sr / 2.0, sizes[0] / sr / 2.0))
    wh = torch.from_numpy(_np.asarray(wh, _np.float32)).to(dev)
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    ctr = torch.stack([gx, gy], dim=-1).reshape(h * w, 1, 2)
    boxes = torch.cat([ctr - wh[None], ctr + wh[None]], dim=-1)
    boxes = boxes.reshape(1, -1, 4)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes


def _as_index_tensor(like, value, dtype=torch.long):
    return torch.full((), value, dtype=dtype, device=like.device)


@register("_contrib_MultiBoxTarget", arity=3, differentiable=False,
          num_outputs=3)
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets. anchor (1, N, 4) corner; label (B, M, 5)
    [cls, x1, y1, x2, y2], padded with cls -1; cls_pred (B, C+1, N), read
    only for hard-negative mining (class 0's column). Returns box_target
    (B, N*4), box_mask (B, N*4) and cls_target (B, N): 0 for background,
    class + 1 for a match, `ignore_label` for a negative not mined."""
    dev = anchor.device
    a = anchor.to(_F32).reshape(-1, 4)
    n = a.shape[0]
    lab = label.to(_F32)
    if lab.dim() == 2:
        lab = lab[None]
    b, m, _ = lab.shape
    gt_cls = lab[..., 0]
    gt_box = lab[..., 1:5]
    gt_valid = gt_cls >= 0

    iou = _pair_iou(a.expand(b, n, 4), gt_box)                  # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou,
                      torch.full((), -1.0, device=dev))

    # stage 1: each valid box with some overlap claims its best anchor,
    # in label order; an anchor already claimed stays with the first box
    best_anchor = iou.argmax(dim=1)                             # (B, M)
    has_overlap = iou.amax(dim=1) > 0
    claimed = torch.zeros((b, n), dtype=torch.bool, device=dev)
    claimed_gt = torch.full((b, n), -1, dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)
    for j in range(m):
        idx = best_anchor[:, j]
        ok = gt_valid[:, j] & has_overlap[:, j] & ~claimed[rows, idx]
        claimed[rows, idx] = claimed[rows, idx] | ok
        claimed_gt[rows, idx] = torch.where(
            ok, _as_index_tensor(idx, j), claimed_gt[rows, idx])

    # stage 2: every other anchor takes its best box at the threshold
    best_iou = iou.amax(dim=2)
    best_gt = iou.argmax(dim=2)
    match = torch.where(claimed, claimed_gt, torch.where(
        best_iou >= overlap_threshold, best_gt,
        _as_index_tensor(best_gt, -1)))
    pos = match >= 0

    mg = match.clamp(0, m - 1)
    g = torch.gather(gt_box, 1, mg[..., None].expand(b, n, 4))
    gc = _to_center(g)
    ac = _to_center(a)[None]
    v = variances
    aw = torch.clamp(ac[..., 2], min=1e-12)
    ah = torch.clamp(ac[..., 3], min=1e-12)
    t = torch.stack([
        (gc[..., 0] - ac[..., 0]) / aw / v[0],
        (gc[..., 1] - ac[..., 1]) / ah / v[1],
        torch.log(torch.clamp(gc[..., 2] / aw, min=1e-12)) / v[2],
        torch.log(torch.clamp(gc[..., 3] / ah, min=1e-12)) / v[3]], dim=-1)
    zero = torch.zeros((), dtype=_F32, device=dev)
    box_target = torch.where(pos[..., None], t, zero).reshape(b, n * 4)
    box_mask = pos[..., None].expand(b, n, 4).to(_F32).reshape(b, n * 4)

    cls_matched = torch.gather(gt_cls, 1, mg)
    cls_target = torch.where(pos, cls_matched + 1.0, zero)

    if negative_mining_ratio is not None and negative_mining_ratio > 0:
        # the ratio * positives negatives with the least background
        # probability are trained; the rest are ignored
        neg_score = -cls_pred.to(_F32)[:, 0, :]
        neg = ~pos & (best_iou < negative_mining_thresh)
        num_pos = pos.sum(dim=1, keepdim=True).to(_F32)
        quota = torch.clamp(num_pos * float(negative_mining_ratio),
                            min=float(minimum_negative_samples))
        order = torch.argsort(torch.where(
            neg, neg_score, torch.full((), float("-inf"), device=dev)),
            dim=1, descending=True, stable=True)
        rank = torch.argsort(order, dim=1, stable=True).to(_F32)
        keep_neg = neg & (rank < quota)
        cls_target = torch.where(pos | keep_neg, cls_target,
                                 torch.full((), float(ignore_label),
                                            device=dev))
    return box_target, box_mask, cls_target


@register("_contrib_MultiBoxDetection", arity=3, differentiable=False)
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode and NMS. cls_prob (B, C+1, N), loc_pred (B, N*4), anchor
    (1, N, 4) -> (B, N, 6) rows [cls_id, score, x1, y1, x2, y2] in score
    order; a suppressed or invalid row has cls_id -1."""
    p = cls_prob.to(_F32)
    b, _, n = p.shape
    loc = loc_pred.to(_F32).reshape(b, n, 4)
    v = variances
    boxes = _box_decode(loc, anchor.to(_F32).reshape(1, -1, 4),
                        std0=v[0], std1=v[1], std2=v[2], std3=v[3],
                        format="corner")
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = torch.cat([p[:, :background_id], p[:, background_id + 1:]], dim=1)
    score, _ = fg.max(dim=1)
    cls_id = fg.argmax(dim=1).to(_F32)
    valid = score > threshold
    minus = torch.full((), -1.0, device=p.device)
    rows = torch.cat([torch.where(valid, cls_id, minus)[..., None],
                      torch.where(valid, score, minus)[..., None], boxes],
                     dim=-1)
    out = _box_nms(rows, overlap_thresh=nms_threshold,
                   valid_thresh=threshold, topk=nms_topk, coord_start=2,
                   score_index=1, id_index=0, force_suppress=force_suppress)
    out[..., 0] = torch.where(out[..., 1] <= 0, minus, out[..., 0])
    return out


# ---------------------------------------------------------------------------
# DeformableConvolution and PSROIPooling
# ---------------------------------------------------------------------------
def _bilinear_gather(img, ys, xs):
    """img (N, C, H, W); ys/xs (N, Ho, Wo) fractional coordinates ->
    (N, C, Ho, Wo). A corner tap outside the image reads 0, so the value
    fades to 0 across the border."""
    n, c, h, w = img.shape
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    yf = (ys - y0f)[:, None]
    xf = (xs - x0f)[:, None]
    y0, x0 = y0f.long(), x0f.long()
    batch = torch.arange(n, device=img.device)[:, None, None]

    def corner(yi, xi):
        ok = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(_F32)
        v = img[batch, :, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return v.permute(0, 3, 1, 2) * ok[:, None]

    return (corner(y0, x0) * (1 - yf) * (1 - xf) +
            corner(y0, x0 + 1) * (1 - yf) * xf +
            corner(y0 + 1, x0) * yf * (1 - xf) +
            corner(y0 + 1, x0 + 1) * yf * xf)


@register("_contrib_DeformableConvolution", arity=3)
def _deformable_convolution(data, offset, weight, bias=None, kernel=None,
                            stride=None, dilate=None, pad=None,
                            num_filter=None, num_group=1,
                            num_deformable_group=1, no_bias=False,
                            layout=None, workspace=None):
    """data (N, C, H, W); offset (N, 2*dg*kh*kw, Ho, Wo), [y, x] per tap
    per deformable group; weight (O, C, kh, kw). Each tap samples the
    input bilinearly at its shifted position and contracts the channels."""
    from .nn import layout_info
    if num_group != 1:
        raise NotImplementedError("DeformableConvolution: num_group > 1")
    _, last = layout_info(layout, 2, "DeformableConvolution")
    if last:
        raise NotImplementedError(
            "DeformableConvolution: channels-last layouts not implemented")
    kh, kw = kernel
    stride = _pair(stride if stride else 1, 2)
    dilate = _pair(dilate if dilate else 1, 2)
    pad = _pair(pad if pad else 0, 2)
    n, c, h, w = data.shape
    ho = (h + 2 * pad[0] - (dilate[0] * (kh - 1) + 1)) // stride[0] + 1
    wo = (w + 2 * pad[1] - (dilate[1] * (kw - 1) + 1)) // stride[1] + 1
    dg = num_deformable_group
    if c % dg != 0:
        raise ValueError(
            "DeformableConvolution: channels (%d) must divide evenly into "
            "num_deformable_group (%d)" % (c, dg))
    cg = c // dg
    dev = data.device
    f32 = data.to(_F32)
    off = offset.to(_F32).reshape(n, dg, kh * kw, 2, ho, wo)
    base_y = (torch.arange(ho, device=dev) * stride[0] - pad[0])[:, None]
    base_x = (torch.arange(wo, device=dev) * stride[1] - pad[1])[None, :]
    out = torch.zeros((n, num_filter, ho, wo), dtype=_F32, device=dev)
    wgt = weight.to(_F32)
    for k in range(kh * kw):
        ky, kx = k // kw, k % kw
        for g in range(dg):
            ys = base_y + ky * dilate[0] + off[:, g, k, 0]
            xs = base_x + kx * dilate[1] + off[:, g, k, 1]
            sampled = _bilinear_gather(f32[:, g * cg:(g + 1) * cg], ys, xs)
            out = out + torch.einsum("nchw,oc->nohw", sampled,
                                     wgt[:, g * cg:(g + 1) * cg, ky, kx])
    if bias is not None and not no_bias:
        out = out + bias.to(_F32).reshape(1, -1, 1, 1)
    return out.to(data.dtype)


@register("_contrib_PSROIPooling", arity=2)
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=None,
                   pooled_size=None, group_size=None):
    """Position-sensitive ROI pooling: data (N, output_dim*ps*ps, H, W),
    rois (R, 5) -> (R, output_dim, ps, ps); bin (i, j) averages its own
    channel slice over its window (ends rounded half away from zero, the
    end pixel included)."""
    ps = int(pooled_size)
    if group_size is not None and int(group_size) != ps:
        raise NotImplementedError("PSROIPooling: group_size != pooled_size")
    n, ctot, h, w = data.shape
    od = int(output_dim)
    dev = data.device
    f32 = data.to(_F32).reshape(n, od, ps, ps, h, w)
    r = rois.to(_F32)
    bidx = r[:, 0].long()
    x1 = torch.floor(r[:, 1] + 0.5) * spatial_scale
    y1 = torch.floor(r[:, 2] + 0.5) * spatial_scale
    x2 = (torch.floor(r[:, 3] + 0.5) + 1.0) * spatial_scale
    y2 = (torch.floor(r[:, 4] + 0.5) + 1.0) * spatial_scale
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bh, bw = _div(rh, ps)[:, None], _div(rw, ps)[:, None]
    i = torch.arange(ps, dtype=_F32, device=dev)[None]
    hs = torch.floor(y1[:, None] + i * bh)
    he = torch.ceil(y1[:, None] + (i + 1) * bh)
    ws_ = torch.floor(x1[:, None] + i * bw)
    we = torch.ceil(x1[:, None] + (i + 1) * bw)
    hh = torch.arange(h, dtype=_F32, device=dev)
    ww = torch.arange(w, dtype=_F32, device=dev)
    rmask = ((hh[None, None] >= hs[..., None]) &
             (hh[None, None] < he[..., None])).to(_F32)     # (R, ps, H)
    cmask = ((ww[None, None] >= ws_[..., None]) &
             (ww[None, None] < we[..., None])).to(_F32)     # (R, ps, W)
    num = torch.einsum("rdijhw,rih,rjw->rdij", f32[bidx], rmask, cmask)
    cnt = torch.einsum("rih,rjw->rij", rmask, cmask)
    return (num / torch.clamp(cnt, min=1.0)[:, None]).to(data.dtype)
