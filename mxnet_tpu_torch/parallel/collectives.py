"""Row dedup of sparse slabs (the port of `merge_unique_rows` from
`mxnet_tpu.parallel.collectives`).

The mesh collectives of that module (`all_gather_rows`,
`psum_unique_rows`, the dense all-reduce benchmarks) come with the port's
multi-rank communication slice.
"""
from __future__ import annotations

import torch

from ..ops import sparse_ops as _sops

__all__ = ["merge_unique_rows"]

_SENTINEL = 2 ** 31 - 1


def merge_unique_rows(ids, vals, pad_id=-1):
    """Sum the rows of duplicate ids in an ``(n,)`` / ``(n, *row)`` slab;
    negative ids are padding. Returns ``(out_ids, out_vals)`` of the same
    shapes: the unique real rows first, ids ascending, then `pad_id` and
    zero rows. A stable sort by id, the starts of its runs, and one
    `segment_sum` into n slots, so duplicates add in occurrence order."""
    n = ids.shape[0]
    ids32 = ids.to(torch.int32)
    valid = ids32 >= 0
    key = torch.where(valid, ids32, _SENTINEL)
    sk, order = torch.sort(key, stable=True)
    sv = vals[order]
    svalid = sk != _SENTINEL
    starts = torch.ones_like(svalid)
    starts[1:] = sk[1:] != sk[:-1]
    starts &= svalid
    seg = torch.cumsum(starts, 0, dtype=torch.int32) - 1
    # pad rows go to the last slot with zeroed values: with at least one
    # pad row there are fewer than n real segments, so the last slot is
    # then no real segment; without one, it may be
    seg = torch.where(svalid, seg, n - 1)
    mask = svalid.reshape((n,) + (1,) * (sv.dim() - 1))
    merged = _sops.segment_sum(torch.where(mask, sv, torch.zeros_like(sv)),
                               seg, n)
    out_ids = torch.full((n,), pad_id, dtype=torch.int32, device=ids.device)
    out_ids[seg.long()] = torch.where(svalid, sk, pad_id).to(torch.int32)
    return out_ids, merged.to(vals.dtype)
