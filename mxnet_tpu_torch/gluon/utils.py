"""Gluon utilities (the port of `mxnet_tpu.gluon.utils`): `split_data`,
`split_and_load` (slice a batch across contexts), `clip_global_norm`,
`check_sha1`, `download` (local paths and ``file://`` URLs only: the port
has no network) and `shape_is_known`.
"""
from __future__ import annotations

import hashlib
import os

import numpy as _np

from .. import ndarray as nd

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "shape_is_known", "_indent"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split an NDArray into `num_slice` along batch_axis.
    reference: gluon/utils.py (split_data)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." %
            (str(data.shape), num_slice, batch_axis, num_slice))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    if not even_split:
        slices = []
        for i in range(num_slice):
            begin = i * step
            end = size if i == num_slice - 1 else (i + 1) * step
            slices.append(data.slice_axis(batch_axis, begin, end))
        return slices
    return [data.slice_axis(batch_axis, i * step, (i + 1) * step)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split `data` and load each slice on one context.
    reference: gluon/utils.py (split_and_load)."""
    if not isinstance(data, nd.NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [i.as_in_context(ctx) for i, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale arrays so that the sum of their 2-norms is <= max_norm.
    reference: gluon/utils.py (clip_global_norm)."""
    def _norm(array):
        if array.stype == "default":
            x = array.reshape((-1,))
            return nd.invoke("dot", x, x)
        return array.norm().square()
    assert len(arrays) > 0
    ctx = arrays[0].context
    total_norm = nd.invoke("add_n", *[_norm(arr).as_in_context(ctx)
                                      for arr in arrays])
    total_norm = total_norm.sqrt()
    if check_isfinite:
        tn = float(total_norm.asscalar())
        if not _np.isfinite(tn):
            import warnings
            warnings.warn(
                UserWarning("nan or inf is detected. Clipping results will "
                            "be undefined."), stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    scale = nd.invoke("broadcast_minimum", scale,
                      nd.ones((1,), ctx=scale.context))
    for arr in arrays:
        arr *= scale.as_in_context(arr.context)
    if check_isfinite:
        return tn
    return total_norm


def check_sha1(filename, sha1_hash):
    """Check a file against expected sha1. reference: gluon/utils.py."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    """Fetch a file to `path`: an existing file there (with the right
    sha1, where one is given), a ``file://`` URL or a local path. Anything
    else needs the network, which the port does not have: it raises."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and (
            not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    if url.startswith("file://"):
        import shutil
        shutil.copyfile(url[len("file://"):], fname)
        return fname
    if os.path.exists(url):
        import shutil
        shutil.copyfile(url, fname)
        return fname
    raise RuntimeError(
        "download('%s') requires network access, which this environment "
        "does not have. Place the file at '%s' manually." % (url, fname))


def shape_is_known(shape):
    """Whether a shape is fully known (no 0/None dims)."""
    if shape is None:
        return False
    for dim in shape:
        if not dim:
            return False
    return True


def _indent(s_, num_spaces):
    """Indent a multi-line string (for reprs)."""
    lines = s_.split("\n")
    if len(lines) == 1:
        return s_
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line for line in lines)
