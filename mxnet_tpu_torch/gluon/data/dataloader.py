"""DataLoader: mini-batches from a dataset, in the main process or in
worker processes (the port of `mxnet_tpu.gluon.data.dataloader`).

The batch sampler runs in the main process, so the order of the batches is
the sampler's. With ``num_workers > 0`` a **spawn** pool builds the
batches: each worker imports the port afresh, takes the CPU as its default
context and never touches CUDA (the dataset and its transforms must
pickle). A worker writes each batch's arrays into POSIX shared memory
(`_batch_to_shm`) and sends their names; the main process copies them out
and unlinks the segments (`_batch_from_shm`), and an abandoned iterator
unlinks the batches it never read (`_discard_shm`). ``thread_pool=True``
builds the batches in threads of the main process instead. A worker that
dies or hangs raises after `timeout` seconds; nothing falls back to
``num_workers=0``.

Batches come out on the host (`cpu()`), as in the reference; the caller
moves them (`as_in_context(gpu(0))`). ``pin_memory`` is accepted and
ignored, as in the reference.
"""
from __future__ import annotations

import multiprocessing
import pickle
import random

import numpy as _np
import torch

from ... import ndarray as nd
from ... import random as _mx_random
from ...context import Context, cpu
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack the samples into a batch on the host: NDArrays with `stack`,
    tuples field by field, anything else through numpy."""
    if isinstance(data[0], nd.NDArray):
        return nd.stack(*data, axis=0)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = _np.asarray(data)
    return nd.array(data, ctx=cpu(), dtype=data.dtype)


def default_mp_batchify_fn(data):
    """The workers' batchify: numpy arrays, which go to the main process
    through shared memory."""
    if isinstance(data[0], nd.NDArray):
        t = torch.stack([d.data_torch for d in data]).cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_mp_batchify_fn(i) for i in data]
    return _np.asarray(data)


_worker_dataset = None


def _worker_initializer(dataset):
    """Each worker's start: the dataset, and the CPU as the default
    context (in a thread of the thread pool, too: the context is per
    thread). A spawned process also runs torch on one thread, as the
    workers share the host's cores, and seeds the port's generator from
    its own `random` state (seeded by the OS at spawn) so that the workers
    do not draw the same numbers."""
    global _worker_dataset
    _worker_dataset = dataset
    Context._default_ctx.value = cpu()
    if multiprocessing.parent_process() is not None:
        torch.set_num_threads(1)
        _mx_random.seed(random.getrandbits(31))


class _ShmBatch:
    """A batch in POSIX shared memory: (name, shape, dtype) per array and
    the nesting of the arrays."""
    __slots__ = ("descs", "fmt")

    def __init__(self, descs, fmt):
        self.descs = descs
        self.fmt = fmt


def _flatten_np(batch):
    if isinstance(batch, _np.ndarray):
        return [batch], 0
    if isinstance(batch, (list, tuple)):
        arrays, fmt = [], []
        for b in batch:
            a, f = _flatten_np(b)
            arrays.extend(a)
            fmt.append(f)
        return arrays, fmt
    raise TypeError("shm transport expects numpy batches, got %s"
                    % type(batch))


def _regroup_np(arrays, fmt, pos=0):
    if fmt == 0:
        return arrays[pos], pos + 1
    out = []
    for f in fmt:
        item, pos = _regroup_np(arrays, f, pos)
        out.append(item)
    return out, pos


def _batch_to_shm(batch):
    """Worker side: copy each array once into a new segment. The worker
    unregisters the segment from its resource tracker: the main process
    owns it from here and unlinks it."""
    from multiprocessing import resource_tracker, shared_memory
    arrays, fmt = _flatten_np(batch)
    descs = []
    for a in arrays:
        a = _np.ascontiguousarray(a)
        shm = shared_memory.SharedMemory(create=True, size=max(1, a.nbytes))
        _np.ndarray(a.shape, a.dtype, buffer=shm.buf)[...] = a
        resource_tracker.unregister(shm._name, "shared_memory")
        descs.append((shm.name, a.shape, str(a.dtype)))
        shm.close()
    return _ShmBatch(descs, fmt)


def _discard_shm(sb):
    """Unlink a batch's segments without reading them."""
    from multiprocessing import shared_memory
    for name, _, _ in sb.descs:
        shm = shared_memory.SharedMemory(name=name)
        shm.close()
        shm.unlink()


def _batch_from_shm(sb):
    """Main-process side: copy each segment into a host tensor, then
    unmap and unlink it. The tensor owns its memory: none of it aliases a
    mapping that is gone."""
    from multiprocessing import shared_memory
    arrays = []
    for name, shape, dtype in sb.descs:
        shm = shared_memory.SharedMemory(name=name)
        view = _np.ndarray(shape, _np.dtype(dtype), buffer=shm.buf)
        t = torch.from_numpy(view).clone()
        del view
        shm.close()
        shm.unlink()
        arrays.append(nd.NDArray(t, ctx=cpu()))
    out, _ = _regroup_np(arrays, sb.fmt)
    return out


def _worker_fn(samples, batchify_fn, use_shm=False):
    batch = batchify_fn([_worker_dataset[i] for i in samples])
    if use_shm:
        return _batch_to_shm(batch)
    return batch


def _np_mode_tag(data):
    """Under `npx.set_np()` batches are `mx.np.ndarray` (the loader's own
    fresh arrays, so the retag in place is safe)."""
    from ...numpy_extension import is_np_array
    if not is_np_array():
        return data
    from ...numpy.multiarray import as_np_ndarray
    return as_np_ndarray(data)


def _as_in_context(data, ctx):
    if isinstance(data, nd.NDArray):
        return _np_mode_tag(data.as_in_context(ctx))
    if isinstance(data, _np.ndarray):
        return _np_mode_tag(nd.array(data, ctx=ctx, dtype=data.dtype))
    if isinstance(data, (list, tuple)):
        return [_as_in_context(d, ctx) for d in data]
    return data


class DataLoader:
    """Mini-batches of `dataset`: by `batch_size` with a sequential or
    shuffled sampler (``last_batch`` keep, discard or rollover), or by a
    `batch_sampler`; built in the main process (``num_workers=0``), in a
    spawn pool of `num_workers` processes, or in a thread pool."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120):
        self._pool = None
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._thread_pool = thread_pool
        self._timeout = timeout
        assert timeout > 0, "timeout must be positive"

        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless " +
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")

        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._prefetch = max(0, int(prefetch) if prefetch is not None else
                             2 * self._num_workers)
        if batchify_fn is None:
            if num_workers > 0:
                self._batchify_fn = default_mp_batchify_fn
            else:
                self._batchify_fn = default_batchify_fn
        else:
            self._batchify_fn = batchify_fn
        if self._num_workers > 0:
            if thread_pool:
                from multiprocessing.dummy import Pool as ThreadPool
                self._pool = ThreadPool(self._num_workers,
                                        initializer=_worker_initializer,
                                        initargs=(self._dataset,))
            else:
                # spawned workers start from a fresh interpreter: the
                # dataset must pickle. Say so here rather than at the
                # first batch.
                try:
                    pickle.dumps(self._dataset)
                except Exception as e:
                    raise ValueError(
                        "DataLoader(num_workers>0) ships the dataset to "
                        "spawned worker processes, which requires it to be "
                        "picklable (%s). Use a module-level transform "
                        "function instead of a lambda, or pass "
                        "thread_pool=True." % e) from e
                ctx = multiprocessing.get_context("spawn")
                self._pool = ctx.Pool(self._num_workers,
                                      initializer=_worker_initializer,
                                      initargs=(self._dataset,))

    def __iter__(self):
        if self._num_workers == 0:
            def same_process_iter():
                for batch in self._batch_sampler:
                    ret = self._batchify_fn(
                        [self._dataset[idx] for idx in batch])
                    yield _as_in_context(ret, cpu())
            return same_process_iter()
        return _MultiWorkerIter(self._pool, self._batchify_fn,
                                self._batch_sampler,
                                prefetch=self._prefetch,
                                timeout=self._timeout,
                                use_shm=not self._thread_pool)

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        if self._pool is not None:
            self._pool.terminate()


class _MultiWorkerIter:
    """The batches of a worker pool, `prefetch` of them requested ahead,
    returned in the sampler's order."""

    def __init__(self, pool, batchify_fn, batch_sampler, prefetch=0,
                 timeout=120, use_shm=False):
        self._pool = pool
        self._batchify_fn = batchify_fn
        self._batch_sampler = batch_sampler
        self._use_shm = use_shm
        self._data_buffer = {}
        self._rcvd_idx = 0
        self._sent_idx = 0
        self._iter = iter(self._batch_sampler)
        self._timeout = timeout
        for _ in range(prefetch):
            self._push_next()

    def __len__(self):
        return len(self._batch_sampler)

    def _push_next(self):
        r = next(self._iter, None)
        if r is None:
            return
        async_ret = self._pool.apply_async(
            _worker_fn, (r, self._batchify_fn, self._use_shm))
        self._data_buffer[self._sent_idx] = async_ret
        self._sent_idx += 1

    def __next__(self):
        self._push_next()
        if self._rcvd_idx == self._sent_idx:
            assert not self._data_buffer, \
                "Data buffer should be empty at this moment"
            raise StopIteration
        ret = self._data_buffer.pop(self._rcvd_idx)
        batch = ret.get(self._timeout)
        self._rcvd_idx += 1
        if isinstance(batch, _ShmBatch):
            return _np_mode_tag(_batch_from_shm(batch))
        return _as_in_context(batch, cpu())

    def __del__(self):
        # the batches requested and never read own their segments (the
        # workers unregistered them): wait for each, as long as a read
        # would, and unlink it
        for ret in self._data_buffer.values():
            try:
                batch = ret.get(self._timeout)
            except Exception:   # a worker that died or hung wrote nothing
                continue
            if isinstance(batch, _ShmBatch):
                _discard_shm(batch)
        self._data_buffer.clear()

    def next(self):
        return self.__next__()

    def __iter__(self):
        return self
