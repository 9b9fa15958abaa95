"""ZeRO-1 weight-update sharding over the gradient buckets (the port of
`mxnet_tpu.optimizer.zero`).

Each step becomes, per bucket of the frozen `engine.BucketLayout`:

    reduce-scatter(gradient bucket)   this rank's contiguous shard of the
                                      bucket's gradient sum
    flat update of the owned shard    one fused pass (kernels #7/#8 for
                                      SGD/Adam; #9 + norm exchange + #10
                                      for LAMB); optimizer state exists for
                                      the owned shard only
    all-gather(updated weights)       full weights back to every rank,
                                      written into the store's arrays

Per-parameter lr/wd (scheduler, lr_mult/wd_mult, Adam's bias correction)
reach the flat pass as per-element fp32 vectors, each cached on its tuple
of scalars. The exchange is injectable (`ZeroComm`): the default is world
1, where every exchange is the identity and the updater still does the
work; `kvstore.DistZeroComm` exchanges over the process group (NCCL on
the card, gloo on the CPU), and tests drive in-process fleets of threads.
The readiness-ordered entry points (`scatter_ready`, `finish_ready`) start
each bucket's reduce-scatter as backward finishes its members and run the
updates and all-gathers at step time. The integrity sentinel, fault sites
and retries of the reference come with the port's resilience work.

The shards are torch tensors on the weights' device; the kernels update
the weight shard, the moments and the fp32 master in place.
"""
from __future__ import annotations

import math
import pickle
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from .. import engine as _engine
from ..base import get_env, register_env
from ..ops import fused_optimizer as _fo
from .optimizer import LAMB, SGD, Adam, Optimizer

__all__ = ["ZeroComm", "ZeroUpdater", "zero_enabled"]

register_env("MXNET_TPU_ZERO", False, bool,
             "Run the kvstore's optimizer as the ZeRO-1 sharded updater "
             "(Trainer zero=None defers to it).")


def zero_enabled(flag=None):
    """An explicit flag wins, else ``MXNET_TPU_ZERO`` (default off)."""
    if flag is not None:
        return bool(flag)
    return bool(get_env("MXNET_TPU_ZERO"))


class ZeroComm:
    """The exchange contract of the ZeRO path, and its world-1
    implementation (every exchange is the identity).

    reduce_scatter(spec, flat): this rank's (spec.shard,) slice of the
        cross-rank sum of each rank's (spec.padded,) vector.
    all_gather(spec, shard): the (spec.padded,) vector of every rank's
        shard.
    all_reduce(spec, value): the cross-rank sum of a small vector (LAMB's
        per-key squared norms, whose keys may straddle shards).
    """

    world = 1
    rank = 0

    def reduce_scatter(self, spec, flat):
        return flat

    def all_gather(self, spec, shard):
        return shard

    def all_reduce(self, spec, value):
        return value


class ZeroUpdater:
    """The sharded counterpart of `optimizer.Updater`: called once a step
    with the full key set, serializable through `get_states`/`set_states`
    (the frozen layout and the full optimizer state, so a restore may
    re-partition onto another world size). SGD (with momentum), Adam and
    LAMB only: any other optimizer raises at construction."""

    def __init__(self, optimizer, comm=None, cap_bytes=None):
        if not isinstance(optimizer, Optimizer):
            raise TypeError("ZeroUpdater needs an Optimizer instance, got %s"
                            % type(optimizer))
        kinds = {SGD: "sgd", Adam: "adam", LAMB: "lamb"}
        if type(optimizer) not in kinds:
            raise ValueError(
                "ZeRO sharded update supports exactly SGD, Adam and LAMB "
                "(the fused flat kernels); got %s — disable zero or switch "
                "optimizer" % type(optimizer).__name__)
        self._kind = kinds[type(optimizer)]
        self.optimizer = optimizer
        self.comm = comm if comm is not None else ZeroComm()
        self._cap_bytes = cap_bytes
        self.layout = None
        self._w_shards = {}       # bucket index -> owned weight shard
        self._masters = {}        # bucket index -> fp32 master shard (mp)
        self._states = {}         # bucket index -> {slot: flat shard}
        self._mult_cache = {}     # bucket index -> {slot: (scalars, vec)}
        self._seg_cache = {}      # bucket index -> _seg_info's tuple

    # -- layout / state allocation ---------------------------------------
    @property
    def _slots(self):
        return ("mom",) if self._kind == "sgd" else ("mean", "var")

    def _bucket_mp(self, spec):
        return self.optimizer.multi_precision and spec.dtype == "float16"

    def _freeze(self, keys, grads):
        cap = (_engine.bucket_bytes() if self._cap_bytes is None
               else self._cap_bytes)
        self.layout = _engine.BucketLayout.from_entries(
            zip(keys, grads), self.comm.world, cap)

    def _ensure_shards(self, spec, weights_by_key):
        """The owned weight slice (from the store's current values, so a
        restore re-seeds it) and the state shards, made at first use."""
        b = spec.index
        if b in self._w_shards:
            return
        flat = _engine.pack_flat(spec, [weights_by_key[k]._data.detach()
                                        for k in spec.keys])
        lo = self.comm.rank * spec.shard
        self._w_shards[b] = flat[lo:lo + spec.shard].clone()
        dev = self._w_shards[b].device
        mp = self._bucket_mp(spec)
        if mp:
            # a restored master keeps the precision the fp16 weights lost
            if b not in self._masters:
                self._masters[b] = self._w_shards[b].float()
            self._masters[b] = self._masters[b].to(dev)
        elif spec.dtype == "float16":
            warnings.warn("Accumulating with float16 in optimizer can lead "
                          "to poor accuracy or slow convergence. Consider "
                          "using multi_precision=True option of the "
                          "optimizer")
        if b in self._states:
            # restored state shards wait on the host for the weights' device
            self._states[b] = {k: v.to(dev)
                               for k, v in self._states[b].items()}
        else:
            dt = torch.float32 if mp else spec.torch_dtype
            if self._kind == "sgd" and self.optimizer.momentum == 0.0:
                self._states[b] = {}
            else:
                self._states[b] = {s: torch.zeros(spec.shard, dtype=dt,
                                                  device=dev)
                                   for s in self._slots}

    def state_bytes_per_rank(self):
        """Owned optimizer-state bytes on this rank (moments and fp32
        masters)."""
        total = sum(t.numel() * t.element_size()
                    for st in self._states.values() for t in st.values())
        return total + sum(m.numel() * m.element_size()
                           for m in self._masters.values())

    # -- per-step scalars -------------------------------------------------
    def _idx(self, key):
        return int(key) if str(key).isdigit() else str(key)

    def _seg_info(self, spec):
        """Per-bucket segment metadata, built once: ((key_index, start,
        length) of this rank's shard, an int32 per-element key index with
        n_keys on the padding, n_keys, kernel #9's chunk table on the
        card or None on the CPU)."""
        hit = self._seg_cache.get(spec.index)
        if hit is not None:
            return hit
        by_key = {k: i for i, k in enumerate(spec.keys)}
        segments = tuple((by_key[k], start, length) for k, start, length, _
                         in spec.shard_segments(self.comm.rank))
        ids = np.full(spec.shard, len(spec.keys), np.int32)
        for k, start, length in segments:
            ids[start:start + length] = k
        dev = self._w_shards[spec.index].device
        table = _fo.lamb_chunk_table(segments, len(spec.keys), spec.shard,
                                     dev) if dev.type == "cuda" else None
        info = (segments, torch.from_numpy(ids).to(dev), len(spec.keys),
                table)
        self._seg_cache[spec.index] = info
        return info

    def _lr_wd_vectors(self, spec):
        """Per-element fp32 lr/wd vectors of this rank's shard: each owned
        segment holds its parameter's scalar (scheduler, lr_mult/wd_mult
        and, for Adam, the bias correction folded in host double), the
        padding 0. Each vector is cached on its tuple of scalars."""
        opt = self.optimizer
        indices = [self._idx(k) for k in spec.keys]
        lrs = opt._get_lrs(indices)
        wds = opt._get_wds(indices)
        if self._kind == "adam":
            for i, idx in enumerate(indices):
                t = opt._index_update_count[idx]
                lrs[i] *= math.sqrt(1. - opt.beta2 ** t) / \
                    (1. - opt.beta1 ** t)
        cache = self._mult_cache.setdefault(spec.index, {})
        _, seg_ids, _, _ = self._seg_info(spec)

        def vec(slot, scalars):
            sig = tuple(scalars)
            hit = cache.get(slot)
            if hit is not None and hit[0] == sig:
                return hit[1]
            table = torch.tensor(list(scalars) + [0.0], dtype=torch.float32,
                                 device=seg_ids.device)
            out = table.index_select(0, seg_ids)
            cache[slot] = (sig, out)
            return out

        return vec("lr", lrs), vec("wd", wds)

    # -- the step ----------------------------------------------------------
    def __call__(self, index, grad, weight):
        """Updater-protocol entry: the store hands the full key set in one
        call."""
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        self.step(list(index), [getattr(g, "_data", g) for g in grad],
                  list(weight))

    def step(self, keys, grads, weights):
        """One sharded update. `grads` are this rank's merged gradient
        tensors, `weights` the full parameter NDArrays (written in place
        with the gathered result)."""
        keys = [str(k) for k in keys]
        # empty gradients never enter a bucket; drop them here too so the
        # frozen layout and every later step agree on the key sequence
        kept = [i for i, g in enumerate(grads) if g.numel()]
        if len(kept) != len(keys):
            keys = [keys[i] for i in kept]
            grads = [grads[i] for i in kept]
            weights = [weights[i] for i in kept]
        if self.layout is None:
            self._freeze(keys, grads)
        else:
            self.layout.assert_matches(keys)
        grads_by_key = dict(zip(keys, grads))
        weights_by_key = dict(zip(keys, weights))
        opt = self.optimizer
        for k in keys:
            opt._update_count(self._idx(k))
        clip = opt.clip_gradient
        # the profiler ranges name the legs of a step (zero.pack,
        # zero.update with zero.lamb_scale inside, zero.unpack) so a trace
        # can split the updater's device time; they cost nothing unless a
        # profiler runs
        with torch.no_grad():
            for spec in self.layout:
                self._ensure_shards(spec, weights_by_key)
                with record_function("zero.pack"):
                    flat_g = _engine.pack_flat(
                        spec, [grads_by_key[k] for k in spec.keys])
                g_shard = self.comm.reduce_scatter(spec, flat_g)
                with record_function("zero.update"):
                    new_w = self._fused_shard_update(spec, g_shard, clip)
                full = self.comm.all_gather(spec, new_w)
                with record_function("zero.unpack"):
                    for k, part in zip(spec.keys,
                                       _engine.unpack_flat(spec, full)):
                        weights_by_key[k]._data.copy_(part)

    def scatter_ready(self, spec, flat_g, weights_by_key):
        """Start one completed bucket's reduce-scatter (readiness mode,
        frozen layout). Returns the handle `finish_ready` takes: a pending
        exchange where the comm can start one (`reduce_scatter_async`),
        else the shard."""
        self._ensure_shards(spec, weights_by_key)
        start = getattr(self.comm, "reduce_scatter_async", None)
        if start is not None:
            return start(spec, flat_g)
        return self.comm.reduce_scatter(spec, flat_g)

    def finish_ready(self, arrivals, weights_by_key):
        """Complete a readiness round at step time. `arrivals` is [(spec,
        handle)] in completion order (any permutation of the layout); each
        bucket's update and all-gather run in that order, with the
        arithmetic of `step`."""
        if self.layout is None:
            raise RuntimeError("finish_ready needs a frozen layout (the "
                               "first step goes through step())")
        got = sorted(s.index for s, _ in arrivals)
        want = sorted(s.index for s in self.layout)
        if got != want:
            raise ValueError("readiness round arrived with buckets %s but "
                             "the frozen layout holds %s" % (got, want))
        opt = self.optimizer
        for k in self.layout.keys():
            opt._update_count(self._idx(k))
        clip = opt.clip_gradient
        with torch.no_grad():
            for spec, handle in arrivals:
                g_shard = handle.wait() if hasattr(handle, "wait") \
                    else handle
                with record_function("zero.update"):
                    new_w = self._fused_shard_update(spec, g_shard, clip)
                full = self.comm.all_gather(spec, new_w)
                with record_function("zero.unpack"):
                    for k, part in zip(spec.keys,
                                       _engine.unpack_flat(spec, full)):
                        weights_by_key[k]._data.copy_(part)

    def _fused_shard_update(self, spec, g_shard, clip):
        """One flat pass over the owned shard (two for LAMB)."""
        opt = self.optimizer
        b = spec.index
        mp = self._bucket_mp(spec)
        lr_vec, wd_vec = self._lr_wd_vectors(spec)
        w = self._w_shards[b]
        master = self._masters.get(b)
        rescale = opt.rescale_grad
        clip_v = clip if clip is not None else 0.0
        if self._kind == "sgd":
            momentum_on = opt.momentum != 0.0
            _fo.flat_sgd(w, g_shard, self._states[b].get("mom"), master,
                         lr_vec, wd_vec, opt.momentum, rescale, clip_v,
                         momentum_on, clip is not None, mp)
        elif self._kind == "adam":
            st = self._states[b]
            _fo.flat_adam(w, g_shard, st["mean"], st["var"], master, lr_vec,
                          wd_vec, opt.beta1, 1.0 - opt.beta1, opt.beta2,
                          1.0 - opt.beta2, opt.epsilon, rescale, clip_v,
                          clip is not None, mp)
        else:
            self._lamb_shard_update(spec, g_shard, clip, mp, lr_vec, wd_vec,
                                    rescale, clip_v)
        return w

    def _lamb_shard_update(self, spec, g_shard, clip, mp, lr_vec, wd_vec,
                           rescale, clip_v):
        """LAMB over the owned shard: pass 1 (moments, direction and each
        key's squared-norm partials in one sweep, kernel #9), the norm
        all-reduce (keys may straddle shards), the trust ratios, pass 2
        (kernel #10). The norms are summed in another order than
        `torch.linalg.vector_norm`, so this agrees with the per-parameter
        LAMB to fp32 rounding, not bit for bit."""
        opt = self.optimizer
        b = spec.index
        segments, seg_ids, n_keys, table = self._seg_info(spec)
        w = self._w_shards[b]
        master = self._masters.get(b)
        st = self._states[b]
        # one update count for the whole step: every key steps together
        t = opt._index_update_count[self._idx(spec.keys[0])]
        # the bias-correction complements in Python double, as the
        # per-parameter op computes them
        gdir, _, _, partial = _fo.flat_lamb1(
            w, g_shard, st["mean"], st["var"], master, wd_vec, opt.beta1,
            1.0 - opt.beta1, opt.beta2, 1.0 - opt.beta2,
            1.0 - opt.beta1 ** t, 1.0 - opt.beta2 ** t, opt.epsilon,
            rescale, clip_v, clip is not None, mp,
            bool(opt.bias_correction), segments, n_keys, table)
        full = self.comm.all_reduce(spec, partial)
        with record_function("zero.lamb_scale"):
            r1, r2 = torch.sqrt(full[0]), torch.sqrt(full[1])
            if opt.lower_bound is not None and opt.lower_bound > 0:
                r1 = torch.clamp(r1, min=opt.lower_bound)
            if opt.upper_bound is not None and opt.upper_bound > 0:
                r1 = torch.clamp(r1, max=opt.upper_bound)
            ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                                torch.ones_like(r1))
            # the padding's index n_keys takes a ratio of 1; its lr is 0
            ratio = torch.cat([ratio, ratio.new_ones(1)])
            scale_vec = lr_vec * ratio.index_select(0, seg_ids)
        _fo.flat_lamb2(w, master, gdir, scale_vec, mp)

    # -- checkpointing -----------------------------------------------------
    def state_payload(self):
        """World-size-independent state: the frozen layout and the full
        (gathered, unpadded) flat state per bucket as fp32 numpy arrays
        (bf16 and fp16 states are exact in fp32 and cast back on load), in
        the reference's ``zero_format`` 1 shape."""
        if self.layout is None:
            return {"zero_format": 1, "layout": None, "state": {},
                    "comm_schedule": None}
        state = {}
        for spec in self.layout:
            slots = {}
            for name, shard in self._states.get(spec.index, {}).items():
                full = self.comm.all_gather(spec, shard)
                slots[name] = full[:spec.size].float().cpu().numpy()
            if spec.index in self._masters:
                full = self.comm.all_gather(spec, self._masters[spec.index])
                slots["master"] = full[:spec.size].float().cpu().numpy()
            state[spec.index] = slots
        return {"zero_format": 1, "layout": self.layout.to_payload(),
                "state": state, "comm_schedule": None}

    def load_state_payload(self, payload):
        """Inverse of `state_payload`, re-partitioned for this comm's
        world and rank. The state shards wait on the host; the next step
        re-seeds the weight shards from the store and moves the state to
        the weights' device."""
        if int(payload.get("zero_format", -1)) != 1:
            raise ValueError("not a ZeRO state payload: %r"
                             % (payload.get("zero_format"),))
        self._w_shards.clear()
        self._masters.clear()
        self._states.clear()
        self._mult_cache.clear()
        self._seg_cache.clear()
        if payload["layout"] is None:
            self.layout = None
            return
        self.layout = _engine.BucketLayout.from_payload(
            payload["layout"], world=self.comm.world)
        for spec in self.layout:
            slots = payload["state"].get(spec.index)
            if slots is None:
                slots = payload["state"].get(str(spec.index), {})
            lo = self.comm.rank * spec.shard
            dt = torch.float32 if self._bucket_mp(spec) else spec.torch_dtype
            out = {}
            for name, full in slots.items():
                padded = np.zeros(spec.padded, np.float32)
                padded[:spec.size] = np.asarray(full, np.float32)
                shard = torch.from_numpy(padded[lo:lo + spec.shard].copy())
                if name == "master":
                    self._masters[spec.index] = shard
                else:
                    out[str(name)] = shard.to(dt)
            self._states[spec.index] = out

    def get_states(self, dump_optimizer=False):
        payload = self.state_payload()
        if dump_optimizer:
            payload["optimizer"] = self.optimizer
        return pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)

    def set_states(self, states):
        payload = pickle.loads(states)
        if "optimizer" in payload:
            self.optimizer = payload.pop("optimizer")
        self.load_state_payload(payload)
