"""Ring attention of the port against the JAX package, on the CPU.

The JAX reference runs `ring_attention` under `shard_map` over 4 CPU
devices on a ``seq`` axis, as tests/test_parallel.py runs it, and its
gradients come from `jax.grad` through that program. The port runs it
(a) in 4 processes over gloo (`_torch_dist_worker.py`, ``ring``) and
(b) in one process, driven by chip_smoke.py's in-process fleet of 4
threads through the injectable exchange. Shapes: B=2, H=4, Hkv=2 (GQA: only the 2-head
K/V chunks travel), S=32 in chunks of 8, D=16, fp32, causal and not.
Tolerances: o within 1e-5, dq/dk/dv within 2e-5 (fp32 blocks merged in
another order); the fleet and the process group agree within 1e-6.
"""
import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

import mxnet_tpu.parallel as jpar
from mxnet_tpu_torch.parallel.flash_attention import flash_attention
from mxnet_tpu_torch.parallel.ring_attention import (RingExchange,
                                                     ring_attention)

import _torch_dist_worker as W
from test_torch_dist import spawn

WORLD = 4
O_TOL, GRAD_TOL = 1e-5, 2e-5


@pytest.fixture(scope="module")
def gloo_ring(tmp_path_factory):
    res = spawn(WORLD, "ring", tmp_path_factory.mktemp("ring"))
    return {k: np.concatenate([r[k] for r in res], axis=2) for k in res[0]}


def _reference(causal):
    """(o, dq, dk, dv) of the JAX package's ring attention on 4 devices,
    the gradients of sum(o * do)."""
    q, k, v, do = W.ring_inputs()
    mesh = jpar.local_mesh(WORLD, axis="seq")
    spec = P(None, None, "seq", None)
    f = shard_map(lambda q_, k_, v_: jpar.ring_attention(
        q_, k_, v_, axis_name="seq", causal=causal), mesh=mesh,
        in_specs=spec, out_specs=spec)

    def loss(q_, k_, v_):
        return jnp.sum(f(q_, k_, v_) * do)

    o = jax.jit(f)(q, k, v)
    dq, dk, dv = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(t) for t in (o, dq, dk, dv)]


@functools.lru_cache(maxsize=None)
def _fleet():
    """chip_smoke.py's in-process fleet (`FleetComm`, `run_fleet`): the
    one the card's path 19 drives, here on CPU tensors."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(W.__file__).parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_fleet


def _fleet_ring(causal, dtype=torch.float32):
    q, k, v, do = (torch.from_numpy(t).to(dtype) for t in W.ring_inputs())
    c = q.shape[2] // WORLD
    res = [None] * WORLD

    def run(r, comm):
        sl = slice(r * c, (r + 1) * c)
        qs, ks, vs = (t[:, :, sl].clone().requires_grad_()
                      for t in (q, k, v))
        o = ring_attention(qs, ks, vs, causal=causal, comm=comm)
        o.backward(do[:, :, sl])
        res[r] = (o.detach(), qs.grad, ks.grad, vs.grad)

    _fleet()(WORLD, run)
    return [torch.cat([r[i] for r in res], 2).float().numpy()
            for i in range(4)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_attention_over_gloo_matches_reference(gloo_ring, causal):
    want = _reference(causal)
    tag = "causal" if causal else "full"
    for name, w, tol in zip(("o", "dq", "dk", "dv"), want,
                            (O_TOL,) + (GRAD_TOL,) * 3):
        np.testing.assert_allclose(gloo_ring["ring_%s_%s" % (tag, name)],
                                   w, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_attention_fleet_matches_gloo_and_flash(gloo_ring, causal):
    got = _fleet_ring(causal)
    tag = "causal" if causal else "full"
    for name, g in zip(("o", "dq", "dk", "dv"), got):
        np.testing.assert_allclose(g, gloo_ring["ring_%s_%s" % (tag, name)],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    # the whole-sequence flash attention (its plain version here)
    q, k, v, do = (torch.from_numpy(t).requires_grad_()
                   for t in W.ring_inputs())
    o = flash_attention(q, k, v, causal=causal)
    o.backward(do.detach())
    for g, w in zip(got, (o.detach(), q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(g, w.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_ring_attention_bf16_fleet_tracks_fp32():
    """bf16 chunks through the same ring: within bf16 rounding (3e-2) of
    the fp32 result."""
    want = _fleet_ring(True)
    got = _fleet_ring(True, torch.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=3e-2, atol=3e-2)


def test_one_rank_ring_is_flash_attention():
    """Without a process group the ring has one rank and one block: the
    flash attention of the chunk, with its lse."""
    q, k, v, _ = (torch.from_numpy(t) for t in W.ring_inputs())
    comm = RingExchange(None)
    assert comm.world == 1 and comm.rank == 0
    for causal in (False, True):
        o, lse = ring_attention(q, k, v, causal=causal, return_lse=True)
        want = flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(o, want, rtol=1e-6, atol=1e-6)
        assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    with pytest.raises(ValueError, match="differ"):
        ring_attention(q, k[:, :, :4], v[:, :, :4])
