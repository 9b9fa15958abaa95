"""The port's sharded, coordinated and ZeRO checkpoints
(`parallel.checkpoint`) against the JAX package, on the CPU.

In one process, each scenario runs on both packages with the same
numpy-seeded trees: the restored values, `latest_step` and
`latest_committed_step` must agree (the formats differ: the reference
writes orbax, the port `torch.save`), through keep=N retention, a corrupt
LATEST marker, a coordinated save that dies mid-commit, a torn newest
step (the fallback) and a window where nothing verifies. The ZeRO state
round-trips at world 1 in process.

Across ranks (`_torch_resilience_worker.py`, gloo): at world 4, blocks
saved on ``fsdp=2, model=2`` (whole leaves on disk) and restored by the
rules on ``data=4``, ``model=4`` and the saving mesh and by a template of
blocks, coordinated; a torn newest step falling back on every rank;
`restore_train_state` re-laying a ``zero=True`` state (its slots'
``data`` blocks) bit for bit, training on as the live state; and the ZeRO
state round trip. At world 2 the ZeRO state round trip and its restore
laid out for one rank.
"""
import os

import numpy as np
import pytest
import torch

from mxnet_tpu.parallel import checkpoint as jckpt
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.resilience.errors import CheckpointCorruptError as JCorrupt

from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.parallel import checkpoint as ckpt
from mxnet_tpu_torch.resilience import faults
from mxnet_tpu_torch.resilience.errors import (CheckpointCorruptError,
                                               PreemptionError)

import _torch_resilience_worker as W
from test_torch_resilience_dist import spawn


def _tree(scale):
    return {k: v * scale for k, v in W.ckpt_tree().items()
            if not isinstance(v, dict)}


def _both(fn):
    """`fn(pkg_ckpt, to_host)` on the reference and on the port."""
    return (fn(jckpt, lambda t: {k: np.asarray(v) for k, v in t.items()}),
            fn(ckpt, lambda t: {k: v.numpy() for k, v in t.items()}))


def _restore(mod, path, **kw):
    if mod is ckpt:
        kw["device"] = "cpu"
    return mod.restore_sharded(path, **kw)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_keep_and_latest_marker_match_the_reference(tmp_path):
    def run(mod, host):
        path = str(tmp_path / mod.__name__)
        for step in (1, 2, 3, 4):
            tree = _tree(step)
            if mod is ckpt:
                tree = {k: torch.from_numpy(v) for k, v in tree.items()}
            mod.save_sharded(path, tree, step=step, keep=2)
        steps = sorted(int(d) for d in os.listdir(path) if d.isdigit())
        latest = mod.latest_step(path)
        with open(os.path.join(path, "LATEST"), "w") as f:
            f.write("garbage")
        return steps, latest, mod.latest_step(path), \
            host(_restore(mod, path))

    (js, jl, jl2, jt), (ts, tl, tl2, tt) = _both(run)
    assert (ts, tl, tl2) == (js, jl, jl2) == ([3, 4], 4, 4)
    _same(tt, jt)


def test_coordinated_mid_commit_crash_matches_the_reference(tmp_path):
    def run(mod, host):
        path = str(tmp_path / mod.__name__)
        plan = jfaults if mod is jckpt else faults

        def tree(s):
            t = _tree(s)
            return t if mod is jckpt else {k: torch.from_numpy(v)
                                           for k, v in t.items()}
        mod.save_sharded(path, tree(1), step=1, coordinated=True)
        with plan.inject("checkpoint.save:preempt:1"):
            with pytest.raises((PreemptionError,
                                jfaults.PreemptionError)):
                mod.save_sharded(path, tree(2), step=2, coordinated=True)
        return (mod.latest_step(path), mod.latest_committed_step(path),
                host(_restore(mod, path, coordinated=True)))

    (jl, jc, jt), (tl, tc, tt) = _both(run)
    assert (tl, tc) == (jl, jc) == (2, 1)
    _same(tt, jt)
    _same(tt, _tree(1))


def test_torn_newest_step_falls_back_as_the_reference(tmp_path):
    def run(mod, host):
        path = str(tmp_path / mod.__name__)
        for step in (1, 2):
            t = _tree(step)
            mod.save_sharded(path, t if mod is jckpt else {
                k: torch.from_numpy(v) for k, v in t.items()}, step=step)
        # a flipped byte in every payload file of step 2
        for dirpath, _, files in os.walk(os.path.join(path, "2")):
            for name in files:
                victim = os.path.join(dirpath, name)
                if mod is jckpt and os.sep + "d" + os.sep not in victim:
                    continue
                with open(victim, "r+b") as f:
                    blob = bytearray(f.read())
                    blob[len(blob) // 2] ^= 0xFF
                    f.seek(0)
                    f.write(bytes(blob))
        return host(_restore(mod, path))

    before = telemetry.counter_value("checkpoint.corrupt")
    jt, tt = _both(run)
    _same(tt, jt)
    _same(tt, _tree(1))
    assert telemetry.counter_value("checkpoint.corrupt") == before + 1
    assert telemetry.counter_value("checkpoint.corrupt_fallbacks") >= 1


def test_nothing_verifies_raises_as_the_reference(tmp_path):
    path = str(tmp_path / "port")
    ckpt.save_sharded(path, {"w": torch.ones(4)}, step=1)
    with open(os.path.join(path, "1", "state.pt"), "r+b") as f:
        f.truncate(16)
    with pytest.raises(CheckpointCorruptError) as ei:
        ckpt.restore_sharded(path, device="cpu")
    assert ei.value.steps_tried == [1]
    jpath = str(tmp_path / "ref")
    jckpt.save_sharded(jpath, {"w": np.ones(4, np.float32)}, step=1)
    for dirpath, _, files in os.walk(os.path.join(jpath, "1")):
        for name in files:
            if os.sep + "d" + os.sep in os.path.join(dirpath, name):
                with open(os.path.join(dirpath, name), "r+b") as f:
                    blob = bytearray(f.read())
                    blob[len(blob) // 2] ^= 0xFF
                    f.seek(0)
                    f.write(bytes(blob))
    with pytest.raises(JCorrupt):
        jckpt.restore_sharded(jpath)


def test_coordinated_commit_verified(tmp_path):
    root = str(tmp_path / "sharded")
    ckpt.save_sharded(root, {"w": torch.full((4,), 7.0)}, step=3,
                      coordinated=True)
    assert os.path.isfile(os.path.join(root, "3.sha256.json"))
    assert ckpt.latest_committed_step(root) == 3
    tree = ckpt.restore_sharded(root, coordinated=True, device="cpu")
    assert torch.equal(tree["w"], torch.full((4,), 7.0))


def test_zero_state_round_trip_at_world_one(tmp_path):
    out = W.check_zero_state(0, 1, str(tmp_path))
    assert bool(out["zero1/same"])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn("ckpt", 4, tmp_path_factory.mktemp("ckpt4"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn("zero2", 2, tmp_path_factory.mktemp("zero2"))


def _split(x, spec_axes, sizes, coords):
    """The block of whole `x` at mesh coordinates `coords`."""
    for d, axes in enumerate(spec_axes):
        idx, n = 0, 1
        for a in axes:
            idx = idx * sizes.get(a, 1) + coords.get(a, 0)
            n *= sizes.get(a, 1)
        if n > 1 and x.shape[d] % n == 0:
            per = x.shape[d] // n
            x = np.take(x, range(idx * per, (idx + 1) * per), axis=d)
    return x


def test_sharded_state_restores_across_meshes(world4):
    whole = dict(W._flat(W.ckpt_tree()))
    specs = {"embed": (("model",), ("fsdp",)),
             "layers/0/attn/wq": (("fsdp",), ("model",)),
             "layers/0/attn/wo": (("model",), ("fsdp",)), "norm": ()}
    meshes = {"data4": ({"data": 4}, ("data",)),
              "model4": ({"model": 4}, ("model",)),
              "m1": ({"fsdp": 2, "model": 2}, ("fsdp", "model"))}
    for rank, r in enumerate(world4):
        assert int(r["ckpt/committed"]) == 2
        assert bool(r["ckpt/template_same"])
        assert int(r["ckpt/fallback_step"]) == 1
        assert str(r["ckpt/all_corrupt"]) == "[2, 1]"
        for tag, (sizes, order) in meshes.items():
            # rank r's coordinates: the first axis major
            coords, rest = {}, rank
            for a in reversed(order):
                coords[a] = rest % sizes[a]
                rest //= sizes[a]
            for name, x in whole.items():
                np.testing.assert_array_equal(
                    r["ckpt/%s/whole/%s" % (tag, name)], x)
                np.testing.assert_array_equal(
                    r["ckpt/%s/%s" % (tag, name)],
                    _split(x, specs[name], sizes, coords))


def test_restore_train_state_relays_a_zero_state(world4):
    for r in world4:
        assert bool(r["zero_state/same"])


@pytest.mark.parametrize("world", [2, 4])
def test_zero_state_round_trip_across_ranks(request, world):
    res = request.getfixturevalue("world%d" % world)
    for r in res:
        assert bool(r["zero%d/same" % world])
        for i in range(len(W.ZERO_SHAPES)):
            np.testing.assert_array_equal(r["zero%d/w%d" % (world, i)],
                                          res[0]["zero%d/w%d" % (world, i)])
    if world == 2:
        for r in res:
            assert bool(r["zero2/to_world1"])
