"""The port's training step and checkpoints against the JAX package's.

`ShardedTrainStep` runs 3 steps of the tiny fp32 Llama (the config of
tests/test_serve.py) from the same weights, optimizer state and tokens on
both sides; the JAX side runs on a one-device mesh with its flash
attention in Pallas interpret mode. Losses agree to 1e-5 and every
parameter leaf to 1e-4 (fp32, summation order only). At bf16 the JAX adam
update turns bf16 leaves into fp32 (its fp32 bias corrections promote
``p - step``); the port keeps each leaf's dtype, so there the port's
parameters are held to the JAX step's fp32 result rounded to bf16, within
one bf16 ulp, and its moments to the same formulas in fp32 rounded once
(JAX rounds beta1 and beta2 to bf16 first, so its moments are no reference
there).
"""
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models import llama as J
from mxnet_tpu.parallel import ShardedTrainStep as JStep
from mxnet_tpu.parallel import create_mesh
from mxnet_tpu.parallel import train_step as JTS
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.models import llama as T
from mxnet_tpu_torch.models.convert import opt_state_from_jax, params_from_jax
from mxnet_tpu_torch.parallel import (ShardedTrainStep, latest_step,
                                      restore_train_state, save_train_state)
from mxnet_tpu_torch.parallel import train_step as TTS
from mxnet_tpu_torch.resilience.errors import CheckpointCorruptError

JCFG = J.LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, hidden_dim=128, rope_theta=10000.0,
                     max_seq_len=64, dtype=jnp.float32)
TCFG = T.LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, hidden_dim=128, rope_theta=10000.0,
                     max_seq_len=64, dtype=torch.float32)
JPARAMS = J.llama_init(jax.random.PRNGKey(0), JCFG)
NP_PARAMS = jax.tree_util.tree_map(np.asarray, JPARAMS)
LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, size=shape)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _assert_params(tp, jp, atol):
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        got = _leaf(tp, path)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(a), atol=atol,
                                   rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def _run_both(optimizer, steps=3, grad_accum=1, lr=1e-3, **kw):
    tok = _tokens((4, 17), 20)
    jstep = JStep(lambda p, b: J.llama_loss(p, b, JCFG), JPARAMS,
                  create_mesh(data=1), optimizer=optimizer, lr=lr,
                  grad_accum=grad_accum, donate=False, **kw)
    jp, js = jstep.init()
    tp = params_from_jax(NP_PARAMS, device="cpu")
    tstep = ShardedTrainStep(lambda p, b: T.llama_loss(p, b, TCFG), tp,
                             optimizer=optimizer,
                             lr=(lambda s: lr(int(s))) if callable(lr)
                             else lr, grad_accum=grad_accum, **kw)
    tp, _ = tstep.init()
    # both sides start from one optimizer state, carried over from JAX
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                            device="cpu")
    jl, tl = [], []
    for i in range(steps):
        jp, js, loss = jstep(jp, js, {"tokens": jnp.asarray(tok)},
                             step_num=i)
        jl.append(float(loss))
        tp, ts, loss = tstep(tp, ts, {"tokens": tok}, step_num=i)
        tl.append(loss.item())
    return jl, tl, jp, js, tp, ts


@pytest.mark.parametrize("optimizer,kw", [
    ("adamw", {"wd": 0.1}),
    ("adam", {}),
    ("sgd", {"momentum": 0.9}),
], ids=["adamw-wd", "adam", "sgd-momentum"])
def test_three_steps_match_jax(optimizer, kw):
    jl, tl, jp, js, tp, ts = _run_both(optimizer, **kw)
    np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)
    assert tl[-1] < tl[0]
    _assert_params(tp, jp, PARAM_ATOL)
    if optimizer != "sgd":
        assert ts["t"] == int(js["t"]) == 3


def test_grad_accum_and_callable_lr_match_jax():
    jl, tl, jp, _, tp, _ = _run_both(
        "adamw", steps=2, grad_accum=2, lr=lambda s: 1e-3 / (1.0 + s),
        wd=0.01)
    np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)
    _assert_params(tp, jp, PARAM_ATOL)


def test_grad_accum_averages_the_micro_batches():
    tok = _tokens((4, 9), 21)

    def grads(accum):
        tp = params_from_jax(NP_PARAMS, device="cpu")
        step = ShardedTrainStep(lambda p, b: T.llama_loss(p, b, TCFG), tp,
                                optimizer="sgd", lr=1.0, grad_accum=accum)
        p0 = copy.deepcopy(tp)
        _, _, loss = step(tp, {}, tok)
        # plain sgd at lr 1: the update is the (averaged) gradient
        return loss.item(), jax.tree_util.tree_map(lambda a, b: a - b, p0,
                                                   tp)

    l1, g1 = grads(1)
    l2, g2 = grads(2)
    assert l2 == pytest.approx(l1, abs=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="grad_accum"):
        ShardedTrainStep(lambda p, b: T.llama_loss(p, b, TCFG),
                         params_from_jax(NP_PARAMS, device="cpu"),
                         grad_accum=3)(
            params_from_jax(NP_PARAMS, device="cpu"),
            TTS.adam_init(params_from_jax(NP_PARAMS, device="cpu")), tok)


def test_remat_of_the_whole_loss_matches():
    tok = _tokens((2, 9), 22)
    out = []
    for remat in (False, True):
        tp = params_from_jax(NP_PARAMS, device="cpu")
        step = ShardedTrainStep(lambda p, b: T.llama_loss(p, b, TCFG), tp,
                                optimizer="adam", lr=1e-3, remat=remat)
        tp, ts = step.init()
        for _ in range(2):
            tp, ts, loss = step(tp, ts, tok)
        out.append((loss.item(), tp))
    assert out[1][0] == pytest.approx(out[0][0], abs=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(out[0][1]),
                    jax.tree_util.tree_leaves(out[1][1])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)


def test_step_ms_is_observed_under_the_jax_name():
    telemetry.reset()
    tp = params_from_jax(NP_PARAMS, device="cpu")
    step = ShardedTrainStep(lambda p, b: T.llama_loss(p, b, TCFG), tp,
                            optimizer="sgd", lr=1e-2)
    tp, ts = step.init()
    for _ in range(2):
        tp, ts, _ = step(tp, ts, _tokens((2, 5), 23))
    hist = telemetry.snapshot()["histograms"]["train_step.step_ms"]
    assert hist["count"] == 2 and hist["min"] > 0
    assert not any(t.requires_grad for t in jax.tree_util.tree_leaves(tp))


def _bf16_case(seed=30):
    rng = np.random.RandomState(seed)
    shapes = {"w": (16, 24), "b": (24,)}
    mk = lambda s: rng.randn(*s).astype(np.float32)  # noqa: E731
    p = {k: mk(s) for k, s in shapes.items()}
    g = {k: mk(s) * 0.1 for k, s in shapes.items()}
    m = {k: mk(s) * 0.01 for k, s in shapes.items()}
    v = {k: np.abs(mk(s)) * 1e-3 for k, s in shapes.items()}
    return p, g, m, v


def _bf16(tree):
    return {k: torch.from_numpy(a).to(torch.bfloat16) for k, a in
            tree.items()}


def _jbf16(tree):
    return {k: jnp.asarray(a).astype(jnp.bfloat16) for k, a in tree.items()}


def _ulps_apart(a, b):
    """|a - b| in units of bf16 ulps at b (both bf16)."""
    a, b = a.float(), b.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(
        torch.floor(torch.log2(b.abs().clamp_min(1e-30))))
    return ((a - b).abs() / ulp).max().item()


@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "adam"])
def test_adam_update_keeps_bf16_where_jax_promotes_to_fp32(adamw):
    p, g, m, v = _bf16_case()
    jstate = {"m": _jbf16(m), "v": _jbf16(v), "t": jnp.asarray(4, jnp.int32)}
    jp, js = JTS._adam_update(_jbf16(p), _jbf16(g), jstate, 1e-2, wd=0.05,
                              adamw=adamw)
    # the reference quirk this test routes around
    assert all(a.dtype == jnp.float32 for a in jp.values())
    tp = _bf16(p)
    ts = opt_state_from_jax({"m": m, "v": v, "t": np.int32(4)},
                            dtype=torch.bfloat16, device="cpu")
    m0 = {k: t.float().numpy() for k, t in ts["m"].items()}
    v0 = {k: t.float().numpy() for k, t in ts["v"].items()}
    tp2, ts2 = TTS._adam_update(tp, _bf16(g), ts, 1e-2, wd=0.05, adamw=adamw)
    assert tp2 is tp and ts2 is ts and ts["t"] == 5       # in place
    for k in p:
        assert tp[k].dtype == ts["m"][k].dtype == ts["v"][k].dtype \
            == torch.bfloat16
        want = torch.from_numpy(np.array(jp[k])).to(torch.bfloat16)
        assert _ulps_apart(tp[k], want) <= 1.0, k
        # the moments: the same formulas in fp32, rounded once to bf16
        # (the JAX package rounds 0.9 and 0.999 to bf16 first: 0.8984375
        # and 1.0, so its moments are not the reference here)
        g32 = _bf16(g)[k].float().numpy()
        if not adamw:
            g32 = g32 + np.float32(0.05) * _bf16(p)[k].float().numpy()
        m32 = np.float32(0.9) * m0[k] + np.float32(1 - 0.9) * g32
        v32 = np.float32(0.999) * v0[k] + np.float32(1 - 0.999) * g32 * g32
        assert torch.equal(ts["m"][k],
                           torch.from_numpy(m32).to(torch.bfloat16)), k
        assert torch.equal(ts["v"][k],
                           torch.from_numpy(v32).to(torch.bfloat16)), k


def test_training_keeps_bf16_leaves_bf16():
    cfg = T.CONFIGS["llama_tiny"]
    tp = T.llama_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    dtypes = jax.tree_util.tree_map(lambda t: t.dtype, tp)
    step = ShardedTrainStep(lambda p, b: T.llama_loss(p, b, cfg), tp,
                            optimizer="adamw", lr=1e-3, wd=0.1)
    tp, ts = step.init()
    losses = []
    for i in range(3):
        tp, ts, loss = step(tp, ts, _tokens((2, 9), 24), step_num=i)
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for tree in (tp, ts["m"], ts["v"]):
        assert jax.tree_util.tree_map(lambda t: t.dtype, tree) == dtypes


@pytest.mark.parametrize("kw,match", [
    ({"mesh": [torch.device("cpu"), torch.device("cpu")]}, "2 devices"),
    ({"rules": [("wq", ("fsdp", "model"))]}, "rules="),
    ({"bucket_mb": 25}, "bucket_mb="),
    ({"zero": True}, "zero=True"),
], ids=["mesh", "rules", "bucket_mb", "zero"])
def test_multi_device_options_raise_not_implemented(kw, match):
    with pytest.raises(NotImplementedError, match=match) as ei:
        ShardedTrainStep(lambda p, b: 0.0, {}, **kw)
    assert "Queue A.5" in str(ei.value)


def test_one_device_meshes_are_accepted():
    for mesh in (None, [torch.device("cpu")], create_mesh(data=1)):
        ShardedTrainStep(lambda p, b: 0.0, {}, mesh=mesh)


# ---------------------------------------------------------------- checkpoint
def _state(seed):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(8, 16, generator=g).to(torch.bfloat16),
              "norm": torch.randn(16, generator=g),
              "layers": {"0": {"b": torch.randn(3, generator=g)}}}
    return params, TTS.adam_init(params)


def _equal_trees(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        (x.dtype == y.dtype and torch.equal(x, y)) if torch.is_tensor(x)
        else x == y for x, y in zip(la, lb))


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    params, state = _state(0)
    state["t"] = 7
    state["m"]["w"].normal_()
    save_train_state(tmp_path, params, state, step=5)
    p2, s2, step = restore_train_state(tmp_path, device="cpu")
    assert step == 5 and s2["t"] == 7
    assert _equal_trees(p2, params) and _equal_trees(s2, state)
    assert p2["w"].dtype == torch.bfloat16
    assert (tmp_path / "5.sha256.json").is_file()
    assert (tmp_path / "LATEST").read_text().strip() == "5"


def _corrupt(path):
    data = bytearray(path.read_bytes())
    mid = len(data) // 2
    data[mid:mid + 64] = bytes(b ^ 0xFF for b in data[mid:mid + 64])
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("damage", ["flip", "truncate", "sidecar"])
def test_corrupt_step_falls_back_to_the_older_one(tmp_path, damage):
    p5, s5 = _state(5)
    p6, s6 = _state(6)
    save_train_state(tmp_path, p5, s5, step=5)
    save_train_state(tmp_path, p6, s6, step=6)
    payload = tmp_path / "6" / "state.pt"
    if damage == "flip":
        _corrupt(payload)
    elif damage == "truncate":
        payload.write_bytes(payload.read_bytes()[:100])
    else:
        (tmp_path / "6.sha256.json").write_text("{not json")
    telemetry.reset()
    p, s, step = restore_train_state(tmp_path, device="cpu")
    assert step == 5 and _equal_trees(p, p5) and _equal_trees(s, s5)
    counters = telemetry.snapshot()["counters"]
    assert counters["checkpoint.corrupt"] == 1
    assert counters["checkpoint.corrupt_fallbacks"] == 1


def test_sha256_mismatch_is_caught_even_when_the_file_loads(tmp_path):
    p5, s5 = _state(5)
    p6, s6 = _state(6)
    save_train_state(tmp_path, p5, s5, step=5)
    save_train_state(tmp_path, p6, s6, step=6)
    # a well-formed payload whose values differ from what was digested
    p6["norm"][0] += 1.0
    torch.save({"params": p6, "opt_state": s6, "step": 6},
               tmp_path / "6" / "state.pt")
    telemetry.reset()
    _, _, step = restore_train_state(tmp_path, device="cpu")
    assert step == 5
    assert telemetry.snapshot()["counters"]["checkpoint.corrupt"] == 1


def test_no_verifying_step_raises(tmp_path):
    params, state = _state(1)
    save_train_state(tmp_path, params, state, step=1)
    _corrupt(tmp_path / "1" / "state.pt")
    with pytest.raises(CheckpointCorruptError) as ei:
        restore_train_state(tmp_path, device="cpu")
    assert ei.value.steps_tried == [1]
    with pytest.raises(FileNotFoundError):
        restore_train_state(tmp_path / "empty", device="cpu")


def test_latest_step_with_and_without_the_marker(tmp_path):
    assert latest_step(tmp_path) is None
    params, state = _state(2)
    for s in (3, 8, 5):
        save_train_state(tmp_path, params, state, step=s)
    # the marker names the last save; the scan finds the newest step
    assert (tmp_path / "LATEST").read_text().strip() == "5"
    assert latest_step(tmp_path) == 8
    os.remove(tmp_path / "LATEST")
    assert latest_step(tmp_path) == 8
    (tmp_path / "LATEST").write_text("42\n")       # names no step dir
    assert latest_step(tmp_path) == 8
    (tmp_path / "9.tmp-1").mkdir()                 # a save in flight
    assert latest_step(tmp_path) == 8
    _, _, step = restore_train_state(tmp_path, device="cpu")
    assert step == 8


def test_keep_retains_the_newest_steps(tmp_path):
    params, state = _state(3)
    for s in range(1, 6):
        save_train_state(tmp_path, params, state, step=s, keep=2)
    dirs = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert dirs == ["4", "5"]
    assert sorted(p.name for p in tmp_path.glob("*.sha256.json")) == [
        "4.sha256.json", "5.sha256.json"]
