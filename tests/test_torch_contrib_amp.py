"""The port's `contrib.amp` against the JAX package's (modelled on the
reference's tests/test_utils_amp_profiler.py).

* Every op of the three AMP lists that both registries hold gives the
  reference's result dtype under bf16 AMP (bf16 and fp32 inputs; bf16 and
  fp16 for the widest-type ops).
* A narrow Gluon CNN (conv, BatchNorm, Dense) from the same weights under
  bf16 AMP: the forward's dtypes equal, logits and first-step gradients
  within 2e-2 (relative L2: both round the same fp32 values to bf16, in
  different orders), parameters and gradients float32.
* `LossScaler`'s dynamics exact; under float16 (a Dense MLP, which torch
  runs on the CPU) an injected inf gradient skips the update and halves
  the scale in both packages: scales equal, parameters within 2e-3
  (float16's half ulp at 1 is 4.9e-4; the two packages' fp16 products
  round differently); `unscale` then `step` equals `step` alone.
* `convert_model`: the same dtypes and values.
* A `Module` forward under AMP leaves the whole-graph route
  (``compiler.fallback.amp_active``) with the reference's dtypes.

Each test resets `_AMP_WRAP` and `_initialized` in both packages, as the
reference's test does.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.contrib.amp import lists as jlists
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.contrib.amp import lists
from mxnet_tpu_torch.models.convert import gluon_params_from_jax
from mxnet_tpu_torch.ops import registry as treg

from _torch_seed import _seed_torch  # noqa: F401

GRAD_REL = 2e-2
FP16_TOL = 2e-3


@pytest.fixture(autouse=True)
def _amp_off():
    import mxnet_tpu.ndarray.ndarray as jnd
    import mxnet_tpu_torch.ndarray.ndarray as tnd

    def off():
        jnd._AMP_WRAP = None
        tnd._AMP_WRAP = None
        jamp.amp._initialized = False
        jamp.amp._target_dtype = None
        amp.amp._initialized = False
        amp.amp._target_dtype = None
    off()
    yield
    off()


def _dt(d):
    return d if isinstance(d, str) else np.dtype(d).name


def _held(name):
    try:
        jreg.get(name)
        treg.get(name)
        return True
    except Exception:
        return False


def test_lists_are_the_reference_lists():
    assert lists.TARGET_DTYPE_OPS == jlists.TARGET_DTYPE_OPS
    assert lists.FP32_OPS == jlists.FP32_OPS
    assert lists.WIDEST_TYPE_CASTS == jlists.WIDEST_TYPE_CASTS
    assert amp.list_lp16_ops() == jamp.list_lp16_ops()
    assert amp.list_fp32_ops() == jamp.list_fp32_ops()


def _case(name, rng):
    """(positional arrays as (numpy, dtype), kwargs) for one list op."""
    def a(shape, dtype="bfloat16", lo=0.1, hi=0.9):
        return (rng.uniform(lo, hi, shape).astype(np.float32), dtype)
    x = a((2, 3, 4))
    if name == "Convolution":
        return [a((2, 3, 5, 5), "float32"), a((4, 3, 3, 3), "float32"),
                a((4,), "float32")], {"kernel": (3, 3), "num_filter": 4}
    if name == "Deconvolution":
        return [a((2, 3, 5, 5), "float32"), a((3, 4, 3, 3), "float32"),
                a((4,), "float32")], {"kernel": (3, 3), "num_filter": 4}
    if name == "FullyConnected":
        return [a((2, 6), "float32"), a((4, 6), "float32"),
                a((4,), "float32")], {"num_hidden": 4}
    if name == "dot":
        return [a((3, 4), "float32"), a((4, 2), "float32")], {}
    if name == "batch_dot":
        return [a((2, 3, 4), "float32"), a((2, 4, 2), "float32")], {}
    if name == "RNN":
        T, N, I, H = 3, 2, 4, 5
        n = H * I + H * H + 2 * H
        return [a((T, N, I), "float32"), a((n,), "float32"),
                a((1, N, H), "float32")], {"state_size": H,
                                           "num_layers": 1,
                                           "mode": "rnn_tanh"}
    if name == "SoftmaxOutput":
        return [x, (np.array([[0, 1, 2, 0]] * 2, np.float32), "float32")], {}
    if name == "BatchNorm":
        return [x, a((3,)), a((3,)), a((3,)), a((3,))], {}
    if name in ("LayerNorm",):
        return [x, a((4,)), a((4,))], {}
    if name == "InstanceNorm":
        return [x, a((3,)), a((3,))], {}
    if name == "arccosh":
        return [a((2, 3, 4), lo=1.1, hi=3.0)], {}
    if name in ("linalg_gemm",):
        return [a((3, 3)), a((3, 3)), a((3, 3))], {}
    if name in ("linalg_gemm2",):
        return [a((3, 3)), a((3, 3))], {}
    if name == "linalg_potrf":
        m = rng.uniform(0.1, 0.9, (3, 3)).astype(np.float32)
        return [((m @ m.T + 3 * np.eye(3)).astype(np.float32),
                 "bfloat16")], {}
    if name == "linalg_syrk":
        return [a((3, 3))], {}
    if name == "moments":
        return [x], {"axes": (0,)}
    if name == "topk":
        return [x], {"k": 2}
    if name in lists.WIDEST_TYPE_CASTS:
        if name in ("add_n", "concat", "Concat", "stack"):
            return [a((2, 3)), a((2, 3), "float32")], {}
        if name == "where":
            return [(np.array([[1, 0, 1]] * 2, np.float32), "float32"),
                    a((2, 3)), a((2, 3), "float16")], {}
        if name.startswith("elemwise") or name in ("maximum", "minimum"):
            return [a((2, 3)), a((2, 3), "float16")], {}
        return [a((2, 3)), a((1, 3), "float32")], {}
    return [x], {}


SWEEP = [n for n in dict.fromkeys(lists.TARGET_DTYPE_OPS + lists.FP32_OPS
                                  + lists.WIDEST_TYPE_CASTS) if _held(n)]


def _run_op(pkg, name, case):
    arrays, kw = case
    with pkg.cpu():
        args = [pkg.nd.array(v).astype(dt) for v, dt in arrays]
        out = pkg.nd.invoke(name, *args, **kw)
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [_dt(o.dtype) for o in outs]


@pytest.mark.parametrize("name", SWEEP)
def test_list_op_result_dtype_under_bf16(name):
    case = _case(name, np.random.RandomState(0))
    jamp.init("bfloat16")
    amp.init("bfloat16")
    want = _run_op(jmx, name, case)
    got = _run_op(mx, name, case)
    assert got == want, (name, got, want)


def test_sweep_covers_the_lists():
    """Every list op the port's registry holds is in the sweep but the
    reference's missing `power`."""
    held = set(SWEEP)
    assert "Convolution" in held and "RNN" in held and "where" in held
    assert set(lists.TARGET_DTYPE_OPS + lists.FP32_OPS
               + lists.WIDEST_TYPE_CASTS) - held == {"power"}


def _cnn(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(6, 3, padding=1, in_channels=3, use_bias=False),
                nn.BatchNorm(in_channels=6), nn.Activation("relu"),
                nn.Dense(5, in_units=6 * 6 * 6))
    return net


def _cnn_pair():
    rng = np.random.RandomState(3)
    jnet = _cnn(jmx)
    with jmx.cpu():
        jnet.initialize(jmx.init.Xavier())
        x = rng.normal(size=(4, 3, 6, 6)).astype(np.float32)
        jnet(jmx.nd.array(x))
    arrays = {k: v.data().asnumpy()
              for k, v in jnet._collect_params_with_prefix().items()}
    tnet = _cnn(mx)
    with mx.cpu():
        tnet.initialize()
        gluon_params_from_jax(arrays, tnet, ctx=mx.cpu())
    y = rng.randint(0, 5, 4).astype(np.float32)
    return jnet, tnet, x, y


def _amp_step(pkg, amp_mod, net, x, y, ctx=None):
    seen = []
    for blk in net._children.values():
        blk.register_forward_hook(
            lambda b, i, o: seen.append((type(b).__name__, _dt(o.dtype))))
    with ctx or pkg.cpu():
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        amp_mod.init_trainer(tr)
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record():
            out = net(pkg.nd.array(x))
            loss = loss_fn(out, pkg.nd.array(y))
            with amp_mod.scale_loss(loss, tr) as scaled:
                pkg.autograd.backward(scaled)
        logits = out.astype("float32").asnumpy()
        grads = {k: (v.grad().asnumpy(), _dt(v.grad().dtype),
                     _dt(v.data().dtype))
                 for k, v in net._collect_params_with_prefix().items()
                 if v.grad_req != "null"}
        tr.step(len(y))
    return seen, logits, grads


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_narrow_cnn_forward_and_gradients_under_bf16():
    jnet, tnet, x, y = _cnn_pair()
    jamp.init("bfloat16")
    amp.init("bfloat16")
    j_seen, j_logits, j_grads = _amp_step(jmx, jamp, jnet, x, y)
    t_seen, t_logits, t_grads = _amp_step(mx, amp, tnet, x, y)
    assert t_seen == j_seen
    assert ("Conv2D", "bfloat16") in t_seen and \
        ("BatchNorm", "float32") in t_seen
    assert _rel(t_logits, j_logits) < GRAD_REL
    assert sorted(t_grads) == sorted(j_grads)
    for k, (g, gdt, pdt) in t_grads.items():
        assert gdt == pdt == "float32", k
        assert (gdt, pdt) == j_grads[k][1:], k
        assert _rel(g, j_grads[k][0]) < GRAD_REL, k


def test_loss_scaler_dynamics_are_exact():
    seq = [False, False, True, False, False, False, True, True, False,
           False]
    for window in (1, 2, 3):
        a = amp.LossScaler(init_scale=16.0, scale_factor=2.0,
                           scale_window=window)
        b = jamp.LossScaler(init_scale=16.0, scale_factor=2.0,
                            scale_window=window)
        for ov in seq:
            a.update_scale(ov)
            b.update_scale(ov)
            assert a.loss_scale == b.loss_scale
    s = amp.LossScaler(init_scale=1.0)
    s.update_scale(True)
    assert s.loss_scale == 1          # never under 1
    assert amp.LossScaler().loss_scale == 2.0 ** 16


def _mlp_fp16(pkg, amp_mod, arrays, x, y, steps, inject_at, unscale=False):
    nn = pkg.gluon.nn
    with pkg.cpu():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(8, activation="relu", in_units=5),
                    nn.Dense(2, in_units=8))
        net.initialize()
        params = net._collect_params_with_prefix()
        for k, v in params.items():
            v.set_data(pkg.nd.array(arrays[k]))
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9})
        amp_mod.init_trainer(tr)
        scales, skipped = [], 0
        for i in range(steps):
            with pkg.autograd.record():
                out = net(pkg.nd.array(x))
                loss = pkg.nd.mean(pkg.nd.square(
                    out.astype("float32") - pkg.nd.array(y)))
                with amp_mod.scale_loss(loss, tr) as scaled:
                    pkg.autograd.backward(scaled)
            if i in inject_at:
                g = params["0.weight"].grad()
                g[0, 0] = float("inf")
            before = tr._amp_loss_scaler.loss_scale
            if unscale:
                amp_mod.unscale(tr)
            tr.step(1)
            scales.append(tr._amp_loss_scaler.loss_scale)
            skipped += scales[-1] < before
        return ({k: v.data().asnumpy() for k, v in params.items()}, scales,
                skipped)


def _mlp_data():
    rng = np.random.RandomState(5)
    arrays = {"0.weight": rng.normal(0, 0.4, (8, 5)),
              "0.bias": rng.normal(0, 0.1, 8),
              "1.weight": rng.normal(0, 0.4, (2, 8)),
              "1.bias": rng.normal(0, 0.1, 2)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    x = rng.normal(size=(16, 5)).astype(np.float32)
    y = rng.normal(size=(16, 2)).astype(np.float32)
    return arrays, x, y


@pytest.mark.parametrize("unscale", [False, True])
def test_fp16_overflow_skips_and_halves(unscale):
    arrays, x, y = _mlp_data()
    jamp.init("float16")
    amp.init("float16")
    inject = (1, 4)
    jp, js, jskip = _mlp_fp16(jmx, jamp, arrays, x, y, 6, inject, unscale)
    tp, ts, tskip = _mlp_fp16(mx, amp, arrays, x, y, 6, inject, unscale)
    assert ts == js == [2.0 ** 16, 2.0 ** 15, 2.0 ** 15, 2.0 ** 15,
                        2.0 ** 14, 2.0 ** 14]
    assert tskip == jskip == 2
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=FP16_TOL,
                                   atol=FP16_TOL, err_msg=k)
    # a skipped step leaves the parameters: 4 updates moved them
    assert any(np.abs(tp[k] - arrays[k]).max() > 1e-3 for k in tp)


def test_unscale_then_step_equals_step():
    arrays, x, y = _mlp_data()
    amp.init("float16")
    plain, s1, _ = _mlp_fp16(mx, amp, arrays, x, y, 3, ())
    manual, s2, _ = _mlp_fp16(mx, amp, arrays, x, y, 3, (), unscale=True)
    assert s1 == s2
    for k in plain:
        np.testing.assert_array_equal(manual[k], plain[k])


def test_overflow_is_noted_to_telemetry():
    from mxnet_tpu_torch import telemetry
    arrays, x, y = _mlp_data()
    amp.init("float16")
    telemetry.reset()
    try:
        _mlp_fp16(mx, amp, arrays, x, y, 2, (0,))
        assert telemetry.counter_value("integrity.amp_overflow") == 1
        assert telemetry.counter_value("integrity.amp_skipped_steps") == 1
        assert telemetry.counter_value("amp.syncs_saved") == 2 * 3
    finally:
        telemetry.reset()


def test_convert_model_same_dtypes_and_values():
    jnet, tnet, x, _ = _cnn_pair()
    jamp.convert_model(jnet, "bfloat16")
    amp.convert_model(tnet, "bfloat16")
    jp = jnet._collect_params_with_prefix()
    tp = tnet._collect_params_with_prefix()
    for k in jp:
        jd, td = jp[k].data(), tp[k].data()
        assert _dt(td.dtype) == _dt(jd.dtype) == "bfloat16", k
        np.testing.assert_array_equal(td.asnumpy(),
                                      jd.asnumpy().astype(np.float32))
    with mx.cpu():
        out = tnet(mx.nd.array(x).astype("bfloat16"))
    assert _dt(out.dtype) == "bfloat16"
    # a parameter not yet initialized takes the type when it is
    late = mx.gluon.nn.Dense(3)
    amp.convert_model(late, "float16")
    assert late.weight.dtype == "float16"


def _module_forward(pkg):
    sym = pkg.sym
    data = sym.Variable("data")
    fc = sym.FullyConnected(data, num_hidden=4, name="fc1")
    act = sym.Activation(fc, act_type="relu", name="relu1")
    out = sym.softmax(sym.FullyConnected(act, num_hidden=3, name="fc2"),
                      name="sm")
    rng = np.random.RandomState(7)
    params = {"fc1_weight": rng.normal(0, 0.5, (4, 6)),
              "fc1_bias": rng.normal(0, 0.1, 4),
              "fc2_weight": rng.normal(0, 0.5, (3, 4)),
              "fc2_bias": rng.normal(0, 0.1, 3)}
    x = rng.normal(size=(5, 6)).astype(np.float32)
    with pkg.cpu():
        mod = pkg.mod.Module(out, data_names=("data",), label_names=None,
                             context=pkg.cpu())
        mod.bind(data_shapes=[("data", (5, 6))], for_training=False)
        mod.init_params(arg_params={k: pkg.nd.array(v.astype(np.float32))
                                    for k, v in params.items()},
                        aux_params={})
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x)]), is_train=False)
        o = mod.get_outputs()[0]
        inner = mod._exec_group.execs[0].outputs[0]
        return _dt(o.dtype), o.asnumpy(), _dt(inner.dtype)


def test_module_forward_under_amp_leaves_the_whole_graph_route():
    from mxnet_tpu_torch import telemetry
    jamp.init("bfloat16")
    amp.init("bfloat16")
    telemetry.reset()
    try:
        want = _module_forward(jmx)
        got = _module_forward(mx)
        assert telemetry.counter_value("compiler.fallback.amp_active") == 1
        assert telemetry.counter_value("compiler.program_runs") == 0
    finally:
        telemetry.reset()
    assert got[0] == want[0] == "float32"
    assert got[2] == want[2]
    np.testing.assert_allclose(got[1], want[1], rtol=GRAD_REL,
                               atol=GRAD_REL)


def test_init_accepts_float16_and_refuses_others():
    with pytest.raises(ValueError):
        amp.init("int8")
    amp.init(np.float16)
    assert amp.amp._target_dtype == "float16"
    with pytest.warns(UserWarning):
        amp.init("bfloat16")
    assert amp.amp._target_dtype == "float16"
    with mx.cpu():
        out = mx.nd.dot(mx.nd.ones((2, 2)), mx.nd.ones((2, 2)))
    assert _dt(out.dtype) == "float16"


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["bfloat16", "float16"])
def test_amp_dtypes_on_the_card(target):
    """Under AMP on the card: the conv output in the target type, the
    BatchNorm output, parameters and gradients float32, the loss finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    amp.init(target)
    net = _cnn(mx)
    net.initialize(ctx=mx.gpu(0))
    seen, logits, grads = _amp_step(mx, amp, net,
                                    np.random.rand(4, 3, 6, 6).astype(
                                        np.float32),
                                    np.array([0, 1, 2, 3], np.float32),
                                    ctx=mx.gpu(0))
    assert ("Conv2D", target) in seen and ("BatchNorm", "float32") in seen
    assert np.isfinite(logits).all()
    assert all(g[1] == g[2] == "float32" for g in grads.values())
