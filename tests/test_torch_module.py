"""The port's `mx.mod` (Module, BucketingModule, the executor group) and
`mx.model` against the JAX package's (modelled on the reference's
tests/test_symbol_module.py and tests/test_compiler.py).

BatchNorm-free graphs train 3 steps from the same seeded parameters and
batches through both packages' Modules; parameters, scores and
predictions agree within 1e-5. For a BatchNorm graph the yardstick is the
reference's imperative Gluon route (`Trainer` + `SoftmaxCrossEntropyLoss`),
which moves the running statistics: its Module does not (pinned by
`test_reference_module_leaves_moving_stats_alone`). A `cuda`-marked test
runs a step of the card path at narrow width.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry

from test_torch_symbol import mlp
from _torch_seed import _seed_torch  # noqa: F401


def _data(n=48, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, 8)).astype("float32")
    w = rng.normal(size=(8, 3)).astype("float32")
    y = np.argmax(x @ w, axis=1).astype("float32")
    params = {"fc1_weight": rng.normal(size=(16, 8)) * 0.3,
              "fc1_bias": rng.normal(size=16) * 0.1,
              "fc2_weight": rng.normal(size=(3, 16)) * 0.3,
              "fc2_bias": rng.normal(size=3) * 0.1}
    return x, y, {k: v.astype("float32") for k, v in params.items()}


def _fit(pkg, ctxs, x, y, params, kvstore="local", epochs=1, **mod_kw):
    with pkg.cpu():
        it = pkg.io.NDArrayIter(x, y, batch_size=16,
                                label_name="softmax_label")
        mod = pkg.mod.Module(mlp(pkg.sym), context=ctxs,
                             label_names=("softmax_label",), **mod_kw)
        mod.fit(it, num_epoch=epochs, optimizer="sgd", kvstore=kvstore,
                optimizer_params={"learning_rate": 0.5, "momentum": 0.9,
                                  "wd": 1e-3},
                arg_params={k: pkg.nd.array(v) for k, v in params.items()},
                aux_params={})
        args, _ = mod.get_params()
        return (mod, it, {k: v.asnumpy() for k, v in args.items()},
                mod.score(it, "acc"), mod.predict(it).asnumpy())


def _assert_params_close(got, want, tol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol,
                                   atol=tol * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("route", ["whole_graph", "op_by_op"])
def test_module_fit_score_predict_match_reference(route):
    x, y, params = _data()
    _, _, got, score, pred = _fit(mx, [mx.cpu()], x, y, params,
                                  compile_graph=route == "whole_graph")
    _, _, want, rscore, rpred = _fit(jmx, [jmx.cpu()], x, y, params)
    _assert_params_close(got, want)
    assert score == rscore
    np.testing.assert_allclose(pred, rpred, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kvstore", ["local", "device"])
def test_module_multi_context_matches_reference(kvstore):
    """The batch sliced over cpu(0) and cpu(1), gradients summed in the
    port's KVStoreLocal (the optimizer runs on the store)."""
    x, y, params = _data(seed=1)
    mod, _, got, score, pred = _fit(mx, [mx.cpu(0), mx.cpu(1)], x, y,
                                    params, kvstore=kvstore)
    assert type(mod._kvstore).__name__ == "KVStoreLocal"
    assert mod._update_on_kvstore
    _, _, want, rscore, rpred = _fit(jmx, [jmx.cpu(0), jmx.cpu(1)], x, y,
                                     params, kvstore=kvstore)
    _assert_params_close(got, want)
    assert score == rscore
    np.testing.assert_allclose(pred, rpred, rtol=1e-5, atol=1e-6)
    # and the same as one context
    _, _, one, _, _ = _fit(mx, [mx.cpu()], x, y, params)
    _assert_params_close(got, one)


def test_one_local_context_updates_through_the_updater():
    x, y, params = _data()
    mod, _, _, _, _ = _fit(mx, [mx.cpu()], x, y, params)
    assert mod._kvstore is None and not mod._update_on_kvstore
    assert type(mod._updater).__name__ == "Updater"
    assert sorted(mod._updater.states) == list(range(4))


def _bucket_batch(pkg, T, seed):
    rng = np.random.RandomState(seed)
    x = pkg.nd.array(rng.normal(size=(8, T, 6)).astype("float32"))
    y = pkg.nd.array(rng.randint(0, 4, 8).astype("float32"))
    b = pkg.io.DataBatch([x], [y],
                         provide_data=[pkg.io.DataDesc("data", (8, T, 6))],
                         provide_label=[pkg.io.DataDesc("softmax_label",
                                                        (8,))])
    b.bucket_key = T
    return b


def _bucketing(pkg, w, b):
    def sym_gen(T):
        data = pkg.sym.var("data")
        fc = pkg.sym.FullyConnected(data, name="fc", num_hidden=4,
                                    flatten=False)
        pooled = pkg.sym.mean(fc, axis=1, name="pool")
        return pkg.sym.SoftmaxOutput(pooled, name="softmax"), ("data",), \
            ("softmax_label",)
    with pkg.cpu():
        mod = pkg.mod.BucketingModule(sym_gen, default_bucket_key=10,
                                      context=pkg.cpu())
        first = _bucket_batch(pkg, 10, 0)
        mod.bind(data_shapes=first.provide_data,
                 label_shapes=first.provide_label)
        mod.init_params(arg_params={"fc_weight": pkg.nd.array(w),
                                    "fc_bias": pkg.nd.array(b)},
                        aux_params={})
        mod.init_optimizer(kvstore=None, optimizer="sgd",
                           optimizer_params={"learning_rate": 0.3})
        outs = []
        for T, seed in ((10, 0), (5, 1), (10, 2), (7, 3)):
            mod.forward(_bucket_batch(pkg, T, seed), is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        args, _ = mod.get_params()
        return outs, {k: v.asnumpy() for k, v in args.items()}


def test_bucketing_module_matches_reference():
    rng = np.random.RandomState(3)
    w = rng.normal(size=(4, 6)).astype("float32") * 0.3
    b = np.zeros(4, "float32")
    outs, got = _bucketing(mx, w, b)
    routs, want = _bucketing(jmx, w, b)
    for o, r in zip(outs, routs):
        assert o.shape == (8, 4)
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-6)
    _assert_params_close(got, want)


def test_checkpoints_cross_both_packages(tmp_path):
    """Module.save_checkpoint and do_checkpoint write files the reference
    loads (and the other way round); a reloaded module predicts bit-equal
    and resumes from the saved optimizer states."""
    x, y, params = _data(seed=2)
    mod, it, args, _, pred = _fit(mx, [mx.cpu()], x, y, params)
    prefix = str(tmp_path / "mlp")
    mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    sym, rargs, raux = jmx.model.load_checkpoint(prefix, 3)
    assert sym.tojson() == mod.symbol.tojson()
    _assert_params_close({k: v.asnumpy() for k, v in rargs.items()}, args,
                         tol=0)
    with mx.cpu():
        mod2 = mx.mod.Module.load(prefix, 3, load_optimizer_states=True,
                                  context=mx.cpu(),
                                  label_names=("softmax_label",))
        mod2.bind(data_shapes=it.provide_data,
                  label_shapes=it.provide_label)
        mod2.init_optimizer(optimizer="sgd",
                            optimizer_params={"learning_rate": 0.5,
                                              "momentum": 0.9, "wd": 1e-3})
        np.testing.assert_array_equal(mod2.predict(it).asnumpy(), pred)
        assert sorted(mod2._updater.states) == sorted(mod._updater.states)
        for k, s in mod._updater.states.items():
            np.testing.assert_array_equal(mod2._updater.states[k].asnumpy(),
                                          s.asnumpy())
        # one more step from each copy lands on the same parameters
        it.reset()
        batch = next(iter(it))
        for m in (mod, mod2):
            m.forward_backward(batch)
            m.update()
        _assert_params_close(
            {k: v.asnumpy() for k, v in mod2.get_params()[0].items()},
            {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, tol=0)
    # the reference's checkpoint into the port
    rprefix = str(tmp_path / "ref")
    jmx.model.save_checkpoint(rprefix, 1, jmx.sym.load(prefix +
                                                        "-symbol.json"),
                              {k: jmx.nd.array(v) for k, v in args.items()},
                              {})
    psym, pargs, paux = mx.model.load_checkpoint(rprefix, 1)
    assert psym.tojson() == mod.symbol.tojson() and paux == {}
    _assert_params_close({k: v.asnumpy() for k, v in pargs.items()}, args,
                         tol=0)
    assert all(v.context == mx.cpu() for v in pargs.values())


def test_fit_callbacks_monitor_and_optimizer_states(tmp_path, caplog):
    x, y, params = _data(seed=4)
    prefix = str(tmp_path / "cb")
    seen = []
    mon = mx.monitor.Monitor(1, pattern="fc2_.*")
    with mx.cpu(), caplog.at_level(logging.INFO):
        it = mx.io.NDArrayIter(x, y, batch_size=16,
                               label_name="softmax_label")
        mod = mx.mod.Module(mlp(mx.sym), context=mx.cpu())
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                initializer=mx.init.Xavier(),
                batch_end_callback=[lambda p: seen.append(p.nbatch),
                                    mx.callback.Speedometer(16, 1)],
                epoch_end_callback=mx.callback.do_checkpoint(prefix),
                monitor=mon)
        mod.save_optimizer_states(prefix + ".states")
        mod.load_optimizer_states(prefix + ".states")
    assert seen == [0, 1, 2, 0, 1, 2]
    assert (tmp_path / "cb-0001.params").exists()
    assert (tmp_path / "cb-0002.params").exists()
    assert any("fc2_weight" in r.getMessage() for r in caplog.records)
    assert any("samples/sec" in r.getMessage() for r in caplog.records)


def test_set_get_params_and_reshape():
    x, y, params = _data(seed=5)
    with mx.cpu():
        mod = mx.mod.Module(mlp(mx.sym), context=mx.cpu())
        mod.bind(data_shapes=[("data", (16, 8))],
                 label_shapes=[("softmax_label", (16,))])
        mod.set_params({k: mx.nd.array(v) for k, v in params.items()}, {})
        args, aux = mod.get_params()
        _assert_params_close({k: v.asnumpy() for k, v in args.items()},
                             params, tol=0)
        mod.reshape(data_shapes=[("data", (5, 8))],
                    label_shapes=[("softmax_label", (5,))])
        out = mod.predict(mx.nd.array(x[:5]))
        assert out.shape == (5, 3)
        assert mod.output_shapes == [("softmax", (5, 3))]


def test_print_summary_counts_parameters_like_reference(capsys):
    from test_torch_symbol import resnetish
    got = mx.viz.print_summary(resnetish(mx.sym), shape={"data": (2, 3, 8,
                                                                  8)})
    want = jmx.viz.print_summary(resnetish(jmx.sym),
                                 shape={"data": (2, 3, 8, 8)})
    assert got == want > 0


def test_feedforward_fits_through_module():
    x, y, params = _data(seed=6)
    with mx.cpu(), pytest.warns(DeprecationWarning):
        model = mx.model.FeedForward(
            mlp(mx.sym), ctx=mx.cpu(), num_epoch=2, numpy_batch_size=16,
            learning_rate=0.5,
            arg_params={k: mx.nd.array(v) for k, v in params.items()},
            aux_params={})
        model.fit(mx.nd.array(x), mx.nd.array(y))
        assert model.predict(mx.nd.array(x)).shape == (48, 3)


# ---------------------------------------------------------------------------
# BatchNorm graphs: the port's Module against the reference's Gluon route
# ---------------------------------------------------------------------------
B, HW, CLASSES = 4, 32, 10


def _narrow_resnet18(pkg):
    """resnet18_v1's blocks and depth ([2, 2, 2, 2] basic blocks) at
    narrow widths, 10 classes, with the 3x3 stem for 32x32 inputs."""
    res = pkg.gluon.model_zoo.vision.resnet
    with pkg.name.NameManager():
        return res.ResNetV1(res.BasicBlockV1, [2, 2, 2, 2],
                            [8, 8, 16, 32, 64], classes=CLASSES,
                            thumbnail=True)


def _resnet_pair(tmp_path):
    rng = np.random.RandomState(0)
    xs = [rng.standard_normal((B, 3, HW, HW)).astype("f") for _ in range(2)]
    ys = [rng.randint(0, CLASSES, B).astype("f") for _ in range(2)]
    jnet = _narrow_resnet18(jmx)
    jnet.initialize(ctx=jmx.cpu())
    with jmx.autograd.predict_mode():
        jnet(jmx.nd.array(xs[0]))
    for k, p in jnet._collect_params_with_prefix().items():
        shape = p.shape
        if k.endswith(("gamma", "running_var")):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(("beta", "running_mean", "bias")):
            a = rng.randn(*shape) * 0.1
        else:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape) / shape[0])
        p.set_data(jmx.nd.array(a.astype("f")))
    path = str(tmp_path / "r18.params")
    jnet.save_parameters(path)
    with mx.cpu():
        net = _narrow_resnet18(mx)
        net.load_parameters(path, ctx=mx.cpu())
    return jnet, net, xs, ys


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_batchnorm_graph_module_matches_reference_gluon(tmp_path):
    """2 SGD-momentum steps of the narrow ResNet-18 traced to a symbol and
    trained through the port's Module, against the reference's Gluon
    Trainer on the same net: every parameter and running statistic within
    1e-4 (relative L2), and no whole-graph fallback counted (the counters
    are process-wide: reset first, so only this test's executors count)."""
    jnet, net, xs, ys = _resnet_pair(tmp_path)
    telemetry.reset()
    with mx.cpu():
        sym = mx.sym.SoftmaxOutput(net(mx.sym.var("data")), name="softmax")
        aux_names = set(sym.list_auxiliary_states())
        params = net.collect_params()
        mod = mx.mod.Module(sym, context=mx.cpu())
        mod.bind(data_shapes=[("data", (B, 3, HW, HW))],
                 label_shapes=[("softmax_label", (B,))])
        mod.init_params(
            arg_params={n: p.data() for n, p in params.items()
                        if n not in aux_names},
            aux_params={n: p.data() for n, p in params.items()
                        if n in aux_names})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.05, "momentum": 0.9})
        for x, y in zip(xs, ys):
            mod.forward_backward(mx.io.DataBatch([mx.nd.array(x)],
                                                 [mx.nd.array(y)]))
            mod.update()
        args, auxs = mod.get_params()
    trainer = jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9})
    sce = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in zip(xs, ys):
        with jmx.autograd.record():
            loss = sce(jnet(jmx.nd.array(x)), jmx.nd.array(y))
        loss.backward()
        trainer.step(B)
    pnames = {k: p.name for k, p in net._collect_params_with_prefix().items()}
    moved = 0
    for k, jp in jnet._collect_params_with_prefix().items():
        name = pnames[k]
        got = (args[name] if name in args else auxs[name]).asnumpy()
        want = jp.data().asnumpy()
        assert _rel(got, want) <= 1e-4, (k, _rel(got, want))
        if k.endswith("running_mean"):
            before = params[name].data().asnumpy()
            moved += not np.array_equal(got, before)
    assert moved == len(aux_names) // 2 == 19
    assert telemetry.counter_value("compiler.fallback") == 0


def test_reference_module_leaves_moving_stats_alone():
    """Pins the reference defect the port does not copy: after training
    steps through the reference's Module, `moving_mean` is still 0 on both
    of its routes (its executor never applies the update its BatchNorm op
    leaves to the caller); the port's moves it."""
    def graph(S):
        h = S.Convolution(S.var("data"), name="c", num_filter=4,
                          kernel=(3, 3), pad=(1, 1))
        h = S.BatchNorm(h, name="bn", fix_gamma=False)
        h = S.FullyConnected(h, name="fc", num_hidden=3)
        return S.SoftmaxOutput(h, name="softmax")
    rng = np.random.RandomState(0)
    x = rng.normal(size=(8, 2, 5, 5)).astype("f") + 3.0
    y = rng.randint(0, 3, 8).astype("f")
    moving = {}
    for name, pkg, cg in (("ref_whole", jmx, True), ("ref_op", jmx, False),
                          ("port_whole", mx, True), ("port_op", mx, False)):
        pkg.random.seed(0)
        with pkg.cpu():
            it = pkg.io.NDArrayIter(x, y, batch_size=4,
                                    label_name="softmax_label")
            mod = pkg.mod.Module(graph(pkg.sym), context=pkg.cpu(),
                                 compile_graph=cg)
            mod.fit(it, num_epoch=1, optimizer="sgd",
                    initializer=pkg.init.Xavier(),
                    optimizer_params={"learning_rate": 0.01})
            moving[name] = mod.get_params()[1]["bn_moving_mean"].asnumpy()
    np.testing.assert_array_equal(moving["ref_whole"], np.zeros(4))
    np.testing.assert_array_equal(moving["ref_op"], np.zeros(4))
    assert np.all(moving["port_whole"] != 0)
    np.testing.assert_allclose(moving["port_whole"], moving["port_op"],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_module_step_on_the_card_launches_flat_sgd_per_parameter(tmp_path):
    """One Module.fit step of the narrow ResNet-18 on the card: one
    `single` flat_sgd launch per trainable argument, no fallback, and the
    parameters within 1e-4 (relative L2) of the same step on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    _, net, xs, ys = _resnet_pair(tmp_path)
    with mx.cpu():
        sym = mx.sym.SoftmaxOutput(net(mx.sym.var("data")), name="softmax")
        aux_names = set(sym.list_auxiliary_states())
        argp = {n: p.data() for n, p in net.collect_params().items()
                if n not in aux_names}
        auxp = {n: p.data() for n, p in net.collect_params().items()
                if n in aux_names}
    n_trainable = len(sym.list_arguments()) - 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    for ctx in (mx.gpu(0), mx.cpu()):
        with mx.cpu():
            it = mx.io.NDArrayIter(xs[0], ys[0], batch_size=B,
                                   label_name="softmax_label")
        mod = mx.mod.Module(sym, context=ctx)
        telemetry.reset()
        reset_launch_counts()
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                arg_params=argp, aux_params=auxp)
        if ctx.device_type == "gpu":
            launches = launch_counts()
            assert launches["flat_sgd"] == n_trainable, launches
            assert variant_counts() == {("flat_sgd", "single"):
                                        n_trainable}
            assert sum(launches.values()) == n_trainable
        assert telemetry.counter_value("compiler.fallback") == 0
        results.append({k: v.asnumpy()
                        for k, v in mod.get_params()[0].items()})
    for k in results[1]:
        assert _rel(results[0][k], results[1][k]) <= 1e-4, k
