"""Gluon's symbolic half in the port: HybridBlocks traced to symbols,
`export`, `SymbolBlock` and `SymbolBlock.imports`, against the port's own
Gluon net and the JAX package's files.

`export` then `SymbolBlock.imports` (or `Module.load`) gives the Gluon
net's predict-mode logits exactly; the exported files load in the
reference with the same names and values; a net the reference exported
loads into the port and matches the reference's Gluon net within rtol
1e-5. A traced Gluon BatchNorm writes `use_global_stats` only when the
block sets it (the reference writes it on every BatchNorm it traces,
because its layer reads `autograd.is_training()`, false while tracing).
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from _torch_seed import _seed_torch  # noqa: F401


def _net(pkg, seed=0):
    res = pkg.gluon.model_zoo.vision.resnet
    with pkg.name.NameManager():
        net = res.ResNetV1(res.BasicBlockV1, [1, 1], [8, 8, 16], classes=10,
                           thumbnail=True)
    return net


def _x(seed=0, n=2):
    return np.random.RandomState(seed).randn(n, 3, 8, 8).astype("float32")


def _trained_port_net():
    """The port's net with Xavier weights and moved running statistics
    (two training forwards), hybridized and run once in predict mode."""
    with mx.cpu():
        mx.random.seed(0)
        net = _net(mx)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        for s in (1, 2):
            with mx.autograd.record():
                net(mx.nd.array(_x(s, 4)))
        net.hybridize()
        want = net(mx.nd.array(_x())).asnumpy()
    return net, want


def test_export_then_imports_and_module_load_give_the_gluon_logits(tmp_path):
    net, want = _trained_port_net()
    sym_file, params_file = net.export(str(tmp_path / "net"), epoch=7)
    assert params_file.endswith("net-0007.params")
    with mx.cpu():
        blk = mx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                           ctx=mx.cpu())
        np.testing.assert_array_equal(blk(mx.nd.array(_x())).asnumpy(),
                                      want)
        mod = mx.mod.Module.load(str(tmp_path / "net"), 7, context=mx.cpu(),
                                 label_names=None)
        mod.bind(data_shapes=[("data", (2, 3, 8, 8))], for_training=False)
        mod.forward(mx.io.DataBatch([mx.nd.array(_x())]), is_train=False)
        np.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(), want)


def test_exported_files_load_in_the_reference(tmp_path):
    net, _ = _trained_port_net()
    sym_file, params_file = net.export(str(tmp_path / "net"))
    rsym = jmx.sym.load(sym_file)
    with mx.cpu():
        psym = net(mx.sym.var("data"))
    assert rsym.list_arguments() == psym.list_arguments()
    assert rsym.list_auxiliary_states() == psym.list_auxiliary_states()
    saved = jmx.nd.load(params_file)
    aux = set(psym.list_auxiliary_states())
    assert sorted(saved) == sorted(
        ("aux:%s" if n in aux else "arg:%s") % n
        for n in net.collect_params().keys())
    for name, p in net.collect_params().items():
        key = ("aux:%s" if name in aux else "arg:%s") % name
        np.testing.assert_array_equal(saved[key].asnumpy(),
                                      p.data().asnumpy())
    # the reference's SymbolBlock takes the files (its evaluation is not
    # compared: it normalizes by the batch's statistics in inference)
    rblk = jmx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                         ctx=jmx.cpu())
    assert sorted(rblk.collect_params().keys()) == \
        sorted(net.collect_params().keys())


def test_a_net_the_reference_exported_loads_into_the_port(tmp_path):
    jnet = _net(jmx)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    rng = np.random.RandomState(3)
    jnet(jmx.nd.array(_x()))
    for name, p in jnet.collect_params().items():
        if name.endswith("running_mean"):
            p.set_data(jmx.nd.array(rng.randn(*p.shape).astype("f") * 0.1))
        elif name.endswith("running_var"):
            p.set_data(jmx.nd.array(rng.uniform(0.5, 1.5, p.shape)
                                    .astype("f")))
    jnet.hybridize()
    with jmx.autograd.predict_mode():
        want = jnet(jmx.nd.array(_x())).asnumpy()
    sym_file, params_file = jnet.export(str(tmp_path / "ref"))
    with mx.cpu():
        blk = mx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                           ctx=mx.cpu())
        got = blk(mx.nd.array(_x())).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("use_global_stats", [False, True])
def test_traced_batchnorm_writes_use_global_stats_only_when_set(
        use_global_stats):
    with mx.cpu():
        bn = mx.gluon.nn.BatchNorm(use_global_stats=use_global_stats)
        out = bn(mx.sym.var("data"))
    (node,) = [n for n in json.loads(out.tojson())["nodes"]
               if n["op"] == "BatchNorm"]
    assert ("use_global_stats" in node["attrs"]) == use_global_stats
    assert node["attrs"]["eps"] == "1e-05"
    assert node["attrs"]["momentum"] == "0.9"
    # the reference writes it on every traced BatchNorm
    ref = jmx.gluon.nn.BatchNorm()(jmx.sym.var("data"))
    (rnode,) = [n for n in json.loads(ref.tojson())["nodes"]
                if n["op"] == "BatchNorm"]
    assert rnode["attrs"]["use_global_stats"] == "True"


def test_traced_resnet50_has_the_reference_graph():
    """resnet50_v1 traced to a symbol: the reference's ops, argument and
    auxiliary names and shapes (the graphs differ only in the BatchNorm
    attribute above)."""
    with mx.cpu():
        net = mx.gluon.model_zoo.vision.resnet50_v1(classes=1000,
                                                     prefix="r50_")
        mine = mx.sym.SoftmaxOutput(net(mx.sym.var("data")), name="softmax")
    jnet = jmx.gluon.model_zoo.vision.resnet50_v1(classes=1000,
                                                  prefix="r50_")
    ref = jmx.sym.SoftmaxOutput(jnet(jmx.sym.var("data")), name="softmax")
    assert mine.list_arguments() == ref.list_arguments()
    assert mine.list_auxiliary_states() == ref.list_auxiliary_states()
    ops = [n["op"] for n in json.loads(mine.tojson())["nodes"]]
    assert ops == [n["op"] for n in json.loads(ref.tojson())["nodes"]]
    assert mine.infer_shape(data=(2, 3, 224, 224)) == \
        ref.infer_shape(data=(2, 3, 224, 224))
    assert len(mine.list_arguments()) - 2 == 193


def test_hybrid_block_infer_shape_and_type():
    with mx.cpu():
        net = _net(mx)
        net.initialize(ctx=mx.cpu())
        net.infer_shape(mx.nd.array(_x()))
        net.infer_type(mx.nd.array(_x()))
        shapes = {k: p.shape for k, p in net.collect_params().items()}
        ref = _net(mx)
        ref.initialize(ctx=mx.cpu())
        ref(mx.nd.array(_x()))
        assert shapes == {k: p.shape for k, p in
                          ref.collect_params().items()}
        assert all(0 not in s for s in shapes.values())


def test_symbol_block_composes_trains_and_moves_running_stats():
    with mx.cpu():
        data = mx.sym.var("data")
        h = mx.sym.Convolution(data, name="c", num_filter=4, kernel=(3, 3))
        h = mx.sym.BatchNorm(h, name="bn", fix_gamma=False)
        blk = mx.gluon.SymbolBlock(h, data)
        blk.initialize(ctx=mx.cpu())
        assert sorted(blk.collect_params().keys()) == [
            "bn_beta", "bn_gamma", "bn_moving_mean", "bn_moving_var",
            "c_bias", "c_weight"]
        # deferred shapes resolve on the first forward's inputs only when
        # given; set them here as a loaded model would have them
        for name, shape in zip(h.list_arguments()[1:] +
                               h.list_auxiliary_states(),
                               h.infer_shape(data=(2, 3, 6, 6))[0][1:] +
                               h.infer_shape(data=(2, 3, 6, 6))[2]):
            p = blk.collect_params()[name]
            p.shape = shape
            p._finish_deferred_init()
        composed = blk(mx.sym.var("x"))
        assert composed.list_arguments()[0] == "x"
        x = mx.nd.array(_x(4, 2)[:, :, :6, :6])
        trainer = mx.gluon.Trainer(blk.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        before = blk.collect_params()["bn_moving_mean"].data().asnumpy()
        # a sum of squares: the plain sum of a BatchNorm output has a zero
        # gradient with respect to the conv weight in exact arithmetic, so
        # its sign was the rounding's
        with mx.autograd.record():
            loss = blk(x).square().sum()
        loss.backward()
        trainer.step(2)
        after = blk.collect_params()["bn_moving_mean"].data().asnumpy()
        assert not np.array_equal(before, after)
        grad = blk.collect_params()["c_weight"].grad().asnumpy()
        assert np.abs(grad).sum() > 0
