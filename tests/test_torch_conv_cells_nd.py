"""The 1-D and 3-D convolutional recurrent cells of `gluon.contrib.rnn`
against the reference's, on the port's new 1-D and 3-D `Convolution`.

The reference's cell is initialized (Xavier weights, random biases) and
hybridized, its parameters are copied into the port's by name, and both
unroll the same seeded sequence under `autograd.record()`: outputs,
final states and the i2h/h2h weight gradients of the summed outputs
within 1e-5 (fp32), channels first and channels last."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from _torch_seed import _seed_torch  # noqa: F401

TOL = 1e-5

CASES = [("Conv1DLSTMCell", (3, 10), "NCW"), ("Conv1DGRUCell", (3, 10), "NCW"),
         ("Conv1DRNNCell", (10, 3), "NWC"),
         ("Conv3DLSTMCell", (2, 4, 5, 3), "NCDHW"),
         ("Conv3DGRUCell", (4, 5, 3, 2), "NDHWC"),
         ("Conv3DRNNCell", (2, 4, 5, 3), "NCDHW")]


def _make(pkg, cls_name, input_shape, layout):
    return getattr(pkg.gluon.contrib.rnn, cls_name)(
        input_shape=input_shape, hidden_channels=4, i2h_kernel=3,
        h2h_kernel=3, i2h_pad=1, conv_layout=layout, prefix="conv_")


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=TOL * max(1.0, np.abs(b).max()),
                               err_msg=what)


@pytest.mark.parametrize("cls_name,input_shape,layout", CASES)
def test_nd_conv_cells_unroll_and_grad_match_reference(cls_name,
                                                       input_shape, layout):
    x = np.random.RandomState(0).rand(2, 2, *input_shape).astype("float32")
    rng = np.random.RandomState(3)
    jc = _make(jmx, cls_name, input_shape, layout)
    jc.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    jc.hybridize()      # one compiled program a step, not one an op
    with mx.cpu():
        pc = _make(mx, cls_name, input_shape, layout)
        pc.initialize(ctx=mx.cpu())
    for k, p in jc.collect_params().items():
        if p.name.endswith("bias"):
            p.set_data(jmx.nd.array(rng.randn(*p.shape).astype("float32")
                                    * 0.1))
        pc.collect_params()[k].set_data(
            mx.nd.array(p.data().asnumpy(), ctx=mx.cpu()))
    res = []
    for pkg, cell in ((jmx, jc), (mx, pc)):
        with pkg.cpu():
            with pkg.autograd.record():
                outs, states = cell.unroll(2, pkg.nd.array(x), layout="NTC",
                                           merge_outputs=True)
                loss = outs.sum()
            loss.backward()
            res.append([outs.asnumpy()] + [s.asnumpy() for s in states] +
                       [cell.i2h_weight.grad().asnumpy(),
                        cell.h2h_weight.grad().asnumpy()])
    want, got = res
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, "%s item %d" % (cls_name, i))
    assert np.abs(got[-1]).max() > 0
