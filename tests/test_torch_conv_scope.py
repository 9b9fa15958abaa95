"""The port's convolutions keep fp32 numerics without changing the
caller's cuDNN TF32 switch: `torch.backends.cudnn.allow_tf32` reads the
same after a forward and a backward of the `Convolution` op (and of the
fused conv block's plain convolutions) as before, whether the caller set
it True or False, and reads False while the port's convolutions run,
the backward included (autograd's own convolution backward would read the
switch only when the backward runs); the gradients and their strides
are autograd's own for F.conv2d. `cuda`-marked tests hold the port's conv
output and weight gradient on the card to a float64 CPU result within
1e-5 with the caller's switch True (TF32 would miss by about 1e-3), the
switch still True afterwards, and the gradients' values and strides to
autograd's on the card.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import fused_conv
from mxnet_tpu_torch.ops import nn as port_nn


@pytest.fixture
def user_flag(request):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = request.param
    yield request.param
    torch.backends.cudnn.allow_tf32 = prev


def _spy(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        seen.append((name, torch.backends.cudnn.allow_tf32))
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("user_flag", [True, False], indirect=True)
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_convolution_leaves_the_callers_switch(monkeypatch, user_flag,
                                               layout):
    seen = []
    _spy(monkeypatch, torch.nn.functional, "conv2d", seen)
    _spy(monkeypatch, torch.ops.aten, "convolution_backward", seen)
    rng = np.random.RandomState(0)
    shape = (2, 3, 8, 8) if layout == "NCHW" else (2, 8, 8, 3)
    with mx.cpu():
        x = mx.nd.array(rng.randn(*shape))
        w = mx.nd.array(rng.randn(4, 3, 3, 3))    # OIHW, or OHWI for NHWC
        b = mx.nd.array(rng.randn(4))
        for a in (x, w, b):
            a.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Convolution(x, w, b, kernel=(3, 3), pad=(1, 1),
                                  num_filter=4, layout=layout)
            assert torch.backends.cudnn.allow_tf32 is user_flag
            loss = (y * y).sum()
        loss.backward()
    assert torch.backends.cudnn.allow_tf32 is user_flag
    assert [n for n, _ in seen] == ["conv2d", "convolution_backward"]
    assert all(flag is False for _, flag in seen), seen
    assert np.abs(w.grad.asnumpy()).max() > 0


def _grads_against_autograd(layout, device):
    """The scoped backward is the one autograd runs for F.conv2d: the same
    values, and a weight gradient as contiguous as the weight (an OHWI
    weight reaches the conv as a permuted view; the optimizer kernels take
    contiguous gradients only)."""
    rng = np.random.RandomState(3)
    shape = (2, 5, 6, 6) if layout == "NCHW" else (2, 6, 6, 5)

    def leaf(a):
        return torch.tensor(a, dtype=torch.float32, device=device,
                            requires_grad=True)
    x = leaf(rng.randn(*shape))
    w = leaf(rng.randn(4, 5, 3, 3) if layout == "NCHW"
             else rng.randn(4, 3, 3, 5))
    b = leaf(rng.randn(4))
    y = port_nn._convolution(x, w, b, kernel=(3, 3), stride=(2, 1),
                             pad=(1, 0), num_filter=4, layout=layout)
    (y * y).sum().backward()
    got = [t.grad for t in (x, w, b)]
    x2, w2, b2 = (t.detach().clone().requires_grad_() for t in (x, w, b))
    last = layout == "NHWC"
    with port_nn.cudnn_fp32():
        y2 = torch.nn.functional.conv2d(
            x2.permute(0, 3, 1, 2) if last else x2,
            w2.permute(0, 3, 1, 2) if last else w2, b2, (2, 1), (1, 0))
        y2 = y2.permute(0, 2, 3, 1) if last else y2
        (y2 * y2).sum().backward()
    assert torch.equal(y, y2)
    for a, ref in zip(got, (x2.grad, w2.grad, b2.grad)):
        assert torch.equal(a, ref)
        assert a.stride() == ref.stride()
    assert got[1].is_contiguous()


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_gradients_equal_autograds_own_and_keep_its_layout(layout):
    _grads_against_autograd(layout, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_card_gradients_equal_autograds_own_and_keep_its_layout(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _grads_against_autograd(layout, "cuda")


@pytest.mark.parametrize("user_flag", [True, False], indirect=True)
def test_fused_block_plain_convolutions_leave_the_callers_switch(user_flag):
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(1, 4, 4, 2), dtype=torch.float32)
    w = torch.tensor(rng.randn(3, 3, 2, 5), dtype=torch.float32)
    out = fused_conv._conv3x3_same(x, w)
    assert torch.backends.cudnn.allow_tf32 is user_flag
    dx, dw = fused_conv._conv3x3_backward(x, w, torch.ones_like(out))
    assert torch.backends.cudnn.allow_tf32 is user_flag
    assert dx.shape == x.shape and dw.shape == w.shape


def test_scope_restores_after_an_exception():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            with port_nn.cudnn_fp32():
                assert torch.backends.cudnn.allow_tf32 is False
                raise RuntimeError("inside")
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
def test_card_convolution_is_fp32_under_a_tf32_caller():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        rng = np.random.RandomState(2)
        xs = rng.randn(8, 64, 28, 28).astype("float32")
        ws = (rng.randn(128, 64, 3, 3) * 0.05).astype("float32")
        with mx.gpu(0):
            x = mx.nd.array(xs)
            w = mx.nd.array(ws)
            w.attach_grad()
            with mx.autograd.record():
                y = mx.nd.Convolution(x, w, None, kernel=(3, 3), pad=(1, 1),
                                      num_filter=128, no_bias=True)
                loss = y.sum()
            loss.backward()
            got_y, got_gw = y.asnumpy(), w.grad.asnumpy()
        assert torch.backends.cudnn.allow_tf32 is True
        x64 = torch.tensor(xs, dtype=torch.float64)
        w64 = torch.tensor(ws, dtype=torch.float64, requires_grad=True)
        y64 = torch.nn.functional.conv2d(x64, w64, padding=1)
        y64.sum().backward()
        want_y, want_gw = y64.detach().numpy(), w64.grad.numpy()
        assert np.abs(got_y - want_y).max() <= 1e-5 * np.abs(want_y).max()
        assert np.abs(got_gw - want_gw).max() <= 1e-5 * np.abs(want_gw).max()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
