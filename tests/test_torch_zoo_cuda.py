"""The model zoo's training paths on the card (`cuda`-marked; they skip on
a host without one). This file imports no JAX: the card is held to the
port's own CPU route.

Inception-v3's Trainer("sgd", momentum) step hands every trainable tensor
to the aggregated update: one `multi` flat_sgd launch per table of the
kernel's capacity (320 tensors), and no other kernel of the port. The
DCGAN of examples/dcgan.py at ngf = ndf = 16 takes one `multi` flat_adam
launch per Trainer a step; its losses and parameters after the step agree
with the same step on the CPU within TOL (fp32, TF32 off)."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx

TOL = 1e-5
ADAM = {"learning_rate": 2e-4, "beta1": 0.5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield mx.gpu(0)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = allow


@pytest.mark.cuda
def test_inception_v3_trainer_step_on_the_card(card):
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    with card:
        net = mx.gluon.model_zoo.vision.get_model("inceptionv3")
        net.initialize(mx.init.Xavier(), ctx=card)
        net.hybridize()
        x = mx.nd.array(np.random.RandomState(0).rand(2, 3, 299, 299),
                        ctx=card)
        y = mx.nd.array([1, 2], ctx=card)
        net(x)
        n = sum(p.grad_req != "null" for p in net.collect_params().values())
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4})
        sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        before = net.output.weight.data().asnumpy()
        reset_launch_counts()
        with mx.autograd.record():
            loss = sce(net(x), y)
        loss.backward()
        trainer.step(2)
        torch.cuda.synchronize()
        launches = -(-n // 320)
        assert variant_counts() == {("flat_sgd", "multi"): launches}
        assert sum(launch_counts().values()) == launches
        assert np.isfinite(loss.asnumpy()).all()
        assert not np.array_equal(net.output.weight.data().asnumpy(), before)


def _dcgan(ngf=16, ndf=16):
    """examples/dcgan.py's build_generator and build_discriminator."""
    nn = mx.gluon.nn
    gen = nn.HybridSequential(prefix="gen_")
    with gen.name_scope():
        for ch, stride, pad in ((ngf * 4, 1, 0), (ngf * 2, 2, 1),
                                (ngf, 2, 1)):
            gen.add(nn.Conv2DTranspose(ch, 4, strides=stride, padding=pad,
                                       use_bias=False))
            gen.add(nn.BatchNorm(), nn.Activation("relu"))
        gen.add(nn.Conv2DTranspose(3, 4, strides=2, padding=1,
                                   use_bias=False))
        gen.add(nn.Activation("tanh"))
    disc = nn.HybridSequential(prefix="disc_")
    with disc.name_scope():
        disc.add(nn.Conv2D(ndf, 4, strides=2, padding=1, use_bias=False))
        disc.add(nn.LeakyReLU(0.2))
        for ch in (ndf * 2, ndf * 4):
            disc.add(nn.Conv2D(ch, 4, strides=2, padding=1, use_bias=False))
            disc.add(nn.BatchNorm(), nn.LeakyReLU(0.2))
        disc.add(nn.Conv2D(1, 4, strides=1, padding=0, use_bias=False))
    return gen, disc


def _dcgan_step(ctx, state, latent, real):
    gen, disc = _dcgan()
    for net, arrays in zip((gen, disc), state):
        net.initialize(ctx=ctx)
        for k, p in net._collect_params_with_prefix().items():
            p._load_init(mx.nd.array(arrays[k], ctx=mx.cpu()), ctx)
        net.hybridize(static_alloc=True)
    trainer_g, trainer_d = [mx.gluon.Trainer(n.collect_params(), "adam",
                                             dict(ADAM)) for n in (gen, disc)]
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    b = latent.shape[0]
    with ctx:
        ones, zeros = mx.nd.ones((b,), ctx=ctx), mx.nd.zeros((b,), ctx=ctx)
        real, latent = mx.nd.array(real, ctx=ctx), mx.nd.array(latent,
                                                               ctx=ctx)
        with mx.autograd.record():
            fake = gen(latent)
            err_d = loss_fn(disc(real).reshape((-1,)), ones) + loss_fn(
                disc(fake.detach()).reshape((-1,)), zeros)
        err_d.backward()
        trainer_d.step(b)
        with mx.autograd.record():
            err_g = loss_fn(disc(fake).reshape((-1,)), ones)
        err_g.backward()
        trainer_g.step(b)
    params = {k: p.data().asnumpy() for net in (gen, disc)
              for k, p in net.collect_params().items()}
    return err_d.asnumpy(), err_g.asnumpy(), params


@pytest.mark.cuda
def test_dcgan_trainer_steps_on_the_card(card):
    from mxnet_tpu_torch.ops import reset_launch_counts, variant_counts
    rng = np.random.RandomState(0)
    latent = rng.randn(8, 100, 1, 1).astype(np.float32)
    real = np.tanh(rng.randn(8, 3, 32, 32)).astype(np.float32)
    with mx.cpu():
        gen, disc = _dcgan()
        mx.random.seed(0)
        for net in (gen, disc):
            net.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
        disc(gen(mx.nd.array(latent)))
        state = [{k: p.data().asnumpy()
                  for k, p in net._collect_params_with_prefix().items()}
                 for net in (gen, disc)]
    want = _dcgan_step(mx.cpu(), state, latent, real)
    reset_launch_counts()
    got = _dcgan_step(card, state, latent, real)
    torch.cuda.synchronize()
    assert variant_counts() == {("flat_adam", "multi"): 2}
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    for k, w in want[2].items():
        g = got[2][k]
        assert np.linalg.norm(g - w) <= TOL * np.linalg.norm(w), k
