"""examples/dcgan.py's networks in the port against the reference's, at
ngf = ndf = 8 (the example's 32x32 images, a 100-dim latent, batch 8):
the generator (stacked Conv2DTranspose + BatchNorm + ReLU, tanh) and the
discriminator (strided Conv2D + BatchNorm + LeakyReLU(0.2)), both
hybridized.

The reference's nets are initialized with Normal(0.02) and carried into
the port by `gluon_params_from_jax`, which flips the generator's
transposed kernels (the reference's transposed convolution correlates with
the kernel unflipped; the port's is upstream MXNet's). Forward in both
modes, then one step of the example's alternating updates (discriminator
on real and detached fake, then generator through the discriminator) with
two Trainer("adam", lr 2e-4, beta1 0.5): losses and every parameter of
both nets within TOL (fp32); the generator's transposed kernels compared
flipped back. Latents and images are seeded numpy, not either package's
generator. The card's Trainer steps are tested in
tests/test_torch_zoo_cuda.py."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import gluon_params_from_jax

TOL = 1e-5
NGF = NDF = 8
LATENT, BATCH = 100, 8
ADAM = {"learning_rate": 2e-4, "beta1": 0.5}


def build_generator(pkg, ngf=32, nc=3):
    """examples/dcgan.py's generator: latent (B, Z, 1, 1) -> image
    (B, nc, 32, 32) in [-1, 1]."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="gen_")
    with net.name_scope():
        net.add(nn.Conv2DTranspose(ngf * 4, 4, strides=1, padding=0,
                                   use_bias=False))
        net.add(nn.BatchNorm(), nn.Activation("relu"))
        net.add(nn.Conv2DTranspose(ngf * 2, 4, strides=2, padding=1,
                                   use_bias=False))
        net.add(nn.BatchNorm(), nn.Activation("relu"))
        net.add(nn.Conv2DTranspose(ngf, 4, strides=2, padding=1,
                                   use_bias=False))
        net.add(nn.BatchNorm(), nn.Activation("relu"))
        net.add(nn.Conv2DTranspose(nc, 4, strides=2, padding=1,
                                   use_bias=False))
        net.add(nn.Activation("tanh"))
    return net


def build_discriminator(pkg, ndf=32):
    """examples/dcgan.py's discriminator: image (B, nc, 32, 32) -> logit
    (B, 1, 1, 1)."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="disc_")
    with net.name_scope():
        net.add(nn.Conv2D(ndf, 4, strides=2, padding=1, use_bias=False))
        net.add(nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(ndf * 2, 4, strides=2, padding=1, use_bias=False))
        net.add(nn.BatchNorm(), nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(ndf * 4, 4, strides=2, padding=1, use_bias=False))
        net.add(nn.BatchNorm(), nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(1, 4, strides=1, padding=0, use_bias=False))
    return net


def _data(seed=0):
    rng = np.random.RandomState(seed)
    latent = rng.randn(BATCH, LATENT, 1, 1).astype(np.float32)
    real = np.tanh(rng.randn(BATCH, 3, 32, 32)).astype(np.float32)
    return latent, real


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _transposed(k):
    """The generator's transposed kernels: every weight of gen_."""
    return k.endswith("weight")


def _nets(pkg, ctx, arrays=None):
    with ctx:
        gen, disc = build_generator(pkg, NGF), build_discriminator(pkg, NDF)
        if arrays is None:
            pkg.random.seed(0)
            gen.initialize(pkg.init.Normal(0.02), ctx=ctx)
            disc.initialize(pkg.init.Normal(0.02), ctx=ctx)
            latent, real = _data()
            gen(pkg.nd.array(latent))
            disc(pkg.nd.array(real))
        else:
            gen.initialize(ctx=ctx)
            disc.initialize(ctx=ctx)
            gluon_params_from_jax(arrays[0], gen, ctx=ctx)
            gluon_params_from_jax(arrays[1], disc, ctx=ctx)
        gen.hybridize(static_alloc=True)
        disc.hybridize(static_alloc=True)
    return gen, disc


def _pair():
    jgen, jdisc = _nets(jmx, jmx.cpu())
    gen, disc = _nets(mx, mx.cpu(), (_params(jgen), _params(jdisc)))
    return (jgen, jdisc), (gen, disc)


def dcgan_step(pkg, gen, disc, trainers, latent, real, ctx):
    """One iteration of examples/dcgan.py's loop: (D loss, G loss)."""
    loss_fn = pkg.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    trainer_g, trainer_d = trainers
    b = latent.shape[0]
    with ctx:
        real_label = pkg.nd.ones((b,), ctx=ctx)
        fake_label = pkg.nd.zeros((b,), ctx=ctx)
        real = pkg.nd.array(real, ctx=ctx)
        latent = pkg.nd.array(latent, ctx=ctx)
        with pkg.autograd.record():
            out_real = disc(real).reshape((-1,))
            err_real = loss_fn(out_real, real_label)
            fake = gen(latent)
            out_fake = disc(fake.detach()).reshape((-1,))
            err_fake = loss_fn(out_fake, fake_label)
            err_d = err_real + err_fake
        err_d.backward()
        trainer_d.step(b)
        with pkg.autograd.record():
            out = disc(fake).reshape((-1,))
            err_g = loss_fn(out, real_label)
        err_g.backward()
        trainer_g.step(b)
        return err_d.asnumpy(), err_g.asnumpy()


def _trainers(pkg, gen, disc):
    return (pkg.gluon.Trainer(gen.collect_params(), "adam", dict(ADAM)),
            pkg.gluon.Trainer(disc.collect_params(), "adam", dict(ADAM)))


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def test_names_and_shapes_match_reference():
    (jgen, jdisc), (gen, disc) = _pair()
    for jnet, net in ((jgen, gen), (jdisc, disc)):
        want = {k: (p.shape, p.name)
                for k, p in jnet._collect_params_with_prefix().items()}
        got = {k: (p.shape, p.name)
               for k, p in net._collect_params_with_prefix().items()}
        assert got == want
    assert gen[0].weight.shape == (LATENT, NGF * 4, 4, 4)


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_reference(train):
    (jgen, jdisc), (gen, disc) = _pair()
    latent, real = _data(1)
    outs = []
    for pkg, g, d in ((jmx, jgen, jdisc), (mx, gen, disc)):
        with pkg.cpu():
            scope = pkg.autograd.train_mode() if train \
                else pkg.autograd.predict_mode()
            with scope:
                img = g(pkg.nd.array(latent))
                outs.append((img.asnumpy(), d(img).asnumpy(),
                             d(pkg.nd.array(real)).asnumpy()))
    (wi, wf, wr), (gi, gf, gr) = outs
    assert gi.shape == (BATCH, 3, 32, 32) and gf.shape == (BATCH, 1, 1, 1)
    assert np.abs(gi).max() <= 1.0
    _close(gi, wi, "generated images")
    _close(gf, wf, "D(G(z))")
    _close(gr, wr, "D(x)")


def test_alternating_adam_step_matches_reference():
    (jgen, jdisc), (gen, disc) = _pair()
    latent, real = _data(2)
    want = dcgan_step(jmx, jgen, jdisc, _trainers(jmx, jgen, jdisc), latent,
                      real, jmx.cpu())
    got = dcgan_step(mx, gen, disc, _trainers(mx, gen, disc), latent, real,
                     mx.cpu())
    _close(got[0], want[0], "D loss")
    _close(got[1], want[1], "G loss")
    before = _nets(jmx, jmx.cpu())
    for jnet, net, start, flip in ((jgen, gen, before[0], True),
                                   (jdisc, disc, before[1], False)):
        pw, pg, p0 = _params(jnet), _params(net), _params(start)
        assert sorted(pg) == sorted(pw)
        for k, w in pw.items():
            if flip and _transposed(k):
                w = np.flip(w, axis=(2, 3))
            _close(pg[k], w, k)
        # every trainable parameter moved (running statistics included)
        assert all(not np.array_equal(pw[k], p0[k]) for k in pw), \
            [k for k in pw if np.array_equal(pw[k], p0[k])]
