"""The functional ResNet of the port (`models.resnet`) against the
reference's (`mxnet_tpu.models.resnet`, the model of bench.py's
functional benchmark) at its tiny configuration: the reference's
parameter tree (seeded `jax.random`, BatchNorm running statistics drawn
away from their defaults) carried over by `params_from_jax`, the same
seeded NHWC images and labels. Predict-mode logits, the training loss and
its batch statistics, the gradient of every leaf (`jax.grad` against
torch.autograd) and `update_running_stats`, at fp32 within FP32_TOL of the
largest reference value (only the summation order differs), at even and
odd image sizes (XLA's "SAME" padding puts the odd pixel on the high
side); and at bf16, the configuration's own dtype, within BF16_REL."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models import resnet as jres
from mxnet_tpu_torch.models import params_from_jax
from mxnet_tpu_torch.models import resnet as pres

FP32_TOL = 1e-5
BF16_REL = 3e-2         # ||a - b|| / ||b||: every layer rounds to bf16


def _configs(dtype):
    jd, pd = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(jres.CONFIGS["resnet_tiny"], dtype=jd),
            dataclasses.replace(pres.CONFIGS["resnet_tiny"], dtype=pd))


def _setup(dtype, hw, batch=4, seed=0):
    jcfg, pcfg = _configs(dtype)
    jparams = jres.resnet_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)

    def stats(node):
        if isinstance(node, dict):
            if "mean" in node:
                node["mean"] = jnp.asarray(
                    rng.randn(*node["mean"].shape).astype(np.float32) * 0.1)
                node["var"] = jnp.asarray(rng.uniform(
                    0.5, 1.5, node["var"].shape).astype(np.float32))
            for v in node.values():
                stats(v)
    stats(jparams)
    host = jax.tree_util.tree_map(np.asarray, jparams)
    pparams = params_from_jax(host, device="cpu")
    images = rng.rand(batch, hw, hw, 3).astype(np.float32)
    labels = rng.randint(0, jcfg.classes, batch).astype(np.int32)
    jbatch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    pbatch = {"images": torch.from_numpy(images),
              "labels": torch.from_numpy(labels)}
    return jcfg, pcfg, jparams, pparams, jbatch, pbatch


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def _close(got, want, what, tol=FP32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + k + "/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("hw", [32, 33])
def test_forward_and_loss_match_reference(hw):
    jcfg, pcfg, jp, pp, jb, pb = _setup("float32", hw)
    want, _ = jres.resnet_forward(jp, jb["images"], jcfg, train=False)
    got, stats = pres.resnet_forward(pp, pb["images"], pcfg, train=False)
    assert stats == {}
    _close(got, want, "predict logits")
    jloss, jstats = jres.resnet_loss(jp, jb, jcfg)
    ploss, pstats = pres.resnet_loss(pp, pb, pcfg)
    _close(ploss, jloss, "loss")
    assert sorted(pstats) == sorted(jstats)
    for k in jstats:
        _close(pstats[k][0], jstats[k][0], k + " mean")
        _close(pstats[k][1], jstats[k][1], k + " var")


@pytest.mark.parametrize("hw", [32, 33])
def test_gradients_match_reference(hw):
    jcfg, pcfg, jp, pp, jb, pb = _setup("float32", hw, seed=1)
    want = _leaves(jax.grad(lambda p: jres.resnet_loss(p, jb, jcfg)[0])(jp))
    leaves = _leaves(pp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, _ = pres.resnet_loss(pp, pb, pcfg)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    got = {k: (g if g is not None else torch.zeros_like(t))
           for (k, t), g in zip(leaves.items(), grads)}
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)
    assert float(np.abs(_np(got["fc/w"])).max()) > 0


def test_update_running_stats_matches_reference():
    jcfg, pcfg, jp, pp, jb, pb = _setup("float32", 32, seed=2)
    _, jstats = jres.resnet_loss(jp, jb, jcfg)
    loss, pstats = pres.resnet_loss(pp, pb, pcfg)
    want = _leaves(jres.update_running_stats(jp, jstats, jcfg))
    out = pres.update_running_stats(pp, pstats, pcfg)
    assert out is pp
    got = _leaves(pp)
    moved = 0
    for k in want:
        _close(got[k], want[k], k)
        if k.endswith(("mean", "var")):
            assert not got[k].requires_grad, k
            moved += 1
    assert moved == 2 * len(pstats) == 2 * 9


def test_bf16_matches_reference():
    jcfg, pcfg, jp, pp, jb, pb = _setup("bfloat16", 32, seed=3)
    assert pp["stem"]["conv"].dtype == torch.bfloat16
    assert pp["stem"]["bn"]["gamma"].dtype == torch.float32
    want, _ = jres.resnet_forward(jp, jb["images"], jcfg, train=False)
    got, _ = pres.resnet_forward(pp, pb["images"], pcfg, train=False)
    assert got.dtype == torch.float32
    a, b = _np(got), _np(want)
    assert np.linalg.norm(a - b) <= BF16_REL * np.linalg.norm(b)
    jloss, _ = jres.resnet_loss(jp, jb, jcfg)
    ploss, _ = pres.resnet_loss(pp, pb, pcfg)
    assert abs(float(ploss) - float(jloss)) <= BF16_REL * abs(float(jloss))


def test_init_layout_matches_reference():
    """resnet_init draws from a torch generator (not jax.random), in the
    reference's tree: the same leaves, shapes and dtypes, He-normal
    convolutions."""
    _, pcfg = _configs("bfloat16")
    jcfg = jres.CONFIGS["resnet_tiny"]
    want = _leaves(jax.tree_util.tree_map(
        np.asarray, jres.resnet_init(jax.random.PRNGKey(0), jcfg)))
    got = _leaves(pres.resnet_init(torch.Generator().manual_seed(0), pcfg,
                                   device="cpu"))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape, k
        assert str(got[k].dtype).split(".")[-1] == a.dtype.name, k
    w = got["stages/1/0/conv2"].float()
    std = float(w.std())
    assert 0.7 < std / np.sqrt(2.0 / (9 * w.shape[2])) < 1.3
