"""How far bf16 AMP moves a seeded ResNet-50's first gradient, in the JAX
package and in the PyTorch port, on the CPU (a script, not a test: pytest
does not collect it).

Both packages build `resnet50_v1` from the same weights (Xavier,
gaussian, fan-in, magnitude 2; with --random-bn, BatchNorm's gamma and
running variance uniform in [0.5, 1.5) and beta and running mean N(0,
0.1^2), as chip_smoke.py's path 23 draws them), take one seeded batch
through SoftmaxCrossEntropyLoss and backward, in fp32 and under
`amp.init("bfloat16")`, and print the cosines of the flattened gradients:
each package's AMP gradient against its fp32 one, the two fp32 gradients
against each other, and the two AMP gradients against each other; then
the output layer's AMP cosine in each package.

    JAX_PLATFORMS=cpu python tests/_torch_amp_grad_cosine.py \
        --batch 4 --random-bn

It takes a few minutes at 224x224 (the JAX package runs op by op).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.ndarray.ndarray as jnd  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402
import mxnet_tpu_torch.ndarray.ndarray as tnd  # noqa: E402
from mxnet_tpu.contrib import amp as jamp  # noqa: E402
from mxnet_tpu_torch.contrib import amp as tamp  # noqa: E402
from mxnet_tpu_torch.models.convert import gluon_params_from_jax  # noqa


def weights(x, random_bn):
    net = jmx.gluon.model_zoo.vision.resnet50_v1()
    with jmx.cpu():
        net.initialize(jmx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2))
        net(jmx.nd.array(x[:1]))
    arrays = {k: v.data().asnumpy()
              for k, v in net._collect_params_with_prefix().items()}
    if random_bn:
        rng = np.random.RandomState(1)
        for k, a in arrays.items():
            if k.endswith(("gamma", "running_var")):
                arrays[k] = (rng.rand(*a.shape) + 0.5).astype(np.float32)
            elif k.endswith(("beta", "running_mean")):
                arrays[k] = (rng.randn(*a.shape) * 0.1).astype(np.float32)
    return arrays


def gradients(pkg, arrays, x, y, target):
    """{structural name: float64 gradient} of one step's loss."""
    amp_mod, nd_mod = (tamp, tnd) if pkg is mx else (jamp, jnd)
    with pkg.cpu():
        net = pkg.gluon.model_zoo.vision.resnet50_v1()
        net.initialize()
        net(pkg.nd.array(x[:1]))
        if pkg is mx:
            gluon_params_from_jax(arrays, net, ctx=mx.cpu())
        else:
            for k, p in net._collect_params_with_prefix().items():
                p.set_data(pkg.nd.array(arrays[k]))
        amp_mod.amp._initialized = False
        nd_mod._AMP_WRAP = None
        if target:
            amp_mod.init(target)
        try:
            sce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
            with pkg.autograd.record():
                loss = sce(net(pkg.nd.array(x)), pkg.nd.array(y))
            loss.backward()
        finally:
            nd_mod._AMP_WRAP = None
            amp_mod.amp._initialized = False
        return {k: p.grad().asnumpy().astype(np.float64)
                for k, p in net._collect_params_with_prefix().items()
                if p.grad_req != "null"}


def cosine(a, b, keys=None):
    keys = sorted(keys or a)
    fa = np.concatenate([a[k].ravel() for k in keys])
    fb = np.concatenate([b[k].ravel() for k in keys])
    return float(fa @ fb / (np.linalg.norm(fa) * np.linalg.norm(fb)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--random-bn", action="store_true")
    args = ap.parse_args()
    rng = np.random.RandomState(0)
    x = rng.standard_normal((args.batch, 3, args.image,
                             args.image)).astype(np.float32)
    y = rng.randint(0, 1000, args.batch).astype(np.float32)
    arrays = weights(x, args.random_bn)
    g = {}
    for pkg in (mx, jmx):
        for target in (None, "bfloat16"):
            g[pkg, target] = gradients(pkg, arrays, x, y, target)
    out = ["output.weight", "output.bias"]
    print("port bf16 vs port fp32: %.5f (output layer %.5f)" % (
        cosine(g[mx, "bfloat16"], g[mx, None]),
        cosine(g[mx, "bfloat16"], g[mx, None], out)))
    print("reference bf16 vs reference fp32: %.5f (output layer %.5f)" % (
        cosine(g[jmx, "bfloat16"], g[jmx, None]),
        cosine(g[jmx, "bfloat16"], g[jmx, None], out)))
    print("port fp32 vs reference fp32: %.5f" % cosine(g[mx, None],
                                                       g[jmx, None]))
    print("port bf16 vs reference bf16: %.5f" % cosine(g[mx, "bfloat16"],
                                                       g[jmx, "bfloat16"]))


if __name__ == "__main__":
    main()
