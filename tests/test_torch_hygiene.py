"""Boundaries of the PyTorch/CUDA port.

The port and chip_smoke.py import neither JAX nor the JAX package (an AST
scan of every import, including those inside functions), and the port's
entry points default to the CUDA card: without one they raise instead of
running on the CPU.
"""
import ast
import pathlib

import pytest
import torch

import mxnet_tpu_torch
from mxnet_tpu_torch.base import MXNetError, resolve_device
from mxnet_tpu_torch.models.llama import (CONFIGS, init_kv_cache,
                                          init_kv_pools, llama_init)
from mxnet_tpu_torch.parallel import restore_train_state
from mxnet_tpu_torch.serve import InferenceServer, KVBlockPool

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "mxnet_tpu_torch/parallel/flash_attention.py" in names
    assert "mxnet_tpu_torch/serve/scheduler.py" in names
    assert "mxnet_tpu_torch/parallel/train_step.py" in names
    assert "mxnet_tpu_torch/parallel/checkpoint.py" in names
    assert "mxnet_tpu_torch/util.py" in names
    assert "mxnet_tpu_torch/ops/fused_conv.py" in names
    assert "mxnet_tpu_torch/ndarray/ndarray.py" in names
    assert "mxnet_tpu_torch/io/params_serde.py" in names
    assert "mxnet_tpu_torch/gluon/block.py" in names
    assert "mxnet_tpu_torch/gluon/contrib/cnn/conv_layers.py" in names
    assert "mxnet_tpu_torch/gluon/model_zoo/vision/resnet.py" in names
    assert "chip_smoke.py" in names


def test_scan_covers_the_training_slice():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for module in ("autograd.py", "lr_scheduler.py", "gluon/loss.py",
                   "gluon/trainer.py", "gluon/fused_step.py",
                   "optimizer/optimizer.py", "ops/optimizer_ops.py",
                   "ops/fused_optimizer.py"):
        assert "mxnet_tpu_torch/" + module in names


def test_training_kernels_replace_distinct_tpu_kernels():
    from mxnet_tpu_torch.ops import KERNELS
    assert KERNELS["conv_bn_stats"] == ("csrc/conv_bn_relu.cu",
                                        "mxnet_tpu/ops/fused_conv.py:195")
    assert KERNELS["cbr_train_bwd"] == ("csrc/cbr_train_bwd.cu",
                                        "mxnet_tpu/ops/fused_conv.py:341")
    assert KERNELS["flat_sgd"] == ("csrc/fused_optimizer.cu",
                                   "mxnet_tpu/ops/fused_optimizer.py:118")
    assert KERNELS["flat_adam"] == ("csrc/fused_optimizer.cu",
                                    "mxnet_tpu/ops/fused_optimizer.py:149")
    for name in ("conv_bn_stats", "cbr_train_bwd", "flat_sgd", "flat_adam"):
        path, line = KERNELS[name][1].split(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def _kernel"), (name, text)


def test_scan_covers_the_bert_zero_slice():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for module in ("engine/__init__.py", "optimizer/zero.py",
                   "kvstore/kvstore.py", "gluon/model_zoo/bert.py",
                   "models/bert.py", "ops/nn.py", "ops/tensor.py",
                   "gluon/nn/basic_layers.py"):
        assert "mxnet_tpu_torch/" + module in names


def test_lamb_kernels_replace_distinct_tpu_kernels():
    from mxnet_tpu_torch.ops import KERNELS
    assert KERNELS["flat_lamb1"] == ("csrc/lamb.cu",
                                     "mxnet_tpu/ops/fused_optimizer.py:177")
    assert KERNELS["flat_lamb2"] == ("csrc/lamb.cu",
                                     "mxnet_tpu/ops/fused_optimizer.py:229")
    for name, want in (("flat_lamb1", "def _kernel_flat_lamb1"),
                       ("flat_lamb2", "def _kernel_flat_apply")):
        path, line = KERNELS[name][1].split(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith(want), (name, text)


def test_scan_covers_the_sparse_slice():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for module in ("ops/sparse_ops.py", "parallel/collectives.py",
                   "ndarray/sparse.py", "embedding/__init__.py",
                   "embedding/table.py", "embedding/serving.py",
                   "models/dlrm.py"):
        assert "mxnet_tpu_torch/" + module in names


def test_segment_sum_replaces_the_sparse_tpu_kernel():
    from mxnet_tpu_torch.ops import KERNELS
    assert KERNELS["segment_sum"] == ("csrc/segment_sum.cu",
                                      "mxnet_tpu/ops/sparse_ops.py:88")
    path, line = KERNELS["segment_sum"][1].split(":")
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith("def _kernel_segment_sum"), text


KERNEL_MODULES = ["mxnet_tpu_torch/ops/fused_optimizer.py",
                  "mxnet_tpu_torch/ops/sparse_ops.py",
                  "mxnet_tpu_torch/ops/fused_conv.py",
                  "mxnet_tpu_torch/parallel/flash_attention.py",
                  "mxnet_tpu_torch/ops/optimizer_ops.py",
                  "mxnet_tpu_torch/ops/_build.py"]


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_kernel_wrappers_have_no_fallback(module):
    """A wrapper launches its kernel on a CUDA tensor or raises: no `try`
    anywhere in the modules that hold the wrappers and their loader, so no
    failure can turn into a quiet run of the plain version."""
    tree = ast.parse((ROOT / module).read_text())
    tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert not tries, "%s: try at lines %s" % (module, tries)


def test_importing_the_port_builds_and_loads_nothing():
    """Importing every module of the port starts no process (nvcc) and
    loads no shared library: kernels are built at first use."""
    import subprocess
    import sys
    code = (
        "import ctypes, pkgutil, importlib, subprocess\n"
        "import numpy, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('called at import: %r' % (a[:1],))\n"
        "subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "import mxnet_tpu_torch as m\n"
        "for info in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "from mxnet_tpu_torch.ops import _build\n"
        "assert not _build._libs\n"
        "assert not torch.cuda.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(
    ROOT).as_posix())
def test_no_jax_or_mxnet_tpu_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, "%s imports %s" % (path.relative_to(ROOT), bad)


def test_import_roots_detects_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from mxnet_tpu.serve import errors\n"
                   "    import jax.numpy as jnp\n"
                   "    importlib.import_module('jaxlib')\n")
    assert set(_imported_roots(src)) >= {"mxnet_tpu", "jax", "jaxlib"}


def test_every_kernel_has_a_launch_count_and_a_distinct_tpu_kernel():
    from mxnet_tpu_torch.ops import KERNELS, launch_counts
    assert set(launch_counts()) == set(KERNELS)
    assert KERNELS["conv_bn_relu"] == ("csrc/conv_bn_relu.cu",
                                       "mxnet_tpu/ops/fused_conv.py:75")
    replaces = [r for _, r in KERNELS.values()]
    assert len(set(replaces)) == len(replaces)


def test_kernel_sources_ship_with_the_package():
    from mxnet_tpu_torch.ops import KERNELS
    pkg = pathlib.Path(mxnet_tpu_torch.__file__).parent
    for source, replaces in KERNELS.values():
        assert (pkg / source).is_file()
        assert (ROOT / replaces.split(":")[0]).is_file()


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    lambda cfg: llama_init(torch.Generator().manual_seed(0), cfg),
    lambda cfg: init_kv_pools(cfg, 4, 4),
    lambda cfg: init_kv_cache(cfg, 1, 8),
    lambda cfg: KVBlockPool(cfg, num_blocks=4, block_size=4),
    lambda cfg: InferenceServer({}, cfg, kv_blocks=4, block_size=4),
    lambda cfg: restore_train_state("no-such-checkpoint"),
    lambda cfg: mxnet_tpu_torch.nd.array([1.0, 2.0]),
    lambda cfg: mxnet_tpu_torch.nd.zeros((2, 3)),
], ids=["llama_init", "init_kv_pools", "init_kv_cache", "KVBlockPool",
        "InferenceServer", "restore_train_state", "nd.array", "nd.zeros"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                            make):
    _no_cuda(monkeypatch)
    with pytest.raises(MXNetError, match="device='cpu'"):
        make(CONFIGS["llama_tiny"])


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(MXNetError):
            resolve_device()


def test_flash_attention_raises_for_a_device_without_a_kernel():
    from mxnet_tpu_torch.parallel.flash_attention import _flash_forward
    q = torch.zeros(1, 2, 4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        _flash_forward(q, q, q, True, 0.125)


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _no_cuda(monkeypatch)
    with pytest.raises(SystemExit) as ei:
        smoke.main()
    assert ei.value.code != 0
    assert '"ok": true' not in capsys.readouterr().out
