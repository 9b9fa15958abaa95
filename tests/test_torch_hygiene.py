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
    assert "chip_smoke.py" in names


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
], ids=["llama_init", "init_kv_pools", "init_kv_cache", "KVBlockPool",
        "InferenceServer", "restore_train_state"])
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
