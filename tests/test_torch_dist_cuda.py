"""Main path 19's in-process fleets on the card (`cuda`-marked; they skip
on a host without one). This file imports no JAX: the fleets are held to
the port's own one-rank results, with chip_smoke.py's checks at small
sizes.

* ZeRO with LAMB over a fleet of 4 virtual ranks (threads sharing one
  card, a barrier'd mailbox as the exchange), rank r pushing its own
  share (2r + 1)/16 of the gradients, against world 1 at fp32: per-leaf relative error of the
  weights' change within chip_smoke.P19_ZERO_REL, and one flat_lamb1 and
  one flat_lamb2 launch a bucket a rank a step.
* Ring attention over a fleet of 4 (kernels #1-#3 per block), causal, GQA
  4/2, S = 1024, D = 64, bf16 and fp32, against the whole-sequence kernels
  within chip_smoke.P19_RING_TOL.
"""
import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_zero_lamb_fleet_of_four_on_the_card(smoke):
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(768, 768), (768,), (3072, 768), (3072,), (768, 3072),
              (30, 768), (1,)]
    weights = [(torch.randn(s, generator=gen, device="cuda") * 0.02)
               .to(torch.bfloat16) for s in shapes]
    grads = [torch.randn(s, generator=gen, device="cuda")
             .to(torch.bfloat16) for s in shapes]
    err, launches, buckets = smoke.zero_fleet_check(weights, grads, 2,
                                                    cap_mb=4)
    assert buckets > 1
    assert err <= smoke.P19_ZERO_REL, err
    for k in smoke.P19_ZERO_KERNELS:
        assert launches[k] == smoke.P19_FLEET * buckets * 2, launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_ring_attention_fleet_of_four_on_the_card(smoke, dtype):
    res = smoke.ring_fleet_check(B=1, H=4, Hkv=2, S=1024, D=64, dtype=dtype)
    assert res["ok"], res
