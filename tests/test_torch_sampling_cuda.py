"""`sample_tokens`' uniforms on the card against the port's CPU uniforms,
bit for bit (the file imports no JAX: tests/test_torch_sampling.py holds
the CPU uniforms to `jax.random.uniform`). Needs a CUDA card and skips
without one.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.serve import sample_tokens
from mxnet_tpu_torch.serve.sampling import _filtered, _uniforms

pytestmark = pytest.mark.cuda

NEAR_TIE = 1e-4     # top-two gap of the perturbed row under which a token
                    # may differ: log() may round one ulp apart

SEEDS = [0, 1, 12345, 2 ** 31, 2 ** 32 - 1, 7, 99, 2024]
POSITIONS = [0, 1, 513, 2 ** 31 - 1, 48, 80, 4095, 3]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_uniforms_on_card_bit_equal_to_cpu(card):
    got = _uniforms(SEEDS, POSITIONS, 32000, card).cpu().numpy()
    want = _uniforms(SEEDS, POSITIONS, 32000, "cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the tokens of one batched draw: equal to the CPU's, except where the
    # CPU's perturbed row has a near tie
    logits = torch.from_numpy(np.random.RandomState(0).randn(8, 32000)
                              .astype(np.float32) * 4)
    temps, top_k, top_p = np.full(8, 0.8), np.full(8, 50), np.full(8, 0.95)
    args = (np.asarray(SEEDS), np.asarray(POSITIONS), temps, top_k, top_p)
    got_tok = sample_tokens(logits.to(card), *args).cpu()
    want_tok = sample_tokens(logits, *args)
    masked = _filtered(logits, torch.tensor(temps, dtype=torch.float32),
                       torch.tensor(top_k), torch.tensor(top_p,
                                                         dtype=torch.float32))
    top2 = (masked - torch.log(-torch.log(torch.from_numpy(want)))
            ).topk(2).values
    near = (top2[:, 0] - top2[:, 1]) < NEAR_TIE
    assert bool(((got_tok == want_tok) | near).all()), (got_tok, want_tok)
