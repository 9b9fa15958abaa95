"""The port's segment sum (kernel #11's plain version, the wrapper, the
registry op) and `merge_unique_rows` against the JAX package's.

The plain version is held bit-equal to the reference's XLA path
(``zeros().at[ids].add()``, occurrence order) at fp32 and bf16 on
non-negative ids, duplicated and shuffled. On negative ids it is held to
that path with those rows removed: the reference's XLA path wraps them,
while the kernel and the port drop them. The Pallas interpret path is not
used (its two reference tests fail). `merge_unique_rows` is bit-equal to
the reference's, ids and rows. The card test holds the kernel bit-equal to
the plain version.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import sparse_ops as jsops
from mxnet_tpu.parallel.collectives import merge_unique_rows as jmerge
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from mxnet_tpu_torch.ops import sparse_ops as sops
from mxnet_tpu_torch.parallel.collectives import merge_unique_rows


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _ids(rng, n, segments, low=0, sort=False):
    ids = rng.randint(low, segments, size=n).astype(np.int32)
    return np.sort(ids) if sort else ids


def _vals(rng, shape):
    # magnitudes over several decades, so the order of the adds shows
    return (rng.randn(*shape) * np.exp(rng.randn(shape[0], *[1] * (
        len(shape) - 1)) * 3)).astype(np.float32)


@pytest.mark.parametrize("n,segments,row", [
    (64, 5, (3,)), (300, 17, (16,)), (257, 40, (65,)), (100, 1000, (1,)),
    (50, 9, (2, 3))])
@pytest.mark.parametrize("sort", [False, True])
def test_plain_bit_equal_to_xla_fp32(n, segments, row, sort):
    rng = np.random.RandomState(n + segments)
    ids = _ids(rng, n, segments, sort=sort)
    vals = _vals(rng, (n,) + row)
    want = np.asarray(jsops._segment_sum_xla(vals, ids, segments))
    got = sops.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids),
                           segments)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_negative_and_out_of_range_ids_are_dropped(id_dtype):
    rng = np.random.RandomState(3)
    ids = _ids(rng, 200, 12, low=-4).astype(id_dtype)
    ids[::17] = 12                          # past the last segment
    vals = _vals(rng, (200, 8))
    keep = (ids >= 0) & (ids < 12)
    want = np.asarray(jsops._segment_sum_xla(vals[keep], ids[keep], 12))
    got = sops.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), 12)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("row", [(1,), (64,), (4, 5)])
def test_plain_bit_equal_to_xla_bf16(row):
    """Each add rounds to bf16 in occurrence order, as XLA's scatter-add
    does (index_add_ alone would round once)."""
    rng = np.random.RandomState(7)
    ids = _ids(rng, 500, 11)
    vals = _vals(rng, (500,) + row).astype(ml_dtypes.bfloat16)
    want = np.asarray(jsops._segment_sum_xla(jnp.asarray(vals), ids, 11))
    got = sops.segment_sum(torch.from_numpy(vals.astype(np.float32))
                           .bfloat16(), torch.from_numpy(ids), 11)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))


def test_plain_rounds_each_add_at_fp16():
    rng = np.random.RandomState(8)
    ids = torch.from_numpy(_ids(rng, 400, 6))
    vals = torch.from_numpy(_vals(rng, (400, 3))).half()
    got = sops.segment_sum(vals, ids, 6)
    want = torch.zeros(6, 3, dtype=torch.float16)
    for j in range(400):
        want[ids[j]] = want[ids[j]] + vals[j]
    assert torch.equal(got, want)


def test_empty_inputs():
    z = sops.segment_sum(torch.zeros(0, 4), torch.zeros(0, dtype=torch.int32),
                         5)
    assert z.shape == (5, 4) and not z.any()
    e = sops.segment_sum(torch.ones(3, 4), torch.zeros(3, dtype=torch.int32),
                         0)
    assert e.shape == (0, 4)
    with pytest.raises(ValueError, match="num_segments"):
        sops.segment_sum(torch.ones(3, 4), torch.zeros(3, dtype=torch.int32),
                         2 ** 31)


def test_scatter_add_rows_and_registry_op_match_reference():
    rng = np.random.RandomState(11)
    table = rng.randn(30, 6).astype(np.float32)
    ids = _ids(rng, 90, 30)
    vals = _vals(rng, (90, 6))
    want = np.asarray(jsops.scatter_add_rows(table, ids, vals))
    got = sops.scatter_add_rows(torch.from_numpy(table),
                                torch.from_numpy(ids), torch.from_numpy(vals))
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    with mx.cpu():
        out = mx.nd._sparse_segment_sum(mx.nd.array(vals),
                                        mx.nd.array(ids, dtype="int32"),
                                        num_segments=30)
    assert np.array_equal(_bits(out.asnumpy()), _bits(
        np.asarray(jsops._segment_sum_xla(vals, ids, 30))))


def test_plain_version_counts_no_launch():
    reset_launch_counts()
    sops.segment_sum(torch.ones(4, 2), torch.arange(4), 4)
    assert launch_counts()["segment_sum"] == 0
    assert KERNELS["segment_sum"] == ("csrc/segment_sum.cu",
                                      "mxnet_tpu/ops/sparse_ops.py:88")


@pytest.mark.parametrize("case", ["dups_and_pads", "pad_free_unique",
                                  "all_pads", "one_run", "rank3"])
def test_merge_unique_rows_matches_reference(case):
    rng = np.random.RandomState(5)
    if case == "dups_and_pads":
        ids = rng.randint(-3, 20, size=64).astype(np.int32)
        vals = _vals(rng, (64, 8))
    elif case == "pad_free_unique":
        # no pad row: the last slot is a real segment
        ids = rng.permutation(40).astype(np.int32)
        vals = _vals(rng, (40, 8))
    elif case == "all_pads":
        ids = np.full(8, -1, np.int32)
        vals = _vals(rng, (8, 3))
    elif case == "one_run":
        ids = np.full(16, 7, np.int32)
        vals = _vals(rng, (16, 5))
    else:
        ids = rng.randint(-1, 6, size=30).astype(np.int32)
        vals = _vals(rng, (30, 2, 3))
    wids, wvals = jmerge(jnp.asarray(ids), jnp.asarray(vals))
    gids, gvals = merge_unique_rows(torch.from_numpy(ids),
                                    torch.from_numpy(vals))
    assert gids.dtype == torch.int32 and gvals.shape == vals.shape
    assert np.array_equal(gids.numpy(), np.asarray(wids))
    assert np.array_equal(_bits(gvals.numpy()), _bits(np.asarray(wvals)))


@pytest.mark.cuda
def test_segment_sum_kernel_bit_equal_to_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(0)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for n, segments, row, low in ((1000, 37, (65,), -3), (0, 5, (3,), 0),
                                      (513, 10 ** 5, (1,), 0),
                                      (300, 50, (2, 3), -1)):
            ids = torch.from_numpy(_ids(rng, n, segments, low=low))
            vals = torch.from_numpy(_vals(rng, (n,) + row)).to(dtype)
            want = sops.segment_sum(vals, ids, segments)
            reset_launch_counts()
            got = sops.segment_sum(vals.cuda(), ids.cuda(), segments)
            torch.cuda.synchronize()
            assert launch_counts()["segment_sum"] == 1
            assert torch.equal(got.cpu(), want)
    with pytest.raises(TypeError):
        sops.segment_sum(torch.ones(3, 2, dtype=torch.int32, device="cuda"),
                         torch.zeros(3, dtype=torch.int32, device="cuda"), 2)
