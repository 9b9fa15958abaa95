"""The port's segment sum (kernel #11's plain version, the wrapper, the
registry op) and `merge_unique_rows` against the JAX package's.

The plain version is held bit-equal to the reference's XLA path
(``zeros().at[ids].add()``, occurrence order) at fp32 and bf16 on
non-negative ids, duplicated and shuffled. On negative ids it is held to
that path with those rows removed: the reference's XLA path wraps them,
while the kernel and the port drop them. The Pallas interpret path is not
used (its two reference tests fail). `merge_unique_rows` is bit-equal to
the reference's, ids and rows. The card test holds the kernel bit-equal to
the plain version. The route plan (fused or presorted) is pure Python and
is tested here, with a stubbed launch for the count of each route.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import sparse_ops as jsops
from mxnet_tpu.parallel.collectives import merge_unique_rows as jmerge
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import (KERNELS, launch_counts, reset_launch_counts,
                                 variant_counts)
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


@pytest.mark.parametrize("nnz,dim,dtype,want", [
    # the main paths: bench_sparse's push, a Kaggle table at batch 128
    (8192, 64, torch.float32, ("fused", 4, 16, 8192)),
    (128, 16, torch.float32, ("fused", 4, 4, 1024)),
    # the route's edge
    (sops.FUSED_MAX_NNZ, 16, torch.float32, ("fused", 4, 4, 16384)),
    (sops.FUSED_MAX_NNZ + 1, 16, torch.float32, ("presorted", 1, 32, 0)),
    # 16 bytes a lane where the width allows, one value where it does not
    (300, 64, torch.bfloat16, ("fused", 8, 8, 1024)),
    (300, 16, torch.float16, ("fused", 8, 2, 1024)),
    (300, 65, torch.float32, ("fused", 1, 32, 1024)),
    (300, 1, torch.bfloat16, ("fused", 1, 1, 1024)),
    (0, 7, torch.float32, ("fused", 1, 8, 1024)),
    (1025, 129, torch.float16, ("fused", 1, 32, 2048)),
])
def test_segment_sum_plan(nnz, dim, dtype, want):
    assert tuple(sops.segment_sum_plan(nnz, dim, dtype)) == want


def test_segment_sum_plan_unaligned_values_load_one_value_a_lane():
    assert sops.segment_sum_plan(300, 64, torch.float32, aligned=False) \
        == ("fused", 1, 32, 1024)
    assert sops.segment_sum_plan(300, 2 ** 31, torch.float32).variant \
        == "presorted"


@pytest.mark.parametrize("nnz,id_dtype,variant", [
    (64, torch.int32, "fused"), (64, torch.int16, "fused"),
    (sops.FUSED_MAX_NNZ + 1, torch.int64, "presorted")])
def test_wrapper_counts_the_route_it_launches(monkeypatch, nnz, id_dtype,
                                              variant):
    """The wrapper's route reaches variant_counts, with the launch
    stubbed (no card here): one count per call, under its route."""
    launched = []
    monkeypatch.setattr(sops, "_launch", lambda dev, symbol, argtypes,
                        args_of: launched.append(symbol))
    reset_launch_counts()
    vals = torch.ones(nnz, 8)
    ids = torch.arange(nnz).to(id_dtype) % 50
    out = sops._segment_sum_cuda(vals, ids, 50)
    assert out.shape == (50, 8)
    assert launched == ["mx_segment_sum_" + variant
                        if variant == "fused" else "mx_segment_sum"]
    assert launch_counts()["segment_sum"] == 1
    assert variant_counts() == {("segment_sum", variant): 1}


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
    """Both routes, each call's route as the plan says, bit-equal to the
    plain version and to a second launch: sorted, shuffled and all-equal
    ids, int32 and int64 ids (negative, past the last segment and past
    int32's range), widths 1, 16, 64, 65, 128 and rank-3 rows, nnz 0, at
    the fused route's edge, and width 1 past it (the factorization
    machine's linear term on the presorted route)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(0)
    edge = sops.FUSED_MAX_NNZ
    cases = [(1000, 37, (65,), -3, False), (0, 5, (3,), 0, False),
             (513, 10 ** 5, (1,), 0, False), (300, 50, (2, 3), -1, False),
             (4096, 600, (16,), 0, True), (4096, 600, (64,), 0, False),
             (2000, 1, (64,), 0, False), (edge, 3000, (16,), 0, True),
             (edge, 3000, (16,), 0, False), (edge + 1, 3000, (16,), 0, False),
             (128, 120, (128,), 0, False), (edge + 1, 1000, (1,), 0, True),
             (edge + 1, 10 ** 5, (1,), 0, False)]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for n, segments, row, low, sort in cases:
            for id_dtype in (np.int32, np.int64):
                ids = _ids(rng, n, segments, low=low, sort=sort).astype(
                    id_dtype)
                if id_dtype == np.int64 and n > 100:
                    ids[::13] = 2 ** 33 + 1      # past int32, dropped
                    ids[::17] = segments         # past the last segment
                ids = torch.from_numpy(ids)
                vals = torch.from_numpy(_vals(rng, (n,) + row)).to(dtype)
                want = sops.segment_sum(vals, ids, segments)
                plan = sops.segment_sum_plan(n, int(np.prod(row)), dtype)
                reset_launch_counts()
                got = sops.segment_sum(vals.cuda(), ids.cuda(), segments)
                again = sops.segment_sum(vals.cuda(), ids.cuda(), segments)
                torch.cuda.synchronize()
                assert variant_counts() == {("segment_sum", plan.variant): 2}
                assert torch.equal(got.cpu(), want)
                assert torch.equal(got, again)
    with pytest.raises(TypeError):
        sops.segment_sum(torch.ones(3, 2, dtype=torch.int32, device="cuda"),
                         torch.zeros(3, dtype=torch.int32, device="cuda"), 2)
