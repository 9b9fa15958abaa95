"""The port's resumable training across ranks, on the CPU.

`mxnet_tpu_torch.launch` starts four gloo ranks (a FileStore rendezvous
under tmp_path) running the ``resilience`` checks of
`_torch_resilience_worker.py` once:

* the restore election over the rendezvous store, one rank a prepared
  step ahead: every rank elects and restores the same step;
* a coordinated run whose save dies mid-commit on one rank: that rank
  raises the preemption, the others the coordinator's timeout (a
  `RetriableError`, not a hang); every rank then resumes at the elected
  step and ends with the fault-free run's weights, bit for bit;
* elastic shrink (data=4 to data=2 after a preemption: two ranks stand
  by) and grow-back (data=2 to data=4 at a checkpoint boundary: the
  standing-by ranks receive the live state): the weights bit-equal an
  uninterrupted run on the final mesh (binary data: the linear model's
  sums are exact in any order), the losses within 1e-6 of it.

The reference's same plans are held in `test_torch_resilience.py`, where
its runner can run them on one device.
"""
import os
import pathlib
import sys

import numpy as np
import pytest

from mxnet_tpu_torch.launch import launch_local

import _torch_resilience_worker as W

ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
SPAWN_TIMEOUT_S = 240


def spawn(mode, world, tmp):
    """Run the worker's `mode` checks at `world` gloo ranks; the ranks'
    arrays."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for k in ("MXNET_TPU_FAULT_PLAN", "MXNET_TPU_INTEGRITY",
              "MXNET_TPU_COMM_CHECKSUM", "MXNET_TPU_COMM_BUCKET_MB"):
        env.pop(k, None)
    rc = launch_local([sys.executable, W.__file__, mode, str(tmp)], world,
                      root_uri="file://%s" % (tmp / "store"),
                      backend="gloo", timeout=SPAWN_TIMEOUT_S, env=env)
    assert rc == 0, "worker group exited with %s" % rc
    return [dict(np.load(tmp / ("rank%d.npz" % r))) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("resilience", 4, tmp_path_factory.mktemp("resilience"))


def test_restore_election_agrees_across_gloo_ranks(ranks):
    for r in ranks:
        assert list(r["elect/step"]) == [4, 4, 4]


def test_coordinated_mid_commit_crash_resumes_at_the_elected_step(ranks):
    for rank, r in enumerate(ranks):
        # rank 1's save died mid-commit; the others timed out electing
        assert str(r["commit/error"]) == ("PreemptionError" if rank == 1
                                          else "RetriableError")
        # the step-4 payload is durable, the marker still names step 2
        assert list(r["commit/durable"]) == [2, 4]
        assert int(r["commit/first"]) == 2
        assert r["commit/final"].tobytes() == r["commit/clean"].tobytes()


def test_elastic_shrink_and_grow_back(ranks):
    for rank, r in enumerate(ranks):
        # restarts, shrinks, grows, the final mesh's size
        assert list(r["shrink/counts"]) == [1, 1, 0, 2]
        assert list(r["grow/counts"]) == [0, 0, 1, 4]
        if rank < 2:
            assert r["shrink/final"].tobytes() == \
                ranks[0]["elastic/clean2"].tobytes()
            np.testing.assert_allclose(r["shrink/losses"],
                                       ranks[0]["elastic/clean2_losses"],
                                       rtol=1e-6)
            assert tuple(r["shrink/block"]) == (4, 2)
        else:
            assert bool(r["shrink/standby"])
        assert r["grow/final"].tobytes() == \
            ranks[0]["elastic/clean4"].tobytes()
        # the ranks taken in at the step-2 boundary train from there on
        losses = r["grow/losses"]
        start = 0 if rank < 2 else 2
        assert np.isnan(losses[:start]).all()
        np.testing.assert_allclose(losses[start:],
                                   ranks[0]["elastic/clean4_losses"][start:],
                                   rtol=1e-6)
