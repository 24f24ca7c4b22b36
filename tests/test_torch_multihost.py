"""The port's multi-host launch (``dgraph_tpu_torch.comm.multihost``) under a
torchrun-style launch on the CPU.

Four processes (``tests/torch_multihost_worker.py``) start with the
environment ``torchrun`` gives two nodes of two ranks (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``,
``MASTER_ADDR=localhost`` and a free port taken from the kernel, as
``tests/test_multiprocess_launch.py:30-35`` takes it) and join over gloo:

- ``initialize_multihost`` twice (idempotent);
- ``make_pod_groups(3, 1)`` raises the reference's ``make_pod_mesh``
  message; ``make_pod_groups()`` is one graph group of four ranks across
  both nodes (the reference's R = 1 pod mesh); ``make_pod_groups(2, 2)``
  places each graph group of two on one node and the replica axis across
  the nodes;
- ``process_local_shards(4)`` at R = 1 equals the reference's formula
  (``dgraph_tpu/comm/multihost.py:71-80``, ``index_of[d] * world_size //
  n`` over the process's one device);
- one per-replica GCN step at R = 2 x W = 2 gives, on every rank, the loss
  of the same step under the in-process ``launch``;
- ``process_local_plan_shards`` of a W = 4 sharded plan artifact gives each
  rank only its own shard (``[RANK % 4]``, the plan's leading axis 1, its
  statics the whole world's), leaf for leaf the full plan's
  ``shard(rank)``.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from dgraph_tpu_torch.comm.dist import launch
from dgraph_tpu_torch.plan import build_plan_shards, load_sharded_plan

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_replica_ranks  # noqa: E402
from torch_serve_ranks import plan_leaves  # noqa: E402
from test_torch_replica import _gcn_case  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
NODES, PER_NODE = 2, 2
TIMEOUT = 240


def _plan_graph():
    """A small random graph in contiguous blocks over the launch's 4 ranks."""
    rng = np.random.default_rng(4)
    part = np.sort(rng.integers(0, NODES * PER_NODE, 64)).astype(np.int64)
    return rng.integers(0, 64, (2, 400)).astype(np.int64), part


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(every rank's record from the torchrun-style launch, the in-process
    launch's losses)."""
    tmp = tmp_path_factory.mktemp("multihost")
    gcn, _ = _gcn_case()
    inputs = tmp / "inputs.pkl"
    plan_dir = tmp / "plan"
    edges, part = _plan_graph()
    build_plan_shards(edges, part, out_dir=str(plan_dir), world_size=NODES * PER_NODE,
                      overlap=True, write_layout=False)
    with open(inputs, "wb") as f:
        pickle.dump({"gcn": gcn, "plan_dir": str(plan_dir)}, f)
    port, n = _free_port(), NODES * PER_NODE
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(rank % PER_NODE), LOCAL_WORLD_SIZE=str(PER_NODE),
                   GROUP_RANK=str(rank // PER_NODE), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER, str(inputs), str(tmp)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, env=env, cwd=REPO))
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=TIMEOUT)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (out, rc) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-4000:]}"
    records = []
    for rank in range(n):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            records.append(pickle.load(f))
    losses = launch(torch_replica_ranks.gcn_step_loss, 2, str(inputs), num_replicas=2,
                    device="cpu", timeout=TIMEOUT, threads=1)
    return records, losses


def test_pod_groups_keep_graph_groups_on_a_node(run):
    records, _ = run
    for g, rec in enumerate(records):
        assert rec["node"] == g // PER_NODE and rec["local_rank"] == g % PER_NODE
        assert rec["pod"] == (g // 2, g % 2, 2, g)
        assert rec["flat"] == (0, g, 4, g)
    for replica in range(2):
        nodes = {rec["node"] for rec in records if rec["pod"][0] == replica}
        assert len(nodes) == 1, f"graph group {replica} spans nodes {nodes}"
    assert {rec["node"] for rec in records if rec["flat"][0] == 0} == set(range(NODES))


def test_bad_layout_raises_the_reference_message(run):
    records, _ = run
    for rec in records:
        assert rec["bad_layout"] == "ranks_per_graph (3) x num_replicas (1) != 4"


def test_process_local_shards_at_one_replica_match_the_reference_formula(run):
    records, _ = run
    n = len(records)
    for g, rec in enumerate(records):
        # the reference's formula over the process's one device, index g of n
        assert rec["shards"] == sorted({i * n // n for i in [g]})


def test_replica_step_under_torchrun_equals_launch(run):
    records, losses = run
    assert len(losses) == 4
    for rec, want in zip(records, losses):
        assert rec["loss"] == want


def test_process_local_plan_shards_load_each_rank_its_own_shard(run, tmp_path):
    records, _ = run
    edges, part = _plan_graph()
    n = NODES * PER_NODE
    build_plan_shards(edges, part, out_dir=str(tmp_path), world_size=n, overlap=True,
                      write_layout=False)
    full, _ = load_sharded_plan(str(tmp_path), load_layout=False)
    for g, rec in enumerate(records):
        got = rec["plan_shards"]
        assert got["ranks"] == [g] and got["plan_ranks"] == (g,) and got["world_size"] == n
        want = plan_leaves(full.shard(g))
        assert set(got["view"]) == set(want) and want
        for k, v in want.items():
            np.testing.assert_array_equal(got["view"][k], v, err_msg=k)
            assert got["leaves"][k].shape == (1,) + v.shape, k
            np.testing.assert_array_equal(got["leaves"][k][0], v, err_msg=k)
