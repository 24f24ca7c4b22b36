"""The port's graph-delta worker for ``tests/test_torch_deltas.py`` (no JAX):

    python tests/torch_replan_worker.py <run_dir> init             # gen 0 + one delta
    python tests/torch_replan_worker.py <run_dir> replan [commit|shard]
    python tests/torch_replan_worker.py <run_dir> append <n> <value> <go_file>

``replan commit`` replaces the port's pointer write (``deltas.write_world``)
with a SIGKILL of this process: every generation-1 artifact is durable, the
pointer has not moved. ``replan shard`` kills it at the plan build's second
shard write (``plan_shards.write_shard``). The patches live here, in the
test's process, never in the package. ``append`` waits for ``go_file`` to
exist, then stages ``n`` one-vertex deltas whose feature is ``value``, and
prints their records: two such processes started together race each other.
"""

import json
import os
import signal
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

NUM_NODES, FEAT = 48, 4


def _kill(*_args, **_kwargs):
    os.kill(os.getpid(), signal.SIGKILL)


def main() -> None:
    run_dir, phase = sys.argv[1], sys.argv[2]
    from dgraph_tpu_torch import plan_shards
    from dgraph_tpu_torch.serve import deltas

    if phase == "init":
        rng = np.random.default_rng(7)
        edges = np.stack([np.arange(NUM_NODES), (np.arange(NUM_NODES) + 1) % NUM_NODES])
        feats = rng.normal(size=(NUM_NODES, FEAT)).astype(np.float32)
        world = deltas.init_world(run_dir, edges, feats, world_size=4,
                                  partition_method="block", pad_multiple=4)
        rec = deltas.append_delta(run_dir, rng.normal(size=(3, FEAT)).astype(np.float32),
                                  np.array([[0, 48], [48, 49]]))
        print(json.dumps({"init": world, "delta": rec}), flush=True)
    elif phase == "replan":
        kill_at = sys.argv[3] if len(sys.argv) > 3 else ""
        if kill_at == "commit":
            deltas.write_world = _kill
        elif kill_at == "shard":
            real, calls = plan_shards.write_shard, []

            def second_write_kills(*args, **kwargs):
                calls.append(1)
                if len(calls) == 2:
                    _kill()
                return real(*args, **kwargs)

            plan_shards.write_shard = second_write_kills
        print(json.dumps({"replan": deltas.replan(run_dir)}), flush=True)
    elif phase == "append":
        n, value, go = int(sys.argv[3]), float(sys.argv[4]), sys.argv[5]
        while not os.path.exists(go):
            time.sleep(0.001)
        recs = [deltas.append_delta(run_dir, np.full((1, FEAT), value, np.float32),
                                    np.zeros((2, 0), np.int64)) for _ in range(n)]
        print(json.dumps(recs), flush=True)
    else:
        raise SystemExit(f"unknown phase {phase!r}")


if __name__ == "__main__":
    main()
