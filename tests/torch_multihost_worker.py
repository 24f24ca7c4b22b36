"""One rank of ``test_torch_multihost.py``'s torchrun-style launch.

Every process runs this file with the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), as ``torchrun`` starts a program on each
node. It joins through ``comm.multihost``, builds the pod groups, loads its
own shard of the sharded plan the inputs name (``process_local_plan_shards``)
and writes what it saw to ``<out_dir>/rank<RANK>.pkl``. It imports torch and the port
only, never JAX.

    python tests/torch_multihost_worker.py <inputs.pkl> <out_dir>
"""

import os
import pickle
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import torch  # noqa: E402

from dgraph_tpu_torch.comm import multihost  # noqa: E402


def main(inputs: str, out_dir: str) -> None:
    import torch_replica_ranks
    from torch_serve_ranks import plan_leaves

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    multihost.initialize_multihost(device="cpu")
    multihost.initialize_multihost(device="cpu")  # idempotent
    out = {"node": int(os.environ["GROUP_RANK"]), "local_rank": int(os.environ["LOCAL_RANK"])}
    try:
        multihost.make_pod_groups(3, 1)
    except ValueError as e:
        out["bad_layout"] = str(e)
    flat = multihost.make_pod_groups()  # R = 1: one graph group of every rank
    out["flat"] = (flat.replica, flat.rank, flat.world_size, flat.global_rank)
    group = multihost.make_pod_groups(2, 2)
    out["pod"] = (group.replica, group.rank, group.world_size, group.global_rank)
    out["shards"] = multihost.process_local_shards(flat.world_size)
    out["loss"] = torch_replica_ranks.gcn_step_loss(group, inputs)
    with open(inputs, "rb") as f:
        plan_dir = pickle.load(f)["plan_dir"]
    plan, ranks = multihost.process_local_plan_shards(plan_dir)
    view = plan.shard(ranks[0])
    out["plan_shards"] = {
        "ranks": ranks, "plan_ranks": plan.ranks, "world_size": plan.world_size,
        "leaves": plan_leaves(plan), "view": plan_leaves(view),
    }
    group.world_barrier()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
