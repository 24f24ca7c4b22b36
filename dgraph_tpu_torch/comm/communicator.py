"""Communicator facade — the single-rank subset of
``dgraph_tpu/comm/communicator.py``.

:class:`SingleComm` is the world-size-1 communicator the models are written
against; a multi-rank ``torch.distributed`` communicator with the same
methods is a later slice, and model code will not change for it.
"""

from __future__ import annotations

import dataclasses

from dgraph_tpu_torch.comm import collectives
from dgraph_tpu_torch.plan import EdgePlan


@dataclasses.dataclass(frozen=True)
class SingleComm:
    """World-size-1 communicator (no collectives)."""

    def get_rank(self) -> int:
        return 0

    def get_world_size(self) -> int:
        return 1

    def split_active(self, plan: EdgePlan) -> bool:
        return collectives.split_active(plan)

    def gather(self, x, plan: EdgePlan, side: str = "src"):
        return collectives.gather(x, plan, side)

    def halo_extend(self, x, plan: EdgePlan, side: str = "src"):
        return collectives.halo_extend(x, plan, side)

    def local_take(self, x_full, plan: EdgePlan, side: str = "src"):
        return collectives.local_take(x_full, plan, side)

    def scatter(self, edata, plan: EdgePlan, side: str = "dst"):
        return collectives.scatter_sum(edata, plan, side)

    scatter_sum = scatter

    def scatter_bias_relu(self, edata, bias, plan: EdgePlan, side: str = "dst",
                          edge_weight=None):
        return collectives.scatter_bias_relu(edata, bias, plan, side, edge_weight)
