"""Halo schedule compiler: EdgePlan traffic matrix -> verified
multi-round collective schedules — counterpart of ``dgraph_tpu/sched/``.

``ir.py``, ``passes.py`` and ``__main__.py`` are the reference's files with
their import paths changed, so one traffic matrix compiles to the same
:class:`HaloSchedule`, with the same ``schedule_id``, in both packages.
Stdlib only: this package imports neither torch nor numpy, as the
reference's imports no jax. The round executor lives in
:mod:`dgraph_tpu_torch.comm.collectives` and replays the schedule under
``halo_impl="sched"``.
"""

from dgraph_tpu_torch.sched.ir import (
    SCHED_IR_VERSION,
    HaloSchedule,
    Round,
    Transfer,
    normalize_pair_rows,
    verify_schedule,
)
from dgraph_tpu_torch.sched.passes import (
    compile_halo_schedule,
    default_split_threshold,
    normalize_transfers,
    pack_rounds,
    split_transfers,
)

__all__ = [
    "SCHED_IR_VERSION",
    "HaloSchedule",
    "Round",
    "Transfer",
    "compile_halo_schedule",
    "default_split_threshold",
    "normalize_pair_rows",
    "normalize_transfers",
    "pack_rounds",
    "split_transfers",
    "verify_schedule",
]
