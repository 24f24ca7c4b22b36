"""Communication layer: the world-size-1 and multi-rank communicators, the
graph primitives (``collectives``) and process groups (``dist``)."""

from dgraph_tpu_torch.comm.communicator import Communicator, DistComm, SingleComm

__all__ = ["Communicator", "DistComm", "SingleComm"]
