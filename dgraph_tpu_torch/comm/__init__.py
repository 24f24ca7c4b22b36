"""Communication layer (single rank in this slice)."""

from dgraph_tpu_torch.comm.communicator import SingleComm

__all__ = ["SingleComm"]
