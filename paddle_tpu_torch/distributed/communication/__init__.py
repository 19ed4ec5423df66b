"""The public collectives namespace (ref: python/paddle/distributed/
communication/), over `distributed/collective.py`."""
from ..collective import (all_reduce, all_gather, alltoall,  # noqa: F401
                          reduce_scatter, broadcast, reduce, scatter, send,
                          recv, barrier, ReduceOp, wait, all_to_all_single,
                          all_gather_object, broadcast_object_list,
                          scatter_object_list, isend, irecv, P2POp,
                          batch_isend_irecv)
from . import stream  # noqa: F401
