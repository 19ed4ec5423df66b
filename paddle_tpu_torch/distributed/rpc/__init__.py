"""paddle.distributed.rpc (ref: python/paddle/distributed/rpc/rpc.py),
counterpart of `paddle_tpu/distributed/rpc/`: the agent (`init_rpc`,
`rpc_sync`, `rpc_async`, `shutdown`, the worker-info queries) and the wire
framing the process fleet shares (`send_msg`, `recv_msg`)."""
from .rpc import (init_rpc, rpc_sync, rpc_async, shutdown,  # noqa: F401
                  get_worker_info, get_all_worker_infos,
                  get_current_worker_info, WorkerInfo, send_msg, recv_msg,
                  _send_msg, _recv_msg)

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos",
           "get_current_worker_info", "WorkerInfo", "send_msg", "recv_msg"]
