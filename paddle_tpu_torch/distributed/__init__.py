"""paddle.distributed on torch.distributed: counterpart of
`paddle_tpu/distributed/`.

The eager collective stack: `init_parallel_env` (TCPStore rendezvous, then
one process group whose backend follows where the ranks' tensors live),
the collective verbs and groups (`collective`, `communication`), the RPC
agent (`rpc`), gloo's store-only tier (`parallel_with_gloo`); above them
data parallelism (`EagerReducer`, `DataParallel`, `fleet`), and the
topology math. Besides: the int8 compression (`comm_compress`), the atomic
CRC-checked checkpoints (`checkpoint`), the rendezvous `store` and `spawn`.
"""
from .parallel_env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                           init_parallel_env, is_initialized, get_store,
                           get_backend)
from .collective import (new_group, get_group, Group, all_reduce,  # noqa: F401
                         all_gather, all_gather_into_tensor, reduce_scatter,
                         broadcast, reduce, scatter, send, recv, barrier,
                         ReduceOp, wait, split as collective_split, alltoall,
                         alltoall as all_to_all, isend, irecv, P2POp,
                         batch_isend_irecv, all_gather_object,
                         broadcast_object_list, scatter_object_list,
                         all_to_all_single,
                         all_to_all_single as alltoall_single,
                         is_available, destroy_process_group)
from .topology import (CommunicateTopology,  # noqa: F401
                       HybridCommunicateGroup, ParallelMode)
from .parallel_with_gloo import (gloo_init_parallel_env,  # noqa: F401
                                 gloo_barrier, gloo_release)
from .parallel import DataParallel  # noqa: F401
from . import fleet  # noqa: F401
from . import comm_compress  # noqa: F401
from . import communication  # noqa: F401
from .spawn import spawn  # noqa: F401
from .store import TCPStore  # noqa: F401
from . import rpc  # noqa: F401
