"""DataParallel: the eager data-parallel wrapper.

Counterpart of `paddle_tpu/distributed/parallel.py` (ref:
python/paddle/fluid/dygraph/parallel.py:186 DataParallel +
paddle/fluid/distributed/collective/reducer.cc). An `nn.Module` around the
user's model. In a world above 1 it builds an `EagerReducer` over the
model's parameters (`comm_buffer_size` MB buckets, `grad_compress="int8"`
for compressed flushes), so `loss.backward()` leaves every rank with the
gradients averaged over the data-parallel group; in a world of 1 it passes
through. `parameters()`, `named_parameters()` and `state_dict()` are the
wrapped model's, names unprefixed, so a state moves between the wrapper,
the bare model and the reference by name (`convert.load_numpy_params`).

Every parameter must live where `init_parallel_env` put the rank
(`get_device()`'s type): the backend was chosen for those tensors, so a
CUDA model under a CPU rank (or the reverse) raises.
"""
import contextlib

from torch import nn

from .parallel_env import get_device, get_world_size


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, grad_compress=None, compress_chunk=None):
        super().__init__()
        if grad_compress not in (None, "int8"):
            raise ValueError(f"grad_compress must be None or 'int8', got "
                             f"{grad_compress!r}")
        from .comm_compress import resolve_chunk
        resolve_chunk(compress_chunk)
        self._layers = layers
        self._group = group
        self.find_unused_parameters = find_unused_parameters
        self._reducer = None
        if get_world_size() > 1:
            params = list(layers.parameters())
            dev = get_device()
            wrong = sorted({str(p.device) for p in params
                            if dev is not None and p.device.type != dev.type})
            if wrong:
                raise ValueError(
                    f"DataParallel: parameters on {wrong}, but this rank's "
                    f"process group was set up for {dev} "
                    f"(init_parallel_env(device=...))")
            from .reducer import EagerReducer
            self._reducer = EagerReducer(
                params, bucket_bytes=int(comm_buffer_size) * 1024 * 1024,
                group=group, compress=grad_compress,
                compress_chunk=compress_chunk)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """ref: parallel.py:488 — no gradient sync inside this context."""
        if self._reducer is None:
            yield
            return
        self._reducer.enabled = False
        try:
            yield
        finally:
            self._reducer.enabled = True

    def sync_gradients(self):
        """Flush what the backward left unsynced (the reducer's tail); a
        no-op in a world of 1, under no_sync, and after a backward that
        flushed everything."""
        if self._reducer is not None:
            self._reducer.sync()

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        self.sync_gradients()
