"""Stream-variant collectives (ref: python/paddle/distributed/communication/
stream/). `sync_op` and `use_calc_stream` are taken: `sync_op=False`
returns the pending work (its `wait()` blocks); torch.distributed orders a
rank's collectives on its own streams, so `use_calc_stream` changes
nothing."""
from .. import collective as _c


def _verb(fn):
    def call(*args, use_calc_stream=False, **kwargs):
        return fn(*args, **kwargs)
    call.__name__ = fn.__name__
    call.__doc__ = fn.__doc__
    return call


all_reduce = _verb(_c.all_reduce)
all_gather = _verb(_c.all_gather)
alltoall = _verb(_c.alltoall)
reduce_scatter = _verb(_c.reduce_scatter)
broadcast = _verb(_c.broadcast)
reduce = _verb(_c.reduce)
scatter = _verb(_c.scatter)
send = _verb(_c.send)
recv = _verb(_c.recv)
all_to_all_single = _verb(_c.all_to_all_single)
alltoall_single = all_to_all_single
