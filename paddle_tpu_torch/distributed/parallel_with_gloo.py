"""The CPU-only rendezvous tier (ref: python/paddle/distributed/
parallel_with_gloo.py), counterpart of `paddle_tpu/distributed/
parallel_with_gloo.py`: the reference brings up a gloo context for jobs
that never touch a card; here that is the port's TCPStore alone, with its
counter barriers. No process group is made."""

_gloo = {"store": None, "rank": 0, "world": 1, "seq": 0}


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """ref: parallel_with_gloo.py:40 — rendezvous `rank_num` processes
    through the store at server_endpoint (rank 0 hosts it)."""
    from .store import TCPStore
    if _gloo["store"] is not None:
        return
    host, port = str(server_endpoint).rsplit(":", 1)
    store = TCPStore(host, int(port), world_size=int(rank_num),
                     is_master=(int(rank_id) == 0), timeout=120)
    store.barrier("gloo_init", int(rank_num))
    _gloo.update(store=store, rank=int(rank_id), world=int(rank_num), seq=0)


def gloo_barrier():
    """ref: parallel_with_gloo.py gloo_barrier."""
    if _gloo["store"] is None:
        raise RuntimeError("gloo_barrier before gloo_init_parallel_env")
    _gloo["seq"] += 1
    _gloo["store"].barrier(f"gloo_barrier_{_gloo['seq']}", _gloo["world"])


def gloo_release():
    """ref: parallel_with_gloo.py gloo_release — drop the store (its server,
    on rank 0, stays up for the peers until the process exits)."""
    from .store import retire
    retire(_gloo["store"])
    _gloo.update(store=None, rank=0, world=1, seq=0)
