"""paddle.distributed.spawn (ref: python/paddle/distributed/spawn.py:472).

Counterpart of `paddle_tpu/distributed/spawn.py`: nprocs processes of the
`spawn` start method, each with PADDLE_TRAINER_ID (its rank) and
PADDLE_TRAINERS_NUM in its environment. Never `fork`: a forked child of a
process that has touched CUDA cannot use CUDA. A spawned child re-imports
the parent's `__main__` as `__mp_main__`, so a script that spawns must
keep its top level free of work; the target must be a module-level
function (it is pickled by reference).
"""
import multiprocessing
import os


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    if nprocs == -1:
        nprocs = 1
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs)}
        p = ctx.Process(target=_wrap, args=(func, args, env), daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
    return procs


def _wrap(func, args, env):
    os.environ.update(env)
    func(*args)
