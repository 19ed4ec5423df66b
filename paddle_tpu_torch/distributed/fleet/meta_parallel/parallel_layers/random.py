"""Deterministic per-rank RNG for tensor parallelism.

Counterpart of `paddle_tpu/distributed/fleet/meta_parallel/
parallel_layers/random.py` (ref: python/paddle/distributed/fleet/layers/
mpu/random.py — RNGStatesTracker:35, model_parallel_random_seed:89). A
tracker state is a key of the port's threefry stream
(`framework/random.py`); `rng_state(name)` splits it (the state keeps the
first half, as the reference's eager branch) and binds the second with
`key_scope` for the block, so the draws inside are the reference's.

"global_seed" draws the same on every model-parallel rank (dropout on
replicated activations). "local_seed" (and Paddle's
"model_parallel_rng") folds this rank's index in the model-parallel group
into the bound key, where the reference folds `axis_index("model")`, so
the ranks draw apart (dropout on sharded activations); with one rank in
the group nothing is folded.
"""
import contextlib

from .....framework import random as frnd

MODEL_PARALLEL_RNG = "model_parallel_rng"
_RANK_LOCAL = ("local_seed", MODEL_PARALLEL_RNG)


class RNGStatesTracker:
    """ref: mpu/random.py:35."""

    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.states_[name] = frnd.key(seed)

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = states

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        new_key, use_key = frnd.split(self.states_[name])
        self.states_[name] = new_key
        if name in _RANK_LOCAL:
            from .mp_ops import resolve_group
            group = resolve_group(None)
            if group is not None:
                use_key = frnd.fold_in(use_key, group.rank)
        with frnd.key_scope(use_key):
            yield


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    """ref: mpu/random.py:89 — "global_seed" is `seed` on every rank,
    "local_seed" `seed + 1024` (told apart by the rank fold at draw
    time); the global generator is reseeded with `seed`."""
    import random as pyrandom
    if seed is None:
        seed = pyrandom.randint(0, 2 ** 31 - 1)
    tracker = get_rng_state_tracker()
    tracker.reset()
    tracker.add("global_seed", seed)
    tracker.add("local_seed", seed + 1024)
    frnd.seed(seed)


def determinate_seed(rng_name):
    return 0


def dropout(x, p=0.5, axis=None, rng_name=MODEL_PARALLEL_RNG, training=True,
            mode="upscale_in_train", name=None):
    """mp-aware dropout (ref: mpu/random.py dropout): the mask from the
    tracker's `rng_name` state when it has one, else the framework key
    stream."""
    from .....nn import functional as F
    tracker = get_rng_state_tracker()
    if rng_name in tracker.states_:
        with tracker.rng_state(rng_name):
            return F.dropout(x, p, axis, training, mode)
    return F.dropout(x, p, axis, training, mode)
