"""DistributedStrategy.

Counterpart of `paddle_tpu/distributed/fleet/distributed_strategy.py`
(ref: python/paddle/distributed/fleet/base/distributed_strategy.py:116 +
proto fluid/framework/distributed_strategy.proto): the reference's
per-feature sub-configs as one nested dict with its defaults; assigning a
dict to a sub-config updates it.
"""
import copy
import json


_DEFAULTS = {
    "hybrid_configs": {
        "dp_degree": 1,
        "mp_degree": 1,
        "pp_degree": 1,
        "sharding_degree": 1,
        "sep_degree": 1,
        "order": ["dp", "pp", "sharding", "mp"],
    },
    "amp": False,
    "amp_configs": {
        "init_loss_scaling": 32768.0,
        "custom_white_list": [],
        "custom_black_list": [],
        "use_pure_fp16": False,
        "use_fp16_guard": True,
        "use_bf16": True,
    },
    "recompute": False,
    "recompute_configs": {"checkpoints": [], "enable_offload": False},
    "sharding": False,
    "sharding_configs": {
        "sharding_degree": 1,
        "stage": 1,
        "offload": False,
        "accumulate_steps": 1,
    },
    "pipeline": False,
    "pipeline_configs": {
        "accumulate_steps": 1,
        "micro_batch_size": 1,
        "enable_partial_send_recv": True,
        "schedule_mode": "1F1B",
    },
    "tensor_parallel": False,
    "tensor_parallel_configs": {"tensor_parallel_degree": 1,
                                "tensor_init_seed": -1},
    "gradient_merge": False,
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    "lamb": False,
    "lars": False,
    "dgc": False,
    "localsgd": False,
    "gradient_scale_configs": {"scale_strategy": "avg"},
    "find_unused_parameters": False,
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "nccl_comm_num": 1,
    "without_graph_optimization": True,
    # Parameter-server mode (ref: distributed_strategy.proto a_sync,
    # a_sync_configs — async PS training knobs; proto default is true).
    "a_sync": True,
    "a_sync_configs": {"k_steps": -1, "send_queue_size": 16,
                       "use_ps_gpu": False},
}


class DistributedStrategy:
    def __init__(self):
        self._conf = copy.deepcopy(_DEFAULTS)

    def __getattr__(self, name):
        conf = object.__getattribute__(self, "_conf")
        if name in conf:
            return conf[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name == "_conf":
            object.__setattr__(self, name, value)
            return
        if name in self._conf:
            cur = self._conf[name]
            if isinstance(cur, dict) and isinstance(value, dict):
                cur.update(value)
            else:
                self._conf[name] = value
        else:
            self._conf[name] = value

    def __repr__(self):
        return json.dumps(self._conf, indent=2, default=str)

    def to_dict(self):
        return copy.deepcopy(self._conf)
