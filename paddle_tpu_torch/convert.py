"""Move a `paddle_tpu` model's parameters, a `paddle_tpu` trainer's state,
or an eager `paddle_tpu` optimizer's state into their `paddle_tpu_torch`
counterparts (LLaMA, GPT, BERT; Adam and AdamW).

Both packages keep Paddle's [in, out] weight layout and the same parameter
names, so the copy is by name with no transposes. The caller hands over
numpy arrays (this package never imports jax or paddle_tpu).
"""
import numpy as np
import torch


def load_numpy_params(model, arrays):
    """Copy `arrays` ({parameter name: numpy array}, e.g. the JAX model's
    `named_parameters()` as numpy) into `model` in place. Every name of
    either side must appear on the other with the same shape; anything
    else raises ValueError. Values are copied bit for bit (dtype cast only
    where the two dtypes differ)."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"unexpected {extra}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} does not match "
                             f"the model's {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.tensor(np.asarray(arrays[name])))
    return model


def trainer_state_from_numpy(trainer, params, opt=None, step=0):
    """A `paddle_tpu_torch` `SpmdTrainer` state carried over from the
    reference trainer's, as numpy:

    - params: `trainer.gather_params(state)` of the reference —
      {"outer": [the embedding's, final norm's and lm_head's parameters,
      in `trainer.outer_names` order (GPT: word then position table,
      ln_f weight and bias, lm_head)], "stacked": [[L, ...] per decoder
      parameter name]} — the stacks in the trainer's `phys_order`;
    - opt: the reference's `state["opt"]` of one rank, {"outer": [{"m",
      "v"}], "stacked": [{"m", "v"}]}, each moment flat (a stacked one
      over the whole [L, ...] block; padding past the parameter's size is
      dropped), or None for zero moments;
    - step: the reference's step counter.

    Params are cast to the trainer's param_dtype and moments to its
    moment_dtype (bit for bit where the dtypes agree)."""
    n_out, n_lay = len(trainer.outer_names), len(trainer.layer_param_names)
    if len(params["outer"]) != n_out or len(params["stacked"]) != n_lay:
        raise ValueError(
            f"expected {n_out} outer and {n_lay} stacked arrays, got "
            f"{len(params['outer'])} and {len(params['stacked'])}")
    order = trainer.phys_order
    state = trainer.init_state()
    like = state["params"]

    def put(dst, a, name):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} does not "
                             f"match {tuple(dst.shape)}")
        if a.dtype.kind == "V":     # bfloat16 as numpy holds it: exact in f32
            a = a.astype(np.float32)
        dst.copy_(torch.tensor(a))

    def flat(a, shape):
        a = np.asarray(a).reshape(-1)
        return a[:int(np.prod(shape))].reshape(shape)

    with torch.no_grad():
        for i, name in enumerate(trainer.outer_names):
            put(like[name], params["outer"][i], name)
            if opt is not None:
                for k in ("m", "v"):
                    put(state["opt"][name][k],
                        flat(opt["outer"][i][k], like[name].shape), name)
        for i, pname in enumerate(trainer.layer_param_names):
            block = np.asarray(params["stacked"][i])
            one = like[trainer.layer_name(0, pname)].shape
            mom = ({k: flat(opt["stacked"][i][k], (len(order),) + tuple(one))
                    for k in ("m", "v")} if opt is not None else None)
            for phys, li in enumerate(order):
                name = trainer.layer_name(li, pname)
                put(like[name], block[phys], name)
                if mom is not None:
                    for k in ("m", "v"):
                        put(state["opt"][name][k], mom[k][phys], name)
    state["step"] = int(step)
    return state


def optimizer_state_from_numpy(optimizer, accumulators, step_count=0,
                               master_weights=None):
    """Carry an eager reference optimizer's state, as numpy, into the
    port's `Adam` / `AdamW` `optimizer`, so both sides go on from one
    mid-training state:

    - accumulators: the reference's `_accumulators["__state__"]`, {name:
      {"moment1", "moment2"}}, keyed by the port optimizer's parameter
      names (the reference keys by `Parameter.name`; the caller maps
      those to the port's names);
    - step_count: the reference's `_step_count` (the next step is
      step_count + 1 in the bias corrections);
    - master_weights: the reference's `_master_weights` ({name: f32
      array}, `multi_precision`), or None.

    Arrays are copied bit for bit as f32 tensors on each parameter's
    device. A name the optimizer does not hold, or a shape that differs,
    raises ValueError."""
    params = dict(optimizer._params)

    def put(name, a):
        if name not in params:
            raise ValueError(f"{name!r}: no such parameter in the optimizer")
        a = np.asarray(a)
        if a.dtype.kind == "V":     # bfloat16 as numpy holds it: exact in f32
            a = a.astype(np.float32)
        p = params[name]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} does not match "
                             f"the parameter's {tuple(p.shape)}")
        return torch.tensor(a, dtype=torch.float32, device=p.device)

    states = {name: {k: put(name, a) for k, a in st.items()}
              for name, st in accumulators.items()}
    masters = {name: put(name, a)
               for name, a in (master_weights or {}).items()}
    optimizer._accumulators["__state__"] = states
    optimizer._master_weights = masters
    optimizer._step_count = int(step_count)
    return optimizer
