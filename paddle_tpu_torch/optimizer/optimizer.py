"""The eager optimizer base, counterpart of `paddle_tpu/optimizer/
optimizer.py` (`Optimizer`, `L2Decay`, `L1Decay`).

An optimizer holds its parameters in order, each under a name: the names
of `model.named_parameters()` when it is given (name, parameter) pairs,
else `param_{i}` by position. The name keys its state
(`_accumulators["__state__"][name]`, `_master_weights[name]`) and is what
`AdamW`'s `apply_decay_param_fun` is called with. The reference keys by
`Parameter.name`, a counter the deep-copied layers of a
`TransformerEncoder` share with the first layer, so there those layers
share one state; here every parameter has its own (ROADMAP Queue C).

`step()` runs the update rule `_rule(p, g, state, lr, t)` of each
parameter with a gradient, in f32 state: the regulariser first (`grad +
coeff * param`, or its L1 form), on the f32 master weight with
`multi_precision` for a bf16/fp16 parameter, then the rule, the result
cast to the parameter's dtype. Scalars enter the arithmetic in the
tensors' dtype, as JAX's weak Python scalars do; a division by a scalar
divides by a 0-dim tensor on the parameter's device (CUDA would multiply
by the reciprocal of a Python scalar).

Not ported (ROADMAP A9.1): `LRScheduler` learning rates, `grad_clip`,
parameter groups, the sparse (`SelectedRows`) path, per-parameter
regularisers and learning rates (`ParamAttr`), and the optimizers other
than SGD, Adam and AdamW. Each raises NotImplementedError.
"""
import torch

_A91 = "is not ported yet (ROADMAP A9.1)"


def scalar(value, like):
    """`value` as a 0-dim tensor of `like`'s dtype on its device."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


class L2Decay:
    """grad + coeff * param (coeff in param's dtype)."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, grad, param):
        return grad + scalar(self.coeff, param) * param


class L1Decay:
    """grad + coeff * sign(param) (coeff in param's dtype)."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, grad, param):
        return grad + scalar(self.coeff, param) * torch.sign(param)


def _named(parameters):
    """[(name, Parameter)] from parameters or (name, parameter) pairs, and
    whether the names are the caller's."""
    items = list(parameters)
    if any(isinstance(p, dict) for p in items):
        raise NotImplementedError(f"parameter groups {_A91}")
    if items and all(isinstance(p, tuple) and len(p) == 2 for p in items):
        named = [(str(n), p) for n, p in items]
        given = True
    else:
        named = [(f"param_{i}", p) for i, p in enumerate(items)]
        given = False
    for n, p in named:
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"parameter {n!r} is a {type(p).__name__}, not a "
                            f"tensor")
    if len({n for n, _ in named}) != len(named):
        raise ValueError("two parameters share a name")
    return named, given


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                f"learning rate {type(learning_rate).__name__}: "
                f"LRScheduler {_A91}")
        if grad_clip is not None:
            raise NotImplementedError(f"grad_clip {_A91}")
        self._learning_rate = float(learning_rate)
        self._named, self._names_given = ((None, False) if parameters is None
                                          else _named(parameters))
        self._multi_precision = multi_precision
        self._accumulators = {"__state__": {}}
        self._master_weights = {}
        self._step_count = 0
        self._name = name
        if isinstance(weight_decay, (int, float)):
            self._regularization = L2Decay(float(weight_decay))
        else:
            self._regularization = weight_decay

    # -- lr ------------------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        raise NotImplementedError(f"LRScheduler {_A91}")

    # -- state ---------------------------------------------------------------
    @property
    def _params(self):
        if self._named is None:
            raise ValueError("optimizer constructed without parameters")
        return self._named

    def _create_state(self, p):
        return {}

    def _ensure_state(self, name, p):
        states = self._accumulators["__state__"]
        if name not in states:
            states[name] = self._create_state(p)
        return states[name]

    def _master_or_param(self, name, p):
        """The f32 master weight of a bf16/fp16 parameter under
        `multi_precision` (made from it at first use), else the parameter
        itself."""
        if self._multi_precision and p.dtype in (torch.float16,
                                                 torch.bfloat16):
            if name not in self._master_weights:
                self._master_weights[name] = p.detach().float()
            return self._master_weights[name]
        return p.detach()

    def _rule(self, p, g, state, lr, t, name=None):
        raise NotImplementedError

    # -- the eager step ------------------------------------------------------
    @torch.no_grad()
    def step(self):
        pg = [(n, p) for n, p in self._params
              if p.requires_grad and p.grad is not None]
        self._step_count += 1
        t = self._step_count
        lr = self.get_lr()
        for name, p in pg:
            g = p.grad
            if g.is_sparse:
                raise NotImplementedError(f"sparse gradients {_A91}")
            pw = self._master_or_param(name, p)
            if self._regularization is not None:
                g = self._regularization(g, pw)
            state = self._ensure_state(name, p)
            new_p, new_state = self._rule(pw, g.to(pw.dtype), state, lr, t,
                                          name)
            if name in self._master_weights:
                self._master_weights[name] = new_p
                p.copy_(new_p.to(p.dtype))
            else:
                p.copy_(new_p)
            self._accumulators["__state__"][name] = new_state

    def clear_grad(self, set_to_zero=False):
        for _, p in self._params:
            if set_to_zero and p.grad is not None:
                p.grad = torch.zeros_like(p.grad)
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None
