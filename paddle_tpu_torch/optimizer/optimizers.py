"""SGD, Adam and AdamW, counterparts of `paddle_tpu/optimizer/
optimizers.py`'s.

SGD: p - lr g (lr in the parameter's dtype, as JAX's weak scalar).
Adam: f32 moments m, v; m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), in f32, the step
cast to the parameter's dtype. AdamW first decays p by (1 - lr * coeff)
(in p's dtype), skipping the parameters whose name
`apply_decay_param_fun(name)` refuses, then takes Adam's step.
"""
import torch

from .optimizer import Optimizer, scalar


class SGD(Optimizer):
    def _rule(self, p, g, state, lr, t, name=None):
        return p - lr * g, state


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_state(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device),
                "moment2": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)}

    def _rule(self, p, g, state, lr, t, name=None):
        b1, b2 = self._beta1, self._beta2
        g32 = g.float()
        m = b1 * state["moment1"] + (1 - b1) * g32
        v = b2 * state["moment2"] + (1 - b2) * g32 * g32
        mhat = m / scalar(1 - b1 ** t, m)
        vhat = v / scalar(1 - b2 ** t, v)
        upd = lr * mhat / (torch.sqrt(vhat) + self._epsilon)
        return p - upd.to(p.dtype), {"moment1": m, "moment2": v}


class AdamW(Adam):
    """Adam with decoupled weight decay. `apply_decay_param_fun` is called
    with each parameter's optimizer name (the `named_parameters()` name
    when the optimizer is given (name, parameter) pairs; a bare parameter
    list has no names to give, so it refuses the argument). `lr_ratio` is
    taken and has no effect, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._coeff = (float(weight_decay) if not callable(weight_decay)
                       else 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._decay_skip = set()
        if apply_decay_param_fun is not None and parameters is not None:
            if not self._names_given:
                raise TypeError(
                    "apply_decay_param_fun needs parameter names: pass "
                    "parameters=model.named_parameters()")
            self._decay_skip = {n for n, _ in self._named
                                if not apply_decay_param_fun(n)}

    def _rule(self, p, g, state, lr, t, name=None):
        coeff = 0.0 if name in self._decay_skip else self._coeff
        p = p * scalar(1.0 - lr * coeff, p)
        return super()._rule(p, g, state, lr, t, name)
