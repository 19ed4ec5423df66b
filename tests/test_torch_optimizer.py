"""Adam and AdamW: paddle_tpu_torch's eager optimizers against the
reference's (`paddle_tpu.optimizer`), from the same parameters and
gradients (seeded numpy), three steps.

What each test pins:
  - tolerance rtol 1e-6, atol 1e-7 (in practice bit-equal but for an
    occasional last-bit difference of the reference's vectorised f32
    arithmetic): parameters and both moments after three steps of Adam
    with an `L2Decay` regulariser, a float weight decay (an `L2Decay`
    too), and AdamW, in f32; and with bf16 parameters under
    `multi_precision` (f32 master weights, the update cast to bf16): the
    master weights and moments, and the bf16 parameters exactly;
  - exact: the `apply_decay_param_fun` decision (the port calls it with
    each `named_parameters()` name; the reference with `Parameter.name`,
    which here is set to the same names), and its refusal for a bare
    parameter list, which has no names to give;
  - `convert.optimizer_state_from_numpy` carries the reference's moments,
    step count and master weights bit for bit, and one more step from the
    carried state matches the reference's within the tolerance above;
  - refusals: LRScheduler, grad_clip, parameter groups, sparse grads.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu  # noqa: F401  (x64 on, as the reference runs)
from paddle_tpu import optimizer as jopt
from paddle_tpu.nn.layer.layers import Parameter
from paddle_tpu.tensor.tensor import Tensor
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import optimizer_state_from_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"linear.weight": (8, 16), "linear.bias": (16,),
          "norm.weight": (16,)}


def _data(seed=0, steps=3):
    rng = np.random.RandomState(seed)
    params = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(steps)]
    return params, grads


def _ref(cls, params, grads, dtype=jnp.float32, **kw):
    ps = [Parameter(jnp.asarray(params[n]).astype(dtype), name=n)
          for n in SHAPES]
    opt = cls(parameters=ps, **kw)
    for g in grads:
        for p in ps:
            p.grad = Tensor(jnp.asarray(g[p.name]).astype(dtype))
        opt.step()
    return {p.name: np.asarray(p.data.astype(jnp.float32)) for p in ps}, opt


def _port(cls, params, grads, dtype=torch.float32, **kw):
    ps = {n: torch.nn.Parameter(torch.tensor(params[n]).to(dtype))
          for n in SHAPES}
    opt = cls(parameters=list(ps.items()), **kw)
    for g in grads:
        for n, p in ps.items():
            p.grad = torch.from_numpy(g[n]).to(dtype)
        opt.step()
    return {n: p.detach().float().numpy() for n, p in ps.items()}, opt


def _state(opt, name, key):
    st = opt._accumulators["__state__"][name][key]
    return np.asarray(st) if not isinstance(st, torch.Tensor) else st.numpy()


CASES = {
    "adam_l2decay": (jopt.Adam, topt.Adam, lambda m: dict(
        learning_rate=1e-2, weight_decay=m.L2Decay(0.05))),
    "adam_float_decay": (jopt.Adam, topt.Adam, lambda m: dict(
        learning_rate=1e-2, weight_decay=0.05)),
    "adamw": (jopt.AdamW, topt.AdamW, lambda m: dict(
        learning_rate=1e-2, weight_decay=0.1, beta1=0.8, epsilon=1e-6)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_steps_match_reference(case):
    jcls, tcls, kw = CASES[case]
    params, grads = _data(1)
    ref, ropt = _ref(jcls, params, grads, **kw(jopt))
    got, topt_ = _port(tcls, params, grads, **kw(topt))
    for n in SHAPES:
        np.testing.assert_allclose(got[n], ref[n], err_msg=n, **TOL)
        for key in ("moment1", "moment2"):
            np.testing.assert_allclose(_state(topt_, n, key),
                                       _state(ropt, n, key), err_msg=n, **TOL)
    assert topt_._step_count == ropt._step_count == 3


@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_precision_bf16_matches_reference(case):
    jcls, tcls, kw = CASES[case]
    params, grads = _data(2)
    ref, ropt = _ref(jcls, params, grads, jnp.bfloat16,
                     multi_precision=True, **kw(jopt))
    got, topt_ = _port(tcls, params, grads, torch.bfloat16,
                       multi_precision=True, **kw(topt))
    assert sorted(topt_._master_weights) == sorted(SHAPES)
    for n in SHAPES:
        master = topt_._master_weights[n]
        assert master.dtype == torch.float32
        np.testing.assert_allclose(master.numpy(),
                                   np.asarray(ropt._master_weights[n]),
                                   err_msg=n, **TOL)
        np.testing.assert_array_equal(got[n], master.to(
            torch.bfloat16).float().numpy())
        np.testing.assert_allclose(got[n], ref[n], rtol=2 ** -8, atol=0)
        for key in ("moment1", "moment2"):
            np.testing.assert_allclose(_state(topt_, n, key),
                                       _state(ropt, n, key), err_msg=n, **TOL)


def test_apply_decay_param_fun_decision():
    """Zero gradients leave Adam's step at zero, so a parameter moves by
    the decay alone: (1 - lr * coeff) where the function accepts its
    name, not at all where it refuses it. The port passes the
    `named_parameters()` names."""
    params, _ = _data(3, steps=0)
    zero = [{n: np.zeros(s, np.float32) for n, s in SHAPES.items()}]
    seen = []

    def fun(name):
        seen.append(name)
        return not name.endswith("bias") and "norm" not in name

    kw = dict(learning_rate=0.1, weight_decay=0.5, apply_decay_param_fun=fun)
    ref, _ = _ref(jopt.AdamW, params, zero, **kw)
    ref_seen, seen[:] = list(seen), []
    got, _ = _port(topt.AdamW, params, zero, **kw)
    assert seen == ref_seen == list(SHAPES)
    for n in SHAPES:
        np.testing.assert_array_equal(got[n], ref[n])
        decayed = fun(n)
        assert np.array_equal(got[n], params[n]) != decayed, n
    with pytest.raises(TypeError, match="named_parameters"):
        topt.AdamW(parameters=[torch.nn.Parameter(torch.zeros(2))],
                   apply_decay_param_fun=fun)


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "bf16_master"])
def test_optimizer_state_from_numpy_round_trip(mp):
    """The reference's state after two steps, carried into a fresh port
    AdamW (with the parameters), gives bit-equal state tensors, and the
    third step from it matches the reference's third step."""
    params, grads = _data(4)
    jd, td = (jnp.bfloat16, torch.bfloat16) if mp else (jnp.float32,
                                                        torch.float32)
    kw = dict(learning_rate=1e-2, weight_decay=0.1, multi_precision=mp)
    mid, ropt = _ref(jopt.AdamW, params, grads[:2], jd, **kw)
    acc = {n: {k: np.asarray(v) for k, v in st.items()}
           for n, st in ropt._accumulators["__state__"].items()}
    masters = {n: np.asarray(v) for n, v in ropt._master_weights.items()}
    end, _ = _ref(jopt.AdamW, params, grads, jd, **kw)

    ps = {n: torch.nn.Parameter(torch.tensor(mid[n]).to(td))
          for n in SHAPES}
    opt = topt.AdamW(parameters=list(ps.items()), **kw)
    optimizer_state_from_numpy(opt, acc, ropt._step_count,
                               masters if mp else None)
    assert opt._step_count == 2
    for n in SHAPES:
        for k in ("moment1", "moment2"):
            np.testing.assert_array_equal(
                _state(opt, n, k).view(np.uint32), acc[n][k].view(np.uint32))
        if mp:
            np.testing.assert_array_equal(opt._master_weights[n].numpy(),
                                          masters[n])
        ps[n].grad = torch.from_numpy(grads[2][n]).to(td)
    opt.step()
    for n in SHAPES:
        np.testing.assert_allclose(ps[n].detach().float().numpy(), end[n],
                                   err_msg=n, **TOL)
    with pytest.raises(ValueError, match="no such parameter"):
        optimizer_state_from_numpy(opt, {"other": acc["linear.bias"]}, 2)
    with pytest.raises(ValueError, match="shape"):
        optimizer_state_from_numpy(
            opt, {"linear.bias": {"moment1": np.zeros(3, np.float32)}}, 2)


def test_refusals_name_roadmap():
    p = torch.nn.Parameter(torch.zeros(4))
    sched = jopt.lr.StepDecay(0.1, step_size=2)
    with pytest.raises(NotImplementedError, match="A9.1"):
        topt.AdamW(sched, parameters=[p])
    with pytest.raises(NotImplementedError, match="A9.1"):
        topt.Adam(parameters=[p], grad_clip=object())
    with pytest.raises(NotImplementedError, match="A9.1"):
        topt.Adam(parameters=[{"params": [p]}])
    opt = topt.Adam(parameters=[p])
    with pytest.raises(NotImplementedError, match="A9.1"):
        opt.set_lr_scheduler(sched)
    p.grad = torch.zeros(4).to_sparse()
    with pytest.raises(NotImplementedError, match="A9.1"):
        opt.step()
    # lr_ratio is taken and changes nothing
    q1, q2 = (torch.nn.Parameter(torch.ones(4)) for _ in range(2))
    for q, extra in ((q1, {}), (q2, dict(lr_ratio=lambda _: 0.5))):
        q.grad = torch.full((4,), 0.5)
        topt.AdamW(0.1, parameters=[q], **extra).step()
    assert torch.equal(q1, q2)
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25
    p.grad = torch.ones(4)
    opt.clear_grad()
    assert p.grad is None
