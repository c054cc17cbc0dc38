"""Port parity: optimizers, EMA and gradient clipping.  The same parameters
and gradients (numpy, from a seed) go through the JAX package's optimizer
and the port's for three steps -- the second one gated to 0, as
``MixedPrecision`` gates a non-finite step -- and the parameters must agree
after every step."""

import numpy as np
import pytest
import torch

from lightgrad_tpu import optim as jax_optim
from lightgrad_tpu.autograd import Tensor
from lightgrad_tpu_torch import optim
from tests.torch_port import rand, to_np

# f32 on both sides; Muon's Newton-Schulz products and Adafactor's factored
# moments reorder sums, so 1e-5 relative
TOL = dict(atol=1e-6, rtol=1e-5)
SHAPES = [(16, 24), (24,), (4, 3, 2, 2)]

OPTIMIZERS = {
    "sgd": ("SGD", dict(lr=0.1)),
    "sgd_momentum": ("SGD", dict(lr=0.1, momentum=0.9, weight_decay=0.01)),
    "adam": ("Adam", dict(lr=0.01)),
    "adamw": ("AdamW", dict(lr=0.01, weight_decay=0.05)),
    "adabelief": ("AdaBelief", dict(lr=0.01)),
    "lion": ("Lion", dict(lr=0.01, weight_decay=0.1)),
    "rmsprop": ("RMSprop", dict(lr=0.01)),
    "rmsprop_centered": ("RMSprop", dict(lr=0.01, momentum=0.9,
                                         centered=True)),
    "adagrad": ("Adagrad", dict(lr=0.1)),
    "adafactor": ("Adafactor", dict(lr=0.1, min_dim_size_to_factor=8,
                                    momentum=0.9, weight_decay=0.01)),
    "adafactor_unfactored": ("Adafactor", dict(lr=0.1)),
    "muon": ("Muon", dict(lr=0.02, weight_decay=0.01)),
}


def _data(seed=0, steps=3):
    rng = np.random.default_rng(seed)
    params = [rand(rng, *s) for s in SHAPES]
    grads = [[rand(rng, *s) for s in SHAPES] for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    cls, kw = OPTIMIZERS[name]
    params, grads = _data()
    jp = [Tensor.from_numpy(p.copy()) for p in params]
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    jopt = getattr(jax_optim, cls)(jp, **kw)
    topt = getattr(optim, cls)(tp, **kw)
    for step, (gs, gate) in enumerate(zip(grads, (None, 0.0, 1.0))):
        for j, t, g in zip(jp, tp, gs):
            j.zero_grad()
            j.add_grad(Tensor.from_numpy(g.copy(), requires_grad=False))
            t.grad = torch.tensor(g)
        if gate is not None:
            jopt._gate = Tensor.from_numpy(np.float32(gate),
                                           requires_grad=False)
            topt._gate = torch.tensor(gate)
        jopt.step()
        topt.step()
        jopt._gate = topt._gate = None
        for j, t in zip(jp, tp):
            np.testing.assert_allclose(to_np(t), j.numpy(), **TOL,
                                       err_msg=f"{name} step {step}")


def test_gated_step_leaves_params_and_state():
    """A 0 gate skips the step: parameters, moments and the step counter."""
    params, grads = _data(seed=1)
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    opt = optim.AdamW(tp, lr=0.01)
    for t, g in zip(tp, grads[0]):
        t.grad = torch.tensor(g)
    opt.step()
    before = [t.detach().clone() for t in tp + opt.m + opt.v] + [opt.t.clone()]
    opt._gate = torch.tensor(0.0)
    opt.step()
    after = [t.detach() for t in tp + opt.m + opt.v] + [opt.t]
    for a, b in zip(after, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_grad_norm_matches_jax(max_norm):
    params, grads = _data(seed=2, steps=1)
    jp = [Tensor.from_numpy(p.copy()) for p in params]
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    for j, t, g in zip(jp, tp, grads[0]):
        j.zero_grad()
        j.add_grad(Tensor.from_numpy(g.copy(), requires_grad=False))
        t.grad = torch.tensor(g)
    jn = jax_optim.clip_grad_norm(jp, max_norm)
    tn = optim.clip_grad_norm(tp, max_norm)
    np.testing.assert_allclose(to_np(tn), jn.numpy(), **TOL)
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(to_np(t.grad), j.grad.numpy(), **TOL)


def test_ema_matches_jax():
    params, grads = _data(seed=3)
    jp = [Tensor.from_numpy(p.copy()) for p in params]
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    jema, tema = jax_optim.EMA(jp, decay=0.9), optim.EMA(tp, decay=0.9)
    for gs in grads:                       # move the parameters, then fold
        for j, t, g in zip(jp, tp, gs):
            j._set_data(Tensor.from_numpy(j.numpy() + g).data)
            with torch.no_grad():
                t += torch.from_numpy(g)
        jema.update()
        tema.update()
    for js, ts in zip(jema.shadow, tema.shadow):
        np.testing.assert_allclose(to_np(ts), js.numpy(), **TOL)
    live = [t.detach().clone() for t in tp]
    with tema.average_parameters():
        for t, s in zip(tp, tema.shadow):
            assert torch.equal(t.detach(), s)
    for t, v in zip(tp, live):                 # restored on exit
        assert torch.equal(t.detach(), v)
    state = tema.state_dict()
    fresh = optim.EMA(tp, decay=0.9)
    fresh.load_state_dict(state)
    for a, b in zip(fresh.shadow, tema.shadow):
        assert torch.equal(a, b)
