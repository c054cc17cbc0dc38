"""Port parity: learning-rate schedules (``lightgrad_tpu_torch.schedule``)
and tensor learning rates in every port optimizer.

The schedules' values equal the JAX package's step for step (exactly: both
round each value to float32).  A scheduled ``lr`` is a 0-d float32 tensor
on the parameters' device, written in place.  Every optimizer's step with a
tensor ``lr`` equals its step with the same value as a Python float, bit for
bit, on ``torch.nn`` parameters and on tape parameters; the values are
float32-representable, so both forms carry the same number.  An Adam run
under ``WarmupCosine`` follows the JAX package's run on the same weights
(tolerance 1e-6).
"""

import numpy as np
import pytest
import torch

import lightgrad_tpu as light
from lightgrad_tpu.autograd import CpuTensor
from lightgrad_tpu_torch import optim, schedule
from lightgrad_tpu_torch.autograd import Tensor
from tests.torch_port import cpu_device  # noqa: F401

SCHEDULES = [
    ("StepLR", dict(step_size=3, gamma=0.5), 0.1),
    ("CosineAnnealingLR", dict(t_max=10, eta_min=0.1), 1.0),
    ("WarmupCosine", dict(warmup=4, total=12, min_lr=0.0), 1.0),
    ("WarmupCosine", dict(warmup=3, total=9, min_lr=1e-5), 3e-4),
]


@pytest.mark.parametrize("name,kw,lr", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(SCHEDULES)])
def test_schedule_values_match_jax(name, kw, lr):
    w = CpuTensor.from_numpy(np.ones((4, 4), np.float32))
    js = getattr(light.schedule, name)(light.optim.SGD([w], lr=lr), **kw)
    p = torch.nn.Parameter(torch.ones(4, 4))
    opt = optim.SGD([p], lr=lr)
    ts = getattr(schedule, name)(opt, **kw)
    want = [js.step() for _ in range(14)]
    got = [ts.step() for _ in range(14)]
    assert got == want
    assert ts.last_lr == want[-1]
    assert opt.lr is ts._lr_t
    assert opt.lr.dtype == torch.float32 and opt.lr.dim() == 0


def test_step_lr_and_warmup_shapes():
    p = torch.nn.Parameter(torch.ones(4, 4))
    s = schedule.StepLR(optim.SGD([p], lr=0.1), step_size=3, gamma=0.5)
    np.testing.assert_allclose(
        [s.step() for _ in range(7)],
        [0.1, 0.1, 0.05, 0.05, 0.05, 0.025, 0.025], rtol=1e-6)
    s = schedule.WarmupCosine(optim.SGD([p], lr=1.0), warmup=4, total=12)
    vals = [s.step() for _ in range(12)]
    assert vals[0] < vals[1] < vals[2] < vals[3] == pytest.approx(1.0)
    assert all(a >= b for a, b in zip(vals[3:], vals[4:]))
    assert vals[-1] == pytest.approx(0.0, abs=1e-6)


def test_scheduled_lr_is_written_in_place():
    """The optimizer keeps one tensor; each step rewrites its value."""
    w = Tensor.from_numpy(np.ones((4, 4), np.float32))
    opt = optim.SGD([w], lr=0.5)
    s = schedule.StepLR(opt, step_size=1, gamma=0.5)
    lr = opt.lr
    assert lr.device == w.data.device
    w.add_grad(Tensor.from_numpy(np.ones((4, 4), np.float32),
                                 requires_grad=False))
    opt.step()
    np.testing.assert_allclose(w.numpy(), np.ones((4, 4)) - 0.5, rtol=1e-6)
    s.step()
    assert opt.lr is lr and float(lr) == 0.25
    opt.step()
    np.testing.assert_allclose(w.numpy(), np.ones((4, 4)) - 0.75, rtol=1e-6)


# (name, constructor keywords); lr 2**-7 is float32-representable
OPTIMIZERS = [
    ("SGD", {}), ("SGD", dict(momentum=0.9, weight_decay=0.01)),
    ("Adam", {}), ("AdamW", dict(weight_decay=0.0)),
    ("AdamW", dict(weight_decay=0.01)), ("AdaBelief", {}), ("Lion", {}),
    ("Lion", dict(weight_decay=0.1)), ("RMSprop", {}),
    ("RMSprop", dict(momentum=0.9, centered=True)), ("Adagrad", {}),
    ("Adafactor", dict(scale_parameter=False)),
    ("Adafactor", dict(momentum=0.9, weight_decay=0.01)),
    ("Muon", dict(weight_decay=0.01)),
]
LR = 2.0 ** -7


def _params(rng, tape):
    shapes = [(130, 140), (24,), (3, 4, 5)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    if tape:
        ps = [Tensor.from_numpy(a) for a in arrs]
    else:
        ps = [torch.nn.Parameter(torch.from_numpy(a)) for a in arrs]
    return ps, grads


def _run(name, kw, tensor_lr, tape):
    ps, grads = _params(np.random.default_rng(0), tape)
    opt = getattr(optim, name)(ps, lr=LR, **kw)
    if tensor_lr:
        opt.lr = torch.tensor(LR, dtype=torch.float32)
    for gs in grads:
        opt.zero_grad()
        for p, g in zip(ps, gs):
            if tape:
                p.add_grad(Tensor.from_numpy(g, requires_grad=False))
            else:
                p.grad = torch.from_numpy(g)
        opt.step()
    return [p.numpy() if tape else p.detach().numpy() for p in ps]


@pytest.mark.parametrize("tape", [False, True], ids=["torch", "tape"])
@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_tensor_lr_step_equals_float_step(name, kw, tape):
    for a, b in zip(_run(name, kw, False, tape), _run(name, kw, True, tape)):
        np.testing.assert_array_equal(a, b)


def test_adam_under_warmup_cosine_matches_jax():
    """Three Adam steps under WarmupCosine on the same weights and
    gradients, JAX package against the port (1e-6)."""
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((8, 8)).astype(np.float32)
    grads = [rng.standard_normal((8, 8)).astype(np.float32)
             for _ in range(3)]
    jw = CpuTensor.from_numpy(w0)
    jopt = light.optim.Adam([jw], lr=1e-2)
    js = light.schedule.WarmupCosine(jopt, warmup=1, total=4)
    tw = Tensor.from_numpy(w0)
    topt = optim.Adam([tw], lr=1e-2)
    ts = schedule.WarmupCosine(topt, warmup=1, total=4)
    js.step()
    ts.step()
    for g in grads:
        jw.zero_grad()
        jw.add_grad(CpuTensor.from_numpy(g, requires_grad=False))
        jopt.step()
        tw.zero_grad()
        tw.add_grad(Tensor.from_numpy(g, requires_grad=False))
        topt.step()
        assert js.step() == ts.step()
    np.testing.assert_allclose(tw.numpy(), jw.numpy(), rtol=1e-6, atol=1e-6)
