"""Port parity: master-weight AMP on lightgrad tape modules
(``amp.cast_module`` and ``amp.MixedPrecision`` given a tape module).

The counterparts of tests/test_amp.py's checks, on a tiny tape LLaMA and a
Conv2d + Linear net built by the JAX package and carried across with
``load_numpy_params``: the f32 masters after 3 bf16 ``MixedPrecision`` Adam
steps against the JAX package's, masters that integrate what plain bf16
rounds away, a non-finite step skipped by the gate while the scaler backs
off, f32 inputs into bf16 layers, and ``cast_module`` round-tripping f32
-> bf16 -> f32.

Tolerance of the masters after 3 Adam steps at lr 1e-3: the bf16 gradients
of the two packages round differently, and Adam's first steps move a weight
by about lr times the sign of its gradient, so a gradient within bf16 noise
of zero may step either way: at most 6 lr apart (a flip at every step), and
the median weight within lr / 10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from tests.test_torch_llama import _models as llama_models
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

LR = 1e-3


def _conv_nets(seed=0):
    np.random.seed(seed)
    lt.random.seed(seed)
    nets = [p.nn.Sequential(p.nn.Conv2d(2, 4, 3), p.nn.ReLU(),
                            p.nn.Flatten(), p.nn.Linear(4 * 6 * 6, 3))
            for p in (light, lt)]
    state = {n: p.numpy() for n, p in nets[0].named_parameters()}
    lt.load_numpy_params(nets[1], state)
    return nets


def _conv_batch(T, seed=0):
    rng = np.random.default_rng(seed)
    x = T.from_numpy(rng.uniform(-1, 1, (4, 2, 6, 6)).astype(np.float32),
                     requires_grad=False)
    y = T.from_numpy(rng.uniform(-1, 1, (4, 3)).astype(np.float32),
                     requires_grad=False)
    return x, y


def _conv_loss(pkg, T, model, dtype):
    x, y = _conv_batch(T)
    return pkg.loss.mse(model(x), y.astype(dtype))


def _llama_loss(pkg, T, model, dtype):
    ids = np.random.default_rng(1).integers(0, 61, (2, 13)).astype(np.int32)
    logits = model(T.from_numpy(ids[:, :-1], requires_grad=False))
    return pkg.loss.cross_entropy(
        logits.reshape(24, 61).astype(np.float32 if T is JTensor
                                      else torch.float32),
        T.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False))


@pytest.mark.parametrize("net", ["llama", "convnet"])
def test_mixed_precision_steps_match_jax(net):
    """3 bf16 MixedPrecision Adam steps: the masters stay f32, the compute
    parameters are the masters rounded to bf16, and the masters agree with
    the JAX package's."""
    if net == "llama":
        jm, tm = llama_models("llama", seed=1)
        loss_fn = _llama_loss
    else:
        jm, tm = _conv_nets()
        loss_fn = _conv_loss
    jmp = light.amp.MixedPrecision(jm, lambda ps: light.optim.Adam(ps, lr=LR))
    tmp = lt.amp.MixedPrecision(tm, lambda ps: lt.optim.Adam(ps, lr=LR))
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    assert {m.dtype for m in tmp.masters} == {torch.float32}
    assert all(p.requires_grad for p in tm.parameters())
    before = [m.numpy().copy() for m in tmp.masters]
    losses = []
    for _ in range(3):
        with jax_kernel_mode("xla"):
            jl = loss_fn(light, JTensor, jm, jnp.bfloat16)
            jmp.zero_grad()
            jmp.scale(jl).backward()
            jmp.step()
        tl = loss_fn(lt, TTensor, tm, torch.bfloat16)
        tmp.zero_grad()
        tmp.scale(tl).backward()
        tmp.step()
        losses.append((float(tl.numpy()), float(jl.numpy())))
    np.testing.assert_allclose(*zip(*losses), rtol=2e-2)
    diffs = []
    for tmast, jmast, p in zip(tmp.masters, jmp.masters,
                               tmp.compute_params):
        d = np.abs(tmast.numpy() - jmast.numpy())
        assert d.max() <= 6 * LR
        diffs.append(d.ravel())
        np.testing.assert_array_equal(
            p.numpy(), tmast.data.to(torch.bfloat16).float().numpy())
    assert np.median(np.concatenate(diffs)) <= LR / 10
    # every master moved
    for b, m in zip(before, tmp.masters):
        assert not np.array_equal(b, m.numpy())


class _OneParam(lt.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = lt.Tensor.ones((4,))

    def forward(self, x):
        return (self.w * x).sum()


def test_mixed_precision_beats_plain_bf16():
    """An SGD delta of 1e-4 at w = 1 rounds away in plain bf16 (its spacing
    below 1 is 2^-9): the weights stall; the f32 masters integrate 100
    steps to 0.99, as the JAX package's do, and the bf16 weights move."""
    x = TTensor.from_numpy(np.ones(4, np.float32),
                           requires_grad=False).astype(torch.bfloat16)
    plain = lt.amp.cast_module(_OneParam(), torch.bfloat16)
    opt = lt.optim.SGD(list(plain.parameters()), lr=1e-4)
    for _ in range(100):
        loss = plain(x)
        opt.zero_grad()
        loss.backward()
        opt.step()
    np.testing.assert_array_equal(plain.w.numpy(), np.ones(4, np.float32))
    model = _OneParam()
    mp = lt.amp.MixedPrecision(model, lambda ps: lt.optim.SGD(ps, lr=1e-4))
    for _ in range(100):
        loss = model(x)
        mp.zero_grad()
        loss.backward()
        mp.step()
    jw = light.Tensor.ones((4,))
    jm = light.nn.Module()
    jm.w = jw
    jmp = light.amp.MixedPrecision(jm, lambda ps: light.optim.SGD(ps,
                                                                  lr=1e-4))
    jx = JTensor.from_numpy(np.ones(4, np.float32),
                            requires_grad=False).astype(jnp.bfloat16)
    with jax_kernel_mode("xla"):
        for _ in range(100):
            loss = (jm.w * jx).sum()
            jmp.zero_grad()
            loss.backward()
            jmp.step()
    np.testing.assert_allclose(mp.masters[0].numpy(), 0.99, rtol=1e-5)
    np.testing.assert_allclose(mp.masters[0].numpy(),
                               jmp.masters[0].numpy(), rtol=1e-6)
    assert (model.w.numpy() < 1.0).all()


def _torch_linear_loss(model):
    x, y = (torch.from_numpy(a.numpy()) for a in _conv_batch(TTensor))
    out = model(x.reshape(4, -1).to(torch.bfloat16))
    return ((out.float() - y) ** 2).mean()


@pytest.mark.parametrize("net", ["convnet", "torch.nn"])
def test_nonfinite_step_is_skipped_and_the_scaler_backs_off(net):
    """An inf in a gradient: no master moves and the scale halves; three
    clean steps later it has grown back, as the JAX package's scaler.  The
    same on a ``torch.nn`` module (an inf becomes 0 in both, as the JAX
    package's ``nan_to_num`` makes it)."""
    if net == "torch.nn":
        torch.manual_seed(3)
        tm = torch.nn.Linear(72, 3)
        loss_fn = _torch_linear_loss
    else:
        _, tm = _conv_nets(seed=3)
        loss_fn = lambda m: _conv_loss(lt, TTensor, m, torch.bfloat16)
    scaler = lt.amp.GradScaler(init_scale=8.0, growth_interval=3)
    mp = lt.amp.MixedPrecision(tm, lambda ps: lt.optim.Adam(ps, lr=1e-2),
                               scaler=scaler)
    before = [m.detach().numpy().copy() for m in mp.masters]
    loss = loss_fn(tm)
    mp.zero_grad()
    mp.scale(loss).backward()
    g = mp.compute_params[0].grad
    if net == "torch.nn":
        g.view(-1)[0] = float("inf")
    else:
        bad = g.data.clone()
        bad.view(-1)[0] = float("inf")
        g._set_data(bad)
    mp.step()
    for m, b in zip(mp.masters, before):
        np.testing.assert_array_equal(m.detach().numpy(), b)
    assert scaler.scale_value() == 4.0
    for _ in range(4):
        loss = loss_fn(tm)
        mp.zero_grad()
        mp.scale(loss).backward()
        mp.step()
    assert scaler.scale_value() == 8.0
    assert not np.array_equal(mp.masters[0].detach().numpy(), before[0])


def test_f32_inputs_into_bf16_layers():
    """bf16-cast Conv2d / Linear fed f32 inputs cast them on the tape: the
    output is bf16 (the JAX package's, to bf16 rounding) and the input's
    gradient comes back f32."""
    jn, tn = _conv_nets(seed=4)
    light.amp.cast_module(jn, jnp.bfloat16)
    lt.amp.cast_module(tn, torch.bfloat16)
    outs = []
    for T, net in ((JTensor, jn), (TTensor, tn)):
        x, _ = _conv_batch(T, seed=4)
        x._set_requires_grad(True)
        with jax_kernel_mode("xla"):
            y = net(x)
            y.sum().backward()
        assert str(y.dtype).endswith("bfloat16")
        assert str(x.grad.dtype).endswith("float32")
        outs.append((y.numpy().astype(np.float32),
                     x.grad.numpy().astype(np.float32)))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("net", ["llama", "convnet"])
def test_cast_module_round_trip(net):
    """f32 -> bf16 -> f32: every parameter is its bf16 rounding, as the JAX
    package's cast gives it; ``requires_grad`` and the parameter names are
    kept, and a model's decode functions are dropped."""
    jm, tm = (llama_models("gemma", seed=5) if net == "llama"
              else _conv_nets(seed=5))
    if net == "llama":
        tm.generate([1, 2], max_new_tokens=1)    # builds the decode functions
        assert hasattr(tm, "_kv_fns")
    names = [n for n, _ in tm.named_parameters()]
    assert lt.amp.cast_module(tm, torch.bfloat16) is tm
    assert not hasattr(tm, "_kv_fns")
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    lt.amp.cast_module(tm, torch.float32)
    light.amp.cast_module(jm, jnp.bfloat16)
    light.amp.cast_module(jm, jnp.float32)
    assert [n for n, _ in tm.named_parameters()] == names
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad
        np.testing.assert_array_equal(p.numpy(), jparams[n].numpy(),
                                      err_msg=n)
