"""Port parity: DDPM diffusion on the lightgrad tape.  A small UNet (base 8,
time_dim 16, 8 x 8 single-channel images) built by the JAX package and
carried across with ``load_numpy_params``; a ``Diffusion`` of T 10.
Checked against the JAX model in its xla mode (its Pallas conv in
interpret mode is held against the port's conv plain versions by
tests/test_torch_conv.py, and takes a minute at the UNet's 20 shapes):
``sinusoidal_embedding``, the UNet's forward and the gradients of every
parameter and of the input, ``Diffusion.loss`` and its gradients, one
``p_sample`` and one ``p_sample_ddim`` step with the same ``t`` and the
same noise passed in, and the whole deterministic DDIM sampler (eta 0,
whose only noise is the numpy start both packages draw).  Then the EMA of
two SGD steps against the JAX package's, sampling under ``average_parameters`` (shape,
finite, live weights back afterwards), and ``jit=`` wrapping each step."""

import numpy as np

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models import diffusion as jdif
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.models import diffusion as tdif
from tests.torch_port import cpu_device, jax_kernel_mode, rand  # noqa: F401

UNET = dict(in_channels=1, base=8, time_dim=16)
T, B, HW = 10, 2, 8
# f32 through ~20 convs and 9 GroupNorms: products and sums in another order
TOL = dict(rtol=1e-4, atol=1e-5)


def _params(model):
    return {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}


def _models():
    np.random.seed(0)
    ju = jdif.UNet(**UNET)
    tu = tdif.UNet(**UNET)
    lt.load_numpy_params(tu, _params(ju))
    return (jdif.Diffusion(ju, timesteps=T), tdif.Diffusion(tu, timesteps=T))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rand(rng, B, 1, HW, HW)
    noise = rand(rng, B, 1, HW, HW)
    t = np.array([0, 7], np.int32)
    return x, noise, t


def _grads(model):
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def _close(got, want, what=""):
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, **TOL, err_msg=what)


def test_sinusoidal_embedding_matches_jax():
    t = np.array([0.0, 3.0, 199.0], np.float32)
    want = jdif.sinusoidal_embedding(JTensor.from_numpy(t), 16).numpy()
    got = tdif.sinusoidal_embedding(TTensor.from_numpy(t), 16).numpy()
    _close(got, np.asarray(want))


def test_unet_forward_and_gradients_match_jax():
    jd, td = _models()
    x, _, t = _inputs()
    w = rand(np.random.default_rng(9), B, 1, HW, HW)

    def run(T_, model):
        xt = T_.from_numpy(x)
        y = model(xt, T_.from_numpy(t.astype(np.float32),
                                    requires_grad=False))
        model.zero_grad()
        (y * T_.from_numpy(w, requires_grad=False)).sum().backward()
        return y.numpy(), xt.grad.numpy(), _grads(model)

    with jax_kernel_mode("xla"):
        jy, jgx, jg = run(JTensor, jd.model)
    ty, tgx, tg = run(TTensor, td.model)
    _close(ty, np.asarray(jy), "forward")
    _close(tgx, np.asarray(jgx), "input gradient")
    assert sorted(tg) == sorted(jg)
    for n in jg:
        _close(tg[n], np.asarray(jg[n]), n)


def test_loss_and_gradients_match_jax():
    jd, td = _models()
    x, noise, t = _inputs(1)

    def run(T_, pkg, d):
        loss = d.loss(T_.from_numpy(x, requires_grad=False),
                      T_.from_numpy(t, requires_grad=False),
                      T_.from_numpy(noise, requires_grad=False))
        d.model.zero_grad()
        loss.backward()
        return loss.numpy(), _grads(d.model)

    with jax_kernel_mode("xla"):
        jl, jg = run(JTensor, light, jd)
    tl, tg = run(TTensor, lt, td)
    _close(np.asarray(tl), np.asarray(jl), "loss")
    for n in jg:
        _close(tg[n], np.asarray(jg[n]), n)


def test_q_sample_p_sample_and_ddim_step_match_jax():
    jd, td = _models()
    x, noise, t = _inputs(2)
    tp = np.array([-1, 3], np.int32)
    outs = {}
    for name, T_, d in (("jax", JTensor, jd), ("port", TTensor, td)):
        a = lambda v: T_.from_numpy(v, requires_grad=False)
        with jax_kernel_mode("xla"), (light if name == "jax"
                                      else lt).no_grad():
            outs[name] = [
                d.q_sample(a(x), a(t), a(noise)).numpy(),
                d.p_sample(a(x), a(t), a(noise)).numpy(),
                d.p_sample_ddim(a(x), a(t), a(tp), 0.0, a(noise)).numpy(),
                d.p_sample_ddim(a(x), a(t), a(tp), 1.0, a(noise)).numpy()]
    for what, got, want in zip(("q_sample", "p_sample", "ddim eta 0",
                                "ddim eta 1"), outs["port"], outs["jax"]):
        _close(got, np.asarray(want), what)


def test_deterministic_ddim_sampler_matches_jax():
    jd, td = _models()
    with jax_kernel_mode("xla"):
        want = jd.sample_ddim(2, steps=4, shape=(1, HW, HW), seed=3).numpy()
    got = td.sample_ddim(2, steps=4, shape=(1, HW, HW), seed=3).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    again = td.sample_ddim(2, steps=4, shape=(1, HW, HW), seed=3).numpy()
    assert np.array_equal(got, again)


def test_ema_training_and_sampling():
    """Two SGD steps with an EMA at 0.9 on both packages (same t and noise;
    SGD keeps the update linear in the gradient, so the shadows differ by
    the gradients' rounding alone): the shadow weights agree; sampling under
    ``average_parameters`` gives finite images of the asked shape from the
    EMA weights and puts the live weights back."""
    jd, td = _models()
    x, noise, t = _inputs(4)

    def train(T_, pkg, d):
        opt = pkg.optim.SGD(list(d.model.parameters()), lr=0.05)
        ema = pkg.optim.EMA(list(d.model.parameters()), decay=0.9)
        a = lambda v: T_.from_numpy(v, requires_grad=False)
        for _ in range(2):
            loss = d.loss(a(x), a(t), a(noise))
            opt.zero_grad()
            loss.backward()
            opt.step()
            ema.update()
        return ema

    with jax_kernel_mode("xla"):
        jema = train(JTensor, light, jd)
    tema = train(TTensor, lt, td)
    for j, s in zip(jema.shadow, tema.shadow):
        np.testing.assert_allclose(s.numpy(), np.asarray(j.numpy()), **TOL)
    live = _params(td.model)
    with tema.average_parameters():
        for p, s in zip(td.model.parameters(), tema.shadow):
            assert np.array_equal(p.numpy(), s.numpy())
        imgs = td.sample(3, shape=(1, HW, HW), seed=1).numpy()
    assert imgs.shape == (3, 1, HW, HW) and np.isfinite(imgs).all()
    for n, p in td.model.named_parameters():
        assert np.array_equal(p.numpy(), live[n]), n


def test_samplers_take_a_jit_wrapper():
    _, td = _models()
    calls = {"n": 0}

    def jit(fn):
        def wrapped(*args):
            calls["n"] += 1
            return fn(*args)
        return wrapped

    td.sample(1, shape=(1, HW, HW), jit=jit)
    assert calls["n"] == T
    calls["n"] = 0
    td.sample_ddim(1, steps=4, eta=1.0, shape=(1, HW, HW), jit=jit)
    assert calls["n"] == 4
