"""Port parity: the vision layers of ``nn`` and the tape's pooling and
transposed-convolution composites.  Each layer is built by the JAX package
and carried across with ``load_numpy_params(layer, jax_layer.state_dict())``
(parameters and buffers); the same numpy input goes through both, and the
forward, the input's gradient and every parameter's gradient of a weighted
sum are compared, with the JAX kernels in pallas (interpret) and xla modes.
``BatchNorm2d`` is checked in training (two steps: outputs, gradients and
the running statistics after them, which stay buffers) and in eval mode;
its training gradient is the true one (torch's ``batch_norm``), where the
JAX package's treats the batch statistics as constants, so the JAX layer
runs with that corrected (``jax_batchnorm_true_gradient``)."""

import numpy as np
import pytest
import torch

import lightgrad_tpu.nn as jnn
import lightgrad_tpu_torch as lt
import lightgrad_tpu_torch.nn as tnn
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from tests.torch_port import (cpu_device, jax_batchnorm_true_gradient,  # noqa: F401
                               jax_kernel_mode, rand)

# f32 on both sides, the same formulas; products and sums in another order
TOL = dict(rtol=2e-5, atol=2e-5)
MODES = ["pallas", "xla"]


def _pair(name, *args, **kwargs):
    """The JAX layer (seeded) and the port's, with the JAX layer's
    parameters and buffers."""
    np.random.seed(0)
    jl = getattr(jnn, name)(*args, **kwargs)
    tl = getattr(tnn, name)(*args, **kwargs)
    lt.load_numpy_params(tl, jl.state_dict())
    return jl, tl


def _step(T, layer, x, seed):
    """Forward, then the gradients of sum(y * w) for a seeded w: (y, dx)."""
    tx = T.from_numpy(x.copy())
    y = layer(tx)
    w = rand(np.random.default_rng(seed), *y.shape)
    (y * T.from_numpy(w, requires_grad=False)).sum().backward()
    return y.numpy(), tx.grad.numpy()


def _grads(layer, names):
    params = dict(layer.named_parameters())
    return {n: params[n].grad.numpy() for n in names}


def _compare(jl, tl, x, mode, steps=1):
    """``steps`` forward/backward passes of both layers on the same inputs,
    compared (the port's parameter names: the JAX package also lists
    BatchNorm's running statistics once a training step updated them)."""
    names = [n for n, _ in tl.named_parameters()]
    for step in range(steps):
        xs = x if step == 0 else rand(np.random.default_rng(10 + step),
                                      *x.shape)
        for p in list(jl.parameters()) + list(tl.parameters()):
            p.zero_grad()
        with jax_kernel_mode(mode):
            jy, jdx = _step(JTensor, jl, xs, 20 + step)
        ty, tdx = _step(TTensor, tl, xs, 20 + step)
        assert ty.shape == jy.shape
        np.testing.assert_allclose(ty, jy, **TOL)
        np.testing.assert_allclose(tdx, jdx, **TOL)
        jg, tg = _grads(jl, names), _grads(tl, names)
        for n in names:
            np.testing.assert_allclose(tg[n], jg[n], **TOL, err_msg=n)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kwargs", [
    dict(kernelsize=3),                           # default pad k // 2
    dict(kernelsize=3, pad="valid", stride=2),
    dict(kernelsize=4, pad="same"),               # even kernel: (1, 2)
    dict(kernelsize=3, pad=(0, 1), bias=False),
    dict(kernelsize=3, pad=2, dilation=2, groups=2),
    dict(kernelsize=7, stride=2, pad=3, bias=False),   # ResNet's stem
], ids=str)
def test_conv2d(kwargs, mode):
    jl, tl = _pair("Conv2d", 4, 6, **kwargs)
    _compare(jl, tl, rand(np.random.default_rng(1), 2, 4, 11, 10), mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kwargs", [
    dict(kernelsize=3),
    dict(kernelsize=4, stride=2, pad=1),
    dict(kernelsize=3, stride=2, pad=1, output_padding=1, groups=2),
    dict(kernelsize=3, dilation=2, bias=False),
], ids=str)
def test_conv_transpose2d(kwargs, mode):
    jl, tl = _pair("ConvTranspose2d", 4, 6, **kwargs)
    _compare(jl, tl, rand(np.random.default_rng(2), 2, 4, 5, 6), mode)


@pytest.mark.parametrize("mode", MODES)
def test_batchnorm2d_train_then_eval(mode, jax_batchnorm_true_gradient):
    jl, tl = _pair("BatchNorm2d", 5)
    x = rand(np.random.default_rng(3), 4, 5, 6, 7) * 2.0 + 0.5
    _compare(jl, tl, x, mode, steps=2)
    # the running statistics moved, are equal, and are still buffers
    jsd, tsd = jl.state_dict(), tl.state_dict()
    for n in ("running_mean", "running_var"):
        np.testing.assert_allclose(tsd[n], jsd[n], **TOL)
        assert tl._buffers[n] is getattr(tl, n)
    assert not np.allclose(tsd["running_var"], 1.0)
    assert [n for n, _ in tl.named_parameters()] == ["weight", "bias"]
    jl.eval()
    tl.eval()
    _compare(jl, tl, x, mode)


def _bn_input_grad(x, w_out, stats_constant):
    """torch's training-mode batch norm (no affine) and its input gradient
    for sum(y * w_out), optionally with the batch statistics detached."""
    xt = torch.tensor(x, requires_grad=True)
    if stats_constant:
        m = xt.mean((0, 2, 3), keepdim=True).detach()
        v = ((xt - m) ** 2).mean((0, 2, 3), keepdim=True).detach()
        y = (xt - m) / (v + 1e-5).sqrt()
    else:
        y = torch.nn.functional.batch_norm(xt, None, None, training=True,
                                           eps=1e-5)
    (y * torch.tensor(w_out)).sum().backward()
    return xt.grad.numpy()


def test_batchnorm2d_gradient_is_torchs():
    """The port's training gradient is torch's batch_norm's; the JAX
    package's (unpatched) keeps the batch statistics out of it."""
    rng = np.random.default_rng(7)
    x, w_out = rand(rng, 4, 3, 5, 5), rand(rng, 4, 3, 5, 5)
    got = {}
    for T, nn in ((TTensor, tnn), (JTensor, jnn)):
        tx = T.from_numpy(x.copy())
        (nn.BatchNorm2d(3, affine=False)(tx)
         * T.from_numpy(w_out, requires_grad=False)).sum().backward()
        got[T] = tx.grad.numpy()
    np.testing.assert_allclose(got[TTensor], _bn_input_grad(x, w_out, False),
                               **TOL)
    np.testing.assert_allclose(got[JTensor], _bn_input_grad(x, w_out, True),
                               **TOL)
    assert np.abs(got[JTensor] - got[TTensor]).max() > 0.1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("affine", [True, False])
def test_groupnorm(affine, mode):
    jl, tl = _pair("GroupNorm", 3, 6, affine=affine)
    x = rand(np.random.default_rng(4), 2, 6, 5, 4) * 3.0 - 1.0
    _compare(jl, tl, x, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,args,kwargs", [
    ("MaxPool2d", (3,), dict(stride=2, padding=1)),   # ResNet's stem pool
    ("MaxPool2d", (2,), {}),
    ("MaxPool2d", ((2, 3),), dict(stride=(1, 2))),
    ("AvgPool2d", (2,), {}),
], ids=str)
def test_pool_layers(name, args, kwargs, mode):
    jl, tl = _pair(name, *args, **kwargs)
    _compare(jl, tl, rand(np.random.default_rng(5), 2, 3, 9, 8), mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spatial,strides,pad,output_padding", [
    ((7,), 2, 1, 1),             # 1-D
    ((5, 6), 1, 0, 0),
    ((5, 6), 3, 2, 1),
])
def test_conv_transpose_composite(spatial, strides, pad, output_padding,
                                  mode):
    rng = np.random.default_rng(6)
    x = rand(rng, 2, 4, *spatial)
    w = rand(rng, 4, 3, *(3,) * len(spatial), scale=0.3)
    w_out = None
    outs = {}
    for T, ctx in ((JTensor, jax_kernel_mode(mode)), (TTensor, None)):
        tx, tw = T.from_numpy(x.copy()), T.from_numpy(w.copy())
        if ctx:
            with ctx:
                y = tx.conv_transpose(tw, strides=strides, pad=pad,
                                      output_padding=output_padding)
        else:
            y = tx.conv_transpose(tw, strides=strides, pad=pad,
                                  output_padding=output_padding)
        if w_out is None:
            w_out = rand(rng, *y.shape)
        (y * T.from_numpy(w_out, requires_grad=False)).sum().backward()
        outs[T] = (y.numpy(), tx.grad.numpy(), tw.grad.numpy())
    for j, t in zip(outs[JTensor], outs[TTensor]):
        np.testing.assert_allclose(t, j, **TOL)


def test_max_pool2d_gradient_goes_to_the_window_maximum():
    """Overlapping 3x3/s2/p1 windows: the padded -1e30 cells never win, and
    every window's gradient lands on its maximum."""
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    t = TTensor.from_numpy(x)
    y = t.max_pool2d(kernel=(3, 3), stride=(2, 2), padding=1)
    np.testing.assert_array_equal(y.numpy()[0, 0], [[5, 7], [13, 15]])
    y.sum().backward()
    want = np.zeros((4, 4), np.float32)
    want[1, 1] = want[1, 3] = want[3, 1] = want[3, 3] = 1
    np.testing.assert_array_equal(t.grad.numpy()[0, 0], want)
