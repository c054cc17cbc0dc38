"""Port parity: losses.  The port's ``cross_entropy`` and ``mse`` (value and
gradient) against the JAX package's on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu import loss as jax_loss
from lightgrad_tpu.autograd import Tensor
from lightgrad_tpu_torch import loss
from tests.torch_port import rand, to_np

# f32 on both sides, reductions in another order
TOL = dict(atol=1e-6, rtol=1e-5)


def _jax_value_and_grad(fn, y, *rest, **kw):
    jy = Tensor.from_numpy(y.copy())
    out = fn(jy, *(Tensor.from_numpy(a, requires_grad=False) for a in rest),
             **kw)
    out.backward()
    return out.numpy(), jy.grad.numpy()


def _port_value_and_grad(fn, y, *rest, **kw):
    ty = torch.tensor(y, requires_grad=True)
    out = fn(ty, *(torch.from_numpy(a) for a in rest), **kw)
    out.backward()
    return to_np(out), to_np(ty.grad)


@pytest.mark.parametrize("ignore_index", [None, -100])
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(ignore_index, label_smoothing):
    rng = np.random.default_rng(3)
    y = rand(rng, 12, 37, scale=3.0)
    labels = rng.integers(0, 37, 12).astype(np.int32)
    if ignore_index is not None:
        labels[[1, 5, 6]] = ignore_index
    kw = dict(ignore_index=ignore_index, label_smoothing=label_smoothing)
    want = _jax_value_and_grad(jax_loss.cross_entropy, y, labels, **kw)
    got = _port_value_and_grad(loss.cross_entropy, y, labels, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    if ignore_index is not None:                 # ignored rows: no gradient
        assert not got[1][[1, 5, 6]].any()


def test_cross_entropy_bf16_logits_match_jax():
    """bf16 logits: both packages subtract the row max in bf16, then reduce
    in f32; the loss is f32 and the gradient comes back in bf16 (rounded
    once, 2^-8 relative)."""
    rng = np.random.default_rng(4)
    y = rand(rng, 8, 50, scale=4.0)
    labels = rng.integers(0, 50, 8).astype(np.int32)
    jy = Tensor.from_numpy(y).astype(jnp.bfloat16).detach()
    jy._set_requires_grad(True)
    jout = jax_loss.cross_entropy(
        jy, Tensor.from_numpy(labels, requires_grad=False))
    jout.backward()
    ty = torch.from_numpy(y).bfloat16().requires_grad_(True)
    out = loss.cross_entropy(ty, torch.from_numpy(labels))
    out.backward()
    assert out.dtype == torch.float32 and ty.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out), jout.numpy(), **TOL)
    np.testing.assert_allclose(to_np(ty.grad),
                               jy.grad.numpy().astype(np.float32),
                               atol=1e-4, rtol=8e-3)


def test_mse_matches_jax():
    rng = np.random.default_rng(5)
    y, y_hat = rand(rng, 6, 7), rand(rng, 6, 7)
    want = _jax_value_and_grad(jax_loss.mse, y, y_hat)
    got = _port_value_and_grad(loss.mse, y, y_hat)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
