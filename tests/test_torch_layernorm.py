"""Port parity: the fused LayerNorm.  The port's ``layernorm_fwd`` /
``layernorm_bwd_dx`` (CPU plain versions) against the JAX package's in
pallas (interpret) and xla modes, and the port's autograd Function (dx, dw,
db) against the JAX tape's ``layernorm`` op."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.autograd import Tensor
from lightgrad_tpu.ops.layernorm import layernorm_bwd_dx as jax_ln_bwd_dx
from lightgrad_tpu.ops.layernorm import layernorm_fwd as jax_ln_fwd
from lightgrad_tpu_torch.autograd import layernorm
from lightgrad_tpu_torch.models._torch_layers import LayerNorm
from lightgrad_tpu_torch.ops.layernorm import (layernorm_bwd_dx,
                                               layernorm_fwd)
from tests.torch_port import jax_kernel_mode, rand, to_np

# f32 on both sides, row statistics summed in another order
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(shape, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rand(rng, *shape, c, scale=2.0) + 0.5
    return x, rand(rng, c), rand(rng, c), rand(rng, *shape, c)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("shape,c", [((4, 24), 96), ((37,), 100)])
def test_layernorm_fwd_bwd_match_jax(shape, c, mode):
    x, w, b, g = _inputs(shape, c)
    with jax_kernel_mode(mode):
        jy, jxhat, jrstd = jax_ln_fwd(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), 1e-5)
        jdx = jax_ln_bwd_dx(jnp.asarray(g).reshape(-1, c), jnp.asarray(w),
                            jxhat, jrstd)
    tx, tw, tb, tg = (torch.from_numpy(a) for a in (x, w, b, g))
    y, xhat, rstd = layernorm_fwd(tx, tw, tb, 1e-5)
    assert y.shape == tx.shape and xhat.dtype == rstd.dtype == torch.float32
    for got, want in ((y, jy), (xhat, jxhat), (rstd, jrstd)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    dx = layernorm_bwd_dx(tg.reshape(-1, c), tw, xhat, rstd)
    np.testing.assert_allclose(to_np(dx), np.asarray(jdx), **TOL)


def test_layernorm_grads_match_jax_tape():
    """dx, dw and db of the port's Function vs the JAX tape's ``layernorm``
    op, through a weighted sum of the output."""
    x, w, b, g = _inputs((3, 10), 64, seed=4)
    jx, jw, jb = (Tensor.from_numpy(a.copy()) for a in (x, w, b))
    jy = jx.layernorm(jw, jb, eps=1e-5)
    (jy * Tensor.from_numpy(g, requires_grad=False)).sum().backward()
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    ty = layernorm(tx, tw, tb, 1e-5)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(to_np(ty), jy.numpy(), **TOL)
    for t, j in ((tx, jx), (tw, jw), (tb, jb)):
        np.testing.assert_allclose(to_np(t.grad), j.grad.numpy(), **TOL)


def test_layernorm_module():
    """nn.LayerNorm: ones/zeros parameters, the fused op, shape check."""
    ln = LayerNorm(64, eps=1e-5)
    assert [n for n, _ in ln.named_parameters()] == ["weight", "bias"]
    x = torch.from_numpy(_inputs((5,), 64)[0])
    torch.testing.assert_close(ln(x), torch.nn.functional.layer_norm(
        x, (64,), eps=1e-5), **TOL)
    with pytest.raises(ValueError):
        ln(torch.zeros(5, 32))
