"""Port parity: the fused LayerNorm.  The port's ``layernorm_fwd`` /
``layernorm_bwd_dx`` (CPU plain versions) against the JAX package's in
pallas (interpret) and xla modes; the autograd path's pair
``layernorm_fwd_stats`` / ``layernorm_bwd`` (dx, dw, db from x and the row
statistics) against JAX's forward, ``layernorm_bwd_dx`` and ``reduce`` sums
of g * xhat and g; and the port's autograd Function and the tape's
``layernorm`` op (dx, dw, db) against the JAX tape's ``layernorm`` op."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.autograd import Tensor
from lightgrad_tpu.ops.layernorm import layernorm_bwd_dx as jax_ln_bwd_dx
from lightgrad_tpu.ops.layernorm import layernorm_fwd as jax_ln_fwd
from lightgrad_tpu.ops.reduce import reduce as jax_reduce
from lightgrad_tpu_torch.autograd import layernorm
from lightgrad_tpu_torch.models._torch_layers import LayerNorm
from lightgrad_tpu_torch.autograd import Tensor as PortTensor
from lightgrad_tpu_torch.ops.layernorm import (layernorm_bwd,
                                               layernorm_bwd_dx,
                                               layernorm_bwd_reference,
                                               layernorm_fwd,
                                               layernorm_fwd_stats)
from tests.torch_port import cpu_device, jax_kernel_mode, rand, to_np  # noqa

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


# bfloat16: bf16 inputs on both sides, the JAX package evaluated in f32 (the
# port's kernels keep statistics, partials and sums in f32); one rounding of
# each port output to bf16 (2^-8 relative), over max(1, max |reference|)
BF16_TOL = 1e-2


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,c", [((4, 24), 96), ((37,), 100)])
def test_layernorm_bwd_reference_matches_jax(shape, c, dtype, mode):
    """(dx, dw, db) of ``layernorm_bwd`` from x and the forward's (mean,
    rstd) against JAX's ``layernorm_bwd_dx`` and its ``reduce`` sums of
    g * xhat and g over the rows; y and the recomputed xhat against JAX's
    forward."""
    x, w, b, g = _inputs(shape, c, seed=7)
    if dtype == "bfloat16":     # inputs exact in bf16 on both sides
        x, w, b, g = (to_np(_bf16(a)) for a in (x, w, b, g))
    with jax_kernel_mode(mode):
        jy, jxhat, jrstd = jax_ln_fwd(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), 1e-5)
        g2 = jnp.asarray(g).reshape(-1, c)
        jdx = jax_ln_bwd_dx(g2, jnp.asarray(w), jxhat, jrstd)
        jdw = jax_reduce(g2 * jxhat, "sum", axis=0)
        jdb = jax_reduce(g2, "sum", axis=0)
    cast = _bf16 if dtype == "bfloat16" else torch.from_numpy
    tx, tw, tb, tg = (cast(a) for a in (x, w, b, g))
    y, mean, rstd = layernorm_fwd_stats(tx, tw, tb, 1e-5)
    assert mean.dtype == rstd.dtype == torch.float32
    assert mean.shape == rstd.shape == (tx.numel() // c, 1)
    xhat = (tx.reshape(-1, c).float() - mean) * rstd
    dx, dw, db = layernorm_bwd(tg, tx, tw, mean, rstd)
    assert dx.dtype == dw.dtype == db.dtype == getattr(torch, dtype)
    assert dx.shape == (tx.numel() // c, c) and dw.shape == db.shape == (c,)
    for got, want in ((y, jy), (xhat, jxhat), (dx, jdx), (dw, jdw),
                      (db, jdb)):
        want = np.asarray(want, np.float32).reshape(tuple(got.shape))
        if dtype == "float32":
            np.testing.assert_allclose(to_np(got), want, **TOL)
        else:
            err = np.abs(to_np(got) - want).max()
            assert err <= BF16_TOL * max(1.0, np.abs(want).max()), err


def test_layernorm_bwd_reference_is_the_dx_formula_and_row_sums():
    """``layernorm_bwd_reference`` is ``layernorm_bwd_dx`` on the
    recomputed xhat plus the two row sums, bit for bit."""
    x, w, b, g = (torch.from_numpy(a) for a in _inputs((6,), 40, seed=3))
    y, mean, rstd = layernorm_fwd_stats(x, w, b, 1e-5)
    _, xhat, rstd2 = layernorm_fwd(x, w, b, 1e-5)
    assert torch.equal(rstd, rstd2)
    assert torch.equal((x - mean) * rstd, xhat)
    dx, dw, db = layernorm_bwd_reference(g, x, w, mean, rstd)
    assert torch.equal(dx, layernorm_bwd_dx(g, w, xhat, rstd))
    assert torch.equal(dw, (g * xhat).sum(0))
    assert torch.equal(db, g.sum(0))


def test_layernorm_tape_grads_match_jax_tape():
    """dx, dw and db of the port's tape ``layernorm`` op vs the JAX tape's,
    through a weighted sum of the output."""
    x, w, b, g = _inputs((3, 10), 64, seed=5)
    jx, jw, jb = (Tensor.from_numpy(a.copy()) for a in (x, w, b))
    jy = jx.layernorm(jw, jb, eps=1e-5)
    (jy * Tensor.from_numpy(g, requires_grad=False)).sum().backward()
    px, pw, pb = (PortTensor.from_numpy(a.copy()) for a in (x, w, b))
    py = px.layernorm(pw, pb, eps=1e-5)
    (py * PortTensor.from_numpy(g, requires_grad=False)).sum().backward()
    np.testing.assert_allclose(py.numpy(), jy.numpy(), **TOL)
    for t, j in ((px, jx), (pw, jw), (pb, jb)):
        np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy(), **TOL)
