"""Port parity: the fused softmax.  The port's ``softmax_fwd`` /
``softmax_bwd`` (CPU plain versions) against the JAX package's in pallas
(interpret) and xla modes, including the additive -1e9 mask of BERT's
attention scores."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.ops.softmax import softmax_bwd as jax_softmax_bwd
from lightgrad_tpu.ops.softmax import softmax_fwd as jax_softmax_fwd
from lightgrad_tpu_torch.ops.softmax import softmax_bwd, softmax_fwd
from tests.torch_port import jax_kernel_mode, rand, to_np

# f32 on both sides; row sums in another order
TOL = dict(rtol=1e-5, atol=1e-6)


def _scores(shape, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    x = rand(rng, *shape, scale=3.0)
    if masked:
        # BERT's padding mask: -1e9 on the last keys of each row block
        x[..., -3:] += -1e9
    return x, rand(rng, *shape)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("shape,masked", [((2, 3, 8, 8), True),
                                          ((5, 33), False), ((7,), False)])
def test_softmax_fwd_bwd_match_jax(shape, masked, mode):
    x, g = _scores(shape, masked=masked)
    with jax_kernel_mode(mode):
        jy = jax_softmax_fwd(jnp.asarray(x))
        jdx = jax_softmax_bwd(jnp.asarray(g), jy)
    y = softmax_fwd(torch.from_numpy(x))
    dx = softmax_bwd(torch.from_numpy(g), y)
    assert y.shape == x.shape and dx.shape == x.shape
    np.testing.assert_allclose(to_np(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(to_np(dx), np.asarray(jdx), **TOL)
    if masked:
        assert float(to_np(y)[..., -3:].max()) == 0.0


def test_softmax_bf16_keeps_dtype():
    x, g = _scores((4, 16))
    xb, gb = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    y = softmax_fwd(xb)
    assert y.dtype == torch.bfloat16 and softmax_bwd(gb, y).dtype == \
        torch.bfloat16
    np.testing.assert_allclose(to_np(y), to_np(torch.softmax(xb.float(), -1)),
                               atol=4e-3)


def test_softmax_bwd_rows_sum_to_zero_under_a_common_part():
    """Rows of g with a large common part (attention near uniform over
    tokens that drifted together): the gradient of each row must still sum
    to zero, as it does exactly -- the two-pass row sum keeps it there,
    where one pass leaves f32 epsilon times the common part."""
    rng = np.random.default_rng(0)
    y = torch.softmax(torch.from_numpy(rand(rng, 64, 128, scale=0.1)), -1)
    g = 300.0 + torch.from_numpy(rand(rng, 64, 128, scale=0.01))
    dx = softmax_bwd(g, y)
    want = y.double() * (g.double() - (g.double() * y.double()).sum(
        -1, keepdim=True))
    scale = want.abs().max().item()
    assert dx.double().sum(-1).abs().max().item() <= 1e-5 * scale
    # elementwise, the first pass's g - sum(g*y) rounds at the common part:
    # a few f32 ulps of 300, times y
    ulp = 300.0 * torch.finfo(torch.float32).eps * y.max().item()
    assert (dx.double() - want).abs().max().item() <= 4 * ulp
