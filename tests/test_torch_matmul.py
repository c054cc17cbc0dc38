"""Port parity: the matmul kernel family.  The port's ``matmul`` and
``matmul_vjp`` (CPU plain versions) against ``lightgrad_tpu.ops.matmul.
matmul`` and its VJP in pallas (interpret) and xla modes: ragged M/N/K,
broadcast batch dims, a shared 2-D right operand, transposed operands; and
the batch-stride merging the CUDA kernel is launched with
(``_merge_batch``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgrad_tpu.ops.matmul import matmul as jax_matmul
from lightgrad_tpu_torch.ops.matmul import (_merge_batch, matmul,
                                            matmul_reference, matmul_vjp)
from tests.torch_port import jax_kernel_mode, rand, to_np

# f32 on both sides (true f32 products); sums of up to 45 terms in another
# order
TOL = dict(rtol=2e-5, atol=2e-5)

SHAPES = [
    ((37, 19), (19, 45)),            # ragged M, K, N: no tile multiple
    ((1, 5), (5, 3)),
    ((2, 1, 5, 7), (3, 7, 4)),       # broadcast batch dims
    ((3, 5, 7), (7, 4)),             # shared 2-D right operand (Linear)
    ((5, 7), (2, 7, 4)),             # shared 2-D left operand
    ((2, 3, 16, 8), (2, 3, 8, 16)),  # attention scores (b, h, s, d)
]


def _operands(sa, sb, seed=0):
    rng = np.random.default_rng(seed)
    return rand(rng, *sa), rand(rng, *sb)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("sa,sb", SHAPES)
def test_matmul_and_vjp_match_jax(sa, sb, mode):
    a, b = _operands(sa, sb)
    with jax_kernel_mode(mode):
        want, vjp = jax.vjp(jax_matmul, jnp.asarray(a), jnp.asarray(b))
        g = np.asarray(rand(np.random.default_rng(1), *want.shape))
        jga, jgb = vjp(jnp.asarray(g))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = matmul(ta, tb)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    ga, gb = matmul_vjp(torch.from_numpy(g), ta, tb)
    assert ga.shape == ta.shape and gb.shape == tb.shape
    np.testing.assert_allclose(to_np(ga), np.asarray(jga), **TOL)
    np.testing.assert_allclose(to_np(gb), np.asarray(jgb), **TOL)


def test_transposed_operands():
    """W.T of nn.Linear and k^T of the attention scores are strided views;
    the product and its gradient equal those of contiguous copies."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rand(rng, 2, 6, 8))
    w = torch.from_numpy(rand(rng, 5, 8))
    k = torch.from_numpy(rand(rng, 2, 3, 6, 4))
    q = torch.from_numpy(rand(rng, 2, 3, 6, 4))
    with jax_kernel_mode("pallas"):
        jy = jax_matmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy().T))
        js = jax_matmul(jnp.asarray(q.numpy()),
                        jnp.asarray(k.numpy().transpose(0, 1, 3, 2)))
    np.testing.assert_allclose(to_np(matmul(x, w.T)), np.asarray(jy), **TOL)
    np.testing.assert_allclose(to_np(matmul(q, k.transpose(-1, -2))),
                               np.asarray(js), **TOL)
    g = torch.from_numpy(rand(rng, 2, 6, 5))
    ga, gb = matmul_vjp(g, x, w.T)
    torch.testing.assert_close(gb, (x.reshape(-1, 8).T @ g.reshape(-1, 5)),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(ga, g @ w, rtol=2e-5, atol=2e-5)


def test_bf16_sums_in_f32():
    """bf16 operands: the product sums in f32 and rounds once to bf16."""
    a, b = _operands((16, 64), (64, 8))
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    y = matmul_reference(ta, tb)
    assert y.dtype == torch.bfloat16
    want = (ta.float() @ tb.float()).bfloat16()
    assert torch.equal(y, want)


def test_rejects_1d():
    with pytest.raises(ValueError):
        matmul(torch.zeros(3), torch.zeros(3, 2))


@pytest.mark.parametrize("sizes,sa,sb,want", [
    # q (8, 12, 128, 64) from x.reshape(b, s, h, d).transpose(0, 2, 1, 3)
    # against k^T of the same layout: the heads cannot merge with the batch
    ((8, 12), (98304, 64), (98304, 64), [(8, 98304, 98304), (12, 64, 64)]),
    # contiguous probs (8, 12, 128, 128) against that v: still two dims
    ((8, 12), (196608, 16384), (98304, 64),
     [(8, 196608, 98304), (12, 16384, 64)]),
    # both contiguous: one batch dim
    ((2, 3), (60, 20), (24, 8), [(6, 20, 8)]),
    # a broadcast right operand (stride 0) merges too
    ((2, 3), (60, 20), (0, 0), [(6, 20, 0)]),
    ((1, 4), (0, 20), (0, 8), [(4, 20, 8)]),
])
def test_merge_batch(sizes, sa, sb, want):
    assert _merge_batch(sizes, sa, sb) == want
