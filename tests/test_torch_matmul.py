"""Port parity: the matmul kernel family.  The port's ``matmul`` and
``matmul_vjp`` (CPU plain versions) against ``lightgrad_tpu.ops.matmul.
matmul`` and its VJP in pallas (interpret) and xla modes: ragged M/N/K,
broadcast batch dims, a shared 2-D right operand, transposed operands; and
the batch-stride merging the CUDA kernel is launched with
(``_merge_batch``).  The f32 kernel's arithmetic, three tf32 passes
(``matmul_tf32x3_reference``), against the JAX package at
Precision.HIGHEST, where one tf32 pass fails the same tolerance; the
'default' precision's (operands rounded to bf16) against JAX's xla mode
under ``set_matmul_precision('default')``; the loader choice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgrad_tpu import amp as jax_amp
from lightgrad_tpu.ops.matmul import matmul as jax_matmul
import importlib

from lightgrad_tpu_torch import amp
from lightgrad_tpu_torch.ops.matmul import (LOADERS, _loader, _merge_batch,
                                            matmul, matmul_default_reference,
                                            matmul_reference,
                                            matmul_tf32x3_reference,
                                            matmul_vjp, tf32_round)
from tests.torch_port import jax_kernel_mode, rand, to_np

mm_mod = importlib.import_module("lightgrad_tpu_torch.ops.matmul")

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


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("sa,sb", SHAPES)
def test_tf32x3_reference_matches_jax_highest(sa, sb, mode):
    """The f32 kernel's arithmetic -- hi = tf32(x), lo = tf32(x - hi), hi hi
    + hi lo + lo hi -- against the JAX package's f32 product at
    Precision.HIGHEST (its default), at the f32 tolerance."""
    a, b = _operands(sa, sb, seed=3)
    with jax_kernel_mode(mode):
        want = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = matmul_tf32x3_reference(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(to_np(got), want, **TOL)


def test_one_tf32_pass_fails_the_tolerance():
    """One tf32 product (what TF32 alone keeps) misses the f32 tolerance on
    these shapes, so the three-pass test above tells the two apart."""
    worst = 0.0
    for sa, sb in SHAPES:
        a, b = _operands(sa, sb, seed=3)
        with jax_kernel_mode("xla"):
            want = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b)))
        one = torch.matmul(tf32_round(torch.from_numpy(a)).double(),
                           tf32_round(torch.from_numpy(b)).double()).float()
        excess = np.abs(to_np(one) - want) - (TOL["atol"]
                                              + TOL["rtol"] * np.abs(want))
        worst = max(worst, float(excess.max()))
    assert worst > 0.0


def test_tf32_round_is_nearest_even():
    """tf32_round keeps 10 mantissa bits, ties to even; inf and NaN pass."""
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 + 2 ** -20, 3.0, float("inf")])
    want = [1.0, 1.0, 1 + 2 ** -9, -1.0, 1 + 2 ** -10, 3.0, float("inf")]
    assert tf32_round(x).tolist() == want
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("sa,sb", SHAPES[:4])
def test_default_precision_matches_jax_xla(sa, sb):
    """set_matmul_precision('default') on both sides: the port's plain
    version rounds f32 operands to bf16 (the kernel's one bf16 pass) and
    sums in f32; JAX's xla mode on the CPU keeps f32, so the two agree to
    the bf16 rounding of the operands (1e-2 of the larger of 1 and the
    largest |element|), and the port differs from its 'highest' product."""
    a, b = _operands(sa, sb, seed=4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    prev_j = jax_amp.set_matmul_precision("default")
    prev_t = amp.set_matmul_precision("default")
    try:
        with jax_kernel_mode("xla"):
            want = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b)))
        got = matmul(ta, tb)
    finally:
        jax_amp.set_matmul_precision(prev_j)
        amp.set_matmul_precision(prev_t)
    assert prev_t == "highest"
    assert torch.equal(got, matmul_default_reference(ta, tb))
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(to_np(got) - want).max() <= 1e-2 * scale
    assert not torch.equal(got, matmul(ta, tb))
    with pytest.raises(ValueError):
        amp.set_matmul_precision("tf32")


@pytest.mark.parametrize("shape,strides,offset,kind,want", [
    # x (1024, 768) row-major: 16-byte rows along k
    ((1024, 768), (768, 1), 0, "f32", ("vec-k", "vec-mn")),
    ((1024, 768), (768, 1), 0, "bf16", ("async-k", "async-mn")),
    # x.T: rows along m
    ((768, 1024), (1, 768), 0, "f32", ("vec-mn", "vec-k")),
    # a storage offset of one element breaks 16-byte alignment: 4-byte
    # copies in f32 at full precision, element loads otherwise
    ((64, 64), (64, 1), 1, "f32", ("elem-k", "elem-mn")),
    ((64, 64), (64, 1), 1, "f32 default", ("scalar", "scalar")),
    # the decoder's gradient: rows of 30522 floats are not 16-byte aligned
    ((1024, 30522), (30522, 1), 0, "f32", ("elem-k", "elem-mn")),
    # K = 19: rows of 19 bf16 are not 16-byte aligned
    ((37, 19), (19, 1), 0, "bf16", ("scalar", "scalar")),
    # no unit stride
    ((40, 24), (48, 2), 0, "f32", ("scalar", "scalar")),
])
def test_loader_choice(shape, strides, offset, kind, want):
    """The kernel's loader by strides and alignment, as A (rows m) and as
    B's transpose (rows n)."""
    k_ = {"f32": mm_mod._F32X3, "bf16": mm_mod._BF16,
          "f32 default": mm_mod._F32BF16}[kind]
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    base = torch.zeros(offset + shape[0] * strides[0] + shape[1] * strides[1]
                       + 64, dtype=dtype)
    t = base.as_strided(shape, strides, offset)
    m, k = shape
    got_a = _loader(t, 0, 0, t.stride(0), t.stride(1), m, k, k_)
    got_b = _loader(t, 0, 0, t.stride(1), t.stride(0), k, m, k_)
    assert (LOADERS[got_a], LOADERS[got_b]) == want
