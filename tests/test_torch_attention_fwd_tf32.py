"""Port parity: the arithmetic of the float32 flash forward on the tensor
cores.  The kernel computes both products, s = q k^T and out = p v, as
three tf32 passes (hi = tf32(x), lo = tf32(x - hi); hi hi + hi lo + lo hi),
as the JAX kernel computes them at Precision.HIGHEST.  The port's plain
model of that arithmetic, ``attention_fwd_tf32x3_reference``, against the
JAX package's ``attention_fwd_res`` in pallas (interpret) and xla modes at
head dims 64, 80 and 256, causal, banded, with lengths and G 2, at the f32
kernel tolerance; one tf32 pass misses the same bar."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.ops.attention import \
    attention_fwd_res as jax_attention_fwd_res
from lightgrad_tpu_torch.ops.attention import (attention_fwd_reference,
                                               attention_fwd_tf32x3_reference)
from lightgrad_tpu_torch.ops.matmul import tf32_round
from tests.torch_port import jax_kernel_mode, rand, to_np

# the f32 kernel tolerance (chip_smoke.py's KERNEL_TOL): max |err| <= TOL *
# max(1, max |reference|)
TOL = 1e-4

# (S, G, d, causal, window, lengths): head dims 64, 80 (no instantiation of
# its own) and 256, the causal mask, a band, per-row lengths (0, 1, S and
# between; the JAX package takes no band with them), grouped queries
CASES = [(64, 1, 64, True, 0, None), (64, 2, 64, True, 16, None),
         (48, 2, 64, False, 0, (48, 0, 1, 30)), (40, 2, 80, True, 0, None),
         (40, 1, 80, False, 0, (40, 17, 3, 39)), (32, 2, 256, True, 0, None),
         (40, 1, 256, True, 9, None)]


def _case(S, G, d, causal, window, lengths, mode):
    """Inputs (numpy, seeded by the case) as torch tensors, the call's
    keywords, and the JAX forward's (out, lse) in ``mode``."""
    rng = np.random.default_rng(3 * S + G + d + window)
    B = 4
    q = rand(rng, B, S, d)
    k, v = rand(rng, B // G, S, d), rand(rng, B // G, S, d)
    scale = d ** -0.5
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    kw = dict(causal=causal, window=window)
    if lens is not None:
        kw["lengths"] = jnp.asarray(lens)
    with jax_kernel_mode(mode):
        want = jax_attention_fwd_res(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), scale, **kw)
    kw["lengths"] = None if lens is None else torch.from_numpy(lens)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return t, scale, kw, want


def _excess(got, want):
    """max |got - want| over the tolerance's bar (<= 1 passes)."""
    w = np.asarray(want)
    bar = TOL * max(1.0, float(np.abs(w).max()))
    return float(np.abs(to_np(got) - w.reshape(to_np(got).shape)).max()) / bar


def _one_pass(a, b):
    """One tf32 product: each operand rounded to tf32, summed exactly."""
    return torch.matmul(tf32_round(a).double(),
                        tf32_round(b).double()).float()


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("S,G,d,causal,window,lengths", CASES)
def test_tf32x3_forward_matches_jax(S, G, d, causal, window, lengths, mode):
    (q, k, v), scale, kw, want = _case(S, G, d, causal, window, lengths,
                                       mode)
    got = attention_fwd_tf32x3_reference(q, k, v, scale, **kw)
    assert got[0].shape == q.shape and got[0].dtype == torch.float32
    assert got[1].shape == (q.shape[0], S, 1)
    for a, b in zip(got, want):
        assert _excess(a, b) <= 1.0
    if lengths is not None:     # padded rows: zeros and an lse of 0
        pad = torch.arange(S)[None, :] >= kw["lengths"][:, None]
        assert bool((got[0][pad] == 0).all())
        assert bool((got[1][..., 0][pad] == 0).all())


def test_one_tf32_pass_fails_the_tolerance():
    """The same arithmetic with one tf32 pass a product (what TF32 alone
    keeps) misses the bar at every case, while the plain f32 version meets
    it, so the test above tells the two apart."""
    for case in CASES:
        (q, k, v), scale, kw, want = _case(*case, "xla")
        one = attention_fwd_tf32x3_reference(q, k, v, scale, **kw,
                                             product=_one_pass)
        plain = attention_fwd_reference(q, k, v, scale, **kw)
        assert max(_excess(a, b) for a, b in zip(one, want)) > 1.0, case
        assert max(_excess(a, b) for a, b in zip(plain, want)) <= 1.0, case
