"""Port parity: lightgrad_tpu_torch.ops.attention (CPU plain version) vs the
JAX package's attention forward in pallas (interpret) and xla modes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.ops.attention import attention_fwd as jax_attention_fwd
from lightgrad_tpu.ops.attention import \
    attention_fwd_res as jax_attention_fwd_res
from lightgrad_tpu_torch.ops.attention import (attention_fwd,
                                               attention_fwd_res)
from tests.torch_port import jax_kernel_mode, rand, to_np

# f32 on both sides; sums in another order: 1e-5
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(S, G, seed=0):
    rng = np.random.default_rng(seed)
    B, D = 4, 64
    return (rand(rng, B, S, D), rand(rng, B // G, S, D),
            rand(rng, B // G, S, D))


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [64, 100])
def test_attention_fwd_res_matches_jax(S, causal, G, mode):
    q, k, v = _inputs(S, G)
    with jax_kernel_mode(mode):
        want_o, want_l = jax_attention_fwd_res(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125,
            causal=causal)
        want = jax_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), 0.125, causal=causal)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got_o, got_l = attention_fwd_res(tq, tk, tv, 0.125, causal=causal)
    got = attention_fwd(tq, tk, tv, 0.125, causal=causal)
    assert got_l.shape == (4, S, 1)
    np.testing.assert_allclose(to_np(got_o), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(to_np(got_l), np.asarray(want_l), **TOL)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_attention_fwd_window_and_lengths_on_cpu(mode):
    """The plain version serves ``window`` and ``lengths`` (on CUDA the
    kernel takes both)."""
    q, k, v = _inputs(64, 1, seed=3)
    lens = np.array([64, 40, 1, 17], np.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with jax_kernel_mode(mode):
        want_w = jax_attention_fwd_res(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), 0.125, causal=True,
                                       window=8)
        want_n = jax_attention_fwd_res(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), 0.125, causal=False,
                                       lengths=jnp.asarray(lens))
    got_w = attention_fwd_res(tq, tk, tv, 0.125, causal=True, window=8)
    got_n = attention_fwd_res(tq, tk, tv, 0.125, causal=False,
                              lengths=torch.from_numpy(lens))
    for got, want in ((got_w, want_w), (got_n, want_n)):
        np.testing.assert_allclose(to_np(got[0]), np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(to_np(got[1]), np.asarray(want[1]), **TOL)


def test_attention_fwd_keeps_leading_dims():
    """(b, heads, S, D) in, the same shape out (the model's call shape)."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rand(rng, 2, 3, 16, 64))
    out = attention_fwd(q, q, q, 0.125, causal=True)
    assert out.shape == q.shape and out.dtype == q.dtype
