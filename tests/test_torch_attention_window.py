"""Port parity: the sliding window and the other head dims of the flash
kernels and of decode attention.  The port's ``attention_fwd_res``,
``attention_bwd`` and the two passes ``attention_bwd_dq`` /
``attention_bwd_dkv`` (whose plain version, ``_bwd_from_residuals``, takes
the window: it is what the card holds the kernels against) against the JAX
package's ``attention_fwd_res`` / ``attention_bwd`` in pallas (interpret)
and xla modes, at S <= 64, windows below, at and above S, G 1, 2 and 4 and
head dims 8, 16, 32 and 80; and ``decode_attention`` at head dims 8 and 256
with a window."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.ops.attention import attention_bwd as jax_attention_bwd
from lightgrad_tpu.ops.attention import \
    attention_fwd_res as jax_attention_fwd_res
from lightgrad_tpu.ops.decode_attention import \
    decode_attention as jax_decode_attention
from lightgrad_tpu_torch.ops.attention import (attention_bwd,
                                               attention_bwd_dkv,
                                               attention_bwd_dq,
                                               attention_bwd_reference,
                                               attention_fwd_res)
from lightgrad_tpu_torch.ops.decode_attention import decode_attention
from tests.torch_port import jax_kernel_mode, rand, to_np

# f32 on both sides, sums in another order
TOL = dict(atol=2e-5, rtol=2e-5)

# (S, G, d, window): the band below S (several head dims and groups), at S
# and past S (no band), and an S that is not a multiple of any tile
CASES = [(64, 1, 32, 8), (48, 2, 16, 5), (40, 4, 8, 13), (64, 2, 80, 16),
         (33, 1, 80, 33), (24, 4, 16, 100)]


def _inputs(S, G, d, seed, B=4):
    rng = np.random.default_rng(seed)
    return (rand(rng, B, S, d), rand(rng, B // G, S, d),
            rand(rng, B // G, S, d), rand(rng, B, S, d))


def _jax(mode, q, k, v, g, scale, window):
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    with jax_kernel_mode(mode):
        out, lse = jax_attention_fwd_res(jq, jk, jv, scale, causal=True,
                                         window=window)
        grads = jax_attention_bwd(jg, jq, jk, jv, scale, causal=True,
                                  out=out, lse=lse, window=window)
    return out, lse, grads


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("S,G,d,window", CASES)
def test_window_and_head_dims_match_jax(S, G, d, window, mode):
    """The forward (out, lse) and the whole backward against the JAX
    package's, and the two passes (the kernels' plain arithmetic from lse
    and dcap) against the same gradients."""
    q, k, v, g = _inputs(S, G, d, seed=S + d + window)
    scale = d ** -0.5
    want_o, want_l, want = _jax(mode, q, k, v, g, scale, window)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = attention_fwd_res(tq, tk, tv, scale, causal=True,
                                 window=window)
    np.testing.assert_allclose(to_np(out), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(to_np(lse), np.asarray(want_l), **TOL)
    whole = attention_bwd(tg, tq, tk, tv, scale, True, out=out, lse=lse,
                          window=window)
    dcap = (tg * out).sum(-1).contiguous()
    refined = torch.empty_like(dcap)
    dq = attention_bwd_dq(tg, tq, tk, tv, lse, dcap, scale, True,
                          dcap_out=refined, window=window)
    dk, dv = attention_bwd_dkv(tg, tq, tk, tv, lse, refined, scale, True,
                               window=window)
    for got in (whole, (dq, dk, dv)):
        for a, b, like in zip(got, want, (tq, tk, tv)):
            assert a.shape == like.shape
            np.testing.assert_allclose(to_np(a), np.asarray(b), **TOL)


def test_passes_without_the_window_differ():
    """The two passes' plain version applies the band: dropping it changes
    dq, dk and dv (a window that reached nothing would test nothing)."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(40, 2, 16, seed=7))
    out, lse = attention_fwd_res(q, k, v, 0.25, causal=True, window=6)
    dcap = (g * out).sum(-1).contiguous()
    banded = attention_bwd_dq(g, q, k, v, lse, dcap, 0.25, True, window=6)
    full = attention_bwd_dq(g, q, k, v, lse, dcap, 0.25, True)
    assert (banded - full).abs().max() > 1e-2
    want = attention_bwd_reference(g, q, k, v, 0.25, True, window=6)
    torch.testing.assert_close(banded, want[0], atol=2e-5, rtol=2e-5)
    for a, b in zip(attention_bwd_dkv(g, q, k, v, lse, dcap, 0.25, True,
                                      window=6), want[1:]):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("hd,G,pos,window", [(8, 3, 20, 6), (8, 1, 31, 0),
                                              (256, 8, 25, 9),
                                              (256, 2, 7, 40)])
def test_decode_attention_head_dims_match_jax(hd, G, pos, window, mode):
    rng = np.random.default_rng(hd + pos)
    KV, W = 2, 32
    q, kc, vc = rand(rng, KV, G, hd), rand(rng, KV, W, hd), \
        rand(rng, KV, W, hd)
    scale = hd ** -0.5
    with jax_kernel_mode(mode):
        want = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.int32(pos), scale,
                                    window=window)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), pos, scale, window=window)
    assert got.shape == (KV, G, hd)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
