"""Port parity: the flash-attention backward.  The port's ``attention_bwd``
(CPU plain version) against the JAX package's in pallas (interpret) and
xla modes, and the port's autograd Function against torch autograd through
the plain forward."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.ops.attention import attention_bwd as jax_attention_bwd
from lightgrad_tpu.ops.attention import \
    attention_fwd_res as jax_attention_fwd_res
from lightgrad_tpu_torch.autograd import attention
from lightgrad_tpu_torch.ops.attention import (attention_bwd,
                                               attention_bwd_dkv,
                                               attention_bwd_dq,
                                               attention_fwd_reference,
                                               attention_fwd_res)
from tests.torch_port import jax_kernel_mode, rand, to_np

# f32 on both sides; sums in another order: 1e-5
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(S, G, seed=0, B=4, D=64):
    rng = np.random.default_rng(seed)
    return (rand(rng, B, S, D), rand(rng, B // G, S, D),
            rand(rng, B // G, S, D), rand(rng, B, S, D))


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_bwd_matches_jax(causal, G, mode):
    q, k, v, g = _inputs(64, G, seed=G + 2 * causal)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    with jax_kernel_mode(mode):
        out, lse = jax_attention_fwd_res(jq, jk, jv, 0.125, causal=causal)
        want = jax_attention_bwd(jg, jq, jk, jv, 0.125, causal=causal,
                                 out=out, lse=lse)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    t_out, t_lse = attention_fwd_res(tq, tk, tv, 0.125, causal=causal)
    got = attention_bwd(tg, tq, tk, tv, 0.125, causal, out=t_out, lse=t_lse)
    for a, b, like in zip(got, want, (tq, tk, tv)):
        assert a.shape == like.shape
        np.testing.assert_allclose(to_np(a), np.asarray(b), **TOL)


def test_attention_bwd_passes_match_the_whole():
    """The dq and dk/dv wrappers give the whole backward's parts."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(40, 2, seed=5))
    out, lse = attention_fwd_res(q, k, v, 0.125, causal=True)
    dcap = (g * out).sum(-1)
    dq, dk, dv = attention_bwd(g, q, k, v, 0.125, True, out=out, lse=lse)
    torch.testing.assert_close(
        attention_bwd_dq(g, q, k, v, lse, dcap, 0.125, True), dq)
    for a, b in zip(attention_bwd_dkv(g, q, k, v, lse, dcap, 0.125, True),
                    (dk, dv)):
        torch.testing.assert_close(a, b)


def test_dq_pass_refines_dcap():
    """The dq pass corrects dcap against its own p and dp: given a dcap off
    by 1e-3 (and an lse cotangent), its dq and its refined dcap are those
    of the exact one."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(40, 2, seed=6))
    out, lse = attention_fwd_res(q, k, v, 0.125, causal=True)
    dlse = torch.from_numpy(rand(np.random.default_rng(1), 4, 40))
    dcap = (g * out).sum(-1) - dlse
    want = attention_bwd_dq(g, q, k, v, lse, dcap, 0.125, True, dlse=dlse)
    refined = torch.empty_like(dcap)
    got = attention_bwd_dq(g, q, k, v, lse, dcap + 1e-3, 0.125, True,
                           dlse=dlse, dcap_out=refined)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(refined, dcap, **TOL)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_function_grads_match_autograd(causal, G):
    """The Function's analytic backward vs torch autograd differentiating
    the plain forward, through the model's (b, heads, S, D) layout and a
    strided incoming gradient."""
    rng = np.random.default_rng(7)
    q = rand(rng, 2, 4, 48, 64)
    k, v = rand(rng, 2, 4 // G, 48, 64), rand(rng, 2, 4 // G, 48, 64)
    w = torch.from_numpy(rand(rng, 48, 256))

    def run(fn):
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        y = fn(tq, tk, tv)                                  # (2, 4, 48, 64)
        y = y.transpose(1, 2).reshape(2, 48, 256)           # strided grad
        (y * w).sum().backward()
        return y, tq.grad, tk.grad, tv.grad

    got = run(lambda a, b, c: attention(a, b, c, 0.125, causal))
    want = run(lambda a, b, c: attention_fwd_reference(a, b, c, 0.125,
                                                       causal)[0])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)
