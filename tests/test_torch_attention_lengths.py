"""Port parity: flash attention with per-example ``lengths`` (right-padded
keys masked out of every softmax, padded query rows zero).  The port's
forward and backward (CPU plain versions, the recompute one and the one
from the forward's lse and dcap that the dq and dk/dv kernels share)
against the JAX package's in pallas (interpret) and xla modes, and the
tape's ``attention(lengths=)`` forward and backward against the JAX tape."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.ops.attention import attention_bwd as jax_attention_bwd
from lightgrad_tpu.ops.attention import \
    attention_fwd_res as jax_attention_fwd_res
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.ops.attention import (attention_bwd,
                                               attention_bwd_dkv,
                                               attention_bwd_dq,
                                               attention_fwd_res)
from tests.torch_port import cpu_device, jax_kernel_mode, rand, to_np  # noqa

# f32 on both sides; sums in another order: 1e-5
TOL = dict(atol=1e-5, rtol=1e-5)
S, B, D = 64, 4, 64
# a full row, a short one, one of a single key, one past a block boundary
LENS = np.array([S, 5, 1, 33], np.int32)


def _inputs(G, seed):
    rng = np.random.default_rng(seed)
    return (rand(rng, B, S, D), rand(rng, B // G, S, D),
            rand(rng, B // G, S, D), rand(rng, B, S, D))


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_with_lengths_matches_jax(causal, G, mode):
    """out, lse, and dq, dk, dv from the whole backward and from the two
    passes' plain versions."""
    q, k, v, g = _inputs(G, seed=10 + G + 2 * causal)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    with jax_kernel_mode(mode):
        j_out, j_lse = jax_attention_fwd_res(jq, jk, jv, 0.125, causal=causal,
                                             lengths=jnp.asarray(LENS))
        want = jax_attention_bwd(jg, jq, jk, jv, 0.125, causal=causal,
                                 out=j_out, lse=j_lse,
                                 lengths=jnp.asarray(LENS))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    lens = torch.from_numpy(LENS)
    out, lse = attention_fwd_res(tq, tk, tv, 0.125, causal, lengths=lens)
    np.testing.assert_allclose(to_np(out), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(to_np(lse), np.asarray(j_lse), **TOL)
    whole = attention_bwd(tg, tq, tk, tv, 0.125, causal, out=out, lse=lse,
                          lengths=lens)
    dcap = (tg * out).sum(-1)
    passes = (attention_bwd_dq(tg, tq, tk, tv, lse, dcap, 0.125, causal,
                               lens),
              *attention_bwd_dkv(tg, tq, tk, tv, lse, dcap, 0.125, causal,
                                 lens))
    for got in (whole, passes):
        for a, b in zip(got, want):
            np.testing.assert_allclose(to_np(a), np.asarray(b), **TOL)
    pad = np.arange(S)[None, :] >= LENS[:, None]
    assert not to_np(out)[pad].any() and not to_np(lse)[..., 0][pad].any()
    assert not to_np(passes[0])[pad].any()


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_tape_attention_lengths_backward_matches_jax(mode):
    """The tape's op on the model's (batch, heads, S, D) layout: a (batch,)
    lengths vector repeated over the heads, causal, forward and the
    gradient of each input."""
    rng = np.random.default_rng(4)
    arrays = [rand(rng, 2, 3, 16, 64) for _ in range(3)]
    lens = np.array([16, 7], np.int32)
    w = rand(rng, 2, 3, 16, 64)

    def run(T):
        q, k, v = (T.from_numpy(a.copy()) for a in arrays)
        y = q.attention(k, v, scale=0.125, causal=True,
                        lengths=T.from_numpy(lens, requires_grad=False))
        (y * T.from_numpy(w, requires_grad=False)).sum().backward()
        return [y.numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy()]

    with jax_kernel_mode(mode):
        want = run(JTensor)
    for a, b in zip(run(TTensor), want):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **TOL)
