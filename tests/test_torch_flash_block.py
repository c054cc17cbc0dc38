"""Port parity: ``flash_block``, (out, lse) differentiable through lse.
The port's ``torch.autograd.Function`` (CPU plain versions; the two-pass
and the fused backward) against the JAX package's ``flash_block`` with a
nonzero lse cotangent (as tests/test_ring_attention.py checks the JAX one),
and a 4-chunk merge of blocks -- ring attention's math in one process --
against one full attention call, forward and gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgrad_tpu.ops.attention import flash_block as jax_flash_block
from lightgrad_tpu_torch.autograd import flash_block
from lightgrad_tpu_torch.ops.attention import (attention_bwd,
                                               attention_fwd_res,
                                               flash_block_reference,
                                               set_flash_fused)
from tests.torch_port import jax_kernel_mode, rand, to_np

# f32 on both sides; sums in another order; sin(lse) adds one more rounding
TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(b, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rand(rng, b, s, d, scale=0.5) for _ in range(3)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_lse_cotangent_matches_jax(causal, fused):
    q, k, v = _qkv(2, 128, 64, seed=8 + causal)
    scale = 0.25

    def loss_jax(q, k, v):
        out, lse = jax_flash_block(q, k, v, scale, causal)
        return jnp.sum(out ** 2) + jnp.sum(jnp.sin(lse))

    with jax_kernel_mode("pallas"):
        want = jax.grad(loss_jax, argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
        want_out, want_lse = jax_flash_block(
            *(jnp.asarray(a) for a in (q, k, v)), scale, causal)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    prev = set_flash_fused(fused)
    try:
        out, lse = flash_block(*ts, scale, causal)
        ((out ** 2).sum() + torch.sin(lse).sum()).backward()
    finally:
        set_flash_fused(prev)
    np.testing.assert_allclose(to_np(out), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(to_np(lse), np.asarray(want_lse), **TOL)
    for t, w, name in zip(ts, want, "qkv"):
        np.testing.assert_allclose(to_np(t.grad), np.asarray(w),
                                   err_msg=name, **TOL)


def _merge(acc, lse, out_r, lse_r):
    """The JAX package's online-softmax combine of two (out, lse) partials
    (parallel/ring_attention.py)."""
    lse_new = torch.logaddexp(lse, lse_r)
    return (acc * torch.exp(lse - lse_new)
            + out_r.float() * torch.exp(lse_r - lse_new)), lse_new


def chunked(q, k, v, scale, n, block):
    """Causal attention over ``n`` chunks: each query chunk merges its
    diagonal block (causal) with every earlier chunk (not causal)."""
    c = q.shape[-2] // n
    outs, lses = [], []
    for i in range(n):
        qi = q[:, i * c:(i + 1) * c]
        acc, lse = block(qi, k[:, i * c:(i + 1) * c], v[:, i * c:(i + 1) * c],
                         scale, True)
        acc = acc.float()
        for j in range(i):
            acc, lse = _merge(acc, lse, *block(
                qi, k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c], scale,
                False))
        outs.append(acc.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, 1)


@pytest.mark.parametrize("block", ["flash_block", "reference"])
def test_four_chunk_merge_matches_one_full_call(block):
    """sum(out * w) + sum(lse * wl) through the merge: out, lse, dq, dk, dv
    against one full causal call, whose backward takes the same lse
    cotangent as dcap - dlse."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 128, 64, seed=2))
    w = torch.from_numpy(rand(rng, 3, 128, 64))
    wl = torch.from_numpy(rand(rng, 3, 128, 1))

    def run(fn, n):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = chunked(*ts, 0.125, n, fn) if n > 1 else \
            fn(*ts, 0.125, True)
        ((out * w).sum() + (lse * wl).sum()).backward()
        return [out, lse] + [t.grad for t in ts]

    got = run(flash_block if block == "flash_block"
              else flash_block_reference, 4)
    for want in (run(flash_block, 1), run(flash_block_reference, 1)):
        for a, b, name in zip(got, want, ("out", "lse", "dq", "dk", "dv")):
            np.testing.assert_allclose(to_np(a), to_np(b), err_msg=name,
                                       **TOL)
    # without the lse term the full call is attention_fwd_res/attention_bwd
    f_out, f_lse = attention_fwd_res(q, k, v, 0.125, True)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    (chunked(*ts, 0.125, 4, flash_block)[0] * w).sum().backward()
    for t, a in zip(ts, attention_bwd(w, q, k, v, 0.125, True, out=f_out,
                                      lse=f_lse)):
        np.testing.assert_allclose(to_np(t.grad), to_np(a), **TOL)
