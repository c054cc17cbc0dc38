"""Port parity: the fused flash backward (one kernel for dq, dk and dv; dq
as the f32 sum of the key blocks' shares in ascending order).  The port's plain version
against the JAX package's ``_flash_bwd_fused``, reached through its
``set_flash_fused(True)`` in pallas (interpret) mode, at head dims 8 to
256, and the port's own switch and rule (the JAX rule: no lengths, no
window, G == 1, at any head dim)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.ops import attention as jax_attention
from lightgrad_tpu_torch.ops import attention
from lightgrad_tpu_torch.ops.attention import (attention_bwd,
                                               attention_bwd_fused,
                                               attention_bwd_fused_reference,
                                               attention_bwd_reference,
                                               attention_fwd_res, fused_rows,
                                               set_flash_fused)
from lightgrad_tpu_torch.ops.matmul import (matmul_tf32x3_reference,
                                            tf32_round)
from tests.torch_port import jax_kernel_mode, rand, to_np

# f32 on both sides; sums (here also the slabs' sum) in another order
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(S, D, seed):
    rng = np.random.default_rng(seed)
    return [rand(rng, 4, S, D) for _ in range(4)]


def _one_tf32_pass(a, b):
    """One tf32 product: each operand rounded to tf32, summed exactly."""
    return torch.matmul(tf32_round(a).double(),
                        tf32_round(b).double()).float()


# head dims: each instantiation (32, 64, 128, 256) at its own width, and 8
# and 80 through the next wider one; S 100 is no multiple of any block's
# rows (64, 32, 16)
@pytest.mark.parametrize("S,D,causal", [(64, 64, False), (64, 64, True),
                                        (100, 64, True), (96, 128, True),
                                        (64, 8, True), (100, 8, False),
                                        (64, 32, False), (100, 32, True),
                                        (100, 80, True), (64, 80, False),
                                        (64, 256, True), (100, 256, False)])
def test_fused_backward_matches_jax_fused(S, D, causal):
    q, k, v, g = _inputs(S, D, seed=S + D + causal)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    prev = jax_attention.set_flash_fused(True)
    try:
        with jax_kernel_mode("pallas"):
            out, lse = jax_attention.attention_fwd_res(jq, jk, jv, 0.125,
                                                       causal=causal)
            want = jax_attention.attention_bwd(jg, jq, jk, jv, 0.125,
                                               causal=causal, out=out,
                                               lse=lse)
    finally:
        jax_attention.set_flash_fused(prev)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    t_out, t_lse = attention_fwd_res(tq, tk, tv, 0.125, causal)
    dcap = (tg * t_out).sum(-1)
    for got in (attention_bwd_fused_reference(tg, tq, tk, tv, t_out, t_lse,
                                              dcap, 0.125, causal),
                attention_bwd_fused(tg, tq, tk, tv, t_lse, dcap, 0.125,
                                    causal)):
        for a, b, like in zip(got, want, (tq, tk, tv)):
            assert a.shape == like.shape and a.dtype == like.dtype
            np.testing.assert_allclose(to_np(a), np.asarray(b), **TOL)


def _jax_fused(q, k, v, g, scale, causal):
    """JAX's fused backward (pallas, interpret) of the numpy inputs."""
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    prev = jax_attention.set_flash_fused(True)
    try:
        with jax_kernel_mode("pallas"):
            out, lse = jax_attention.attention_fwd_res(jq, jk, jv, scale,
                                                       causal=causal)
            return jax_attention.attention_bwd(jg, jq, jk, jv, scale,
                                               causal=causal, out=out,
                                               lse=lse)
    finally:
        jax_attention.set_flash_fused(prev)


def _tf32x3_excess(S, D, causal, product=None):
    """The f32 fused kernel's arithmetic (``product``: every product; by
    default its three tf32 passes) against JAX's fused backward: the
    largest of dq, dk, dv's max |err| over the f32 kernel tolerance's bar,
    1e-4 * max(1, max |ref|) (<= 1 passes)."""
    q, k, v, g = _inputs(S, D, seed=5 * S + D + causal)
    want = _jax_fused(q, k, v, g, D ** -0.5, causal)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    t_out, t_lse = attention_fwd_res(tq, tk, tv, D ** -0.5, causal)
    dcap = (tg * t_out).sum(-1)
    got = attention_bwd_fused_reference(
        tg, tq, tk, tv, t_out, t_lse, dcap, D ** -0.5, causal,
        product=product or matmul_tf32x3_reference)
    excess = 0.0
    for a, b, like in zip(got, want, (tq, tk, tv)):
        assert a.shape == like.shape and a.dtype == torch.float32
        w = np.asarray(b)
        bar = 1e-4 * max(1.0, float(np.abs(w).max()))
        excess = max(excess, float(np.abs(to_np(a) - w).max()) / bar)
    return excess


# head dims 64 and 256 at their own instantiations, 80 through D 96's; S
# 300 spans three of D 96's 128-key blocks, S 200 four of D 256's 64
@pytest.mark.parametrize("S,D,causal", [(160, 64, True), (300, 80, True),
                                        (200, 256, False)])
def test_fused_tf32x3_model_matches_jax_fused(S, D, causal):
    """The f32 fused kernel's three tf32 passes a product (dq summed over
    its key blocks in order), modelled by ``attention_bwd_fused_reference``
    with ``product=matmul_tf32x3_reference``, within the f32 kernel
    tolerance of JAX's fused backward; one tf32 pass a product misses it."""
    assert _tf32x3_excess(S, D, causal) <= 1.0
    assert _tf32x3_excess(S, D, causal, product=_one_tf32_pass) > 1.0


def test_fused_slabs_sum_to_the_recompute_backward():
    """At D 128 the f32 plain version sums four 128-key blocks' shares: the
    same gradients as the recompute backward."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(512, 128, seed=3))
    out, lse = attention_fwd_res(q, k, v, 0.09, True)
    dcap = (g * out).sum(-1)
    got = attention_bwd_fused(g, q, k, v, lse, dcap, 0.09, True)
    for a, b in zip(got, attention_bwd_reference(g, q, k, v, 0.09, True)):
        torch.testing.assert_close(a, b, **TOL)


def test_switch_returns_the_previous_setting_and_the_rule(monkeypatch):
    """set_flash_fused returns what it replaces; the backward takes the
    fused version only without lengths and with G == 1."""
    assert set_flash_fused(True) is False
    try:
        calls = []
        fused = attention.attention_bwd_fused
        monkeypatch.setattr(attention, "attention_bwd_fused",
                            lambda *a: calls.append(1) or fused(*a))
        q, k, v, g = (torch.from_numpy(a) for a in _inputs(32, 64, seed=1))
        out, lse = attention_fwd_res(q, k, v, 0.125, True)
        attention._flash_bwd(g, q, k, v, out, lse, 0.125, True)
        assert calls == [1]
        lens = torch.tensor([32, 3, 9, 17], dtype=torch.int32)
        o2, l2 = attention_fwd_res(q, k, v, 0.125, True, lengths=lens)
        attention._flash_bwd(g, q, k, v, o2, l2, 0.125, True, lengths=lens)
        o3, l3 = attention_fwd_res(q, k[:2], v[:2], 0.125, True)
        attention._flash_bwd(g, q, k[:2], v[:2], o3, l3, 0.125, True)
        assert calls == [1]
    finally:
        assert set_flash_fused(False) is True


@pytest.mark.parametrize("d,dtype,rows", [
    (8, torch.float32, 64), (32, torch.float32, 64), (64, torch.float32, 64),
    (80, torch.float32, 128), (128, torch.float32, 128),
    (136, torch.float32, 64), (256, torch.float32, 64),
    (8, torch.bfloat16, 64), (80, torch.bfloat16, 64),
    (136, torch.bfloat16, 64), (256, torch.bfloat16, 64)])
def test_fused_rows_follow_the_instantiation(d, dtype, rows):
    """A head dim runs the narrowest instantiation of its dtype that holds
    it (f32: the tensor-core kernel's 64, 64, 128, 128, 64 key rows at D
    32, 64, 96, 128, 256; bf16: 64 at D 64, 128, 256), whose key rows a
    block set the key blocks whose dq shares the plain version sums in
    order (csrc/flash_bwd.cu asserts them)."""
    assert fused_rows(d, dtype) == rows


@pytest.mark.parametrize("D", [80, 256])
def test_rule_takes_the_fused_backward_at_any_head_dim(D, monkeypatch):
    """Under the switch, the backward takes the fused version wherever the
    JAX rule does (G == 1, no lengths, no window) -- head dims 80 and 256
    too -- through ``_flash_bwd``; grouped queries, lengths and a window
    stay on the two passes.  ``attention_bwd`` on CPU tensors keeps the
    recompute version, which the fused one matches."""
    calls, passes = [], []
    fused = attention.attention_bwd_fused
    dq_pass = attention.attention_bwd_dq
    monkeypatch.setattr(attention, "attention_bwd_fused",
                        lambda *a: calls.append(1) or fused(*a))
    monkeypatch.setattr(attention, "attention_bwd_dq",
                        lambda *a, **k: passes.append(1) or dq_pass(*a, **k))
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(48, D, seed=D))
    out, lse = attention_fwd_res(q, k, v, 0.1, True)
    prev = set_flash_fused(True)
    try:
        got = attention._flash_bwd(g, q, k, v, out, lse, 0.1, True)
        again = attention_bwd(g, q, k, v, 0.1, True, out=out, lse=lse)
        assert calls == [1] and passes == []
        lens = torch.tensor([48, 3, 9, 17], dtype=torch.int32)
        o2, l2 = attention_fwd_res(q, k, v, 0.1, True, lengths=lens)
        attention._flash_bwd(g, q, k, v, o2, l2, 0.1, True, lengths=lens)
        o3, l3 = attention_fwd_res(q, k, v, 0.1, True, window=8)
        attention._flash_bwd(g, q, k, v, o3, l3, 0.1, True, window=8)
        o4, l4 = attention_fwd_res(q, k[:2], v[:2], 0.1, True)
        attention._flash_bwd(g, q, k[:2], v[:2], o4, l4, 0.1, True)
        assert calls == [1] and passes == [1, 1, 1]
    finally:
        set_flash_fused(prev)
    want = attention_bwd_reference(g, q, k, v, 0.1, True)
    for a, b, c in zip(got, again, want):
        assert torch.equal(b, c)
        torch.testing.assert_close(a, c, **TOL)
