"""Port parity: the flash backward's bfloat16 arithmetic.  The TPU kernels
round p and ds to the input dtype before their products (``p.astype``,
``ds.astype``), as the port's tensor-core kernels do with their bf16
operands; the port's plain versions (``attention_bwd_dq`` /
``attention_bwd_dkv`` on CPU tensors, ``attention_bwd_fused_reference``)
round the same way.  The same numpy bf16 inputs, the same forward residuals
and the same dcap go through the JAX package's ``_flash_bwd`` and
``_flash_bwd_fused`` in Pallas interpret mode and through the port's plain
versions; the plain versions without the rounding must be further from
JAX than with it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgrad_tpu.ops import attention as jax_attention
from lightgrad_tpu_torch.ops import attention
from lightgrad_tpu_torch.ops.attention import (attention_bwd_dkv,
                                               attention_bwd_dq,
                                               attention_bwd_fused_reference,
                                               fused_rows)
from tests.torch_port import jax_kernel_mode, rand, to_np

# Both sides sum in f32 in another order and round each output to bf16 once:
# past one bf16 ulp of each element, the error stays below TOL of the
# reference's rms (a p or ds that rounds the other way moves an output by
# far less).
TOL = 1e-2
ULP = 2.0 ** -7


def _excess(got, want):
    """max(|got - want| - ulp |want|) / rms(want), and mean |got - want| /
    rms(want)."""
    got, want = to_np(got).astype(np.float64), np.asarray(want, np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    diff = np.abs(got - want)
    return (diff - ULP * np.abs(want)).max() / rms, diff.mean() / rms


def _case(B, G, S, D, seed):
    """bf16 numpy inputs (q, do (B, S, D); k, v (B/G, S, D)), as f32 arrays
    holding bf16 values."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    q, do = bf(rand(rng, B, S, D)), bf(rand(rng, B, S, D))
    k, v = bf(rand(rng, B // G, S, D)), bf(rand(rng, B // G, S, D))
    return q, k, v, do


def _jax_residuals(q, k, v, do, scale, causal, lengths, window):
    """JAX's bf16 forward (out, lse) in Pallas interpret mode and the dcap
    its backward computes from them, (B, S, 1) f32."""
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    with jax_kernel_mode("pallas"):
        out, lse = jax_attention.attention_fwd_res(
            jq, jk, jv, scale, causal, lengths=lengths, window=window)
    dcap = jnp.sum(jg * out, axis=-1, keepdims=True).astype(jnp.float32)
    return (jq, jk, jv, jg), out, lse, dcap


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
            for a in arrays]


def _unrounded(g, q, k, v, lse, dcap, scale, causal, lengths=None,
               window=0, block_rows=None):
    """The same plain arithmetic in f32 throughout (p and ds never rounded),
    outputs rounded to bf16 once."""
    f32 = [t.float() for t in (g, q, k, v)]
    got = attention._bwd_from_residuals(*f32, lse, dcap, scale, causal,
                                        lengths, block_rows=block_rows,
                                        window=window)[:3]
    return [t.to(torch.bfloat16) for t in got]


def _assert_rounding_matches(got, plain, want):
    """``got`` within TOL of JAX's ``want`` past one ulp, and on the whole
    a tenth as far from it as the unrounded ``plain`` (whose outputs differ
    from JAX's by an ulp in about a third of the elements)."""
    for name, a, u, w in zip(("dq", "dk", "dv"), got, plain, want):
        assert a.dtype == torch.bfloat16
        over, mean = _excess(a, w)
        assert over <= TOL, (name, over)
        assert 10 * mean < _excess(u, w)[1], (name, mean, _excess(u, w)[1])


# (B, G, S, D, causal, lengths, window): d 32, 64, 80, 128; G 1 and 2;
# causal and not; S not a multiple of the kernels' 64-row tiles
PASSES = [(4, 1, 128, 64, True, False, 0), (4, 2, 100, 32, False, False, 0),
          (2, 1, 200, 80, True, False, 0), (4, 2, 256, 128, True, False, 0),
          (4, 1, 96, 64, True, True, 0), (4, 2, 160, 64, True, False, 40)]


@pytest.mark.parametrize("B,G,S,D,causal,lens,window", PASSES)
def test_two_passes_round_as_the_tpu_kernels(B, G, S, D, causal, lens,
                                             window):
    q, k, v, do = _case(B, G, S, D, seed=S + D + G)
    scale = D ** -0.5
    lengths = np.array([S, 1, S // 2, S - 7], np.int32)[:B] if lens else None
    (jq, jk, jv, jg), out, lse, dcap = _jax_residuals(
        q, k, v, do, scale, causal, lengths, window)
    with jax_kernel_mode("pallas"):
        want = jax_attention._flash_bwd(
            jg, jq, jk, jv, out, lse, scale, causal,
            lengths=None if lengths is None else jnp.asarray(lengths),
            window=window)
    want = [np.asarray(w, np.float32) for w in want]
    tq, tk, tv, tg = _torch(q, k, v, do)
    t_lse = torch.from_numpy(np.array(lse, np.float32))
    t_dcap = torch.from_numpy(np.array(dcap, np.float32)).reshape(B, S)
    t_lens = None if lengths is None else torch.from_numpy(lengths)
    refined = torch.empty_like(t_dcap)
    dq = attention_bwd_dq(tg, tq, tk, tv, t_lse, t_dcap, scale, causal,
                          t_lens, dcap_out=refined, window=window)
    # no refinement in bf16: the dk/dv pass takes dcap as given
    assert torch.equal(refined, t_dcap)
    dk, dv = attention_bwd_dkv(tg, tq, tk, tv, t_lse, refined, scale, causal,
                               t_lens, window=window)
    plain = _unrounded(tg, tq, tk, tv, t_lse, t_dcap, scale, causal, t_lens,
                       window)
    _assert_rounding_matches((dq, dk, dv), plain, want)


FUSED = [(4, 128, 64, True), (4, 100, 32, False), (2, 200, 80, True),
         (2, 256, 128, False)]


@pytest.mark.parametrize("B,S,D,causal", FUSED)
def test_fused_backward_rounds_as_the_tpu_kernel(B, S, D, causal):
    q, k, v, do = _case(B, 1, S, D, seed=3 * S + D)
    scale = D ** -0.5
    (jq, jk, jv, jg), out, lse, dcap = _jax_residuals(q, k, v, do, scale,
                                                      causal, None, 0)
    with jax_kernel_mode("pallas"):
        want = jax_attention._flash_bwd_fused(jg, jq, jk, jv, lse, dcap,
                                              scale, causal)
    want = [np.asarray(w, np.float32) for w in want]
    tq, tk, tv, tg = _torch(q, k, v, do)
    t_out = torch.from_numpy(np.array(out, np.float32)).to(torch.bfloat16)
    t_lse = torch.from_numpy(np.array(lse, np.float32))
    t_dcap = torch.from_numpy(np.array(dcap, np.float32)).reshape(B, S)
    got = attention_bwd_fused_reference(tg, tq, tk, tv, t_out, t_lse,
                                        t_dcap, scale, causal)
    plain = _unrounded(tg, tq, tk, tv, t_lse, t_dcap, scale, causal,
                       block_rows=fused_rows(D, torch.bfloat16))
    _assert_rounding_matches(got, plain, want)
