"""Port parity: the arithmetic of the float32 flash backward passes on the
tensor cores.  The kernels compute every product of the dq and dk/dv
passes as three tf32 passes (hi = tf32(x), lo = tf32(x - hi); hi hi + hi
lo + lo hi), as the JAX kernels compute theirs at Precision.HIGHEST.  The
port's plain model of that arithmetic, ``attention_bwd_tf32x3_reference``,
against the JAX package's ``attention_bwd`` in pallas (interpret) and xla
modes at head dims 64 and 256, causal, banded, with lengths and G 2, at the
f32 kernel tolerance; one tf32 pass misses the same bar."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.ops.attention import attention_bwd as jax_attention_bwd
from lightgrad_tpu.ops.attention import \
    attention_fwd_res as jax_attention_fwd_res
from lightgrad_tpu_torch.ops.attention import (attention_bwd_tf32x3_reference,
                                               attention_fwd_res)
from lightgrad_tpu_torch.ops.matmul import tf32_round
from tests.torch_port import jax_kernel_mode, rand, to_np

# the f32 kernel tolerance (chip_smoke.py's KERNEL_TOL): max |err| <= TOL *
# max(1, max |reference|)
TOL = 1e-4

# (S, G, d, causal, window, lengths): head dims 64 and 256, the causal mask,
# a band, per-row lengths (0, 1, S and between; the JAX package takes no
# band with them), grouped queries
CASES = [(64, 1, 64, True, 0, None), (64, 2, 64, True, 16, None),
         (48, 2, 64, False, 0, (48, 0, 1, 30)), (32, 2, 256, True, 0, None),
         (40, 1, 256, True, 0, (40, 17, 3, 39))]


def _case(S, G, d, causal, window, lengths, mode):
    """Inputs (numpy, seeded by the case), the JAX backward's (dq, dk, dv)
    in ``mode``, and the port's forward (out, lse) the passes start from."""
    rng = np.random.default_rng(S + G + d + window)
    B = 4
    q, g = rand(rng, B, S, d), rand(rng, B, S, d)
    k, v = rand(rng, B // G, S, d), rand(rng, B // G, S, d)
    scale = d ** -0.5
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    kw = dict(causal=causal, window=window)
    if lens is not None:
        kw["lengths"] = jnp.asarray(lens)
    with jax_kernel_mode(mode):
        out, lse = jax_attention_fwd_res(jq, jk, jv, scale, **kw)
        want = jax_attention_bwd(jg, jq, jk, jv, scale, out=out, lse=lse,
                                 **kw)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    tl = None if lens is None else torch.from_numpy(lens)
    t_out, t_lse = attention_fwd_res(*t[:3], scale, causal, lengths=tl,
                                     window=window)
    return t, (t_out, t_lse, scale, causal, tl, window), want


def _excess(got, want):
    """max |got - want| over the tolerance's bar (<= 1 passes)."""
    w = np.asarray(want)
    bar = TOL * max(1.0, float(np.abs(w).max()))
    return float(np.abs(to_np(got) - w).max()) / bar


def _one_pass(a, b):
    """One tf32 product: each operand rounded to tf32, summed exactly."""
    return torch.matmul(tf32_round(a).double(),
                        tf32_round(b).double()).float()


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("S,G,d,causal,window,lengths", CASES)
def test_tf32x3_backward_matches_jax(S, G, d, causal, window, lengths, mode):
    (q, k, v, g), (out, lse, scale, causal, lens, window), want = _case(
        S, G, d, causal, window, lengths, mode)
    got = attention_bwd_tf32x3_reference(g, q, k, v, out, lse, scale, causal,
                                         lens, window)
    for a, b, like in zip(got, want, (q, k, v)):
        assert a.shape == like.shape and a.dtype == torch.float32
        assert _excess(a, b) <= 1.0


def test_one_tf32_pass_fails_the_tolerance():
    """The same arithmetic with one tf32 pass a product (what TF32 alone
    keeps) misses the bar at every case, so the test above tells the two
    apart."""
    for case in CASES:
        (q, k, v, g), (out, lse, scale, causal, lens, window), want = _case(
            *case, "xla")
        one = attention_bwd_tf32x3_reference(g, q, k, v, out, lse, scale,
                                             causal, lens, window,
                                             product=_one_pass)
        assert max(_excess(a, b) for a, b in zip(one, want)) > 1.0, case
