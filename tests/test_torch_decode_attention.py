"""Port parity: lightgrad_tpu_torch.ops.decode_attention (CPU plain version)
vs the JAX package's decode_attention in pallas (interpret) and xla modes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.ops.decode_attention import \
    decode_attention as jax_decode_attention
from lightgrad_tpu_torch.ops.decode_attention import decode_attention
from tests.torch_port import jax_kernel_mode, rand, to_np

W = 16
TOL = dict(atol=1e-5, rtol=1e-5)   # f32 both sides, other summation order


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("pos", [0, 5, W - 1])
def test_decode_attention_matches_jax(pos, window, mode):
    rng = np.random.default_rng(pos + 10 * window)
    KV, G, hd = 2, 3, 64                    # grouped-query: 3 heads per KV
    q, kc, vc = rand(rng, KV, G, hd), rand(rng, KV, W, hd), \
        rand(rng, KV, W, hd)
    with jax_kernel_mode(mode):
        want = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.int32(pos), 0.125,
                                    window=window)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), pos, 0.125, window=window)
    assert got.shape == (KV, G, hd)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
