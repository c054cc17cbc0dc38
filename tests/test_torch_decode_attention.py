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


# --- the split kernel's arithmetic: ranges of the visible keys, merged -------
from functools import lru_cache  # noqa: E402

from lightgrad_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_attention_reference, decode_attention_split_reference,
    decode_merge, decode_merge_reference, decode_splits, max_visible,
    plan_splits, split_bounds, split_partials, visible_range)

SPLIT_W = 16


@lru_cache(maxsize=None)
def _split_case(G, hd, pos, window, mode):
    """(q, kc, vc) and the JAX package's output for one case, made once
    for every n_split."""
    rng = np.random.default_rng(1000 * G + 10 * hd + pos + window)
    KV = 2
    q, kc, vc = rand(rng, KV, G, hd), rand(rng, KV, SPLIT_W, hd), \
        rand(rng, KV, SPLIT_W, hd)
    with jax_kernel_mode(mode):
        want = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.int32(pos), 0.3,
                                    window=window)
    return q, kc, vc, np.asarray(want)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("hd", [8, 64, 80])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("pos,window", [(0, 0), (9, 0), (SPLIT_W - 1, 0),
                                        (0, 4), (9, 4), (SPLIT_W - 1, 4)])
@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 40])
def test_split_reference_matches_jax(n_split, pos, window, G, hd, mode):
    """The split kernel's ranges and merge (n_split past the visible keys
    leaves ranges empty, whose partials the merge weighs 0) against the
    JAX package's decode_attention, pallas (interpret) and xla modes."""
    q, kc, vc, want = _split_case(G, hd, pos, window, mode)
    got = decode_attention_split_reference(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), pos,
        0.3, window, n_split)
    assert got.shape == q.shape
    np.testing.assert_allclose(to_np(got), want, **TOL)


@pytest.mark.parametrize("n_split", [2, 3, 5])
def test_merge_plain_version_and_layout(n_split):
    """decode_merge on CPU tensors (the merge kernel's plain version) over
    split_partials' layout equals the one-pass reference; a partial whose
    maxima are shifted by a constant merges to the same output (the merge
    rescales by e^(m_s - M)), and one split's range alone does not."""
    rng = np.random.default_rng(n_split)
    KV, G, hd, W, pos = 2, 4, 32, 40, 33
    q, kc, vc = (torch.from_numpy(rand(rng, *s))
                 for s in ((KV, G, hd), (KV, W, hd), (KV, W, hd)))
    part = split_partials(q, kc, vc, pos, 0.2, 0, n_split)
    assert part.numel() == KV * n_split * G * (hd + 2)
    want = decode_attention_reference(q, kc, vc, pos, 0.2)
    out = decode_merge(part, torch.empty(KV, G, hd), n_split)
    np.testing.assert_allclose(to_np(out), to_np(want), **TOL)
    n = KV * n_split * G
    shifted = part.clone()
    shifted[n * hd:n * (hd + 1)] += 3.0      # m + 3: acc and l scale e^-3
    shifted[:n * hd] *= np.exp(-3.0)
    shifted[n * (hd + 1):] *= np.exp(-3.0)
    np.testing.assert_allclose(
        to_np(decode_merge_reference(shifted, KV, G, hd, n_split)),
        to_np(want), **TOL)
    b = split_bounds(0, pos + 1, n_split)
    first = decode_attention_reference(q, kc, vc, b[1] - 1, 0.2, b[1])
    assert np.abs(to_np(first) - to_np(want)).max() > 1e-2


# the serving paths' decode shapes: (KV, hd, W, pos, window)
SERVING_DECODE = [(1, 256, 8192, 4096, 0),        # Gemma-2B
                  (8, 128, 8192, 6000, 4096),     # Mistral-7B, banded
                  (12, 64, 1024, 512, 0),         # GPT-2 small
                  (2, 32, 192, 100, 0),           # examples/llama.py
                  (1, 256, 8192, 8191, 0), (8, 128, 8192, 0, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,hd,W,pos,window", SERVING_DECODE)
def test_decode_splits_cover_the_range_once(KV, hd, W, pos, window, dtype):
    """The planner's ranges cover [lo, hi] exactly once, at most 256.  The
    count is planned from the most rows the cache can show, never from
    pos, so where it exceeds the visible rows max(0, n - nv) ranges are
    empty, and none is where it does not."""
    lo, hi = visible_range(W, pos, window)
    nv = hi - lo + 1
    n = plan_splits(KV, W, window, hd, dtype)
    assert n == decode_splits(KV, max_visible(W, window), hd, dtype)
    assert 1 <= n <= min(max_visible(W, window), 256)
    b = split_bounds(lo, nv, n)
    assert b[0] == lo and b[-1] == hi + 1 and len(b) == n + 1
    assert all(e >= s for s, e in zip(b[:-1], b[1:]))
    assert sum(e == s for s, e in zip(b[:-1], b[1:])) == max(0, n - nv)


def test_decode_splits_at_the_serving_shapes():
    """The plans the serving paths run (the kernel's stage is 64 bf16
    keys): Gemma-2B's one KV head split into 65 ranges of <= 64 keys,
    Mistral-7B's 8 heads into 32 ranges of 128 (two blocks an SM), GPT-2's
    12 heads into 9; a ragged range never spills into another stage."""
    bf16 = torch.bfloat16
    assert decode_splits(1, 4097, 256, bf16) == 65
    assert decode_splits(8, 4096, 128, bf16) == 32
    assert decode_splits(12, 513, 64, bf16) == 9
    assert decode_splits(300, 4000, 64, bf16) == 1
    for KV, nv in ((1, 4097), (8, 4096), (8, 1501), (12, 513), (1, 1001)):
        n = decode_splits(KV, nv, 64, bf16)
        b = split_bounds(0, nv, n)
        longest = max(e - s for s, e in zip(b[:-1], b[1:]))
        # the longest range takes the even share of the range's stages
        assert -(-longest // 64) == -(-(-(-nv // 64)) // n)
