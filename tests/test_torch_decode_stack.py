"""Port parity: lightgrad_tpu_torch.ops.decode_stack (CPU plain versions) vs
the JAX package's decode megakernel in pallas (interpret) mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.ops.decode_stack import decode_stack as jax_decode_stack
from lightgrad_tpu.ops.decode_stack import \
    decode_stack_batch as jax_decode_stack_batch
from lightgrad_tpu.ops.decode_stack import pack_gpt_stack as jax_pack
from lightgrad_tpu_torch.ops.decode_stack import (decode_stack,
                                                  decode_stack_batch,
                                                  pack_gpt_stack,
                                                  stack_supported)
from tests.torch_port import jax_kernel_mode, rand, to_np

L, d, H, W, R = 2, 128, 2, 16, 4
hd = d // H
EPS = 1e-5
# the JAX package's own megakernel tolerances (tests/test_decode_stack.py)
TOL_STEP = dict(atol=2e-4, rtol=2e-4)
TOL_BATCH = dict(atol=5e-4, rtol=5e-4)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    p = {}
    for l in range(L):
        pre = f"h.{l}."
        p[pre + "ln_1.weight"] = 1 + rand(rng, d, scale=0.1)
        p[pre + "ln_1.bias"] = rand(rng, d, scale=0.1)
        p[pre + "ln_2.weight"] = 1 + rand(rng, d, scale=0.1)
        p[pre + "ln_2.bias"] = rand(rng, d, scale=0.1)
        p[pre + "attn.c_attn.weight"] = rand(rng, 3 * d, d, scale=0.08)
        p[pre + "attn.c_attn.bias"] = rand(rng, 3 * d, scale=0.1)
        p[pre + "attn.c_proj.weight"] = rand(rng, d, d, scale=0.08)
        p[pre + "attn.c_proj.bias"] = rand(rng, d, scale=0.1)
        p[pre + "c_fc.weight"] = rand(rng, R * d, d, scale=0.08)
        p[pre + "c_fc.bias"] = rand(rng, R * d, scale=0.1)
        p[pre + "c_proj.weight"] = rand(rng, d, R * d, scale=0.04)
        p[pre + "c_proj.bias"] = rand(rng, d, scale=0.1)
    return p


def _packed(seed=0):
    p = _params(seed)
    jp = jax_pack({k: jnp.asarray(v) for k, v in p.items()}, L, d, R)
    tp = pack_gpt_stack({k: torch.from_numpy(v) for k, v in p.items()},
                        L, d, R)
    return jp, tp


def test_pack_gpt_stack_equals_jax_packing():
    jp, tp = _packed()
    for key in ("stack#slabs", "stack#vecs"):
        assert tuple(tp[key].shape) == tuple(jp[key].shape)
        np.testing.assert_array_equal(to_np(tp[key]), np.asarray(jp[key]))


@pytest.mark.parametrize("pos", [0, 5, W - 4])
@pytest.mark.parametrize("n", [1, 4])
def test_decode_stack_matches_jax(n, pos):
    rng = np.random.default_rng(100 + n + pos)
    x, cache = rand(rng, n, d), rand(rng, L, 2, H, W, hd)
    jp, tp = _packed(seed=n)
    with jax_kernel_mode("pallas"):
        want_x, want_kv = jax_decode_stack(
            jnp.asarray(x), jnp.asarray(cache), jnp.int32(pos),
            jp["stack#slabs"], jp["stack#vecs"], eps=EPS)
    got_x, got_kv = decode_stack(
        torch.from_numpy(x), torch.from_numpy(cache), pos, tp["stack#slabs"],
        tp["stack#vecs"], eps=EPS)
    assert got_x.shape == (n, d) and got_kv.shape == (L, 2, n, d)
    np.testing.assert_allclose(to_np(got_x), np.asarray(want_x), **TOL_STEP)
    np.testing.assert_allclose(to_np(got_kv), np.asarray(want_kv),
                               **TOL_STEP)


def test_decode_stack_batch_matches_jax():
    rng = np.random.default_rng(7)
    B = 3
    poss = np.array([3, 7, 5], np.int32)
    x, caches = rand(rng, B, d), rand(rng, B, L, 2, H, W, hd)
    jp, tp = _packed(seed=9)
    with jax_kernel_mode("pallas"):
        want_x, want_kv = jax_decode_stack_batch(
            jnp.asarray(x), jnp.asarray(caches), jnp.asarray(poss),
            jp["stack#slabs"], jp["stack#vecs"], eps=EPS)
    got_x, got_kv = decode_stack_batch(
        torch.from_numpy(x), torch.from_numpy(caches), torch.from_numpy(poss),
        tp["stack#slabs"], tp["stack#vecs"], eps=EPS)
    np.testing.assert_allclose(to_np(got_x), np.asarray(want_x), **TOL_BATCH)
    np.testing.assert_allclose(to_np(got_kv), np.asarray(want_kv),
                               **TOL_BATCH)


@pytest.mark.parametrize("d_,hd_,n,ok", [
    (768, 64, 8, True), (128, 64, 1, True), (768, 64, 9, False),
    (768, 128, 1, False), (96, 32, 1, False), (8192, 64, 1, False)])
def test_stack_supported(d_, hd_, n, ok):
    assert stack_supported(d=d_, hd=hd_, n=n) is ok
