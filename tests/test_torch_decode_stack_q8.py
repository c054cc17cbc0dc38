"""Port parity of the whole-stack decode kernel's int8 variants: int8 slabs
with per-column scales (``quantize_serving``), an int8 cache with per-row
scales (``quantize_kv``) and both, single-stream and batched.  The port's
CPU plain versions against the JAX package's Pallas kernels in interpret
mode, and against a float64 numpy evaluation of the same dequantized math."""

import importlib

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
                                                  pack_gpt_stack)
from tests.test_torch_decode_stack import EPS, L, H, R, W, _params, d, hd
from tests.torch_port import jax_kernel_mode, rand, to_np

# int8 cache alone: f32 on both sides (tests/test_decode_stack.py's 2e-4).
# int8 weights: the JAX kernel rounds activations to bf16 before its int8
# dot, the port keeps them f32 (tests/test_decode_stack.py's 5e-2).
TOL = {"kvq": dict(atol=2e-4, rtol=2e-4),
       "int8": dict(atol=5e-2, rtol=5e-2),
       "int8_kvq": dict(atol=5e-2, rtol=5e-2)}
# the port against a float64 evaluation of its own (dequantized) math
TOL64 = dict(atol=2e-4, rtol=2e-4)
VARIANTS = ["int8", "kvq", "int8_kvq"]
BIG = ("attn.c_attn.weight", "attn.c_proj.weight", "c_fc.weight",
       "c_proj.weight")


def _quantized(seed):
    """The per-layer params with every matrix as GPT.quantize_serving
    stores it: ``#q`` int8 rows and ``#s`` per-output-channel scales."""
    p = _params(seed)
    for l in range(L):
        for name in BIG:
            w = p.pop(f"h.{l}.{name}")
            ws = np.maximum(np.abs(w).max(axis=1), 1e-8) / np.float32(127.0)
            p[f"h.{l}.{name}#q"] = np.clip(np.round(w / ws[:, None]), -127,
                                           127).astype(np.int8)
            p[f"h.{l}.{name}#s"] = ws.astype(np.float32)
    return p


def _q_rows(kv):
    """GPT.quantize_kv's per-row int8 quantization, in numpy."""
    s = np.maximum(np.abs(kv).max(-1, keepdims=True), 1e-8) / np.float32(127)
    return np.clip(np.round(kv / s), -127, 127).astype(np.int8), \
        s.astype(np.float32)


def _packed(variant, seed):
    p = _quantized(seed) if "int8" in variant else _params(seed)
    jp = jax_pack({k: jnp.asarray(v) for k, v in p.items()}, L, d, R)
    tp = pack_gpt_stack({k: torch.from_numpy(v) for k, v in p.items()},
                        L, d, R)
    return jp, tp


def _oracle(x, caches, slots, lens, self_vis, slabs, vecs, scales, kvs,
            v_scale_in_sum=False):
    """float64 numpy: dequantize slabs and cache rows, then the layer math.
    ``v_scale_in_sum`` plants a mistake a kernel could make: the softmax
    denominator sums p * vs over the cached keys instead of p."""
    x = x.astype(np.float64)
    n = x.shape[0]
    w = slabs.astype(np.float64)
    if scales is not None:
        w = w * scales.astype(np.float64)[:, :, None, :]
    c = caches.astype(np.float64)
    if kvs is not None:
        c = c * kvs.astype(np.float64)
    vecs = vecs.astype(np.float64)

    def ln(v, g, b):
        m = v.mean(-1, keepdims=True)
        var = ((v - m) ** 2).mean(-1, keepdims=True)
        return (v - m) / np.sqrt(var + EPS) * g + b

    def gelu(y):
        return 0.5 * y * (1 + np.tanh(0.7978845608028654 *
                                      (y + 0.044715 * y ** 3)))

    seen = np.arange(W)[None, :] < lens[:, None]
    kv = np.zeros((L, 2, n, d))
    for l in range(L):
        vec = vecs[l]
        h = ln(x, vec[0], vec[1])
        q, k, v = (h @ w[l, i] + vec[6 + i] for i in range(3))
        kv[l, 0], kv[l, 1] = k, v
        qh = q.reshape(n, H, hd)
        kc, vc = c[slots, l, 0], c[slots, l, 1]                # (n,H,W,hd)
        sc = np.einsum("nhd,nhwd->nhw", qh, kc) / np.sqrt(hd)
        sc = np.where(seen[:, None, :], sc, -np.inf)
        ss = np.einsum("nhd,jhd->nhj", qh, k.reshape(n, H, hd)) / np.sqrt(hd)
        ss = np.where(self_vis[:, None, :], ss, -np.inf)
        s = np.concatenate([sc, ss], -1)
        pr = np.exp(s - s.max(-1, keepdims=True))
        den = pr.sum(-1, keepdims=True)
        if v_scale_in_sum:
            vs = kvs.astype(np.float64)[slots, l, 1, ..., 0]     # (n,H,W)
            den = den + (pr[..., :W] * (vs - 1)).sum(-1, keepdims=True)
        pr /= den
        att = (np.einsum("nhw,nhwd->nhd", pr[..., :W], vc)
               + np.einsum("nhj,jhd->nhd", pr[..., W:], v.reshape(n, H, hd)))
        x = x + att.reshape(n, d) @ w[l, 3] + vec[4]
        h2 = ln(x, vec[2], vec[3])
        x = x + vec[5] + sum(gelu(h2 @ w[l, 4 + i] + vec[9 + i])
                             @ w[l, 4 + R + i] for i in range(R))
    return x, kv


def _caches(rng, variant, *lead):
    cache = rand(rng, *lead, L, 2, H, W, hd)
    if "kvq" not in variant:
        return cache, None
    return _q_rows(cache)


def test_int8_packing_equals_jax_packing():
    jp, tp = _packed("int8", 0)
    assert tp["stack#slabs"].dtype == torch.int8
    assert tp["stack#scales"].dtype == torch.float32
    np.testing.assert_array_equal(to_np(tp["stack#slabs"]),
                                  np.asarray(jp["stack#slabs"], np.float32))
    np.testing.assert_array_equal(to_np(tp["stack#vecs"]),
                                  np.asarray(jp["stack#vecs"]))
    # JAX keeps (L, S, 1, d) for Mosaic's tiling; the values are the same
    assert tuple(jp["stack#scales"].shape) == (L, 4 + 2 * R, 1, d)
    np.testing.assert_array_equal(to_np(tp["stack#scales"]),
                                  np.asarray(jp["stack#scales"])[:, :, 0])


@pytest.mark.parametrize("pos", [0, 5, W - 4])
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_stack_variant_matches_jax_and_float64(variant, n, pos):
    rng = np.random.default_rng(200 + 10 * n + pos)
    x = rand(rng, n, d)
    cache, kvs = _caches(rng, variant)
    jp, tp = _packed(variant, n)
    jsc, tsc = jp.get("stack#scales"), tp.get("stack#scales")
    with jax_kernel_mode("pallas"):
        want_x, want_kv = jax_decode_stack(
            jnp.asarray(x), jnp.asarray(cache), jnp.int32(pos),
            jp["stack#slabs"], jp["stack#vecs"], jsc, eps=EPS,
            kv_scales=None if kvs is None else jnp.asarray(kvs))
    tkvs = None if kvs is None else torch.from_numpy(kvs)
    got_x, got_kv = decode_stack(
        torch.from_numpy(x), torch.from_numpy(cache), pos, tp["stack#slabs"],
        tp["stack#vecs"], tsc, eps=EPS, kv_scales=tkvs)
    assert got_x.dtype == got_kv.dtype == torch.float32
    assert got_x.shape == (n, d) and got_kv.shape == (L, 2, n, d)
    np.testing.assert_allclose(to_np(got_x), np.asarray(want_x),
                               **TOL[variant])
    np.testing.assert_allclose(to_np(got_kv), np.asarray(want_kv),
                               **TOL[variant])
    rows = np.arange(n)
    o_x, o_kv = _oracle(
        x, cache[None], np.zeros(n, int), np.full(n, pos),
        rows[None, :] <= rows[:, None], to_np(tp["stack#slabs"]),
        to_np(tp["stack#vecs"]), None if tsc is None else to_np(tsc),
        None if kvs is None else kvs[None])
    np.testing.assert_allclose(to_np(got_x), o_x, **TOL64)
    np.testing.assert_allclose(to_np(got_kv), o_kv, **TOL64)


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_stack_batch_variant_matches_jax_and_float64(variant):
    rng = np.random.default_rng(17)
    B = 3
    poss = np.array([3, 0, W - 2], np.int32)
    x = rand(rng, B, d)
    caches, kvs = _caches(rng, variant, B)
    jp, tp = _packed(variant, 9)
    jsc, tsc = jp.get("stack#scales"), tp.get("stack#scales")
    with jax_kernel_mode("pallas"):
        want_x, want_kv = jax_decode_stack_batch(
            jnp.asarray(x), jnp.asarray(caches), jnp.asarray(poss),
            jp["stack#slabs"], jp["stack#vecs"], jsc, eps=EPS,
            kv_scales=None if kvs is None else jnp.asarray(kvs))
    got_x, got_kv = decode_stack_batch(
        torch.from_numpy(x), torch.from_numpy(caches), torch.from_numpy(poss),
        tp["stack#slabs"], tp["stack#vecs"], tsc, eps=EPS,
        kv_scales=None if kvs is None else torch.from_numpy(kvs))
    tol = dict(TOL[variant])
    if variant == "kvq":       # the JAX package's batched tolerance
        tol = dict(atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(to_np(got_x), np.asarray(want_x), **tol)
    np.testing.assert_allclose(to_np(got_kv), np.asarray(want_kv), **tol)
    rows = np.arange(B)
    o_x, o_kv = _oracle(x, caches, rows, poss, rows[None, :] == rows[:, None],
                        to_np(tp["stack#slabs"]), to_np(tp["stack#vecs"]),
                        None if tsc is None else to_np(tsc), kvs)
    np.testing.assert_allclose(to_np(got_x), o_x, **TOL64)
    np.testing.assert_allclose(to_np(got_kv), o_kv, **TOL64)


def test_int8_kv_scale_folds_into_the_context_only():
    """A V scale folded into the softmax denominator too would still give
    plausible rows: the plain version matches the float64 math, and the
    same math with that mistake lies far outside the tolerance."""
    rng = np.random.default_rng(3)
    x = rand(rng, 1, d)
    cache, kvs = _caches(rng, "kvq")
    _, tp = _packed("kvq", 1)
    args = (to_np(tp["stack#slabs"]), to_np(tp["stack#vecs"]), None)
    rows = np.arange(1)
    good = _oracle(x, cache[None], rows * 0, np.array([W - 1]),
                   rows[None] <= rows[:, None], *args, kvs[None])[0]
    got = to_np(decode_stack(torch.from_numpy(x), torch.from_numpy(cache),
                             W - 1, tp["stack#slabs"], tp["stack#vecs"],
                             eps=EPS, kv_scales=torch.from_numpy(kvs))[0])
    np.testing.assert_allclose(got, good, **TOL64)
    bad = _oracle(x, cache[None], rows * 0, np.array([W - 1]),
                  rows[None] <= rows[:, None], *args, kvs[None],
                  v_scale_in_sum=True)[0]
    assert np.abs(bad - got).max() > 100 * TOL64["atol"]


@pytest.mark.parametrize("what", ["scales dtype", "slabs dtype",
                                  "kv_scales shape"])
def test_decode_stack_checks_operand_types_on_the_card(what, monkeypatch):
    """The CUDA wrapper's operand checks run before any library is built:
    each operand has its own dtype (x f32/bf16, slabs x's or int8, cache
    x's or int8, scales f32)."""
    ds = importlib.import_module("lightgrad_tpu_torch.ops.decode_stack")
    _, tp = _packed("int8", 0)
    x = torch.zeros(1, d)
    cache = torch.zeros(L, 2, H, W, hd, dtype=torch.int8)
    kvs = torch.ones(L, 2, H, W, 1)
    slabs, sc = tp["stack#slabs"], tp["stack#scales"]
    if what == "scales dtype":
        sc = sc.double()
    elif what == "slabs dtype":
        slabs = slabs.float()
    else:
        kvs = kvs[..., 0]
    monkeypatch.setattr(ds._build, "library", lambda: pytest.fail("built"))
    with pytest.raises(ValueError):
        ds._launch("decode_stack_int8_kvq", x, cache, 0, None, 0, slabs,
                   tp["stack#vecs"], sc, kvs, EPS, R)
