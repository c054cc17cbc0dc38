"""Port parity: decode positions kept on the device, and LLaMA's batched
``step_batch``.

The port's decode functions take a position either as a host int or as an
int32 tensor that nothing reads to the host (the JAX kernels' SMEM
scalar): ``decode_attention`` and ``decode_stack`` (CPU plain versions)
with a tensor position equal the host-int call and the JAX package,
positions past the window included; the split kernel's plain arithmetic
with its splits planned from the window, not the position; the batched
decode attention's plain version equals B single calls and the JAX
package's ``jax.vmap`` of its kernel; LLaMA's ``step_batch``, one pass
over all slots, equals B single ``step``s and the JAX package's
``jax.vmap(step.fn)``; GPT-2's ``step`` at a tensor position equals the
host-int step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgrad_tpu_torch as lt
from lightgrad_tpu.models.llama import Llama as JLlama
from lightgrad_tpu.models.llama import LlamaConfig as JLlamaConfig
from lightgrad_tpu.ops.decode_attention import \
    decode_attention as jax_decode_attention
from lightgrad_tpu.ops.decode_stack import decode_stack as jax_decode_stack
from lightgrad_tpu.ops.decode_stack import pack_gpt_stack as jax_pack
from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
from lightgrad_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_batch, decode_attention_split_reference,
    plan_splits, split_partials)
from lightgrad_tpu_torch.ops.decode_stack import decode_stack, pack_gpt_stack
from tests.torch_port import cpu_device, jax_kernel_mode, rand, to_np  # noqa

W = 16
TOL = dict(atol=1e-5, rtol=1e-5)   # f32 both sides, other summation order


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("pos,window", [(0, 0), (7, 0), (W - 1, 0),
                                        (W + 5, 0), (9, 4), (W + 1, 4)])
def test_decode_attention_tensor_position(pos, window, mode):
    """A one-element int32 tensor position gives the host int's output and
    the JAX package's, past the window too (keys clamp to the W rows)."""
    rng = np.random.default_rng(pos + 7 * window)
    KV, G, hd = 2, 3, 16
    q, kc, vc = rand(rng, KV, G, hd), rand(rng, KV, W, hd), \
        rand(rng, KV, W, hd)
    with jax_kernel_mode(mode):
        want = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.int32(pos), 0.25,
                                    window=window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kc, vc))
    got = decode_attention(tq, tk, tv, _i32([pos]), 0.25, window=window)
    assert torch.equal(got, decode_attention(tq, tk, tv, pos, 0.25,
                                             window=window))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos,window,n_split", [(0, 0, 16), (3, 0, 5),
                                                (W - 1, 0, 16), (W + 1, 4, 4),
                                                (2, 4, 4), (11, 4, 3)])
def test_split_arithmetic_plans_from_the_window(pos, window, n_split):
    """The split kernel's plain arithmetic at a tensor position: ranges cut
    from the visible rows at the split count planned for the whole window
    (empty ones where it exceeds them) merge to the one-pass output, and a
    tensor position gives the host int's partials."""
    rng = np.random.default_rng(40 + pos)
    KV, G, hd = 2, 2, 8
    q, kc, vc = (torch.from_numpy(rand(rng, *s))
                 for s in ((KV, G, hd), (KV, W, hd), (KV, W, hd)))
    want = decode_attention(q, kc, vc, pos, 0.3, window)
    got = decode_attention_split_reference(q, kc, vc, _i32(pos), 0.3, window,
                                           n_split)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    assert torch.equal(split_partials(q, kc, vc, _i32([pos]), 0.3, window,
                                      n_split),
                       split_partials(q, kc, vc, pos, 0.3, window, n_split))


def test_splits_are_planned_from_the_window():
    """The split count depends on the cache's rows and the window, never on
    the position: Gemma-2B's one KV head over 8192 rows, Mistral-7B's 8
    over its 4096 band, GPT-2's 12 over 1024 rows."""
    bf16 = torch.bfloat16
    assert plan_splits(1, 8192, 0, 256, bf16) == 128
    assert plan_splits(8, 8192, 4096, 128, bf16) == 32
    assert plan_splits(12, 1024, 0, 64, bf16) == 16
    assert plan_splits(2, 16, 0, 32, torch.float32) == 1
    assert plan_splits(1, 8192, 9000, 256, bf16) == 128


@pytest.mark.parametrize("window", [0, 5])
def test_batched_decode_attention_matches_single_calls_and_jax_vmap(window):
    """The batched plain version over a stacked cache's strided slot views,
    slots at their own positions (one past W), equals one call a slot and
    the JAX package's kernel lifted by jax.vmap (pallas, interpret)."""
    rng = np.random.default_rng(9 + window)
    B, L, KV, G, hd = 4, 2, 2, 3, 16
    poss = np.array([0, 6, W - 1, W + 2], np.int32)
    q = rand(rng, B, KV, G, hd)
    caches = torch.from_numpy(rand(rng, B, L, 2, KV, W, hd))
    kc, vc = caches[:, 1, 0], caches[:, 1, 1]
    got = decode_attention_batch(torch.from_numpy(q), kc, vc,
                                 torch.from_numpy(poss), 0.25, window)
    for b in range(B):
        one = decode_attention(torch.from_numpy(q[b]), kc[b], vc[b],
                               int(poss[b]), 0.25, window)
        np.testing.assert_allclose(to_np(got[b]), to_np(one), **TOL)
    with jax_kernel_mode("pallas"):
        want = jax.vmap(lambda q_, k_, v_, p_: jax_decode_attention(
            q_, k_, v_, p_, 0.25, window=window))(
                jnp.asarray(q), jnp.asarray(kc.numpy()),
                jnp.asarray(vc.numpy()), jnp.asarray(poss))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_decode_stack_tensor_position():
    """decode_stack at a tensor position equals the host int's call and the
    JAX megakernel (pallas, interpret)."""
    L, d, H, R, n, pos = 2, 128, 2, 4, 2, 9
    rng = np.random.default_rng(5)
    p = {}
    for l in range(L):
        pre = f"h.{l}."
        for k, shape, sc in (("ln_1.weight", (d,), 0.1),
                             ("ln_1.bias", (d,), 0.1),
                             ("ln_2.weight", (d,), 0.1),
                             ("ln_2.bias", (d,), 0.1),
                             ("attn.c_attn.weight", (3 * d, d), 0.08),
                             ("attn.c_attn.bias", (3 * d,), 0.1),
                             ("attn.c_proj.weight", (d, d), 0.08),
                             ("attn.c_proj.bias", (d,), 0.1),
                             ("c_fc.weight", (R * d, d), 0.08),
                             ("c_fc.bias", (R * d,), 0.1),
                             ("c_proj.weight", (d, R * d), 0.04),
                             ("c_proj.bias", (d,), 0.1)):
            p[pre + k] = rand(rng, *shape, scale=sc) + (
                1.0 if k.endswith("weight") and k.startswith("ln") else 0.0)
    jp = jax_pack({k: jnp.asarray(v) for k, v in p.items()}, L, d, R)
    tp = pack_gpt_stack({k: torch.from_numpy(v) for k, v in p.items()}, L, d,
                        R)
    x, cache = rand(rng, n, d), rand(rng, L, 2, H, W, d // H)
    args = (tp["stack#slabs"], tp["stack#vecs"])
    got = decode_stack(torch.from_numpy(x), torch.from_numpy(cache),
                       _i32([pos]), *args, eps=1e-5)
    host = decode_stack(torch.from_numpy(x), torch.from_numpy(cache), pos,
                        *args, eps=1e-5)
    with jax_kernel_mode("pallas"):
        want = jax_decode_stack(jnp.asarray(x), jnp.asarray(cache),
                                jnp.int32(pos), jp["stack#slabs"],
                                jp["stack#vecs"], eps=1e-5)
    for a, h, w in zip(got, host, want):
        assert torch.equal(a, h)
        np.testing.assert_allclose(to_np(a), np.asarray(w), atol=2e-4,
                                   rtol=2e-4)


# --- LLaMA's step_batch: one pass over the slots -----------------------------
BASE = dict(vocab_size=61, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=W)
CONFIGS = {
    "llama": {},
    "mistral": dict(sliding_window=5),
    "qwen2": dict(attention_bias=True, num_key_value_heads=4),
    "gemma": dict(head_dim=8, hidden_act="gelu_pytorch_tanh", rms_offset=True,
                  scale_embeddings=True, tie_word_embeddings=True,
                  rms_norm_eps=1e-6),
}
# tests/test_torch_llama.py's: f32 through 2 layers
LLAMA_TOL = dict(rtol=1e-4, atol=1e-4)


def _llama(name, seed):
    cfg = dict(BASE, **CONFIGS[name])
    np.random.seed(seed)
    jm = JLlama(JLlamaConfig(**cfg))
    rng = np.random.default_rng(seed)
    state = {}
    for n, prm in jm.named_parameters():
        a = prm.numpy()
        if "layernorm" in n or n == "norm.weight" or n.endswith(".bias"):
            a = rng.uniform(-0.5, 1.5, a.shape).astype(np.float32)
        state[n] = a
    jm.load_parameters(state)
    tm = Llama(LlamaConfig(**cfg))
    lt.load_numpy_params(tm, state)
    return jm, tm


@pytest.mark.parametrize("name", list(CONFIGS))
def test_llama_step_batch_matches_steps_and_jax_vmap(name):
    """Three slots prefilled with ragged prompts, then one step_batch (one
    slot past the window, clamped) against one ``step`` a slot on copies of
    the caches, and against the JAX package's jax.vmap(step.fn) over its
    own stacked caches: logits and the written cache rows."""
    jm, tm = _llama(name, seed=11)
    rng = np.random.default_rng(11)
    lens = (3, 9, W - 1)
    toks = rng.integers(0, BASE["vocab_size"], (3, W)).astype(np.int32)
    poss = np.array([3, 9, W + 1], np.int32)
    nxt = rng.integers(0, BASE["vocab_size"], 3).astype(np.int32)

    with torch.no_grad():
        tfns = tm._kv_functions()
        caches = torch.stack([tfns.init_cache() for _ in range(3)])
        for b, n in enumerate(lens):
            tfns.prefill(caches[b], torch.from_numpy(toks[b]).long(), n)
        ref = caches.clone()
        singles = [tfns.step(ref[b], min(int(poss[b]), W - 1),
                             int(nxt[b]))[1] for b in range(3)]
        _, got = tfns.step_batch(caches, torch.from_numpy(poss),
                                 torch.from_numpy(nxt).long())
    assert got.shape == (3, BASE["vocab_size"])
    for b in range(2):   # the third slot's step attends its window edge
        np.testing.assert_allclose(to_np(got[b]), to_np(singles[b]),
                                   **LLAMA_TOL)
    np.testing.assert_allclose(to_np(caches[:2]), to_np(ref[:2]),
                               **LLAMA_TOL)

    with jax_kernel_mode("pallas"):
        jfns = jm._kv_functions()
        init, prefill, step = jfns
        jcaches = jnp.stack([prefill(init(), jnp.asarray(toks[b]), n)[0]
                             for b, n in enumerate(lens)])
        jcaches, want = jax.vmap(step.fn, in_axes=(None, 0, 0, 0))(
            step.params, jcaches, jnp.asarray(poss), jnp.asarray(nxt))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LLAMA_TOL)
    np.testing.assert_allclose(to_np(caches), np.asarray(jcaches),
                               **LLAMA_TOL)


def test_gpt_step_tensor_position():
    """GPT-2's step at an int32 tensor position: the host int's logits and
    cache, through the stack kernel's branch and the unrolled one."""
    cfg = lt.GPTConfig(vocab_size=96, n_positions=W, n_embd=128, n_layer=2,
                       n_head=2)
    model = lt.GPT(cfg, device=torch.device("cpu"),
                   generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, 96, (W,), generator=torch.Generator()
                         .manual_seed(1))
    for pack in (True, False):
        fns = model._kv_functions(pack_stack=pack)
        cache = fns.init_cache()
        with torch.no_grad():
            fns.prefill(cache, toks, 6)
            ref = cache.clone()
            want = fns.step(ref, 6, 17)[1]
            got = fns.step(cache, _i32(6), torch.tensor(17))[1]
        assert torch.equal(got, want)
        assert torch.equal(cache, ref)
