"""Port parity of int8 serving: ``GPT.quantize_serving`` (int8 weights),
``GPT.quantize_kv`` (an int8 KV cache) and both, in float32 and bfloat16.
A tiny GPT built by the JAX package is carried across with
``load_numpy_params``; prefill, cached steps on the packed-stack and the
unrolled branch, extend, step_batch, generate_batch and the serving engine
over the (rows, scales) cache are held against the JAX package and against
the port's own float path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgrad_tpu as light
from lightgrad_tpu.models import GPT as JaxGPT
from lightgrad_tpu.models import GPTConfig as JaxGPTConfig
from lightgrad_tpu_torch import (GPT, GPTConfig, InferenceEngine,
                                 load_numpy_params)
from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts
from tests.torch_port import jax_kernel_mode, one_thread, to_np  # noqa: F401

CFG = dict(vocab_size=64, n_positions=64, n_embd=128, n_layer=2, n_head=2)
W, L, H, HD = 64, 2, 2, 64
MODES = ["serve", "kv", "both"]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# branch -> (JAX kernel mode, the port's pack_stack)
BRANCHES = {"packed": ("pallas", None), "unrolled": ("xla", False)}
PROMPT = [3, 7, 11, 19, 2]


def _quantize(m, mode):
    if mode in ("serve", "both"):
        m.quantize_serving()
    if mode in ("kv", "both"):
        m.quantize_kv()
    return m


def _tol(mode, dtype, branch="unrolled"):
    """Logits tolerance against the JAX package.  bf16: both sides round
    at other points.  int8 weights on the packed branch: the JAX kernel
    rounds activations to bf16 before its int8 dot, the port keeps f32
    (tests/test_decode_stack.py's 5e-2).  int8 KV: 5e-3, the JAX package's
    own packed-vs-unrolled bound (tests/test_decode_stack.py)."""
    if dtype == "bf16" or (mode != "kv" and branch == "packed"):
        return dict(atol=5e-2, rtol=5e-2)
    if mode == "kv":
        return dict(atol=5e-3, rtol=5e-3)
    return dict(atol=2e-4, rtol=2e-4)


def _jax_model():
    np.random.seed(11)
    return JaxGPT(JaxGPTConfig(**CFG))


def _models(mode, dtype):
    """The JAX model (made anew from its seed, so each test quantizes its
    own) and the port's twin carrying the same weights."""
    jm = _jax_model()
    tm = GPT(GPTConfig(**CFG), device="cpu")
    load_numpy_params(tm, {n: np.asarray(t.data)
                           for n, t in jm.named_parameters()})
    if dtype == "bf16":
        light.amp.cast_module(jm, jnp.bfloat16)
        tm.to(torch.bfloat16)
    return _quantize(jm, mode), _quantize(tm, mode)


def _fns(jm, tm, branch):
    jmode, pack = BRANCHES[branch]
    with jax_kernel_mode(jmode):
        jf = jm._kv_functions()
    tf = tm._kv_functions(pack_stack=pack)
    assert ("stack#slabs" in tf.step.params) == (branch == "packed")
    assert ("stack#slabs" in jf.step.params) == (branch == "packed")
    return jf, tf


def _toks(prompt):
    toks = np.zeros(W, np.int32)
    toks[:len(prompt)] = prompt
    return toks


def _prefill(jf, tf, prompt):
    toks = _toks(prompt)
    jc, jl = jf.prefill(jf.init_cache(), jnp.asarray(toks), len(prompt))
    tc, tl = tf.prefill(tf.init_cache(), torch.from_numpy(toks).long(),
                        len(prompt))
    return jc, jl, tc, tl


def _cache_close(tc, jc, mode, tol, dtype="f32"):
    """f32: int8 rows within one unit (rounding boundaries crossed under
    reduction-order noise), scales rtol 1e-2.  bf16: the rows were
    quantized from K/V that already differ at the bf16 tolerance (JAX
    rounds LayerNorm's statistics to bf16, torch keeps them f32), so the
    dequantized rows are compared at that tolerance.  A float cache within
    ``tol``."""
    if mode == "serve":
        np.testing.assert_allclose(to_np(tc), np.asarray(jc, np.float32),
                                   **tol)
        return
    (tq, ts), (jq, js) = tc, jc
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    if dtype == "bf16":
        np.testing.assert_allclose(tq.numpy() * ts.numpy(),
                                   np.asarray(jq, np.float32)
                                   * np.asarray(js), **tol)
        return
    diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert diff.max() <= 1, diff.max()
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-2,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_init_cache_and_prefill_match_jax(mode, dtype):
    jm, tm = _models(mode, dtype)
    jf, tf = _fns(jm, tm, "unrolled")
    c = tf.init_cache()
    if mode == "serve":
        assert c.dtype == DTYPES[dtype][0] and c.shape == (L, 2, H, W, HD)
    else:
        assert c[0].dtype == torch.int8 and c[0].shape == (L, 2, H, W, HD)
        assert c[1].dtype == torch.float32 and c[1].shape == (L, 2, H, W, 1)
    if mode != "kv":
        p = tf.step.params
        assert p["head#q"].dtype == torch.int8
        assert p["head#s"].dtype == DTYPES[dtype][0]
        assert "h.0.c_fc.weight" not in p and "h.0.c_fc.weight#q" in p
        np.testing.assert_array_equal(
            p["h.1.attn.c_proj.weight#q"].numpy(),
            np.asarray(jf.step.params["h.1.attn.c_proj.weight#q"]))
        np.testing.assert_array_equal(
            to_np(p["h.1.c_fc.weight#s"]),
            np.asarray(jf.step.params["h.1.c_fc.weight#s"], np.float32))
    with jax_kernel_mode("xla"):
        jc, jl, tc, tl = _prefill(jf, tf, PROMPT)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "f32" else _tol(mode, dtype)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl, np.float32), **tol)
    _cache_close(tc, jc, mode, tol, dtype)


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_teacher_forced_steps_match_jax(mode, dtype, branch):
    jm, tm = _models(mode, dtype)
    jf, tf = _fns(jm, tm, branch)
    tol = _tol(mode, dtype, branch)
    forced = np.random.default_rng(1).integers(0, 64, 6)
    with jax_kernel_mode(BRANCHES[branch][0]):
        jc, _, tc, _ = _prefill(jf, tf, PROMPT)
        for i, tok in enumerate(forced):
            pos = len(PROMPT) + i
            jc, jl = jf.step(jc, jnp.int32(pos), jnp.int32(tok))
            tc, tl = tf.step(tc, pos, int(tok))
            np.testing.assert_allclose(to_np(tl), np.asarray(jl, np.float32),
                                       **tol)
            _cache_close(tc, jc, mode, tol, dtype)


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("mode", MODES)
def test_extend_matches_sequential_steps(mode, branch):
    _, tm = _models(mode, "f32")
    tf = tm._kv_functions(pack_stack=BRANCHES[branch][1])
    toks = torch.tensor([4, 8, 15, 16])
    c, _ = tf.prefill(tf.init_cache(), torch.from_numpy(_toks([5, 1, 9])).long(),
                      3)
    seq = tuple(t.clone() for t in c) if mode != "serve" else c.clone()
    c, rows = tf.extend(c, 3, toks)
    assert rows.shape == (4, 64)
    for i, tok in enumerate(toks):
        seq, lg = tf.step(seq, 3 + i, int(tok))
        np.testing.assert_allclose(to_np(lg), to_np(rows[i]), atol=1e-3,
                                   rtol=1e-3)
    _cache_close(seq, tuple(t.numpy() for t in c) if mode != "serve"
                 else c.numpy(), mode, dict(atol=1e-3, rtol=1e-3))


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("mode", MODES)
def test_step_batch_matches_jax(mode, branch):
    jm, tm = _models(mode, "f32")
    jf, tf = _fns(jm, tm, branch)
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5, 4, 3], [20, 21, 22, 23, 24]]
    poss = np.array([len(p) for p in prompts], np.int32)
    toks = np.array([30, 31, 32], np.int32)
    with jax_kernel_mode(BRANCHES[branch][0]):
        pairs = [_prefill(jf, tf, pr) for pr in prompts]
        if mode == "serve":
            jcs = jnp.stack([p[0] for p in pairs])
            tcs = torch.stack([p[2] for p in pairs])
        else:
            jcs = tuple(jnp.stack([p[0][i] for p in pairs]) for i in (0, 1))
            tcs = tuple(torch.stack([p[2][i] for p in pairs]) for i in (0, 1))
        jcs, jl = jf.step_batch(jcs, jnp.asarray(poss), jnp.asarray(toks))
    tcs, tl = tf.step_batch(tcs, torch.from_numpy(poss),
                            torch.from_numpy(toks).long())
    tol = _tol(mode, "f32", branch)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **tol)
    _cache_close(tcs, jcs, mode, tol)


@pytest.mark.parametrize("mode", MODES)
def test_greedy_tokens_agree_with_the_float_path_at_decisive_steps(mode):
    """The quantized and the float path decode the SAME (float argmax)
    trajectory, and their argmax must agree wherever the float logits'
    top-2 gap exceeds 10x the measured deviation (as tests/test_kv_quant.py
    does); at least half of 24 steps must qualify (int8 weights deviate
    ~3x more than the int8 cache, so 12 steps would leave too few)."""
    _, fm = _models("none", "f32")
    _, qm = _models(mode, "f32")
    ff, qf = fm._kv_functions(), qm._kv_functions()
    toks = torch.from_numpy(_toks([5, 2, 33])).long()
    fc, fl = ff.prefill(ff.init_cache(), toks, 3)
    qc, ql = qf.prefill(qf.init_cache(), toks, 3)
    tok, checked = int(fl.argmax()), 0
    for i in range(24):
        fc, fl = ff.step(fc, 3 + i, tok)
        qc, ql = qf.step(qc, 3 + i, tok)
        dev = float((fl - ql).abs().max())
        assert dev < 0.05, (i, dev)
        top2 = fl.topk(2).values
        if float(top2[0] - top2[1]) > 10 * max(dev, 1e-6):
            assert int(ql.argmax()) == int(fl.argmax()), i
            checked += 1
        tok = int(fl.argmax())
    assert checked >= 12, f"only {checked}/24 steps had a decisive gap"


@pytest.mark.parametrize("mode", MODES)
def test_generate_batch_and_engine_over_the_quantized_cache(mode):
    _, tm = _models(mode, "f32")
    reset_launch_counts()
    out = tm.generate([3, 1, 4], max_new_tokens=6)
    assert len(out) == 9 and all(0 <= t < 64 for t in out)
    outs = tm.generate_batch([[4, 5], [6], [7, 8, 9]], max_new_tokens=5)
    assert [len(o) for o in outs] == [7, 6, 8]
    assert [o[:len(p)] for o, p in zip(outs, [[4, 5], [6], [7, 8, 9]])] == \
        [[4, 5], [6], [7, 8, 9]]
    eng = InferenceEngine(tm, slots=2, steps_per_tick=3)
    specs = [([3, 7, 11], 9), ([2, 4, 6, 8, 10, 12], 5), ([1], 12)]
    reqs = [eng.submit(p, n) for p, n in specs]
    assert isinstance(eng._caches, tuple) == (mode != "serve")
    done = eng.run()
    assert len(done) == 3
    assert [r.n_generated for r in reqs] == [n for _, n in specs]
    assert all(0 <= t < 64 for r in reqs for t in r.tokens)
    # greedy: the engine's tokens are generate's on the same prompt
    assert reqs[0].tokens == tm.generate(specs[0][0], max_new_tokens=9)
    assert set(launch_counts().values()) == {0}    # the CPU launches none


def test_quantize_false_restores_the_float_path():
    _, fm = _models("none", "f32")
    _, tm = _models("both", "f32")
    tf = tm._kv_functions()
    assert isinstance(tf.init_cache(), tuple)
    tm.quantize_serving(False).quantize_kv(False)
    assert not hasattr(tm, "_kv_fns")
    tf, ff = tm._kv_functions(), fm._kv_functions()
    assert "head#q" not in tf.step.params and "stack#scales" not in \
        tf.step.params
    toks = torch.from_numpy(_toks(PROMPT)).long()
    tc, tl = tf.prefill(tf.init_cache(), toks, 5)
    fc, fl = ff.prefill(ff.init_cache(), toks, 5)
    assert torch.equal(tl, fl) and torch.equal(tc, fc)
    assert torch.equal(tf.step(tc, 5, 9)[1], ff.step(fc, 5, 9)[1])
