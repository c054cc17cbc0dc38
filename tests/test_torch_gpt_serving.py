"""Port parity of the GPT-2 serving slice: a tiny GPT built by the JAX
package, carried across with ``load_numpy_params``, and driven through both
packages -- forward, prefill, cached steps on both the packed-stack and the
unrolled branch, extend, step_batch, generation and the serving engine."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.autograd import Tensor, no_grad
from lightgrad_tpu.models import GPT as JaxGPT
from lightgrad_tpu.models import GPTConfig as JaxGPTConfig
from lightgrad_tpu.serving import InferenceEngine as JaxEngine
from lightgrad_tpu_torch import (GPT, GPTConfig, InferenceEngine,
                                 load_numpy_params)
from lightgrad_tpu_torch.models.decoding import _device_sample
from lightgrad_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     runtime)
from tests.torch_port import jax_kernel_mode, to_np

CFG = dict(vocab_size=64, n_positions=64, n_embd=128, n_layer=2, n_head=2)
W = CFG["n_positions"]
# f32 on both sides; the JAX package's megakernel-vs-unrolled tolerance
TOL = dict(atol=2e-4, rtol=2e-4)
# branch -> (JAX kernel mode, the port's pack_stack): the packed branch runs
# the decode megakernel, the unrolled one the per-layer decode attention
BRANCHES = {"packed": ("pallas", None), "unrolled": ("xla", False)}


@pytest.fixture(scope="module")
def models():
    np.random.seed(11)
    jm = JaxGPT(JaxGPTConfig(**CFG))
    tm = GPT(GPTConfig(**CFG), device="cpu")
    load_numpy_params(tm, {n: np.asarray(t.data)
                           for n, t in jm.named_parameters()})
    return jm, tm


def _fns(jm, tm, branch):
    mode, pack = BRANCHES[branch]
    with jax_kernel_mode(mode):
        jf = jm._kv_functions()
    tf = tm._kv_functions(pack_stack=pack)
    assert ("stack#slabs" in jf.step.params) == (branch == "packed")
    assert ("stack#slabs" in tf.step.params) == (branch == "packed")
    return jf, tf


def _prefill_both(jf, tf, prompt):
    toks = np.zeros(W, np.int32)
    toks[:len(prompt)] = prompt
    jc, jl = jf.prefill(jf.init_cache(), jnp.asarray(toks), len(prompt))
    tc, tl = tf.prefill(tf.init_cache(), torch.from_numpy(toks).long(),
                        len(prompt))
    return jc, jl, tc, tl


def test_load_numpy_params_checks_names_and_shapes(models):
    _, tm = models
    named = {n: to_np(t) for n, t in tm.named_parameters()}
    with pytest.raises(KeyError):
        load_numpy_params(tm, {k: v for k, v in named.items()
                               if k != "ln_f.bias"})
    bad = dict(named, **{"ln_f.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        load_numpy_params(tm, bad)


def test_forward_logits_match_jax(models):
    jm, tm = models
    ids = np.random.default_rng(0).integers(0, 64, (2, 12)).astype(np.int32)
    with no_grad():
        want = jm(Tensor.from_numpy(ids, requires_grad=False)).numpy()
    got = tm(torch.from_numpy(ids).long())
    np.testing.assert_allclose(to_np(got), want, **TOL)


@pytest.mark.parametrize("branch", ["packed", "unrolled"])
def test_prefill_and_teacher_forced_steps_match_jax(models, branch):
    jm, tm = models
    jf, tf = _fns(jm, tm, branch)
    prompt = [3, 7, 11, 19, 2]
    with jax_kernel_mode(BRANCHES[branch][0]):
        jc, jl, tc, tl = _prefill_both(jf, tf, prompt)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
        np.testing.assert_allclose(to_np(tc), np.asarray(jc), **TOL)
        forced = np.random.default_rng(1).integers(0, 64, 6)
        for i, tok in enumerate(forced):
            pos = len(prompt) + i
            jc, jl = jf.step(jc, jnp.int32(pos), jnp.int32(tok))
            tc, tl = tf.step(tc, pos, int(tok))
            np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
            np.testing.assert_allclose(to_np(tc), np.asarray(jc), **TOL)


@pytest.mark.parametrize("branch", ["packed", "unrolled"])
def test_extend_matches_sequential_steps_and_jax(models, branch):
    jm, tm = models
    jf, tf = _fns(jm, tm, branch)
    prompt = [5, 1, 9]
    toks = np.array([4, 8, 15, 16], np.int32)
    with jax_kernel_mode(BRANCHES[branch][0]):
        jc, _, tc, _ = _prefill_both(jf, tf, prompt)
        seq_c = tc.clone()
        jc, jl = jf.extend(jc, jnp.int32(len(prompt)), jnp.asarray(toks))
    tc, tl = tf.extend(tc, len(prompt), torch.from_numpy(toks).long())
    assert tl.shape == (4, 64)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), **TOL)
    for i, tok in enumerate(toks):
        seq_c, lg = tf.step(seq_c, len(prompt) + i, int(tok))
        np.testing.assert_allclose(to_np(lg), to_np(tl[i]), **TOL)
    np.testing.assert_allclose(to_np(seq_c), to_np(tc), **TOL)


@pytest.mark.parametrize("branch", ["packed", "unrolled"])
def test_step_batch_matches_jax(models, branch):
    jm, tm = models
    jf, tf = _fns(jm, tm, branch)
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5, 4, 3], [20, 21, 22, 23, 24]]
    with jax_kernel_mode(BRANCHES[branch][0]):
        pairs = [_prefill_both(jf, tf, pr) for pr in prompts]
        jcs = jnp.stack([p[0] for p in pairs])
        tcs = torch.stack([p[2] for p in pairs])
        poss = np.array([len(pr) for pr in prompts], np.int32)
        toks = np.array([30, 31, 32], np.int32)
        jcs, jl = jf.step_batch(jcs, jnp.asarray(poss), jnp.asarray(toks))
    tcs, tl = tf.step_batch(tcs, torch.from_numpy(poss),
                            torch.from_numpy(toks).long())
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(to_np(tcs), np.asarray(jcs), **TOL)


def test_greedy_generate_and_generate_batch_tokens_match_jax(models):
    jm, tm = models
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9]]
    want = [int(t) for t in jm.generate(prompts[0], max_new_tokens=10)]
    assert tm.generate(prompts[0], max_new_tokens=10) == want
    assert tm.generate(prompts[0], max_new_tokens=10, use_cache=False) == want
    want_b = jm.generate_batch(prompts, max_new_tokens=8)
    got_b = tm.generate_batch(prompts, max_new_tokens=8)
    assert got_b == [[int(t) for t in row] for row in want_b]


def test_engine_greedy_tokens_match_jax_engine(models):
    jm, tm = models
    specs = [([3, 7, 11], 9), ([2, 4, 6, 8, 10, 12], 5), ([1], 12)]
    got_e = InferenceEngine(tm, slots=2, steps_per_tick=4)
    want_e = JaxEngine(jm, slots=2, steps_per_tick=4)
    got = [got_e.submit(p, n) for p, n in specs]
    want = [want_e.submit(p, n) for p, n in specs]
    got_e.run()
    want_e.run()
    assert [r.tokens for r in got] == [[int(t) for t in r.tokens]
                                       for r in want]
    assert all(r.n_generated == n for r, (_, n) in zip(got, specs))
    assert got_e.stats["prefills"] == 3


def test_device_sample_truncations_and_sampling_engine(models):
    """Greedy, top-k=1 and a tiny top-p all pick the argmax; sampled tokens
    stay inside the top-k set; an engine of sampled requests completes."""
    logits = torch.from_numpy(
        np.random.default_rng(4).standard_normal((3, 64)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    top = logits.argmax(-1)
    assert torch.equal(_device_sample(logits, g, 0.0, 0, 0.0), top)
    assert torch.equal(_device_sample(logits, g, 1.0, 1, 0.0), top)
    assert torch.equal(_device_sample(logits, g, 1.0, 0, 1e-6), top)
    top5 = logits.topk(5, -1).indices
    for _ in range(20):
        ids = _device_sample(logits, g, 2.0, 5, 0.0)
        assert bool((top5 == ids[:, None]).any(-1).all())
    _, tm = models
    eng = InferenceEngine(tm, slots=2, steps_per_tick=3,
                          generator=torch.Generator().manual_seed(1))
    reqs = [eng.submit([1, 2, 3], 7, temperature=1.0, top_k=8),
            eng.submit([4, 5], 5, temperature=1.0, top_k=8)]
    eng.run()
    assert [r.n_generated for r in reqs] == [7, 5]
    assert all(0 <= t < 64 for r in reqs for t in r.tokens)


def test_cpu_run_launches_no_kernel(models):
    _, tm = models
    reset_launch_counts()
    tm.generate([1, 2, 3], max_new_tokens=3)
    tm._kv_functions(pack_stack=False).step(
        torch.zeros((2, 2, 2, W, 64)), 0, 1)
    tm.generate_batch([[1, 2], [3]], max_new_tokens=2)
    assert set(launch_counts().values()) == {0}, launch_counts()


def test_runtime_reports_cpu_dispatch():
    t = torch.zeros(2)
    assert runtime.device_kind(t) == "cpu"
    assert not runtime.kernels_in_use(t)
    if not torch.cuda.is_available():
        assert runtime.device_kind() == "cpu"
        assert runtime.device_name() == "cpu"


def test_import_leaves_jax_out():
    code = ("import sys, lightgrad_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'lightgrad_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
