"""Port parity: int8 serving of the LLaMA family -- ``quantize_serving``
(int8 weights, a scale an output channel), ``quantize_kv`` (an int8 cache
with f32 row scales) and both.

The tiny LLaMA / Mistral / Qwen2 / Gemma of tests/test_torch_llama.py and
the tiny Mixtral of tests/test_torch_mixtral.py, built by the JAX package
and carried across with ``load_numpy_params``.  Against the JAX model in the
same mode (its xla mode: the int8 paths are plain XLA there): the int8
weight bytes and their scales equal, the cache's dtypes, the teacher-forced
logits (prefill, then cached steps), and greedy tokens.  On the port:
``step_batch`` against ``step`` and beam search over the tuple cache, and
the modes dropping the decode functions.

Tolerance: float32 1e-4 on logits, the same int8 bytes dequantized by the
same products.  Under ``quantize_kv`` a K/V element that the two packages
compute 1e-7 apart may round to neighbouring int8 values when it lies on a
rounding boundary; 1e-3 covers one such step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgrad_tpu_torch as lt
from lightgrad_tpu.models.llama import Llama as JLlama
from lightgrad_tpu.models.llama import LlamaConfig as JLlamaConfig
from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
from tests.test_torch_llama import BASE, CONFIGS, _forced, _state
from tests.test_torch_mixtral import CFG as MIXTRAL
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

MODELS = {name: dict(BASE, **kw) for name, kw in CONFIGS.items()}
MODELS["mixtral"] = MIXTRAL
MODES = {"weights": (True, False), "cache": (False, True),
         "both": (True, True)}


def _models(name, seed):
    np.random.seed(seed)
    jm = JLlama(JLlamaConfig(**MODELS[name]))
    state = _state(jm, seed)
    jm.load_parameters(state)
    tm = Llama(LlamaConfig(**MODELS[name]))
    lt.load_numpy_params(tm, state)
    return jm, tm


def _quantize(model, mode):
    w, kv = MODES[mode]
    if w:
        model.quantize_serving()
    if kv:
        model.quantize_kv()
    return model


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(MODELS))
def test_int8_modes_match_jax(name, mode):
    jm, tm = _models(name, seed=11)
    _quantize(jm, mode)
    _quantize(tm, mode)
    vocab = MODELS[name]["vocab_size"]
    W = MODELS[name]["max_position_embeddings"]
    rng = np.random.default_rng(11)
    seq = [int(t) for t in rng.integers(0, vocab, 22)]
    with jax_kernel_mode("xla"):
        jfns = jm._kv_functions()
        want = _forced(jfns, seq, 10, W, jnp.asarray)
        jtoks = [int(t) for t in jm.generate(seq[:9], max_new_tokens=6)]
    tfns = tm._kv_functions()
    # the same int8 bytes and scales, the same names quantized
    jp, tp = jfns[1].params, tfns.prefill.params
    qnames = sorted(n for n in jp if n.endswith("#q"))
    assert qnames == sorted(n for n in tp if n.endswith("#q"))
    assert bool(qnames) == MODES[mode][0]
    for n in qnames:
        assert tp[n].dtype == torch.int8
        np.testing.assert_array_equal(tp[n].numpy(), np.asarray(jp[n]),
                                      err_msg=n)
        s = n[:-2] + "#s"
        np.testing.assert_array_equal(tp[s].numpy(), np.asarray(jp[s]),
                                      err_msg=s)
    assert not any("router" in n or "embed" in n or "w1" in n
                   for n in qnames)
    # the cache's dtypes
    jc, tc = jfns[0](), tfns.init_cache()
    if MODES[mode][1]:
        assert [str(c.dtype) for c in jc] == ["int8", "float32"]
        assert [c.dtype for c in tc] == [torch.int8, torch.float32]
        assert [tuple(c.shape) for c in tc] == [c.shape for c in jc]
    else:
        assert tc.dtype == torch.float32 and str(jc.dtype) == "float32"
    with torch.no_grad():
        got = _forced(tfns, seq, 10, W, lambda a: torch.from_numpy(a).long())
    tol = 1e-3 if MODES[mode][1] else 1e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert tm.generate(seq[:9], max_new_tokens=6) == jtoks


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["mistral", "gemma", "mixtral"])
def test_int8_batched_decoding_and_beams(name, mode):
    """``step_batch`` over three slots against three ``step``s (logits and
    every part of the cache), ``generate_batch`` against ``generate``, and
    beam search at beam 2 on the tuple cache against the JAX package's."""
    jm, tm = _models(name, seed=12)
    _quantize(jm, mode)
    tm.generate([1, 2, 3], max_new_tokens=2)
    assert hasattr(tm, "_kv_fns")
    _quantize(tm, mode)
    assert not hasattr(tm, "_kv_fns")
    fns = tm._kv_functions()
    vocab = MODELS[name]["vocab_size"]
    W = MODELS[name]["max_position_embeddings"]
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(0, vocab, n)]
               for n in (3, 11, 7)]
    caches = lt.models.decoding.stacked_zeros(fns.init_cache(), 3)
    with torch.no_grad():
        for i, pr in enumerate(prompts):
            toks = torch.zeros(W, dtype=torch.long)
            toks[:len(pr)] = torch.tensor(pr)
            fns.prefill(lt.models.decoding.cache_slot(caches, i), toks,
                        len(pr))
        single = lt.models.decoding.cache_map(torch.clone, caches)
        poss = torch.tensor([len(pr) for pr in prompts], dtype=torch.int32)
        toks = torch.tensor([5, 17, 40])
        caches, got = fns.step_batch(caches, poss, toks)
        want = torch.stack([fns.step(
            lt.models.decoding.cache_slot(single, i), int(poss[i]),
            int(toks[i]))[1] for i in range(3)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    # the written rows: float parts to 1e-4, int8 rows to one step (a row
    # computed 1e-7 apart in a batch may round the other way)
    for a, b in zip(*(c if isinstance(c, tuple) else (c,)
                      for c in (caches, single))):
        atol = 1 if a.dtype == torch.int8 else 1e-4
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=1e-4, atol=atol)
    assert tm.generate_batch(prompts, max_new_tokens=5) == [
        tm.generate(p, max_new_tokens=5) for p in prompts]
    with jax_kernel_mode("xla"):
        jbeam = [int(t) for t in jm.generate(prompts[1], max_new_tokens=5,
                                             num_beams=2)]
    assert tm.generate(prompts[1], max_new_tokens=5, num_beams=2) == jbeam
