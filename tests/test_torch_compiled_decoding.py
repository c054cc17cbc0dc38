"""Compiled KV decoding (models/decoding.py ``ParamFn``, the device loops,
beam and speculative search, serving.py's engine, T5's ``generate_compiled``).

On the CPU a compiled function runs the same slot code as on the card, and
the "graph" is the function re-run over its slots at each call.  Held here:
- every ``ParamFn`` (prefill, step, extend, step_batch) of GPT (packed
  stack, unrolled, int8 cache, int8 weights and cache), LLaMA (GQA, a
  sliding window) and Mixtral against its own ``.fn`` called eagerly, bit
  for bit, over its record, compile and run calls;
- every loop and the engine compiled against the same loop with every
  ``ParamFn`` called through ``.fn``, bit for bit,
  greedy and sampled;
- the greedy loops against the JAX package's jitted ``generate_device``,
  ``generate_batch``, ``beam_search`` and engine, token for token, and the
  prefill's logits within ``LOGITS_TOL``;
- the captures: one a signature, none on a repeated ``generate_device``,
  again after a rebound parameter or ``invalidate_captures``, at most one a
  beam slot plus the prefill in beam search, one a bucket of prompt
  lengths in Mixtral's prefill; the graphs over freed caches dropped, an
  engine's graphs its own, and ``release_decoding``;
- a tape model's functions built again over weights ``load_parameters``
  rebinds, against the JAX package on the new weights;
- a model with sharded parameters builds its functions eager.
"""

import numpy as np
import pytest
import torch

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.models import GPT as JaxGPT
from lightgrad_tpu.models import GPTConfig as JaxGPTConfig
from lightgrad_tpu.models import decoding as jdec
from lightgrad_tpu.models import t5 as jt5
from lightgrad_tpu.models.llama import Llama as JLlama
from lightgrad_tpu.models.llama import LlamaConfig as JLlamaConfig
from lightgrad_tpu_torch import GPT, GPTConfig
from lightgrad_tpu_torch.models import decoding as tdec
from lightgrad_tpu_torch.models import t5 as tt5
from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
from tests.torch_port import (cpu_device, jax_kernel_mode,  # noqa: F401
                               one_thread)

GPT_CFG = dict(vocab_size=64, n_positions=32, n_embd=64, n_layer=2,
               n_head=1)
LLAMA_CFG = dict(vocab_size=61, hidden_size=32, intermediate_size=64,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=32,
                 sliding_window=8)
MIXTRAL = dict(num_local_experts=4, num_experts_per_tok=2)
T5_CFG = dict(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
              num_decoder_layers=2, num_heads=4,
              relative_attention_num_buckets=8,
              relative_attention_max_distance=20, dropout_rate=0.0)
# the prefill's last logits, port (plain versions) against the JAX
# package (xla mode), both float32
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = [3, 8, 13, 18, 23]
PROMPTS = [[3, 8, 13, 18, 23], [1, 2, 3, 4, 5, 6, 7, 9], [40]]
NEW = 8
SAMPLED = dict(temperature=0.9, top_k=7, top_p=0.9)
# variant -> (family, the port's pack_stack, quantization)
VARIANTS = {"packed": ("gpt", None, ()), "unrolled": ("gpt", False, ()),
            "kv": ("gpt", None, ("kv",)), "both": ("gpt", None, ("serve",
                                                              "kv")),
            "llama": ("llama", None, ()), "mixtral": ("mixtral", None, ())}


def _jax_model(family, seed):
    """A JAX model with seeded weights, scaled so that greedy choices are
    decisive, and its numpy state."""
    np.random.seed(seed)
    if family == "gpt":
        jm = JaxGPT(JaxGPTConfig(**GPT_CFG))
    else:
        jm = JLlama(JLlamaConfig(**dict(
            LLAMA_CFG, **(MIXTRAL if family == "mixtral" else {}))))
    state = {n: np.asarray(p.numpy()) * (1.0 if "norm" in n or "ln_" in n
                                         else 3.0)
             for n, p in jm.named_parameters()}
    jm.load_parameters(state)
    return jm, state


def _port_model(family, state, pack=None, quant=()):
    if family == "gpt":
        m = GPT(GPTConfig(**GPT_CFG), device="cpu")
    else:
        m = Llama(LlamaConfig(**dict(
            LLAMA_CFG, **(MIXTRAL if family == "mixtral" else {}))))
    lt.load_numpy_params(m, state)
    if "serve" in quant:
        m.quantize_serving()
    if "kv" in quant:
        m.quantize_kv()
    if family == "gpt":
        m._kv_fns = m._kv_functions(pack_stack=pack)
    return m


_MODELS = {}


def _model(variant):
    """The port's model of a variant, built once a module; its JAX twin
    under ``_MODELS[variant, "jax"]``."""
    if variant not in _MODELS:
        family, pack, quant = VARIANTS[variant]
        jm, state = _jax_model(family, {"gpt": 1, "llama": 2,
                                        "mixtral": 3}[family])
        _MODELS[variant, "jax"] = jm
        _MODELS[variant] = _port_model(family, state, pack, quant)
    return _MODELS[variant]


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _captures(fns):
    """Compiled signatures of every function the model's loops use."""
    return sum(pf.captures for pf in fns.functions())


# ---------------------------------------------------------------------------
# each ParamFn against its .fn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_paramfn_equals_fn_bit_for_bit(variant):
    """prefill, step (host ints and device scalars), extend and step_batch:
    three calls of one signature (record, compile, run) give the eager
    ``.fn``'s logits and caches bit for bit, and compile once."""
    m = _model(variant)
    fns = m._kv_functions(pack_stack=VARIANTS[variant][1]) \
        if VARIANTS[variant][0] == "gpt" else m._kv_functions()
    W = tdec._window(m)
    toks = torch.zeros(W, dtype=torch.long)
    toks[:len(PROMPT)] = torch.tensor(PROMPT)
    ref, got = fns.init_cache(), fns.init_cache()
    for n in (5, 3, 7):
        _, want = fns.prefill.fn(fns.prefill.params, ref, toks, n)
        _, have = fns.prefill(got, toks, n)
        assert torch.equal(want, have) and _same(ref, got)
    assert fns.prefill.captures == 1
    for i, pos in enumerate((7, 8, torch.tensor([9], dtype=torch.int32))):
        tok = 5 + i if i < 2 else torch.tensor([11])
        _, want = fns.step.fn(fns.step.params, ref, pos, tok)
        _, have = fns.step(got, pos, tok)
        assert torch.equal(want, have) and _same(ref, got), pos
    # the host int and the device position are two signatures
    assert fns.step.captures == 1
    if fns.extend is not None:
        for pos0 in (10, 12, 14):
            rows = torch.tensor([4, pos0, 15])
            _, want = fns.extend.fn(fns.extend.params, ref, pos0, rows)
            _, have = fns.extend(got, pos0, rows)
            assert torch.equal(want, have) and _same(ref, got)
        assert fns.extend.captures == 1
    refs, gots = (tdec.stacked_zeros(fns.init_cache(), 3) for _ in range(2))
    for r in range(3):
        poss = torch.tensor([4 + r, 9, 30 + r], dtype=torch.int32)
        tk = torch.tensor([1 + r, 2, 3])
        _, want = fns.step_batch.fn(fns.step_batch.params, refs, poss, tk)
        _, have = fns.step_batch(gots, poss, tk)
        assert torch.equal(want, have) and _same(refs, gots)
    assert fns.step_batch.captures == 1


# ---------------------------------------------------------------------------
# the loops, compiled against eager
# ---------------------------------------------------------------------------
def _run_loops(m, draft):
    """Every loop of the decoding module over ``m`` (and ``draft``)."""
    out = {
        "device": tdec.generate_device(m, PROMPT, NEW),
        "device sampled": tdec.generate_device(m, PROMPT, NEW, seed=4,
                                               **SAMPLED),
        "device eos": tdec.generate_device(m, PROMPT, NEW, eos_id=7),
        "batch device": tdec.generate_batch_device(m, PROMPTS, NEW),
        "batch device sampled": tdec.generate_batch_device(
            m, PROMPTS, NEW, seed=2, **SAMPLED),
        "batch": tdec.generate_batch(m, PROMPTS, NEW),
        "beam": tdec.beam_search(m, PROMPT, NEW, beam_size=3),
        "spec": tdec.generate_speculative(m, draft, PROMPT, NEW, k=3),
        "spec device": tdec.generate_speculative_device(m, draft, PROMPT,
                                                        NEW, k=3),
        "spec device sampled": tdec.generate_speculative_device(
            m, draft, PROMPT, NEW, k=2, temperature=0.9, seed=6),
        "generate": m.generate(PROMPT, max_new_tokens=NEW),
    }
    return out


@pytest.mark.parametrize("variant", ["packed", "unrolled", "both", "llama",
                                     "mixtral"])
def test_loops_compiled_equal_eager(variant, monkeypatch):
    """Each loop twice compiled (the second call replays what the first
    compiled), then through ``.fn``: the same tokens, sampled ones too."""
    m = _model(variant)
    draft = _model("packed" if VARIANTS[variant][0] == "gpt" else "llama")
    first = _run_loops(m, draft)
    assert _run_loops(m, draft) == first
    with monkeypatch.context() as mp:
        mp.setattr(tdec.ParamFn, "__call__",
                   lambda self, *a: self.fn(self.params, *a))
        assert _run_loops(m, draft) == first


def _engine_run(m, steps, sampled_too=True):
    eng = lt.InferenceEngine(m, slots=3, steps_per_tick=steps,
                             rng=np.random.default_rng(1),
                             generator=torch.Generator().manual_seed(5))
    reqs = [eng.submit(p, 6 + i % 3) for i, p in enumerate(PROMPTS * 2)]
    if sampled_too:
        # a second signature: ticks mix while both are in flight
        reqs += [eng.submit(p, 5, **SAMPLED) for p in PROMPTS[:2]]
    eng.run()
    return [r.tokens for r in reqs], eng


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("variant", ["packed", "llama"])
def test_engine_ticks_compiled_equal_eager(variant, steps, monkeypatch):
    """Engine ticks at ``steps_per_tick`` 1 and 4, homogeneous and mixed
    sampling signatures: compiled admission and ticks give the eager
    engine's tokens; one admission graph serves every slot."""
    m = _model(variant)
    got, eng = _engine_run(m, steps)
    # the engine's own admission, one for every slot
    assert eng._admit.captures == 1
    assert eng._step_batch.captures <= 1
    assert all(t.captures <= 1 for t in eng._tick_fns.values())
    assert _engine_run(m, steps)[0] == got
    with monkeypatch.context() as mp:
        mp.setattr(tdec.ParamFn, "__call__",
                   lambda self, *a: self.fn(self.params, *a))
        assert _engine_run(m, steps)[0] == got


# ---------------------------------------------------------------------------
# against the JAX package's jitted loops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["unrolled", "llama"])
def test_greedy_loops_match_jax(variant):
    """Greedy ``generate_device``, ``generate_batch``, ``beam_search`` and
    the engine: the JAX package's jitted programs' tokens, token for token;
    the prefill's logits within ``LOGITS_TOL``."""
    m = _model(variant)
    jm = _MODELS[variant, "jax"]
    with jax_kernel_mode("xla"):
        jinit, jprefill, _ = jm._kv_functions()
        W = tdec._window(m)
        jt = np.zeros(W, np.int32)
        jt[:len(PROMPT)] = PROMPT
        _, jl = jprefill(jinit(), jt, len(PROMPT))
        want = {"device": [int(t) for t in jdec.generate_device(
                    jm, PROMPT, NEW)],
                "batch": jdec.generate_batch(jm, PROMPTS, NEW),
                "beam": [int(t) for t in jdec.beam_search(
                    jm, PROMPT, NEW, beam_size=3)]}
        eng = light.serving.InferenceEngine(jm, slots=2)
        jreqs = [eng.submit(p, NEW) for p in PROMPTS]
        eng.run()
        want["engine"] = [[int(t) for t in r.tokens] for r in jreqs]
    fns = tdec._kv(m)
    toks = torch.zeros(W, dtype=torch.long)
    toks[:len(PROMPT)] = torch.tensor(PROMPT)
    for _ in range(3):
        _, tl = fns.prefill(fns.init_cache(), toks, len(PROMPT))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    for _ in range(2):      # the second replays
        assert tdec.generate_device(m, PROMPT, NEW) == want["device"]
        assert [[int(t) for t in r] for r in tdec.generate_batch(
            m, PROMPTS, NEW)] == [[int(t) for t in r] for r in want["batch"]]
        assert tdec.beam_search(m, PROMPT, NEW, beam_size=3) == want["beam"]
        e = lt.InferenceEngine(m, slots=2)
        reqs = [e.submit(p, NEW) for p in PROMPTS]
        e.run()
        assert [r.tokens for r in reqs] == want["engine"]


# ---------------------------------------------------------------------------
# captures
# ---------------------------------------------------------------------------
def test_one_capture_per_signature_and_none_on_a_repeat():
    """A repeated ``generate_device`` (greedy or sampled, any seed) replays
    what the first compiled: no capture; a new sampling signature or
    batch compiles its own loop body once."""
    family, pack, quant = VARIANTS["packed"]
    _, state = _jax_model(family, 1)
    m = _port_model(family, state, pack, quant)
    fns = m._kv_fns
    a = tdec.generate_device(m, PROMPT, NEW)
    assert _captures(fns) == 1      # the loop body (the prefill recorded)
    assert tdec.generate_device(m, PROMPT, NEW) == a
    n = _captures(fns)
    assert n == 2       # and the prefill into the kept slot
    for _ in range(2):
        assert tdec.generate_device(m, PROMPT, NEW) == a
        assert tdec.generate_device(m, [9, 9], NEW - 2)[:2] == [9, 9]
    assert _captures(fns) == n + 1          # the shorter output buffer
    s = tdec.generate_device(m, PROMPT, NEW, seed=1, **SAMPLED)
    assert _captures(fns) == n + 2
    assert tdec.generate_device(m, PROMPT, NEW, seed=2, **SAMPLED) != s
    assert tdec.generate_device(m, PROMPT, NEW, seed=1, **SAMPLED) == s
    assert _captures(fns) == n + 2
    tdec.generate_batch_device(m, PROMPTS, NEW)
    tdec.generate_batch_device(m, PROMPTS, NEW)
    # the admission (one for every slot) and the batched loop body
    assert _captures(fns) == n + 4


def test_rebound_parameter_and_invalidation_record_again():
    """A rebound ``.params`` entry, or ``invalidate_captures``, records and
    compiles again, and the new graph reads the new value."""
    _, state = _jax_model("gpt", 1)
    m = _port_model("gpt", state, False)
    fns = m._kv_fns
    cache = fns.init_cache()
    toks = torch.zeros(32, dtype=torch.long)
    toks[:5] = torch.tensor(PROMPT)
    fns.prefill(cache, toks, 5)
    for _ in range(3):
        fns.step(cache, 5, 7)
    assert fns.step.captures == 1
    fns.step.params["ln_f.bias"] = fns.step.params["ln_f.bias"] + 0.5
    for _ in range(3):
        _, got = fns.step(cache, 5, 7)
    assert fns.step.captures == 2
    _, want = fns.step.fn(fns.step.params, cache, 5, 7)
    assert torch.equal(got, want)
    lt.invalidate_captures()
    for _ in range(3):
        fns.step(cache, 5, 7)
    assert fns.step.captures == 3


def test_engines_of_other_slot_counts_keep_the_graphs_bounded():
    """Engines of 1 to 4 slots over one model, one after another: each
    compiles its own admission and tick once, the model's shared
    functions compile nothing for them, and a freed engine's caches take
    the signatures over them along when the next signature records."""
    m = _model("llama")
    fns = tdec._kv(m)
    shared = {id(f): f.captures for f in fns.functions()}
    for slots in (1, 2, 3, 4):
        eng = lt.InferenceEngine(m, slots=slots, steps_per_tick=2)
        reqs = [eng.submit(p, 4) for p in PROMPTS]
        eng.run()
        assert all(len(r.tokens) == len(p) + 4 for r, p in zip(reqs, PROMPTS))
        assert eng._admit.captures == 1 and len(eng._admit._sigs) == 1
        assert all(t.captures == 1 for t in eng._tick_fns.values())
    assert {id(f): f.captures for f in fns.functions()} == shared
    # a ParamFn over caches that are freed: the next record drops them
    step = tdec._own(fns.step)
    a, b = fns.init_cache(), fns.init_cache()
    for _ in range(3):
        step(a, 5, 7)
    del a
    step(b, 5, 7)
    assert step.captures == 1 and len(step._sigs) == 1
    step.release()
    assert not step._sigs


def test_release_decoding_drops_kept_state_and_graphs():
    """``release_decoding`` empties the loops' kept caches and every
    compiled signature; the next call records and compiles again and
    gives the same tokens."""
    family, pack, quant = VARIANTS["packed"]
    _, state = _jax_model(family, 1)
    m = _port_model(family, state, pack, quant)
    fns = m._kv_fns
    a = tdec.generate_device(m, PROMPT, NEW)
    assert tdec.generate_device(m, PROMPT, NEW) == a
    assert fns.workspace and any(f.graphs() for f in fns.functions())
    tdec.release_decoding(m)
    assert not fns.workspace and not any(f._sigs for f in fns.functions())
    for _ in range(2):
        assert tdec.generate_device(m, PROMPT, NEW) == a
    assert any(f.graphs() for f in fns.functions())


def test_mixtral_prefill_compiles_one_graph_a_bucket():
    """Mixtral's prefill routes a power-of-two bucket of rows: prompts of
    3 and 4 tokens share one graph, 5 takes another; each call equals the
    eager ``.fn`` bit for bit, and the bucket's logits and K/V rows are
    those of the prefill that routes all W rows."""
    m = _model("mixtral")
    fns = m._kv_functions()
    W = tdec._window(m)
    toks = torch.zeros(W, dtype=torch.long)
    toks[:len(PROMPT)] = torch.tensor(PROMPT)
    got, ref, full = (fns.init_cache() for _ in range(3))
    for n, caps in ((3, 0), (4, 1), (3, 1), (5, 1), (5, 2), (4, 2)):
        _, have = fns.prefill(got, toks, n)
        _, want = fns.prefill.fn(fns.prefill.params, ref, toks, n)
        assert torch.equal(have, want) and torch.equal(got, ref)
        assert fns.prefill.captures == caps, n
        _, all_w = fns.prefill.fn(fns.prefill.params, full, toks, n, W)
        torch.testing.assert_close(have, all_w, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[:, :, :, :n], full[:, :, :, :n],
                                   rtol=1e-5, atol=1e-5)
    admit = tdec._admit_program(fns)
    caches = tdec.stacked_zeros(fns.init_cache(), 2)
    for slot, n in ((0, 3), (1, 4), (0, 4), (1, 3)):
        admit(caches, slot, toks, n)
    assert admit.captures == 1


def test_load_parameters_rebuilds_tape_model_functions():
    """A LLaMA whose weights ``load_parameters`` rebinds decodes with the
    new ones: its functions are built again, and ``generate_device`` and
    the engine give the JAX package's greedy tokens on the new weights."""
    _, state = _jax_model("llama", 2)
    m = _port_model("llama", state)
    tdec.generate_device(m, PROMPT, NEW)
    tdec.generate_device(m, PROMPT, NEW)
    old = tdec._kv(m)
    new_state = {n: v * (1.0 if "norm" in n else -1.5)
                 for n, v in state.items()}
    m.load_parameters(new_state)
    got = tdec.generate_device(m, PROMPT, NEW)
    assert tdec._kv(m) is not old
    assert tdec.generate_device(m, PROMPT, NEW) == got
    jm, _ = _jax_model("llama", 2)
    jm.load_parameters(new_state)
    with jax_kernel_mode("xla"):
        want = [int(t) for t in jdec.generate_device(jm, PROMPT, NEW)]
    assert got == want
    e = lt.InferenceEngine(m, slots=2)
    reqs = [e.submit(PROMPT, NEW)]
    e.run()
    assert reqs[0].tokens == want


def test_beam_search_captures_stay_bounded():
    """Beam search steps its kept beam slots in place: the step compiles at
    most once a slot, the prefill once, over rounds and calls."""
    m = _model("unrolled")
    m._kv_fns = m._kv_functions(pack_stack=False)
    fns = m._kv_fns
    a = tdec.beam_search(m, PROMPT, 12, beam_size=3)
    assert tdec.beam_search(m, PROMPT, 12, beam_size=3) == a
    assert fns.step.captures <= 3 and fns.prefill.captures <= 1
    assert tdec.beam_search(m, [5, 6], 10, beam_size=3)[:2] == [5, 6]
    assert fns.step.captures <= 3 and fns.prefill.captures <= 1


# ---------------------------------------------------------------------------
# T5, the torch.nn GPT's recompute decode, sharded parameters
# ---------------------------------------------------------------------------
def test_t5_compiled_decoding_equals_eager_and_jax(monkeypatch):
    """``generate_compiled``: built once per weight set, its step compiled
    once and replayed by a second call; the eager ``.fn``'s tokens, the
    tape's cached ``generate``'s, and the JAX package's; rebuilt after
    ``load_parameters``."""
    np.random.seed(0)
    jm = jt5.T5ForConditionalGeneration(jt5.T5Config(**T5_CFG))
    tm = tt5.T5ForConditionalGeneration(tt5.T5Config(**T5_CFG))
    state = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    lt.load_numpy_params(tm, state)
    src = np.random.default_rng(13).integers(2, 96, 8).astype(np.int32)
    am = np.ones(8, np.int32)
    am[6:] = 0
    a = tm.generate_compiled(src, max_new_tokens=6, attention_mask=am)
    b = tm.generate_compiled(src, max_new_tokens=6, attention_mask=am)
    (_, _, step), _ = tm._compiled_functions(7)
    assert step.captures == 1
    np.testing.assert_array_equal(a, b)
    s = tm.generate_compiled(src, max_new_tokens=6, temperature=0.9,
                             rng=np.random.default_rng(3))
    with jax_kernel_mode("xla"):
        np.testing.assert_array_equal(a, jm.generate_compiled(
            src, max_new_tokens=6, attention_mask=am))
        np.testing.assert_array_equal(s, jm.generate_compiled(
            src, max_new_tokens=6, temperature=0.9,
            rng=np.random.default_rng(3)))
    eager = tm.generate(lt.Tensor.from_numpy(src[None], requires_grad=False),
                        max_new_tokens=6, attention_mask=lt.Tensor.from_numpy(
                            am[None], requires_grad=False))[0]
    np.testing.assert_array_equal(a, eager[:len(a)])
    with monkeypatch.context() as mp:
        mp.setattr(tdec.ParamFn, "__call__",
                   lambda self, *x: self.fn(self.params, *x))
        np.testing.assert_array_equal(a, tm.generate_compiled(
            src, max_new_tokens=6, attention_mask=am))
    tm.load_parameters({n: v * 1.5 for n, v in state.items()})
    tm.generate_compiled(src, max_new_tokens=6, attention_mask=am)
    (_, _, step2), _ = tm._compiled_functions(7)
    assert step2 is not step


def test_torch_nn_gpt_recompute_decode_is_compiled():
    """``generate(use_cache=False)`` runs the window's forward through
    ``jit``: one record and one compile, the cached decode's greedy
    tokens, and a rebound parameter records again."""
    _, state = _jax_model("gpt", 1)
    m = _port_model("gpt", state)
    want = m.generate(PROMPT, max_new_tokens=NEW)
    assert m.generate(PROMPT, max_new_tokens=NEW, use_cache=False) == want
    step = m._decode_fn
    assert len(step.cache) == 1 and next(iter(step.cache.values())).compiled
    m.ln_f.bias = torch.nn.Parameter(m.ln_f.bias.detach() + 0.0)
    assert m.generate(PROMPT, max_new_tokens=3, use_cache=False) == \
        want[:len(PROMPT) + 3]


def test_sharded_parameters_build_eager_functions():
    """A GPT whose parameters are ``DTensor``s (one gloo rank) builds eager
    functions, decided when they are built, and decodes as the whole
    model does."""
    import torch.distributed as dist

    from lightgrad_tpu_torch.parallel import make_mesh
    from lightgrad_tpu_torch.parallel.shard import GPT_TP_RULES, shard_module

    _, state = _jax_model("gpt", 1)
    whole = _port_model("gpt", state)
    want = tdec.generate_device(whole, PROMPT, NEW)
    assert whole._kv_fns.step.compiled
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        m = _port_model("gpt", state)
        del m._kv_fns
        shard_module(m, make_mesh(devices="cpu"), GPT_TP_RULES)
        fns = tdec._kv(m)
        assert not any(f.compiled for f in (fns.prefill, fns.step,
                                            fns.extend, fns.step_batch))
        assert tdec.generate_device(m, PROMPT, NEW) == want
    finally:
        dist.destroy_process_group()
