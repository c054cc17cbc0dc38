"""Compiled KV decoding on the card: CUDA graphs captured and replayed.

Every test here needs an NVIDIA GPU and skips without one.  This file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_compiled_decoding_cuda.py

Held here, at tiny shapes on the card's kernels (the flash forward, decode
attention and its batched form, the whole-stack decode kernel and its int8
instantiations): every ``ParamFn`` of GPT (packed stack and unrolled, f32,
bf16, int8 weights and cache), LLaMA and Mixtral replays its graph with the
eager ``.fn``'s logits and caches bit for bit; the loops, beam and
speculative search and the engine give the eager run's tokens, greedy and
sampled, under ``set_sync_debug_mode("error")``; the graphs' launches are
counted at each replay; the stack kernel's sync words stay reusable.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

GPT_CFG = dict(vocab_size=64, n_positions=32, n_embd=64, n_layer=2,
               n_head=1)
LLAMA_CFG = dict(vocab_size=61, hidden_size=32, intermediate_size=64,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=32,
                 sliding_window=8)
MIXTRAL = dict(num_local_experts=4, num_experts_per_tok=2)
PROMPT = [3, 8, 13, 18, 23]
PROMPTS = [[3, 8, 13, 18, 23], [1, 2, 3, 4, 5, 6, 7, 9], [40]]
NEW = 8
SAMPLED = dict(temperature=0.9, top_k=7, top_p=0.9)
VARIANTS = ("packed", "unrolled", "bf16", "int8", "llama", "mixtral")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph of the card's kernels "
                    "has no CPU mode")
    return torch.device("cuda")


def _eager(monkeypatch):
    from lightgrad_tpu_torch.models import decoding

    monkeypatch.setattr(decoding.ParamFn, "__call__",
                        lambda self, *a: self.fn(self.params, *a))


def _model(variant, dev):
    from lightgrad_tpu_torch import GPT, GPTConfig
    from lightgrad_tpu_torch import random as lrandom
    from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig

    if variant in ("llama", "mixtral"):
        lrandom.seed(2)
        m = Llama(LlamaConfig(**dict(
            LLAMA_CFG, **(MIXTRAL if variant == "mixtral" else {}))))
        m._kv_fns = m._kv_functions()
        return m
    m = GPT(GPTConfig(**GPT_CFG), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(3.0)
    if variant == "bf16":
        m.to(torch.bfloat16)
    if variant == "int8":
        m.quantize_serving().quantize_kv()
    m._kv_fns = m._kv_functions(pack_stack=variant != "unrolled")
    return m


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("variant", VARIANTS)
def test_paramfns_replay_eager_bit_for_bit(card, variant):
    """prefill, step, extend and step_batch: a graph a signature, its
    replays bit for bit the eager ``.fn``'s logits and caches, its
    launches counted at each replay."""
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    m = _model(variant, card)
    fns = m._kv_fns
    toks = torch.zeros(32, dtype=torch.long, device=card)
    toks[:5] = torch.tensor(PROMPT, device=card)
    ref, got = fns.init_cache(), fns.init_cache()
    for n in (5, 3, 7):
        _, want = fns.prefill.fn(fns.prefill.params, ref, toks, n)
        _, have = fns.prefill(got, toks, n)
        assert torch.equal(want, have) and _same(ref, got), n
    for i in range(4):
        _, want = fns.step.fn(fns.step.params, ref, 7 + i, 5 + i)
        _, have = fns.step(got, 7 + i, 5 + i)
        assert torch.equal(want, have) and _same(ref, got), i
    if fns.extend is not None:
        for pos0 in (12, 14, 16):
            rows = torch.tensor([4, pos0, 15], device=card)
            _, want = fns.extend.fn(fns.extend.params, ref, pos0, rows)
            _, have = fns.extend(got, pos0, rows)
            assert torch.equal(want, have) and _same(ref, got)
    refs, gots = (fns.init_cache(), fns.init_cache())
    from lightgrad_tpu_torch.models.decoding import stacked_zeros
    refs, gots = stacked_zeros(refs, 3), stacked_zeros(gots, 3)
    for r in range(3):
        poss = torch.tensor([4 + r, 9, 30 + r], dtype=torch.int32,
                            device=card)
        tk = torch.tensor([1 + r, 2, 3], device=card)
        _, want = fns.step_batch.fn(fns.step_batch.params, refs, poss, tk)
        _, have = fns.step_batch(gots, poss, tk)
        assert torch.equal(want, have) and _same(refs, gots), r
    for pf in (fns.prefill, fns.step, fns.step_batch):
        assert pf.captures == 1
        (g,) = pf.graphs()
        assert g["capture_s"] > 0 and (g["nodes"] is None or g["nodes"] > 0)
    launches = fns.step.graphs()[0]["launches"]
    assert launches, "the step's graph launched no counted kernel"
    reset_launch_counts()
    fns.step(got, 11, 3)
    counts = launch_counts()
    assert all(counts[k] == n for k, n in launches.items()), counts


def _loops(m, draft):
    from lightgrad_tpu_torch.models import decoding as d

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return {
            "device": d.generate_device(m, PROMPT, NEW),
            "device sampled": d.generate_device(m, PROMPT, NEW, seed=4,
                                                **SAMPLED),
            "batch device": d.generate_batch_device(m, PROMPTS, NEW),
            "batch device sampled": d.generate_batch_device(
                m, PROMPTS, NEW, seed=2, **SAMPLED),
            "spec device": d.generate_speculative_device(m, draft, PROMPT,
                                                         NEW, k=3),
            "spec device sampled": d.generate_speculative_device(
                m, draft, PROMPT, NEW, k=2, temperature=0.9, seed=6),
        } | _host_loops(m, draft)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _host_loops(m, draft):
    from lightgrad_tpu_torch.models import decoding as d

    torch.cuda.set_sync_debug_mode(0)
    return {"batch": d.generate_batch(m, PROMPTS, NEW),
            "beam": d.beam_search(m, PROMPT, NEW, beam_size=3),
            "spec": d.generate_speculative(m, draft, PROMPT, NEW, k=3),
            "generate": m.generate(PROMPT, max_new_tokens=NEW)}


@pytest.mark.parametrize("variant", ["packed", "bf16", "int8", "llama"])
def test_loops_replay_eager_tokens(card, variant, monkeypatch):
    """The device loops under sync debug mode "error", the host loops,
    beam and speculative search: twice compiled, then eager, the same
    tokens, sampled ones too."""
    m = _model(variant, card)
    draft = m if variant != "llama" else _model("llama", card)
    first = _loops(m, draft)
    assert _loops(m, draft) == first
    _eager(monkeypatch)
    assert _loops(m, draft) == first


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("variant", ["packed", "llama"])
def test_engine_replays_eager_tokens(card, variant, steps, monkeypatch):
    """Compiled admission and ticks (homogeneous and mixed signatures) under
    sync debug mode "error": the eager engine's tokens."""
    from lightgrad_tpu_torch import InferenceEngine

    m = _model(variant, card)

    def run():
        eng = InferenceEngine(m, slots=3, steps_per_tick=steps,
                              rng=np.random.default_rng(1),
                              generator=torch.Generator(
                                  device=card).manual_seed(5))
        reqs = [eng.submit(p, 6 + i % 3) for i, p in enumerate(PROMPTS * 2)]
        reqs += [eng.submit(p, 5, **SAMPLED) for p in PROMPTS[:2]]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return [r.tokens for r in reqs]

    got = run()
    assert run() == got
    _eager(monkeypatch)
    assert run() == got


def test_stack_sync_words_stay_reusable(card):
    """Replayed stack-kernel calls leave the ticket words zeroed and the
    barrier count moved on, as an eager call does."""
    import importlib

    from lightgrad_tpu_torch.models import decoding as d

    decode_stack = importlib.import_module("lightgrad_tpu_torch.ops."
                                           "decode_stack")
    m = _model("packed", card)
    d.generate_device(m, PROMPT, NEW)
    sync = decode_stack._SYNC[card.index or 0]
    count = int(sync[:2].view(torch.int64))
    for _ in range(2):
        d.generate_device(m, PROMPT, NEW)
    torch.cuda.synchronize()
    assert int(sync[:2].view(torch.int64)) > count
    assert not sync[32:].any()


def test_t5_compiled_decoding_replays(card, monkeypatch):
    """T5's ``generate_compiled``: its step captured once, replayed by a
    second call, the eager ``.fn``'s tokens."""
    from lightgrad_tpu_torch import random as lrandom
    from lightgrad_tpu_torch.models import t5

    lrandom.seed(3)
    tm = t5.T5ForConditionalGeneration(t5.T5Config(
        vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=20, dropout_rate=0.0))
    src = np.random.default_rng(13).integers(2, 96, 8).astype(np.int32)
    a = tm.generate_compiled(src, max_new_tokens=6)
    b = tm.generate_compiled(src, max_new_tokens=6)
    (_, _, step), _ = tm._compiled_functions(7)
    assert step.captures == 1 and step.graphs()[0]["capture_s"] > 0
    np.testing.assert_array_equal(a, b)
    _eager(monkeypatch)
    np.testing.assert_array_equal(a, tm.generate_compiled(src,
                                                          max_new_tokens=6))


def test_engine_graphs_go_with_the_engine(card):
    """Engines of 2 to 4 slots over one model, one after another, each run
    twice (its admission and ticks captured, then replayed): once each is
    dropped, the memory allocated is back where it was after the first
    engine (its caches and its graphs' pool go with it), and the model's
    shared functions capture nothing for them."""
    import gc

    from lightgrad_tpu_torch import InferenceEngine

    m = _model("mixtral", card)
    fns = m._kv_fns

    def serve(slots):
        eng = InferenceEngine(m, slots=slots, steps_per_tick=2)
        for _ in range(2):
            reqs = [eng.submit(p, 4) for p in PROMPTS]
            eng.run()
            assert all(r.n_generated == 4 for r in reqs)
        assert eng._admit.graphs() and all(
            t.graphs() for t in eng._tick_fns.values())
        del eng
        gc.collect()
        torch.cuda.synchronize()

    serve(1)
    base = torch.cuda.memory_allocated(card)
    shared = [f.captures for f in fns.functions()]
    for slots in (2, 3, 4, 2):
        serve(slots)
        assert torch.cuda.memory_allocated(card) <= base
    assert [f.captures for f in fns.functions()] == shared
