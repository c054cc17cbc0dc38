"""Port parity of the decoding module (models/decoding.py): whole-generation
decoding on the device, beam search and speculative decoding.

A tiny GPT and a tiny LLaMA (GQA 4:2, a window of 8) built by the JAX
package and trained a few steps there (so the logits are not flat), carried
across with ``load_numpy_params``, give the same greedy tokens through each
function of both packages: GPT on the packed-stack branch (JAX in Pallas
interpret mode) and the unrolled one (JAX in ``xla`` mode), under
``quantize_serving``, ``quantize_kv`` and both, and LLaMA.  Sampling: a
seed repeats, seeds differ, the exponential-race draw equals
``torch.multinomial`` from the same generator state (the top-k set:
tests/test_torch_gpt_serving.py), and the accept rules' marginal law is
the target's."""

import numpy as np
import pytest
import torch

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import TpuTensor
from lightgrad_tpu.models import GPT as JaxGPT
from lightgrad_tpu.models import GPTConfig as JaxGPTConfig
from lightgrad_tpu.models import decoding as jdec
from lightgrad_tpu.models.llama import Llama as JLlama
from lightgrad_tpu.models.llama import LlamaConfig as JLlamaConfig
from lightgrad_tpu_torch import GPT, GPTConfig
from lightgrad_tpu_torch.models import decoding as tdec
from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

GPT_CFG = dict(vocab_size=64, n_positions=64, n_embd=128, n_layer=2,
               n_head=2)
LLAMA_CFG = dict(vocab_size=61, hidden_size=32, intermediate_size=64,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=48,
                 sliding_window=8)
# variant -> (JAX kernel mode, the port's pack_stack, quantization): the
# packed branch runs the decode megakernel (its int8 instantiations under
# quantization), the unrolled one the per-layer decode attention.  The int8
# variants hold the port's packed branch against the JAX package's
# unrolled one: its Pallas programs compile for seconds a function here
VARIANTS = {"packed": ("pallas", None, ()),
            "unrolled": ("xla", False, ()),
            "serve": ("xla", None, ("serve",)),
            "kv": ("xla", None, ("kv",)),
            "both": ("xla", None, ("serve", "kv")),
            "llama": ("xla", None, ())}
# the JAX models' decode programs, dropped before another kernel mode
JAX_CACHES = ("_kv_fns", "_kv_batch_fns", "_dev_gen", "_dev_gen_batch",
              "_dev_spec", "_spec_verify", "_spec_verify_key")
NEW = 12


def _train(jm, seq, vocab, steps=30):
    """``steps`` Adam steps of next-token prediction on ``seq``, one
    compiled program (``light.jit``)."""
    opt = light.optim.Adam(jm.parameters(), lr=1e-2)
    x = TpuTensor.from_numpy(seq[None, :-1], requires_grad=False)
    y = TpuTensor.from_numpy(seq[1:], requires_grad=False)

    def step(a, b):
        loss = light.loss.cross_entropy(
            jm(a).reshape(len(seq) - 1, vocab), b)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss

    f = light.jit(step)
    losses = [float(f(x, y).numpy()) for _ in range(steps)]
    assert losses[-1] < 0.8 * losses[0], losses
    return {n: np.asarray(p.data) for n, p in jm.named_parameters()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops at these sizes gain nothing from intra-op
    threads, and beside the suite's other workers the threads' spinning
    makes each small op's latency many times larger."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def states():
    """Trained target states and untrained drafts of one layer, by family:
    numpy dicts of the JAX models' parameters."""
    np.random.seed(11)
    g_seq = (np.arange(41) * 5 % 64).astype(np.int32)
    gpt = _train(JaxGPT(JaxGPTConfig(**GPT_CFG)), g_seq, 64)
    np.random.seed(12)
    g_draft = {n: np.asarray(p.data) for n, p in
               JaxGPT(JaxGPTConfig(**dict(GPT_CFG, n_layer=1)))
               .named_parameters()}
    np.random.seed(13)
    l_seq = (np.arange(33) * 7 % 61).astype(np.int32)
    llama = _train(JLlama(JLlamaConfig(**LLAMA_CFG)), l_seq, 61)
    np.random.seed(14)
    l_draft = {n: p.numpy() for n, p in
               JLlama(JLlamaConfig(**dict(LLAMA_CFG, num_hidden_layers=1)))
               .named_parameters()}
    return {"gpt": (gpt, g_draft), "llama": (llama, l_draft)}


def _jax_model(family, state, **cut):
    if family == "gpt":
        m = JaxGPT(JaxGPTConfig(**dict(GPT_CFG, **cut)))
    else:
        m = JLlama(JLlamaConfig(**dict(LLAMA_CFG, **cut)))
    m.load_parameters(state)
    return m


def _port_model(family, state, **cut):
    if family == "gpt":
        m = GPT(GPTConfig(**dict(GPT_CFG, **cut)), device="cpu")
    else:
        m = Llama(LlamaConfig(**dict(LLAMA_CFG, **cut)))
    lt.load_numpy_params(m, state)
    return m


class Pair:
    """The JAX model and the port's twin of one variant (and their
    drafts), with each JAX result computed once per module."""

    def __init__(self, variant, states):
        self.mode, pack, quant = VARIANTS[variant]
        family = "llama" if variant == "llama" else "gpt"
        state, dstate = states[family]
        self.vocab = 61 if family == "llama" else 64
        self.jm, self.tm = (_jax_model(family, state),
                            _port_model(family, state))
        cut = ({"num_hidden_layers": 1} if family == "llama"
               else {"n_layer": 1})
        self.jd, self.td = (_jax_model(family, dstate, **cut),
                            _port_model(family, dstate, **cut))
        for m in (self.jm, self.tm):
            if "serve" in quant:
                m.quantize_serving()
            if "kv" in quant:
                m.quantize_kv()
        with jax_kernel_mode(self.mode):
            for m in (self.jm, self.jd):
                for a in JAX_CACHES:
                    m.__dict__.pop(a, None)
                m._kv_fns = m._kv_functions()
        if family == "gpt":
            self.tm._kv_fns = self.tm._kv_functions(pack_stack=pack)
            self.td._kv_fns = self.td._kv_functions(pack_stack=pack)
            assert ("stack#slabs" in self.tm._kv_fns.step.params) \
                == (pack is None)
            assert ("stack#slabs" in self.jm._kv_fns.step.params) \
                == (self.mode == "pallas")
        self.memo = {}

    def jax(self, key, fn):
        if key not in self.memo:
            with jax_kernel_mode(self.mode):
                self.memo[key] = [int(t) for t in fn()]
        return self.memo[key]


_PAIRS = {}


@pytest.fixture(params=list(VARIANTS))
def pair(request, states):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = Pair(request.param, states)
    return _PAIRS[request.param]


PROMPT = [3, 8, 13, 18, 23]
PROMPTS = [[3, 8, 13, 18, 23], [1, 2, 3, 4, 5, 6, 7, 9], [40]]


def _greedy(pr):
    return pr.jax("greedy", lambda: jdec.generate_device(pr.jm, PROMPT, NEW))


def test_generate_device_greedy_matches_jax(pair):
    """Greedy ``generate_device`` equals the JAX package's, and the port's
    host loop ``generate``; with an eos that a greedy token hits, the same
    tokens up to it (the JAX package's own eos rule, held by its tests)."""
    want = _greedy(pair)
    got = tdec.generate_device(pair.tm, PROMPT, NEW)
    assert got == want
    assert pair.tm.generate(PROMPT, max_new_tokens=NEW) == want
    eos = want[len(PROMPT) + 3]
    want_e = want[:want.index(eos, len(PROMPT)) + 1]
    assert tdec.generate_device(pair.tm, PROMPT, NEW, eos_id=eos) == want_e


def test_generate_batch_device_matches_jax(pair):
    """Ragged prompts: the JAX package's batched device decode, and the
    port's single runs row by row."""
    want = pair.jax("batch", lambda: sum(jdec.generate_batch_device(
        pair.jm, PROMPTS, 8), []))
    got = tdec.generate_batch_device(pair.tm, PROMPTS, 8)
    assert sum(got, []) == want
    assert got == [tdec.generate_device(pair.tm, p, 8) for p in PROMPTS]


def test_generate_batch_device_without_step_batch(states):
    """A model with no batched step: each slot steps in turn, with the
    batched run's tokens."""
    pr = _PAIRS.get("unrolled") or Pair("unrolled", states)
    want = tdec.generate_batch_device(pr.tm, PROMPTS, 8)
    fns = pr.tm._kv_fns
    step_batch, fns.step_batch = fns.step_batch, None
    try:
        assert tdec.generate_batch_device(pr.tm, PROMPTS, 8) == want
    finally:
        fns.step_batch = step_batch


def test_beam_search_matches_jax(pair):
    """Beam 1 (greedy), beam 3, and beam 3 with the greedy first token as
    eos, through ``generate(num_beams=...)`` where it routes there."""
    greedy = _greedy(pair)
    assert tdec.beam_search(pair.tm, PROMPT, NEW, beam_size=1) == greedy
    want = pair.jax("beam3", lambda: jdec.beam_search(
        pair.jm, PROMPT, NEW, beam_size=3))
    assert pair.tm.generate(PROMPT, max_new_tokens=NEW, num_beams=3) == want
    eos = greedy[len(PROMPT)]
    want_e = pair.jax("beam3 eos", lambda: jdec.beam_search(
        pair.jm, PROMPT, NEW, beam_size=3, eos_id=eos, length_penalty=0.0))
    assert tdec.beam_search(pair.tm, PROMPT, NEW, beam_size=3, eos_id=eos,
                            length_penalty=0.0) == want_e


@pytest.mark.parametrize("k", [1, 3])
def test_speculative_matches_jax(pair, k):
    """Greedy speculative decoding, host loop and device loop, against an
    untrained one-layer draft: the JAX package's tokens (its two functions
    at k 3, where they equal its plain greedy decoding); the device loop
    reads the host once a round."""
    want = _greedy(pair)
    assert pair.jax("spec", lambda: jdec.generate_speculative(
        pair.jm, pair.jd, PROMPT, NEW, k=3)) == want
    assert pair.jax("spec device", lambda: jdec.generate_speculative_device(
        pair.jm, pair.jd, PROMPT, NEW, k=3)) == want
    assert tdec.generate_speculative(pair.tm, pair.td, PROMPT, NEW,
                                     k=k) == want
    tdec.host_transfers.clear()
    assert tdec.generate_speculative_device(pair.tm, pair.td, PROMPT, NEW,
                                            k=k) == want
    rounds = tdec.host_transfers["generate_speculative_device"] - 4
    assert 1 <= rounds <= NEW, tdec.host_transfers


def test_speculative_eos_and_self_draft(states):
    """With eos, and with the target as its own draft (every proposal
    accepted: NEW / (k + 1) rounds), both loops give greedy decoding."""
    pr = _PAIRS.get("packed") or Pair("packed", states)
    want = _greedy(pr)
    eos = want[len(PROMPT) + 4]
    want_e = want[:want.index(eos, len(PROMPT)) + 1]
    for fn in (tdec.generate_speculative, tdec.generate_speculative_device):
        assert fn(pr.tm, pr.td, PROMPT, NEW, k=3, eos_id=eos) == want_e
    tdec.host_transfers.clear()
    assert tdec.generate_speculative_device(pr.tm, pr.tm, PROMPT, NEW,
                                            k=3) == want
    assert tdec.host_transfers["generate_speculative_device"] == 4 + 3
    assert tdec.generate_speculative(pr.tm, pr.tm, PROMPT, NEW, k=3) == want


def test_beam_clones_a_shared_cache(states, monkeypatch):
    """Survivors that share a parent: the port's in-place cache is cloned
    for all but one of them before they step.  Beam 3 over 12 tokens takes
    that branch after the first round here (clones beyond the prefill's
    two), and equals the JAX package, whose caches are immutable.  Checked
    by mutation on a copy of the module: with the clone dropped, this
    test's tokens leave the JAX package's."""
    pr = _PAIRS.get("unrolled") or Pair("unrolled", states)
    clones = []
    cache_map = tdec.cache_map

    def counted(fn, cache):
        clones.append(fn)
        return cache_map(fn, cache)

    monkeypatch.setattr(tdec, "cache_map", counted)
    want = pr.jax("beam3", lambda: jdec.beam_search(pr.jm, PROMPT, NEW,
                                                    beam_size=3))
    assert tdec.beam_search(pr.tm, PROMPT, NEW, beam_size=3) == want
    assert len(clones) > 2, clones


def test_device_sample_equals_multinomial_under_one_generator():
    """The exponential-race draw gives ``torch.multinomial``'s ids from the
    same generator state, truncations included (the engine's sampled
    tokens are unchanged).  Greedy, the truncations' argmax cases and the
    top-k set: tests/test_torch_gpt_serving.py."""
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (5, 64)).astype(np.float32) * 3)
    for temp, tk, tp in ((1.0, 0, 0.0), (0.7, 9, 0.0), (1.3, 0, 0.8),
                         (0.9, 20, 0.9)):
        for seed in range(4):
            got = tdec._device_sample(logits, torch.Generator().manual_seed(
                seed), temp, tk, tp)
            lg = logits.clone()
            if tk:
                kth = lg.topk(tk, -1).values[:, -1:]
                lg = lg.masked_fill(lg < kth, float("-inf"))
            z = (lg - lg.max(-1, keepdim=True).values) / temp
            if tp:
                prob = torch.softmax(z, -1)
                ps, order = prob.sort(-1, descending=True)
                keep = torch.zeros_like(ps, dtype=torch.bool).scatter(
                    -1, order, ps.cumsum(-1) - ps < tp)
                z = z.masked_fill(~keep, float("-inf"))
            want = torch.multinomial(torch.softmax(z, -1), 1,
                                     generator=torch.Generator().manual_seed(
                                         seed))[:, 0]
            assert torch.equal(got, want), (temp, tk, tp, seed)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_sampled_device_decoding_repeats_under_its_seed(states, family):
    """Temperature / top-k / top-p on the device: a seed repeats, another
    seed differs, every id is in range; the batched and speculative device
    loops too."""
    pr = _PAIRS.get("packed" if family == "gpt" else "llama") \
        or Pair("packed" if family == "gpt" else "llama", states)
    kw = dict(temperature=0.9, top_k=7, top_p=0.9)
    a = tdec.generate_device(pr.tm, PROMPT, NEW, seed=11, **kw)
    assert a == tdec.generate_device(pr.tm, PROMPT, NEW, seed=11, **kw)
    assert a != tdec.generate_device(pr.tm, PROMPT, NEW, seed=12, **kw)
    assert len(a) == len(PROMPT) + NEW and all(0 <= t < pr.vocab for t in a)
    b = tdec.generate_batch_device(pr.tm, PROMPTS, 8, seed=3, **kw)
    assert b == tdec.generate_batch_device(pr.tm, PROMPTS, 8, seed=3, **kw)
    s = tdec.generate_speculative_device(pr.tm, pr.td, PROMPT, NEW, k=3,
                                         temperature=0.9, seed=5)
    assert s == tdec.generate_speculative_device(pr.tm, pr.td, PROMPT, NEW,
                                                 k=3, temperature=0.9, seed=5)
    assert len(s) == len(PROMPT) + NEW and all(0 <= t < pr.vocab for t in s)
    h = tdec.generate_speculative(pr.tm, pr.td, PROMPT, NEW, k=3,
                                  temperature=0.9)
    assert len(h) == len(PROMPT) + NEW and all(0 <= t < pr.vocab for t in h)


def test_speculative_accept_marginal_law():
    """Monte Carlo at the JAX package's sample count (its
    tests/test_gpt.py): the accept/resample rule's output marginal is the
    target distribution for an adversarially different draft, and equal
    distributions never resample."""
    p_d = np.array([0.70, 0.05, 0.05, 0.20])
    p_t = np.array([0.10, 0.40, 0.25, 0.25])
    rng = np.random.default_rng(0)
    n = 40_000
    counts = np.zeros(4)
    for _ in range(n):
        x = rng.choice(4, p=p_d)
        y, _ = tdec.speculative_accept(p_d, p_t, x, rng)
        counts[y] += 1
    np.testing.assert_allclose(counts / n, p_t, atol=0.01)
    for _ in range(200):
        x = rng.choice(4, p=p_t)
        y, ok = tdec.speculative_accept(p_t, p_t, x, rng)
        assert ok and y == x


def test_device_accept_rule_marginal_law():
    """The device loop's accept rule (k = 1): the emitted token's law is
    the target's, whether it is the accepted proposal or the residual
    resample; a draft equal to the target always accepts and then draws
    the bonus token from the target's next row."""
    p_d = torch.tensor([0.70, 0.05, 0.05, 0.20])
    p_t = torch.tensor([0.10, 0.40, 0.25, 0.25])
    g = torch.Generator().manual_seed(0)
    n = 5_000
    props = torch.multinomial(p_d, n, replacement=True, generator=g)
    dl = p_d.log()[None]
    trows = torch.stack([p_t.log(), p_t.log()])
    counts = np.zeros(4)
    for x in props.tolist():
        _, emit = tdec._accept_device(torch.tensor([x]), dl, trows, g, 1.0)
        counts[int(emit[0])] += 1
    np.testing.assert_allclose(counts / n, p_t.numpy(), atol=0.03)
    m, emit = tdec._accept_device(torch.tensor([2]), trows[:1], trows, g, 1.0)
    assert int(m) == 1 and int(emit[0]) == 2


@pytest.mark.parametrize("variant", ["packed", "unrolled", "both"])
def test_extend_at_a_tensor_position_equals_the_host_int(states, variant):
    """GPT's extend takes pos0 as an int32 tensor (the device speculative
    loop's), written through index tensors: the same logits and cache as
    the host int, on both branches and the int8 cache."""
    pr = _PAIRS.get(variant) or Pair(variant, states)
    fns = pr.tm._kv_fns
    toks = torch.zeros(64, dtype=torch.long)
    toks[:5] = torch.tensor(PROMPT)
    rows = torch.tensor([4, 8, 15, 16])
    caches = []
    for pos0 in (5, torch.tensor([5], dtype=torch.int32)):
        cache, _ = fns.prefill(fns.init_cache(), toks, 5)
        cache, lg = fns.extend(cache, pos0, rows)
        caches.append((cache, lg))
    (a, la), (b, lb) = caches
    assert torch.equal(la, lb)
    a, b = (c if isinstance(c, tuple) else (c,) for c in (a, b))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
