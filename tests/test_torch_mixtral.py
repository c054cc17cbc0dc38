"""Port parity: Mixtral (LLaMA with routed experts, ``nn.MoE``) on the
lightgrad tape and in its decode functions.

The tiny Mixtral of tests/test_mixtral.py (4 experts, top-2, GQA 4:2),
built by the JAX package and carried across with ``load_numpy_params``.
Checked against the JAX model: the logits and both router losses, one
AdamW step's gradients and parameters (loss = cross-entropy + 0.01 aux +
0.001 z), greedy ``generate`` with and without the cache, and the
teacher-forced decode functions -- the port's one-pass prefill against
JAX's ``prefill_scan`` (the K/V rows at every valid position and the last
logits), then cached steps -- and beam search at beam 2.  On the port:
``step_batch`` against ``step``, ``generate_batch`` and
``generate_device`` / ``generate_batch_device`` against ``generate``.
Tolerance: float32 1e-4 (products summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models.llama import Llama as JLlama
from lightgrad_tpu.models.llama import LlamaConfig as JLlamaConfig
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

CFG = dict(vocab_size=48, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2,
           intermediate_size=48, max_position_embeddings=32,
           num_local_experts=4, num_experts_per_tok=2)
B, S = 2, 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _models(seed=0, **kw):
    np.random.seed(seed)
    cfg = dict(CFG, **kw)
    jm = JLlama(JLlamaConfig(**cfg))
    rng = np.random.default_rng(seed)
    state = {}
    for n, p in jm.named_parameters():
        a = p.numpy()
        if "layernorm" in n or n == "norm.weight":
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        state[n] = a
    jm.load_parameters(state)
    tm = Llama(LlamaConfig(**cfg))
    lt.load_numpy_params(tm, state)
    assert [n for n, _ in tm.named_parameters()] == list(state)
    return jm, tm


def _ids(seed=0, n=S + 1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG["vocab_size"], (B, n)).astype(np.int32)


def _loss(T, pkg, model, ids):
    logits = model(T.from_numpy(ids[:, :-1], requires_grad=False))
    ce = pkg.loss.cross_entropy(
        logits.reshape(B * S, CFG["vocab_size"]),
        T.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False))
    return logits, ce + model.aux_loss * 0.01 + model.z_loss * 0.001


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_logits_losses_and_adamw_step_match_jax(mode):
    jm, tm = _models()
    ids = _ids(1)
    jopt = light.optim.AdamW(list(jm.parameters()), lr=1e-3, eps=1e-6)
    topt = lt.optim.AdamW(list(tm.parameters()), lr=1e-3, eps=1e-6)
    with jax_kernel_mode(mode):
        jlogits, jloss = _loss(JTensor, light, jm, ids)
        jopt.zero_grad()
        jloss.backward()
    tlogits, tloss = _loss(TTensor, lt, tm, ids)
    topt.zero_grad()
    tloss.backward()
    np.testing.assert_allclose(tlogits.numpy(), jlogits.numpy(), **TOL)
    for name in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   getattr(jm, name).numpy(), err_msg=name,
                                   **TOL)
    np.testing.assert_allclose(tloss.numpy(), jloss.numpy(), **TOL)
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jparams[n].grad.numpy(),
                                   err_msg=n, **TOL)
    jopt.step()
    topt.step()
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.numpy(), jparams[n].numpy(), err_msg=n,
                                   **TOL)


def test_greedy_generate_matches_jax():
    """With the cache (one-pass prefill, then cached steps, every expert
    over the rows) and without it (a full tape forward a token)."""
    jm, tm = _models(seed=3)
    prompt = [int(t) for t in _ids(3)[0, :9]]
    with jax_kernel_mode("xla"):
        want = [int(t) for t in jm.generate(prompt, max_new_tokens=8)]
        assert [int(t) for t in jm.generate(
            prompt, max_new_tokens=8, use_cache=False)] == want
    assert tm.generate(prompt, max_new_tokens=8) == want
    assert tm.generate(prompt, max_new_tokens=8, use_cache=False) == want


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_one_pass_prefill_and_steps_match_jax_scan(mode):
    """Teacher-forced: the port's one-pass prefill of 10 tokens against the
    JAX package's ``prefill_scan`` (one step a position over the window):
    the same K/V rows at the 10 valid positions and the same last logits;
    then cached steps to position 21, each step's logits."""
    jm, tm = _models(seed=4)
    seq = [int(t) for t in _ids(4, n=22)[1]]
    W, P = CFG["max_position_embeddings"], 10
    toks = np.zeros(W, np.int32)
    toks[:P] = seq[:P]
    with jax_kernel_mode(mode):
        jinit, jprefill, jstep = jm._kv_functions()
        jcache, jlg = jprefill(jinit(), jnp.asarray(toks), P)
        jkv = np.asarray(jcache)[:, :, :, :P]
        want = [np.asarray(jlg)]
        for pos in range(P, len(seq)):
            jcache, jlg = jstep(jcache, jnp.int32(pos), jnp.int32(seq[pos]))
            want.append(np.asarray(jlg))
    with torch.no_grad():
        init, prefill, step = tm._kv_functions()
        cache, lg = prefill(init(), torch.from_numpy(toks).long(), P)
        np.testing.assert_allclose(cache[:, :, :, :P].numpy(), jkv, **TOL)
        got = [lg.numpy()]
        for pos in range(P, len(seq)):
            cache, lg = step(cache, pos, seq[pos])
            got.append(lg.numpy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), **TOL)


def test_step_batch_matches_single_steps():
    """Three slots at different positions through one ``step_batch``
    against three ``step``s: logits and the written K/V rows."""
    _, tm = _models(seed=5)
    fns = tm._kv_functions()
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, CFG["vocab_size"], n)]
               for n in (3, 11, 7)]
    W = CFG["max_position_embeddings"]
    caches = torch.zeros((3,) + tuple(fns.init_cache().shape))
    with torch.no_grad():
        for i, pr in enumerate(prompts):
            toks = torch.zeros(W, dtype=torch.long)
            toks[:len(pr)] = torch.tensor(pr)
            fns.prefill(caches[i], toks, len(pr))
        single = caches.clone()
        poss = torch.tensor([len(pr) for pr in prompts], dtype=torch.int32)
        toks = torch.tensor([5, 17, 40])
        caches, got = fns.step_batch(caches, poss, toks)
        want = torch.stack([fns.step(single[i], int(poss[i]),
                                     int(toks[i]))[1] for i in range(3)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(caches.numpy(), single.numpy(), **TOL)


def test_batched_and_device_decoding_match_generate():
    """``generate_batch``, ``generate_batch_device`` and the engine over
    ragged prompts, and ``generate_device``, give ``generate``'s tokens."""
    _, tm = _models(seed=6)
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(0, CFG["vocab_size"], n)]
               for n in (4, 13, 9)]
    want = [tm.generate(p, max_new_tokens=7) for p in prompts]
    assert tm.generate_batch(prompts, max_new_tokens=7) == want
    assert tm.generate_batch_device(prompts, max_new_tokens=7) == want
    assert [tm.generate_device(p, max_new_tokens=7)
            for p in prompts] == want
    engine = lt.InferenceEngine(tm, slots=2)
    reqs = [engine.submit(p, 7) for p in prompts]
    engine.run()
    assert [r.tokens for r in reqs] == want


def test_beam_search_matches_jax():
    jm, tm = _models(seed=7)
    prompt = [int(t) for t in _ids(7)[0, :6]]
    with jax_kernel_mode("xla"):
        want = [int(t) for t in jm.generate(prompt, max_new_tokens=6,
                                            num_beams=2)]
    assert tm.generate(prompt, max_new_tokens=6, num_beams=2) == want


def test_topk_gates_break_exact_ties_as_lax_top_k():
    """The decode functions' top-k: an exact tie goes to the lowest index,
    as ``lax.top_k`` (the JAX step's rule) gives it; the gates are the
    renormalised probabilities."""
    import jax

    from lightgrad_tpu_torch.models.llama import topk_gates

    probs = np.array([[0.2, 0.3, 0.3, 0.2],      # a tie for the top
                      [0.25, 0.25, 0.25, 0.25],  # all tied
                      [0.1, 0.2, 0.2, 0.5],      # a tie for second
                      [0.4, 0.1, 0.1, 0.4]], np.float32)
    gates, ids = topk_gates(torch.from_numpy(probs), 2)
    jvals, jids = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(
        gates.numpy(), np.asarray(jvals / jvals.sum(-1, keepdims=True)),
        rtol=1e-6)
