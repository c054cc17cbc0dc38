"""Port parity: the LLaMA family on the lightgrad tape.  Tiny LLaMA (GQA
4:2), Mistral (window 8 below a 24-token sequence, as tests/test_mistral.py
bands it), Qwen2 (q/k/v biases) and Gemma (head dim 8, (1 + w) RMSNorm,
scaled embeddings, tied head, tanh-GELU) configurations, built by the JAX
package and carried across with ``load_numpy_params``.  Checked against the
JAX model: the forward logits (the fused flash branch, and the raw-score
branch), one AdamW step's gradients, greedy ``generate`` with and without
the cache, and the teacher-forced ``_kv_functions`` (prefill + cached
steps); and, on the port, ``generate_batch`` and the ``InferenceEngine``
against one-by-one ``generate``, ``map_parameters`` and weight reloads."""

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
from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig, RMSNorm
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

BASE = dict(vocab_size=61, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=32)
CONFIGS = {
    "llama": {},
    "mistral": dict(sliding_window=8),
    "qwen2": dict(attention_bias=True, num_key_value_heads=4),
    "gemma": dict(head_dim=8, hidden_act="gelu_pytorch_tanh", rms_offset=True,
                  scale_embeddings=True, tie_word_embeddings=True,
                  rms_norm_eps=1e-6),
}
B, S = 2, 24
# f32 through 2 layers: products and row sums in another order
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(name, **kw):
    return dict(BASE, **CONFIGS[name], **kw)


def _state(jm, seed):
    """The JAX model's parameters, RMSNorm weights perturbed (ones would
    hide Gemma's offset) and attention biases made nonzero."""
    rng = np.random.default_rng(seed)
    state = {}
    for n, p in jm.named_parameters():
        a = p.numpy()
        if "layernorm" in n or n == "norm.weight" or n.endswith(".bias"):
            a = rng.uniform(-0.5, 1.5, a.shape).astype(np.float32)
        state[n] = a
    return state


def _models(name, seed=0, **kw):
    np.random.seed(seed)
    jm = JLlama(JLlamaConfig(**_cfg(name, **kw)))
    state = _state(jm, seed)
    jm.load_parameters(state)
    tm = Llama(LlamaConfig(**_cfg(name, **kw)))
    lt.load_numpy_params(tm, state)
    assert [n for n, _ in tm.named_parameters()] == list(state)
    return jm, tm


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, BASE["vocab_size"], (B, S + 1)).astype(np.int32)


def _loss(T, pkg, model, ids):
    logits = model(T.from_numpy(ids[:, :-1], requires_grad=False))
    loss = pkg.loss.cross_entropy(
        logits.reshape(B * S, BASE["vocab_size"]),
        T.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False))
    return logits, loss


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_and_adamw_step_match_jax(name, mode):
    """The fused branch's logits and loss, every parameter's gradient, and
    every parameter after one AdamW step."""
    jm, tm = _models(name)
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
    assert tlogits.shape == (B, S, BASE["vocab_size"])
    np.testing.assert_allclose(tlogits.numpy(), jlogits.numpy(), **TOL)
    np.testing.assert_allclose(tloss.numpy(), jloss.numpy(), **TOL)
    jgrads = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n].grad.numpy(),
                                   err_msg=n, **TOL)
    jopt.step()
    topt.step()
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.numpy(), jgrads[n].numpy(), err_msg=n,
                                   **TOL)


@pytest.mark.parametrize("name", ["mistral", "gemma"])
def test_raw_score_branch_matches_jax(name, monkeypatch):
    """A tensor type without a fused ``attention`` op takes the raw-score
    branch: the materialised scores, the additive causal / band mask and the
    softmax, with the grouped K/V gathered; the same logits and gradients as
    the JAX model's."""
    jm, tm = _models(name, seed=2)
    ids = _ids(2)
    monkeypatch.delattr(TTensor, "attention")
    with jax_kernel_mode("xla"):
        jlogits, jloss = _loss(JTensor, light, jm, ids)
        jloss.backward()
    tlogits, tloss = _loss(TTensor, lt, tm, ids)
    tloss.backward()
    np.testing.assert_allclose(tlogits.numpy(), jlogits.numpy(), **TOL)
    jgrads = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n].grad.numpy(),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_generate_matches_jax(name):
    """Greedy tokens with the cache (prefill + steps, the Mistral prompt
    decoding past its band) and without it (a full forward a token)."""
    jm, tm = _models(name, seed=3)
    prompt = [int(t) for t in _ids(3)[0, :12]]
    with jax_kernel_mode("xla"):
        want = [int(t) for t in jm.generate(prompt, max_new_tokens=6)]
    assert tm.generate(prompt, max_new_tokens=6) == want
    assert tm.generate(prompt, max_new_tokens=6, use_cache=False) == want


def _forced(fns, seq, P, W, to_tok):
    init_cache, prefill, step = fns
    toks = np.zeros(W, np.int32)
    toks[:P] = seq[:P]
    cache, lg = prefill(init_cache(), to_tok(toks), P)
    rows = [np.asarray(lg, np.float32)]
    for pos in range(P, len(seq)):
        cache, lg = step(cache, pos, seq[pos])
        rows.append(np.asarray(lg, np.float32))
    return np.stack(rows)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_kv_functions_match_jax(name, mode):
    """Teacher-forced: a 10-token prefill, then cached steps to position 21
    (past Mistral's band of 8), each step's logits against the JAX
    package's ``_kv_functions``."""
    jm, tm = _models(name, seed=4)
    seq = [int(t) for t in _ids(4)[1, :22]]
    W = BASE["max_position_embeddings"]
    with jax_kernel_mode(mode):
        want = _forced(jm._kv_functions(), seq, 10, W, jnp.asarray)
    with torch.no_grad():
        got = _forced(tm._kv_functions(), seq, 10, W,
                      lambda a: torch.from_numpy(a).long())
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["mistral", "gemma"])
def test_generate_batch_and_engine_match_generate(name):
    """``generate_batch`` (one ``step_batch`` a round) and an engine of 2
    slots over 3 ragged requests give each prompt's one-by-one tokens."""
    _, tm = _models(name, seed=5)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, BASE["vocab_size"], n)]
               for n in (4, 13, 9)]
    want = [tm.generate(p, max_new_tokens=7) for p in prompts]
    assert tm.generate_batch(prompts, max_new_tokens=7) == want
    engine = lt.InferenceEngine(tm, slots=2)
    reqs = [engine.submit(p, 7) for p in prompts]
    engine.run()
    assert [r.tokens for r in reqs] == want


def test_reloaded_weights_reach_the_decode_functions():
    """``load_numpy_params`` into a model that has generated drops its
    decode functions: the next ``generate`` follows the new weights."""
    _, tm = _models("mistral", seed=6)
    _, other = _models("mistral", seed=7)
    prompt = [5, 9, 2, 40]
    tm.generate(prompt, max_new_tokens=4)
    assert hasattr(tm, "_kv_fns")
    lt.load_numpy_params(tm, {n: p.numpy()
                              for n, p in other.named_parameters()})
    assert not hasattr(tm, "_kv_fns")
    want = other.generate(prompt, max_new_tokens=8)
    assert tm.generate(prompt, max_new_tokens=8) == want
    assert tm.generate(prompt, max_new_tokens=8, use_cache=False) == want


def test_map_parameters_casts_and_drops_the_decode_functions():
    """``map_parameters`` rebinds every parameter (here to bf16, as the
    card serves); the decode functions are rebuilt over the new tensors
    and the cache takes their dtype."""
    _, tm = _models("gemma", seed=8)
    tm.generate([1, 2, 3], max_new_tokens=2)
    out = tm.map_parameters(lambda p: p.astype("bfloat16"))
    assert out is tm and not hasattr(tm, "_kv_fns")
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    toks = tm.generate([1, 2, 3], max_new_tokens=3)
    assert tm._kv_fns.init_cache().dtype == torch.bfloat16
    assert len(toks) == 6 and all(0 <= t < BASE["vocab_size"] for t in toks)


def test_rmsnorm_and_config_match_jax():
    """RMSNorm with Gemma's offset against numpy; the config's derived
    fields as the JAX package derives them (Mixtral's expert fields too,
    the scanned stack's), and experts with the scanned stack raise the JAX
    package's error."""
    x = np.random.default_rng(9).uniform(-2, 2, (3, 8)).astype(np.float32)
    norm = RMSNorm(8, eps=1e-6, offset=1.0)
    got = norm(TTensor.from_numpy(x, requires_grad=False)).numpy()
    want = x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6) * 2.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for kw in (dict(), dict(sliding_window=4096, use_sliding_window=False),
               dict(hidden_size=64, head_dim=None, num_key_value_heads=None),
               dict(num_local_experts=4, num_experts_per_tok=2)):
        a, b = LlamaConfig(**dict(BASE, **kw)), JLlamaConfig(**dict(BASE,
                                                                    **kw))
        for f in ("head_dim", "num_key_value_heads", "sliding_window",
                  "num_local_experts", "num_experts_per_tok"):
            assert getattr(a, f) == getattr(b, f), f
    for kw in (dict(scan_layers=True), dict(remat=True),
               dict(scan_layers=True, remat="dots")):
        a, b = LlamaConfig(**dict(BASE, **kw)), JLlamaConfig(**dict(BASE,
                                                                    **kw))
        assert (a.scan_layers, a.remat) == (b.scan_layers, b.remat)
    kw = dict(BASE, num_local_experts=4, scan_layers=True)
    with pytest.raises(ValueError, match="scan_layers") as port:
        LlamaConfig(**kw)
    with pytest.raises(ValueError, match="scan_layers") as jax_err:
        JLlamaConfig(**kw)
    assert str(port.value) == str(jax_err.value)
