"""Port parity: the GPT-NeoX / Pythia family on the lightgrad tape.  Tiny
NeoX configurations (head dim 80, as Pythia-2.8B's) at rotary_pct 0.25,
0.5 and 1.0, parallel and serial residual, built by the JAX package
and carried across with ``load_numpy_params``.  Checked against the JAX
model: the forward logits (the attention op's branch and the raw-score
branch), one AdamW step's gradients and parameters (JAX in xla mode, and in
pallas mode with its fused flash backward beside the port's), greedy and
temperature ``generate``, and the HF state remap / export."""

import numpy as np
import pytest

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models.neox import NeoX as JNeoX
from lightgrad_tpu.models.neox import NeoXConfig as JNeoXConfig
from lightgrad_tpu.ops import attention as jax_attention
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.autograd.cuda import ops as tape_ops
from lightgrad_tpu_torch.models.neox import NeoX, NeoXConfig
from lightgrad_tpu_torch.ops import attention
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

# one width for all three (Pythia-2.8B's head dim 80: the fused kernel's D
# 128 instantiation at stride 80, 32 key rows a block, so a 40-token
# sequence sums two dq slabs); rot 20, 40 and 80
BASE = dict(vocab_size=61, hidden_size=160, intermediate_size=320,
            num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=32)
CONFIGS = {
    "pct25_parallel": dict(rotary_pct=0.25),
    "pct50_serial": dict(rotary_pct=0.5, use_parallel_residual=False),
    "pct100_parallel": dict(rotary_pct=1.0),
}
B, S = 2, 40
# f32 through 2 layers: products and row sums in another order
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(name):
    return dict(BASE, **CONFIGS[name])


def _models(name, seed=0):
    """The JAX model at ``name`` and the port's with its weights; the
    LayerNorm weights and every bias drawn anew (ones and zeros would hide
    a swapped or dropped one)."""
    np.random.seed(seed)
    jm = JNeoX(JNeoXConfig(**_cfg(name)))
    rng = np.random.default_rng(seed)
    state = {}
    for n, p in jm.named_parameters():
        a = p.numpy()
        if "layernorm" in n or n.endswith(".bias"):
            a = rng.uniform(-0.5, 1.5, a.shape).astype(np.float32)
        state[n] = a
    jm.load_parameters(state)
    tm = NeoX(NeoXConfig(**_cfg(name)))
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


def _assert_grads_match(jm, tm):
    jgrads = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n].grad.numpy(),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("mode", ["xla", "pallas_fused"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_and_adamw_step_match_jax(name, mode, monkeypatch):
    """The attention op's logits and loss, every parameter's gradient, and
    every parameter after one AdamW step.  ``pallas_fused``: JAX's Pallas
    kernels (interpret) with its fused flash backward, and the port's
    switch on.  The tape's backward goes through ``_flash_bwd``, the
    card's route, which on CPU tensors runs the plain versions: the fused
    kernel's once a layer under the switch, the two passes' without."""
    jm, tm = _models(name)
    ids = _ids(1)
    fused = mode == "pallas_fused"
    calls = []
    fused_bwd = attention.attention_bwd_fused
    monkeypatch.setattr(attention, "attention_bwd_fused",
                        lambda *a: calls.append(a[1].shape) or fused_bwd(*a))

    def card_route(g, q, k, v, scale, causal, out=None, lse=None,
                   lengths=None, window=0):
        return attention._flash_bwd(g, q, k, v, out, lse, scale, causal,
                                    lengths=lengths, window=window)

    monkeypatch.setattr(tape_ops, "kattn_bwd", card_route)
    jopt = light.optim.AdamW(list(jm.parameters()), lr=1e-3, eps=1e-6)
    topt = lt.optim.AdamW(list(tm.parameters()), lr=1e-3, eps=1e-6)
    jprev = jax_attention.set_flash_fused(fused)
    tprev = attention.set_flash_fused(fused)
    try:
        with jax_kernel_mode("pallas" if fused else "xla"):
            jlogits, jloss = _loss(JTensor, light, jm, ids)
            jopt.zero_grad()
            jloss.backward()
        tlogits, tloss = _loss(TTensor, lt, tm, ids)
        topt.zero_grad()
        tloss.backward()
    finally:
        jax_attention.set_flash_fused(jprev)
        attention.set_flash_fused(tprev)
    H = BASE["num_attention_heads"]
    hd = BASE["hidden_size"] // H
    assert calls == ([(B, H, S, hd)] * BASE["num_hidden_layers"]
                     if fused else [])
    assert tlogits.shape == (B, S, BASE["vocab_size"])
    np.testing.assert_allclose(tlogits.numpy(), jlogits.numpy(), **TOL)
    np.testing.assert_allclose(tloss.numpy(), jloss.numpy(), **TOL)
    _assert_grads_match(jm, tm)
    jopt.step()
    topt.step()
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.numpy(), jparams[n].numpy(), err_msg=n,
                                   **TOL)


@pytest.mark.parametrize("name", ["pct25_parallel", "pct50_serial"])
def test_raw_score_branch_matches_jax(name, monkeypatch):
    """A tensor type without a fused ``attention`` op takes the raw-score
    branch: the materialised scores, the additive causal mask and the
    softmax; the same logits and gradients as the JAX model's."""
    jm, tm = _models(name, seed=2)
    ids = _ids(2)
    monkeypatch.delattr(TTensor, "attention")
    with jax_kernel_mode("xla"):
        jlogits, jloss = _loss(JTensor, light, jm, ids)
        jloss.backward()
    tlogits, tloss = _loss(TTensor, lt, tm, ids)
    tloss.backward()
    np.testing.assert_allclose(tlogits.numpy(), jlogits.numpy(), **TOL)
    _assert_grads_match(jm, tm)


@pytest.mark.parametrize("name,prompt_len,temperature",
                         [("pct25_parallel", 10, 0.0),
                          ("pct50_serial", 30, 0.0),
                          ("pct100_parallel", 7, 0.8)])
def test_generate_matches_jax(name, prompt_len, temperature):
    """The fixed-window recompute decoding: greedy, the 30-token prompt
    running past the 32-token window, and temperature sampling from the
    same numpy stream."""
    jm, tm = _models(name, seed=3)
    prompt = [int(t) for t in _ids(3)[0, :prompt_len]]
    with jax_kernel_mode("xla"):
        want = jm.generate(prompt, max_new_tokens=5, temperature=temperature,
                           rng=np.random.default_rng(4))
    got = tm.generate(prompt, max_new_tokens=5, temperature=temperature,
                      rng=np.random.default_rng(4))
    assert got == [int(t) for t in want]
    assert len(got) == prompt_len + 5


def test_hf_state_remap_and_export_round_trip():
    """A synthetic HF-named state (the ``gpt_neox.`` prefix, the untied
    head without it, and the rotary / causal-mask buffers) remaps to the
    model's names as the JAX package's does, loads, and exports back to
    the same state less the buffers."""
    jm, tm = _models("pct50_serial", seed=5)
    hf = {("" if n.startswith("embed_out.") else "gpt_neox.") + n: a
          for n, a in tm.state_dict().items()}
    buffers = {"gpt_neox.layers.0.attention.rotary_emb.inv_freq":
               np.ones(8, np.float32),
               "gpt_neox.layers.1.attention.bias": np.ones((1, 1, 4, 4),
                                                           np.bool_),
               "gpt_neox.layers.1.attention.masked_bias": np.float32(-1e9)}
    remapped = NeoX.remap_hf_state({**hf, **buffers})
    assert list(remapped) == list(JNeoX.remap_hf_state({**hf, **buffers}))
    assert set(remapped) == {n for n, _ in tm.named_parameters()}
    _, fresh = _models("pct50_serial", seed=6)
    lt.load_numpy_params(fresh, remapped)
    exported = fresh.export_hf_state()
    assert list(exported) == list(jm.export_hf_state()) == list(hf)
    for n, a in hf.items():
        np.testing.assert_array_equal(exported[n], a, err_msg=n)


def test_config_matches_jax():
    """The config's defaults and fields as the JAX package's, HF's other
    keys accepted and dropped."""
    extra = dict(hidden_act="gelu", bos_token_id=0, tie_word_embeddings=False)
    for kw in (dict(), dict(_cfg("pct25_parallel"), **extra)):
        a, b = NeoXConfig(**kw), JNeoXConfig(**kw)
        assert vars(a) == vars(b)
    attn = NeoX(NeoXConfig(**_cfg("pct25_parallel"))).layers[0].attention
    assert (attn.head_dim, attn.rot) == (80, 20)
