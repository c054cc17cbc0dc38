"""Port parity: T5 on the lightgrad tape.  A small T5 at the JAX test's size
(vocab 96, d_model 32, d_kv 8, d_ff 64, 2 + 2 layers, 4 heads, 8 buckets,
max distance 20) built by the JAX package and carried across with
``load_numpy_params``, on 2 x 9 sources with a padding mask and 2 x 7
targets.  Checked against the JAX model: logits, loss and every gradient
(relu in pallas interpret and xla modes, gated-gelu with an untied head in
xla); cached ``generate`` against uncached, greedy and sampled; eager,
compiled and JAX's ``generate_compiled`` tokens, with and without a mask;
``beam_generate`` at beam 1 and 4 against JAX's; bf16 purity; the bucket
function; ``remap_hf_state`` / ``export_hf_state`` against JAX's and
``from_pretrained`` from a seeded ``LIGHTGRAD_CACHE``."""

import hashlib
import json

import numpy as np
import pytest
import torch

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models import t5 as jt5
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.models import t5 as tt5
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

CFG = dict(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
           num_decoder_layers=2, num_heads=4,
           relative_attention_num_buckets=8,
           relative_attention_max_distance=20, dropout_rate=0.0)
B, SRC, TGT = 2, 9, 7
TOL = dict(rtol=1e-4, atol=1e-5)


def _params(model):
    return {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}


def _models(seed=0, **kw):
    np.random.seed(seed)
    jm = jt5.T5ForConditionalGeneration(jt5.T5Config(**CFG, **kw))
    tm = tt5.T5ForConditionalGeneration(tt5.T5Config(**CFG, **kw))
    lt.load_numpy_params(tm, _params(jm))
    return jm, tm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(2, CFG["vocab_size"], (B, SRC)).astype(np.int32)
    am = np.ones((B, SRC), np.int32)
    am[1, 6:] = 0
    src[1, 6:] = 0
    labels = rng.integers(2, CFG["vocab_size"], (B, TGT)).astype(np.int32)
    return src, am, labels


def _step(T, pkg, model, src, am, labels):
    dec = model.shift_right(labels)
    logits = model(T.from_numpy(src, requires_grad=False),
                   T.from_numpy(dec, requires_grad=False),
                   attention_mask=T.from_numpy(am, requires_grad=False))
    loss = pkg.loss.cross_entropy(
        logits.reshape(B * TGT, CFG["vocab_size"]),
        T.from_numpy(labels.reshape(-1), requires_grad=False))
    model.zero_grad()
    loss.backward()
    return logits.numpy(), loss.numpy(), {
        n: p.grad.numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("ffn,tied,mode", [
    ("relu", True, "pallas"), ("relu", True, "xla"),
    ("gated-gelu", False, "xla")])
def test_logits_loss_and_gradients_match_jax(ffn, tied, mode):
    jm, tm = _models(feed_forward_proj=ffn, tie_word_embeddings=tied)
    src, am, labels = _batch()
    with jax_kernel_mode(mode):
        jl, jloss, jg = _step(JTensor, light, jm, src, am, labels)
    tl, tloss, tg = _step(TTensor, lt, tm, src, am, labels)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    assert sorted(tg) == sorted(jg)
    assert ("lm_head.weight" in tg) == (not tied)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], **TOL, err_msg=n)
    # the bias tables get their gradient through the bucket gather
    for stack in ("encoder", "decoder"):
        g = tg[f"{stack}.block.0.layer.0.SelfAttention."
               "relative_attention_bias.weight"]
        assert np.abs(g).max() > 0


def test_relative_position_bucket_is_the_jax_packages():
    rel = np.arange(300)[None, :] - np.arange(300)[:, None]
    for bidirectional in (True, False):
        for nb, md in ((8, 20), (32, 128)):
            np.testing.assert_array_equal(
                tt5._relative_position_bucket(rel, bidirectional, nb, md),
                jt5._relative_position_bucket(rel, bidirectional, nb, md))


def test_cached_generate_equals_uncached():
    _, tm = _models()
    src, am, _ = _batch(1)
    x = TTensor.from_numpy(src, requires_grad=False)
    amt = TTensor.from_numpy(am, requires_grad=False)
    for kw in ({}, {"attention_mask": amt}):
        fast = tm.generate(x, max_new_tokens=7, use_cache=True, **kw)
        slow = tm.generate(x, max_new_tokens=7, use_cache=False, **kw)
        np.testing.assert_array_equal(fast, slow)
    s1 = tm.generate(x, max_new_tokens=5, temperature=0.8,
                     rng=np.random.default_rng(0), use_cache=True)
    s2 = tm.generate(x, max_new_tokens=5, temperature=0.8,
                     rng=np.random.default_rng(0), use_cache=False)
    np.testing.assert_array_equal(s1, s2)


@pytest.mark.parametrize("masked", [False, True])
def test_compiled_generate_matches_eager_and_jax(masked):
    jm, tm = _models()
    rng = np.random.default_rng(13)
    src = rng.integers(2, CFG["vocab_size"], (1, 8)).astype(np.int32)
    am = np.ones((1, 8), np.int32)
    if masked:
        am[:, 6:] = 0
    kw = {"attention_mask": TTensor.from_numpy(am, requires_grad=False)} \
        if masked else {}
    jkw = {"attention_mask": JTensor.from_numpy(am, requires_grad=False)} \
        if masked else {}
    eager = tm.generate(TTensor.from_numpy(src, requires_grad=False),
                        max_new_tokens=6, **kw)[0]
    fast = tm.generate_compiled(src[0], max_new_tokens=6,
                                attention_mask=am[0] if masked else None)
    np.testing.assert_array_equal(fast, eager[:len(fast)])
    with jax_kernel_mode("xla"):
        jfast = jm.generate_compiled(src[0], max_new_tokens=6,
                                     attention_mask=am[0] if masked else None)
        jeager = jm.generate(JTensor.from_numpy(src, requires_grad=False),
                             max_new_tokens=6, **jkw)[0]
    np.testing.assert_array_equal(fast, jfast)
    np.testing.assert_array_equal(eager, jeager)
    # sampled: the same tokens from the same seed
    a = tm.generate_compiled(src[0], max_new_tokens=6, temperature=0.9,
                             rng=np.random.default_rng(3))
    with jax_kernel_mode("xla"):
        b = jm.generate_compiled(src[0], max_new_tokens=6, temperature=0.9,
                                 rng=np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_generate_matches_jax(beam):
    jm, tm = _models()
    rng = np.random.default_rng(12)
    src = rng.integers(2, CFG["vocab_size"], (1, 8)).astype(np.int32)
    got = tm.beam_generate(TTensor.from_numpy(src, requires_grad=False),
                           max_new_tokens=6, beam_size=beam)
    with jax_kernel_mode("xla"):
        want = jm.beam_generate(JTensor.from_numpy(src, requires_grad=False),
                                max_new_tokens=6, beam_size=beam)
    np.testing.assert_array_equal(got, want)
    if beam == 1:
        greedy = tm.generate(TTensor.from_numpy(src, requires_grad=False),
                             max_new_tokens=6)[0]
        np.testing.assert_array_equal(got, greedy[:len(got)])


def test_bf16_purity():
    """A bf16-cast T5 keeps its whole stream bf16: the bias and the masks
    are cast to the scores' dtype."""
    np.random.seed(7)
    cfg = tt5.T5Config(vocab_size=48, d_model=16, d_kv=4, d_ff=32,
                       num_layers=2, num_decoder_layers=2, num_heads=4,
                       relative_attention_num_buckets=8,
                       relative_attention_max_distance=10, dropout_rate=0.0)
    model = lt.amp.cast_module(tt5.T5ForConditionalGeneration(cfg),
                               torch.bfloat16)
    rng = np.random.default_rng(7)
    src = rng.integers(2, 48, (2, 6)).astype(np.int32)
    tgt = rng.integers(2, 48, (2, 4)).astype(np.int32)
    am = np.ones_like(src)
    am[:, 5:] = 0
    seen = []
    softmax = TTensor.softmax

    def spy(t, axis=-1):
        seen.append(t.dtype)
        return softmax(t, axis=axis)

    TTensor.softmax = spy
    try:
        logits = model(TTensor.from_numpy(src, requires_grad=False),
                       TTensor.from_numpy(tgt, requires_grad=False),
                       attention_mask=TTensor.from_numpy(
                           am, requires_grad=False))
    finally:
        TTensor.softmax = softmax
    assert logits.dtype == torch.bfloat16, logits.dtype
    assert seen and set(seen) == {torch.bfloat16}, seen
    assert np.isfinite(logits.numpy()).all()


def _hf_state(seed=0):
    """An HF-named T5 state of CFG (numpy f32), with the per-stack
    embedding views HF checkpoints carry."""
    np.random.seed(seed)
    st = dict(_params(jt5.T5ForConditionalGeneration(jt5.T5Config(**CFG))))
    st["encoder.embed_tokens.weight"] = st["shared.weight"]
    st["decoder.embed_tokens.weight"] = st["shared.weight"]
    return {k: np.array(v, np.float32) for k, v in st.items()}


def test_remap_and_export_match_jax():
    hf = _hf_state()
    want = jt5.T5ForConditionalGeneration.remap_hf_state(hf)
    got = tt5.T5ForConditionalGeneration.remap_hf_state(
        {k: torch.from_numpy(v) for k, v in hf.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    jm, tm = _models()
    assert sorted(got) == sorted(n for n, _ in tm.named_parameters())
    tm.load_parameters(got)
    jm.load_parameters(want)
    je, te = jm.export_hf_state(), tm.export_hf_state()
    assert sorted(je) == sorted(te)
    for k in je:
        assert np.array_equal(te[k], np.asarray(je[k])), k


def test_from_pretrained_reads_a_seeded_cache(tmp_path, monkeypatch):
    """Both packages' ``from_pretrained`` build the same T5 from an HF
    ``config.json`` and ``pytorch_model.bin`` under md5(url) in
    ``LIGHTGRAD_CACHE``; their logits agree."""
    hf = _hf_state(seed=1)
    url = "https://huggingface.co/tiny/t5/resolve/main/"

    def seed(name, data):
        key = hashlib.md5((url + name).encode()).hexdigest()
        (tmp_path / key).write_bytes(data)

    seed("config.json", json.dumps(dict(CFG, model_type="t5")).encode())
    torch.save({n: torch.from_numpy(a) for n, a in hf.items()},
               tmp_path / "bin")
    seed("pytorch_model.bin", (tmp_path / "bin").read_bytes())
    monkeypatch.setenv("LIGHTGRAD_CACHE", str(tmp_path))
    model, cfg = tt5.T5ForConditionalGeneration.from_pretrained("tiny/t5")
    assert cfg.num_heads == CFG["num_heads"]
    jmodel, _ = jt5.T5ForConditionalGeneration.from_pretrained("tiny/t5")
    jparams = _params(jmodel)
    for n, p in model.named_parameters():
        assert np.array_equal(p.numpy(), jparams[n]), n
    src, am, labels = _batch(3)
    dec = model.shift_right(labels)
    with jax_kernel_mode("xla"):
        jl = jmodel(JTensor.from_numpy(src, requires_grad=False),
                    JTensor.from_numpy(dec, requires_grad=False)).numpy()
    tl = model(TTensor.from_numpy(src, requires_grad=False),
               TTensor.from_numpy(dec, requires_grad=False)).numpy()
    np.testing.assert_allclose(tl, jl, **TOL)
