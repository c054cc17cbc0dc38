"""Port parity: BERT masked-LM training on the lightgrad tape.  A small
BERT (2 layers, hidden 64, 2 heads, intermediate 128, vocab 97) built by
the JAX package and carried across with ``load_numpy_params``; a 2 x 16
batch with a padding mask (the materialised attention branch: the matmul,
softmax, elementwise and reduce kernels' plain versions) and masked-LM
labels (-100 elsewhere).  Checked against the JAX model: the logits,
step 1's gradient of every parameter, every parameter after 3 AdamW steps,
the unmasked (flash) branch's logits, and the ``attention_lengths`` branch's
valid-row logits and gradients."""

import numpy as np
import pytest

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models.bert import BertConfig as JBertConfig
from lightgrad_tpu.models.bert import BertForMaskedLM as JBertForMaskedLM
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

CFG = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128,
           max_position_embeddings=32, type_vocab_size=2)
B, S = 2, 16
# f32 through 2 layers: products and row sums in another order
TOL = dict(rtol=1e-4, atol=1e-5)
# Adam divides by sqrt(v): the key bias's gradient is 0 in exact arithmetic
# (softmax ignores a per-row constant), so both sides feed Adam rounding
# noise there; eps 1e-6 keeps that noise far below lr
LR, ADAM_EPS = 1e-3, 1e-6


def _models():
    np.random.seed(0)
    jm = JBertForMaskedLM(JBertConfig(**CFG))
    tm = BertForMaskedLM(BertConfig(**CFG))
    lt.load_numpy_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    lengths = np.array([S, 11])
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
    labels = np.full((B, S), -100, np.int32)
    for b in range(B):
        pick = rng.choice(lengths[b], max(1, int(0.15 * lengths[b])),
                          replace=False)
        labels[b, pick] = rng.integers(0, CFG["vocab_size"], pick.size)
    return ids, mask, labels.reshape(-1)


def _loss(T, pkg, model, ids, mask, labels):
    logits = model(T.from_numpy(ids, requires_grad=False),
                   attention_mask=None if mask is None else
                   T.from_numpy(mask, requires_grad=False))
    loss = pkg.loss.cross_entropy(
        logits.reshape(B * S, CFG["vocab_size"]),
        T.from_numpy(labels, requires_grad=False), ignore_index=-100)
    return logits, loss


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_logits_and_step1_gradients_match_jax(mode):
    jm, tm = _models()
    ids, mask, labels = _batch()
    with jax_kernel_mode(mode):
        jlogits, jloss = _loss(JTensor, light, jm, ids, mask, labels)
        jloss.backward()
    tlogits, tloss = _loss(TTensor, lt, tm, ids, mask, labels)
    tloss.backward()
    assert tlogits.shape == (B, S, CFG["vocab_size"])
    np.testing.assert_allclose(tlogits.numpy(), jlogits.numpy(), **TOL)
    np.testing.assert_allclose(tloss.numpy(), jloss.numpy(), **TOL)
    jgrads = dict(jm.named_parameters())
    names = [n for n, _ in tm.named_parameters()]
    assert names == list(jgrads)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].grad.numpy(),
                                   err_msg=name, **TOL)


def test_adamw_training_matches_jax():
    """3 AdamW steps on one batch: losses and every parameter."""
    jm, tm = _models()
    ids, mask, labels = _batch(1)
    jopt = light.optim.AdamW(list(jm.parameters()), lr=LR, eps=ADAM_EPS)
    topt = lt.optim.AdamW(list(tm.parameters()), lr=LR, eps=ADAM_EPS)
    jl, tl_ = [], []
    for _ in range(3):
        with jax_kernel_mode("xla"):
            _, jloss = _loss(JTensor, light, jm, ids, mask, labels)
            jopt.zero_grad()
            jloss.backward()
            jopt.step()
        _, tloss = _loss(TTensor, lt, tm, ids, mask, labels)
        topt.zero_grad()
        tloss.backward()
        topt.step()
        jl.append(jloss.item())
        tl_.append(tloss.item())
    assert tl_[-1] < tl_[0]
    np.testing.assert_allclose(tl_, jl, rtol=1e-4)
    jp = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.numpy(), jp[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_unmasked_forward_takes_the_flash_branch(mode, monkeypatch):
    """Without a mask, self-attention is the fused attention op; the logits
    match the JAX model's."""
    jm, tm = _models()
    ids, _, _ = _batch(2)
    calls = []
    orig = TTensor.attention
    monkeypatch.setattr(TTensor, "attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with jax_kernel_mode(mode):
        jlogits = jm(JTensor.from_numpy(ids, requires_grad=False))
    tlogits = tm(TTensor.from_numpy(ids, requires_grad=False))
    assert len(calls) == CFG["num_hidden_layers"]
    np.testing.assert_allclose(tlogits.numpy(), jlogits.numpy(), **TOL)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_attention_lengths_matches_jax(mode):
    """``attention_lengths`` (the flash kernels with per-example lengths)
    against the JAX model on the same branch: the valid rows' logits, the
    loss and step 1's gradient of every parameter; and the valid rows
    against the port's own padding-mask branch (tests/test_bert.py checks
    the JAX model so)."""
    jm, tm = _models()
    ids, mask, labels = _batch(3)
    lengths = mask.sum(1).astype(np.int32)
    valid = mask.astype(bool)

    def run(T, pkg, model):
        logits = model(T.from_numpy(ids, requires_grad=False),
                       attention_lengths=T.from_numpy(lengths,
                                                      requires_grad=False))
        loss = pkg.loss.cross_entropy(
            logits.reshape(B * S, CFG["vocab_size"]),
            T.from_numpy(labels, requires_grad=False), ignore_index=-100)
        loss.backward()
        return logits.numpy(), loss.numpy()

    with jax_kernel_mode(mode):
        jlogits, jloss = run(JTensor, light, jm)
    tlogits, tloss = run(TTensor, lt, tm)
    np.testing.assert_allclose(tlogits[valid], jlogits[valid], **TOL)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    jgrads = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].grad.numpy(),
                                   err_msg=name, **TOL)
    masked, _ = _loss(TTensor, lt, tm, ids, mask, labels)
    np.testing.assert_allclose(tlogits[valid], masked.numpy()[valid], **TOL)


def test_hf_names_round_trip():
    """export_hf_state gives the JAX model's HF names; remap_hf_state
    inverts it."""
    jm, tm = _models()
    exported = tm.export_hf_state()
    assert sorted(exported) == sorted(jm.export_hf_state())
    back = BertForMaskedLM.remap_hf_state(exported)
    assert sorted(back) == sorted(n for n, _ in tm.named_parameters())
