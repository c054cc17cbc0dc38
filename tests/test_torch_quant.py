"""Port parity of the tape's int8 quantization (``lightgrad_tpu_torch.quant``
and the CUDA backend's ``quant_linear`` op) against ``lightgrad_tpu.quant``:
weight quantization, the int8 x int8 dot's exact int32 sums, QuantLinear's
forward and straight-through backward, module conversion, checkpoints of
the int8 buffers, QAT, and a small BERT quantized on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models.bert import BertConfig as JBertConfig
from lightgrad_tpu.models.bert import BertForMaskedLM as JBertForMaskedLM
from lightgrad_tpu.quant import QuantLinear as JQuantLinear
from lightgrad_tpu.quant import quantize_module as jquantize_module
from lightgrad_tpu.quant import quantize_weight as jquantize_weight
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.autograd.cuda.ops import int8_matmul
from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from lightgrad_tpu_torch.quant import (QuantLinear, quantize_module,
                                       quantize_weight)
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

# f32 on both sides, the same int32 sums; the epilogue's products rounded
# in the same order
TOL = dict(rtol=1e-5, atol=1e-6)


def _pair_linear(seed, fin, fout, bias=True):
    """A JAX nn.Linear and the port's, carrying the same numpy weights."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1, 1, (fout, fin)).astype(np.float32) / np.sqrt(fin)
    b = rng.uniform(-1, 1, fout).astype(np.float32) if bias else None
    jl, tl = light.nn.Linear(fin, fout, bias=bias), lt.nn.Linear(
        fin, fout, bias=bias)
    named = {"weight": w} if b is None else {"weight": w, "bias": b}
    jl.load_parameters(named)
    tl.load_parameters(named)
    return jl, tl


@pytest.mark.parametrize("dead", [False, True])
def test_quantize_weight_bit_exact_vs_jax(dead):
    w = np.random.default_rng(1).uniform(-2, 2, (32, 64)).astype(np.float32)
    if dead:
        w[3] = 0.0
        w[7, :] = 1e-30
    got_q, got_s = quantize_weight(w)
    want_q, want_s = jquantize_weight(w)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s, want_s)
    if dead:
        assert got_s[3] == 0.0 and (got_q[3] == 0).all()


def test_int8_matmul_sums_exactly_where_float32_would_not():
    """in = 3072 (BERT-base's FFN output) with values near +-127: sums
    past 2^24, where a float32 accumulation rounds."""
    rng = np.random.default_rng(2)
    xq = rng.integers(100, 128, (8, 3072)).astype(np.int8)
    wq = rng.integers(100, 128, (16, 3072)).astype(np.int8)
    xq[1::2] *= -1
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(xq), jnp.asarray(wq), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32))
    assert np.abs(want).max() > 2 ** 24
    got = int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    f32 = torch.from_numpy(xq).float() @ torch.from_numpy(wq).float().T
    assert not np.array_equal(f32.numpy().astype(np.int64), want)


@pytest.mark.parametrize("shape", [(16, 64), (2, 5, 64)])
def test_quant_linear_forward_matches_jax(shape):
    jl, tl = _pair_linear(3, 64, 32)
    jq, tq = JQuantLinear.from_linear(jl), QuantLinear.from_linear(tl)
    assert tq.weight_q.dtype == torch.int8
    assert tq.weight_scale.dtype == torch.float32
    assert [n for n, _ in tq.named_parameters()] == ["bias"]
    x = np.random.default_rng(4).uniform(-1, 1, shape).astype(np.float32)
    want = jq(JTensor.from_numpy(x, requires_grad=False)).numpy()
    got = tq(TTensor.from_numpy(x, requires_grad=False)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # dynamic int8 activations stay within ~1% of the float layer
    ref = tl(TTensor.from_numpy(x, requires_grad=False)).numpy()
    assert np.abs(got - ref).mean() / np.abs(ref).mean() < 0.02


def test_quant_linear_straight_through_grads_match_jax():
    jl, tl = _pair_linear(5, 12, 6)
    jq, tq = JQuantLinear.from_linear(jl), QuantLinear.from_linear(tl)
    x = np.random.default_rng(6).uniform(-1, 1, (5, 12)).astype(np.float32)
    grads = []
    for T, q in ((JTensor, jq), (TTensor, tq)):
        xt = T.from_numpy(x)
        y = q(xt)
        (y * y).sum().backward()
        grads.append((xt.grad.numpy(), q.bias.grad.numpy()))
        assert q.weight_q.grad is None and q.weight_scale.grad is None
    for got, want in zip(grads[1], grads[0]):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_quantize_module_recursion_and_min_features():
    class Net(lt.nn.Module):
        def __init__(self):
            super().__init__()
            self.body = lt.nn.ModuleList(lt.nn.Linear(32, 32),
                                         lt.nn.Linear(32, 32))
            self.head = lt.nn.Linear(32, 4)

        def forward(self, x):
            for layer in self.body:
                x = layer(x).relu()
            return self.head(x)

    lt.random.seed(7)
    net = Net()
    x = TTensor.uniform(-1, 1, (8, 32), requires_grad=False)
    y_f = net(x).numpy()
    assert quantize_module(net, min_features=8) is net
    assert isinstance(net.body[0], QuantLinear)
    assert isinstance(net.body[1], QuantLinear)
    assert isinstance(net.head, lt.nn.Linear)      # min dim 4 < 8
    assert isinstance(list(net.body)[1], QuantLinear)
    assert sorted(n for n, _ in net.named_buffers()) == [
        "body.0.weight_q", "body.0.weight_scale", "body.1.weight_q",
        "body.1.weight_scale"]
    y_q = net(x).numpy()
    cos = (y_f * y_q).sum() / (np.linalg.norm(y_f) * np.linalg.norm(y_q))
    assert cos > 0.99, cos


def test_state_dict_round_trips_the_int8_buffers():
    _, a = _pair_linear(8, 8, 8)
    _, b = _pair_linear(9, 8, 8)
    qa, qb = QuantLinear.from_linear(a), QuantLinear.from_linear(b)
    sd = qa.state_dict()
    assert set(sd) == {"weight_q", "weight_scale", "bias"}
    assert sd["weight_q"].dtype == np.int8
    qb.load_parameters(sd)
    assert qb.weight_q.dtype == torch.int8
    x = TTensor.uniform(-1, 1, (2, 8), requires_grad=False)
    np.testing.assert_array_equal(qa(x).numpy(), qb(x).numpy())
    # absent buffers keep their values, as in the JAX package
    qb.load_parameters({"bias": sd["bias"]})
    np.testing.assert_array_equal(qb.weight_q.numpy(), sd["weight_q"])


def test_quantized_model_still_learns_qat():
    lt.random.seed(3)
    net = lt.nn.Module()
    net.l1 = QuantLinear.from_linear(lt.nn.Linear(6, 16))
    net.l2 = lt.nn.Linear(16, 3)
    x = TTensor.uniform(-1, 1, (32, 6), requires_grad=False)
    yt = TTensor.uniform(-1, 1, (32, 3), requires_grad=False)
    opt = lt.optim.Adam(list(net.parameters()), lr=0.02)
    losses = []
    for _ in range(60):
        loss = lt.loss.mse(net.l2(net.l1(x).relu()), yt)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.7, losses[::10]


BERT = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=32, type_vocab_size=2)


def test_quantized_bert_matches_the_jax_bert_quantized_the_same_way():
    np.random.seed(0)
    jm = JBertForMaskedLM(JBertConfig(**BERT))
    tm = BertForMaskedLM(BertConfig(**BERT))
    lt.load_numpy_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    ids = np.random.default_rng(1).integers(0, 97, (2, 16)).astype(np.int32)
    float_logits = tm(TTensor.from_numpy(ids, requires_grad=False)).numpy()
    jquantize_module(jm, min_features=64)
    quantize_module(tm, min_features=64)
    jq = [n for n, _ in jm.named_buffers()]
    assert [n for n, _ in tm.named_buffers()] == jq and len(jq) == 2 * 14
    with jax_kernel_mode("xla"):
        want = jm(JTensor.from_numpy(ids, requires_grad=False)).numpy()
    got = tm(TTensor.from_numpy(ids, requires_grad=False)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    cos = (got * float_logits).sum() / (np.linalg.norm(got)
                                        * np.linalg.norm(float_logits))
    assert cos > 0.99, cos
