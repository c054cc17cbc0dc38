"""Port parity: scanned stacks with rematerialisation.

The ``torch.nn`` GPT's ``ScannedBlocks`` and the tape's ``ScannedStack``
(LLaMA, BERT with the padding mask as an extra) against the JAX package's
scanned models, whose stacked ``named_parameters()`` load as they are:
parameter names and order, logits, one optimizer step, greedy
``generate`` and per-layer ``state_dict`` names.  Within the port, the
three remat modes (False, "full", "dots") and the unscanned model give
bitwise-equal losses and gradients on the CPU; "dots" launches no product
twice.  The JAX side runs in ``xla`` mode.  Tolerances: f32 logits 2e-5,
one step's parameters 1e-5 (the same math in another order).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import lightgrad_tpu as light
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models import GPT as JGPT, GPTConfig as JGPTConfig
from lightgrad_tpu.models.bert import BertConfig as JBertConfig
from lightgrad_tpu.models.bert import BertForMaskedLM as JBert
from lightgrad_tpu.models.llama import Llama as JLlama
from lightgrad_tpu.models.llama import LlamaConfig as JLlamaConfig
from lightgrad_tpu_torch import (GPT, GPTConfig, amp, load_numpy_params,
                                 loss, nn, optim)
from lightgrad_tpu_torch.autograd import Tensor
from lightgrad_tpu_torch.autograd.cuda import ops as cuda_ops
from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
from lightgrad_tpu_torch.scan import ScannedStack
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

GPT_CFG = dict(vocab_size=64, n_positions=16, n_embd=32, n_layer=3,
               n_head=2)
LLAMA_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
                 num_hidden_layers=3, num_attention_heads=2,
                 num_key_value_heads=1, max_position_embeddings=16)
BERT_CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=3,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=16)
REMATS = [False, "full", "dots"]
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_params(jm):
    return {n: np.asarray(t.data) for n, t in jm.named_parameters()}


def _ids(b=2, s=9, vocab=64, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


# --- the torch.nn GPT --------------------------------------------------------
def _gpt_pair(remat=False):
    np.random.seed(0)
    jm = JGPT(JGPTConfig(scan_layers=True, **GPT_CFG))
    tm = GPT(GPTConfig(scan_layers=True, remat=remat, **GPT_CFG),
             device="cpu")
    load_numpy_params(tm, _jax_params(jm))
    return jm, tm


def test_gpt_names_and_order_match_jax():
    jm, tm = _gpt_pair()
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert tm.h.ln_1__weight.shape == (3, 32)
    # per-layer state_dict names, as the unscanned models have them
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    np.random.seed(0)
    plain = JGPT(JGPTConfig(**GPT_CFG))
    assert sorted(tm.state_dict()) == sorted(plain.state_dict())
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), v,
                                      err_msg=k)


def test_gpt_logits_step_and_generate_match_jax():
    jm, tm = _gpt_pair(remat="dots")
    ids = _ids()
    x, y = ids[:, :-1], ids[:, 1:].reshape(-1)
    with jax_kernel_mode("xla"):
        jlogits = jm(JTensor.from_numpy(x, requires_grad=False))
        jloss = light.loss.cross_entropy(
            jlogits.reshape(-1, 64), JTensor.from_numpy(y,
                                                       requires_grad=False))
        jopt = light.optim.Adam(list(jm.parameters()), lr=1e-3, eps=1e-6)
        jopt.zero_grad()
        jloss.backward()
        jopt.step()
        jgen = jm.generate([3, 5, 7], max_new_tokens=5)
    logits = tm(torch.from_numpy(x).long())
    np.testing.assert_allclose(logits.detach().numpy(), jlogits.numpy(),
                               **LOGIT_TOL)
    opt = optim.Adam(tm.parameters(), lr=1e-3, eps=1e-6)
    lo = F.cross_entropy(logits.reshape(-1, 64), torch.from_numpy(y).long())
    opt.zero_grad()
    lo.backward()
    opt.step()
    np.testing.assert_allclose(lo.item(), jloss.item(), rtol=1e-5)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(dict(jm.named_parameters())[n]
                                              .data), err_msg=n, **STEP_TOL)
    assert tm.generate([3, 5, 7], max_new_tokens=5) == jgen


def _gpt_grads(m, ids):
    x = torch.from_numpy(ids[:, :-1]).long()
    y = torch.from_numpy(ids[:, 1:].reshape(-1)).long()
    lo = F.cross_entropy(m(x).reshape(-1, 64), y)
    names = [n for n, _ in m.named_parameters()]
    return lo.item(), dict(zip(names, torch.autograd.grad(
        lo, list(m.parameters()))))


def test_gpt_remat_modes_are_bitwise_the_unscanned_model():
    g = torch.Generator().manual_seed(0)
    ref = GPT(GPTConfig(**GPT_CFG), device="cpu", generator=g)
    ids = _ids()
    l0, g0 = _gpt_grads(ref, ids)
    for remat in REMATS:
        g = torch.Generator().manual_seed(0)
        m = GPT(GPTConfig(scan_layers=True, remat=remat, **GPT_CFG),
                device="cpu", generator=g)
        # one generator draws the same weights in either layout
        for k, v in ref.state_dict().items():
            assert torch.equal(m.state_dict()[k], v), k
        l1, g1 = _gpt_grads(m, ids)
        assert l1 == l0, remat
        for n, gr in g1.items():
            if not n.startswith("h."):
                assert torch.equal(gr, g0[n]), (remat, n)
                continue
            key = n[2:].replace("__", ".")
            for l in range(GPT_CFG["n_layer"]):
                assert torch.equal(gr[l], g0[f"h.{l}.{key}"]), (remat, n, l)


def test_gpt_dots_keeps_the_linears_products():
    """Under "dots" the backward recomputes no Linear (aten.addmm / mm of
    the forward); under "full" it does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func is torch.ops.aten.addmm.default
            return func(*args, **(kwargs or {}))

    ids = torch.from_numpy(_ids()).long()
    counts = {}
    for remat in REMATS:
        m = GPT(GPTConfig(scan_layers=True, remat=remat, **GPT_CFG),
                device="cpu")
        out = m(ids).sum()
        with Count() as c:
            out.backward()
        counts[remat] = c.n
    assert counts[False] == counts["dots"] == 0 < counts["full"], counts


def test_gpt_state_dict_loads_across_layouts():
    g = torch.Generator().manual_seed(3)
    ref = GPT(GPTConfig(**GPT_CFG), device="cpu", generator=g)
    sc = GPT(GPTConfig(scan_layers=True, **GPT_CFG), device="cpu")
    sc.load_state_dict(ref.state_dict())
    back = GPT(GPTConfig(**GPT_CFG), device="cpu")
    back.load_state_dict(sc.state_dict())
    ids = torch.from_numpy(_ids()).long()
    assert torch.equal(sc(ids), ref(ids))
    assert torch.equal(back(ids), ref(ids))
    with pytest.raises(RuntimeError, match="Unexpected"):
        sc.load_state_dict(dict(ref.state_dict(), **{"h.9.x": torch.ones(1)}))


def test_gpt_amp_over_the_scanned_stack_trains():
    m = GPT(GPTConfig(scan_layers=True, remat="dots", **GPT_CFG),
            device="cpu")
    mp = amp.MixedPrecision(m, lambda ps: optim.Adam(ps, lr=1e-2))
    assert m.h.attn__c_attn__weight.dtype == torch.bfloat16
    ids = _ids(s=9)
    x = torch.from_numpy(ids[:, :-1]).long()
    y = torch.from_numpy(ids[:, 1:].reshape(-1)).long()
    losses = []
    for _ in range(4):
        lo = F.cross_entropy(m(x).float().reshape(-1, 64), y)
        mp.zero_grad()
        lo.backward()
        mp.step()
        losses.append(lo.item())
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("bad", ["save_anything_except_these_names",
                                 "dots_savable", 2])
def test_unknown_remat_raises(bad):
    # the message names the accepted values and the one given
    match = f"{bad!r}.*'full', 'dots'.*'dots_saveable'"
    with pytest.raises(ValueError, match=match):
        GPT(GPTConfig(scan_layers=True, remat=bad, **GPT_CFG), device="cpu")
    with pytest.raises(ValueError, match=match):
        Llama(LlamaConfig(scan_layers=True, remat=bad, **LLAMA_CFG))


def test_experts_with_scan_raise_as_in_jax():
    with pytest.raises(ValueError, match="scan_layers"):
        LlamaConfig(scan_layers=True, num_local_experts=2)
    with pytest.raises(ValueError, match="scan_layers"):
        GPTConfig(scan_layers=True, n_experts=2)


# --- the tape: LLaMA and BERT ------------------------------------------------
def _llama_pair(remat=False):
    np.random.seed(0)
    jm = JLlama(JLlamaConfig(scan_layers=True, **LLAMA_CFG))
    tm = Llama(LlamaConfig(scan_layers=True, remat=remat, **LLAMA_CFG))
    load_numpy_params(tm, _jax_params(jm))
    return jm, tm


def _tape_loss(m, ids, jax=False):
    T = JTensor if jax else Tensor
    lossmod = light.loss if jax else loss
    x = T.from_numpy(ids[:, :-1], requires_grad=False)
    y = T.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False)
    return lossmod.cross_entropy(m(x).reshape(-1, 64), y)


def test_llama_matches_jax_scanned_model():
    jm, tm = _llama_pair(remat="full")
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    ids = _ids(seed=4)
    with jax_kernel_mode("xla"):
        jx = JTensor.from_numpy(ids[:, :-1], requires_grad=False)
        np.testing.assert_allclose(
            tm(Tensor.from_numpy(ids[:, :-1], requires_grad=False)).numpy(),
            jm(jx).numpy(), **LOGIT_TOL)
        jl = _tape_loss(jm, ids, jax=True)
        jopt = light.optim.AdamW(list(jm.parameters()), lr=1e-3, eps=1e-6)
        jopt.zero_grad()
        jl.backward()
        jopt.step()
        jgen = jm.generate([3, 5, 7], max_new_tokens=5)
    tl = _tape_loss(tm, ids)
    opt = optim.AdamW(list(tm.parameters()), lr=1e-3, eps=1e-6)
    opt.zero_grad()
    tl.backward()
    opt.step()
    np.testing.assert_allclose(tl.item(), jl.item(), rtol=1e-5)
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.numpy(), jp[n].numpy(), err_msg=n,
                                   **STEP_TOL)
    assert tm.generate([3, 5, 7], max_new_tokens=5) == jgen


def test_llama_remat_modes_are_bitwise_the_unscanned_model():
    from lightgrad_tpu_torch import random as lg_random

    lg_random.seed(0)
    ref = Llama(LlamaConfig(**LLAMA_CFG))
    ids = _ids(seed=5)
    l0 = _tape_loss(ref, ids)
    ref.zero_grad()
    l0.backward()
    g0 = {n: p.grad.numpy() for n, p in ref.named_parameters()}
    for remat in REMATS:
        m = Llama(LlamaConfig(scan_layers=True, remat=remat, **LLAMA_CFG))
        m.load_parameters(ref.state_dict())
        l1 = _tape_loss(m, ids)
        m.zero_grad()
        l1.backward()
        assert l1.item() == l0.item(), remat
        for n, p in m.named_parameters():
            g = p.grad.numpy()
            if not n.startswith("layers."):
                np.testing.assert_array_equal(g, g0[n], err_msg=n)
                continue
            key = n[len("layers."):].replace("__", ".")
            for l in range(LLAMA_CFG["num_hidden_layers"]):
                np.testing.assert_array_equal(g[l], g0[f"layers.{l}.{key}"],
                                              err_msg=f"{remat} {n} {l}")
        assert m.generate([3, 5, 7], max_new_tokens=4) == \
            ref.generate([3, 5, 7], max_new_tokens=4)


def test_tape_dots_replay_launches_no_product(monkeypatch):
    """A step's products (the matmul kernel's wrapper): "dots" launches as
    many as the unscanned model, "full" more (its replay)."""
    calls = {"n": 0}
    real = cuda_ops.kmatmul

    def counted(a, b):
        calls["n"] += 1
        return real(a, b)

    monkeypatch.setattr(cuda_ops, "kmatmul", counted)
    ids = _ids(seed=6)
    n = {}
    for remat in [None] + REMATS:
        kw = {} if remat is None else dict(scan_layers=True, remat=remat)
        m = Llama(LlamaConfig(**kw, **LLAMA_CFG))
        calls["n"] = 0
        _tape_loss(m, ids).backward()
        n[remat] = calls["n"]
    assert n[None] == n[False] == n["dots"] < n["full"], n


def test_tape_cast_module_reaches_the_stack():
    """amp.cast_module rebinds the stacked tensors through map_parameters;
    the stack's view follows, and MixedPrecision trains the scanned
    model."""
    m = Llama(LlamaConfig(scan_layers=True, remat="dots", **LLAMA_CFG))
    mp = amp.MixedPrecision(m, lambda ps: optim.Adam(ps, lr=1e-2))
    params = list(m.parameters())
    for n, t in m.layers._stacked.items():
        assert t.dtype == torch.bfloat16, n
        assert any(t is p for p in params), n
    ids = _ids(seed=7)
    losses = []
    for _ in range(4):
        lo = _tape_loss(m, ids)
        mp.zero_grad()
        lo.backward()
        mp.step()
        losses.append(lo.item())
    assert losses[-1] < losses[0], losses


def test_bert_scan_with_mask_matches_jax_and_the_loop():
    np.random.seed(0)
    jm = JBert(JBertConfig(scan_layers=True, **BERT_CFG))
    tm = BertForMaskedLM(BertConfig(scan_layers=True, remat="dots",
                                    **BERT_CFG))
    load_numpy_params(tm, _jax_params(jm))
    loop = BertForMaskedLM(BertConfig(**BERT_CFG))
    loop.load_parameters(tm.state_dict())
    ids = np.random.default_rng(3).integers(0, 64, (2, 8)).astype(np.int32)
    mask = np.array([[1] * 8, [1] * 5 + [0] * 3], np.float32)
    with jax_kernel_mode("xla"):
        want = jm(JTensor.from_numpy(ids, requires_grad=False),
                  attention_mask=JTensor.from_numpy(
                      mask, requires_grad=False)).numpy()

    def run(m):
        out = m(Tensor.from_numpy(ids, requires_grad=False),
                attention_mask=Tensor.from_numpy(mask, requires_grad=False))
        m.zero_grad()
        out.sum().backward()
        return out.numpy(), m.state_dict()

    got, _ = run(tm)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    ref, _ = run(loop)
    np.testing.assert_array_equal(got, ref)
    gl = {n: p.grad.numpy() for n, p in loop.named_parameters()}
    w = tm.bert.layer._stacked["attention.self.query.weight"]
    for l in range(3):
        np.testing.assert_array_equal(
            w.grad.numpy()[l],
            gl[f"bert.layer.{l}.attention.self.query.weight"])
    with pytest.raises(ValueError, match="attention_lengths"):
        tm(Tensor.from_numpy(ids, requires_grad=False),
           attention_lengths=Tensor.from_numpy(np.array([8, 5], np.int32),
                                               requires_grad=False))


def test_live_dropout_rejected():
    class Blk(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(8, 8)
            self.drop = nn.Dropout(0.5)

        def forward(self, x):
            return self.drop(self.lin(x))

    stack = ScannedStack([Blk(), Blk()])
    x = Tensor.from_numpy(np.ones((2, 8), np.float32), requires_grad=False)
    with pytest.raises(AssertionError, match="Dropout"):
        stack(x)
    stack.eval()
    assert stack(x).shape == (2, 8)


def test_stack_loads_stacked_and_per_layer_names():
    class Blk(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)

        def forward(self, x):
            return self.lin(x).relu() + x

    stack = ScannedStack([Blk() for _ in range(3)])
    sd = stack.state_dict("s")
    assert sorted(sd) == sorted(f"s.{l}.lin.{w}" for l in range(3)
                                for w in ("weight", "bias"))
    other = ScannedStack([Blk() for _ in range(3)])
    other.load_parameters(sd, prefix="s")
    for k, v in other.state_dict("s").items():
        np.testing.assert_array_equal(v, sd[k])
    stacked = {f"s.{k}": np.zeros(p.shape, np.float32)
               for k, p in other._params.items()}
    other.load_parameters(stacked, prefix="s")
    assert not any(v.any() for v in other.state_dict("s").values())


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_scanned_decode_functions_read_per_layer_views(mode):
    """Greedy generate of a scanned GPT and LLaMA equals the unscanned
    model's, float and under quantize_serving + quantize_kv (the int8
    copies are made from the per-layer views)."""
    from lightgrad_tpu_torch import random as lg_random

    gpts = [GPT(GPTConfig(**GPT_CFG, **kw), device="cpu",
                generator=torch.Generator().manual_seed(4))
            for kw in ({}, dict(scan_layers=True, remat="full"))]
    lg_random.seed(4)
    ll = Llama(LlamaConfig(**LLAMA_CFG))
    lls = Llama(LlamaConfig(scan_layers=True, **LLAMA_CFG))
    lls.load_parameters(ll.state_dict())
    for plain, scanned in (gpts, (ll, lls)):
        if mode == "int8":
            for m in (plain, scanned):
                m.quantize_serving().quantize_kv()
        want = plain.generate([3, 5, 7, 11], max_new_tokens=6)
        assert scanned.generate([3, 5, 7, 11], max_new_tokens=6) == want
        assert scanned.generate_device([3, 5, 7, 11], 6) == want


def test_scanned_llama_save_pretrained_writes_per_layer_names(tmp_path):
    from lightgrad_tpu_torch import random as lg_random

    lg_random.seed(5)
    plain = Llama(LlamaConfig(**LLAMA_CFG))
    scanned = Llama(LlamaConfig(scan_layers=True, **LLAMA_CFG))
    scanned.load_parameters(plain.state_dict())
    a = torch.load(plain.save_pretrained(str(tmp_path / "a")),
                   weights_only=True)
    b = torch.load(scanned.save_pretrained(str(tmp_path / "b")),
                   weights_only=True)
    assert sorted(a) == sorted(b)
    assert "model.layers.2.mlp.down_proj.weight" in b
    for k in a:
        assert torch.equal(a[k], b[k]), k
    back = Llama(LlamaConfig(scan_layers=True, **LLAMA_CFG))
    back.load_parameters(Llama.remap_hf_state(b))
    for k, v in plain.state_dict().items():
        np.testing.assert_array_equal(back.state_dict()[k], v, err_msg=k)
