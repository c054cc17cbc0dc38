"""Port parity: LoRA (``lightgrad_tpu_torch.lora``) in both model worlds.

Mirrors the JAX package's tests/test_lora.py on the ``torch.nn`` GPT and on
the tape's LLaMA: the adapted model equals the base at init (exactly: B is
zero), only the adapters train, the merge is exact (f32 2e-5, as the JAX
test), and the adapter state round-trips.  Across packages: after
``apply_lora`` both GPTs carry the same names in the same order, load each
other's weights and adapters, and give the same logits (2e-5) and the same
adapters after two Adam steps (1e-5); ``A`` is uniform in +-1/sqrt(in).  As
in the JAX package, a scanned stack's Linears are not wrapped.  Over a
bfloat16 base the adapters stay float32 and are the only parameters that
train.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import lightgrad_tpu as light
from lightgrad_tpu import lora as jlora
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models import GPT as JGPT, GPTConfig as JGPTConfig
from lightgrad_tpu_torch import (GPT, GPTConfig, amp, load_numpy_params,
                                 lora, loss, optim)
from lightgrad_tpu_torch.autograd import Tensor
from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

GPT_CFG = dict(vocab_size=50, n_embd=32, n_layer=2, n_head=4, n_positions=16)
LLAMA_CFG = dict(vocab_size=50, hidden_size=32, intermediate_size=48,
                 num_hidden_layers=2, num_attention_heads=2,
                 num_key_value_heads=1, max_position_embeddings=16)
ADAPTER = ("lora_A", "lora_B")


def _gpt(seed=0, **kw):
    return GPT(GPTConfig(**GPT_CFG, **kw), device="cpu",
               generator=torch.Generator().manual_seed(seed))


def _batch(seed, b=4, s=12):
    ids = np.random.default_rng(seed).integers(0, 50, (b, s)) \
        .astype(np.int32)
    return torch.from_numpy(ids).long()


def _is_adapter(n):
    return n.rsplit(".", 1)[-1] in ADAPTER


def test_gpt_identity_at_init_and_a_bound():
    m = _gpt()
    x = _batch(0)
    before = m(x)
    wrapped = lora.apply_lora(m, rank=4, targets=("c_attn", "c_proj",
                                                  "c_fc"),
                              generator=torch.Generator().manual_seed(1))
    assert len(wrapped) == 8
    assert torch.equal(m(x), before)
    a = m.h[0].attn.c_attn.lora_A
    assert a.shape == (4, 32) and a.abs().max() <= 1 / np.sqrt(32)
    assert not m.h[0].attn.c_attn.lora_B.any()


def test_gpt_trains_only_adapters():
    m = _gpt()
    lora.apply_lora(m, rank=4, targets=("c_attn",))
    params = lora.lora_parameters(m)
    assert params and all(p.requires_grad for p in params)
    frozen = {n: p.detach().clone() for n, p in m.named_parameters()
              if not _is_adapter(n)}
    assert frozen and not any(p.requires_grad for n, p in
                              m.named_parameters() if n in frozen)
    x = _batch(1)
    opt = optim.Adam(params, lr=5e-3)
    losses = []
    for _ in range(8):
        lo = F.cross_entropy(m(x).reshape(-1, 50), x.reshape(-1))
        lo.backward()
        opt.step()
        opt.zero_grad()
        losses.append(lo.item())
    assert losses[-1] < losses[0], losses
    for n, p in m.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    assert any(p.abs().max() > 0 for n, p in m.named_parameters()
               if n.endswith("lora_B"))


def test_gpt_merge_is_exact():
    m = _gpt()
    lora.apply_lora(m, rank=4, alpha=8, targets=("c_attn", "c_fc"))
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for n, p in m.named_parameters():
            if n.endswith("lora_B"):
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape)
                                         .astype(np.float32) * 0.02))
    x = _batch(3)
    adapted = m(x)
    assert lora.merge_lora(m)
    np.testing.assert_allclose(m(x).detach().numpy(),
                               adapted.detach().numpy(), atol=2e-5,
                               rtol=2e-5)
    names = [n for n, _ in m.named_parameters()]
    assert not any(".base." in n or "lora_" in n for n in names)
    assert all(p.requires_grad for p in m.parameters())


def test_gpt_adapter_state_round_trip():
    m1 = _gpt()
    state = m1.state_dict()
    lora.apply_lora(m1, rank=4, targets=("c_attn",))
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for n, p in m1.named_parameters():
            if n.endswith("lora_B"):
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape)
                                         .astype(np.float32) * 0.05))
    adapters = lora.lora_state_dict(m1)
    assert adapters and all("lora_" in k for k in adapters)
    m2 = _gpt(seed=9)
    m2.load_state_dict(state)
    lora.apply_lora(m2, rank=4, targets=("c_attn",))
    m2.load_state_dict({k: torch.from_numpy(v) for k, v in adapters.items()},
                       strict=False)
    x = _batch(6)
    assert torch.equal(m2(x), m1(x))


def test_gpt_lora_matches_jax():
    """Same base, same adapters: logits, then two Adam steps on the
    adapters, JAX package (xla) against the port."""
    np.random.seed(0)
    jm = JGPT(JGPTConfig(**GPT_CFG))
    jlora.apply_lora(jm, rank=4, alpha=8, targets=("c_attn", "c_fc"))
    tm = _gpt()
    lora.apply_lora(tm, rank=4, alpha=8, targets=("c_attn", "c_fc"))
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    rng = np.random.default_rng(7)
    for n, p in jm.named_parameters():
        if n.endswith("lora_B"):
            p._set_data(JTensor.from_numpy(rng.standard_normal(p.shape)
                                           .astype(np.float32) * 0.02).data)
    load_numpy_params(tm, {n: np.asarray(t.data)
                           for n, t in jm.named_parameters()})
    ids = _batch(8).numpy().astype(np.int32)
    with jax_kernel_mode("xla"):
        jx = JTensor.from_numpy(ids, requires_grad=False)
        jy = JTensor.from_numpy(ids.reshape(-1), requires_grad=False)
        np.testing.assert_allclose(
            tm(torch.from_numpy(ids).long()).detach().numpy(),
            jm(jx).numpy(), rtol=2e-5, atol=2e-5)
        jopt = light.optim.Adam(jlora.lora_parameters(jm), lr=1e-2)
        for _ in range(2):
            lo = light.loss.cross_entropy(jm(jx).reshape(-1, 50), jy)
            jopt.zero_grad()
            lo.backward()
            jopt.step()
    topt = optim.Adam(lora.lora_parameters(tm), lr=1e-2)
    x = torch.from_numpy(ids).long()
    for _ in range(2):
        lo = F.cross_entropy(tm(x).reshape(-1, 50), x.reshape(-1))
        topt.zero_grad()
        lo.backward()
        topt.step()
    want = jlora.lora_state_dict(jm)
    got = lora.lora_state_dict(tm)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _llama_loss(m, ids):
    return loss.cross_entropy(
        m(Tensor.from_numpy(ids[:, :-1], requires_grad=False))
        .reshape(-1, 50),
        Tensor.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False))


def test_llama_on_the_tape():
    """The JAX docstring's workflow: q_proj / v_proj adapters on a LLaMA;
    identity at init, adapters alone trained, an exact merge."""
    from lightgrad_tpu_torch import random as lg_random

    lg_random.seed(0)
    m = Llama(LlamaConfig(**LLAMA_CFG))
    ids = np.random.default_rng(1).integers(0, 50, (2, 9)).astype(np.int32)
    x = Tensor.from_numpy(ids[:, :-1], requires_grad=False)
    before = m(x).numpy()
    assert lora.apply_lora(m, rank=4) == [
        f"layers.{l}.self_attn.{p}" for l in range(2)
        for p in ("q_proj", "v_proj")]
    np.testing.assert_array_equal(m(x).numpy(), before)
    frozen = {n: p.numpy() for n, p in m.named_parameters()
              if not _is_adapter(n)}
    opt = optim.AdamW(lora.lora_parameters(m), lr=1e-2)
    losses = []
    for _ in range(5):
        lo = _llama_loss(m, ids)
        opt.zero_grad()
        lo.backward()
        opt.step()
        losses.append(lo.item())
    assert losses[-1] < losses[0], losses
    for n, p in m.named_parameters():
        if n in frozen:
            np.testing.assert_array_equal(p.numpy(), frozen[n], err_msg=n)
    adapted = m(x).numpy()
    lora.merge_lora(m)
    np.testing.assert_allclose(m(x).numpy(), adapted, atol=2e-5, rtol=2e-5)
    assert sorted(n for n, _ in m.named_parameters()) == sorted(
        n.replace(".base.", ".") for n in frozen)


def test_bf16_base_keeps_f32_adapters():
    from lightgrad_tpu_torch import random as lg_random

    lg_random.seed(0)
    m = Llama(LlamaConfig(**LLAMA_CFG))
    amp.cast_module(m, torch.bfloat16)
    lora.apply_lora(m, rank=4)
    assert all(p.dtype == torch.float32 for p in lora.lora_parameters(m))
    ids = np.random.default_rng(2).integers(0, 50, (2, 9)).astype(np.int32)
    out = m(Tensor.from_numpy(ids[:, :-1], requires_grad=False))
    assert out.dtype == torch.bfloat16
    opt = optim.AdamW(lora.lora_parameters(m), lr=1e-2)
    lo = loss.cross_entropy(out.astype(torch.float32).reshape(-1, 50),
                            Tensor.from_numpy(ids[:, 1:].reshape(-1),
                                              requires_grad=False))
    lo.backward()
    opt.step()
    assert any(np.abs(p.numpy()).max() > 0 for n, p in m.named_parameters()
               if n.endswith("lora_B"))


@pytest.mark.parametrize("world", ["torch", "tape"])
def test_scanned_stack_is_not_wrapped(world):
    if world == "torch":
        m = _gpt(scan_layers=True)
        targets = ("c_attn",)
    else:
        m = Llama(LlamaConfig(scan_layers=True, **LLAMA_CFG))
        targets = ("q_proj", "v_proj")
    with pytest.raises(ValueError, match="no Linear matched"):
        lora.apply_lora(m, rank=4, targets=targets)
