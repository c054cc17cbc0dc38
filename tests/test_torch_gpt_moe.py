"""Port parity: the mixture-of-experts option of the ``torch.nn`` GPT.  A
tiny MoE GPT (``tests/test_moe_gpt.py``'s ``tiny_cfg``: vocab 64, 16
positions, width 16, 2 layers, 2 heads, 4 experts of width 32, top-2) built
by the JAX package and carried across with ``load_numpy_params``, on 2 x 8
tokens.  Checked against the JAX tape GPT (xla mode): logits,
``aux_loss``, ``z_loss`` and every gradient of a loss that adds both, for
``topk`` at capacity factor 1.25 and 0.5 (routings dropped), ``top1`` every
other block, ``dense`` and one shared expert; an AdamW step.  The index
dispatch against ``moe_reference`` (the JAX package's one-hot products in
plain PyTorch), drops and an exact tie included; the cached-decode
``ValueError``; uncached ``generate`` against JAX's tokens."""

import numpy as np
import pytest
import torch

import lightgrad_tpu as light
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models import GPT as JaxGPT
from lightgrad_tpu.models import GPTConfig as JaxGPTConfig
from lightgrad_tpu_torch import GPT, GPTConfig, load_numpy_params, optim
from lightgrad_tpu_torch.loss import cross_entropy
from lightgrad_tpu_torch.models._torch_layers import MoE, moe_reference
from tests.torch_port import jax_kernel_mode, to_np

BASE = dict(vocab_size=64, n_positions=16, n_embd=16, n_layer=2, n_head=2,
            n_experts=4, moe_k=2, moe_hidden=32)
B, S, V = 2, 8, 64
AUX, ZW = 0.01, 0.001
TOL = dict(rtol=1e-5, atol=1e-6)
CASES = {"topk": {}, "topk_drops": dict(moe_capacity_factor=0.5),
         "top1_every2": dict(moe_dispatch="top1", moe_every=2, n_layer=4),
         "dense": dict(moe_dispatch="dense"), "shared": dict(moe_shared=1)}


def _models(seed=0, **kw):
    cfg = dict(BASE, **kw)
    np.random.seed(seed)
    jm = JaxGPT(JaxGPTConfig(**cfg))
    tm = GPT(GPTConfig(**cfg), device="cpu")
    load_numpy_params(tm, {n: np.asarray(t.data)
                           for n, t in jm.named_parameters()})
    return jm, tm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, S)).astype(np.int32),
            rng.integers(0, V, B * S).astype(np.int32))


def _jax_loss(jm, ids, tgt):
    logits = jm(JTensor.from_numpy(ids, requires_grad=False))
    loss = light.loss.cross_entropy(
        logits.reshape(B * S, V), JTensor.from_numpy(tgt, requires_grad=False))
    if jm.aux_loss is not None:
        loss = loss + jm.aux_loss * AUX + jm.z_loss * ZW
    return logits, loss


def _port_loss(tm, ids, tgt):
    logits = tm(torch.from_numpy(ids).long())
    loss = cross_entropy(logits.reshape(B * S, V),
                         torch.from_numpy(tgt).long())
    if tm.aux_loss is not None:
        loss = loss + tm.aux_loss * AUX + tm.z_loss * ZW
    return logits, loss


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_losses_and_gradients_match_jax(case):
    jm, tm = _models(**CASES[case])
    jnames = [n for n, _ in jm.named_parameters()]
    assert [n for n, _ in tm.named_parameters()] == jnames
    ids, tgt = _batch()
    with jax_kernel_mode("xla"):
        jl, jloss = _jax_loss(jm, ids, tgt)
        jm.zero_grad()
        jloss.backward()
    tl, tloss = _port_loss(tm, ids, tgt)
    tloss.backward()
    np.testing.assert_allclose(to_np(tl), jl.numpy(), **TOL)
    np.testing.assert_allclose(to_np(tloss), jloss.numpy(), **TOL)
    if case == "dense":
        assert tm.aux_loss is None and tm.z_loss is None
    else:
        np.testing.assert_allclose(to_np(tm.aux_loss), jm.aux_loss.numpy(),
                                   **TOL)
        np.testing.assert_allclose(to_np(tm.z_loss), jm.z_loss.numpy(),
                                   **TOL)
    moes = [b.moe for b in tm.h if hasattr(b, "moe")]
    assert len(moes) == (2 if case == "top1_every2" else BASE["n_layer"])
    if case == "topk_drops":
        assert all(not m.routes[1].all() for m in moes)
    jg = {n: t.grad.numpy() for n, t in jm.named_parameters()}
    for n, t in tm.named_parameters():
        scale = max(np.abs(jg[n]).max(), 1e-3)
        err = np.abs(to_np(t.grad) - jg[n]).max()
        assert err <= 1e-5 * scale, (n, err, scale)


def test_adamw_step_matches_jax():
    jm, tm = _models(**CASES["topk_drops"])
    ids, tgt = _batch(1)
    jopt = light.optim.AdamW(list(jm.parameters()), lr=1e-3, eps=1e-6)
    topt = optim.AdamW(tm.parameters(), lr=1e-3, eps=1e-6)
    with jax_kernel_mode("xla"):
        for _ in range(2):
            _, jloss = _jax_loss(jm, ids, tgt)
            jopt.zero_grad()
            jloss.backward()
            jopt.step()
            _, tloss = _port_loss(tm, ids, tgt)
            topt.zero_grad()
            tloss.backward()
            topt.step()
            np.testing.assert_allclose(to_np(tloss), jloss.numpy(), **TOL)
    jp = dict(jm.named_parameters())
    for n, t in tm.named_parameters():
        np.testing.assert_allclose(to_np(t), jp[n].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def _moe(dispatch, cf, n_shared=0, seed=0, zero_router=False):
    torch.manual_seed(seed)
    moe = MoE(24, 40, 6, dispatch=dispatch, capacity_factor=cf, k=2,
              n_shared=n_shared)
    with torch.no_grad():
        for p in moe.parameters():
            p.uniform_(-0.3, 0.3)
        if zero_router:
            moe.router.weight.zero_()
    return moe


@pytest.mark.parametrize("dispatch,cf,n_shared,tie", [
    ("topk", 1.25, 0, False), ("topk", 0.5, 0, False), ("top1", 0.75, 0, False),
    ("dense", 1.0, 0, False), ("topk", 1.0, 2, False), ("topk", 1.0, 0, True)])
def test_index_dispatch_equals_moe_reference(dispatch, cf, n_shared, tie):
    """The main path's gather / batched products / scatter-add against the
    one-hot formulation: outputs, losses, routings (kept and dropped) and
    every gradient.  ``tie``: a zero router makes every probability equal,
    so each token's k choices are experts 0 .. k-1."""
    moe = _moe(dispatch, cf, n_shared, zero_router=tie)
    x = torch.randn(3, 50, 24, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    y = moe(x)
    w = dict(moe.named_parameters())
    xr = x.detach().clone().requires_grad_(True)
    yr, aux, z, routes = moe_reference(xr, w, 6, dispatch=dispatch, k=2,
                                       capacity_factor=cf)
    torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-6)
    if dispatch == "dense":
        assert moe.aux_loss is None and aux is None
        loss, loss_r = (y * y).sum(), (yr * yr).sum()
    else:
        ids, keep = moe.routes
        assert torch.equal(ids, routes[0]) and torch.equal(keep, routes[1])
        if cf < 1:
            assert not keep.all()
        if tie:
            k = ids.shape[0]
            assert torch.equal(ids, torch.arange(k)[:, None].expand_as(ids))
        torch.testing.assert_close(moe.aux_loss, aux)
        torch.testing.assert_close(moe.z_loss, z)
        loss = (y * y).sum() + moe.aux_loss + moe.z_loss
        loss_r = (yr * yr).sum() + aux + z
    names = list(w)
    got = torch.autograd.grad(loss, [x] + [w[n] for n in names])
    want = torch.autograd.grad(loss_r, [xr] + [w[n] for n in names])
    for n, a, b in zip(["x"] + names, got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=n)


def test_reference_takes_given_routes():
    """``moe_reference(ids=...)`` routes as told (the smoke run's twin takes
    the model's choices): its kept set then follows its own slot count."""
    moe = _moe("topk", 0.5)
    x = torch.randn(40, 24, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        y = moe(x)
        ids, keep = moe.routes
        flipped = ids.flip(0)
        yr, _, _, (own, kept) = moe_reference(
            x, dict(moe.named_parameters()), 6, k=2, capacity_factor=0.5,
            ids=ids)
        _, _, _, (_, kept_flipped) = moe_reference(
            x, dict(moe.named_parameters()), 6, k=2, capacity_factor=0.5,
            ids=flipped)
    torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-6)
    assert torch.equal(own, ids) and torch.equal(kept, keep)
    assert not torch.equal(kept_flipped, keep)


def test_structure_config_and_decoding():
    """Blocks ``i % moe_every == moe_every - 1`` are MoE; scanned stacks
    refuse experts; cached decoding raises ValueError (the JAX package
    raises KeyError there); uncached generate gives JAX's tokens."""
    jm, tm = _models(**CASES["top1_every2"])
    names = dict(tm.named_parameters())
    assert "h.1.moe.w1" in names and "h.3.moe.w2" in names
    assert "h.0.c_fc.weight" in names and "h.1.c_fc.weight" not in names
    assert names["h.1.moe.w1"].shape == (4, 16, 32)
    assert not any("aux_loss" in k for k in tm.state_dict())
    with pytest.raises(ValueError, match="scan_layers"):
        GPTConfig(scan_layers=True, n_experts=2)
    assert GPTConfig(n_experts=8).n_experts == 8
    for call in (lambda: tm.generate([1, 2, 3], 4),
                 lambda: tm._kv_functions(),
                 lambda: tm.generate([1, 2, 3], 4, num_beams=2)):
        with pytest.raises(ValueError, match="use_cache=False"):
            call()
    prompt = [5, 9, 2]
    got = tm.generate(prompt, 6, use_cache=False)
    with jax_kernel_mode("xla"):
        want = jm.generate(prompt, 6, use_cache=False)
    assert got == list(want)
