"""Port parity: ``nn.MoE`` on the lightgrad tape against the JAX package's.

Dense, top-1 and top-k (k 2) dispatch; GELU and SwiGLU experts; a shared
expert; capacity factor 1.0 on skewed tokens (so routings are dropped); and
router rows made equal, an exact tie that must route to the lower expert
index in both packages.  The same numpy weights and inputs go through both;
checked: the output, ``aux_loss``, ``z_loss`` and every parameter's
gradient.  Tolerance: float32 1e-4 (the same products summed in another
order; routing decisions must agree exactly, or the outputs would differ
by O(1)).
"""

import numpy as np
import pytest
import torch

import lightgrad_tpu.nn as jnn
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu_torch import load_numpy_params
from lightgrad_tpu_torch import nn as tnn
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
D, H, E, T = 8, 12, 4, 10

CASES = {
    "dense_gelu": dict(dispatch="dense"),
    "top1_gelu": dict(dispatch="top1"),
    "topk_swiglu": dict(dispatch="topk", k=2, ffn="swiglu"),
    "topk_gelu_shared": dict(dispatch="topk", k=2, n_shared=1),
    "topk_drops": dict(dispatch="topk", k=2, ffn="swiglu",
                       capacity_factor=1.0),
    "top1_tie": dict(dispatch="top1", ffn="swiglu"),
}


def _inputs(name, seed):
    rng = np.random.default_rng(seed)
    np.random.seed(seed)
    jm = jnn.MoE(D, H, E, **CASES[name])
    state = {n: rng.standard_normal(p.shape).astype(np.float32) * 0.5
             for n, p in jm.named_parameters()}
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    if name == "topk_drops":
        # skewed tokens: every token leans to expert 0, so its capacity of
        # ceil(2 T / E) slots overflows
        state["router.weight"][0, :] = 3.0
        x = x * 0.1 + 1.0
    if name == "top1_tie":
        # experts 1 and 2 score alike for every token, above the others
        state["router.weight"][2] = state["router.weight"][1]
        state["router.weight"][(0, 3), :] = -state["router.weight"][1]
        x = np.abs(x) * np.sign(state["router.weight"][1])
    r = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    return jm, state, x, r


def _run(T_, model, x, r):
    xt = T_.from_numpy(x)
    y = model(xt)
    loss = (y * T_.from_numpy(r, requires_grad=False)).sum()
    if model.dispatch != "dense":
        loss = loss + model.aux_loss * 0.5 + model.z_loss * 0.25
    loss.backward()
    return y, xt


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_matches_jax(name, mode):
    """Output, both router losses, the input's and every parameter's
    gradient, against the JAX ``nn.MoE`` on the same weights."""
    jm, state, x, r = _inputs(name, seed=list(CASES).index(name))
    jm.load_parameters(state)
    tm = tnn.MoE(D, H, E, **CASES[name])
    load_numpy_params(tm, state)
    assert [n for n, _ in tm.named_parameters()] == list(state)
    with jax_kernel_mode(mode):
        jy, jx = _run(JTensor, jm, x, r)
    ty, tx = _run(TTensor, tm, x, r)
    np.testing.assert_allclose(ty.numpy(), jy.numpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)
    if tm.dispatch != "dense":
        for loss in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(getattr(tm, loss).numpy(),
                                       getattr(jm, loss).numpy(),
                                       err_msg=loss, **TOL)
    jgrads = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n].grad.numpy(),
                                   err_msg=n, **TOL)
    if name == "topk_drops":
        # the capacity really dropped routings: some token's output is zero
        # in its routed part (cap = ceil(2 T / E) = 5 < 10 first choices)
        logits = x.reshape(T, D) @ state["router.weight"].T
        assert (logits.argmax(-1) == 0).sum() > 5
    if name == "top1_tie":
        # every token routes to expert 1, never its tied twin 2
        onehot = tm._argmax_onehot(
            TTensor.from_numpy(x.reshape(T, D) @ state["router.weight"].T,
                               requires_grad=False)).numpy()
        jonehot = jnn.MoE._argmax_onehot(
            JTensor.from_numpy(x.reshape(T, D) @ state["router.weight"].T,
                               requires_grad=False)).numpy()
        np.testing.assert_array_equal(onehot, jonehot)
        np.testing.assert_array_equal(onehot.argmax(-1), np.ones(T))
        assert onehot.sum() == T


def test_bf16_slot_positions_are_exact_past_256_tokens():
    """In bf16 the slot positions are counted in float32: with 300 tokens
    all routed to one expert of capacity 300, each token keeps its own slot
    and the routed output is its own FFN, token for token."""
    n = 300
    rng = np.random.default_rng(7)
    m = tnn.MoE(4, 8, 2, dispatch="top1", capacity_factor=2.0, ffn="swiglu")
    state = {k: rng.standard_normal(p.shape).astype(np.float32) * 0.5
             for k, p in m.named_parameters()}
    state["router.weight"][:] = [[1.0] * 4, [-1.0] * 4]
    load_numpy_params(m, state)
    m.map_parameters(lambda p: p.astype(torch.bfloat16))
    x = np.abs(rng.standard_normal((n, 4))).astype(np.float32)
    xt = TTensor.from_numpy(x, requires_grad=False).astype(torch.bfloat16)
    y = m(xt).numpy()
    w1, w3, w2 = (m.w1.data[0].float(), m.w3.data[0].float(),
                  m.w2.data[0].float())
    xb = xt.data.float()
    g = xb @ w1
    gate = torch.softmax(xb @ m.router.weight.data.float().T, -1)[:, :1]
    want = (gate * ((torch.nn.functional.silu(g) * (xb @ w3)) @ w2)).numpy()
    np.testing.assert_allclose(y, want, rtol=3e-2, atol=3e-2)
