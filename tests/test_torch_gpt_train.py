"""Port parity of the GPT-2 training slice: a tiny GPT built by the JAX
package and carried across with ``load_numpy_params`` trains for three steps
in both packages -- f32 Adam, and bf16 ``MixedPrecision`` -- on the same
tokens; a non-finite step is gated away in both.  The JAX side runs in
``xla`` mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgrad_tpu as light
from lightgrad_tpu.autograd import Tensor
from lightgrad_tpu.models import GPT as JaxGPT
from lightgrad_tpu.models import GPTConfig as JaxGPTConfig
from lightgrad_tpu_torch import GPT, GPTConfig, amp, load_numpy_params, optim
from lightgrad_tpu_torch.autograd import ops as autograd_ops
from lightgrad_tpu_torch.loss import cross_entropy
from lightgrad_tpu_torch.models._torch_layers import LayerNorm
from tests.torch_port import jax_kernel_mode, to_np

CFG = dict(vocab_size=96, n_positions=32, n_embd=64, n_layer=2, n_head=4)
B, S, LR = 2, 16, 1e-3
# f32: the same math summed in another order, through 3 Adam steps
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# The key projection's bias has a zero gradient in exact arithmetic (a
# constant added to every score of a row cancels in the softmax), so both
# packages hand Adam rounding noise there, ~1e-9 in f32.  With eps 1e-8
# Adam would scale that noise up to +-lr; eps 1e-6 keeps it noise, and is
# still far below every real gradient of the model (~1e-3).
ADAM_EPS = 1e-6


def _models(seed=11):
    np.random.seed(seed)
    jm = JaxGPT(JaxGPTConfig(**CFG))
    tm = GPT(GPTConfig(**CFG), device="cpu")
    load_numpy_params(tm, {n: np.asarray(t.data)
                           for n, t in jm.named_parameters()})
    return jm, tm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    tgt = rng.integers(0, CFG["vocab_size"], B * S).astype(np.int32)
    return ids, tgt


def _jax_loss(jm, ids, tgt, poison=False):
    logits = jm(Tensor.from_numpy(ids, requires_grad=False))
    loss = light.loss.cross_entropy(
        logits.reshape(B * S, CFG["vocab_size"]),
        Tensor.from_numpy(tgt, requires_grad=False))
    return loss * float("nan") if poison else loss


def _port_loss(tm, ids, tgt, poison=False):
    logits = tm(torch.from_numpy(ids).long())
    loss = cross_entropy(logits.reshape(B * S, CFG["vocab_size"]),
                         torch.from_numpy(tgt).long())
    return loss * float("nan") if poison else loss


def test_forward_records_the_tape():
    """GPT.forward is differentiable: its logits carry a grad_fn."""
    _, tm = _models()
    ids, _ = _batch()
    logits = tm(torch.from_numpy(ids).long())
    assert logits.requires_grad and logits.grad_fn is not None


def test_backward_runs_the_fused_kernels_backwards(monkeypatch):
    """The block's attention and every LayerNorm (ln_1, ln_2 per layer,
    ln_f) go through the fused ops' backward functions."""
    _, tm = _models()
    assert all(isinstance(m, LayerNorm) for n, m in tm.named_modules()
               if n.rsplit(".", 1)[-1].startswith("ln_"))
    calls = {"attention_bwd": 0, "layernorm_bwd": 0}
    for name in calls:
        fn = getattr(autograd_ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(autograd_ops, name, counted)
    ids, tgt = _batch()
    _port_loss(tm, ids, tgt).backward()
    L = CFG["n_layer"]
    assert calls == {"attention_bwd": L, "layernorm_bwd": 2 * L + 1}


def test_adam_training_matches_jax():
    """3 f32 Adam steps: losses and every parameter match the JAX model."""
    jm, tm = _models()
    ids, tgt = _batch()
    jopt = light.optim.Adam(list(jm.parameters()), lr=LR, eps=ADAM_EPS)
    topt = optim.Adam(tm.parameters(), lr=LR, eps=ADAM_EPS)
    losses = []
    with jax_kernel_mode("xla"):
        for _ in range(3):
            jl = _jax_loss(jm, ids, tgt)
            jopt.zero_grad()
            jl.backward()
            jopt.step()
            tl = _port_loss(tm, ids, tgt)
            topt.zero_grad()
            tl.backward()
            topt.step()
            np.testing.assert_allclose(to_np(tl), jl.numpy(), **F32_TOL)
            losses.append(float(tl.detach()))
    assert losses[-1] < losses[0]
    jp = dict(jm.named_parameters())
    for name, t in tm.named_parameters():
        np.testing.assert_allclose(to_np(t), jp[name].numpy(), **F32_TOL,
                                   err_msg=name)


def _amp_pair():
    jm, tm = _models()
    jmp = light.amp.MixedPrecision(
        jm, lambda ps: light.optim.Adam(ps, lr=LR))
    tmp = amp.MixedPrecision(tm, lambda ps: optim.Adam(ps, lr=LR))
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert all(m.dtype == torch.float32 for m in tmp.masters)
    return jm, tm, jmp, tmp


def _amp_backward(jm, tm, jmp, tmp, ids, tgt, poison=False):
    jl = _jax_loss(jm, ids, tgt, poison)
    jmp.zero_grad()
    jmp.scale(jl).backward()
    tl = _port_loss(tm, ids, tgt, poison)
    tmp.zero_grad()
    tmp.scale(tl).backward()
    return jl, tl


def _amp_step(*pair, poison=False):
    jl, tl = _amp_backward(*pair, poison=poison)
    pair[2].step()
    pair[3].step()
    return jl, tl


# bf16 compute: both packages round each product and activation to bf16 at
# their own points.  A loss agrees to 1e-2 relative; a gradient to 5e-2 of
# the model's largest gradient entry.  Adam moves a master by at most ~lr a
# step whatever the gradient's size, and normalises rounding noise (the key
# bias's zero gradient) up to that size, so after 3 steps two runs stay
# within 2 * 3 * lr of each other.
BF16_LOSS_TOL = dict(atol=0.0, rtol=1e-2)
BF16_GRAD_TOL = 5e-2
BF16_MASTER_TOL = dict(atol=2 * 3 * LR, rtol=0.0)


def test_mixed_precision_training_matches_jax():
    jm, tm, jmp, tmp = _amp_pair()
    ids, tgt = _batch()
    losses = []
    with jax_kernel_mode("xla"):
        for step in range(3):
            jl, tl = _amp_backward(jm, tm, jmp, tmp, ids, tgt)
            np.testing.assert_allclose(to_np(tl), jl.numpy(),
                                       **BF16_LOSS_TOL)
            if step == 0:
                jg = [to_np(p.grad.numpy()) for p in jmp.compute_params]
                tg = [to_np(p.grad) for p in tmp.compute_params]
                scale = max(np.abs(g).max() for g in jg)
                for a, b in zip(tg, jg):
                    assert a.dtype == b.dtype == np.float32
                    np.testing.assert_allclose(
                        a, b, atol=BF16_GRAD_TOL * scale, rtol=0.0)
            jmp.step()
            tmp.step()
            losses.append(float(tl.detach()))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for jmst, tmst in zip(jmp.masters, tmp.masters):
        np.testing.assert_allclose(to_np(tmst), jmst.numpy(),
                                   **BF16_MASTER_TOL)
    # compute parameters are the masters requantized
    for p, m in zip(tmp.compute_params, tmp.masters):
        assert torch.equal(p, m.bfloat16())


def test_nan_step_is_gated_in_both_packages():
    """A NaN loss gives NaN gradients; ``MixedPrecision.step`` skips the
    step: compute params, masters, Adam moments and its counter stay."""
    jm, tm, jmp, tmp = _amp_pair()
    ids, tgt = _batch()
    with jax_kernel_mode("xla"):
        _amp_step(jm, tm, jmp, tmp, ids, tgt)

        def state():
            jo, to = jmp.optim, tmp.optim
            return ([to_np(m.numpy()) for m in jmp.compute_params
                     + jmp.masters + jo.m + jo.v + [jo.t]],
                    [to_np(m) for m in tmp.compute_params + tmp.masters
                     + to.m + to.v + [to.t]])

        before = state()
        _amp_step(jm, tm, jmp, tmp, ids, tgt, poison=True)
        after = state()
    for b, a in zip(before, after):
        for x, y in zip(b, a):
            np.testing.assert_array_equal(x, y)
    assert float(tmp.optim.t) == float(jmp.optim.t.numpy()) == 1.0


@pytest.mark.parametrize("enabled", [True, False])
def test_grad_scaler_matches_jax(enabled):
    """Dynamic loss scaling: growth after ``growth_interval`` good steps,
    backoff on a non-finite one."""
    js = light.amp.GradScaler(init_scale=4.0, growth_interval=2,
                              enabled=enabled)
    ts = amp.GradScaler(init_scale=4.0, growth_interval=2, enabled=enabled)
    for ok in (1.0, 1.0, 1.0, 0.0, 1.0):
        js.update(Tensor.from_numpy(np.float32(ok), requires_grad=False))
        ts.update(torch.tensor(ok))
        assert ts.scale_value() == js.scale_value()
    loss = torch.tensor(3.0)
    assert float(ts.scale(loss)) == 3.0 * (ts.scale_value() if enabled
                                           else 1.0)
