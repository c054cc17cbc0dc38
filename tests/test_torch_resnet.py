"""Port parity: ResNet on the lightgrad tape.  A tiny ``ResNet([1, 1],
[4, 8])`` and a narrow ResNet-18 layout (four stages of two blocks, the
7x7/s2 stem and the padded 3x3/s2 max pool, widths 4-16) built by the JAX
package and carried across with ``load_numpy_params(model,
jax_model.state_dict())``, on 2 or 4 x 3 x 32 x 32 inputs.  Checked against
the JAX model (pallas interpret and xla modes): the logits, step 1's
gradient of every parameter, every parameter and running statistic after
two AdamW steps, an eval-mode forward, and a fresh model loaded from the
trained JAX model's state.  The JAX BatchNorm runs with its training
gradient corrected (``jax_batchnorm_true_gradient``, as the port's).  Also
``load_torchvision_state_dict`` on a synthetic torchvision-named state,
and ``load_numpy_params``'s checks of buffer names."""

import numpy as np
import pytest
import torch

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models import resnet as jresnet
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.models import resnet as tresnet
from tests.torch_port import (cpu_device, jax_batchnorm_true_gradient,  # noqa: F401
                               jax_kernel_mode, rand)

# f32 through up to 17 conv + BatchNorm layers: products and statistics
# summed in another order.  At 32 x 32 the last stage normalises over B x
# 1 x 1 positions, which makes its gradients ill-conditioned (the stem's
# reach ~1e3), so each array is held to max |err| / max |ref|, as
# chip_smoke.py holds the card's gradients
TOL = 1e-4
# Adam's first step is about lr * sign(g) for every element whose gradient
# exceeds eps: an element whose gradient is near rounding noise moves by
# up to lr on either side, so the parameters after the steps are held to
# STEP_TOL * lr, absolute
LR, ADAM_EPS, CLASSES, STEP_TOL = 1e-3, 1e-6, 10, 0.1

CONFIGS = {
    "tiny": dict(stage_blocks=[1, 1], stage_channels=[4, 8]),
    "resnet18-layout": dict(stage_blocks=[2, 2, 2, 2],
                            stage_channels=[4, 8, 8, 16], stem_kernel=7,
                            stem_stride=2, stem_pool=True),
}
# the ResNet-18 layout's last stage is 1 x 1 at 32 x 32: 4 images give its
# BatchNorm 4 values a channel
BATCH = {"tiny": 2, "resnet18-layout": 4}


def _models(cfg):
    np.random.seed(0)
    jm = jresnet.ResNet(num_classes=CLASSES, **cfg)
    tm = tresnet.ResNet(num_classes=CLASSES, **cfg)
    lt.load_numpy_params(tm, jm.state_dict())
    return jm, tm


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    return (rand(rng, n, 3, 32, 32),
            rng.integers(0, CLASSES, n).astype(np.int32))


def _step(T, pkg, model, opt, x, y):
    logits = model(T.from_numpy(x, requires_grad=False))
    loss = pkg.loss.cross_entropy(logits, T.from_numpy(y,
                                                       requires_grad=False))
    opt.zero_grad()
    loss.backward()
    return logits.numpy()


def _close(got, want, what):
    """max |got - want| / max |want| within TOL."""
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= TOL, f"{what}: max |err| / max |ref| = {err}"


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_resnet_trains_like_the_jax_model(name, mode,
                                          jax_batchnorm_true_gradient):
    jm, tm = _models(CONFIGS[name])
    names = [n for n, _ in tm.named_parameters()]
    jparams = dict(jm.named_parameters())
    jopt = light.optim.AdamW([jparams[n] for n in names], lr=LR,
                             eps=ADAM_EPS)
    topt = lt.optim.AdamW(list(tm.parameters()), lr=LR, eps=ADAM_EPS)
    for step in range(2):
        x, y = _batch(step, BATCH[name])
        with jax_kernel_mode(mode):
            jl = _step(JTensor, light, jm, jopt, x, y)
        tl = _step(TTensor, lt, tm, topt, x, y)
        if step == 0:
            _close(tl, jl, "step-1 logits")
            tp = dict(tm.named_parameters())
            for n in names:
                _close(tp[n].grad.numpy(), jparams[n].grad.numpy(),
                       f"step-1 gradient of {n}")
        with jax_kernel_mode(mode):
            jopt.step()
        topt.step()
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert sorted(tsd) == sorted(jsd)
    for n in tsd:
        if n in jparams:
            err = np.abs(tsd[n] - jsd[n]).max()
            assert err <= STEP_TOL * LR, f"{n} after two steps: {err}"
        else:                                   # running statistics
            _close(tsd[n], jsd[n], f"{n} after two steps")
    assert not np.allclose(tsd["bstem.running_mean"], 0.0)

    # eval mode: BatchNorm on the running statistics, both models, then a
    # fresh port model loaded from the trained JAX model's whole state
    x, _ = _batch(7, BATCH[name])
    jm.eval()
    tm.eval()
    with jax_kernel_mode(mode):
        want = jm(JTensor.from_numpy(x, requires_grad=False)).numpy()
    _close(tm(TTensor.from_numpy(x, requires_grad=False)).numpy(), want,
           "eval logits")
    fresh = tresnet.ResNet(num_classes=CLASSES, **CONFIGS[name])
    lt.load_numpy_params(fresh, jsd)
    fresh.eval()
    _close(fresh(TTensor.from_numpy(x, requires_grad=False)).numpy(), want,
           "eval logits of the loaded model")


def test_resnet_constructors_match_the_jax_package():
    for make in ("resnet20", "resnet18"):
        np.random.seed(0)
        jm = getattr(jresnet, make)(num_classes=10, in_channels=1)
        tm = getattr(tresnet, make)(num_classes=10, in_channels=1)
        tshapes = {n: t.shape for n, t in tm.named_parameters()}
        jshapes = {n: tuple(t.shape) for n, t in jm.named_parameters()}
        assert tshapes == jshapes
        assert [n for n, _ in tm.named_buffers()] == \
            [n for n, _ in jm.named_buffers()]
    assert lt.models.resnet18 is tresnet.resnet18


def _torchvision_state(stage_blocks, widths, as_torch):
    """A torchvision-named BasicBlock-ResNet state of random values, with
    the num_batches_tracked buffers torchvision saves."""
    rng = np.random.default_rng(8)
    state = {}

    def bn(pre, c):
        state[pre + ".weight"] = rand(rng, c)
        state[pre + ".bias"] = rand(rng, c)
        state[pre + ".running_mean"] = rand(rng, c)
        state[pre + ".running_var"] = np.abs(rand(rng, c)) + 0.5
        state[pre + ".num_batches_tracked"] = np.array(3)

    state["conv1.weight"] = rand(rng, widths[0], 3, 7, 7)
    bn("bn1", widths[0])
    cin = widths[0]
    for li, (n, c) in enumerate(zip(stage_blocks, widths)):
        for bi in range(n):
            pre = f"layer{li + 1}.{bi}."
            state[pre + "conv1.weight"] = rand(rng, c, cin, 3, 3)
            bn(pre + "bn1", c)
            state[pre + "conv2.weight"] = rand(rng, c, c, 3, 3)
            bn(pre + "bn2", c)
            if cin != c or (li > 0 and bi == 0):
                state[pre + "downsample.0.weight"] = rand(rng, c, cin, 1, 1)
                bn(pre + "downsample.1", c)
            cin = c
    state["fc.weight"] = rand(rng, CLASSES, cin)
    state["fc.bias"] = rand(rng, CLASSES)
    if as_torch:
        state = {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}
    return state


@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_load_torchvision_state_dict_round_trip(as_torch):
    cfg = CONFIGS["resnet18-layout"]
    state = _torchvision_state(cfg["stage_blocks"], cfg["stage_channels"],
                               as_torch)
    jm = jresnet.ResNet(num_classes=CLASSES, **cfg)
    jresnet.load_torchvision_state_dict(
        jm, {k: np.asarray(v) for k, v in state.items()})
    tm = tresnet.ResNet(num_classes=CLASSES, **cfg)
    assert tresnet.load_torchvision_state_dict(tm, state) is tm
    tsd, jsd = tm.state_dict(), jm.state_dict()
    assert sorted(tsd) == sorted(jsd)
    for n in tsd:
        np.testing.assert_array_equal(tsd[n], jsd[n], err_msg=n)
    np.testing.assert_array_equal(tsd["blocks.2.proj.w"],
                                  np.asarray(state["layer2.0.downsample."
                                                   "0.weight"]))
    np.testing.assert_array_equal(tsd["bstem.running_var"],
                                  np.asarray(state["bn1.running_var"]))


def test_load_numpy_params_checks_buffer_names_before_changing_anything():
    jm, tm = _models(CONFIGS["tiny"])
    before = tm.state_dict()
    state = {n: v + 1.0 for n, v in jm.state_dict().items()}
    missing = dict(state)
    del missing["blocks.1.bproj.running_var"]
    with pytest.raises(KeyError, match="missing.*bproj.running_var"):
        lt.load_numpy_params(tm, missing)
    with pytest.raises(KeyError, match="unexpected.*num_batches_tracked"):
        lt.load_numpy_params(tm, {**state, "bstem.num_batches_tracked": 0})
    after = tm.state_dict()
    for n in before:
        np.testing.assert_array_equal(after[n], before[n])
    lt.load_numpy_params(tm, state)
    np.testing.assert_array_equal(tm.state_dict()["bstem.running_var"],
                                  state["bstem.running_var"])
