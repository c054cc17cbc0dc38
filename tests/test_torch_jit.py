"""Port parity: the step compiler (``lightgrad_tpu_torch.jit``) against the
JAX package's ``light.jit``, on the CPU.

On the CPU the port's ``jit`` runs its record, slot and write-back code, and
its "graph" is the captured pass re-run over the slots (the capture itself
needs a card: tests/test_torch_kernels_cuda.py).  The JAX side compiles with
``light.jit`` in its default (abstract) recording, except where a test
compares the state a call leaves behind: the port records with a real eager
step, whose counterpart is the JAX package's ``LIGHTGRAD_RECORD=eager``.
The same numpy weights and inputs go through both.  Tolerances: f32
parameters and losses within 1e-5 relative (2e-5 absolute) of the JAX
package's; the port's compiled steps bit for bit the port's eager steps.
"""

import importlib

import numpy as np
import pytest
import torch

import lightgrad_tpu as light
import lightgrad_tpu.nn as jnn
from lightgrad_tpu.autograd import TpuTensor
from lightgrad_tpu.models import Llama as JLlama
from lightgrad_tpu.models import LlamaConfig as JLlamaConfig
from lightgrad_tpu.models.neox import NeoX as JNeoX
from lightgrad_tpu.models.neox import NeoXConfig as JNeoXConfig
import lightgrad_tpu_torch as lt
import lightgrad_tpu_torch.nn as tnn
from lightgrad_tpu_torch.examples import mnist, on_device
from lightgrad_tpu_torch.models import Llama, LlamaConfig, NeoX, NeoXConfig
from tests.torch_port import cpu_device, jax_kernel_mode, one_thread  # noqa: F401

# the package's ``jit`` attribute is the function; its module, by name
jit_mod = importlib.import_module("lightgrad_tpu_torch.jit")

RTOL, ATOL = 1e-5, 2e-5


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _j(a):
    return TpuTensor.from_numpy(np.asarray(a), requires_grad=False)


def _t(a):
    return lt.Tensor.from_numpy(np.asarray(a), requires_grad=False)


class JTwoLayer(jnn.Module):
    def __init__(self):
        super().__init__()
        self.l1 = jnn.Linear(6, 16)
        self.l2 = jnn.Linear(16, 3)

    def forward(self, x):
        return self.l2(self.l1(x).relu())


class TTwoLayer(tnn.Module):
    def __init__(self):
        super().__init__()
        self.l1 = tnn.Linear(6, 16)
        self.l2 = tnn.Linear(16, 3)

    def forward(self, x):
        return self.l2(self.l1(x).relu())


def _data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 6)).astype(np.float32),
            rng.uniform(-1, 1, (n, 3)).astype(np.float32))


def _pair(seed):
    """The JAX TwoLayer at ``seed`` and the port's with its weights."""
    np.random.seed(seed)
    jm = JTwoLayer()
    with on_device("cpu"):
        tm = TTwoLayer()
    lt.load_numpy_params(tm, {n: np.asarray(p.numpy())
                              for n, p in jm.named_parameters()})
    return jm, tm


def _params(m):
    return {n: p.numpy() for n, p in m.named_parameters()}


OPTIMS = {
    "adam": (lambda pkg: lambda ps: pkg.optim.Adam(ps, lr=1e-2)),
    "sgd_momentum": (lambda pkg: lambda ps: pkg.optim.SGD(
        ps, lr=5e-2, momentum=0.9)),
    "adamw": (lambda pkg: lambda ps: pkg.optim.AdamW(ps, lr=1e-2,
                                                     weight_decay=0.1)),
}


def _train(pkg, model, make_opt, x, y, steps, use_jit):
    opt = make_opt(model.parameters())

    def step(a, b):
        opt.zero_grad()
        loss = pkg.loss.mse(model(a), b)
        loss.backward()
        opt.step()
        return loss

    fn = pkg.jit(step) if use_jit else step
    return [float(fn(x, y).numpy()) for _ in range(steps)], opt


@pytest.fixture(scope="module")
def jax_runs():
    """Each optimizer's TwoLayer trained 8 steps by the JAX package's
    ``light.jit``: (losses, parameters)."""
    out = {}
    x, y = _data(3)
    for name, make in OPTIMS.items():
        jm, _ = _pair(3)
        losses, _ = _train(light, jm, make(light), _j(x), _j(y), 8, True)
        out[name] = losses, _params(jm)
    return out


# --- the ported cases of tests/test_jit_record.py ----------------------------
@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_compiled_step_trains_like_jax(name, jax_runs):
    """A compiled step trains, and its trajectory is the JAX package's."""
    _, tm = _pair(3)
    x, y = _data(3)
    losses, _ = _train(lt, tm, OPTIMS[name](lt), _t(x), _t(y), 8, True)
    assert losses[-1] < losses[0]
    want_losses, want = jax_runs[name]
    _close(losses, want_losses, "losses")
    for n, p in _params(tm).items():
        _close(p, want[n], n)


@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_compiled_trajectory_equals_eager(name):
    """The same kernels in the same order: compiled = eager, bit for bit."""
    x, y = _data(3)
    runs = []
    for use_jit in (False, True):
        _, tm = _pair(3)
        losses, _ = _train(lt, tm, OPTIMS[name](lt), _t(x), _t(y), 6,
                           use_jit)
        runs.append((losses, _params(tm)))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][n], p, err_msg=n)


def test_zero_arg_closure_step():
    """A step that reads all its tensors from closures."""
    x, y = _data(5)
    res = []
    for pkg, T in ((light, _j), (lt, _t)):
        m = _pair(5)[pkg is lt]
        opt = pkg.optim.SGD(m.parameters(), lr=5e-2, momentum=0.9)
        xs, ys = T(x), T(y)

        def step():
            opt.zero_grad()
            loss = pkg.loss.mse(m(xs), ys)
            loss.backward()
            opt.step()
            return loss

        fn = pkg.jit(step)
        res.append(([float(fn().numpy()) for _ in range(8)], _params(m)))
    (jl, jp), (tl, tp) = res
    assert tl[-1] < tl[0]
    _close(tl, jl, "losses")
    for n in jp:
        _close(tp[n], jp[n], n)


def test_gradient_accumulation_matches_full_batch():
    """Two micro-batch backward passes inside one compiled step accumulate
    to the full-batch gradient; both steps against the JAX package's."""
    x, y = _data(7)
    out = {}
    for pkg, T in ((light, _j), (lt, _t)):
        xt, yt = T(x), T(y)
        xa, xb, ya, yb = (xt.narrow(0, 8), xt.narrow(8, 8), yt.narrow(0, 8),
                          yt.narrow(8, 8))
        ma, mf = _pair(11)[pkg is lt], _pair(11)[pkg is lt]
        oa = pkg.optim.Adam(ma.parameters(), lr=1e-2)
        of = pkg.optim.Adam(mf.parameters(), lr=1e-2)

        def step_accum():
            oa.zero_grad()
            for mx, my in ((xa, ya), (xb, yb)):
                loss = pkg.loss.mse(ma(mx), my) * 0.5
                loss.backward()
            oa.step()
            return loss

        def step_full():
            of.zero_grad()
            loss = pkg.loss.mse(mf(xt), yt)
            loss.backward()
            of.step()
            return loss

        fa, ff = pkg.jit(step_accum), pkg.jit(step_full)
        for _ in range(4):
            fa(), ff()
        out[pkg is lt] = _params(ma), _params(mf)
    (ja, jf), (ta, tf) = out[False], out[True]
    for n in ja:
        np.testing.assert_allclose(ta[n], tf[n], rtol=2e-4, atol=2e-5,
                                   err_msg=n)
        _close(ta[n], ja[n], n)
        _close(tf[n], jf[n], n)


@pytest.fixture(scope="module")
def jax_scaler():
    """The JAX package's scaler-growth case: 7 good compiled bf16 steps at
    growth_interval 3, the scale after each and the master weights."""
    x, y = _data(7)
    jm, _ = _pair(7)
    scaler = light.amp.GradScaler(init_scale=4.0, growth_factor=2.0,
                                  growth_interval=3)
    mp = light.amp.MixedPrecision(jm, lambda ps: light.optim.Adam(
        ps, lr=1e-3), scaler=scaler)
    xb = _j(x).astype(mp.compute_dtype).detach()._set_requires_grad(False)
    yb = _j(y).astype(mp.compute_dtype).detach()._set_requires_grad(False)

    def step(a, b):
        loss = light.loss.mse(jm(a), b)
        mp.zero_grad()
        mp.scale(loss).backward()
        mp.step()
        return loss

    fn = light.jit(step)
    scales, losses = [], []
    for _ in range(7):
        losses.append(float(fn(xb, yb).numpy()))
        scales.append(scaler.scale_value())
    return scales, losses, [m.numpy() for m in mp.masters]


def test_scaler_growth_inside_jit(jax_scaler):
    """Dynamic loss-scale growth across compiled steps: the scaler's state
    is device tensors updated in place, so the step reads and writes it
    at every run (two growths in 7 steps at growth_interval 3)."""
    want_scales, want_losses, want_masters = jax_scaler
    x, y = _data(7)
    _, tm = _pair(7)
    scaler = lt.amp.GradScaler(init_scale=4.0, growth_factor=2.0,
                               growth_interval=3)
    mp = lt.amp.MixedPrecision(tm, lambda ps: lt.optim.Adam(ps, lr=1e-3),
                               scaler=scaler)
    xb = _t(x).astype(mp.compute_dtype).detach()._set_requires_grad(False)
    yb = _t(y).astype(mp.compute_dtype).detach()._set_requires_grad(False)

    def step(a, b):
        loss = lt.loss.mse(tm(a), b)
        mp.zero_grad()
        mp.scale(loss).backward()
        mp.step()
        return loss

    fn = lt.jit(step)
    scales, losses = [], []
    for _ in range(7):
        losses.append(float(fn(xb, yb).numpy()))
        scales.append(scaler.scale_value())
    assert scales == want_scales
    assert scales[-1] == pytest.approx(16.0)
    np.testing.assert_allclose(losses, want_losses, rtol=5e-2)
    for m, w in zip(mp.masters, want_masters):
        np.testing.assert_allclose(m.numpy(), w, rtol=5e-2, atol=1e-3)


def test_overflow_skips_the_step_inside_jit():
    """A non-finite gradient inside a compiled step: the gate skips it
    (masters, compute weights and Adam's state untouched) and the scale
    backs off, on the device; the next step trains again."""
    x, y = _data(9)
    _, tm = _pair(9)
    scaler = lt.amp.GradScaler(init_scale=8.0, growth_interval=100)
    mp = lt.amp.MixedPrecision(tm, lambda ps: lt.optim.Adam(ps, lr=1e-3),
                               scaler=scaler)
    xb = _t(x).astype(mp.compute_dtype).detach()._set_requires_grad(False)
    yb = _t(y).astype(mp.compute_dtype).detach()._set_requires_grad(False)
    bad = _t(np.full((16, 3), np.inf, np.float32)).astype(mp.compute_dtype)
    bad = bad.detach()._set_requires_grad(False)

    def step(a, b):
        loss = lt.loss.mse(tm(a), b)
        mp.zero_grad()
        mp.scale(loss).backward()
        mp.step()
        return loss

    fn = lt.jit(step)
    fn(xb, yb), fn(xb, yb)                  # record, compile + run
    before = [m.numpy() for m in mp.masters] + [v.numpy()
                                                for v in mp.optim.v]
    t_before = float(mp.optim.t)
    fn(xb, bad)                             # the same signature: a replay
    assert scaler.scale_value() == 4.0
    after = [m.numpy() for m in mp.masters] + [v.numpy()
                                               for v in mp.optim.v]
    for a, b in zip(after, before):
        np.testing.assert_array_equal(a, b)
    assert float(mp.optim.t) == t_before
    fn(xb, yb)
    assert not np.array_equal(mp.masters[0].numpy(), before[0])


def test_seeded_device_init_trains():
    """The counterpart of the JAX package's ``set_device_init``: the
    tape's initializers draw from the seeded ``random`` generator, so one
    seed gives one set of parameters, and two models from one seed train
    to the same parameters compiled and eagerly."""
    x, y = _data(2)
    models = []
    for _ in range(3):
        lt.random.seed(11)
        models.append(TTwoLayer())
    a, b, c = models
    for n, p in _params(a).items():
        np.testing.assert_array_equal(_params(b)[n], p)
    assert a.l1.weight.numpy().std() > 0
    _train(lt, b, OPTIMS["adam"](lt), _t(x), _t(y), 4, False)
    _train(lt, c, OPTIMS["adam"](lt), _t(x), _t(y), 4, True)
    for n, p in _params(b).items():
        np.testing.assert_array_equal(_params(c)[n], p, err_msg=n)


def test_capture_failure_raises_without_eager_fallback():
    """A host read inside the step: the recording call runs it eagerly
    (its real result), the compiling call raises CaptureError naming the
    contract and the op, and nothing is run eagerly instead -- the
    parameters keep the recording step's values."""
    w = lt.Tensor.from_numpy(np.ones((3,), np.float32))
    calls = []

    def step(x):
        calls.append(1)
        scale = float((x * 0 + 2).sum().item()) / 3.0
        return x * w * scale

    fn = lt.jit(step)
    x = _t(np.arange(3, dtype=np.float32))
    np.testing.assert_allclose(fn(x).numpy(), np.arange(3) * 2.0)
    with pytest.raises(jit_mod.CaptureError, match=r"numpy\(\) / \.item\(\)"
                       r".*no host synchronisation"):
        fn(x)
    np.testing.assert_array_equal(w.numpy(), np.ones(3, np.float32))


def test_upload_of_a_changing_host_array_raises():
    """A host array inside the step is a constant of the step: one the
    recording step uploaded is read in place; a new value raises."""
    rng = np.random.default_rng(0)
    fixed = np.arange(4, dtype=np.float32)

    def step(x):
        c = lt.Tensor.from_numpy(fixed, requires_grad=False)
        return x + c

    fn = lt.jit(step)
    x = _t(np.ones(4, np.float32))
    for _ in range(3):
        np.testing.assert_array_equal(fn(x).numpy(), fixed + 1)

    def noisy(x):
        return x + lt.Tensor.from_numpy(rng.standard_normal(4).astype(
            np.float32), requires_grad=False)

    fn = lt.jit(noisy)
    fn(x)
    with pytest.raises(jit_mod.CaptureError, match="did not upload"):
        fn(x)


def test_no_abstract_discovery():
    """The first call is a real eager step, not an abstract trace: the step
    sees concrete values, and its result and parameters are an eager
    step's bit for bit; the second call compiles and runs the next one."""
    x, y = _data(4)
    _, eager = _pair(4)
    want, _ = _train(lt, eager, OPTIMS["adam"](lt), _t(x), _t(y), 2, False)
    _, tm = _pair(4)
    opt = lt.optim.Adam(tm.parameters(), lr=1e-2)
    seen = []

    def step(a, b):
        opt.zero_grad()
        loss = lt.loss.mse(tm(a), b)
        if not seen:
            seen.append(loss.numpy())       # legal while recording only
        loss.backward()
        opt.step()
        return loss

    fn = lt.jit(step)
    first = float(fn(_t(x), _t(y)).numpy())
    assert first == want[0] == float(seen[0])
    assert float(fn(_t(x), _t(y)).numpy()) == want[1]
    for n, p in _params(eager).items():
        np.testing.assert_array_equal(_params(tm)[n], p, err_msg=n)


# --- tests/test_fuzz_jit.py's random Sequentials -----------------------------
def _random_model(nn_mod, rng):
    layers = []
    if rng.random() < 0.5:
        ch = int(rng.integers(2, 5))
        layers += [nn_mod.Conv2d(1, ch, kernelsize=3, pad="same"),
                   nn_mod.ReLU(), nn_mod.Flatten()]
        feats = ch * 36
    else:
        layers.append(nn_mod.Flatten())
        feats = 36
    width = int(rng.integers(8, 24))
    layers.append(nn_mod.Linear(feats, width))
    for _ in range(int(rng.integers(1, 3))):
        kind = rng.integers(0, 4)
        if kind == 0:
            layers.append(nn_mod.GELU())
        elif kind == 1:
            layers.append(nn_mod.Tanh())
        elif kind == 2:
            layers.append(nn_mod.LayerNorm(width))
        else:
            layers.append(nn_mod.ReLU())
            layers.append(nn_mod.Linear(width, width))
    layers.append(nn_mod.Linear(width, 5))
    return nn_mod.Sequential(*layers)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_random_sequential_against_jax(seed):
    """A random small Sequential (conv or linear front, random middle), 4
    compiled Adam / SGD steps: the parameters within f32 1e-5 relative of
    the JAX package's ``light.jit`` from the same weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 1, 6, 6)).astype(np.float32)
    y = rng.integers(0, 5, 8).astype(np.int32)
    np.random.seed(seed)
    jm = _random_model(jnn, np.random.default_rng(seed + 100))
    tm = _random_model(tnn, np.random.default_rng(seed + 100))
    lt.load_numpy_params(tm, {n: p.numpy()
                              for n, p in jm.named_parameters()})
    out = []
    for pkg, m, T in ((light, jm, _j), (lt, tm, _t)):
        opt = (pkg.optim.Adam(m.parameters(), lr=1e-2) if seed % 2 else
               pkg.optim.SGD(m.parameters(), lr=5e-2))
        xs, ys = T(x), T(y)

        def step():
            loss = pkg.loss.cross_entropy(m(xs), ys)
            opt.zero_grad()
            loss.backward()
            opt.step()
            return loss

        fn = pkg.jit(step)
        with jax_kernel_mode("xla"):
            losses = [fn().item() for _ in range(4)]
        out.append((losses, _params(m)))
    (jl, jp), (tl, tp) = out
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)


# --- the rest of the contract -------------------------------------------------
def test_schedule_lr_reaches_the_compiled_step():
    """WarmupCosine writes the lr tensor in place between calls; the
    compiled step reads each new value (against the JAX package)."""
    x, y = _data(6)
    out = []
    for pkg, T in ((light, _j), (lt, _t)):
        m = _pair(6)[pkg is lt]
        opt = pkg.optim.Adam(m.parameters(), lr=3e-2)
        sched = pkg.schedule.WarmupCosine(opt, warmup=3, total=10)
        xs, ys = T(x), T(y)

        def step(a, b):
            opt.zero_grad()
            loss = pkg.loss.mse(m(a), b)
            loss.backward()
            opt.step()
            return loss

        fn = pkg.jit(step)
        losses, lrs = [], []
        for _ in range(8):
            losses.append(float(fn(xs, ys).numpy()))
            lrs.append(sched.step())
        out.append((losses, lrs, _params(m)))
    (jl, jlr, jp), (tl, tlr, tp) = out
    np.testing.assert_array_equal(np.float32(tlr), np.float32(jlr))
    _close(tl, jl, "losses")
    for n in jp:
        _close(tp[n], jp[n], n)


def test_one_graph_per_shape_signature(monkeypatch):
    """A second shape records again; the first shape, on its return, is
    run from its slots, not recorded."""
    records = []
    record = jit_mod._CompiledStep._record
    monkeypatch.setattr(jit_mod._CompiledStep, "_record",
                        lambda self, sig, args: records.append(sig)
                        or record(self, sig, args))
    _, tm = _pair(1)
    fn = lt.jit(lambda a: tm(a))
    x8, x4 = _t(_data(1, 8)[0]), _t(_data(1, 4)[0])
    fn(x8), fn(x8)
    state = fn.cache[fn._signature((x8,))]
    assert len(records) == 1 and state.compiled
    fn(x4)
    assert len(records) == 2 and len(fn.cache) == 2
    got = fn(x8).numpy()
    assert len(records) == 2
    assert fn.cache[fn._signature((x8,))] is state
    with lt.no_grad():
        np.testing.assert_array_equal(got, tm(x8).numpy())


def test_static_arguments_are_part_of_the_signature():
    """A non-tensor argument is baked into its program: another value
    records another one."""
    fn = lt.jit(lambda a, k: a * k)
    x = _t(np.ones(3, np.float32))
    for k in (2.0, 2.0, 3.0, 3.0, 2.0):
        np.testing.assert_array_equal(fn(x, k).numpy(), np.full(3, k))
    assert len(fn.cache) == 2


@pytest.mark.parametrize("rebind_after", [1, 3])
def test_rebind_invalidates_captures(rebind_after, monkeypatch):
    """Rebinding a module's parameter moves the capture epoch: the same
    compiled step records again and trains the new tensor under an
    optimizer rebuilt over it, as eager does, whether the rebind falls
    between the record and the compile (after call 1) or after the
    compile (after call 3).  A record the epoch has left behind is never
    compiled."""
    compiled = []
    compile_ = jit_mod._CompiledStep._compile

    def spy(self, state, args):
        assert state.epoch == jit_mod._capture_epoch
        compiled.append(state)
        return compile_(self, state, args)

    monkeypatch.setattr(jit_mod._CompiledStep, "_compile", spy)
    x, y = _data(8)
    runs = []
    for use_jit in (False, True):
        _, tm = _pair(8)
        opts = [lt.optim.SGD(tm.parameters(), lr=5e-2)]

        def step(a, b, tm=tm, opts=opts):
            opts[0].zero_grad()
            loss = lt.loss.mse(tm(a), b)
            loss.backward()
            opts[0].step()
            return loss

        fn = lt.jit(step) if use_jit else step
        losses = [float(fn(_t(x), _t(y)).numpy())
                  for _ in range(rebind_after)]
        epoch = jit_mod._capture_epoch
        tm.l2.bias = lt.Tensor.from_numpy(np.full((3,), 0.5, np.float32))
        assert jit_mod._capture_epoch == epoch + 1
        opts[0] = lt.optim.SGD(tm.parameters(), lr=5e-2)
        losses += [float(fn(_t(x), _t(y)).numpy()) for _ in range(3)]
        runs.append((losses, _params(tm)))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][n], p, err_msg=n)
    assert runs[0][1]["l2.bias"].tolist() != [0.5] * 3
    assert len(compiled) == 1 + (rebind_after > 1)


class _TorchTwoLayer(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.l1 = torch.nn.Linear(6, 16)
        self.l2 = torch.nn.Linear(16, 3)
        self.register_buffer("shift", torch.full((3,), 0.25))
        with torch.no_grad():
            for q in self.parameters():
                q.copy_(torch.rand(q.shape, generator=g) - 0.5)

    def forward(self, x):
        return self.l2(torch.relu(self.l1(x))) + self.shift


def _rebind_torch(kind, model):
    """A change to a ``torch.nn`` model's state after which a graph that
    read the old buffers would be stale; values stay those of an eager
    run's same change."""
    if kind == "setattr":
        model.l2.bias = torch.nn.Parameter(torch.full((3,), 0.5))
    elif kind == "assign":
        sd = {k: v.clone() + 0.125 for k, v in model.state_dict().items()}
        model.load_state_dict(sd, assign=True)
    else:                                   # .to(): new buffers, same values
        model.double().float()


@pytest.mark.parametrize("kind", ["setattr", "assign", "to"])
def test_torch_nn_state_change_records_again(kind):
    """A step over ``torch.nn`` modules (the port's GPT is one) reads
    parameters no tape hook sees: the guard keys the called modules'
    parameters and buffers, so a new ``Parameter``, a
    ``load_state_dict(assign=True)`` or a ``.to()`` after compiling makes
    the step record again; the trajectory equals eager's."""
    x, y = (torch.from_numpy(a) for a in _data(5))
    runs = []
    for use_jit in (False, True):
        model = _TorchTwoLayer()
        opts = [lt.optim.Adam(list(model.parameters()), lr=1e-2)]

        def step(a, b, model=model, opts=opts):
            opts[0].zero_grad()
            loss = ((model(a) - b) ** 2).mean()
            loss.backward()
            opts[0].step()
            return loss

        fn = lt.jit(step) if use_jit else step
        losses = [float(fn(x, y).detach()) for _ in range(3)]
        _rebind_torch(kind, model)
        if use_jit:
            assert fn._stale(next(iter(fn.cache.values())))
        opts[0] = lt.optim.Adam(list(model.parameters()), lr=1e-2)
        losses += [float(fn(x, y).detach()) for _ in range(3)]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
        if use_jit:
            assert not fn._stale(next(iter(fn.cache.values())))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_load_after_compiling_records_again():
    """``load_numpy_params`` rebinds the captured buffers: the guard sees
    buffers the graph does not read, the step records again and trains
    the loaded weights (equal to an eager run from them)."""
    x, y = _data(12)
    loaded = _params(_pair(13)[1])
    runs = []
    for use_jit in (False, True):
        _, tm = _pair(12)
        opt = lt.optim.SGD(tm.parameters(), lr=5e-2, momentum=0.9)

        def step(a, b, tm=tm, opt=opt):
            opt.zero_grad()
            loss = lt.loss.mse(tm(a), b)
            loss.backward()
            opt.step()
            return loss

        fn = lt.jit(step) if use_jit else step
        for _ in range(3):
            fn(_t(x), _t(y))
        lt.load_numpy_params(tm, loaded)
        if use_jit:
            assert fn._stale(next(iter(fn.cache.values())))
        for _ in range(3):
            fn(_t(x), _t(y))
        runs.append(_params(tm))
    for n, p in runs[0].items():
        np.testing.assert_array_equal(runs[1][n], p, err_msg=n)


def test_frozen_capture_rebound_records_again():
    """A capture the step only reads (a frozen weight) is read in place;
    rebinding it makes the step record again and read the new value."""
    w = lt.Tensor.from_numpy(np.full((3,), 2.0, np.float32),
                             requires_grad=False)
    fn = lt.jit(lambda a: a * w)
    x = _t(np.ones(3, np.float32))
    fn(x), fn(x)
    w._set_data(torch.full((3,), 5.0))
    np.testing.assert_array_equal(fn(x).numpy(), np.full(3, 5.0))
    np.testing.assert_array_equal(fn(x).numpy(), np.full(3, 5.0))


def test_returned_tensors_stay_valid():
    """Outputs are copied out of the step's buffers: a returned tensor
    keeps its value after the next calls (JAX returns fresh arrays)."""
    _, tm = _pair(2)
    opt = lt.optim.Adam(tm.parameters(), lr=1e-1)
    x, y = _data(2)

    def step(a, b):
        opt.zero_grad()
        out = tm(a)
        loss = lt.loss.mse(out, b)
        loss.backward()
        opt.step()
        return {"loss": loss, "out": out, "n": 3}

    fn = lt.jit(step)
    res = [fn(_t(x), _t(y)) for _ in range(4)]
    kept = [(float(r["loss"].numpy()), r["out"].numpy().copy()) for r in res]
    for _ in range(3):
        fn(_t(x), _t(y))
    for r, (loss, out) in zip(res, kept):
        assert float(r["loss"].numpy()) == loss and r["n"] == 3
        np.testing.assert_array_equal(r["out"].numpy(), out)
    assert len({loss for loss, _ in kept}) == 4


def test_post_call_state_matches_jax(monkeypatch):
    """After each call the parameters, Adam's state and ``p.grad`` hold
    what the JAX package's (eager-recording) ``light.jit`` leaves: the
    recording step's gradients stay in ``p.grad`` (a compiled step does
    not rebind what the recording step created)."""
    monkeypatch.setenv("LIGHTGRAD_RECORD", "eager")
    x, y = _data(14)
    jm, tm = _pair(14)
    res = []
    for pkg, m, T in ((light, jm, _j), (lt, tm, _t)):
        opt = pkg.optim.Adam(m.parameters(), lr=1e-2)

        def step(a, b):
            opt.zero_grad()
            loss = pkg.loss.mse(m(a), b)
            loss.backward()
            opt.step()
            return loss

        fn = pkg.jit(step)
        states = []
        for _ in range(4):
            fn(T(x), T(y))
            states.append((_params(m),
                           [g.grad.numpy() for g in m.parameters()],
                           [np.array(v.numpy() if hasattr(v, "numpy")
                                     else v) for v in opt.m + opt.v],
                           float(np.asarray(opt.t.numpy()))))
        res.append(states)
    for (jp, jg, jmv, jt), (tp, tg, tmv, tt) in zip(*res):
        assert tt == jt
        for n in jp:
            _close(tp[n], jp[n], n)
        for a, b in zip(tg, jg):
            _close(a, b, "grad")
        for a, b in zip(tmv, jmv):
            _close(a, b, "moment")


def test_aliased_captures_get_their_own_slots():
    """Two rebound captures that share one buffer (a copy aliases, by
    value semantics) each get a slot of their own: they train apart, as
    eagerly."""
    x, y = _data(15)
    out = []
    for use_jit in (False, True):
        _, tm = _pair(15)
        shadow = tm.l1.weight.copy()            # shares l1.weight's buffer
        opt = lt.optim.Adam(tm.parameters(), lr=1e-2)

        def step(a, b, tm=tm, opt=opt, shadow=shadow):
            opt.zero_grad()
            loss = lt.loss.mse(tm(a), b)
            loss.backward()
            opt.step()
            with lt.no_grad():
                shadow *= 0.5
            return loss

        fn = lt.jit(step) if use_jit else step
        for _ in range(4):
            fn(_t(x), _t(y))
        out.append((tm.l1.weight.numpy(), shadow.numpy()))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_batchnorm_buffers_written_back():
    """BatchNorm's running statistics are rebound by the step: written
    back into their slots, equal to the eager run's."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal((4, 2, 5, 5)).astype(np.float32)
    y = rng.integers(0, 3, 4).astype(np.int32)
    out = []
    for use_jit in (False, True):
        lt.random.seed(16)
        m = tnn.Sequential(tnn.Conv2d(2, 3, kernelsize=3, pad=1),
                           tnn.BatchNorm2d(3), tnn.ReLU(), tnn.Flatten(),
                           tnn.Linear(75, 3))
        opt = lt.optim.SGD(m.parameters(), lr=1e-1)

        def step(a, b, m=m, opt=opt):
            loss = lt.loss.cross_entropy(m(a), b)
            opt.zero_grad()
            loss.backward()
            opt.step()
            return loss

        fn = lt.jit(step) if use_jit else step
        for _ in range(4):
            fn(_t(x), _t(y))
        out.append({n: b.numpy() for n, b in m.named_buffers()})
    assert out[0] and set(out[0]) == set(out[1])
    for n, b in out[0].items():
        np.testing.assert_array_equal(out[1][n], b, err_msg=n)


def test_dropout_draws_afresh_each_call():
    """Dropout inside the step draws from the tape's generator at every
    run: compiled = eager under one seed, and two calls differ."""
    x = np.ones((64, 32), np.float32)
    outs = []
    for use_jit in (False, True):
        lt.random.seed(21)
        drop = tnn.Dropout(0.5)
        fn = lt.jit(lambda a: drop(a)) if use_jit else (lambda a: drop(a))
        outs.append([fn(_t(x)).numpy() for _ in range(4)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(outs[1][2], outs[1][3])


def test_argument_written_by_the_step():
    """A step that rebinds its tensor argument hands the result back to the
    caller's tensor, as the JAX package does."""
    def step(a):
        with lt.no_grad():
            a += 1.0
        return a * 2.0

    fn = lt.jit(step)
    for k in range(3):
        x = _t(np.full(3, float(k), np.float32))
        np.testing.assert_array_equal(fn(x).numpy(), np.full(3, 2 * k + 2))
        np.testing.assert_array_equal(x.numpy(), np.full(3, k + 1))


def test_diffusion_sampler_compiled_equals_eager():
    """``sample`` / ``sample_ddim`` with ``jit=lightgrad_tpu_torch.jit``:
    the same images as the eager sampler under one seed."""
    from lightgrad_tpu_torch.models import Diffusion, UNet

    lt.random.seed(0)
    dif = Diffusion(UNet(in_channels=1, base=8), timesteps=4)
    a = dif.sample(2, shape=(1, 8, 8), seed=3).numpy()
    b = dif.sample(2, shape=(1, 8, 8), seed=3, jit=lt.jit).numpy()
    np.testing.assert_array_equal(a, b)
    c = dif.sample_ddim(2, steps=3, eta=1.0, shape=(1, 8, 8), seed=3).numpy()
    d = dif.sample_ddim(2, steps=3, eta=1.0, shape=(1, 8, 8), seed=3,
                        jit=lt.jit).numpy()
    np.testing.assert_array_equal(c, d)


# --- the models and examples that compile through jit ----------------------
def test_neox_recompute_decode_matches_jax():
    """NeoX's ``generate``: the window's forward compiled once
    (``_decode_fn``), greedy tokens equal to the JAX model's compiled
    recompute decode."""
    cfg = dict(vocab_size=61, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=2,
               max_position_embeddings=16, rotary_pct=0.5)
    np.random.seed(0)
    jm = JNeoX(JNeoXConfig(**cfg))
    tm = NeoX(NeoXConfig(**cfg))
    lt.load_numpy_params(tm, {n: p.numpy()
                              for n, p in jm.named_parameters()})
    prompt = [3, 14, 15, 9, 2, 6]
    with jax_kernel_mode("xla"):
        want = jm.generate(prompt, max_new_tokens=12)
    got = tm.generate(prompt, max_new_tokens=12)
    assert got == [int(t) for t in want]
    assert len(tm._decode_fn.cache) == 1 and \
        next(iter(tm._decode_fn.cache.values())).compiled


def test_llama_recompute_decode_matches_jax():
    """LLaMA's ``generate(use_cache=False)`` through the compiled window
    forward, greedy tokens equal to the JAX model's."""
    cfg = dict(vocab_size=61, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=16)
    np.random.seed(1)
    jm = JLlama(JLlamaConfig(**cfg))
    tm = Llama(LlamaConfig(**cfg))
    lt.load_numpy_params(tm, {n: p.numpy()
                              for n, p in jm.named_parameters()})
    prompt = [5, 1, 40, 7]
    with jax_kernel_mode("xla"):
        want = jm.generate(prompt, max_new_tokens=14, use_cache=False)
    got = tm.generate(prompt, max_new_tokens=14, use_cache=False)
    assert got == [int(t) for t in want]
    assert len(tm._decode_fn.cache) == 1


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_mnist_compiled_step_matches_the_jax_script(kind):
    """The MNIST example's compiled step against the JAX script's
    (``examples/mnist.py``: ``light.jit`` of a step that narrows the
    device-resident set at a traced offset), 4 steps from one set of
    weights."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_example_mnist", os.path.join(root, "examples", "mnist.py"))
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    rng = np.random.default_rng(17)
    batch = 8
    xs = rng.random((4 * batch, 28, 28)).astype(np.float32)
    ys = rng.integers(0, 10, 4 * batch).astype(np.int32)

    np.random.seed(17)
    jm = jex.MLP() if kind == "mlp" else jex.CNN()
    jopt = light.optim.AdaBelief(jm.parameters(),
                                 lr=1e-3 if kind == "mlp" else 3e-3)
    tm, topt = mnist.build(kind)
    lt.load_numpy_params(tm, {n: p.numpy()
                              for n, p in jm.named_parameters()})
    jx, jy = _j(xs), _j(ys)

    def jstep(off):
        x = jx.narrow(off, batch)
        y = jy.narrow(off, batch)
        out = jm(x.reshape(batch, -1) if kind == "mlp"
                 else x.reshape(batch, 1, 28, 28))
        loss = light.loss.cross_entropy(out, y)
        jopt.zero_grad()
        loss.backward()
        jopt.step()
        return loss

    jfn = light.jit(jstep)
    tfn = lt.jit(lambda x, y: mnist.train_step(tm, topt, kind, x, y))
    tx, ty = _t(xs), _t(ys)
    with jax_kernel_mode("xla"):
        want = [float(jfn(_j(np.int32(i * batch))).numpy())
                for i in range(4)]
    got = [float(tfn(tx.narrow(i * batch, batch),
                     ty.narrow(i * batch, batch)).numpy()) for i in range(4)]
    _close(got, want, "losses")
    for n, p in _params(jm).items():
        _close(_params(tm)[n], p, n)


def _example(name):
    """(model, step, args) of an example's own builder and step at a small
    batch, from its seeded start."""
    from lightgrad_tpu_torch.examples import diffusion, gpt, llama, resnet, t5

    rng = np.random.default_rng(0)
    if name == "resnet":
        model, opt = resnet.build()
        return model, (lambda a, b: resnet.train_step(model, opt, a, b)), (
            _t(rng.random((4, 784)).astype(np.float32)),
            _t(rng.integers(0, 10, 4).astype(np.int32)))
    if name == "gpt":
        model, opt = gpt.build(20, 16, "cpu")
        ids = torch.from_numpy(rng.integers(0, 20, (2, 17)))
        return model, (lambda a, b: gpt.train_step(model, opt, a, b)), (
            ids[:, :-1].contiguous(), ids[:, 1:].contiguous())
    if name.startswith("llama"):
        model, opt = llama.build(20, 16, use_amp=name == "llama_amp")
        ids = rng.integers(0, 20, (2, 17)).astype(np.int32)
        return model, (lambda a, b: llama.train_step(model, opt, a, b)), (
            _t(ids[:, :-1]), _t(ids[:, 1:]))
    if name == "t5":
        model, opt = t5.build(seq=8)
        src, lab = t5.make_batch(rng, 4, 8)
        return model, (lambda x, d, y: t5.train_step(model, opt, x, d, y)), (
            _t(src), _t(model.shift_right(lab)), _t(lab))
    dif, opt, ema = diffusion.build(timesteps=8, base=8)
    data = _t((rng.random((8, 1, 28, 28)) * 2 - 1).astype(np.float32))
    ti = _t(np.zeros(4, np.int32))
    return dif.model, (lambda off: diffusion.train_step(
        dif, opt, ema, *diffusion.draw(data, ti, off, 4, 8))), (
        _t(np.int32(4)),)


@pytest.mark.parametrize("name", ["resnet", "gpt", "llama", "llama_amp",
                                  "t5", "diffusion"])
def test_example_step_compiled_equals_eager(name):
    """Each example's own step compiled as its ``main`` compiles it: 3
    steps bit for bit the eager steps from the same seeded start (the
    diffusion step draws its timesteps and noise inside, from the tape's
    generator, as its ``main`` does)."""
    runs = []
    for use_jit in (False, True):
        with on_device("cpu"):
            model, step, args = _example(name)
            fn = lt.jit(step) if use_jit else step
            losses = []
            for _ in range(3):
                out = fn(*args)
                losses.append(float(out.detach() if isinstance(
                    out, torch.Tensor) else out.numpy()))
            params = [np.array(p.detach() if isinstance(p, torch.Tensor)
                               else p.numpy()) for p in model.parameters()]
        runs.append((losses, params))
    assert runs[0][0] == runs[1][0], runs
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)
