"""Port parity: the lightgrad tape on ``CudaTensor`` (device "cpu", so every
op runs its kernels' plain versions) against the JAX package's tape on
``TpuTensor``, with the JAX kernels in pallas (interpret) and xla modes.

Every ported backend op: its forward, and the gradient of each input
through ``.backward()`` of a weighted sum.  Then the tape's machinery:
``no_grad``, ``zero_grad``, in-place rebinding (a view taken before
``a += b`` keeps its values), repeated-index gathers that accumulate, the
losses, optimizers and layers over lightgrad tensors, and the
``gradient_descent`` example's loop against JAX."""

import numpy as np
import pytest
import torch

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.autograd import ops as tape_ops
from tests.torch_port import cpu_device, jax_kernel_mode, rand  # noqa: F401

# f32 on both sides, the same formulas; products and sums in another order
TOL = dict(rtol=2e-5, atol=2e-5)


def _arrays(shapes, seed=0, positive=False):
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        x = rand(rng, *s)
        out.append(np.abs(x) + 0.5 if positive else x)
    return out


def _run(pkg_tensor, fn, arrays, grad_of):
    ts = [pkg_tensor.from_numpy(a.copy(), requires_grad=i in grad_of)
          for i, a in enumerate(arrays)]
    y = fn(*ts)
    ys = y if isinstance(y, tuple) else (y,)
    y = ys[0]
    grads = None
    if grad_of:
        w = rand(np.random.default_rng(9), *y.shape)
        loss = (y * pkg_tensor.from_numpy(w, requires_grad=False)).sum()
        loss.backward()
        grads = [ts[i].grad.numpy() for i in grad_of]
    return [t.numpy() for t in ys], grads


def _check(fn, arrays, mode, grad_of=None, tol=TOL):
    grad_of = tuple(range(len(arrays))) if grad_of is None else grad_of
    with jax_kernel_mode(mode):
        jys, jgs = _run(JTensor, fn, arrays, grad_of)
    tys, tgs = _run(TTensor, fn, arrays, grad_of)
    for j, t in zip(jys, tys):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, np.asarray(j, np.float32), **tol)
    for j, t in zip(jgs or (), tgs or ()):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, np.asarray(j, np.float32), **tol)


S = (3, 4, 5)
OPS = {
    # unary
    "neg": (lambda a: -a, [S]),
    "sin": (lambda a: a.sin(), [S]),
    "cos": (lambda a: a.cos(), [S]),
    "exp": (lambda a: a.exp(), [S]),
    "log": (lambda a: a.log(), [S], "positive"),
    "sigmoid": (lambda a: a.sigmoid(), [S]),
    "tanh": (lambda a: a.tanh(), [S]),
    "relu": (lambda a: a.relu(), [S]),
    "gelu": (lambda a: a.gelu(), [S]),
    "gelu_exact": (lambda a: a.gelu_exact(), [S]),
    # binary, broadcast, fused two-gradient backward
    "add": (lambda a, b: a + b, [S, (4, 1)]),
    "sub": (lambda a, b: a - b, [S, (5,)]),
    "mul": (lambda a, b: a * b, [S, (3, 1, 5)]),
    "div": (lambda a, b: a / b, [S, (4, 5)], "positive"),
    "pow": (lambda a, b: a ** b, [S, (5,)], "positive"),
    # with a Python scalar
    "add_scalar": (lambda a: a + 2.0, [S]),
    "mul_scalar": (lambda a: a * 3, [S]),
    "div_scalar": (lambda a: a / 4.0, [S]),
    "pow_scalar": (lambda a: a ** 2.0, [S]),
    "rsub": (lambda a: 2.0 - a, [S]),
    "rdiv": (lambda a: 1.0 / a, [S], "positive"),
    # movement
    "transpose": (lambda a: a.transpose(1, 0, 2), [S]),
    "T": (lambda a: a.T(), [(4, 6)]),
    "reshape": (lambda a: a.reshape(4, -1), [S]),
    "contiguous": (lambda a: a.transpose(2, 0, 1).contiguous(), [S]),
    "getitem_slice": (lambda a: a[1:, ::2], [S]),
    "getitem_int": (lambda a: a[1], [S]),
    "getitem_gather": (lambda a: a[np.array([0, 2, 0, 0])], [S]),
    "getitem_pairs": (lambda a: a[np.arange(3), np.array([1, 1, 3])], [S]),
    "getitem_mixed": (lambda a: a[:, np.array([0, 0, 3])], [S]),
    "narrow": (lambda a: a.narrow(1, 2, axis=1), [S]),
    "concat": (lambda a, b: a.concat(b, axis=1), [S, (3, 2, 5)]),
    "pad": (lambda a: a.pad(2), [S]),
    "pad_value": (lambda a: a.pad((1, 0), dims=(-1,), value=-3.0), [S]),
    # products
    "dot": (lambda a, b: a @ b, [(6, 5), (5, 7)]),
    "dot_batched": (lambda a, b: a @ b, [(2, 3, 6, 5), (2, 3, 5, 4)]),
    "dot_shared": (lambda a, b: a @ b, [(3, 6, 5), (5, 4)]),
    "dot_transposed": (lambda a, b: a @ b.T(1, 0), [(3, 6, 5), (4, 5)]),
    "einsum": (lambda a, b: a.einsum("ijk,kl->jl", b), [S, (5, 2)]),
    # reductions
    "sum": (lambda a: a.sum(), [S]),
    "sum_axis": (lambda a: a.sum(axis=1), [S]),
    "sum_axes_keep": (lambda a: a.sum(axis=(0, 2), keepdims=True), [S]),
    "max": (lambda a: a.max(axis=-1), [S]),
    "min": (lambda a: a.min(axis=0, keepdims=True), [S]),
    "mean": (lambda a: a.mean(axis=(1, 2)), [S]),
    "nan_to_num": (lambda a: a.nan_to_num(), [S]),
    "cumsum": (lambda a: a.cumsum(axis=1), [S]),
    # fused layer ops
    "softmax": (lambda a: a.softmax(axis=-1), [S]),
    "softmax_axis1": (lambda a: a.softmax(axis=1), [S]),
    "layernorm": (lambda a, w, b: a.layernorm(w, b, eps=1e-5),
                  [S, (5,), (5,)]),
    "attention": (lambda q, k, v: q.attention(k, v, scale=0.5),
                  [(2, 8, 4), (2, 8, 4), (2, 8, 4)]),
    "attention_causal": (lambda q, k, v: q.attention(k, v, scale=0.5,
                                                     causal=True),
                         [(2, 8, 4), (2, 8, 4), (2, 8, 4)]),
    "attention_lengths": (lambda q, k, v: q.attention(
        k, v, scale=0.5, lengths=np.array([5, 8], np.int32)),
        [(2, 8, 4), (2, 8, 4), (2, 8, 4)]),
    "astype": (lambda a: a.astype(np.float32) * 2.0, [S]),
    "dropout_eval": (lambda a: a.dropout(p=0.5, training=False), [S]),
    # device-agnostic composites of autograd/ops.py (backends override the
    # first four with fused ops; here the composites themselves run)
    "composite_sigmoid": (lambda a: _composite(a, "sigmoid"), [S]),
    "composite_tanh": (lambda a: _composite(a, "tanh"), [S]),
    "composite_softmax": (lambda a: _composite(a, "softmax"), [S]),
    "composite_gelu": (lambda a: _composite(a, "gelu"), [S]),
    "pool_max": (lambda a: a.max_pool(kernel=(2, 2)), [(2, 5, 6)]),
    "pool_min": (lambda a: a.min_pool(kernel=(2, 3)), [(2, 4, 6)]),
    "pool_mean": (lambda a: a.mean_pool(kernel=(2, 2)), [(2, 4, 4)]),
}


def _composite(t, name):
    mod = tape_ops if isinstance(t, TTensor) else light.autograd.ops
    return getattr(mod, name)(t)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("name", list(OPS))
def test_op_forward_and_gradient_match_jax(name, mode):
    fn, shapes, *flags = OPS[name]
    arrays = _arrays(shapes, positive="positive" in flags)
    _check(fn, arrays, mode)


@pytest.mark.parametrize("tensor_start", [False, True])
@pytest.mark.parametrize("start,axis", [(0, 0), (2, 1), (3, 1), (9, 1),
                                        (-1, 2), (-7, 2)])
def test_narrow_clamps_like_jax(start, axis, tensor_start):
    """``narrow`` with an int or a 0-d int32 tensor start, forward and
    gradient: a start past n - length clamps, a negative one counts from
    the end, as JAX's ``dynamic_slice_in_dim`` does."""

    def fn(a):
        T = type(a)
        st = T.from_numpy(np.int32(start), requires_grad=False) \
            if tensor_start else start
        return a.narrow(st, 2, axis=axis)

    _check(fn, _arrays([S]), "xla")


@pytest.mark.parametrize("name", ["eq", "ge", "gt"])
def test_compare_ops_match_jax(name):
    a, b = _arrays([S, (5,)])
    b[:2] = a[0, 0, :2]                     # some equal pairs
    with jax_kernel_mode("pallas"):
        want = getattr(JTensor.from_numpy(a), name)(
            JTensor.from_numpy(b)).numpy()
    y = getattr(TTensor.from_numpy(a), name)(TTensor.from_numpy(b))
    np.testing.assert_array_equal(y.numpy(), want)


def test_int32_with_float_scalar_promotes():
    """An int32 tensor times a float is float32, as in the JAX package."""
    ids = np.array([[1, 2], [3, 4]], np.int32)
    y = TTensor.from_numpy(ids, requires_grad=False) * 0.5
    jy = JTensor.from_numpy(ids, requires_grad=False) * 0.5
    assert y.dtype == torch.float32 and str(jy.dtype) == "float32"
    np.testing.assert_array_equal(y.numpy(), jy.numpy())


def test_bf16_with_f32_promotes():
    a, b = _arrays([(4, 5), (4, 5)])
    ta = TTensor.from_numpy(a).astype("bfloat16")
    y = ta + TTensor.from_numpy(b)
    assert ta.dtype == torch.bfloat16 and y.dtype == torch.float32


def test_no_grad_records_nothing():
    (a,) = _arrays([S])
    t = TTensor.from_numpy(a)
    with lt.no_grad():
        y = (t * 2.0).exp().sum()
    assert not y.requires_grad and y.ctx is None
    y2 = (t * 2.0).sum()
    assert y2.requires_grad and y2.ctx is not None


def test_zero_grad():
    (a,) = _arrays([S])
    t = TTensor.from_numpy(a)
    (t * t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), 2 * a, **TOL)
    t.zero_grad()
    assert np.all(t.grad.numpy() == 0) and t.grad.shape == S
    u = TTensor.from_numpy(a)
    y = (u * 3.0).sum()
    y.backward()
    y.zero_grad(traverse_graph=True)
    assert np.all(u.grad.numpy() == 0)


def test_inplace_rebinds_and_a_view_keeps_its_values():
    """``a += b`` writes a fresh buffer and rebinds ``a``: a view taken
    before (which shares storage in torch) keeps the old values."""
    a, b = _arrays([(4, 6), (4, 6)])
    ta = TTensor.from_numpy(a, requires_grad=False)
    view = ta.reshape(24)
    tview = ta.transpose(1, 0)
    ptr = ta.data.data_ptr()
    assert view.data.data_ptr() == ptr          # a true view
    ta += TTensor.from_numpy(b, requires_grad=False)
    ta *= 2.0
    assert ta.data.data_ptr() != ptr
    np.testing.assert_array_equal(view.numpy(), a.reshape(24))
    np.testing.assert_array_equal(tview.numpy(), a.T)
    np.testing.assert_allclose(ta.numpy(), (a + b) * 2.0, **TOL)
    ta[1:3] = 7.0
    np.testing.assert_array_equal(view.numpy(), a.reshape(24))
    assert np.all(ta.numpy()[1:3] == 7.0)
    ta.fill(0.5)
    np.testing.assert_array_equal(tview.numpy(), a.T)


def test_inplace_keeps_dtype():
    p = TTensor.from_numpy(np.ones((3,), np.float32)).astype("bfloat16")
    p = p.detach()._set_requires_grad(False)
    p += TTensor.from_numpy(np.full((3,), 0.25, np.float32))
    assert p.dtype == torch.bfloat16


def test_repeated_indices_accumulate():
    """Gathers with repeated indices (embedding rows, loss picks) add every
    occurrence's gradient."""
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[0, 2], [0, 0]], np.int32)
    tw = TTensor.from_numpy(w)
    tw[TTensor.from_numpy(ids, requires_grad=False)].sum().backward()
    jw = JTensor.from_numpy(w)
    jw[JTensor.from_numpy(ids, requires_grad=False)].sum().backward()
    np.testing.assert_array_equal(tw.grad.numpy(), jw.grad.numpy())
    assert tw.grad.numpy()[0, 0] == 3.0


def test_unported_ops_raise():
    t = TTensor.from_numpy(np.ones((1, 1, 4, 4), np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t.ring_attention(t, t)
    # conv is ported: a 3x3 window of ones over ones sums 9 taps
    w = TTensor.from_numpy(np.ones((1, 1, 3, 3), np.float32))
    np.testing.assert_array_equal(t.conv(w).numpy(),
                                  np.full((1, 1, 2, 2), 9.0, np.float32))


def test_random_draws_follow_the_seed():
    lt.random.seed(3)
    a = TTensor.from_numpy(np.zeros((64,), np.float32))
    z1, r1 = a.randn_like(), a.randint_like(0, 7)
    u1 = TTensor.uniform(-2, 2, (64,))
    lt.random.seed(3)
    z2, r2 = a.randn_like(), a.randint_like(0, 7)
    assert r1.dtype == torch.int32 and r1.numpy().min() >= 0 \
        and r1.numpy().max() < 7
    np.testing.assert_array_equal(z1.numpy(), z2.numpy())
    np.testing.assert_array_equal(r1.numpy(), r2.numpy())
    assert np.all(np.abs(u1.numpy()) <= 2) and u1.shape == (64,)
    d = TTensor.from_numpy(np.ones((1000,), np.float32)).dropout(p=0.25)
    kept = d.numpy() != 0
    assert 0.6 < kept.mean() < 0.9
    np.testing.assert_allclose(d.numpy()[kept], 1 / 0.75, rtol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"ignore_index": -100},
                                {"label_smoothing": 0.1},
                                {"ignore_index": 3, "label_smoothing": 0.2}])
def test_tape_cross_entropy_matches_jax(kw):
    rng = np.random.default_rng(4)
    y = rand(rng, 6, 9, scale=2.0)
    labels = rng.integers(0, 9, 6).astype(np.int32)
    labels[[1, 4]] = kw.get("ignore_index", labels[1])
    res = []
    for T, loss in ((JTensor, light.loss), (TTensor, lt.loss)):
        ty = T.from_numpy(y)
        out = loss.cross_entropy(ty, T.from_numpy(labels, requires_grad=False),
                                 **kw)
        out.backward()
        res.append((out.numpy(), ty.grad.numpy()))
    for j, t in zip(*res):
        np.testing.assert_allclose(t, j, **TOL)


def test_tape_mse_matches_jax():
    y, y_hat = _arrays([(5, 3), (5, 3)])
    res = []
    for T, loss in ((JTensor, light.loss), (TTensor, lt.loss)):
        ty = T.from_numpy(y)
        out = loss.mse(ty, T.from_numpy(y_hat, requires_grad=False))
        out.backward()
        res.append((out.numpy(), ty.grad.numpy()))
    for j, t in zip(*res):
        np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("name,kw", [("SGD", dict(lr=0.1, momentum=0.9)),
                                     ("Adam", dict(lr=0.01)),
                                     ("AdamW", dict(lr=0.01))])
def test_optimizers_take_tape_tensors(name, kw):
    """3 steps of each optimizer on lightgrad tensors match the JAX
    package's; zero_grad goes through the tensors' own zero_grad."""
    w0, x = _arrays([(4, 3), (5, 4)])
    out = []
    for T, pkg in ((JTensor, light), (TTensor, lt)):
        w = T.from_numpy(w0.copy())
        opt = getattr(pkg.optim, name)([w], **kw)
        xt = T.from_numpy(x, requires_grad=False)
        for _ in range(3):
            loss = ((xt @ w).tanh() ** 2.0).sum()
            opt.zero_grad()
            loss.backward()
            opt.step()
        out.append(w.numpy())
    np.testing.assert_allclose(out[1], out[0], **TOL)
    norm = lt.optim.clip_grad_norm([w], 1e-3)
    assert float(norm) > 1e-3
    np.testing.assert_allclose(np.linalg.norm(w.grad.numpy()), 1e-3,
                               rtol=1e-3)


def test_layers_match_jax():
    """Linear, Embedding, LayerNorm, Sequential, Dropout (eval), ReLU, GELU,
    Tanh, Flatten: the JAX layers' names, their weights carried across with
    load_numpy_params, the same outputs and gradients."""
    def build(nn):
        return nn.Sequential(nn.Linear(6, 8), nn.GELU(), nn.LayerNorm(8),
                             nn.Dropout(0.3), nn.ReLU(), nn.Linear(8, 4),
                             nn.Tanh(), nn.Flatten())

    jm, tm = build(light.nn), build(lt.nn)
    jnames = [n for n, _ in jm.named_parameters()]
    assert [n for n, _ in tm.named_parameters()] == jnames
    lt.load_numpy_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    jm.eval()
    tm.eval()
    (x,) = _arrays([(5, 6)])
    outs = []
    for T, m in ((JTensor, jm), (TTensor, tm)):
        y = m(T.from_numpy(x, requires_grad=False))
        y.sum().backward()
        outs.append([y.numpy()] + [p.grad.numpy() for p in m.parameters()])
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, j, **TOL)
    sd = tm.state_dict()
    assert list(sd) == jnames
    emb_j, emb_t = light.nn.Embedding(7, 3), lt.nn.Embedding(7, 3)
    emb_t.load_parameters(emb_j.state_dict())
    ids = np.array([[1, 6], [6, 0]], np.int32)
    np.testing.assert_array_equal(
        emb_t(TTensor.from_numpy(ids, requires_grad=False)).numpy(),
        emb_j(JTensor.from_numpy(ids, requires_grad=False)).numpy())
    with pytest.raises(ValueError):
        lt.nn.LayerNorm(8)(TTensor.from_numpy(np.zeros((2, 7), np.float32)))


def _gradient_descent(pkg, T, arrays, epochs=10, lr=0.001):
    a, b, c = (T.from_numpy(x.copy()) for x in arrays)
    losses = []
    for _ in range(epochs):
        y = (a.tanh() + b.sigmoid()) @ (c.relu() - a.sigmoid())
        loss = (y * y).sum()
        for p in (a, b, c):
            p.zero_grad()
        loss.backward()
        with pkg.no_grad():
            for p in (a, b, c):
                p += p.grad * (-lr)
        losses.append(loss.item())
    return losses, [p.numpy() for p in (a, b, c)]


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_gradient_descent_loop_matches_jax(mode):
    """examples/gradient_descent.py's loop (64 x 64), 10 epochs: the same
    losses and tensors as the JAX package."""
    rng = np.random.default_rng(0)
    arrays = [rng.uniform(-1, 1, (64, 64)).astype(np.float32)
              for _ in range(3)]
    with jax_kernel_mode(mode):
        jl, jp = _gradient_descent(light, JTensor, arrays)
    tl_, tp = _gradient_descent(lt, TTensor, arrays)
    assert tl_[-1] < tl_[0]
    np.testing.assert_allclose(tl_, jl, rtol=1e-4)
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5)


def test_package_shortcuts():
    z = lt.zeros((2, 3))
    assert isinstance(z, lt.Tensor) and z.dtype == torch.float32
    assert lt.ones((2,)).numpy().tolist() == [1.0, 1.0]
    x = lt.from_numpy(np.eye(3, dtype=np.float32))
    y = lt.einsum("ij,jk->ik", x, lt.xavier((3, 2)))
    assert y.shape == (3, 2) and lt.Tensor is lt.CudaTensor


def test_graph_is_freed_without_the_cycle_collector():
    """A node holds its output weakly: dropping the loss frees the step's
    graph and its saved buffers by reference counting alone."""
    import gc
    import weakref

    (a,) = _arrays([S])
    t = TTensor.from_numpy(a)
    gc.disable()
    try:
        h = (t * 2.0).exp()
        loss = (h * h).sum()
        loss.backward()
        node, buf = weakref.ref(h.ctx), weakref.ref(h.data)
        del h, loss
        assert node() is None and buf() is None
    finally:
        gc.enable()
    np.testing.assert_allclose(t.grad.numpy(), 4 * np.exp(4 * a), rtol=1e-5)
