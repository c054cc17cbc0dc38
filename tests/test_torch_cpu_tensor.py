"""Port parity: the numpy oracle ``CpuTensor`` and ``utils.gradcheck``.

The port's ``CpuTensor`` against the JAX package's, op by op: the same
numpy inputs, the forward, and the gradient of every input through
``.backward()`` of a weighted sum.  Both run the same numpy calls, and the
derived ops (softmax, GELU, pooling, padding, ``conv_transpose``) the same
formulas, so every op is held to bitwise equality.
Then the JAX package's ``tests/common.py`` checkers on the port's tape:
numpy parity (1e-5), oracle parity of the port's ``CudaTensor`` (device
"cpu", the kernels' plain versions) against the port's ``CpuTensor``
(1e-3), ``assert_gradcheck`` at the reference's 5e-4 on both tensor types;
``.cpu()`` / ``.cuda()`` conversion both ways; and a Linear model whose
parameters were moved to the oracle."""

import numpy as np
import pytest

from lightgrad_tpu.autograd import CpuTensor as JCpu
from lightgrad_tpu.utils import gradcheck as jgradcheck
from lightgrad_tpu_torch import nn
from lightgrad_tpu_torch.autograd import CpuTensor, CudaTensor
from lightgrad_tpu_torch.utils.gradcheck import (assert_gradcheck, gradcheck,
                                                 jacobian, numerical_jacobian)
from tests.torch_port import cpu_device, rand  # noqa: F401

S = (3, 4, 5)
OPS = {
    # movement
    "transpose": (lambda a: a.transpose(1, 0, 2), [S]),
    "T": (lambda a: a.T(), [(4, 6)]),
    "reshape": (lambda a: a.reshape(4, -1), [S]),
    "contiguous": (lambda a: a.transpose(2, 0, 1).contiguous(), [S]),
    "getitem_slice": (lambda a: a[1:, ::2], [S]),
    "getitem_negative_step": (lambda a: a[:, ::-1, 1:], [S]),
    "getitem_gather": (lambda a: a[np.array([0, 2, 0, 0])], [S]),
    "getitem_pairs": (lambda a: a[np.arange(3), np.array([1, 1, 3])], [S]),
    "narrow": (lambda a: a.narrow(1, 2, axis=1), [S]),
    "concat": (lambda a, b: a.concat(b, axis=1), [S, (3, 2, 5)]),
    "pad": (lambda a: a.pad(2), [S]),
    "pad_value": (lambda a: a.pad((1, 0), dims=(-1,), value=-3.0), [S]),
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
    # binary with broadcasts, and with Python scalars
    "add": (lambda a, b: a + b, [S, (4, 1)]),
    "sub": (lambda a, b: a - b, [S, (5,)]),
    "mul": (lambda a, b: a * b, [S, (3, 1, 5)]),
    "div": (lambda a, b: a / b, [S, (4, 5)], "positive"),
    "pow": (lambda a, b: a ** b, [S, (5,)], "positive"),
    "pow_negative": (lambda a: a ** -0.5, [S], "positive"),
    "rsub": (lambda a: 2.0 - a, [S]),
    "rdiv": (lambda a: 1.0 / a, [S], "positive"),
    # products
    "dot": (lambda a, b: a @ b, [(6, 5), (5, 7)]),
    "dot_batched": (lambda a, b: a @ b, [(2, 3, 6, 5), (2, 3, 5, 4)]),
    "dot_shared": (lambda a, b: a @ b, [(3, 6, 5), (5, 4)]),
    "einsum": (lambda a, b: a.einsum("ijk,kl->jl", b), [S, (5, 2)]),
    # reductions
    "sum": (lambda a: a.sum(), [S]),
    "sum_axes_keep": (lambda a: a.sum(axis=(0, 2), keepdims=True), [S]),
    "max": (lambda a: a.max(axis=-1), [S]),
    "min": (lambda a: a.min(axis=0, keepdims=True), [S]),
    "mean": (lambda a: a.mean(axis=(1, 2)), [S]),
    "nan_to_num": (lambda a: a.nan_to_num(), [S]),
    "cumsum": (lambda a: a.cumsum(axis=1), [S]),
    "softmax": (lambda a: a.softmax(axis=1), [S]),
    "astype": (lambda a: a.astype(np.float32) * 2.0, [S]),
    "dropout_eval": (lambda a: a.dropout(p=0.5, training=False), [S]),
    # convolution and the layers over it
    "conv": (lambda x, w: x.conv(w), [(2, 3, 6, 6), (4, 3, 3, 3)]),
    "conv_strided_dilated": (lambda x, w: x.conv(w, strides=2, dilation=2),
                             [(2, 2, 9, 9), (3, 2, 3, 3)]),
    "conv_groups": (lambda x, w: x.conv(w, groups=2),
                    [(2, 4, 5, 5), (6, 2, 3, 3)]),
    "conv_1d": (lambda x, w: x.conv(w, strides=2), [(2, 3, 9), (4, 3, 3)]),
    "conv_3d": (lambda x, w: x.conv(w), [(1, 2, 4, 4, 4), (3, 2, 2, 2, 2)]),
    "conv_transpose": (lambda x, w: x.conv_transpose(w, strides=2, pad=1),
                       [(2, 3, 4, 4), (3, 2, 4, 4)]),
    "max_pool": (lambda a: a.max_pool(kernel=(2, 2)), [(2, 5, 6)]),
    "max_pool2d": (lambda a: a.max_pool2d(kernel=3, stride=2, padding=1),
                   [(1, 2, 7, 7)]),
    "mean_pool": (lambda a: a.mean_pool(kernel=(2, 2)), [(2, 4, 4)]),
}
def _arrays(shapes, seed=0, positive=False):
    rng = np.random.default_rng(seed)
    return [np.abs(rand(rng, *s)) + 0.5 if positive else rand(rng, *s)
            for s in shapes]


def _run(cls, fn, arrays):
    ts = [cls.from_numpy(a.copy()) for a in arrays]
    y = fn(*ts)
    w = rand(np.random.default_rng(9), *y.shape)
    (y * cls.from_numpy(w, requires_grad=False)).sum().backward()
    return y.numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("name", list(OPS))
def test_op_matches_the_jax_oracle_bitwise(name):
    fn, shapes, *flags = OPS[name]
    arrays = _arrays(shapes, positive="positive" in flags)
    jy, jgs = _run(JCpu, fn, arrays)
    ty, tgs = _run(CpuTensor, fn, arrays)
    for what, t, j in [("forward", ty, jy)] + [
            (f"gradient {i}", t, j) for i, (t, j) in enumerate(zip(tgs, jgs))]:
        assert t.dtype == j.dtype and t.shape == j.shape, (name, what)
        assert np.array_equal(t, j), f"{name} {what}"


@pytest.mark.parametrize("name", ["iadd", "isub", "imul", "idiv", "fill"])
def test_inplace_ops_match_the_jax_oracle(name):
    a, b = _arrays([S, (4, 5)], positive=True)
    outs = []
    for cls in (JCpu, CpuTensor):
        t = cls.from_numpy(a.copy(), requires_grad=False)
        if name == "fill":
            t.fill(1.5)
        else:
            getattr(t, name)(cls.from_numpy(b, requires_grad=False))
            getattr(t, name)(2.0)
        outs.append(t.numpy())
    assert np.array_equal(*outs), name


@pytest.mark.parametrize("name", ["eq", "ge", "gt"])
def test_comparisons_match_the_jax_oracle(name):
    a = np.array([[1.0, 2.0, 3.0], [3.0, 2.0, 1.0]], np.float32)
    b = np.array([2.0, 2.0, 2.0], np.float32)
    outs = [getattr(cls.from_numpy(a), name)(cls.from_numpy(b)).numpy()
            for cls in (JCpu, CpuTensor)]
    assert np.array_equal(*outs) and outs[1].dtype == np.float32


@pytest.mark.parametrize("name", ["dropout", "randn_like", "randint_like"])
def test_random_ops_draw_numpys_stream_as_jax(name):
    calls = {"dropout": lambda t: t.dropout(p=0.3),
             "randn_like": lambda t: t.randn_like(scale=2.0),
             "randint_like": lambda t: t.randint_like(0, 7)}
    outs = []
    for cls in (JCpu, CpuTensor):
        np.random.seed(5)
        outs.append(calls[name](cls.from_numpy(np.ones(S, np.float32)))
                    .numpy())
    assert np.array_equal(*outs) and outs[0].dtype == outs[1].dtype


def test_initializers_and_conversion():
    np.random.seed(1)
    ju = JCpu.uniform(-1, 1, (3, 4)).numpy()
    np.random.seed(1)
    tu = CpuTensor.uniform(-1, 1, (3, 4)).numpy()
    assert np.array_equal(ju, tu)
    assert CpuTensor.from_numpy(np.arange(3)).dtype.kind == "i"
    x = np.random.default_rng(0).standard_normal(S).astype(np.float32)
    c = CudaTensor.from_numpy(x)
    o = c.cpu()
    assert type(o) is CpuTensor and np.array_equal(o.numpy(), x)
    assert o.cpu() is o
    back = o.cuda()
    assert type(back) is CudaTensor and np.array_equal(back.numpy(), x)
    assert back.data.device.type == "cpu"
    ids = CudaTensor.from_numpy(np.array([1, 2], np.int32)).cpu()
    assert ids.dtype == np.int32


# --- the tests/common.py checkers on the port's tape -----------------------
def _variants(shapes, broadcast):
    """The checkers' input sweep: the base inputs, then each input with one
    dimension collapsed to 1."""
    base = [np.random.uniform(-1, 1, size=s).astype(np.float32)
            for s in shapes]
    yield base
    if broadcast:
        for i, shape in enumerate(shapes):
            for d in range(len(shape)):
                c = shape[:d] + (1,) + shape[d + 1:]
                yield base[:i] + [np.random.uniform(-1, 1, size=c).astype(
                    np.float32)] + base[i + 1:]


CHECKS = {
    # name: (numpy function or None, tape function, shapes, broadcast)
    "add": (np.add, lambda a, b: a + b, [(4, 5), (4, 5)], True),
    "mul": (np.multiply, lambda a, b: a * b, [(4, 5), (4, 5)], True),
    "sub": (np.subtract, lambda a, b: a - b, [(4, 5), (4, 5)], True),
    "exp": (np.exp, lambda a: a.exp(), [(4, 5)], False),
    "tanh": (np.tanh, lambda a: a.tanh(), [(4, 5)], False),
    "dot": (np.matmul, lambda a, b: a @ b, [(4, 5), (5, 3)], False),
    "sum": (lambda a: a.sum(1), lambda a: a.sum(axis=1), [(4, 5)], False),
    "max": (lambda a: a.max(0), lambda a: a.max(axis=0), [(4, 5)], False),
    "softmax": (None, lambda a: a.softmax(axis=-1), [(3, 5)], False),
    "conv": (None, lambda x, w: x.conv(w, strides=2),
             [(1, 2, 5, 5), (2, 2, 3, 3)], False),
    "mean_pool": (None, lambda a: a.mean_pool(kernel=(2, 2)),
                  [(1, 1, 4, 4)], False),
    "getitem": (lambda a: a[1:3, np.array([0, 2, 2])],
                lambda a: a[1:3, np.array([0, 2, 2])], [(4, 3)], False),
    "concat": (lambda a, b: np.concatenate([a, b], 0),
               lambda a, b: a.concat(b, axis=0), [(2, 3), (1, 3)], False),
}


@pytest.mark.parametrize("name", list(CHECKS))
def test_common_checkers_on_the_port(name):
    """numpy parity (1e-5), the CudaTensor on the CPU against the oracle
    (1e-3, forward and every input's gradient), and assert_gradcheck at
    5e-4 on the oracle."""
    np_fn, fn, shapes, broadcast = CHECKS[name]
    np.random.seed(1234)
    for arrays in _variants(shapes, broadcast):
        want = fn(*[CpuTensor.from_numpy(a) for a in arrays]).numpy()
        if np_fn is not None:
            np.testing.assert_allclose(want, np_fn(*arrays), rtol=1e-5,
                                       atol=1e-5)
        oy, ogs = _run(CpuTensor, fn, arrays)
        cy, cgs = _run(CudaTensor, fn, arrays)
        for o, c in zip([oy] + ogs, [cy] + cgs):
            np.testing.assert_allclose(c, o, rtol=1e-3, atol=1e-3)
        for i in range(len(arrays)):
            ts = [CpuTensor.from_numpy(a) for a in arrays]
            assert_gradcheck(
                lambda x: fn(*ts[:i], x, *ts[i + 1:]), ts[i])


@pytest.mark.parametrize("cls", [CpuTensor, CudaTensor])
def test_gradcheck_takes_either_tensor(cls):
    x = cls.from_numpy(np.random.default_rng(3).uniform(
        0.5, 1.5, (3, 4)).astype(np.float32))
    f = lambda t: (t * t).log().sum(axis=1)
    assert gradcheck(f, x)
    assert_gradcheck(f, x)


def test_gradcheck_matches_the_jax_module():
    a = np.random.default_rng(4).uniform(-1, 1, (2, 3)).astype(np.float32)
    f = lambda t: (t.sin() * t).sum(axis=0)
    jj = jgradcheck.jacobian(f, JCpu.from_numpy(a))
    tj = jacobian(f, CpuTensor.from_numpy(a))
    assert np.array_equal(jj, tj)
    jn = jgradcheck.numerical_jacobian(f, JCpu.from_numpy(a), eps=1e-3)
    tn = numerical_jacobian(f, CpuTensor.from_numpy(a), eps=1e-3)
    assert np.array_equal(jn, tn)


def test_gradcheck_catches_a_wrong_gradient():
    from lightgrad_tpu_torch.autograd import Function

    class wrong_square(Function):
        def forward(ctx, a):
            ctx.save_for_backward(a.data)
            return CpuTensor(a.data * a.data, requires_grad=False)

        def backward(ctx, g):
            (x,) = ctx.get_saved_tensors()
            return CpuTensor(3.0 * x * g.data, requires_grad=False)

    x = CpuTensor.from_numpy(np.array([0.5, -1.0, 2.0], np.float32))
    assert not gradcheck(wrong_square, x)
    with pytest.raises(AssertionError):
        assert_gradcheck(wrong_square, x)


def test_linear_model_on_the_oracle():
    """A tape model moved to the oracle with ``map_parameters(lambda p:
    p.cpu())``: its gradcheck, and its forward against the CudaTensor
    model's."""
    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Linear(4, 6)
            self.l2 = nn.Linear(6, 3)

        def forward(self, x):
            return self.l2(self.l1(x).tanh())

    model = Model()
    x = np.random.default_rng(2).uniform(-1, 1, (5, 4)).astype(np.float32)
    want = model(CudaTensor.from_numpy(x)).numpy()
    model.map_parameters(lambda p: p.cpu())
    assert all(type(p) is CpuTensor for p in model.parameters())
    got = model(CpuTensor.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert_gradcheck(model, CpuTensor.from_numpy(x))
