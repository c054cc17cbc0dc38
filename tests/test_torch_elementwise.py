"""Port parity: the elementwise kernel family.  Every body of the port's
``ew`` (CPU plain version) against the JAX package's ``ew`` over the same
body, in pallas (interpret) and xla modes, on broadcast shapes; ``n_out=2``;
the int32 / bfloat16 dtype promotion; and the CUDA kernel's operand
addressing (``_plan``) replayed in numpy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgrad_tpu.autograd.tpu.ops as jax_ops
from lightgrad_tpu.ops.elementwise import ew as jax_ew
from lightgrad_tpu_torch.ops.elementwise import BODIES, _plan, ew
from tests.torch_port import jax_kernel_mode, to_np

# f32 on both sides; the same formulas, transcendentals from two libraries
TOL = dict(rtol=1e-5, atol=1e-6)
# bodies whose operands must be positive (log, pow); b is a divisor in div
_POSITIVE = {"f_log", "b_log", "f_pow", "b2_pow", "b1_pow"}
# one broadcast pattern per arity: the first operand is the output's shape
# (a gradient), the rest broadcast against it
_SHAPES = {1: [(4, 3, 6)], 2: [(4, 3, 6), (3, 1)],
           3: [(4, 3, 6), (3, 1), (1, 6)], 4: [(4, 3, 6), (3, 1), (1, 6),
                                               (4, 3, 6)]}


def _arity(body):
    return _jax_body(body).__code__.co_argcount


def _jax_body(body):
    return getattr(jax_ops, "_" + body)


def _n_out(body):
    return 2 if body.startswith("b2_") else 1


def _inputs(body, seed=0):
    rng = np.random.default_rng(seed)
    xs = []
    for shape in _SHAPES[_arity(body)]:
        x = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if body not in _POSITIVE:
            x *= rng.choice([-1.0, 1.0], shape).astype(np.float32)
        xs.append(x)
    if body == "b_minmax":
        xs[2][0, :3] = xs[1][:, 0]      # some x == y pairs
    return xs


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("body", BODIES)
def test_body_matches_jax(body, mode):
    xs = _inputs(body)
    n_out = _n_out(body)
    with jax_kernel_mode(mode):
        want = jax_ew(_jax_body(body), *map(jnp.asarray, xs), n_out=n_out)
    got = ew(body, *map(torch.from_numpy, xs), n_out=n_out)
    want = want if n_out > 1 else (want,)
    got = got if n_out > 1 else (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype)[6:] == str(w.dtype)
        np.testing.assert_allclose(to_np(g), np.asarray(w, np.float32), **TOL)


def test_minmax_gradient_hits_the_maxima():
    """b_minmax routes the gradient to the elements equal to the max."""
    x = np.array([[1.0, 3.0, 3.0], [2.0, 0.0, -1.0]], np.float32)
    y = x.max(axis=1, keepdims=True)
    g = np.ones((2, 1), np.float32)
    got = ew("b_minmax", *map(torch.from_numpy, (g, x, y)))
    np.testing.assert_array_equal(to_np(got), [[0, 1, 1], [1, 0, 0]])


@pytest.mark.parametrize("a_dt,b_dt,scalar,want", [
    ("int32", "float32", True, "float32"),    # int32 tensor with a float
    ("bfloat16", "float32", False, "float32"),
    ("int32", "int32", False, "int32"),
    ("bfloat16", "bfloat16", False, "bfloat16"),
])
@pytest.mark.parametrize("body", ["f_mul", "f_add"])
def test_dtype_promotion_matches_jax(body, a_dt, b_dt, scalar, want):
    rng = np.random.default_rng(3)
    a = rng.integers(-5, 6, (4, 5)).astype(np.float32)
    b = np.float32(0.5) if scalar else \
        rng.integers(-5, 6, (1, 5)).astype(np.float32)
    ja = jnp.asarray(a, dtype=a_dt)
    jb = jnp.asarray(b, dtype=b_dt)
    ta = torch.from_numpy(a).to(getattr(torch, a_dt))
    tb = torch.as_tensor(b).to(getattr(torch, b_dt))
    with jax_kernel_mode("pallas"):
        jy = jax_ew(_jax_body(body), ja, jb)
    ty = ew(body, ta, tb)
    assert str(jy.dtype) == want and ty.dtype == getattr(torch, want)
    # bfloat16: JAX rounds each op, the port widens to f32 and rounds once
    tol = 1e-2 if want == "bfloat16" else 1e-6
    np.testing.assert_allclose(to_np(ty), np.asarray(jy, np.float32),
                               rtol=tol, atol=tol)


def test_int_division_promotes_to_float():
    a = torch.tensor([[7, -3]], dtype=torch.int32)
    b = torch.tensor([2], dtype=torch.int32)
    y = ew("f_div", a, b)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(to_np(y), [[3.5, -1.5]])


def test_two_outputs_are_both_gradients():
    rng = np.random.default_rng(5)
    g, a, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 3, 4), (2, 3, 4), (3, 1)))
    ga, gb = ew("b2_mul", *map(torch.from_numpy, (g, a, b)), n_out=2)
    assert ga.shape == gb.shape == (2, 3, 4)
    np.testing.assert_allclose(to_np(ga), g * b, **TOL)
    np.testing.assert_allclose(to_np(gb), g * a, **TOL)


def _replay(dims, mode, strides, x, n):
    """What the kernel loads for operand ``x`` at flat output index 0..n-1
    (the index arithmetic of ``ew_kernel``, in numpy)."""
    offs = np.arange(n)
    flat = x.reshape(-1)
    if mode == 0:
        return flat[offs]
    if mode == 1:
        return np.full(n, flat[0])
    _, d1, d2, d3 = dims
    i3, r = offs % d3, offs // d3
    i2, r = r % d2, r // d2
    i1, i0 = r % d1, r // d1
    return flat[i0 * strides[0] + i1 * strides[1] + i2 * strides[2]
                + i3 * strides[3]]


@pytest.mark.parametrize("shapes", [
    [(8, 12, 16, 16), (8, 1, 1, 16)],          # scores + additive mask
    [(32, 48), (48,)],                         # bias add
    [(5, 1, 7), (1, 6, 1), ()],                # crossed broadcast + scalar
    [(2, 3, 4, 5), (2, 3, 4, 5)],              # same shape: no index math
    [(4, 1), (4, 6), (1, 6)],                  # both sides broadcast
])
def test_kernel_addressing_reads_the_broadcast(shapes):
    """The (dims, modes, strides) the CUDA kernel is launched with address
    every operand as numpy broadcasting does, without materialising it."""
    out = np.broadcast_shapes(*shapes)
    n = int(np.prod(out))
    dims, modes, strides = _plan(shapes, out)
    assert len(dims) == 4 and int(np.prod(dims)) == n
    rng = np.random.default_rng(0)
    for shape, mode, st in zip(shapes, modes, strides):
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.broadcast_to(x, out).reshape(-1)
        np.testing.assert_array_equal(_replay(dims, mode, st, x, n), want)
    if shapes[0] == shapes[-1] and len(set(shapes)) == 1:
        assert modes == [0, 0]


def test_kernel_addressing_merges_dims():
    """Dims with one broadcast signature merge: the masked scores are 3-D
    to the kernel; a pattern needing more than 4 dims raises."""
    dims, modes, _ = _plan([(8, 12, 16, 16), (8, 1, 1, 16)], (8, 12, 16, 16))
    assert dims == (1, 8, 192, 16) and modes == [0, 2]
    with pytest.raises(ValueError):
        _plan([(2, 1, 2, 1, 2), (1, 2, 1, 2, 1)], (2, 2, 2, 2, 2))
