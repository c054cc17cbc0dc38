"""Numpy op set of ``CpuTensor``, the tape's oracle.

Counterpart of ``lightgrad_tpu/autograd/cpu/ops.py``, op for op and numpy
call for numpy call, so the two oracles agree bit for bit: the view ops,
unary and binary ops, the in-place ops, ``fill``, ``dot``, ``einsum``,
``sum``, ``concat``, ``nan_to_num``, ``cumsum``, ``max`` / ``min``, the
comparisons, the N-D ``conv`` (strides, dilation, groups, both
gradients), ``astype``, ``dropout``, ``randn_like`` and ``randint_like``.
The tape's derived ops (``autograd/ops.py``: softmax, gelu, mean, pad,
pooling, ``conv_transpose``) are device-agnostic and run on it unchanged.
Random draws use numpy's global generator.
"""

import numpy as np

from ..tensor import AbstractTensor
from ..function import Function
from ..einsum_spec import parse_spec as parse_einsum_spec, bwd_plan as einsum_bwd_plan
from .tensor import CpuTensor


def _raw(x):
    return x.data if isinstance(x, AbstractTensor) else x


def _t(arr, like_dtype=None):
    arr = np.asarray(arr)
    return CpuTensor(arr, requires_grad=False, dtype=arr.dtype)


def _unwrap_index(idx):
    """Allow tensors inside (fancy) indices, e.g. ``y[range(n), labels]``."""
    if isinstance(idx, AbstractTensor):
        return idx.data
    if isinstance(idx, tuple):
        return tuple(_unwrap_index(i) for i in idx)
    return idx


# ---------------------------------------------------------------------------
# movement
# ---------------------------------------------------------------------------
@CpuTensor.register_op()
@CpuTensor.register_op("T")
class transpose(Function):
    def forward(ctx, a, *axes):
        axes = axes if len(axes) > 0 else tuple(reversed(range(a.ndim)))
        ctx.save_for_backward(axes)
        return _t(np.transpose(a.data, axes))

    def backward(ctx, g):
        (axes,) = ctx.get_saved_tensors()
        return _t(np.transpose(g.data, np.argsort(axes)))


@CpuTensor.register_op()
class reshape(Function):
    def forward(ctx, a, *shape):
        ctx.save_for_backward(a.shape)
        return _t(a.data.reshape(shape))

    def backward(ctx, g):
        (shape,) = ctx.get_saved_tensors()
        return _t(g.data.reshape(shape))


@CpuTensor.register_op()
class contiguous(Function):
    def forward(ctx, a):
        return _t(np.ascontiguousarray(a.data))

    def backward(ctx, g):
        return g


@CpuTensor.register_op("__getitem__")
class getitem(Function):
    def forward(ctx, a, idx):
        idx = _unwrap_index(idx)
        ctx.save_for_backward(a.shape, a.dtype, idx)
        return _t(a.data[idx])

    def backward(ctx, g):
        shape, dtype, idx = ctx.get_saved_tensors()
        out = np.zeros(shape, dtype=dtype)
        np.add.at(out, idx, g.data)
        return _t(out)


@CpuTensor.register_op("__setitem__")
class setitem(Function):
    def forward(ctx, a, idx, val):
        a.data[_unwrap_index(idx)] = _raw(val)
        return a


@CpuTensor.register_op()
class narrow(Function):
    """Static- or tensor-start slice along ``axis`` (the CUDA op of the
    same name also clamps the start)."""

    def forward(ctx, a, start, length: int, axis: int = 0):
        s = int(start.data) if isinstance(start, AbstractTensor) else int(start)
        ctx.save_for_backward(a.shape, a.dtype, s, length, axis)
        idx = tuple(slice(None) for _ in range(axis)) + (slice(s, s + length),)
        return _t(a.data[idx])

    def backward(ctx, g):
        shape, dtype, s, length, axis = ctx.get_saved_tensors()
        out = np.zeros(shape, dtype=dtype)
        idx = tuple(slice(None) for _ in range(axis)) + (slice(s, s + length),)
        out[idx] = g.data
        return (_t(out),)


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------
@CpuTensor.register_op()
class neg(Function):
    def forward(ctx, a):
        return _t(-a.data)

    def backward(ctx, g):
        return _t(-g.data)


@CpuTensor.register_op()
class sin(Function):
    def forward(ctx, a):
        ctx.save_for_backward(a.data)
        return _t(np.sin(a.data))

    def backward(ctx, g):
        (x,) = ctx.get_saved_tensors()
        return _t(np.cos(x) * g.data)


@CpuTensor.register_op()
class cos(Function):
    def forward(ctx, a):
        ctx.save_for_backward(a.data)
        return _t(np.cos(a.data))

    def backward(ctx, g):
        (x,) = ctx.get_saved_tensors()
        return _t(-np.sin(x) * g.data)


@CpuTensor.register_op()
class exp(Function):
    def forward(ctx, a):
        y = np.exp(a.data)
        ctx.save_for_backward(y)
        return _t(y)

    def backward(ctx, g):
        (y,) = ctx.get_saved_tensors()
        return _t(y * g.data)


@CpuTensor.register_op()
class gelu_exact(Function):
    """Exact erf GELU (torch's default), through scipy.special.erf; the
    tanh ``gelu`` composite stays the default activation."""

    def forward(ctx, a):
        from scipy.special import erf

        ctx.save_for_backward(a.data)
        return _t(0.5 * a.data * (1.0 + erf(a.data * 0.7071067811865476)))

    def backward(ctx, g):
        from scipy.special import erf

        (x,) = ctx.get_saved_tensors()
        cdf = 0.5 * (1.0 + erf(x * 0.7071067811865476))
        pdf = 0.3989422804014327 * np.exp(-0.5 * x * x)
        return _t(g.data * (cdf + x * pdf))


@CpuTensor.register_op()
class log(Function):
    def forward(ctx, a):
        ctx.save_for_backward(a.data)
        return _t(np.log(a.data))

    def backward(ctx, g):
        (x,) = ctx.get_saved_tensors()
        return _t(g.data / x)


@CpuTensor.register_op(overwrite=True)
class sigmoid(Function):
    def forward(ctx, a):
        y = 1.0 / (1.0 + np.exp(-a.data))
        ctx.save_for_backward(y)
        return _t(y)

    def backward(ctx, g):
        (y,) = ctx.get_saved_tensors()
        return _t(y * (1.0 - y) * g.data)


@CpuTensor.register_op(overwrite=True)
class tanh(Function):
    def forward(ctx, a):
        y = np.tanh(a.data)
        ctx.save_for_backward(y)
        return _t(y)

    def backward(ctx, g):
        (y,) = ctx.get_saved_tensors()
        return _t((1.0 - y * y) * g.data)


@CpuTensor.register_op()
class relu(Function):
    def forward(ctx, a):
        ctx.save_for_backward(a.data)
        return _t(np.maximum(a.data, 0))

    def backward(ctx, g):
        (x,) = ctx.get_saved_tensors()
        return _t((x > 0) * g.data)


# ---------------------------------------------------------------------------
# elementwise binary (scalar operands allowed; grads trimmed in the core)
# ---------------------------------------------------------------------------
@CpuTensor.register_op()
class add(Function):
    def forward(ctx, a, b):
        ctx.save_for_backward(isinstance(b, AbstractTensor))
        return _t(a.data + _raw(b))

    def backward(ctx, g):
        (both,) = ctx.get_saved_tensors()
        return (g, g) if both else (g,)


@CpuTensor.register_op(overwrite=True)
class sub(Function):
    def forward(ctx, a, b):
        ctx.save_for_backward(isinstance(b, AbstractTensor))
        return _t(a.data - _raw(b))

    def backward(ctx, g):
        (both,) = ctx.get_saved_tensors()
        return (g, _t(-g.data)) if both else (g,)


@CpuTensor.register_op()
class mul(Function):
    def forward(ctx, a, b):
        ctx.save_for_backward(a.data, _raw(b), isinstance(b, AbstractTensor))
        return _t(a.data * _raw(b))

    def backward(ctx, g):
        x, y, both = ctx.get_saved_tensors()
        return (_t(y * g.data), _t(x * g.data)) if both else (_t(y * g.data),)


@CpuTensor.register_op(overwrite=True)
class div(Function):
    def forward(ctx, a, b):
        ctx.save_for_backward(a.data, _raw(b), isinstance(b, AbstractTensor))
        return _t(a.data / _raw(b))

    def backward(ctx, g):
        x, y, both = ctx.get_saved_tensors()
        ga = _t(g.data / y)
        if both:
            return ga, _t(-x / (y * y) * g.data)
        return (ga,)


@CpuTensor.register_op()
class pow(Function):
    def forward(ctx, a, b):
        y = a.data ** _raw(b)
        ctx.save_for_backward(a.data, _raw(b), y, isinstance(b, AbstractTensor))
        return _t(y)

    def backward(ctx, g):
        x, e, y, both = ctx.get_saved_tensors()
        ga = _t(e * x ** (np.asarray(e) - 1) * g.data)
        if both:
            return ga, _t(y * np.log(x) * g.data)
        return (ga,)


# ---------------------------------------------------------------------------
# in-place (no backward; used under no_grad, e.g. optimizer updates)
# ---------------------------------------------------------------------------
@CpuTensor.register_op()
class iadd(Function):
    def forward(ctx, a, b):
        a.data.__iadd__(_raw(b))
        return a


@CpuTensor.register_op()
class isub(Function):
    def forward(ctx, a, b):
        a.data.__isub__(_raw(b))
        return a


@CpuTensor.register_op()
class imul(Function):
    def forward(ctx, a, b):
        a.data.__imul__(_raw(b))
        return a


@CpuTensor.register_op()
class idiv(Function):
    def forward(ctx, a, b):
        a.data.__itruediv__(_raw(b))
        return a


@CpuTensor.register_op()
class fill(Function):
    def forward(ctx, a, val):
        a.data.fill(val)
        return a


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------
@CpuTensor.register_op()
class dot(Function):
    def forward(ctx, a, b):
        ctx.save_for_backward(a.data, b.data)
        return _t(np.matmul(a.data, b.data))

    def backward(ctx, g):
        x, y, go = ctx.get_saved_tensors()[0], ctx.get_saved_tensors()[1], g.data
        ga = np.matmul(go, np.swapaxes(y, -1, -2))
        gb = np.matmul(np.swapaxes(x, -1, -2), go)
        return _t(ga), _t(gb)


@CpuTensor.register_op()
class einsum(Function):
    """General tensor contraction (the numpy twin of the CUDA op)."""

    def forward(ctx, a, spec: str, *rest):
        datas = (a.data,) + tuple(o.data for o in rest)
        terms, out = parse_einsum_spec(spec, len(datas))
        ctx.save_for_backward(spec, terms, out, datas)
        return _t(np.einsum(spec, *datas))

    def backward(ctx, g):
        spec, terms, out, datas = ctx.get_saved_tensors()
        grads = []
        for i, parent in enumerate(ctx.parents):
            if not parent.requires_grad:
                grads.append(None)
                continue
            sub, kept, term = einsum_bwd_plan(terms, out, i)
            others = [d for j, d in enumerate(datas) if j != i]
            gi = np.einsum(sub, g.data, *others)
            for pos, c in enumerate(term):  # re-insert forward-summed axes
                if c not in kept:
                    gi = np.expand_dims(gi, pos)
            gi = np.broadcast_to(gi, datas[i].shape)
            grads.append(_t(gi.astype(datas[i].dtype)))
        return tuple(grads)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _restore_dims(arr, axis, keepdims):
    """Re-insert reduced axes of size 1 so the value broadcasts against input."""
    if keepdims or axis is None:
        return arr
    axes = axis if isinstance(axis, tuple) else (axis,)
    return np.expand_dims(arr, axes)


@CpuTensor.register_op()
class sum(Function):
    def forward(ctx, a, axis=None, keepdims: bool = False):
        ctx.save_for_backward(a.shape, axis, keepdims)
        return _t(np.sum(a.data, axis=axis, keepdims=keepdims))

    def backward(ctx, g):
        shape, axis, keepdims = ctx.get_saved_tensors()
        go = _restore_dims(g.data, axis, keepdims)
        return _t(np.broadcast_to(go, shape).copy())


@CpuTensor.register_op()
class concat(Function):
    """Concatenate tensors along ``axis`` (backward slices the gradient)."""

    def forward(ctx, *ts, axis: int = -1):
        sizes = [t.shape[axis] for t in ts]
        ctx.save_for_backward(axis, sizes)
        return _t(np.concatenate([t.data for t in ts], axis=axis))

    def backward(ctx, g):
        axis, sizes = ctx.get_saved_tensors()
        outs, off = [], 0
        idx = [slice(None)] * g.ndim
        for s in sizes:
            idx[axis] = slice(off, off + s)
            outs.append(_t(g.data[tuple(idx)].copy()))
            off += s
        return tuple(outs)


@CpuTensor.register_op()
class nan_to_num(Function):
    """Replace nan/±inf (AMP grad sanitization; gradient passes through)."""

    def forward(ctx, a, nan: float = 0.0, posinf: float = 0.0, neginf: float = 0.0):
        return _t(np.nan_to_num(a.data, nan=nan, posinf=posinf, neginf=neginf))

    def backward(ctx, g):
        return _t(g.data)


@CpuTensor.register_op()
class cumsum(Function):
    """Inclusive cumulative sum along ``axis`` (reverse-cumsum backward)."""

    def forward(ctx, a, axis: int = -1):
        ctx.save_for_backward(axis)
        return _t(np.cumsum(a.data, axis=axis))

    def backward(ctx, g):
        (axis,) = ctx.get_saved_tensors()
        return _t(np.flip(np.cumsum(np.flip(g.data, axis), axis=axis), axis))


@CpuTensor.register_op("max")
class max_(Function):
    def forward(ctx, a, axis=None, keepdims: bool = False):
        y = np.max(a.data, axis=axis, keepdims=keepdims)
        ctx.save_for_backward(a.data, y, axis, keepdims)
        return _t(y)

    def backward(ctx, g):
        x, y, axis, keepdims = ctx.get_saved_tensors()
        mask = x == _restore_dims(np.asarray(y), axis, keepdims)
        return _t(mask * _restore_dims(g.data, axis, keepdims))


@CpuTensor.register_op("min")
class min_(Function):
    def forward(ctx, a, axis=None, keepdims: bool = False):
        y = np.min(a.data, axis=axis, keepdims=keepdims)
        ctx.save_for_backward(a.data, y, axis, keepdims)
        return _t(y)

    def backward(ctx, g):
        x, y, axis, keepdims = ctx.get_saved_tensors()
        mask = x == _restore_dims(np.asarray(y), axis, keepdims)
        return _t(mask * _restore_dims(g.data, axis, keepdims))


# ---------------------------------------------------------------------------
# convolution (N-D, NC<spatial> layout)
# ---------------------------------------------------------------------------
_SPATIAL = "xyz"
_KERNEL = "uvw"


@CpuTensor.register_op()
class conv(Function):
    """N-D convolution: x ``(B, Cin, *S)``, w ``(Cout, Cin/g, *K)``;
    int/tuple strides and dilation, grouped channels via ``groups``."""

    def forward(ctx, x, w, strides=1, dilation=1, groups=1):
        xd, wd = x.data, w.data
        n = wd.ndim - 2
        s = (strides,) * n if isinstance(strides, int) else tuple(strides)
        dl = (dilation,) * n if isinstance(dilation, int) else tuple(dilation)
        ksize = wd.shape[2:]
        # windows over the dilated footprint, then pick every dl-th tap and
        # every s-th output position: (B, Cin, *S_out, *K)
        k_eff = tuple((k - 1) * d + 1 for k, d in zip(ksize, dl))
        win = np.lib.stride_tricks.sliding_window_view(xd, k_eff, axis=tuple(range(2, 2 + n)))
        win = win[(slice(None), slice(None))
                  + tuple(slice(None, None, st) for st in s)
                  + tuple(slice(None, None, d) for d in dl)]
        sp, k = _SPATIAL[:n], _KERNEL[:n]
        if groups == 1:
            out = np.einsum(f"bc{sp}{k},oc{k}->bo{sp}", win, wd)
        else:
            cg, og = xd.shape[1] // groups, wd.shape[0] // groups
            out = np.concatenate([
                np.einsum(f"bc{sp}{k},oc{k}->bo{sp}",
                          win[:, gi * cg:(gi + 1) * cg],
                          wd[gi * og:(gi + 1) * og])
                for gi in range(groups)
            ], axis=1)
        ctx.save_for_backward(xd.shape, wd, win, s, dl, groups)
        return _t(np.ascontiguousarray(out))

    def backward(ctx, g):
        x_shape, wd, win, s, dl, groups = ctx.get_saved_tensors()
        go = g.data
        n = wd.ndim - 2
        sp, k = _SPATIAL[:n], _KERNEL[:n]
        cg, og = x_shape[1] // groups, wd.shape[0] // groups
        # weight gradient: correlate output grad with the input windows
        if groups == 1:
            gw = np.einsum(f"bo{sp},bc{sp}{k}->oc{k}", go, win)
        else:
            gw = np.concatenate([
                np.einsum(f"bo{sp},bc{sp}{k}->oc{k}",
                          go[:, gi * og:(gi + 1) * og],
                          win[:, gi * cg:(gi + 1) * cg])
                for gi in range(groups)
            ], axis=0)
        # input gradient: scatter-add each kernel tap's contribution back
        gx = np.zeros(x_shape, dtype=go.dtype)
        out_sp = go.shape[2:]
        for kidx in np.ndindex(*wd.shape[2:]):
            wtap = wd[(slice(None), slice(None)) + kidx]  # (Cout, Cin/g)
            if groups == 1:
                contrib = np.einsum(f"bo{sp},oc->bc{sp}", go, wtap)
            else:
                contrib = np.concatenate([
                    np.einsum(f"bo{sp},oc->bc{sp}",
                              go[:, gi * og:(gi + 1) * og],
                              wtap[gi * og:(gi + 1) * og])
                    for gi in range(groups)
                ], axis=1)
            dst = tuple(
                slice(ki * d, ki * d + st * od, st)
                for ki, st, d, od in zip(kidx, s, dl, out_sp)
            )
            gx[(slice(None), slice(None)) + dst] += contrib
        return _t(gx), _t(gw)


@CpuTensor.register_op()
class astype(Function):
    """Dtype cast (differentiable: gradient casts back)."""

    def forward(ctx, a, dtype):
        ctx.save_for_backward(a.dtype)
        return _t(a.data.astype(dtype))

    def backward(ctx, g):
        (dtype,) = ctx.get_saved_tensors()
        return _t(g.data.astype(dtype))


@CpuTensor.register_op()
class dropout(Function):
    """Inverted dropout (host RNG)."""

    def forward(ctx, a, p: float = 0.5, training: bool = True):
        if not training or p <= 0.0:
            ctx.save_for_backward(None)
            return _t(a.data.copy())
        mask = (np.random.rand(*a.shape) >= p).astype(a.dtype) / (1.0 - p)
        ctx.save_for_backward(mask)
        return _t(a.data * mask)

    def backward(ctx, g):
        (mask,) = ctx.get_saved_tensors()
        if mask is None:
            return g
        return _t(g.data * mask)


def _register_compare(name, np_fn):
    class Op(Function):
        """Elementwise comparison -> float mask (no gradient)."""

        def forward(ctx, a, b):
            return _t(np_fn(a.data, _raw(b)).astype(a.dtype))

        def backward(ctx, g):
            return None  # no gradient through comparisons (any arity)

    Op.__name__ = name
    CpuTensor.register_op(name, Op, overwrite=True)


_register_compare("eq", np.equal)
_register_compare("ge", np.greater_equal)
_register_compare("gt", np.greater)


@CpuTensor.register_op()
class randn_like(Function):
    """Standard-normal draws with ``a``'s shape and dtype (numpy's global
    generator).  No gradient."""

    def forward(ctx, a, scale: float = 1.0):
        z = np.random.standard_normal(a.shape).astype(a.dtype)
        return _t(z * scale if scale != 1.0 else z)

    def backward(ctx, g):
        return None


@CpuTensor.register_op()
class randint_like(Function):
    """Uniform int32 draws in [lo, hi) with ``a``'s shape.  No gradient."""

    def forward(ctx, a, lo: int, hi: int):
        return _t(np.random.randint(lo, hi, a.shape).astype(np.int32))

    def backward(ctx, g):
        return None
