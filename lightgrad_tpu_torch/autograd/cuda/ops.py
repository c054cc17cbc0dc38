"""CUDA op set: Function wrappers over the port's kernel layer.

Counterpart of ``lightgrad_tpu/autograd/tpu/ops.py``, op for op.  Every
elementwise op and fused two-gradient backward goes through ``ew`` (the
elementwise kernel), every product through ``matmul`` (the matmul kernel),
every sum, max and min through ``reduce`` (the reduce kernel), softmax,
LayerNorm and attention through their fused kernels, convolution through
the implicit-GEMM conv kernels.  On CPU tensors each
wrapper runs its plain version.  What the JAX package leaves to XLA --
gathers, scatters, reshapes, padding, concatenation, einsum, cumsum, random
draws -- is plain PyTorch here.

Value semantics: a movement op may return a view that shares its input's
storage, so no op ever writes into storage it did not allocate.  In-place
ops compute a fresh buffer and rebind (``_set_data``), ``setitem`` writes a
clone.  ``ring_attention`` is not ported yet and raises.
"""

import numpy as np
import torch

from ..einsum_spec import bwd_plan as einsum_bwd_plan
from ..einsum_spec import parse_spec as parse_einsum_spec
from ..function import Function
from ..tensor import AbstractTensor
from .tensor import CudaTensor, torch_dtype
from ...ops.attention import attention_bwd as kattn_bwd
from ...ops.attention import attention_fwd_res as kattn_fwd_res
from ...ops.conv import conv_bwd as kconv_bwd
from ...ops.conv import conv_fwd as kconv_fwd
from ...ops.elementwise import ew, scalar
from ...ops.layernorm import layernorm_bwd as kln_bwd
from ...ops.layernorm import layernorm_fwd_stats as kln_fwd
from ...ops.matmul import matmul as kmatmul
from ...ops.matmul import matmul_vjp
from ...ops.reduce import reduce as kreduce
from ...ops.softmax import softmax_bwd as ksoftmax_bwd
from ...ops.softmax import softmax_fwd as ksoftmax_fwd


def _t(x):
    return CudaTensor(x, requires_grad=False)


def _raw(x):
    return x.data if isinstance(x, AbstractTensor) else x


def _scalar(b, like):
    """A Python scalar as ``ew`` takes it by value: rounded on the host to
    ``like``'s dtype when that is floating, else to float32 for a float and
    ``like``'s dtype for an int (jnp's 32-bit promotion).  No device tensor
    is made, so nothing is copied to the card and nothing waits for it."""
    if isinstance(b, torch.Tensor):
        return b
    b = b.item() if isinstance(b, np.generic) else b
    if like.is_floating_point():
        dt = like.dtype
    else:
        dt = torch.float32 if isinstance(b, float) else like.dtype
    return scalar(b, dt)


def _unwrap_index(idx, dev):
    if isinstance(idx, AbstractTensor):
        return idx.data
    if isinstance(idx, np.ndarray):
        return torch.as_tensor(idx, device=dev)
    if isinstance(idx, tuple):
        return tuple(_unwrap_index(i, dev) for i in idx)
    return idx


def _is_advanced(i):
    return isinstance(i, (torch.Tensor, list))


def _long_index(i, dev):
    i = torch.as_tensor(i, device=dev)
    return i if i.dtype == torch.bool else i.long()


# ---------------------------------------------------------------------------
# unary ops
# ---------------------------------------------------------------------------
def _unary(name, save):
    fwd, bwd = "f_" + name, "b_" + name

    class Op(Function):
        def forward(ctx, a):
            y = ew(fwd, a.data)
            if save == "x":
                ctx.save_for_backward(a.data)
            elif save == "y":
                ctx.save_for_backward(y)
            return _t(y)

        def backward(ctx, g):
            if save is None:
                return _t(ew(bwd, g.data))
            (res,) = ctx.get_saved_tensors()
            return _t(ew(bwd, g.data, res))

    Op.__name__ = name
    CudaTensor.register_op(name, Op, overwrite=True)
    return Op


_unary("neg", None)
_unary("sin", "x")
_unary("cos", "x")
_unary("exp", "y")
_unary("log", "x")
_unary("sigmoid", "y")
_unary("tanh", "y")
_unary("relu", "x")
_unary("gelu", "x")
_unary("gelu_exact", "x")


# ---------------------------------------------------------------------------
# binary ops (fused two-gradient backward when both operands are tensors)
# ---------------------------------------------------------------------------
def _binary(name, bwd1, save_y=False):
    fwd, bwd2 = "f_" + name, "b2_" + name

    class Op(Function):
        def forward(ctx, a, b):
            both = isinstance(b, AbstractTensor)
            braw = b.data if both else _scalar(b, a.data)
            y = ew(fwd, a.data, braw)
            ctx.save_for_backward(both, a.data, braw, y if save_y else None)
            return _t(y)

        def backward(ctx, g):
            both, araw, braw, y = ctx.get_saved_tensors()
            if both:
                args = (g.data, araw, braw) + ((y,) if save_y else ())
                ga, gb = ew(bwd2, *args, n_out=2)
                return _t(ga), _t(gb)
            if bwd1 == "b1_add":
                return (_t(ew(bwd1, g.data)),)
            if bwd1 == "b1_pow":
                return (_t(ew(bwd1, g.data, araw, braw)),)
            return (_t(ew(bwd1, g.data, braw)),)

    Op.__name__ = name
    CudaTensor.register_op(name, Op, overwrite=True)
    return Op


_binary("add", "b1_add")
_binary("sub", "b1_add")
_binary("mul", "b1_mul")
_binary("div", "b1_div")
_binary("pow", "b1_pow", save_y=True)


# ---------------------------------------------------------------------------
# in-place ops: a fresh buffer, rebound (used under no_grad)
# ---------------------------------------------------------------------------
def _inplace(name, fwd):
    class Op(Function):
        def forward(ctx, a, b):
            braw = b.data if isinstance(b, AbstractTensor) \
                else _scalar(b, a.data)
            res = ew(fwd, a.data, braw)
            if res.dtype != a.data.dtype:
                # never change the target's dtype (bf16 param += f32 grad)
                res = res.to(a.data.dtype)
            return a._set_data(res)

    Op.__name__ = name
    CudaTensor.register_op(name, Op, overwrite=True)
    return Op


_inplace("iadd", "f_add")
_inplace("isub", "f_sub")
_inplace("imul", "f_mul")
_inplace("idiv", "f_div")


@CudaTensor.register_op()
class fill(Function):
    def forward(ctx, a, val):
        return a._set_data(torch.full(a.shape, val, dtype=a.dtype,
                                      device=a.data.device))


# ---------------------------------------------------------------------------
# movement ops (plain torch; results may be views)
# ---------------------------------------------------------------------------
@CudaTensor.register_op()
@CudaTensor.register_op("T")
class transpose(Function):
    def forward(ctx, a, *axes):
        axes = axes if len(axes) > 0 else tuple(reversed(range(a.ndim)))
        ctx.save_for_backward(axes)
        return _t(a.data.permute(*axes))

    def backward(ctx, g):
        (axes,) = ctx.get_saved_tensors()
        return _t(g.data.permute(*np.argsort(axes).tolist()))


@CudaTensor.register_op()
class reshape(Function):
    def forward(ctx, a, *shape):
        ctx.save_for_backward(a.shape)
        return _t(a.data.reshape(shape))

    def backward(ctx, g):
        (shape,) = ctx.get_saved_tensors()
        return _t(g.data.reshape(shape))


@CudaTensor.register_op()
class contiguous(Function):
    def forward(ctx, a):
        return _t(a.data.contiguous())

    def backward(ctx, g):
        return g


def _positive_steps(idx, shape):
    """``(idx', dims)`` with ``x[idx] == x.flip(dims)[idx']`` and every step
    of ``idx'`` positive: torch slices take no negative step (the JAX
    package's flipped kernels of ``conv_transpose`` use one).  Only an
    index of slices and ints (and one Ellipsis) can carry one."""
    parts = idx if isinstance(idx, tuple) else (idx,)
    if not any(isinstance(i, slice) and i.step is not None and i.step < 0
               for i in parts):
        return idx, ()
    if not all(isinstance(i, (slice, int)) or i is Ellipsis for i in parts):
        raise NotImplementedError(f"negative slice steps beside {idx!r}")
    if Ellipsis in parts:
        at = parts.index(Ellipsis)
        fill = (slice(None),) * (len(shape) - len(parts) + 1)
        parts = parts[:at] + fill + parts[at + 1:]
    out, dims = [], []
    for d, i in enumerate(parts):
        if isinstance(i, slice) and i.step is not None and i.step < 0:
            r = range(*i.indices(shape[d]))
            n = shape[d] - 1
            i = slice(n - r[0], n - r[-1] + 1, -i.step) if len(r) \
                else slice(0, 0)
            dims.append(d)
        out.append(i)
    return tuple(out), tuple(dims)


@CudaTensor.register_op("__getitem__")
class getitem(Function):
    def forward(ctx, a, idx):
        idx = _unwrap_index(idx, a.data.device)
        idx, flips = _positive_steps(idx, a.shape)
        ctx.save_for_backward(a.shape, a.dtype, idx, flips)
        x = a.data.flip(flips) if flips else a.data
        return _t(x[idx])

    def backward(ctx, g):
        shape, dtype, idx, flips = ctx.get_saved_tensors()
        gd = g.data.to(dtype)
        out = torch.zeros(shape, dtype=dtype, device=gd.device)
        if flips:
            out[idx] = gd
            return _t(out.flip(flips))
        parts = idx if isinstance(idx, tuple) else (idx,)
        if all(_is_advanced(i) for i in parts):
            # repeated indices (embedding rows, loss picks) must accumulate
            parts = tuple(_long_index(i, gd.device) for i in parts)
            out.index_put_(parts, gd, accumulate=True)
        elif not any(_is_advanced(i) for i in parts):
            out[idx] = gd                 # basic indexing never repeats
        else:
            # mixed basic/advanced: the scatter-add of torch's own indexing
            # backward, which accumulates repeats too
            with torch.enable_grad():
                z = torch.zeros(shape, dtype=dtype, device=gd.device,
                                requires_grad=True)
                (out,) = torch.autograd.grad(z[idx], z, gd)
        return _t(out)


@CudaTensor.register_op("__setitem__")
class setitem(Function):
    def forward(ctx, a, idx, val):
        new = a.data.clone()
        new[_unwrap_index(idx, new.device)] = _raw(val)
        return a._set_data(new)


@CudaTensor.register_op()
class narrow(Function):
    """``length`` elements along ``axis`` from ``start`` (an int or a 0-d
    integer tensor), as JAX's ``dynamic_slice_in_dim``: a negative start
    counts from the end, the start is then clamped to ``[0, n - length]``,
    and a tensor start stays on the device (no read to the host, so no
    synchronisation).  The backward writes the gradient into zeros at the
    same rows."""

    def forward(ctx, a, start, length: int, axis: int = 0):
        x = a.data
        axis = axis % x.ndim
        n = x.shape[axis]
        if not 0 <= length <= n:
            raise ValueError(f"narrow: length {length} not in [0, {n}]")
        start = _raw(start)
        if isinstance(start, torch.Tensor):
            st = start.to(x.device).long()
            st = torch.where(st < 0, st + n, st).clamp(0, n - length)
            rows = st + torch.arange(length, device=x.device)
            ctx.save_for_backward(a.shape, a.dtype, axis, rows)
            return _t(x.index_select(axis, rows))
        s = int(start)
        s = min(max(s + n if s < 0 else s, 0), n - length)
        ctx.save_for_backward(a.shape, a.dtype, axis, s)
        return _t(x.narrow(axis, s, length))

    def backward(ctx, g):
        shape, dtype, axis, at = ctx.get_saved_tensors()
        out = torch.zeros(shape, dtype=dtype, device=g.data.device)
        if isinstance(at, torch.Tensor):
            out.index_copy_(axis, at, g.data)
        else:
            out.narrow(axis, at, g.shape[axis]).copy_(g.data)
        return (_t(out),)


@CudaTensor.register_op()
class concat(Function):
    """Concatenate tensors along ``axis`` (backward slices the gradient)."""

    def forward(ctx, *ts, axis: int = -1):
        sizes = [t.shape[axis] for t in ts]
        ctx.save_for_backward(axis, sizes)
        return _t(torch.cat([t.data for t in ts], dim=axis))

    def backward(ctx, g):
        axis, sizes = ctx.get_saved_tensors()
        return tuple(_t(p) for p in g.data.split(sizes, dim=axis))


@CudaTensor.register_op(overwrite=True)
class pad(Function):
    """Constant pad of the trailing ``len(dims)`` axes by ``padding`` on
    each side (overrides the generic zeros+setitem composite)."""

    def forward(ctx, t, padding, dims: tuple = (-2, -1), value: float = 0.0):
        n = len(dims)
        lo, hi = padding if isinstance(padding, tuple) else (padding, padding)
        ctx.save_for_backward(lo, hi, n)
        return _t(torch.nn.functional.pad(t.data, (lo, hi) * n,
                                          value=float(value)))

    def backward(ctx, g):
        lo, hi, n = ctx.get_saved_tensors()
        idx = tuple(slice(None) for _ in range(g.ndim - n)) + tuple(
            slice(lo, s - hi) for s in g.shape[-n:])
        return _t(g.data[idx])


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------
@CudaTensor.register_op()
class dot(Function):
    def forward(ctx, a, b):
        ctx.save_for_backward(a.data, b.data)
        return _t(kmatmul(a.data, b.data))

    def backward(ctx, g):
        araw, braw = ctx.get_saved_tensors()
        ga, gb = matmul_vjp(g.data, araw, braw)
        return _t(ga), _t(gb)


@CudaTensor.register_op()
class einsum(Function):
    """General tensor contraction ``a.einsum("ab,bc->ac", b)``: one
    ``torch.einsum`` forward, one per differentiable operand backward,
    planned by ``autograd/einsum_spec.py``."""

    def forward(ctx, a, spec: str, *rest):
        datas = (a.data,) + tuple(o.data for o in rest)
        terms, out = parse_einsum_spec(spec, len(datas))
        ctx.save_for_backward(spec, terms, out, datas)
        return _t(torch.einsum(spec, *datas))

    def backward(ctx, g):
        spec, terms, out, datas = ctx.get_saved_tensors()
        grads = []
        for i, parent in enumerate(ctx.parents):
            if not parent.requires_grad:
                grads.append(None)
                continue
            sub, kept, term = einsum_bwd_plan(terms, out, i)
            others = [d for j, d in enumerate(datas) if j != i]
            gi = torch.einsum(sub, g.data, *others)
            for pos, c in enumerate(term):  # re-insert forward-summed axes
                if c not in kept:
                    gi = gi.unsqueeze(pos)
            gi = gi.expand(datas[i].shape)
            grads.append(_t(gi.to(datas[i].dtype)))
        return tuple(grads)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _restore(x, axis, keepdims, rank):
    if keepdims or axis is None:
        return x
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    for a in sorted(a % rank for a in axes):
        x = x.unsqueeze(a)
    return x


@CudaTensor.register_op("sum")
class sum_(Function):
    def forward(ctx, a, axis=None, keepdims: bool = False):
        ctx.save_for_backward(a.shape, axis, keepdims)
        return _t(kreduce(a.data, "sum", axis=axis, keepdims=keepdims))

    def backward(ctx, g):
        shape, axis, keepdims = ctx.get_saved_tensors()
        return _t(_restore(g.data, axis, keepdims, len(shape)).expand(shape))


def _minmax(name):
    class Op(Function):
        def forward(ctx, a, axis=None, keepdims: bool = False):
            y = kreduce(a.data, name, axis=axis, keepdims=keepdims)
            ctx.save_for_backward(a.data, y, axis, keepdims)
            return _t(y)

        def backward(ctx, g):
            x, y, axis, keepdims = ctx.get_saved_tensors()
            ye = _restore(y, axis, keepdims, x.dim())
            ge = _restore(g.data, axis, keepdims, x.dim())
            return _t(ew("b_minmax", ge, x, ye))

    Op.__name__ = name
    CudaTensor.register_op(name, Op, overwrite=True)


_minmax("max")
_minmax("min")


@CudaTensor.register_op()
class nan_to_num(Function):
    """Replace nan/+-inf (gradient passes through)."""

    def forward(ctx, a, nan: float = 0.0, posinf: float = 0.0,
                neginf: float = 0.0):
        return _t(torch.nan_to_num(a.data, nan=nan, posinf=posinf,
                                   neginf=neginf))

    def backward(ctx, g):
        return _t(g.data)


@CudaTensor.register_op()
class cumsum(Function):
    """Inclusive cumulative sum along ``axis`` (reverse-cumsum backward)."""

    def forward(ctx, a, axis: int = -1):
        ctx.save_for_backward(axis)
        return _t(torch.cumsum(a.data, dim=axis).to(a.dtype))

    def backward(ctx, g):
        (axis,) = ctx.get_saved_tensors()
        gd = g.data
        return _t(gd.flip(axis).cumsum(axis).flip(axis).to(gd.dtype))


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------
@CudaTensor.register_op()
class conv(Function):
    """N-D convolution, x (B, Cin, *S) with w (Cout, Cin/groups, *K), VALID
    padding.  The input gradient is computed only when ``x`` needs one (an
    image batch does not)."""

    def forward(ctx, x, w, strides=1, dilation=1, groups=1):
        ctx.save_for_backward(x.data, w.data, strides, dilation, groups)
        return _t(kconv_fwd(x.data, w.data, strides, dilation, groups))

    def backward(ctx, g):
        xd, wd, strides, dilation, groups = ctx.get_saved_tensors()
        gx, gw = kconv_bwd(g.data, xd, wd, strides, dilation, groups,
                           need_dx=ctx.parents[0].requires_grad)
        return (None if gx is None else _t(gx)), _t(gw)


# ---------------------------------------------------------------------------
# not ported yet
# ---------------------------------------------------------------------------
def _unported(name, item):
    class Op(Function):
        def forward(ctx, *args, **kwargs):
            raise NotImplementedError(
                f"{name} is not ported to the CUDA backend yet (ROADMAP.md, "
                f"{item})")

    Op.__name__ = name
    CudaTensor.register_op(name, Op, overwrite=True)


_unported("ring_attention", "queue 1, item 7: the parallel layer")


# ---------------------------------------------------------------------------
# int8 quantized linear (serving path; see lightgrad_tpu_torch/quant.py)
# ---------------------------------------------------------------------------
def int8_matmul(xq, wq):
    """``xq (..., in) @ wq (out, in).T`` of int8 tensors, summed exactly:
    int32, on the inputs' device."""
    return torch.matmul(xq.double(), wq.double().T).to(torch.int32)


@CudaTensor.register_op()
class quant_linear(Function):
    """Dynamic-activation int8 x int8 linear: ``y = x @ Wq.T * (xs*ws) + b``.

    ``wq`` is an int8 (out, in) matrix with per-output-channel scales
    ``wscale`` (out,); activations are quantized per row at run time, the
    int8 products summed exactly in int32, and the f32 epilogue applies
    both scales and casts to ``x``'s dtype.  The JAX package computes the
    dot in XLA outside any Pallas kernel, so it is plain PyTorch here, on
    the inputs' device (:func:`int8_matmul`): in float64, which holds every
    partial sum of int8 products exactly (|sum| <= in * 127^2 < 2^53), so
    the int32 result is the same in any order of summation (float32 would
    round sums past 2^24, which in = 3072 reaches).  Backward: the straight-through
    estimator through the dequantized weight; ``wq`` / ``wscale`` get no
    gradient."""

    def forward(ctx, x, wq, wscale, bias=None):
        xd = x.data
        wqd, wsd = _raw(wq), _raw(wscale)
        xf = xd.float()
        xs = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
        xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
        y = int8_matmul(xq, wqd).float() * xs * wsd.float()
        if bias is not None:
            y = y + _raw(bias).float()
        ctx.save_for_backward(wqd, wsd, xd.dtype, bias is not None)
        return _t(y.to(xd.dtype))

    def backward(ctx, g):
        wqd, wsd, xdt, has_bias = ctx.get_saved_tensors()
        wdeq = wqd.float() * wsd.float()[:, None]
        gx = torch.matmul(g.data.float(), wdeq)
        grads = (_t(gx.to(xdt)), None, None)
        # the bias gradient reduces to (out,) in Function's _unbroadcast
        return grads + (_t(g.data),) if has_bias else grads


# ---------------------------------------------------------------------------
# fused layer ops
# ---------------------------------------------------------------------------
@CudaTensor.register_op(overwrite=True)
class softmax(Function):
    """Fused numerically-stable softmax (overrides the 5-op composite)."""

    def forward(ctx, a, axis: int = -1):
        axis = axis % a.ndim
        last = a.ndim - 1
        x = a.data if axis == last else a.data.transpose(axis, last)
        y = ksoftmax_fwd(x)
        ctx.save_for_backward(axis, last, y)
        return _t(y if axis == last else y.transpose(axis, last))

    def backward(ctx, g):
        axis, last, y = ctx.get_saved_tensors()
        gd = g.data if axis == last else g.data.transpose(axis, last)
        gx = ksoftmax_bwd(gd, y)
        return _t(gx if axis == last else gx.transpose(axis, last))


@CudaTensor.register_op()
class layernorm(Function):
    """Fused layer normalization over the trailing dims of ``w``'s shape."""

    def forward(ctx, x, w, b, eps: float = 1e-5):
        xd, wd = x.data.contiguous(), w.data.contiguous()
        y, mean, rstd = kln_fwd(xd, wd, b.data.contiguous(), eps)
        # x and the row statistics, no (r, c) residual
        ctx.save_for_backward(xd, wd, mean, rstd)
        return _t(y)

    def backward(ctx, g):
        xd, wd, mean, rstd = ctx.get_saved_tensors()
        dx, dw, db = kln_bwd(g.data.contiguous(), xd, wd, mean, rstd)
        return _t(dx.reshape(xd.shape)), _t(dw), _t(db)


@CudaTensor.register_op()
class attention(Function):
    """Fused scaled-dot-product attention over (..., S, D) q/k/v.

    ``lengths``: per-example valid lengths of right-padded keys; a (batch,)
    vector is repeated over the remaining leading (head) dims and goes to
    the flash kernels as int32.  ``window`` > 0 (causal only): the sliding
    band i - window < j <= i, inside the flash kernels in both directions.
    k and v may carry fewer heads than q (grouped-query, kv-major): the
    kernels serve each KV head's query heads without a repeated copy."""

    def forward(ctx, q, k, v, scale: float, causal: bool = False,
                lengths=None, window: int = 0):
        lens = None
        if lengths is not None:
            lens = torch.as_tensor(_raw(lengths), device=q.data.device).to(
                torch.int32).reshape(-1, 1)
            b_flat = int(np.prod(q.shape[:-2]))
            # (batch,) -> one per (batch, head) row; an expand, which needs
            # no read of the lengths to the host
            lens = lens.expand(-1, b_flat // lens.shape[0]).reshape(-1) \
                .contiguous()
        qd, kd, vd = (t.data.contiguous() for t in (q, k, v))
        out, lse = kattn_fwd_res(qd, kd, vd, scale, causal=causal,
                                 lengths=lens, window=window)
        ctx.save_for_backward(qd, kd, vd, out, lse, scale, causal, lens,
                              window)
        return _t(out)

    def backward(ctx, g):
        (qd, kd, vd, out, lse, scale, causal, lens,
         window) = ctx.get_saved_tensors()
        dq, dk, dv = kattn_bwd(g.data.contiguous(), qd, kd, vd, scale,
                               causal=causal, out=out, lse=lse, lengths=lens,
                               window=window)
        return _t(dq), _t(dk), _t(dv)


@CudaTensor.register_op()
class astype(Function):
    """Dtype cast (differentiable: the gradient casts back)."""

    def forward(ctx, a, dtype):
        ctx.save_for_backward(a.dtype)
        return _t(a.data.to(torch_dtype(dtype)))

    def backward(ctx, g):
        (dtype,) = ctx.get_saved_tensors()
        return _t(g.data.to(dtype))


@CudaTensor.register_op()
class dropout(Function):
    """Inverted dropout; the mask is drawn from the device's generator in
    ``lightgrad_tpu_torch.random``."""

    def forward(ctx, a, p: float = 0.5, training: bool = True):
        if not training or p <= 0.0:
            ctx.save_for_backward(None)
            return _t(a.data)
        from ... import random

        dev = a.data.device
        keep = torch.rand(a.shape, generator=random.generator(dev),
                          device=dev) < 1.0 - p
        mask = keep.to(a.dtype) * (1.0 / (1.0 - p))
        ctx.save_for_backward(mask)
        return _t(ew("f_mul", a.data, mask))

    def backward(ctx, g):
        (mask,) = ctx.get_saved_tensors()
        if mask is None:
            return g
        return _t(ew("f_mul", g.data, mask))


def _register_compare(name):
    fwd = "f_" + name

    class Op(Function):
        """Elementwise comparison -> mask in the first operand's dtype (no
        gradient)."""

        def forward(ctx, a, b):
            braw = b.data if isinstance(b, AbstractTensor) \
                else _scalar(b, a.data)
            return _t(ew(fwd, a.data, braw))

        def backward(ctx, g):
            return None

    Op.__name__ = name
    CudaTensor.register_op(name, Op, overwrite=True)


_register_compare("eq")
_register_compare("ge")
_register_compare("gt")


@CudaTensor.register_op()
class randn_like(Function):
    """Standard-normal draws with ``a``'s shape and dtype (x ``scale``), from
    the device's generator.  No gradient."""

    def forward(ctx, a, scale: float = 1.0):
        from ... import random

        dev = a.data.device
        z = torch.randn(a.shape, generator=random.generator(dev), device=dev,
                        dtype=a.dtype)
        return _t(z * scale if scale != 1.0 else z)

    def backward(ctx, g):
        return None


@CudaTensor.register_op()
class randint_like(Function):
    """Uniform int32 draws in [lo, hi) with ``a``'s shape.  No gradient."""

    def forward(ctx, a, lo: int, hi: int):
        from ... import random

        dev = a.data.device
        return _t(torch.randint(lo, hi, a.shape,
                                generator=random.generator(dev), device=dev,
                                dtype=torch.int32))

    def backward(ctx, g):
        return None
