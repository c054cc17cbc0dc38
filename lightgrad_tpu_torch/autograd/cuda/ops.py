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
clone.  Sharded buffers (``DTensor``s of the parallel layer) go through
the same ops: the kernel wrappers place them by their strategies, plain
PyTorch by DTensor's own rules, and ``ring_attention`` rotates K/V
around a mesh axis.
"""

import numpy as np
import torch

from ..einsum_spec import bwd_plan as einsum_bwd_plan
from ..einsum_spec import parse_spec as parse_einsum_spec
from ..function import Function
from ..tensor import AbstractTensor
from .tensor import CudaTensor, torch_dtype, upload
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
from ...ops.runtime import is_sharded
from ...ops.softmax import softmax_bwd as ksoftmax_bwd
from ...ops.softmax import softmax_fwd as ksoftmax_fwd


def _t(x):
    return CudaTensor(x, requires_grad=False)


def _raw(x):
    return x.data if isinstance(x, AbstractTensor) else x


def _scalar(b, like):
    """A non-tensor operand of an op over ``like``, in ``like``'s dtype when
    that is floating, else in float32 for a float and ``like``'s dtype for
    an int (jnp's 32-bit promotion).  A Python or numpy scalar (a 0-d array
    too) goes to ``ew`` by value, rounded on the host: no device tensor is
    made, so nothing is copied to the card and nothing waits for it.  An
    array is uploaded (:func:`upload`: inside a compiled step, a constant
    of the step) and broadcasts as a tensor would, as the JAX package's
    ``_scalar`` makes an array of any operand."""
    if isinstance(b, torch.Tensor):
        return b
    if isinstance(b, np.ndarray) and b.ndim:
        if like.is_floating_point():
            dt = like.dtype
        else:
            dt = torch.float32 if b.dtype.kind == "f" else like.dtype
        return upload(b, like.device, dt)
    b = b.item() if isinstance(b, (np.generic, np.ndarray)) else b
    if like.is_floating_point():
        dt = like.dtype
    else:
        dt = torch.float32 if isinstance(b, float) else like.dtype
    return scalar(b, dt)


def _unwrap_index(idx, dev):
    if isinstance(idx, AbstractTensor):
        return idx.data
    if isinstance(idx, np.ndarray):
        return upload(idx, dev)
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
        # full_like keeps a sharded buffer's placement
        return a._set_data(torch.full_like(a.data, val))


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


def _index_dims(parts, ndim):
    """The source dim each part of an index reads (None for a ``None``
    part, which adds a dim; an Ellipsis stands for the dims it spans), or
    None where a boolean mask spans more than one dim."""
    def width(i):
        if i is None:
            return 0
        if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
            return i.ndim
        return 1
    rest = sum(width(i) for i in parts if i is not Ellipsis)
    dims, d = [], 0
    for i in parts:
        if i is Ellipsis:
            dims.append(None)
            d += ndim - rest
        elif width(i) > 1:
            return None
        else:
            dims.append(d if width(i) else None)
            d += width(i)
    return dims


def _clamped(idx, shape):
    """``idx`` with every integer index (an int, an integer tensor) clamped
    into its dim, as the JAX package's gathers clamp: ``a[9]`` of 4 rows is
    row 3, and a negative index counts from the end before it clamps."""
    parts = idx if isinstance(idx, tuple) else (idx,)
    dims = _index_dims(parts, len(shape))
    if dims is None:
        return idx
    out = []
    for i, d in zip(parts, dims):
        if d is not None:
            n = shape[d]
            if isinstance(i, (int, np.integer)) \
                    and not isinstance(i, (bool, np.bool_)):
                i = min(max(int(i), -n), n - 1)
            elif isinstance(i, torch.Tensor) and i.dtype != torch.bool \
                    and not i.is_floating_point() and n:
                i = i.clamp(-n, n - 1)
        out.append(i)
    return tuple(out) if isinstance(idx, tuple) else out[0]


def _positive_steps(idx, shape):
    """``(idx', dims)`` with ``x[idx] == x.flip(dims)[idx']`` and every step
    of ``idx'`` positive: torch slices take no negative step (the JAX
    package's flipped kernels of ``conv_transpose`` use one).  Beside the
    flipped slices an index may hold ints, integer arrays, one Ellipsis and
    ``None``s."""
    parts = idx if isinstance(idx, tuple) else (idx,)
    if not any(isinstance(i, slice) and i.step is not None and i.step < 0
               for i in parts):
        return idx, ()
    dims = _index_dims(parts, len(shape))
    if dims is None:
        raise NotImplementedError(f"negative slice steps beside {idx!r}")
    out, flips = [], []
    for d, i in zip(dims, parts):
        if isinstance(i, slice) and i.step is not None and i.step < 0:
            r = range(*i.indices(shape[d]))
            n = shape[d] - 1
            i = slice(n - r[0], n - r[-1] + 1, -i.step) if len(r) \
                else slice(0, 0)
            flips.append(d)
        out.append(i)
    return tuple(out), tuple(flips)


@CudaTensor.register_op("__getitem__")
class getitem(Function):
    def forward(ctx, a, idx):
        idx = _unwrap_index(idx, a.data.device)
        parts = idx if isinstance(idx, tuple) else (idx,)
        if is_sharded(a.data, *parts):
            return _sharded_getitem(ctx, a, idx)
        idx, flips = _positive_steps(_clamped(idx, a.shape), a.shape)
        ctx.save_for_backward(a.shape, a.dtype, idx, flips)
        x = a.data.flip(flips) if flips else a.data
        return _t(x[idx])

    def backward(ctx, g):
        shape, dtype, idx, flips = ctx.get_saved_tensors()
        gd = g.data.to(dtype)
        if flips is None:       # a sharded lookup: ``shape`` holds the table
            return _t(_rows_backward(gd, idx, shape))
        if is_sharded(gd):
            return _t(_autograd_scatter(gd.new_zeros(shape), idx, gd))
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
            # mixed basic/advanced
            out = _autograd_scatter(out, idx, gd)
        return _t(out)


def _autograd_scatter(zeros, idx, gd):
    """The gradient of ``x[idx]`` for cotangent ``gd``: the scatter-add of
    torch's own indexing backward, which accumulates repeats too."""
    with torch.enable_grad():
        z = zeros.requires_grad_(True)
        (out,) = torch.autograd.grad(z[idx], z, gd)
    return out


def _sharded_getitem(ctx, a, idx):
    """``a[idx]`` of a sharded buffer (``DTensor``).  A table's rows by an
    integer tensor -- an embedding lookup -- go through
    ``F.embedding``, whose sharding rule looks up each shard's rows and
    masks the others, then sums the shards' rows (one all-reduce), so a
    table sharded over the vocabulary is never gathered whole.  Index
    tensors count as replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    parts = idx if isinstance(idx, tuple) else (idx,)
    mesh = next(t.device_mesh for t in (a.data, *parts) if is_sharded(t))
    rep = [Replicate()] * mesh.ndim

    def dt(i):
        if isinstance(i, torch.Tensor) and not is_sharded(i):
            return DTensor.from_local(i, mesh, rep, run_check=False)
        return i

    x = dt(a.data)          # a whole table is replicated on the mesh
    if isinstance(idx, torch.Tensor) and a.ndim == 2 \
            and not idx.is_floating_point() and idx.dtype != torch.bool:
        ids = dt(idx.long())
        ctx.save_for_backward(x, a.dtype, ids, None)
        out = torch.nn.functional.embedding(ids, x)
        # the masked partial sum holds its mask for one reduction only
        return _t(out.redistribute(mesh, [
            Replicate() if p.is_partial() else p for p in out.placements]))
    idx = tuple(dt(i) for i in idx) if isinstance(idx, tuple) else dt(idx)
    ctx.save_for_backward(a.shape, a.dtype, idx, ())
    return _t(x[idx])


def _rows_backward(gd, ids, table):
    """The table gradient of a sharded embedding lookup: each shard's own
    rows (and columns) of the cotangents, summed into a shard of the
    table's placement -- nothing of the table is gathered."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, pl = table.device_mesh, table.placements
    shape, (lo, clo) = compute_local_shape_and_global_offset(
        table.shape, mesh, pl)
    rows = ids.full_tensor().reshape(-1)
    g = gd.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    g = g.reshape(-1, table.shape[1])[:, clo:clo + shape[1]]
    mine = (rows >= lo) & (rows < lo + shape[0])
    out = torch.zeros(shape, dtype=gd.dtype, device=g.device)
    # the accumulating index_put_ of the whole table's gather backward, so
    # a bf16 table sums its rows in the same order
    out.index_put_((rows[mine] - lo,), g[mine], accumulate=True)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _dropped(idx, shape):
    """``(idx', pad)``: ``idx`` with the rows a scatter drops sent to a
    pad row (index n of a dim of n, after a negative index counts from the
    end), as the JAX package's scatters drop out-of-range rows; ``pad``
    lists the dims that need the row.  None where an int index is out of
    range: the whole write is dropped."""
    parts = idx if isinstance(idx, tuple) else (idx,)
    dims = _index_dims(parts, len(shape))
    if dims is None:
        return idx, ()
    out, pad = [], []
    for i, d in zip(parts, dims):
        if d is not None:
            n = shape[d]
            if isinstance(i, (int, np.integer)) \
                    and not isinstance(i, (bool, np.bool_)):
                if not -n <= i < n:
                    return None, ()
            elif isinstance(i, torch.Tensor) and i.dtype != torch.bool \
                    and not i.is_floating_point():
                i = torch.where(i < 0, i + n, i)
                i = torch.where((i < 0) | (i >= n), n, i)
                pad.append(d)
        out.append(i)
    return (tuple(out) if isinstance(idx, tuple) else out[0]), tuple(pad)


def _value(val, like):
    """A ``setitem`` value as torch takes it: a tape tensor's buffer, a
    numpy array uploaded in ``like``'s dtype, a numpy scalar as a number."""
    val = _raw(val)
    if isinstance(val, np.ndarray):
        return upload(val, like.device, like.dtype)
    return val.item() if isinstance(val, np.generic) else val


@CudaTensor.register_op("__setitem__")
class setitem(Function):
    """``a[idx] = val`` into a fresh buffer.  Out-of-range rows are
    dropped, as the JAX package's scatters drop them; negative slice steps
    and numpy values (arrays, scalars, index arrays) are taken."""

    def forward(ctx, a, idx, val):
        new = a.data.clone()
        idx, flips = _positive_steps(_unwrap_index(idx, new.device),
                                     new.shape)
        idx, pad = _dropped(idx, new.shape)
        if idx is None:
            return a._set_data(new)
        x = new.flip(flips) if flips else new
        for d in pad:
            x = torch.cat([x, x.narrow(d, 0, 1)], d)
        x[idx] = _value(val, new)
        for d in pad:
            x = x.narrow(d, 0, new.shape[d])
        if pad or flips:
            x = x.flip(flips) if flips else x
            new = x.contiguous() if pad else x
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
# scan.py's remat="dots" / "dots_all": while a ScannedStack runs a layer,
# each product's output goes through this store, which keeps it on the
# layer's first pass and hands it back, without a launch, when the layer is
# replayed; ``batched`` says whether the product has batch dimensions
product_store = None


def _product(compute, batched):
    return compute() if product_store is None \
        else product_store(compute, batched)


@CudaTensor.register_op()
class dot(Function):
    def forward(ctx, a, b):
        ctx.save_for_backward(a.data, b.data)
        return _t(_product(lambda: kmatmul(a.data, b.data), b.ndim > 2))

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
        batched = any(all(c in t for t in terms) for c in out)
        return _t(_product(lambda: torch.einsum(spec, *datas), batched))

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


@CudaTensor.register_op()
class ring_attention(Function):
    """Sequence-parallel exact attention: K/V rotate around the mesh's
    ``axis`` ring instead of the whole sequence being gathered; q, k, v are
    ``(..., S, D)`` buffers sharded on S over that axis (``DTensor``s, or
    whole arrays, which the op shards).  The backward is the ring's own
    (parallel/ring_attention.py): dk and dv travel home with K/V."""

    def forward(ctx, q, k, v, scale: float = 1.0, mesh=None, axis: str = "sp",
                causal: bool = False, batch_axis: str = None):
        from ...parallel.ring_attention import ring_sharded_fwd

        if mesh is None:
            raise ValueError("ring_attention needs a mesh (parallel."
                             "make_mesh) with the sequence axis")
        out, state = ring_sharded_fwd(q.data, k.data, v.data, scale, mesh,
                                      axis=axis, causal=causal,
                                      batch_axis=batch_axis)
        ctx.save_for_backward(state)
        return _t(out)

    def backward(ctx, g):
        from ...parallel.ring_attention import ring_sharded_bwd

        (state,) = ctx.get_saved_tensors()
        return tuple(_t(d) for d in ring_sharded_bwd(g.data, state))


# ---------------------------------------------------------------------------
# int8 quantized linear (serving path; see lightgrad_tpu_torch/quant.py)
# ---------------------------------------------------------------------------
def int8_matmul(xq, wq):
    """``xq (..., in) @ wq (out, in).T`` of int8 tensors, summed exactly:
    int32, on the inputs' device."""
    return torch.matmul(xq.double(), wq.double().T).to(torch.int32)


def int8_linear(x, wq, wscale, bias=None):
    """``x @ dequant(wq).T + bias`` the int8 way, on torch tensors: ``x``
    quantized per row (scale ``max(absmax, 1e-8) / 127``), the int8
    products summed exactly, both scales and the bias applied in f32, the
    result in ``x``'s dtype."""
    xf = x.float()
    xs = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    y = int8_matmul(xq, wq).float() * xs * wscale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def int8_linear_dx(g, wq, wscale):
    """The straight-through input gradient of :func:`int8_linear`: ``g``
    through the dequantized weight, in f32."""
    return torch.matmul(g.float(), wq.float() * wscale.float()[:, None])


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
        y = int8_linear(xd, wqd, wsd, None if bias is None else _raw(bias))
        ctx.save_for_backward(wqd, wsd, xd.dtype, bias is not None)
        return _t(y)

    def backward(ctx, g):
        wqd, wsd, xdt, has_bias = ctx.get_saved_tensors()
        grads = (_t(int8_linear_dx(g.data, wqd, wsd).to(xdt)), None, None)
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
