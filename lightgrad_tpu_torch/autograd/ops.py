"""The tape's derived ops, and the fused ops of the ``torch.autograd`` models.

Two tapes share this package.  The lightgrad tape (``Function``,
``AbstractTensor``) gets here, as in ``lightgrad_tpu/autograd/ops.py``, its
device-agnostic layer: the operator dunders, the ``sub/div/rsub/rdiv``
composites, ``sigmoid/tanh/softmax/gelu`` fallbacks (the CUDA backend
overrides them with fused ops), ``mean``, ``pad``, the pooling family
(``max_pool2d`` with overlapping, padded windows) and ``conv_transpose``.
Composites record their primitive sub-ops directly on the tape.

The GPT-2 model is a ``torch.nn.Module`` on ``torch.autograd``; its fused
``layernorm`` and ``attention`` are the ``torch.autograd.Function``s at the
end of this module: the forward runs the fused kernel and saves its
residuals, the backward runs the kernel's backward.  ``flash_block`` is the
(out, lse) unit of blockwise / ring attention, differentiable through lse.
On CUDA tensors both directions launch the hand-written kernels
(ops/layernorm.py, ops/attention.py); on CPU tensors, their plain
versions.
"""

from functools import reduce as _reduce

import torch

from ..ops.attention import (attention_bwd, attention_fwd_res,
                             flash_block_bwd, flash_block_fwd)
from ..ops.layernorm import layernorm_bwd_dx, layernorm_fwd

__all__ = ["attention", "flash_block", "layernorm"]


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        y, xhat, rstd = layernorm_fwd(x, w, b, eps)
        ctx.save_for_backward(w, xhat, rstd)
        ctx.x_shape = x.shape
        return y

    @staticmethod
    def backward(ctx, g):
        w, xhat, rstd = ctx.saved_tensors
        r, c = xhat.shape
        g2 = g.reshape(r, c).contiguous()
        dx = layernorm_bwd_dx(g2, w, xhat, rstd).reshape(ctx.x_shape)
        # weight and bias gradients: plain row sums in f32, as the JAX
        # package leaves them to its reduce op
        g32 = g2.float()
        dw = (g32 * xhat).sum(0).reshape(w.shape).to(w.dtype)
        db = g32.sum(0).reshape(w.shape).to(w.dtype)
        return dx, dw, db, None


class _Attention(torch.autograd.Function):
    """(out, lse) of the flash forward.  ``attention`` keeps out (lse is
    not differentiable there); ``flash_block`` (``block``) keeps both, and
    its backward takes lse's cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block):
        fwd = flash_block_fwd if block else attention_fwd_res
        out, lse = fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.block = scale, causal, block
        if not block:
            ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, glse):
        q, k, v, out, lse = ctx.saved_tensors
        # the cotangent arrives through transpose(1, 2).reshape: strided
        g = g.contiguous()
        if ctx.block:
            grads = flash_block_bwd(g, glse, q, k, v, out, lse, ctx.scale,
                                    ctx.causal)
        else:
            grads = attention_bwd(g, q, k, v, ctx.scale, ctx.causal, out=out,
                                  lse=lse)
        return (*grads, None, None, None)


def layernorm(x, w, b, eps: float = 1e-5):
    """Fused layer normalization over the trailing dims of ``w``'s shape."""
    return _LayerNorm.apply(x, w, b, float(eps))


def attention(q, k, v, scale: float, causal: bool = False):
    """Fused scaled-dot-product attention over (..., S, D) q/k/v; k and v
    may carry fewer leading rows (grouped-query, kv-major)."""
    return _Attention.apply(q, k, v, float(scale), bool(causal), False)[0]


def flash_block(q, k, v, scale: float, causal: bool = False):
    """(out (B, S, D), lse (B, S, 1) f32) of one (Q, K-chunk) flash pass,
    differentiable in q, k and v through both outputs: the unit that
    blockwise and ring attention merge (the JAX package's ``flash_block``).
    k and v may carry fewer rows (grouped-query)."""
    # chunks of a longer sequence arrive as strided views
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _Attention.apply(q, k, v, float(scale), bool(causal), True)


# ---------------------------------------------------------------------------
# the lightgrad tape: operator dunders -> registered methods
# ---------------------------------------------------------------------------
from .function import Function, composite  # noqa: E402
from .tensor import AbstractTensor  # noqa: E402

AbstractTensor.__neg__ = lambda t: t.neg()
AbstractTensor.__pow__ = lambda a, b: a.pow(b)
AbstractTensor.__add__ = lambda a, b: a.add(b)
AbstractTensor.__radd__ = lambda a, b: a.add(b)
AbstractTensor.__mul__ = lambda a, b: a.mul(b)
AbstractTensor.__rmul__ = lambda a, b: a.mul(b)
AbstractTensor.__sub__ = lambda a, b: a.sub(b)
AbstractTensor.__truediv__ = lambda a, b: a.div(b)
AbstractTensor.__rsub__ = lambda b, a: b.rsub(a)
AbstractTensor.__rtruediv__ = lambda b, a: b.rdiv(a)
AbstractTensor.__matmul__ = lambda a, b: a.dot(b)
# in-place dunders route to the backend's in-place ops (iadd/isub/...)
AbstractTensor.__iadd__ = lambda a, b: a.iadd(b)
AbstractTensor.__isub__ = lambda a, b: a.isub(b)
AbstractTensor.__imul__ = lambda a, b: a.imul(b)
AbstractTensor.__itruediv__ = lambda a, b: a.idiv(b)


# --- arithmetic composites (backends may override with fused primitives) --
@composite
def sub(a, b):
    return a + (-b)


@composite
def div(a, b):
    return a * (b ** -1.0)


@composite
def rsub(b, a):
    """``a - b`` with ``a`` a scalar on the left."""
    return (-b) + a


@composite
def rdiv(b, a):
    """``a / b`` with ``a`` a scalar on the left."""
    return (b ** -1.0) * a


AbstractTensor.register_method("sub", sub)
AbstractTensor.register_method("div", div)
AbstractTensor.register_method("rsub", rsub)
AbstractTensor.register_method("rdiv", rdiv)


# --- activations ----------------------------------------------------------
@composite
def sigmoid(t):
    return 1.0 / (1.0 + t.neg().exp())


@composite
def tanh(t):
    # tanh(x) = 2*sigmoid(2x) - 1
    return (t * 2.0).sigmoid() * 2.0 - 1.0


@composite
def softmax(t, axis: int = -1):
    exps = (t - t.max(axis=axis, keepdims=True)).exp()
    return exps / exps.sum(axis=axis, keepdims=True)


@composite
def gelu(t):
    """tanh-approximated GELU (the BERT variant)."""
    return t * ((t * 0.7978845608028654 * (1.0 + 0.044715 * t * t)).tanh()
                + 1.0) * 0.5


AbstractTensor.register_method("sigmoid", sigmoid)
AbstractTensor.register_method("tanh", tanh)
AbstractTensor.register_method("softmax", softmax)
AbstractTensor.register_method("gelu", gelu)


# --- reductions -----------------------------------------------------------
@composite
def mean(t, axis=None, keepdims: bool = False):
    s = t.sum(axis=axis, keepdims=keepdims)
    count = t.numel() / max(s.numel(), 1)
    return s * (1.0 / count)


AbstractTensor.register_method("mean", mean)


# --- padding (backends override with a native pad) ------------------------
@AbstractTensor.register_op()
class pad(Function):
    """Zero- (or value-) pad the trailing ``dims`` by ``padding`` on both
    sides."""

    def forward(ctx, t, padding, dims: tuple = (-2, -1), value: float = 0.0):
        n = len(dims)
        lo, hi = padding if isinstance(padding, tuple) else (padding, padding)
        ctx.save_for_backward(lo, hi, n)
        out_shape = t.shape[:-n] + tuple(lo + hi + s for s in t.shape[-n:])
        out = type(t).empty(out_shape, dtype=t.dtype).fill(value).detach()
        idx = tuple(slice(None) for _ in t.shape[:-n]) + tuple(
            slice(lo, lo + s) for s in t.shape[-n:])
        out[idx] = t
        return out

    def backward(ctx, out_grad):
        lo, hi, n = ctx.get_saved_tensors()
        idx = tuple(slice(None) for _ in out_grad.shape[:-n]) + tuple(
            slice(lo, s - hi) for s in out_grad.shape[-n:])
        return out_grad[idx]


# --- pooling: window extraction via reshape/transpose, then a reduction
# over axis 0; the tape provides the backward ------------------------------
@composite
def pool(t, kernel: tuple = (2, 2)):
    n = len(kernel)
    lead, spatial = t.shape[:-n], t.shape[-n:]
    out_sp = tuple(d // k for d, k in zip(spatial, kernel))
    cropped = tuple(o * k for o, k in zip(out_sp, kernel))
    if cropped != spatial:
        idx = tuple(slice(None) for _ in lead) + tuple(
            slice(c) for c in cropped)
        t = t[idx]
    split_shape = lead + sum(((o, k) for o, k in zip(out_sp, kernel)), ())
    t = t.reshape(*split_shape)
    m = len(lead)
    kernel_axes = tuple(m + 2 * i + 1 for i in range(n))
    block_axes = tuple(m + 2 * i for i in range(n))
    t = t.transpose(*kernel_axes, *range(m), *block_axes)
    flat_k = _reduce(lambda a, b: a * b, kernel, 1)
    return t.reshape(flat_k, *lead, *out_sp)


@composite
def max_pool(t, kernel: tuple = (2, 2)):
    return t.pool(kernel=kernel).max(axis=0, keepdims=False)


@composite
def max_pool2d(t, kernel: tuple = (2, 2), stride=None, padding: int = 0):
    """Torch-semantics max pooling over the trailing (H, W) dims:
    overlapping windows (stride < kernel) and padding, unlike ``max_pool``,
    whose reshape needs stride == kernel.  Windows are ``kh*kw`` shifted
    strided slices stacked on a new axis, so the backward comes from
    getitem / concat / max."""
    kh, kw = kernel if isinstance(kernel, tuple) else (kernel, kernel)
    sh, sw = (stride if isinstance(stride, tuple) else (stride, stride)) \
        if stride is not None else (kh, kw)
    if padding:
        # a finite -inf: padded cells never win the max
        t = t.pad(padding, dims=(-2, -1), value=-1e30)
    h, w = t.shape[-2:]
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    lead = tuple(slice(None) for _ in t.shape[:-2])
    slices = []
    for i in range(kh):
        for j in range(kw):
            s = t[lead + (slice(i, i + (oh - 1) * sh + 1, sh),
                          slice(j, j + (ow - 1) * sw + 1, sw))]
            slices.append(s.reshape(1, *s.shape))
    if len(slices) == 1:
        return slices[0].max(axis=0, keepdims=False)
    return slices[0].concat(*slices[1:], axis=0).max(axis=0, keepdims=False)


@composite
def min_pool(t, kernel: tuple = (2, 2)):
    return t.pool(kernel=kernel).min(axis=0, keepdims=False)


@composite
def mean_pool(t, kernel: tuple = (2, 2)):
    return t.pool(kernel=kernel).mean(axis=0, keepdims=False)


@composite
def conv_transpose(t, w, strides: int = 1, dilation: int = 1, groups: int = 1,
                   output_padding: int = 0, pad: int = 0):
    """Transposed (fractionally-strided) convolution, 1-D or 2-D.

    Torch semantics and weight layout ``(Cin, Cout/g, *K)``: output spatial
    ``(s-1)*stride - 2*pad + (k-1)*dilation + 1 + output_padding``.  Built
    from primitives -- zero-dilate the input (reshape + pad + reshape),
    flip and transpose the kernel, a stride-1 conv -- so the tape gives the
    backward."""
    n = w.ndim - 2
    assert n in (1, 2), f"conv_transpose supports 1-D/2-D, got {n}-D"
    st, dl = strides, dilation
    assert isinstance(st, int) and isinstance(dl, int), \
        "conv_transpose takes scalar stride/dilation"
    k_eff = tuple((k - 1) * dl + 1 for k in w.shape[2:])
    assert all(0 <= pad <= ke - 1 for ke in k_eff), \
        f"pad must be in [0, k_eff-1], got {pad} vs {k_eff}"
    b, cin = t.shape[0], t.shape[1]
    spatial = t.shape[2:]

    if st > 1:
        # zero-dilate: x[..., i] -> position i*st.  Split each spatial dim
        # into (S, 1), grow the singleton to st with a right zero-pad, then
        # flatten and crop the trailing st-1 zeros.
        if n == 2:
            sh, sw = spatial
            y = t.reshape(b, cin, sh, 1, sw, 1)
            y = y.pad((0, st - 1), dims=(-1,))      # (b,c,sh,1,sw,st)
            y = y.transpose(0, 1, 2, 5, 4, 3)       # (b,c,sh,st,sw,1)
            y = y.pad((0, st - 1), dims=(-1,))      # (b,c,sh,st,sw,st)
            y = y.reshape(b, cin, sh * st, sw * st)
            t = y[:, :, : (sh - 1) * st + 1, : (sw - 1) * st + 1]
        else:
            (sw,) = spatial
            y = t.reshape(b, cin, sw, 1).pad((0, st - 1), dims=(-1,))
            t = y.reshape(b, cin, sw * st)[:, :, : (sw - 1) * st + 1]

    lo = tuple(ke - 1 - pad for ke in k_eff)
    hi = tuple(ke - 1 - pad + output_padding for ke in k_eff)
    assert len(set(lo)) == 1 and len(set(hi)) == 1, \
        "anisotropic kernels need equal k_eff"
    if lo[0] > 0 or hi[0] > 0:
        t = t.pad((lo[0], hi[0]), dims=tuple(range(-n, 0)))

    # weight (Cin, Cout/g, *K) -> flipped, per-group-transposed
    # (Cout, Cin/g, *K)
    flip = (slice(None), slice(None)) + (slice(None, None, -1),) * n
    wf = w[flip]
    og = w.shape[1]
    wf = wf.reshape(groups, cin // groups, og, *w.shape[2:])
    wf = wf.transpose(0, 2, 1, *range(3, 3 + n))
    wf = wf.reshape(groups * og, cin // groups, *w.shape[2:])
    return t.conv(wf, strides=1, dilation=dl, groups=groups)


AbstractTensor.register_method("pool", pool)
AbstractTensor.register_method("max_pool", max_pool)
AbstractTensor.register_method("max_pool2d", max_pool2d)
AbstractTensor.register_method("min_pool", min_pool)
AbstractTensor.register_method("mean_pool", mean_pool)
AbstractTensor.register_method("conv_transpose", conv_transpose)
