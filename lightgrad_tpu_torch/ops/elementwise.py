"""The elementwise kernel family ("atom"): one Triton kernel, many bodies.

Counterpart of ``lightgrad_tpu/ops/elementwise.py`` (TPU kernel
``_pallas_ew``): ``ew(body, *xs, n_out=1)`` applies an N-ary, multi-output
function over broadcastable operands.  A body is named by a string, and
each name has two definitions of the same math: a torch function in
``_TORCH`` (the plain twin, :func:`ew_reference`) and a ``@triton.jit``
function built in :func:`_triton_bodies`.  They are the JAX package's
``_f_*`` / ``_b_*`` / ``_b2_*`` / ``_b1_*`` bodies and its compares
(``lightgrad_tpu/autograd/tpu/ops.py``), under the same names without the
leading underscore.

Semantics: the output shape is the operands' broadcast shape; output
dtypes follow the promotion of the torch body over the operand dtypes
(float32, bfloat16, int32), as jnp's do: bfloat16 with float32 gives
float32, int32 with float32 gives float32.  Floating operands are widened
to float32 for the math on both paths, and outputs are rounded once.

The kernel on this card: a fused pass over memory, bound by bytes moved
(a few flops per element).  What the TPU kernel does is kept:

* dims with the same broadcast signature across operands are merged
  (``_canonicalize``) -- at most 4 remain, or the call raises;
* an operand that is broadcast is read through stride 0 and never
  materialised at the output shape; an operand of the output's shape is
  read at the flat index with no index arithmetic, a one-element operand
  is loaded once per program;
* ``n_out = 2`` writes both gradients of a binary op in one pass.

The body reaches the kernel as a ``tl.constexpr`` argument, so Triton
compiles one specialisation per (body, dtypes, operand modes), at its first
launch; ``triton`` is imported only then.
"""

import functools
from math import prod

import torch

from . import runtime

__all__ = ["ew", "ew_reference", "BODIES"]

_MAX_RANK = 4
_MAX_IN, _MAX_OUT = 4, 2
_BLOCK = 1024
_DTYPES = (torch.float32, torch.bfloat16, torch.int32)

_SQRT_2_OVER_PI = 0.7978845608028654
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


# ---------------------------------------------------------------------------
# torch bodies (the plain twin)
# ---------------------------------------------------------------------------
def _gelu_tanh_u(x):
    return _SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)


def _b_gelu(g, x):
    t = torch.tanh(_gelu_tanh_u(x))
    du = _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * x * x)
    return g * (0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du)


def _b_gelu_exact(g, x):
    cdf = 0.5 * (1.0 + torch.erf(x * _INV_SQRT2))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * x * x)
    return g * (cdf + x * pdf)


_TORCH = {
    "f_neg": lambda x: -x,
    "b_neg": lambda g: -g,
    "f_sin": torch.sin,
    "b_sin": lambda g, x: g * torch.cos(x),
    "f_cos": torch.cos,
    "b_cos": lambda g, x: -g * torch.sin(x),
    "f_exp": torch.exp,
    "b_exp": lambda g, y: g * y,
    "f_log": torch.log,
    "b_log": lambda g, x: g / x,
    "f_sigmoid": torch.sigmoid,
    "b_sigmoid": lambda g, y: g * y * (1.0 - y),
    "f_tanh": torch.tanh,
    "b_tanh": lambda g, y: g * (1.0 - y * y),
    "f_relu": lambda x: torch.clamp_min(x, 0),
    "b_relu": lambda g, x: g * (x > 0).to(g.dtype),
    "f_gelu": lambda x: 0.5 * x * (1.0 + torch.tanh(_gelu_tanh_u(x))),
    "b_gelu": _b_gelu,
    "f_gelu_exact": lambda x: 0.5 * x * (1.0 + torch.erf(x * _INV_SQRT2)),
    "b_gelu_exact": _b_gelu_exact,
    "f_add": lambda a, b: a + b,
    "b2_add": lambda g, a, b: (g, g),
    "b1_add": lambda g: g,
    "f_sub": lambda a, b: a - b,
    "b2_sub": lambda g, a, b: (g, -g),
    "f_mul": lambda a, b: a * b,
    "b2_mul": lambda g, a, b: (g * b, g * a),
    "b1_mul": lambda g, b: g * b,
    "f_div": lambda a, b: a / b,
    "b2_div": lambda g, a, b: (g / b, -g * a / (b * b)),
    "b1_div": lambda g, b: g / b,
    "f_pow": lambda a, b: a ** b,
    "b2_pow": lambda g, a, b, y: (g * b * a ** (b - 1.0), g * y * torch.log(a)),
    "b1_pow": lambda g, a, b: g * b * a ** (b - 1.0),
    "b_minmax": lambda g, x, y: g * (x == y).to(g.dtype),
    "f_eq": lambda a, b: (a == b).to(a.dtype),
    "f_ge": lambda a, b: (a >= b).to(a.dtype),
    "f_gt": lambda a, b: (a > b).to(a.dtype),
}
BODIES = tuple(_TORCH)

_bodies = None
_kernel = None


def _triton_bodies():
    """The Triton twin of every torch body, built at the first launch."""
    # module globals: Triton resolves the names a kernel calls (tl, ld and
    # the two helpers) in its module's namespace
    global _bodies, _kernel, triton, tl, ld, _gelu_u, _ew_load
    if _bodies is not None:
        return _bodies, _kernel
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice as ld

    jit = triton.jit

    @jit
    def _gelu_u(x):
        return 0.7978845608028654 * (x + 0.044715 * x * x * x)

    @jit
    def f_neg(x): return -x
    @jit
    def b_neg(g): return -g
    @jit
    def f_sin(x): return tl.sin(x)
    @jit
    def b_sin(g, x): return g * tl.cos(x)
    @jit
    def f_cos(x): return tl.cos(x)
    @jit
    def b_cos(g, x): return -g * tl.sin(x)
    @jit
    def f_exp(x): return tl.exp(x)
    @jit
    def b_exp(g, y): return g * y
    @jit
    def f_log(x): return tl.log(x)
    @jit
    def b_log(g, x): return g / x
    @jit
    def f_sigmoid(x): return 1.0 / (1.0 + tl.exp(-x))
    @jit
    def b_sigmoid(g, y): return g * y * (1.0 - y)
    @jit
    def f_tanh(x): return ld.tanh(x)
    @jit
    def b_tanh(g, y): return g * (1.0 - y * y)
    @jit
    def f_relu(x): return tl.where(x > 0, x, 0)
    @jit
    def b_relu(g, x): return tl.where(x > 0, g, 0.0)
    @jit
    def f_gelu(x): return 0.5 * x * (1.0 + ld.tanh(_gelu_u(x)))

    @jit
    def b_gelu(g, x):
        t = ld.tanh(_gelu_u(x))
        du = 0.7978845608028654 * (1.0 + 3 * 0.044715 * x * x)
        return g * (0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du)

    @jit
    def f_gelu_exact(x): return 0.5 * x * (1.0 + ld.erf(x * 0.7071067811865476))

    @jit
    def b_gelu_exact(g, x):
        cdf = 0.5 * (1.0 + ld.erf(x * 0.7071067811865476))
        pdf = 0.3989422804014327 * tl.exp(-0.5 * x * x)
        return g * (cdf + x * pdf)

    @jit
    def f_add(a, b): return a + b
    @jit
    def b2_add(g, a, b): return g, g
    @jit
    def b1_add(g): return g
    @jit
    def f_sub(a, b): return a - b
    @jit
    def b2_sub(g, a, b): return g, -g
    @jit
    def f_mul(a, b): return a * b
    @jit
    def b2_mul(g, a, b): return g * b, g * a
    @jit
    def b1_mul(g, b): return g * b
    @jit
    def f_div(a, b): return a / b
    @jit
    def b2_div(g, a, b): return g / b, -g * a / (b * b)
    @jit
    def b1_div(g, b): return g / b
    @jit
    def f_pow(a, b): return ld.pow(a.to(tl.float32), b.to(tl.float32))

    @jit
    def b2_pow(g, a, b, y):
        a32, b32 = a.to(tl.float32), b.to(tl.float32)
        return g * b32 * ld.pow(a32, b32 - 1.0), g * y * tl.log(a32)

    @jit
    def b1_pow(g, a, b):
        b32 = b.to(tl.float32)
        return g * b32 * ld.pow(a.to(tl.float32), b32 - 1.0)

    @jit
    def b_minmax(g, x, y): return tl.where(x == y, g, 0.0)
    @jit
    def f_eq(a, b): return a == b
    @jit
    def f_ge(a, b): return a >= b
    @jit
    def f_gt(a, b): return a > b

    @jit
    def _ew_load(X, offs, mask, i0, i1, i2, i3, S0, S1, S2, S3,
             MODE: tl.constexpr, UP: tl.constexpr):
        if MODE == 0:        # the output's shape: the flat index
            v = tl.load(X + offs, mask=mask)
        elif MODE == 1:      # one element, broadcast by the arithmetic
            v = tl.load(X)
        else:                # broadcast dims have stride 0
            v = tl.load(X + (i0 * S0 + i1 * S1 + i2 * S2 + i3 * S3),
                        mask=mask)
        if UP:
            v = v.to(tl.float32)
        return v

    @jit(do_not_specialize=[
        "N", "D1", "D2", "D3", "A0", "A1", "A2", "A3", "B0", "B1", "B2",
        "B3", "C0", "C1", "C2", "C3", "E0", "E1", "E2", "E3"])
    def ew_kernel(X0, X1, X2, X3, Y0, Y1, N, D1, D2, D3,
                  A0, A1, A2, A3, B0, B1, B2, B3,
                  C0, C1, C2, C3, E0, E1, E2, E3,
                  BODY: tl.constexpr, N_IN: tl.constexpr,
                  N_OUT: tl.constexpr, M0: tl.constexpr, M1: tl.constexpr,
                  M2: tl.constexpr, M3: tl.constexpr, U0: tl.constexpr,
                  U1: tl.constexpr, U2: tl.constexpr, U3: tl.constexpr,
                  NEED_IDX: tl.constexpr, BIG: tl.constexpr,
                  BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        if BIG:
            offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        else:
            offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < N
        i0 = offs
        i1 = offs
        i2 = offs
        i3 = offs
        if NEED_IDX:         # multi-index in the canonical (<= 4-D) shape
            i3 = offs % D3
            r = offs // D3
            i2 = r % D2
            r = r // D2
            i1 = r % D1
            i0 = r // D1
        x0 = _ew_load(X0, offs, mask, i0, i1, i2, i3, A0, A1, A2, A3, M0, U0)
        if N_IN == 1:
            if N_OUT == 1:
                y0 = BODY(x0)
            else:
                y0, y1 = BODY(x0)
        else:
            x1 = _ew_load(X1, offs, mask, i0, i1, i2, i3, B0, B1, B2, B3, M1, U1)
            if N_IN == 2:
                if N_OUT == 1:
                    y0 = BODY(x0, x1)
                else:
                    y0, y1 = BODY(x0, x1)
            else:
                x2 = _ew_load(X2, offs, mask, i0, i1, i2, i3, C0, C1, C2, C3,
                          M2, U2)
                if N_IN == 3:
                    if N_OUT == 1:
                        y0 = BODY(x0, x1, x2)
                    else:
                        y0, y1 = BODY(x0, x1, x2)
                else:
                    x3 = _ew_load(X3, offs, mask, i0, i1, i2, i3, E0, E1, E2, E3,
                              M3, U3)
                    if N_OUT == 1:
                        y0 = BODY(x0, x1, x2, x3)
                    else:
                        y0, y1 = BODY(x0, x1, x2, x3)
        y0 = tl.broadcast_to(y0, [BLOCK])
        tl.store(Y0 + offs, y0.to(Y0.dtype.element_ty), mask=mask)
        if N_OUT == 2:
            y1 = tl.broadcast_to(y1, [BLOCK])
            tl.store(Y1 + offs, y1.to(Y1.dtype.element_ty), mask=mask)

    scope = dict(locals())
    _bodies = {name: scope[name] for name in _TORCH}
    _kernel = ew_kernel
    return _bodies, _kernel


# ---------------------------------------------------------------------------
# shapes and dtypes
# ---------------------------------------------------------------------------
def _canonicalize(shapes):
    """Rank-align shapes and merge adjacent dims with equal broadcast
    signature; returns ``(out_shape, aligned_shapes)``, all one rank."""
    rank = max([len(s) for s in shapes] + [1])
    aligned = [(1,) * (rank - len(s)) + tuple(s) for s in shapes]
    out = tuple(max(dims) for dims in zip(*aligned))
    sig = [tuple(a[d] != out[d] for a in aligned) for d in range(rank)]
    groups, cur = [], [0]
    for d in range(1, rank):
        if sig[d] == sig[d - 1]:
            cur.append(d)
        else:
            groups.append(cur)
            cur = [d]
    groups.append(cur)
    out = tuple(prod(out[d] for d in grp) for grp in groups)
    aligned = [tuple(prod(a[d] for d in grp) for grp in groups)
               for a in aligned]
    return out, aligned


@functools.lru_cache(maxsize=None)
def _out_dtypes(body, dtypes):
    """Output dtypes of ``body`` over operands of ``dtypes``: the torch
    body's own promotion, evaluated once on one-element tensors (not 0-d:
    torch lets 0-d operands not promote, jnp does)."""
    res = _TORCH[body](*(torch.ones(1, dtype=d) for d in dtypes))
    res = res if isinstance(res, tuple) else (res,)
    return tuple(r.dtype for r in res)


def _widen(x):
    return x.float() if x.dtype == torch.bfloat16 else x


def ew_reference(body, *xs, n_out: int = 1):
    """Plain PyTorch ``body`` over ``xs``: floating operands widened to
    float32, outputs broadcast to the common shape and rounded once."""
    dts = _out_dtypes(body, tuple(x.dtype for x in xs))
    if len(dts) != n_out:
        raise ValueError(f"ew {body}: {len(dts)} outputs, n_out={n_out}")
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    res = _TORCH[body](*(_widen(x) for x in xs))
    res = res if isinstance(res, tuple) else (res,)
    outs = tuple(r.to(dt).expand(shape).contiguous()
                 for r, dt in zip(res, dts))
    return outs if n_out > 1 else outs[0]


def ew(body, *xs, n_out: int = 1):
    """Apply the named elementwise ``body`` over broadcastable tensors: the
    Triton kernel on CUDA tensors, :func:`ew_reference` on CPU tensors.
    Returns one tensor, or a tuple of ``n_out``."""
    if body not in _TORCH:
        raise ValueError(f"ew: unknown body {body!r}")
    if not xs[0].is_cuda:
        return ew_reference(body, *xs, n_out=n_out)
    dev = xs[0].device
    if not 1 <= len(xs) <= _MAX_IN or not 1 <= n_out <= _MAX_OUT:
        raise ValueError(f"ew {body}: {len(xs)} inputs, {n_out} outputs")
    for x in xs:
        if x.device != dev or x.dtype not in _DTYPES:
            raise ValueError(f"ew {body}: operands must be float32, bfloat16 "
                             f"or int32 on {dev}, got {x.dtype} on {x.device}")
    dts = _out_dtypes(body, tuple(x.dtype for x in xs))
    if len(dts) != n_out:
        raise ValueError(f"ew {body}: {len(dts)} outputs, n_out={n_out}")
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    outs = [torch.empty(shape, device=dev, dtype=dt) for dt in dts]
    n = prod(shape)
    if n:
        _launch(body, [x.contiguous() for x in xs], outs, shape, n)
    return tuple(outs) if n_out > 1 else outs[0]


def _plan(in_shapes, shape):
    """The kernel's addressing of each operand: ``(dims, modes, strides)``
    with ``dims`` the canonical output shape padded to 4-D, and per operand
    a mode (0: the output's shape, read at the flat index; 1: one element;
    2: strided, stride 0 on broadcast dims) and its 4 strides."""
    canon, aligned = _canonicalize(list(in_shapes) + [shape])
    if len(canon) > _MAX_RANK:
        raise ValueError(f"ew: broadcast of {[tuple(s) for s in in_shapes]} "
                         f"needs {len(canon)} dims after merging, the kernel "
                         f"takes {_MAX_RANK}")
    pad = _MAX_RANK - len(canon)
    dims = (1,) * pad + canon
    modes, strides = [], []
    for a in aligned[:len(in_shapes)]:
        a = (1,) * pad + a
        if a == dims:
            modes.append(0)
        elif prod(a) == 1:
            modes.append(1)
        else:
            modes.append(2)
        st, acc = [], 1
        for size in reversed(a):
            st.append(0 if size == 1 else acc)
            acc *= size
        strides.append(st[::-1])
    return dims, modes, strides


def _launch(body, xs, outs, shape, n):
    dims, modes, strides = _plan([x.shape for x in xs], shape)
    n_in = len(xs)
    # unused operand slots: any valid pointer, never loaded
    ptrs = xs + [xs[0]] * (_MAX_IN - n_in)
    strides += [[0] * _MAX_RANK] * (_MAX_IN - n_in)
    modes += [0] * (_MAX_IN - n_in)
    ups = [x.dtype == torch.bfloat16 for x in ptrs]
    bodies, kernel = _triton_bodies()
    grid = (triton.cdiv(n, _BLOCK),)
    with torch.cuda.device(xs[0].device):
        kernel[grid](*ptrs, outs[0], outs[-1], n, *dims[1:],
                     *(s for st in strides for s in st),
                     BODY=bodies[body], N_IN=n_in, N_OUT=len(outs),
                     M0=modes[0], M1=modes[1], M2=modes[2], M3=modes[3],
                     U0=ups[0], U1=ups[1], U2=ups[2], U3=ups[3],
                     NEED_IDX=2 in modes, BIG=n >= 2 ** 31 - _BLOCK,
                     BLOCK=_BLOCK, num_warps=4)
    runtime.count_launch("elementwise")
