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

Operands are tensors or :class:`Scalar` values: a Python number rounded on the
host to its dtype (:func:`scalar`, as the op set's ``_scalar`` makes it),
passed to the kernel by value, and to the plain twin as a 0-d tensor.

The kernel on this card: a fused pass over memory, bound by bytes moved
(a few flops per element).  Its design (``_plan``, a pure function of
shapes, strides and dtypes, cached per call signature):

* dims merge wherever every operand's strides allow, views included (the
  TPU kernel merged by broadcast signature); at most 4 remain.  A view
  that keeps more apart is copied, that operand alone, compacted, and the
  copy is counted (``elementwise_copy``); none of the main paths' classes
  needs one;
* the merged shape is walked as rows x inner in 2-D tiles, one a program
  (the TPU kernel's blocks were 2-D too), and each operand has a mode: the
  output's flat offset, one element, one value a row (a per-channel
  operand), one inner slice for every row (a bias), inner-contiguous with
  row offsets (a mask, a rotary slice), contiguous along the rows (a
  transposed view, loaded along its rows and transposed through shared
  memory by Triton), strided, or a scalar.  A tile's multi-index over the
  outer dims is worked out once a tile (once a row where the tile crosses
  them), never per element; rows of at least a tile whose length is not a
  multiple of 8 are walked by the flat index instead, each element's row
  found by one compare;
* full tiles load and store with no mask, so accesses are 16 bytes a
  thread in f32 and bf16; where every row offset is a multiple of 8
  elements the kernel is told so (``ALIGNED``) and masked tiles vectorise
  too;
* operands a body never reads (``b2_add``'s and ``b2_sub``'s a and b)
  shape the output and nothing else: the walk is planned without them;
* ``n_out = 2`` writes both gradients of a binary op in one pass.

The body reaches the kernel as a ``tl.constexpr`` argument, so Triton
compiles one specialisation per (body, dtypes, modes, tile), at its first
launch; ``triton`` is imported only then.  Later launches of a compiled
specialisation call its launcher directly with the cached arguments, so a
call's host work is a cache lookup, the output's allocation and the
launch.
"""

import functools
from math import copysign, prod
from typing import NamedTuple

import torch

from . import runtime

__all__ = ["ew", "ew_reference", "scalar", "Scalar", "BODIES"]

_MAX_RANK = 4
_MAX_IN, _MAX_OUT = 4, 2
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
# the operands a body reads, where it does not read all: the kernel never
# loads the others, so they take no part in the walk's plan
_READS = {"b2_add": (0,), "b2_sub": (0,)}

# the Triton release whose launcher convention :func:`_launch` mirrors
_TRITON = "3.6."

_bodies = None
_kernel = None
_hooks = None


def _triton_bodies():
    """The Triton twin of every torch body, built at the first launch."""
    # module globals: Triton resolves the names a kernel calls (tl, ld and
    # the helpers) in its module's namespace
    global _bodies, _kernel, _hooks, triton, tl, ld, _gelu_u, _ew_ld, \
        _ew_tile
    if _bodies is not None:
        return _bodies, _kernel
    import triton
    if not triton.__version__.startswith(_TRITON):
        raise RuntimeError(
            f"ew: the launch calls a compiled kernel's launcher as Triton "
            f"{_TRITON}x does; Triton {triton.__version__} is installed")
    import triton.language as tl
    from triton import knobs
    from triton.language.extra import libdevice as ld
    _hooks = knobs.runtime      # the launch hooks JITFunction.run passes

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
    def _ew_ld(X, out_off, i, i0, i1, i2, S0, S1, S2, S3, mask, mask_r,
               mask_i, MODE: tl.constexpr, NOUTER: tl.constexpr,
               WRAP: tl.constexpr, ALIGNED: tl.constexpr,
               MASKED: tl.constexpr):
        """Operand X's values over the tile, f32 for bf16."""
        if MODE == 6:        # a Python scalar, passed by value
            v = X
        elif MODE == 1:      # one element
            v = tl.load(X)
        else:
            if MODE == 0:    # the output's layout: the output's offsets
                p = X + out_off
                m = mask
            elif MODE == 3:  # broadcast along the rows: one inner slice
                p = X + i[None, :]
                m = mask_i
            else:            # a row offset, once a row of the tile
                if MODE == 7:    # contiguous along the rows (transposed)
                    ro = i2
                else:
                    ro = i2 * S2
                if NOUTER >= 2:
                    ob = i1 * S1
                    if NOUTER == 3:
                        ob += i0 * S0
                    if ALIGNED:
                        ob = tl.multiple_of(ob, 8)
                    ro += ob
                if MODE == 2:    # broadcast along inner: one value a row
                    if WRAP:     # the tile's one row: each element's row
                        p = X + ro[None, :]
                    else:
                        p = X + ro[:, None]
                    m = mask_r
                else:
                    if MODE == 4:
                        if ALIGNED:
                            ro = tl.multiple_of(ro, 8)
                        p = X + (ro[:, None] + i[None, :])
                    else:        # a view strided along inner
                        col = i * S3
                        if ALIGNED:
                            col = tl.multiple_of(col, 8)
                        p = X + (ro[:, None] + col[None, :])
                    m = mask
            if MASKED:
                v = tl.load(p, mask=m)
            else:
                v = tl.load(p)
        if v.dtype == tl.bfloat16:
            v = v.to(tl.float32)
        return v

    @jit
    def _ew_tile(X0, X1, X2, X3, Y0, Y1, out_off, i, i0, i1, i2,
                 A0, A1, A2, A3, B0, B1, B2, B3, C0, C1, C2, C3,
                 E0, E1, E2, E3, mask, mask_r, mask_i,
                 BODY: tl.constexpr, N_IN: tl.constexpr, N_OUT: tl.constexpr,
                 M0: tl.constexpr, M1: tl.constexpr, M2: tl.constexpr,
                 M3: tl.constexpr, NOUTER: tl.constexpr, WRAP: tl.constexpr,
                 ALIGNED: tl.constexpr, MASKED: tl.constexpr,
                 RB: tl.constexpr, IB: tl.constexpr):
        x0 = _ew_ld(X0, out_off, i, i0, i1, i2, A0, A1, A2, A3, mask, mask_r,
                    mask_i, M0, NOUTER, WRAP, ALIGNED, MASKED)
        if N_IN == 1:
            if N_OUT == 1:
                y0 = BODY(x0)
            else:
                y0, y1 = BODY(x0)
        else:
            x1 = _ew_ld(X1, out_off, i, i0, i1, i2, B0, B1, B2, B3, mask,
                        mask_r, mask_i, M1, NOUTER, WRAP, ALIGNED,
                        MASKED)
            if N_IN == 2:
                if N_OUT == 1:
                    y0 = BODY(x0, x1)
                else:
                    y0, y1 = BODY(x0, x1)
            else:
                x2 = _ew_ld(X2, out_off, i, i0, i1, i2, C0, C1, C2, C3, mask,
                            mask_r, mask_i, M2, NOUTER, WRAP, ALIGNED,
                            MASKED)
                if N_IN == 3:
                    if N_OUT == 1:
                        y0 = BODY(x0, x1, x2)
                    else:
                        y0, y1 = BODY(x0, x1, x2)
                else:
                    x3 = _ew_ld(X3, out_off, i, i0, i1, i2, E0, E1, E2, E3,
                                mask, mask_r, mask_i, M3, NOUTER, WRAP,
                                ALIGNED, MASKED)
                    if N_OUT == 1:
                        y0 = BODY(x0, x1, x2, x3)
                    else:
                        y0, y1 = BODY(x0, x1, x2, x3)
        y0 = tl.broadcast_to(y0, [RB, IB])
        if MASKED:
            tl.store(Y0 + out_off, y0.to(Y0.dtype.element_ty), mask=mask)
        else:
            tl.store(Y0 + out_off, y0.to(Y0.dtype.element_ty))
        if N_OUT == 2:
            y1 = tl.broadcast_to(y1, [RB, IB])
            if MASKED:
                tl.store(Y1 + out_off, y1.to(Y1.dtype.element_ty), mask=mask)
            else:
                tl.store(Y1 + out_off, y1.to(Y1.dtype.element_ty))

    @jit(do_not_specialize=[
        "ROWS", "INNER", "D1", "D2", "A0", "A1", "A2", "A3", "B0", "B1",
        "B2", "B3", "C0", "C1", "C2", "C3", "E0", "E1", "E2", "E3"])
    def ew_kernel(X0, X1, X2, X3, Y0, Y1, ROWS, INNER, D1, D2,
                  A0, A1, A2, A3, B0, B1, B2, B3,
                  C0, C1, C2, C3, E0, E1, E2, E3,
                  BODY: tl.constexpr, N_IN: tl.constexpr,
                  N_OUT: tl.constexpr, M0: tl.constexpr, M1: tl.constexpr,
                  M2: tl.constexpr, M3: tl.constexpr, NOUTER: tl.constexpr,
                  RB: tl.constexpr, IB: tl.constexpr, EVEN: tl.constexpr,
                  SPLIT: tl.constexpr, WRAP: tl.constexpr,
                  ALIGNED: tl.constexpr, BIG: tl.constexpr):
        pid = tl.program_id(0)
        if BIG:              # int64 index arithmetic (ROWS * INNER too)
            pid = pid.to(tl.int64)
            ROWS = ROWS.to(tl.int64)
        if ALIGNED:          # a multiple of 8: masks along inner vectorise
            INNER = INNER // 8 * 8
        if WRAP:             # the flat index; a tile crosses one row at most
            n = ROWS * INNER
            i = pid * IB + tl.arange(0, IB)
            row0 = pid * IB // INNER
            j = i - row0 * INNER
            over = j >= INNER
            r = row0 + over.to(i.dtype)
            i2 = r
            i1 = 0
            i0 = 0
            out_off = i[None, :]
            full = (pid + 1) * IB <= n
            mask = (i < n)[None, :]
            i = tl.where(over, j - INNER, j)
        elif NOUTER == 0:    # one row: the flat index
            i = pid * IB + tl.arange(0, IB)
            r = tl.arange(0, RB)
            i2 = r
            i1 = 0
            i0 = 0
            out_off = i[None, :]
            full = (pid + 1) * IB <= INNER
        else:                # a tile of RB rows x IB of the inner dim
            nib = tl.cdiv(INNER, IB)
            pid_r = pid // nib
            pid_i = pid - pid_r * nib
            i = pid_i * IB + tl.arange(0, IB)
            rbase = pid_r * RB
            r = rbase + tl.arange(0, RB)
            ro = r * INNER
            if ALIGNED:
                ro = tl.multiple_of(ro, 8)
            out_off = ro[:, None] + i[None, :]
            full = ((pid_r + 1) * RB <= ROWS) & ((pid_i + 1) * IB <= INNER)
            # the rows' indices over the outer canonical dims
            if NOUTER == 1:
                i2 = r
                i1 = 0
                i0 = 0
            elif SPLIT:      # RB divides D2: one (i0, i1) for the tile
                q = rbase // D2
                i2 = tl.max_contiguous(tl.multiple_of(
                    rbase - q * D2 + tl.arange(0, RB), RB), RB)
                if NOUTER == 3:
                    i1 = q % D1
                    i0 = q // D1
                else:
                    i1 = q
                    i0 = 0
            else:
                i2 = r % D2
                t = r // D2
                if NOUTER == 3:
                    i1 = t % D1
                    i0 = t // D1
                else:
                    i1 = t
                    i0 = 0
        if WRAP:
            mask_i = mask
            mask_r = mask
        else:
            mask_i = (i < INNER)[None, :]
            mask_r = (r < ROWS)[:, None]
            mask = mask_r & mask_i
        # EVEN: every tile full, so no compare and one tile body.  On an
        # H100 (700 W; scripts/ab_elementwise.py, 6 graph timings a side)
        # ResNet-20's 16- to 64-element classes took 1.08-1.25 us with it
        # and 1.11-1.29 without (each 3-4% apart), BERT-base's add of a
        # permuted operand 9.87-10.08 us and 10.37-10.65
        if EVEN:
            _ew_tile(X0, X1, X2, X3, Y0, Y1, out_off, i, i0, i1, i2,
                     A0, A1, A2, A3, B0, B1, B2, B3, C0, C1, C2, C3,
                     E0, E1, E2, E3, mask, mask_r, mask_i, BODY, N_IN, N_OUT,
                     M0, M1, M2, M3, NOUTER, WRAP, ALIGNED, False, RB,
                     IB)
        elif full:
            _ew_tile(X0, X1, X2, X3, Y0, Y1, out_off, i, i0, i1, i2,
                     A0, A1, A2, A3, B0, B1, B2, B3, C0, C1, C2, C3,
                     E0, E1, E2, E3, mask, mask_r, mask_i, BODY, N_IN, N_OUT,
                     M0, M1, M2, M3, NOUTER, WRAP, ALIGNED, False, RB,
                     IB)
        else:
            _ew_tile(X0, X1, X2, X3, Y0, Y1, out_off, i, i0, i1, i2,
                     A0, A1, A2, A3, B0, B1, B2, B3, C0, C1, C2, C3,
                     E0, E1, E2, E3, mask, mask_r, mask_i, BODY, N_IN, N_OUT,
                     M0, M1, M2, M3, NOUTER, WRAP, ALIGNED, True, RB,
                     IB)

    scope = dict(locals())
    _bodies = {name: scope[name] for name in _TORCH}
    _kernel = ew_kernel
    return _bodies, _kernel


# ---------------------------------------------------------------------------
# scalars, shapes and dtypes
# ---------------------------------------------------------------------------
class Scalar(NamedTuple):
    """A Python number as an operand of ``ew``, passed to the kernel by
    value: ``value`` is already rounded to ``dtype`` (an f32 argument for a
    floating dtype, an int32 one for int32).  Make it with :func:`scalar`."""
    value: object
    dtype: torch.dtype


@functools.lru_cache(maxsize=4096)
def _rounded(value, dtype, kind, sign):
    # kind and sign are only part of the key: -0.0 == 0.0 == False, and
    # they hash alike
    return torch.tensor(value, dtype=dtype).item()


def scalar(value, dtype) -> Scalar:
    """``value`` rounded to ``dtype`` as ``torch.tensor(value, dtype=dtype)``
    rounds it, on the host: no device tensor, no copy to the card."""
    if dtype not in _DTYPES:
        raise ValueError(f"ew: a scalar must be float32, bfloat16 or int32, "
                         f"got {dtype}")
    return Scalar(_rounded(value, dtype, type(value),
                           copysign(1.0, value)), dtype)


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


def _tensors(xs):
    """``xs`` with every :class:`Scalar` as a 0-d tensor of its dtype on
    the first tensor operand's device."""
    dev = next(x for x in xs if isinstance(x, torch.Tensor)).device
    return [x if isinstance(x, torch.Tensor)
            else torch.tensor(x.value, dtype=x.dtype, device=dev) for x in xs]


def ew_reference(body, *xs, n_out: int = 1):
    """Plain PyTorch ``body`` over ``xs`` (tensors and :class:`Scalar`
    values): floating operands widened to float32, outputs broadcast to
    the common shape and rounded once."""
    xs = _tensors(xs)
    dts = _out_dtypes(body, tuple(x.dtype for x in xs))
    if len(dts) != n_out:
        raise ValueError(f"ew {body}: {len(dts)} outputs, n_out={n_out}")
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    res = _TORCH[body](*(_widen(x) for x in xs))
    res = res if isinstance(res, tuple) else (res,)
    outs = tuple(r.to(dt).expand(shape).contiguous()
                 for r, dt in zip(res, dts))
    return outs if n_out > 1 else outs[0]


# ---------------------------------------------------------------------------
# the launch plan: a pure function of shapes, strides and dtypes
# ---------------------------------------------------------------------------
class Plan(NamedTuple):
    """How the kernel walks one call.  The output (contiguous, ``shape``)
    is ``dims`` = (D0, D1, D2, D3) after merging: rows = D0 D1 D2 of
    ``inner`` = D3, in tiles of ``rb`` rows x ``ib`` of ``inner``, one
    tile a program.  Per operand: its mode (``FLAT`` ... ``SCALAR``), its
    4 strides in elements over ``dims``, and ``copies``: None, or the
    size of the compact view that is copied before the launch (a view
    whose strides do not merge into 4 dims)."""
    shape: tuple
    dims: tuple
    modes: tuple
    strides: tuple
    copies: tuple
    rb: int
    ib: int
    grid: int
    nouter: int
    even: bool
    split: bool
    wrap: bool
    aligned: bool
    big: bool


# operand modes: the output's own layout (the flat offset), one element,
# one value a row (broadcast along inner), one inner slice for every row
# (broadcast along the rows), inner-contiguous with row strides, strided
# along inner, a Python scalar by value, strided along inner and contiguous
# along the rows (a transposed view: loaded along the rows)
FLAT, ONE, ROW, COL, INNER, STRIDED, SCALAR, TRANS = range(8)
_TILE_BYTES = 8192          # a program's tile, in bytes of the output
_MIN_TILE = 512             # elements: the smallest tile of a small call
_MIN_PROGRAMS = 16 * 132    # tiles shrink until a call has this many
_WARPS = 4                  # warps a program
_BIG_LIMIT = 2 ** 31 - 1    # offsets past this take int64 arithmetic


def _pow2(n):
    return 1 << max(0, (n - 1).bit_length())


def _merge(sizes, strides):
    """Merge adjacent dims (inner to outer) wherever every operand's
    stride allows: dim d folds into d + 1 when its stride is stride[d + 1]
    * size[d + 1] for each operand (broadcast: 0 and 0).  Returns (sizes,
    strides) of the merged dims, outermost first."""
    out_sizes = [sizes[-1]]
    out_st = [[st[-1]] if st is not None else None for st in strides]
    for d in range(len(sizes) - 2, -1, -1):
        if all(st is None or st[d] == o[0] * out_sizes[0]
               for st, o in zip(strides, out_st)):
            out_sizes[0] *= sizes[d]
        else:
            out_sizes.insert(0, sizes[d])
            for st, o in zip(strides, out_st):
                if st is not None:
                    o.insert(0, st[d])
    return out_sizes, out_st


def _tile(rows, inner, itemsize, square=False, wrap=False):
    """(rows a tile, inner elements a tile, wrap): ``_TILE_BYTES`` of
    output, halved down to ``_MIN_TILE`` elements while the call has fewer
    than ``_MIN_PROGRAMS`` tiles.  The inner block is a power of two that
    divides ``inner`` where one of at least 64 does (no mask), else the
    widest whose padding of a row is within 1/16 of the least;
    ``square``: at most 64 wide and at least 32 rows, so that a transposed
    operand is read in runs of 32 rows or more.  ``wrap`` (allowed where
    no operand needs a row offset): rows of at least a tile whose length
    is not a multiple of 8 are walked by the flat index, a tile crossing
    at most one row."""
    e = _TILE_BYTES // itemsize
    while e > _MIN_TILE and -(-rows * inner // e) < _MIN_PROGRAMS:
        e //= 2
    if rows == 1:
        return 1, min(e, max(16, _pow2(inner))), False
    if wrap and inner % 8 and inner >= e:
        return 1, e, True
    low = inner & -inner
    cap = min(e, 64 if square else e, max(16, _pow2(inner)))
    if low >= min(64, _pow2(inner)):
        ib = min(low, cap)
    else:
        ws = [1 << k for k in range(min(16, _pow2(inner)).bit_length() - 1,
                                     cap.bit_length())]
        pad = {w: -(-inner // w) * w / inner for w in ws}
        ib = max(w for w in ws if pad[w] <= min(pad.values()) + 1 / 16)
    rb = max(e // ib, 32) if square else e // ib
    return max(1, min(rb, _pow2(rows))), ib, False


def _plan(ops, itemsize=4, reads=None):
    """The :class:`Plan` of operands ``ops``: per operand ``(shape,
    strides)``, or None for a :class:`Scalar`; ``itemsize``: the first
    output's; ``reads``: the indices of the operands the body reads (None:
    all), the others shaping the output alone, planned as scalars (never
    loaded).  Raises ValueError where the broadcast needs more than 4 dims
    even with every view copied."""
    shapes = [tuple(op[0]) for op in ops if op is not None]
    out = tuple(torch.broadcast_shapes(*shapes))
    if reads is not None:
        ops = [op if j in reads else None for j, op in enumerate(ops)]
    rank = len(out)
    keep = [d for d in range(rank) if out[d] != 1] or [rank]
    sizes = [out[d] if d < rank else 1 for d in keep]

    def aligned(shape, st):
        pad = rank - len(shape)
        return [0 if d == rank or d < pad or shape[d - pad] == 1
                else st[d - pad] for d in keep]

    strides = [None if op is None else aligned(*op) for op in ops]
    merged, mst = _merge(sizes, strides)
    copies = [None] * len(ops)
    if len(merged) > _MAX_RANK:
        # copy each view that keeps dims from merging, compacted (its
        # broadcast dims taken once), and merge again
        for j, (op, st) in enumerate(zip(ops, strides)):
            if st is None:
                continue
            shape, own = op
            size = tuple(1 if n == 1 or s == 0 else n
                         for n, s in zip(shape, own))
            if own != tuple(_contiguous(size, shape, own)):
                copies[j] = size
                acc, cst = 1, []
                for n, s in reversed(list(zip(sizes, st))):
                    cst.append(0 if s == 0 else acc)
                    acc *= n if s else 1
                strides[j] = cst[::-1]
        merged, mst = _merge(sizes, strides)
        if len(merged) > _MAX_RANK:
            raise ValueError(f"ew: broadcast of {shapes} needs "
                             f"{len(merged)} dims after merging, the kernel "
                             f"takes {_MAX_RANK}")
    pad = _MAX_RANK - len(merged)
    dims = (1,) * pad + tuple(merged)
    flat = [prod(dims[k + 1:]) for k in range(_MAX_RANK)]
    modes, sts = [], []
    for st in mst:
        if st is None:
            modes.append(SCALAR)
            sts.append((0,) * _MAX_RANK)
            continue
        st = (0,) * pad + tuple(st)
        outer = [s for s, n in zip(st[:3], dims[:3]) if n > 1]
        if not any(st):
            modes.append(ONE)
        elif all(s == f for s, f, n in zip(st, flat, dims) if n > 1):
            modes.append(FLAT)
        elif st[3] == 0:
            modes.append(ROW)
        elif st[3] == 1:
            modes.append(COL if not any(outer) else INNER)
        elif st[2] == 1 and dims[2] > 1:
            modes.append(TRANS)
        else:
            modes.append(STRIDED)
        sts.append(st)
    rows, inner = prod(dims[:3]), dims[3]
    nouter = len(merged) - 1
    rb, ib, wrap = _tile(rows, inner, itemsize, TRANS in modes,
                         nouter == 1 and set(modes) <= {FLAT, ONE, ROW, COL,
                                                        SCALAR})
    grid = -(-rows * inner // ib) if wrap else -(-rows // rb) * -(-inner // ib)
    aligned_ = rows > 1 and inner % 8 == 0 and all(
        all(s % 8 == 0 for s in (st[:3] if m == INNER else
                                 (st[0], st[1], st[3])))
        for m, st in zip(modes, sts) if m in (INNER, TRANS))
    reach = max([prod(out), *(sum(n * abs(s) for n, s in zip(dims, st))
                              for st in sts)])
    big = reach + (rb + ib) * max(1, *(abs(s) for st in sts for s in st)) \
        >= _BIG_LIMIT
    even = rows * inner % ib == 0 if wrap else \
        rows % rb == 0 and inner % ib == 0
    return Plan(out, dims, tuple(modes), tuple(sts), tuple(copies), rb, ib,
                grid if prod(out) else 0, nouter, even,
                nouter <= 1 or dims[2] % rb == 0, wrap, aligned_, big)


def _contiguous(size, shape, own):
    """The strides ``own`` would be for a compact tensor: contiguous over
    ``size``'s dims of more than one element (others: as given)."""
    acc, st = 1, []
    for n, full, s in reversed(list(zip(size, shape, own))):
        st.append(acc if n > 1 else s)
        acc *= n
    return st[::-1]


class Call(NamedTuple):
    """A cached call: its :class:`Plan`, output dtypes, the kernel's
    integer arguments (rows, inner, D1, D2 and 4 x 4 strides) and its
    constexpr arguments after ``BODY`` (in the kernel's order), and the
    compiled kernels it has launched, by the 16-byte alignment of its
    tensor operands."""
    plan: Plan
    dtypes: tuple
    ints: tuple
    meta: tuple
    compiled: dict


_META = ("N_IN", "N_OUT", "M0", "M1", "M2", "M3", "NOUTER", "RB", "IB",
         "EVEN", "SPLIT", "WRAP", "ALIGNED", "BIG")


@functools.lru_cache(maxsize=4096)
def _cached_plan(body, n_out, key):
    """The :class:`Call` of ``body`` over operands described by ``key``:
    per operand (shape, strides, dtype, device index), or (None, None,
    dtype, None) for a scalar.  Validates what the kernel takes."""
    if not 1 <= len(key) <= _MAX_IN or not 1 <= n_out <= _MAX_OUT:
        raise ValueError(f"ew {body}: {len(key)} inputs, {n_out} outputs")
    devs = {k[3] for k in key if k[0] is not None}
    for shape, _, dt, dev in key:
        if dt not in _DTYPES or (shape is not None and dev < 0) \
                or len(devs) != 1:
            raise ValueError(f"ew {body}: operands must be float32, bfloat16 "
                             f"or int32 on one CUDA device, got {dt} on "
                             f"device {dev}")
    dts = _out_dtypes(body, tuple(k[2] for k in key))
    if len(dts) != n_out:
        raise ValueError(f"ew {body}: {len(dts)} outputs, n_out={n_out}")
    plan = _plan(tuple(None if k[0] is None else (k[0], k[1]) for k in key),
                 torch.tensor([], dtype=dts[0]).element_size(),
                 _READS.get(body))
    n_in, d = len(key), plan.dims
    ints = (d[0] * d[1] * d[2], d[3], d[1], d[2],
            *(s for st in plan.strides for s in st),
            *(0,) * (_MAX_RANK * (_MAX_IN - n_in)))
    m = plan.modes + (FLAT,) * (_MAX_IN - n_in)
    meta = (n_in, n_out, *m, plan.nouter, plan.rb, plan.ib, plan.even,
            plan.split, plan.wrap, plan.aligned, plan.big)
    return Call(plan, dts, ints, meta, {})


def ew(body, *xs, n_out: int = 1):
    """Apply the named elementwise ``body`` over broadcastable tensors and
    :class:`Scalar` operands: the Triton kernel on CUDA tensors,
    :func:`ew_reference` on CPU tensors.  Returns one tensor, or a tuple of
    ``n_out``."""
    if body not in _TORCH:
        raise ValueError(f"ew: unknown body {body!r}")
    x0 = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if x0 is None:
        raise ValueError(f"ew {body}: no tensor operand")
    if not x0.is_cuda:
        return ew_reference(body, *xs, n_out=n_out)
    key = tuple((x.shape, x.stride(), x.dtype, x.get_device())
                if isinstance(x, torch.Tensor) else (None, None, x.dtype, None)
                for x in xs)
    call = _cached_plan(body, n_out, key)
    plan, dev = call.plan, x0.device
    outs = [torch.empty(plan.shape, device=dev, dtype=dt)
            for dt in call.dtypes]
    if plan.grid:
        args, align = _operands(xs, plan.copies)
        if dev.index == torch.cuda.current_device():
            _launch(body, call, args, outs, align, dev.index)
        else:
            with torch.cuda.device(dev):
                _launch(body, call, args, outs, align, dev.index)
    return tuple(outs) if n_out > 1 else outs[0]


def _operands(xs, copies):
    """The kernel's operands of one call (a view in ``copies`` copied, a
    :class:`Scalar` as its value) and what Triton specialises them on: a
    tensor's 16-byte alignment, an int's being 1 or a multiple of 16."""
    args, align = [], 0
    for x, size in zip(xs, copies):
        if not isinstance(x, torch.Tensor):
            x = x.value
            if isinstance(x, int):
                align = 4 * align + 2 * (x == 1) + (x % 16 == 0)
        else:
            if size is not None:
                x = x.as_strided(size, x.stride(), x.storage_offset()) \
                    .contiguous()
                runtime.count_launch("elementwise_copy")
            align = 2 * align + (x.data_ptr() % 16 == 0)
        args.append(x)
    return args, align


def _arguments(body, call, args, outs):
    """Every parameter of ``ew_kernel`` in order, constexprs included."""
    bodies, _ = _triton_bodies()
    return (*args, *(None,) * (_MAX_IN - len(args)), outs[0],
            outs[1] if len(outs) > 1 else None, *call.ints, bodies[body],
            *call.meta)


def _jit_launch(full, grid):
    """A launch through Triton's ``JITFunction``, which compiles the
    arguments' specialisation at its first sight; the compiled kernel."""
    _, kernel = _triton_bodies()
    n = len(_META) + 1
    return kernel[(grid,)](*full[:-n], BODY=full[-n],
                           **dict(zip(_META, full[-n + 1:])),
                           num_warps=_WARPS)


def _launch(body, call, args, outs, align, index):
    """One launch of the kernel.  The first of a call's specialisations
    (``align``, from :func:`_operands`) goes through :func:`_jit_launch`;
    later ones call the compiled kernel's launcher directly with the same
    arguments, as Triton 3.6's ``JITFunction.run`` ends, skipping its
    per-call binding and specialisation of every argument."""
    full = _arguments(body, call, args, outs)
    k = call.compiled.get(align)
    if k is None:
        call.compiled[align] = _jit_launch(full, call.plan.grid)
    else:
        grid = (call.plan.grid, 1, 1)
        stream = torch._C._cuda_getCurrentRawStream(index)
        k.run(*grid, stream, k.function, k.packed_metadata,
              k.launch_metadata(grid, stream, *full),
              _hooks.launch_enter_hook, _hooks.launch_exit_hook, *full)
    runtime.count_launch("elementwise")
