"""Batched matrix product: the CUDA kernel and its plain twins.

Counterpart of ``lightgrad_tpu/ops/matmul.py`` (TPU kernel
``_pallas_matmul3`` and its VJP).  :func:`matmul` is ``a @ b`` with numpy
batch broadcasting over >= 2-D operands; :func:`matmul_vjp` is its
gradient, ``(g @ b^T, a^T @ g)`` summed back to each operand's shape.  On
CUDA tensors they launch the tensor-core kernel of ``csrc/matmul.cu``; on
CPU tensors they run the plain versions.

float32 products follow :func:`set_precision`, as the JAX package's do:
``'highest'`` (the default) computes what the TPU's HIGHEST passes compute,
each operand split into tf32 high and low parts and three tf32 products
summed in f32 (:func:`matmul_tf32x3_reference` is that arithmetic in plain
PyTorch; on the CPU the wrapper runs the plain f32 product,
:func:`matmul_reference`); ``'default'`` rounds f32 operands to bf16 and
takes one bf16 pass with an f32 result (:func:`matmul_default_reference`).
bfloat16 products sum in float32 and round once.  Operands are passed by
strides: a transposed view (``W.T`` of nn.Linear, ``k.transpose(-1, -2)``,
``a^T`` of the backward) and a broadcast batch cost no copy.  A 2-D right
operand under a batched left one is one product with the batch folded into
M, and its gradient is one product with the batch folded into K -- never a
batch of weight-sized partial gradients summed afterwards.
"""

import torch

from . import _build, runtime
from .reduce import reduce

__all__ = ["matmul", "matmul_vjp", "matmul_reference",
           "matmul_tf32x3_reference", "matmul_default_reference",
           "set_precision", "tf32_round", "LOADERS", "loader_counts"]

_MAX_BATCH = 65535
_DTYPES = (torch.float32, torch.bfloat16)
# csrc/matmul.cu's kinds of product
_F32X3, _BF16, _F32BF16 = 0, 1, 2
# csrc/matmul.cu's operand loaders, by the kernel's numbering: 16-byte
# cp.async copies along k or along m / n (bf16), 16-byte copies or loads
# along either (f32), element loads (any strides), and 4-byte cp.async
# copies along k or along m / n (f32 at full precision, rows with a unit
# stride that are not 16-byte aligned)
LOADERS = ("async-k", "async-mn", "vec-k", "vec-mn", "scalar", "elem-k",
           "elem-mn")
# operands loaded by each loader (a caller zeroes the counts to count one
# run): the main paths should need no scalar loads
loader_counts = dict.fromkeys(LOADERS, 0)

# float32 precision: 'highest' (three tf32 passes, f32 accuracy) or
# 'default' (one bf16 pass); bfloat16 operands always take one bf16 pass
_PRECISION = "highest"


def set_precision(p: str) -> str:
    """Set the float32 product precision ('highest' or 'default'); returns
    the previous one."""
    global _PRECISION
    if p not in ("highest", "default"):
        raise ValueError(f"matmul precision must be 'highest' or 'default', "
                         f"got {p!r}")
    prev, _PRECISION = _PRECISION, p
    return prev


def _check(a, b):
    if a.dim() < 2 or b.dim() < 2:
        raise ValueError(f"matmul needs >= 2-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"matmul: {tuple(a.shape)} @ {tuple(b.shape)}")


def matmul_reference(a, b):
    """Plain PyTorch ``a @ b``: float32 sums, result in the promoted dtype."""
    _check(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.float(), b.float()).to(dt)


def tf32_round(x):
    """float32 ``x`` rounded to tf32's 10 mantissa bits, to nearest, ties to
    even, on the f32 bits (as the kernel's loader does); infinities and NaNs
    pass unchanged."""
    u = x.float().contiguous().view(torch.int32)
    r = (u + 0xFFF + ((u >> 13) & 1)) & -0x2000
    finite = (u & 0x7F800000) != 0x7F800000
    return torch.where(finite, r, u).view(torch.float32)


def matmul_tf32x3_reference(a, b):
    """The f32 kernel's arithmetic in plain PyTorch: each operand split into
    hi = tf32(x) and lo = tf32(x - hi), the three products hi hi + hi lo +
    lo hi summed in float64, rounded to float32."""
    _check(a, b)
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a.float() - ah), tf32_round(b.float() - bh)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    return (torch.matmul(ah, bh) + torch.matmul(ah, bl)
            + torch.matmul(al, bh)).float()


def matmul_default_reference(a, b):
    """The 'default' precision's arithmetic in plain PyTorch: float32
    operands rounded to bf16, summed in float32, a float32 result."""
    _check(a, b)
    return torch.matmul(a.bfloat16().float(), b.bfloat16().float())


def _merge_batch(sizes, sa, sb):
    """Batch dims as (size, stride of a, stride of b), outer first, with
    size-1 dims dropped and neighbours that both operands walk with one
    stride merged."""
    out = []
    for n, x, y in zip(sizes, sa, sb):
        if n == 1:
            continue
        if out and out[-1][1] == x * n and out[-1][2] == y * n:
            out[-1] = (out[-1][0] * n, x, y)
        else:
            out.append((n, x, y))
    return out


def _loader(t, sb1, sb2, smn, sk, n, k, kind):
    """The kernel's loader for one operand: 16-byte copies (bf16) or loads
    (f32) along k or along m / n where every row of the batch starts 16
    bytes aligned and the edge chunks are whole; in the three-pass f32
    kind, 4-byte copies along a unit stride otherwise; element loads where
    nothing else fits."""
    bf16 = kind == _BF16
    w = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and sb1 % w == 0 and sb2 % w == 0:
        if sk == 1 and smn % w == 0 and k % w == 0:
            return 0 if bf16 else 2
        if smn == 1 and sk % w == 0 and n % w == 0:
            return 1 if bf16 else 3
    if kind == _F32X3 and sk == 1:
        return 5
    if kind == _F32X3 and smn == 1:
        return 6
    return 4


def _launch(a, b, out):
    """out (batch..., M, N) contiguous = a @ b, both expanded to the batch."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    dims = _merge_batch(out.shape[:-2], a.stride()[:-2], b.stride()[:-2])
    if len(dims) > 2:
        # three unmergeable batch strides: the kernel walks two
        for t in (a, b):
            if not t.is_contiguous():
                runtime.count_launch("matmul_pack")
        a, b = a.contiguous(), b.contiguous()
        dims = _merge_batch(out.shape[:-2], a.stride()[:-2], b.stride()[:-2])
    dims = [(1, 0, 0)] * (2 - len(dims)) + dims
    (n1, sa1, sb1), (n2, sa2, sb2) = dims
    if n1 * n2 > _MAX_BATCH:
        raise ValueError(f"matmul: batch {n1 * n2} > {_MAX_BATCH}")
    bf16 = out.dtype == torch.bfloat16
    kind = _BF16 if bf16 else _F32X3 if _PRECISION == "highest" \
        else _F32BF16
    la = _loader(a, sa1, sa2, a.stride(-2), a.stride(-1), m, k, kind)
    lb = _loader(b, sb1, sb2, b.stride(-1), b.stride(-2), n, k, kind)
    with torch.cuda.device(a.device):
        err = _build.library().lg_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, n1 * n2, n2,
            sa1, sa2, a.stride(-2), a.stride(-1), sb1, sb2, b.stride(-2),
            b.stride(-1), kind, la, lb,
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, f"lg_matmul ({m} x {k} @ {k} x {n}, batch {n1 * n2}, "
                      f"kind {kind}, loaders {LOADERS[la]}, {LOADERS[lb]})")
    runtime.count_launch("matmul")
    loader_counts[LOADERS[la]] += 1
    loader_counts[LOADERS[lb]] += 1


def matmul(a, b):
    """``a @ b`` (numpy broadcasting over the batch dims): the CUDA kernel on
    CUDA tensors, the plain version of the current precision on CPU
    tensors."""
    _check(a, b)
    if not a.is_cuda:
        if _PRECISION == "default" and torch.float32 == torch.promote_types(
                a.dtype, b.dtype):
            return matmul_default_reference(a, b)
        return matmul_reference(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    if b.device != a.device or dt not in _DTYPES:
        raise TypeError(f"matmul: operands must be float32/bfloat16 on one "
                        f"device, got {a.dtype} on {a.device} and {b.dtype} "
                        f"on {b.device}")
    a, b = a.to(dt), b.to(dt)
    k, n = b.shape[-2:]
    if b.dim() == 2 and a.dim() > 2:
        # fold the batch into M: one product against the shared matrix
        out = torch.empty((a.numel() // k, n), device=a.device, dtype=dt)
        _launch(a.reshape(-1, k), b, out)
        return out.reshape(*a.shape[:-1], n)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    out = torch.empty((*batch, a.shape[-2], n), device=a.device, dtype=dt)
    _launch(a.expand(*batch, *a.shape[-2:]), b.expand(*batch, k, n), out)
    return out


def _reduce_to(x, shape):
    """Sum ``x`` down to ``shape`` (undo batch broadcasting)."""
    extra = x.dim() - len(shape)
    if extra:
        x = reduce(x, "sum", axis=tuple(range(extra)))
    axes = tuple(i for i, s in enumerate(shape)
                 if s == 1 and x.shape[i] != 1)
    if axes:
        x = reduce(x, "sum", axis=axes, keepdims=True)
    return x


def matmul_vjp(g, a, b):
    """(dA, dB) of ``a @ b`` for the output cotangent ``g``, each in its
    operand's shape."""
    ga = _reduce_to(matmul(g, b.transpose(-1, -2)), a.shape)
    if b.dim() == 2 and a.dim() > 2:
        # fold the batch into the contraction: a^T (K, B*M) @ g (B*M, N)
        k, n = b.shape
        gb = matmul(a.reshape(-1, k).transpose(0, 1), g.reshape(-1, n))
    else:
        gb = _reduce_to(matmul(a.transpose(-1, -2), g), b.shape)
    return ga, gb
