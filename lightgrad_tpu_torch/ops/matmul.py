"""Batched matrix product: the CUDA kernel and its plain twin.

Counterpart of ``lightgrad_tpu/ops/matmul.py`` (TPU kernel
``_pallas_matmul3`` and its VJP).  :func:`matmul` is ``a @ b`` with numpy
batch broadcasting over >= 2-D operands; :func:`matmul_vjp` is its
gradient, ``(g @ b^T, a^T @ g)`` summed back to each operand's shape.  On
CUDA tensors they launch the kernel of ``csrc/matmul.cu``; on CPU tensors
they run :func:`matmul_reference`.

float32 products are true float32 (no TF32), bfloat16 products sum in
float32 and round once.  Operands are passed by strides: a transposed view
(``W.T`` of nn.Linear, ``k.transpose(-1, -2)``, ``a^T`` of the backward)
and a broadcast batch cost no copy.  A 2-D right operand under a batched
left one is one product with the batch folded into M, and its gradient is
one product with the batch folded into K -- never a batch of weight-sized
partial gradients summed afterwards.
"""

import torch

from . import _build, runtime
from .reduce import reduce

__all__ = ["matmul", "matmul_vjp", "matmul_reference"]

_MAX_BATCH = 65535
_DTYPES = (torch.float32, torch.bfloat16)


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


def _launch(a, b, out):
    """out (batch..., M, N) contiguous = a @ b, both expanded to the batch."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    dims = _merge_batch(out.shape[:-2], a.stride()[:-2], b.stride()[:-2])
    if len(dims) > 2:
        # three unmergeable batch strides: the kernel walks two
        a, b = a.contiguous(), b.contiguous()
        dims = _merge_batch(out.shape[:-2], a.stride()[:-2], b.stride()[:-2])
    dims = [(1, 0, 0)] * (2 - len(dims)) + dims
    (n1, sa1, sb1), (n2, sa2, sb2) = dims
    if n1 * n2 > _MAX_BATCH:
        raise ValueError(f"matmul: batch {n1 * n2} > {_MAX_BATCH}")
    with torch.cuda.device(a.device):
        err = _build.library().lg_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, n1 * n2, n2,
            sa1, sa2, a.stride(-2), a.stride(-1), sb1, sb2, b.stride(-2),
            b.stride(-1), int(out.dtype == torch.bfloat16),
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "lg_matmul")
    runtime.count_launch("matmul")


def matmul(a, b):
    """``a @ b`` (numpy broadcasting over the batch dims): the CUDA kernel on
    CUDA tensors, :func:`matmul_reference` on CPU tensors."""
    _check(a, b)
    if not a.is_cuda:
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
