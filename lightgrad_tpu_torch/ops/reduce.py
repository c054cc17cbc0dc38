"""Sum / max / min over any axes: the Triton kernel and its plain twin.

Counterpart of ``lightgrad_tpu/ops/reduce.py`` (TPU kernel
``_pallas_reduce2``, (K, R) -> (K, 1) over the last axis, and
``_reduce_impl``, which moves the reduced axes last).  The result keeps the
input's dtype; floating sums accumulate in float32.  Empty ``axes`` (a 0-d
input, or ``axis=()``) is the identity.  On CUDA tensors :func:`reduce`
launches the kernel; on CPU tensors it runs :func:`reduce_reference`.

The kernel on this card: one pass over the input, bound by device memory.
It reads the input where it lies, through two strides: the kept axes
merge into K rows, the reduced axes into R columns, whenever the layout
allows (a contiguous input always does for a prefix or a suffix of axes,
e.g. the bias gradient's sum over the leading (batch, seq) axes), so no
transposed copy is made.  Each program owns a block of rows and walks R in
chunks, with the block in registers; a stride of 1 on either axis is
specialised by Triton, which keeps the loads coalesced for row sums and
column sums alike.  Triton is imported, and the kernel compiled, at the
first launch.
"""

from math import prod

import torch

from . import runtime

__all__ = ["reduce", "reduce_reference"]

_OPS = ("sum", "max", "min")
_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_kernel = None


def _normalize_axes(axis, rank):
    if axis is None:
        return tuple(range(rank))
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    return tuple(sorted({a % rank for a in axes}))


def _out_shape(shape, axes, keepdims):
    if keepdims:
        return tuple(1 if d in axes else n for d, n in enumerate(shape))
    return tuple(n for d, n in enumerate(shape) if d not in axes)


def reduce_reference(x, op: str, axis=None, keepdims: bool = False):
    """Plain PyTorch reduction with the kernel's dtype rules."""
    axes = _normalize_axes(axis, x.dim())
    if not axes:
        return x
    if op == "sum":
        acc = x.float() if x.is_floating_point() else x
        return acc.sum(dim=axes, keepdim=keepdims).to(x.dtype)
    if op == "max":
        return torch.amax(x, dim=axes, keepdim=keepdims)
    if op == "min":
        return torch.amin(x, dim=axes, keepdim=keepdims)
    raise ValueError(f"reduce: unknown op {op!r}")


def _merge(sizes, strides):
    """(size, stride) walking ``sizes`` (outer first) as one axis, or None
    when the strides do not allow it."""
    dims = [(n, s) for n, s in zip(sizes, strides) if n != 1]
    if not dims:
        return 1, 0
    total, step = dims[-1]
    for n, s in reversed(dims[:-1]):
        if s != step * total:
            return None
        total *= n
    return total, step


def _triton_kernel():
    """Compile-on-first-use Triton kernel (``triton`` is imported here so
    that a host without it can import this module)."""
    # module globals: Triton resolves a kernel's names in its module
    global _kernel, triton, tl
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["K", "R"])
    def reduce_rows(X, Y, K, R, SK, SR, OP: tl.constexpr,
                    IS_INT: tl.constexpr, NEUTRAL: tl.constexpr,
                    BLOCK_K: tl.constexpr, BLOCK_R: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * BLOCK_K + tl.arange(0, BLOCK_K)
        rmask = rows < K
        base = X + rows[:, None] * SK
        if IS_INT:
            acc = tl.full([BLOCK_K, BLOCK_R], NEUTRAL, tl.int32)
        else:
            acc = tl.full([BLOCK_K, BLOCK_R], NEUTRAL, tl.float32)
        for r0 in range(0, R, BLOCK_R):
            cols = r0 + tl.arange(0, BLOCK_R)
            mask = rmask[:, None] & (cols < R)[None, :]
            v = tl.load(base + cols[None, :].to(tl.int64) * SR, mask=mask,
                        other=NEUTRAL).to(acc.dtype)
            if OP == 0:
                acc += v
            elif OP == 1:
                acc = tl.maximum(acc, v)
            else:
                acc = tl.minimum(acc, v)
        if OP == 0:
            res = tl.sum(acc, axis=1)
        elif OP == 1:
            res = tl.max(acc, axis=1)
        else:
            res = tl.min(acc, axis=1)
        tl.store(Y + rows, res.to(Y.dtype.element_ty), mask=rmask)

    _kernel = reduce_rows
    return _kernel


def _neutral(op, dtype):
    if op == "sum":
        return 0
    if dtype == torch.int32:
        return -2 ** 31 if op == "max" else 2 ** 31 - 1
    return float("-inf") if op == "max" else float("inf")


def _blocks(k, r, sr):
    """(BLOCK_K, BLOCK_R, num_warps): about 2048 elements a program, the
    block long along the axis that is contiguous in memory."""
    if sr == 1:
        block_r = min(1024, max(16, 1 << max(r - 1, 0).bit_length()))
        block_k = max(1, 2048 // block_r)
    else:
        block_k = min(128, max(16, 1 << max(k - 1, 0).bit_length()))
        block_r = max(1, 2048 // block_k)
    return block_k, block_r, 4


def reduce(x, op: str, axis=None, keepdims: bool = False):
    """``op`` in sum / max / min over ``axis`` (None: all): the Triton
    kernel on CUDA tensors, :func:`reduce_reference` on CPU tensors."""
    if op not in _OPS:
        raise ValueError(f"reduce: unknown op {op!r}")
    if not x.is_cuda:
        return reduce_reference(x, op, axis, keepdims)
    if x.dtype not in _DTYPES:
        raise TypeError(f"reduce: unsupported dtype {x.dtype}")
    rank = x.dim()
    axes = _normalize_axes(axis, rank)
    if not axes:
        return x
    keep = tuple(d for d in range(rank) if d not in axes)
    shape = _out_shape(x.shape, axes, keepdims)
    k = prod(x.shape[d] for d in keep)
    r = prod(x.shape[d] for d in axes)
    if k == 0 or r == 0:
        if r == 0 and op != "sum":
            raise ValueError(f"reduce: {op} over an empty axis")
        return torch.zeros(shape, device=x.device, dtype=x.dtype)
    rows = _merge([x.shape[d] for d in keep], [x.stride(d) for d in keep])
    cols = _merge([x.shape[d] for d in axes], [x.stride(d) for d in axes])
    if rows is None or cols is None:
        # the layout cannot be walked with two strides: transposed copy
        x = x.permute(*keep, *axes).contiguous()
        rows, cols = (k, r), (r, 1)
    sk, sr = rows[1], cols[1]
    y = torch.empty(shape, device=x.device, dtype=x.dtype)
    block_k, block_r, warps = _blocks(k, r, sr)
    kern = _triton_kernel()
    with torch.cuda.device(x.device):
        kern[(triton.cdiv(k, block_k),)](
            x, y, k, r, sk, sr, OP=_OPS.index(op),
            IS_INT=x.dtype == torch.int32, NEUTRAL=_neutral(op, x.dtype),
            BLOCK_K=block_k, BLOCK_R=block_r, num_warps=warps)
    runtime.count_launch("reduce")
    return y
