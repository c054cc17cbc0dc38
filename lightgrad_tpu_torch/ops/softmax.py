"""Last-axis softmax, forward and backward: the Triton kernels and their
plain twins.

Counterpart of ``lightgrad_tpu/ops/softmax.py`` (TPU kernel ``_rows_call``
with ``_fwd_kernel`` / ``_bwd_kernel``):

    softmax_fwd(x) -> y = exp(x - max) / sum(exp(x - max))     like x
    softmax_bwd(g, y) -> dx = y * (d - sum(d*y)),  d = g - sum(g*y)

over the last axis of any shape.  The backward is the JAX package's
``y * (g - sum(g*y))`` with its row sum taken in two passes.  Where the
rows of g share a large common part -- attention of a deep stack whose
tokens have drifted together, so that ``dP = dO v^T`` is nearly constant
along a row -- ``sum(g*y)`` carries a rounding error of f32 epsilon times
that common part, and every element of the row inherits it: the row of dx
no longer sums to zero, and the keys' and queries' gradients (a sum over
the row's tokens) lose about three digits at BERT-base depth.  The second
pass takes the same sum over ``d``, which is small, and removes that
error: in f32 the gradients of BERT-base's attention weights (8 x 128
tokens, random weights) then stay within ~4e-5 of a float64 computation,
against ~1.3e-3 with one pass.  On CUDA tensors the wrappers launch the
Triton kernels; on CPU tensors they run the ``*_reference`` versions,
which compute the same two passes.

The kernels on this card: each is one pass over its rows, bound by device
memory (the (8, 12, 128, 128) attention scores of BERT-base are 6 MB of
f32 read and written once, for ~5-8 flops per element).  One program holds a
block of whole rows in registers, so the row max and sum never leave the
chip, and the math is float32 whatever the input dtype.  Triton is
imported, and the kernels compiled, at the first launch.
"""

import torch

from . import runtime

__all__ = ["softmax_fwd", "softmax_bwd", "softmax_fwd_reference",
           "softmax_bwd_reference"]

_MAX_COLS = 32768       # a row block must fit in one program's registers
_DTYPES = (torch.float32, torch.bfloat16)
_kernels = None


def softmax_fwd_reference(x):
    """Plain PyTorch softmax over the last axis, in float32."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def softmax_bwd_reference(g, y):
    """Plain PyTorch softmax backward over the last axis, in float32."""
    g32, y32 = g.float(), y.float()
    d = g32 - (g32 * y32).sum(-1, keepdim=True)
    return (y32 * (d - (d * y32).sum(-1, keepdim=True))).to(g.dtype)


def _triton_kernels():
    """Compile-on-first-use Triton kernels (``triton`` is imported here so
    that a host without it can import this module)."""
    global _kernels, triton, tl
    if _kernels is not None:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["R"])
    def softmax_fwd_rows(X, Y, R, C, BLOCK_R: tl.constexpr,
                         BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_C)
        mask = (rows < R)[:, None] & (cols < C)[None, :]
        offs = rows[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(X + offs, mask=mask, other=float("-inf")).to(tl.float32)
        e = tl.exp(x - tl.max(x, axis=1)[:, None])
        y = e / tl.sum(e, axis=1)[:, None]
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=mask)

    @triton.jit(do_not_specialize=["R"])
    def softmax_bwd_rows(G, Yp, DX, R, C, BLOCK_R: tl.constexpr,
                         BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_C)
        mask = (rows < R)[:, None] & (cols < C)[None, :]
        offs = rows[:, None].to(tl.int64) * C + cols[None, :]
        g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
        y = tl.load(Yp + offs, mask=mask, other=0.0).to(tl.float32)
        d = g - tl.sum(g * y, axis=1)[:, None]
        dx = y * (d - tl.sum(d * y, axis=1)[:, None])
        tl.store(DX + offs, dx.to(DX.dtype.element_ty), mask=mask)

    _kernels = (softmax_fwd_rows, softmax_bwd_rows)
    return _kernels


def _launch_shape(r, c):
    """(grid, BLOCK_R, BLOCK_C, num_warps): about 4096 elements a program."""
    block_c = 1 << max(c - 1, 0).bit_length()
    block_r = max(1, 4096 // block_c)
    warps = min(16, max(4, block_r * block_c // 512))
    return ((r + block_r - 1) // block_r,), block_r, block_c, warps


def _rows(fn, *ts):
    """(rows, cols) of the call; raises on what the kernel does not take."""
    x = ts[0]
    c = x.shape[-1] if x.dim() else 1
    if c > _MAX_COLS:
        raise ValueError(f"{fn}: {c} columns > {_MAX_COLS}")
    for t in ts:
        if t.device != x.device or t.dtype not in _DTYPES \
                or t.shape != x.shape:
            raise ValueError(f"{fn}: operands must be float32/bfloat16 of "
                             f"one shape on one device")
    return x.numel() // max(c, 1), c


def softmax_fwd(x):
    """Softmax over the last axis: the Triton kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if not x.is_cuda:
        return softmax_fwd_reference(x)
    r, c = _rows("softmax_fwd", x)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        fwd, _ = _triton_kernels()
        grid, block_r, block_c, warps = _launch_shape(r, c)
        with torch.cuda.device(x.device):
            fwd[grid](x, y, r, c, BLOCK_R=block_r, BLOCK_C=block_c,
                      num_warps=warps)
        runtime.count_launch("softmax_fwd")
    return y


def softmax_bwd(g, y):
    """Input gradient of :func:`softmax_fwd` given its output ``y``: the
    Triton kernel on CUDA tensors, the plain version on CPU tensors."""
    if not g.is_cuda:
        return softmax_bwd_reference(g, y)
    r, c = _rows("softmax_bwd", g, y)
    g, y = g.contiguous(), y.contiguous()
    dx = torch.empty_like(g)
    if g.numel():
        _, bwd = _triton_kernels()
        grid, block_r, block_c, warps = _launch_shape(r, c)
        with torch.cuda.device(g.device):
            bwd[grid](g, y, dx, r, c, BLOCK_R=block_r, BLOCK_C=block_c,
                      num_warps=warps)
        runtime.count_launch("softmax_bwd")
    return dx
