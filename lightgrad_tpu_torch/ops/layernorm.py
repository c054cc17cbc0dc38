"""Fused LayerNorm: the Triton kernels and their plain twins.

Counterpart of ``lightgrad_tpu/ops/layernorm.py`` (kernels ``_fwd_kernel``
and ``_bwd_kernel``).  Rows are the leading dims, columns are ``w``'s size:

    layernorm_fwd(x, w, b, eps) -> (y, xhat, rstd)   y like x; xhat (r, c)
                                                     and rstd (r, 1) float32
    layernorm_bwd_dx(g, w, xhat, rstd) -> dx (r, c) in g's dtype,
        dx = rstd * (gw - mean(gw) - xhat * mean(gw * xhat)),  gw = g * w

The weight and bias gradients are plain row sums (``autograd/ops.py``), as
the JAX package leaves them to its reduce op.  On CUDA tensors the wrappers
launch Triton kernels; on CPU tensors they run the ``*_reference`` versions.

The kernels on this card: each is one pass over its rows, bound by device
memory (a 768-wide f32 row is 3 KB read, up to 6 KB written, for ~10 flops
per element).  One program holds a block of whole rows in registers, so
every row is read once and the statistics never leave the chip.  ``xhat``
and ``rstd`` are kept in f32 whatever the input dtype, so the backward of a
bf16 model loses no bits to the saved residuals.  Triton is imported, and
the kernels compiled, at the first launch.
"""

import torch

from . import runtime

__all__ = ["layernorm_fwd", "layernorm_bwd_dx", "layernorm_fwd_reference",
           "layernorm_bwd_dx_reference"]

_MAX_COLS = 16384       # a row block must fit in one program's registers
_kernels = None


def _rows_cols(x, w):
    c = w.numel()
    if c == 0 or x.numel() % c or tuple(x.shape[-w.dim():]) != tuple(w.shape):
        raise ValueError(f"layernorm: x {tuple(x.shape)} does not end in "
                         f"w's shape {tuple(w.shape)}")
    return x.numel() // c, c


def layernorm_fwd_reference(x, w, b, eps: float = 1e-5):
    """Plain PyTorch (y, xhat, rstd), statistics in float32."""
    r, c = _rows_cols(x, w)
    x2 = x.reshape(r, c).float()
    mu = x2.mean(-1, keepdim=True)
    d = x2 - mu
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    xhat = d * rstd
    y = xhat * w.reshape(1, c).float() + b.reshape(1, c).float()
    return y.to(x.dtype).reshape(x.shape), xhat, rstd


def layernorm_bwd_dx_reference(g, w, xhat, rstd):
    """Plain PyTorch input gradient over the flattened rows."""
    r, c = xhat.shape
    gw = g.reshape(r, c).float() * w.reshape(1, c).float()
    m1 = gw.mean(-1, keepdim=True)
    m2 = (gw * xhat).mean(-1, keepdim=True)
    return (rstd * (gw - m1 - xhat * m2)).to(g.dtype)


def _triton_kernels():
    """Compile-on-first-use Triton kernels (``triton`` is imported here so
    that a host without it can import this module)."""
    # module globals: Triton resolves a kernel's names (``tl``) in its
    # module's namespace
    global _kernels, triton, tl
    if _kernels is not None:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def ln_fwd(X, W, B, Y, XHAT, RSTD, R, C, eps,
               BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_C)
        rmask = rows < R
        cmask = cols < C
        mask = rmask[:, None] & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / C
        d = tl.where(mask, x - mean[:, None], 0.0)
        rstd = 1.0 / tl.sqrt(tl.sum(d * d, axis=1) / C + eps)
        xhat = d * rstd[:, None]
        w = tl.load(W + cols, mask=cmask, other=0.0).to(tl.float32)
        b = tl.load(B + cols, mask=cmask, other=0.0).to(tl.float32)
        y = xhat * w[None, :] + b[None, :]
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=mask)
        tl.store(XHAT + offs, xhat, mask=mask)
        tl.store(RSTD + rows, rstd, mask=rmask)

    @triton.jit
    def ln_bwd(G, W, XHAT, RSTD, DX, R, C,
               BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_C)
        rmask = rows < R
        cmask = cols < C
        mask = rmask[:, None] & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * C + cols[None, :]
        g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
        xhat = tl.load(XHAT + offs, mask=mask, other=0.0)
        rstd = tl.load(RSTD + rows, mask=rmask, other=0.0)
        w = tl.load(W + cols, mask=cmask, other=0.0).to(tl.float32)
        gw = g * w[None, :]
        m1 = tl.sum(gw, axis=1) / C
        m2 = tl.sum(gw * xhat, axis=1) / C
        dx = rstd[:, None] * (gw - m1[:, None] - xhat * m2[:, None])
        tl.store(DX + offs, dx.to(DX.dtype.element_ty), mask=mask)

    _kernels = (ln_fwd, ln_bwd)
    return _kernels


def _launch_shape(r, c):
    """(grid, BLOCK_R, BLOCK_C, num_warps): about 4096 elements a program."""
    block_c = 1 << max(c - 1, 0).bit_length()
    block_r = max(1, 4096 // block_c)
    warps = min(16, max(4, block_r * block_c // 512))
    return ((r + block_r - 1) // block_r,), block_r, block_c, warps


def _check_cuda(fn, c, *named):
    if c > _MAX_COLS:
        raise ValueError(f"{fn}: {c} columns > {_MAX_COLS}")
    dev = named[0][1].device
    for name, t, dtypes in named:
        if t.device != dev or not t.is_contiguous() or t.dtype not in dtypes:
            raise ValueError(f"{fn}: {name} must be a contiguous tensor on "
                             f"{dev} of dtype {dtypes}")


_IO = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)


def layernorm_fwd(x, w, b, eps: float = 1e-5):
    """(y, xhat, rstd): Triton kernel on CUDA, plain version on CPU."""
    if not x.is_cuda:
        return layernorm_fwd_reference(x, w, b, eps)
    r, c = _rows_cols(x, w)
    _check_cuda("layernorm_fwd", c, ("x", x, _IO), ("w", w, _IO),
                ("b", b, _IO))
    y = torch.empty_like(x)
    xhat = torch.empty((r, c), device=x.device, dtype=torch.float32)
    rstd = torch.empty((r, 1), device=x.device, dtype=torch.float32)
    fwd, _ = _triton_kernels()
    grid, block_r, block_c, warps = _launch_shape(r, c)
    with torch.cuda.device(x.device):
        fwd[grid](x, w, b, y, xhat, rstd, r, c, float(eps),
                  BLOCK_R=block_r, BLOCK_C=block_c, num_warps=warps)
    runtime.count_launch("layernorm_fwd")
    return y, xhat, rstd


def layernorm_bwd_dx(g, w, xhat, rstd):
    """Input gradient over the flattened rows: Triton kernel on CUDA, plain
    version on CPU."""
    if not g.is_cuda:
        return layernorm_bwd_dx_reference(g, w, xhat, rstd)
    r, c = xhat.shape
    if g.numel() != r * c or w.numel() != c or rstd.numel() != r:
        raise ValueError(f"layernorm_bwd_dx: g {tuple(g.shape)}, w "
                         f"{tuple(w.shape)}, xhat {tuple(xhat.shape)}, rstd "
                         f"{tuple(rstd.shape)}")
    _check_cuda("layernorm_bwd_dx", c, ("g", g, _IO), ("w", w, _IO),
                ("xhat", xhat, _F32), ("rstd", rstd, _F32))
    dx = torch.empty((r, c), device=g.device, dtype=g.dtype)
    _, bwd = _triton_kernels()
    grid, block_r, block_c, warps = _launch_shape(r, c)
    with torch.cuda.device(g.device):
        bwd[grid](g, w, xhat, rstd, dx, r, c,
                  BLOCK_R=block_r, BLOCK_C=block_c, num_warps=warps)
    runtime.count_launch("layernorm_bwd")
    return dx
