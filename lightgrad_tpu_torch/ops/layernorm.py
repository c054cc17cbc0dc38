"""Fused LayerNorm: the Triton kernels and their plain twins.

Counterpart of ``lightgrad_tpu/ops/layernorm.py`` (kernels ``_fwd_kernel``
and ``_bwd_kernel``).  Rows are the leading dims, columns are ``w``'s size:

    layernorm_fwd(x, w, b, eps) -> (y, xhat, rstd)   y like x; xhat (r, c)
                                                     and rstd (r, 1) float32
    layernorm_bwd_dx(g, w, xhat, rstd) -> dx (r, c) in g's dtype,
        dx = rstd * (gw - mean(gw) - xhat * mean(gw * xhat)),  gw = g * w

are the JAX package's signatures.  The autograd Functions (``autograd/ops.py``
and the tape's ``layernorm`` op) save no (r, c) residual beyond x:

    layernorm_fwd_stats(x, w, b, eps) -> (y, mean, rstd)  mean, rstd (r, 1)
                                                          float32
    layernorm_bwd(g, x, w, mean, rstd) -> (dx, dw, db)    dw, db like w,
        xhat = (x - mean) * rstd recomputed from x as the forward computed it,
        dw = sum over rows of g * xhat,  db = sum over rows of g

On CUDA tensors the wrappers launch Triton kernels; on CPU tensors they run
the ``*_reference`` versions.

The kernels on this card: each is one pass over its rows, bound by device
memory (a 768-wide f32 row is 3 KB read, 3 KB written, for ~10 flops per
element).  One program holds a block of whole rows in registers, so every
row is read once and the statistics never leave the chip.  The backward
(``ln_bwd``) runs one program on each of a few SMs' worth of row slices:
each writes dx for its rows and keeps its column sums of g * xhat and g in
registers, then stores them as one row of an f32 (P, c) workspace; a
second launch (``ln_bwd_sums``) adds the P rows in a fixed order into dw and
db.  No atomics: dw and db are bitwise the same from run to run.  The
statistics, partials and sums are float32 whatever the input dtype.  Triton
is imported, and the kernels compiled, at the first launch.
"""

from functools import lru_cache

import torch

from . import runtime

__all__ = ["layernorm_fwd", "layernorm_fwd_stats", "layernorm_bwd",
           "layernorm_bwd_dx", "layernorm_fwd_reference",
           "layernorm_fwd_stats_reference", "layernorm_bwd_reference",
           "layernorm_bwd_dx_reference"]

_MAX_COLS = 16384       # a row block must fit in one program's registers
# backward programs a launch aims at, per SM: the (P, c) partials cost P
# rows of traffic, the occupancy wants several programs an SM
_BWD_PROGRAMS_PER_SM = 2
_TILE = 4096            # elements of a program's (BLOCK_R, BLOCK_C) tile
_kernels = None


def _rows_cols(x, w):
    c = w.numel()
    if c == 0 or x.numel() % c or tuple(x.shape[-w.dim():]) != tuple(w.shape):
        raise ValueError(f"layernorm: x {tuple(x.shape)} does not end in "
                         f"w's shape {tuple(w.shape)}")
    return x.numel() // c, c


def layernorm_fwd_stats_reference(x, w, b, eps: float = 1e-5):
    """Plain PyTorch (y, mean, rstd), statistics in float32."""
    r, c = _rows_cols(x, w)
    x2 = x.reshape(r, c).float()
    mu = x2.mean(-1, keepdim=True)
    d = x2 - mu
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    y = d * rstd * w.reshape(1, c).float() + b.reshape(1, c).float()
    return y.to(x.dtype).reshape(x.shape), mu, rstd


def layernorm_fwd_reference(x, w, b, eps: float = 1e-5):
    """Plain PyTorch (y, xhat, rstd), statistics in float32."""
    y, mu, rstd = layernorm_fwd_stats_reference(x, w, b, eps)
    r, c = _rows_cols(x, w)
    return y, (x.reshape(r, c).float() - mu) * rstd, rstd


def layernorm_bwd_dx_reference(g, w, xhat, rstd):
    """Plain PyTorch input gradient over the flattened rows."""
    r, c = xhat.shape
    gw = g.reshape(r, c).float() * w.reshape(1, c).float()
    m1 = gw.mean(-1, keepdim=True)
    m2 = (gw * xhat).mean(-1, keepdim=True)
    return (rstd * (gw - m1 - xhat * m2)).to(g.dtype)


def layernorm_bwd_reference(g, x, w, mean, rstd):
    """Plain PyTorch (dx, dw, db) over the flattened rows: dx in g's dtype
    and (r, c), dw and db in w's dtype and shape, every sum in float32."""
    r, c = _rows_cols(x, w)
    xhat = (x.reshape(r, c).float() - mean.reshape(r, 1)) * rstd.reshape(r, 1)
    g2 = g.reshape(r, c)
    dx = layernorm_bwd_dx_reference(g2, w, xhat, rstd.reshape(r, 1))
    g32 = g2.float()
    return (dx, (g32 * xhat).sum(0).reshape(w.shape).to(w.dtype),
            g32.sum(0).reshape(w.shape).to(w.dtype))


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
    def ln_fwd(X, W, B, Y, XHAT, MEAN, RSTD, R, C, eps,
               STORE_XHAT: tl.constexpr, BLOCK_R: tl.constexpr,
               BLOCK_C: tl.constexpr):
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
        if STORE_XHAT:
            tl.store(XHAT + offs, xhat, mask=mask)
        else:
            tl.store(MEAN + rows, mean, mask=rmask)
        tl.store(RSTD + rows, rstd, mask=rmask)

    # XHAT_IN: X holds xhat itself (the JAX signature's dx alone);
    # otherwise xhat = (X - mean) * rstd, and SUMS stores this program's
    # column sums of g * xhat and g as row p of PW and PB
    @triton.jit(do_not_specialize=["R", "ROWS_PER"])
    def ln_bwd(G, X, W, MEAN, RSTD, DX, PW, PB, R, C, ROWS_PER,
               XHAT_IN: tl.constexpr, SUMS: tl.constexpr,
               BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        p = tl.program_id(0)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        w = tl.load(W + cols, mask=cmask, other=0.0).to(tl.float32)
        r_lo = p * ROWS_PER
        r_hi = tl.minimum(R, r_lo + ROWS_PER)
        accw = tl.zeros([BLOCK_R, BLOCK_C], tl.float32)
        accb = tl.zeros([BLOCK_R, BLOCK_C], tl.float32)
        for r0 in range(r_lo, r_hi, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            rmask = rows < r_hi
            mask = rmask[:, None] & cmask[None, :]
            offs = rows[:, None].to(tl.int64) * C + cols[None, :]
            g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
            rstd = tl.load(RSTD + rows, mask=rmask, other=0.0)
            if XHAT_IN:
                xhat = tl.load(X + offs, mask=mask, other=0.0)
            else:
                x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
                mean = tl.load(MEAN + rows, mask=rmask, other=0.0)
                xhat = tl.where(mask, (x - mean[:, None]) * rstd[:, None],
                                0.0)
            gw = g * w[None, :]
            m1 = tl.sum(gw, axis=1) / C
            m2 = tl.sum(gw * xhat, axis=1) / C
            dx = rstd[:, None] * (gw - m1[:, None] - xhat * m2[:, None])
            tl.store(DX + offs, dx.to(DX.dtype.element_ty), mask=mask)
            if SUMS:
                accw += g * xhat
                accb += g
        if SUMS:
            prow = p.to(tl.int64) * C + cols
            tl.store(PW + prow, tl.sum(accw, axis=0), mask=cmask)
            tl.store(PB + prow, tl.sum(accb, axis=0), mask=cmask)

    # dw, db = the P partial rows of PW, PB summed in a fixed order
    @triton.jit(do_not_specialize=["P"])
    def ln_bwd_sums(PW, PB, DW, DB, P, C, BLOCK_P: tl.constexpr,
                    BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        accw = tl.zeros([BLOCK_P, BLOCK_C], tl.float32)
        accb = tl.zeros([BLOCK_P, BLOCK_C], tl.float32)
        for p0 in range(0, P, BLOCK_P):
            ps = p0 + tl.arange(0, BLOCK_P)
            mask = (ps < P)[:, None] & cmask[None, :]
            offs = ps[:, None].to(tl.int64) * C + cols[None, :]
            accw += tl.load(PW + offs, mask=mask, other=0.0)
            accb += tl.load(PB + offs, mask=mask, other=0.0)
        tl.store(DW + cols, tl.sum(accw, axis=0).to(DW.dtype.element_ty),
                 mask=cmask)
        tl.store(DB + cols, tl.sum(accb, axis=0).to(DB.dtype.element_ty),
                 mask=cmask)

    _kernels = (ln_fwd, ln_bwd, ln_bwd_sums)
    return _kernels


def _launch_shape(r, c):
    """(grid, BLOCK_R, BLOCK_C, num_warps): about ``_TILE`` elements a
    program."""
    block_c = 1 << max(c - 1, 0).bit_length()
    block_r = max(1, _TILE // block_c)
    warps = min(16, max(4, block_r * block_c // 512))
    return ((r + block_r - 1) // block_r,), block_r, block_c, warps


def _bwd_split(r, block_r, n_sm):
    """(programs, rows a program) of the backward: row slices of whole
    blocks, about ``_BWD_PROGRAMS_PER_SM`` programs an SM."""
    blocks = -(-r // block_r)
    per = -(-blocks // min(blocks, _BWD_PROGRAMS_PER_SM * n_sm))
    return -(-blocks // per), per * block_r


def _sums_block(c, n_sm):
    """Columns a program of the second stage: 16 or more (64-byte rows of
    the partials), fewer than enough to give every SM about one program."""
    block = 16
    while block < 128 and -(-c // (2 * block)) >= n_sm:
        block *= 2
    return block


@lru_cache(maxsize=None)
def _n_sm(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _fwd(x, w, b, eps, store_xhat):
    r, c = _rows_cols(x, w)
    name = "layernorm_fwd" if store_xhat else "layernorm_fwd_stats"
    _check_cuda(name, c, ("x", x, _IO), ("w", w, _IO), ("b", b, _IO))
    y = torch.empty_like(x)
    stat = torch.empty((r, 1), device=x.device, dtype=torch.float32)
    rstd = torch.empty((r, 1), device=x.device, dtype=torch.float32)
    xhat = torch.empty((r, c), device=x.device, dtype=torch.float32) \
        if store_xhat else stat
    fwd = _triton_kernels()[0]
    grid, block_r, block_c, warps = _launch_shape(r, c)
    with torch.cuda.device(x.device):
        fwd[grid](x, w, b, y, xhat, stat, rstd, r, c, float(eps),
                  STORE_XHAT=store_xhat, BLOCK_R=block_r, BLOCK_C=block_c,
                  num_warps=warps)
    runtime.count_launch("layernorm_fwd")
    return y, (xhat if store_xhat else stat), rstd


def layernorm_fwd(x, w, b, eps: float = 1e-5):
    """(y, xhat, rstd): Triton kernel on CUDA, plain version on CPU."""
    if not x.is_cuda:
        return layernorm_fwd_reference(x, w, b, eps)
    return _fwd(x, w, b, eps, True)


def _fwd_strategies(shapes, x, w, b, *args):
    """For one mesh dim: any leading (row) dim of x, which shards y and the
    row statistics alike; w and b replicated."""
    R, S = runtime.Replicate, runtime.Shard
    lead = len(shapes[0]) - len(shapes[1])
    return [((S(d), R(), R()), (S(d),) * 3) for d in range(lead)
            if shapes[0][d] > 1] + [((R(),) * 3, (R(),) * 3)]


def _bwd_strategies(shapes, *args):
    """The forward's row sharding; dw and db are then each shard's partial
    sums."""
    R, S, P = runtime.Replicate, runtime.Shard, runtime.Partial
    lead = len(shapes[1]) - len(shapes[2])
    return [((S(d), S(d), R(), S(d), S(d)), (S(d), P(), P()))
            for d in range(lead) if shapes[1][d] > 1] + [
        ((R(),) * 5, (R(),) * 3)]


def _lead(x, w):
    return x.shape[:x.dim() - w.dim()]


def _fwd_stats_local(x, w, b, eps):
    """The statistics of a shard's rows in the rows' own shape."""
    y, mean, rstd = layernorm_fwd_stats(x, w, b, eps)
    return y, mean.reshape(_lead(x, w)), rstd.reshape(_lead(x, w))


def _bwd_local(g, x, w, mean, rstd):
    dx, dw, db = layernorm_bwd(g, x, w, mean.reshape(-1, 1),
                               rstd.reshape(-1, 1))
    return dx.reshape(x.shape), dw, db


def layernorm_fwd_stats(x, w, b, eps: float = 1e-5):
    """(y, mean, rstd), the autograd path's forward: Triton kernel on CUDA,
    plain version on CPU.  Sharded operands (``DTensor``) by the strategies
    above; the statistics then come in x's leading shape."""
    if runtime.is_sharded(x, w, b):
        return runtime.sharded("layernorm_fwd", _fwd_strategies,
                               _fwd_stats_local, x, w, b, eps)
    if not x.is_cuda:
        return layernorm_fwd_stats_reference(x, w, b, eps)
    return _fwd(x, w, b, eps, False)


def _bwd(g, x, w, mean, rstd, xhat_in):
    r, c = x.shape
    dx = torch.empty((r, c), device=g.device, dtype=g.dtype)
    bwd, sums = _triton_kernels()[1:]
    _, block_r, block_c, warps = _launch_shape(r, c)
    n_sm = _n_sm(g.device)
    # dx alone needs no partials: one row block a program, as many as fit
    programs, rows_per = ((-(-r // block_r), block_r) if xhat_in
                          else _bwd_split(r, block_r, n_sm))
    part = dw = db = dx        # not written by the dx-only variant
    if not xhat_in:
        part = torch.empty((2, programs, c), device=g.device,
                           dtype=torch.float32)
        dw, db = torch.empty_like(w), torch.empty_like(w)
    with torch.cuda.device(g.device):
        bwd[(programs,)](g, x, w, mean, rstd, dx, part[0], part[-1], r, c,
                         rows_per, XHAT_IN=xhat_in, SUMS=not xhat_in,
                         BLOCK_R=block_r, BLOCK_C=block_c, num_warps=warps)
        runtime.count_launch("layernorm_bwd")
        if xhat_in:
            return dx
        block_s = _sums_block(c, n_sm)
        sums[(-(-c // block_s),)](part[0], part[1], dw, db, programs, c,
                                  BLOCK_P=2048 // block_s, BLOCK_C=block_s,
                                  num_warps=4)
        runtime.count_launch("layernorm_bwd")
    return dx, dw, db


def layernorm_bwd(g, x, w, mean, rstd):
    """(dx, dw, db) over the flattened rows from the saved x and statistics:
    Triton kernels on CUDA, plain version on CPU.  Sharded operands as
    :func:`layernorm_fwd_stats` gave them (dx then in x's shape)."""
    if runtime.is_sharded(g, x, w, mean, rstd):
        return runtime.sharded("layernorm_bwd", _bwd_strategies, _bwd_local,
                               g, x, w, mean, rstd)
    if not g.is_cuda:
        return layernorm_bwd_reference(g, x, w, mean, rstd)
    r, c = _rows_cols(x, w)
    if g.numel() != r * c or mean.numel() != r or rstd.numel() != r:
        raise ValueError(f"layernorm_bwd: g {tuple(g.shape)}, x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, mean "
                         f"{tuple(mean.shape)}, rstd {tuple(rstd.shape)}")
    _check_cuda("layernorm_bwd", c, ("g", g, _IO), ("x", x, _IO),
                ("w", w, _IO), ("mean", mean, _F32), ("rstd", rstd, _F32))
    return _bwd(g.reshape(r, c), x.reshape(r, c), w, mean, rstd, False)


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
    return _bwd(g.reshape(r, c), xhat, w, rstd, rstd, True)
