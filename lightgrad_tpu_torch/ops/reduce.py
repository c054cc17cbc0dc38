"""Sum / max / min over any axes: the Triton kernels and their plain twin.

Counterpart of ``lightgrad_tpu/ops/reduce.py`` (TPU kernel
``_pallas_reduce2``, (K, R) -> (K, 1) over the last axis, and
``_reduce_impl``, which moves the reduced axes last).  The result keeps the
input's dtype; floating sums accumulate in float32.  Empty ``axes`` (a 0-d
input, or ``axis=()``) is the identity.  On CUDA tensors :func:`reduce`
launches the kernels; on CPU tensors it runs :func:`reduce_reference`.

The kernels on this card: a reduce is bound by device memory (one add an
element), so the design reads the input once, where it lies, with enough
programs to fill the card.  :func:`_plan` walks the input as

    x[o * S2 + k * SK + i * S1],   k < K kept;  i < N1, o < N2 reduced

the kept axes merged into one stride, the reduced axes into at most two
runs (R1 the one with the smaller stride): rows (R1 contiguous),
columns (K contiguous: every bias gradient), BatchNorm's (0, 2, 3) over
NCHW (N2 = N, K = C, N1 = H W), prefix and suffix sums, ``keepdims`` and
``axis=None`` are all read in place.  Only kept axes that do not merge into
one stride (the middle axis of a contiguous (A, B, C) reduced, a permuted
view's kept axes out of order), or reduced axes that form more than two
runs, take a transposed copy first.

Where K alone gives too few programs for the card's SMs, R is split:
each of S programs for a block of K sums a fixed slice of R (whole steps
of R2, then pieces of R1 in whole tiles) into an f32 partial of an (S, K)
workspace, and a second launch (``lg_reduce_finish``) sums the S partials
in a fixed order.  No atomics: a result is bitwise the same from run to run.
Row walks (``lg_reduce_rows``, one kept index a program) load 16 bytes a
thread: each contiguous segment is split into an unaligned head, whole
16-byte groups, and a tail.  Other layouts (``lg_reduce_tiles``) take a
(BLOCK_K, BLOCK_R) tile; a stride of 1 on either axis is specialised by
Triton, which keeps the loads coalesced and, for columns, 16 bytes wide.
Triton is imported, and the kernels compiled, at the first launch.
"""

from collections import namedtuple
from functools import lru_cache
from math import prod

import torch

from . import runtime

__all__ = ["reduce", "reduce_reference"]

_OPS = ("sum", "max", "min")
_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
# programs a launch aims at: several for each SM
_WAVES = 8
# the least input a split program reads (bytes): below it the partials'
# traffic and the second launch cost more than the extra programs bring
_MIN_SLICE_BYTES = 16384
_MAX_SPLITS = 1024
# a contiguous reduced run at least this long (bytes) is walked a kept
# index a program with 16-byte loads; shorter ones in (K, R) tiles
_ROW_BYTES = 2048
_ROW_TILE_BYTES = 8192      # one row program's loads in flight
_TILE = 4096                # elements of a (BLOCK_K, BLOCK_R) tile
_kernels = None

# The walk of one call: x[o * s2 + k * sk + i * s1]; R split into
# splits2 x splits1 slices, slice s = (s // splits1, s % splits1) covering
# o in [per2 * (s // splits1), ...) and i in [per1 * (s % splits1), ...)
Plan = namedtuple("Plan", "kind k sk n1 s1 n2 s2 splits1 per1 splits2 per2 "
                          "block_k block_r warps")


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


def _runs(dims):
    """The reduced (size, stride) pairs merged into as few runs as their
    strides allow, largest stride first (the order of a sum is free)."""
    runs = []
    for n, s in sorted(dims, key=lambda d: -d[1]):
        if runs and runs[-1][1] == s * n:
            runs[-1] = (runs[-1][0] * n, s)
        else:
            runs.append((n, s))
    return runs


def _pow2(n):
    return 1 << max(n - 1, 0).bit_length()


def _cdiv(a, b):
    return -(-a // b)


def _plan(shape, strides, axes, itemsize, n_sm):
    """The walk and the split of one reduce call, or None when the layout
    needs a transposed copy (kept axes that do not merge into one stride,
    or more than two reduced runs).  A pure function of the call, so that
    the CPU tests can check it."""
    dims = [(n, s, d in axes) for d, (n, s) in enumerate(zip(shape, strides))
            if n != 1]
    kept = _merge([n for n, _, r in dims if not r],
                  [s for _, s, r in dims if not r])
    runs = _runs([(n, s) for n, s, r in dims if r])
    if kept is None or len(runs) > 2:
        return None
    k, sk = kept
    runs = runs[::-1] + [(1, 0)] * (2 - len(runs))     # R1: smaller stride
    (n1, s1), (n2, s2) = runs
    # a stride that is never stepped is 0, so that it costs Triton's
    # divisibility analysis nothing
    sk, s1, s2 = (sk if k > 1 else 0), (s1 if n1 > 1 else 0), \
        (s2 if n2 > 1 else 0)
    if s1 == 1 and n1 * itemsize >= _ROW_BYTES:
        kind, block_k = "rows", 1
        block_r = min(_ROW_TILE_BYTES // itemsize, _pow2(n1))
        warps = min(8, block_r * itemsize // 16 // 32)
    else:
        kind = "tiles"
        if sk == 1:         # columns: the tile long along K
            block_r = min(_TILE // 64, _pow2(n1))
            block_k = min(_pow2(k), _TILE // block_r)
        else:
            block_r = min(1024 if s1 == 1 else 16, _pow2(n1))
            block_k = min(_pow2(k), _TILE // block_r)
        warps = 4
    programs = _cdiv(k, block_k)
    total = k * n1 * n2 * itemsize
    splits = max(1, min(_WAVES * n_sm // programs,
                        total // (programs * _MIN_SLICE_BYTES),
                        _MAX_SPLITS))
    splits2 = min(splits, n2)
    per2 = _cdiv(n2, splits2)
    splits2 = _cdiv(n2, per2)
    # R1 in whole tiles: a piece shorter than the tile leaves lanes idle
    splits1 = min(_cdiv(splits, splits2), _cdiv(n1, block_r))
    per1 = _cdiv(_cdiv(n1, splits1), block_r) * block_r
    splits1 = _cdiv(n1, per1)
    return Plan(kind, k, sk, n1, s1, n2, s2, splits1, per1, splits2, per2,
                block_k, block_r, warps)


# the wrapper's plans, by call: a tape step repeats a few hundred layouts
_cached_plan = lru_cache(maxsize=4096)(_plan)


def _slices(plan):
    """The (o range, i range) each split program sums, in the order the
    second stage adds them: the kernels' own arithmetic."""
    out = []
    for s in range(plan.splits1 * plan.splits2):
        o0 = (s // plan.splits1) * plan.per2
        i0 = (s % plan.splits1) * plan.per1
        out.append((range(o0, min(plan.n2, o0 + plan.per2)),
                    range(i0, min(plan.n1, i0 + plan.per1))))
    return out


def _finish_block(k, n_sm):
    """Columns a program of the second stage: up to 16 (64-byte rows of the
    partials) and then more, short of leaving SMs without a program."""
    block = min(16, max(2, _pow2(k)))
    while block < 128 and _cdiv(k, 2 * block) >= n_sm:
        block *= 2
    return block


def _neutral(op, dtype):
    if op == "sum":
        return 0
    if dtype == torch.int32:
        return -2 ** 31 if op == "max" else 2 ** 31 - 1
    return float("-inf") if op == "max" else float("inf")


def _triton_kernels():
    """Compile-on-first-use Triton kernels (``triton`` is imported here so
    that a host without it can import this module)."""
    # module globals: Triton resolves a kernel's names in its module
    global _kernels, triton, tl, _combine, _collapse
    if _kernels is not None:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def _combine(acc, v, OP: tl.constexpr):
        if OP == 0:
            out = acc + v
        elif OP == 1:
            out = tl.maximum(acc, v)
        else:
            out = tl.minimum(acc, v)
        return out

    @triton.jit
    def _collapse(acc, axis: tl.constexpr, OP: tl.constexpr):
        if OP == 0:
            out = tl.sum(acc, axis=axis)
        elif OP == 1:
            out = tl.max(acc, axis=axis)
        else:
            out = tl.min(acc, axis=axis)
        return out

    # one kept index k a program (axis 0) and a slice of R (axis 1); each
    # contiguous segment of R1 is an unaligned head, whole VEC-element
    # (16-byte) groups, and a tail
    @triton.jit(do_not_specialize=["K", "N1", "N2", "SK", "S2", "PER1",
                                   "PER2", "SPLITS1"])
    def lg_reduce_rows(X, Y, K, N1, N2, SK, S2, PER1, PER2, SPLITS1,
                    OP: tl.constexpr, IS_INT: tl.constexpr,
                    NEUTRAL: tl.constexpr, VEC: tl.constexpr,
                    GROUPS: tl.constexpr):
        k = tl.program_id(0)
        s = tl.program_id(1)
        o_lo = (s // SPLITS1) * PER2
        o_hi = tl.minimum(N2, o_lo + PER2)
        i_lo = (s % SPLITS1) * PER1
        i_hi = tl.minimum(N1, i_lo + PER1)
        if IS_INT:
            acc = tl.full([GROUPS, VEC], NEUTRAL, tl.int32)
            edge = tl.full([VEC], NEUTRAL, tl.int32)
        else:
            acc = tl.full([GROUPS, VEC], NEUTRAL, tl.float32)
            edge = tl.full([VEC], NEUTRAL, tl.float32)
        lane = tl.arange(0, VEC)
        grp = tl.arange(0, GROUPS)
        for o in range(o_lo, o_hi):
            base = k.to(tl.int64) * SK + o.to(tl.int64) * S2
            lo = base + i_lo
            hi = base + i_hi
            g_lo = (lo + VEC - 1) // VEC        # first whole group
            g_hi = hi // VEC                    # past the last whole group
            head = g_lo * VEC - VEC + lane
            v = tl.load(X + head, mask=(head >= lo) & (head < hi),
                        other=NEUTRAL)
            edge = _combine(edge, v.to(acc.dtype), OP)
            tail = tl.maximum(g_hi, g_lo) * VEC + lane
            v = tl.load(X + tail, mask=tail < hi, other=NEUTRAL)
            edge = _combine(edge, v.to(acc.dtype), OP)
            for g0 in range(g_lo, g_hi, GROUPS):
                gi = g0 + grp
                offs = gi[:, None] * VEC + lane[None, :]
                body = tl.load(X + offs, mask=(gi < g_hi)[:, None],
                               other=NEUTRAL)
                acc = _combine(acc, body.to(acc.dtype), OP)
        res = _combine(_collapse(_collapse(acc, 0, OP), 0, OP),
                       _collapse(edge, 0, OP), OP)
        tl.store(Y + s.to(tl.int64) * K + k, res.to(Y.dtype.element_ty))

    # a block of BLOCK_K kept indices a program (axis 0) and a slice of R
    # (axis 1), in (BLOCK_K, BLOCK_R) tiles over (K, R1)
    @triton.jit(do_not_specialize=["N1", "N2", "PER1", "PER2", "SPLITS1"])
    def lg_reduce_tiles(X, Y, K, N1, N2, SK, S1, S2, PER1, PER2, SPLITS1,
                     OP: tl.constexpr, IS_INT: tl.constexpr,
                     NEUTRAL: tl.constexpr, BLOCK_K: tl.constexpr,
                     BLOCK_R: tl.constexpr):
        ks = tl.program_id(0) * BLOCK_K + tl.arange(0, BLOCK_K)
        s = tl.program_id(1)
        kmask = ks < K
        o_lo = (s // SPLITS1) * PER2
        o_hi = tl.minimum(N2, o_lo + PER2)
        i_lo = (s % SPLITS1) * PER1
        i_hi = tl.minimum(N1, i_lo + PER1)
        if IS_INT:
            acc = tl.full([BLOCK_K, BLOCK_R], NEUTRAL, tl.int32)
        else:
            acc = tl.full([BLOCK_K, BLOCK_R], NEUTRAL, tl.float32)
        rows = X + ks[:, None].to(tl.int64) * SK
        for o in range(o_lo, o_hi):
            base = rows + o.to(tl.int64) * S2
            for r0 in range(i_lo, i_hi, BLOCK_R):
                rs = r0 + tl.arange(0, BLOCK_R)
                v = tl.load(base + rs[None, :].to(tl.int64) * S1,
                            mask=kmask[:, None] & (rs < i_hi)[None, :],
                            other=NEUTRAL)
                acc = _combine(acc, v.to(acc.dtype), OP)
        res = _collapse(acc, 1, OP)
        tl.store(Y + s.to(tl.int64) * K + ks, res.to(Y.dtype.element_ty),
                 mask=kmask)

    # the second stage: out[k] = the S partials of column k, in a fixed
    # order (BLOCK_S at a time, then one tree over the block)
    @triton.jit(do_not_specialize=["S"])
    def lg_reduce_finish(P, Y, K, S, OP: tl.constexpr, NEUTRAL: tl.constexpr,
                      BLOCK_S: tl.constexpr, BLOCK_K: tl.constexpr):
        ks = tl.program_id(0) * BLOCK_K + tl.arange(0, BLOCK_K)
        kmask = ks < K
        acc = tl.full([BLOCK_S, BLOCK_K], NEUTRAL, P.dtype.element_ty)
        for s0 in range(0, S, BLOCK_S):
            ss = s0 + tl.arange(0, BLOCK_S)
            v = tl.load(P + ss[:, None].to(tl.int64) * K + ks[None, :],
                        mask=(ss < S)[:, None] & kmask[None, :],
                        other=NEUTRAL)
            acc = _combine(acc, v, OP)
        tl.store(Y + ks, _collapse(acc, 0, OP).to(Y.dtype.element_ty),
                 mask=kmask)

    _kernels = (lg_reduce_rows, lg_reduce_tiles, lg_reduce_finish)
    return _kernels


@lru_cache(maxsize=None)
def _n_sm(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def reduce(x, op: str, axis=None, keepdims: bool = False):
    """``op`` in sum / max / min over ``axis`` (None: all): the Triton
    kernels on CUDA tensors, :func:`reduce_reference` on CPU tensors."""
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
    shape = _out_shape(x.shape, axes, keepdims)
    k = prod(x.shape[d] for d in range(rank) if d not in axes)
    r = prod(x.shape[d] for d in axes)
    if k == 0 or r == 0:
        if r == 0 and op != "sum":
            raise ValueError(f"reduce: {op} over an empty axis")
        return torch.zeros(shape, device=x.device, dtype=x.dtype)
    n_sm = _n_sm(x.device)
    plan = _cached_plan(tuple(x.shape), x.stride(), axes, x.element_size(),
                        n_sm)
    if plan is None:
        # no walk of up to three strides covers this layout: transposed copy
        keep = [d for d in range(rank) if d not in axes]
        x = x.permute(*keep, *axes).contiguous()
        plan = _cached_plan(tuple(x.shape), x.stride(),
                            tuple(range(len(keep), rank)), x.element_size(),
                            n_sm)
    y = torch.empty(shape, device=x.device, dtype=x.dtype)
    splits = plan.splits1 * plan.splits2
    part = y if splits == 1 else torch.empty(
        (splits, k), device=x.device,
        dtype=torch.int32 if x.dtype == torch.int32 else torch.float32)
    rows, tiles, finish = _triton_kernels()
    kw = dict(OP=_OPS.index(op), IS_INT=x.dtype == torch.int32,
              NEUTRAL=_neutral(op, x.dtype), num_warps=plan.warps)
    with torch.cuda.device(x.device):
        if plan.kind == "rows":
            vec = 16 // x.element_size()
            rows[(k, splits)](x, part, k, plan.n1, plan.n2, plan.sk, plan.s2,
                              plan.per1, plan.per2, plan.splits1, VEC=vec,
                              GROUPS=plan.block_r // vec, **kw)
        else:
            tiles[(_cdiv(k, plan.block_k), splits)](
                x, part, k, plan.n1, plan.n2, plan.sk, plan.s1, plan.s2,
                plan.per1, plan.per2, plan.splits1, BLOCK_K=plan.block_k,
                BLOCK_R=plan.block_r, **kw)
        runtime.count_launch("reduce")
        if splits > 1:
            block_k = _finish_block(k, n_sm)
            block_s = min(_pow2(splits), 4096 // block_k)
            finish[(_cdiv(k, block_k),)](
                part, y, k, splits, OP=kw["OP"], NEUTRAL=kw["NEUTRAL"],
                BLOCK_S=block_s, BLOCK_K=block_k, num_warps=4)
            runtime.count_launch("reduce")
    return y
