"""N-D convolution: the CUDA implicit-GEMM kernels and their plain twins.

Counterpart of ``lightgrad_tpu/ops/conv.py`` (kernel 4: ``_conv_fwd_impl``,
``_conv_bwd_impl`` and ``_group_matmul``, a patch matrix of XLA slices fed
to the Pallas GEMM).  Layouts follow the JAX package: x ``(B, Cin, *S)``, w
``(Cout, Cin/groups, *K)``, output ``(B, Cout, *S_out)``, 1-, 2- or 3-D,
VALID padding (the caller pads), int or tuple ``strides`` and
``dilation``, any ``groups`` (depthwise included).

On CUDA tensors :func:`conv_fwd`, :func:`conv_bwd_dx` and :func:`conv_bwd_dw`
(and :func:`conv_bwd`, both gradients) launch one of two routes, chosen by
:func:`conv_route`, a pure function of the shapes and the dtype:

- ``"tc"``: ``csrc/conv_tc.cu`` on Hopper's tensor cores (the tape's
  matmul ring, ``csrc/gemm_core.cuh``): bf16 in one ``wgmma`` pass, float32
  as three tf32 passes (the JAX package's ``Precision.HIGHEST`` as the
  tape's matmul computes it).  The activation operand is first staged
  channels-last and the weight reordered by ``lg_conv_layout`` (counted as
  ``conv_layout``), in float32 forward and input gradient as tf32 hi and lo
  parts that the kernel copies straight to its tiles (the weight gradient,
  whose operands the kernel must transpose, splits raw f32 itself); the
  output is written NCHW by the kernel.  Launches
  count as ``conv_fwd``, ``conv_bwd_dx``, ``conv_bwd_dw``.  The rule: every
  output group has at least 32 channels and a multiple of the 16-byte copy
  width (4 float32, 8 bf16), every input group a multiple of it too, or,
  with ``groups == 1``, so many that padding them to it at most triples
  them (the 3-channel stem pads to 4 / 8), and every operand has fewer than
  2^31 elements.  Every convolution of ResNet-18 takes it.
- ``"simt"``: ``csrc/conv.cu`` on the CUDA cores, true float32 FFMA (no
  TF32), for everything else (MNIST's CNN, ResNet-20's 16-channel layers,
  depthwise convolutions).  Counted as ``conv_fwd_simt``,
  ``conv_bwd_dx_simt``, ``conv_bwd_dw_simt``.

Both gather patches inside their tile loads (no patch matrix in device
memory), take the input gradient a residue class of the stride at a time
(each position written once), and split long reductions over blocks into
float32 partials summed in a fixed order, so every result is the same bit
for bit on each run.  bfloat16 sums in float32 and rounds once.  On CPU
tensors they run :func:`conv_fwd_reference` / :func:`conv_bwd_reference`,
which follow the JAX algorithm: patches by strided slices, a product per
group, and the tap-wise scatter-add of the input gradient.
"""

import ctypes
import functools
import itertools
from math import ceil, prod

import torch

from . import _build, runtime
from .matmul import tf32_round

__all__ = ["conv_fwd", "conv_bwd", "conv_bwd_dx", "conv_bwd_dw",
           "conv_fwd_reference", "conv_bwd_reference",
           "conv_bwd_dx_reference", "conv_bwd_dw_reference", "conv_route",
           "conv_plan", "conv_layout", "conv_layout_reference"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID = 65535
_BK = 16              # csrc/conv.cu's K slice: a dw chunk is a multiple of it


def _norm(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _out_spatial(spatial, ksize, strides, dilation):
    return tuple(
        (s - ((k - 1) * dl + 1)) // st + 1
        for s, k, st, dl in zip(spatial, ksize, strides, dilation))


def _shapes(x, w, strides, dilation, groups):
    """(strides, dilation, output spatial) of a valid call; raises on a
    call no convolution has."""
    n = w.dim() - 2
    if n not in (1, 2, 3) or x.dim() != w.dim():
        raise ValueError(f"conv: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"must both be (B, C, *S) with 1-3 spatial dims")
    strides, dilation = _norm(strides, n), _norm(dilation, n)
    if len(strides) != n or len(dilation) != n or min(strides + dilation) < 1:
        raise ValueError(f"conv: strides {strides} / dilation {dilation} "
                         f"for {n}-D")
    if groups < 1 or x.shape[1] != w.shape[1] * groups \
            or w.shape[0] % groups:
        raise ValueError(f"conv: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"and groups={groups} disagree")
    out_sp = _out_spatial(x.shape[2:], w.shape[2:], strides, dilation)
    if min(out_sp) < 1:
        raise ValueError(f"conv: kernel {tuple(w.shape[2:])} (dilation "
                         f"{dilation}) exceeds the input {tuple(x.shape[2:])}")
    return strides, dilation, out_sp


def _acc_dtype(dt):
    return torch.float64 if dt == torch.float64 else torch.float32


def _tap_slices(kidx, strides, dilation, out_sp):
    """Input-side slices selecting kernel tap ``kidx``'s contributions."""
    return tuple(slice(ki * dl, ki * dl + st * od, st)
                 for ki, st, dl, od in zip(kidx, strides, dilation, out_sp))


def _taps(ksize):
    return itertools.product(*[range(k) for k in ksize])


def _patches(x, ksize, strides, dilation, out_sp):
    """x (B, C, *S) -> (B * prod(out_sp), C * prod(K)) patch matrix, each
    channel's taps contiguous."""
    n = len(ksize)
    cols = [x[(slice(None), slice(None))
              + _tap_slices(kidx, strides, dilation, out_sp)]
            for kidx in _taps(ksize)]
    stacked = torch.stack(cols, dim=-1)          # (B, C, *out_sp, K)
    perm = (0,) + tuple(range(2, 2 + n)) + (1, 2 + n)
    return stacked.permute(perm).reshape(x.shape[0] * prod(out_sp),
                                         x.shape[1] * prod(ksize))


def conv_fwd_reference(x, w, strides=1, dilation=1, groups=1):
    """Plain PyTorch forward: the patch matrix, then one product a group
    (float32 sums; float64 inputs stay float64)."""
    strides, dilation, out_sp = _shapes(x, w, strides, dilation, groups)
    dt = torch.promote_types(x.dtype, w.dtype)
    acc = _acc_dtype(dt)
    cout = w.shape[0]
    pm = _patches(x.to(acc), w.shape[2:], strides, dilation, out_sp)
    pm = pm.reshape(pm.shape[0], groups, -1).transpose(0, 1)
    wm = w.to(acc).reshape(groups, cout // groups, -1).transpose(1, 2)
    out = torch.matmul(pm, wm)                   # (G, R, Cout/G)
    out = out.transpose(0, 1).reshape(x.shape[0], *out_sp, cout)
    return out.movedim(-1, 1).to(dt)


def _bwd_operands(g, t, strides, dilation, groups, x_shape, w_shape):
    """(strides, dilation, out_sp, float type, sum type) of a backward call
    whose gradient ``g`` must have the forward's output shape."""
    x, w = torch.empty(x_shape, device="meta"), torch.empty(w_shape,
                                                           device="meta")
    strides, dilation, out_sp = _shapes(x, w, strides, dilation, groups)
    if tuple(g.shape) != (x_shape[0], w_shape[0], *out_sp):
        raise ValueError(f"conv_bwd: gradient {tuple(g.shape)} for output "
                         f"{(x_shape[0], w_shape[0], *out_sp)}")
    dt = torch.promote_types(g.dtype, t.dtype)
    return strides, dilation, out_sp, dt, _acc_dtype(dt)


def conv_bwd_dx_reference(g, w, x_shape, strides=1, dilation=1, groups=1):
    """Plain PyTorch input gradient: ``g @ w`` a group, scattered back tap
    by tap into an input of shape ``x_shape``."""
    strides, dilation, out_sp, dt, acc = _bwd_operands(
        g, w, strides, dilation, groups, x_shape, w.shape)
    n, (bsz, cin), cout = len(out_sp), x_shape[:2], w.shape[0]
    ksize = tuple(w.shape[2:])
    rows = bsz * prod(out_sp)
    gf = g.to(acc).movedim(1, -1).reshape(rows, groups, cout // groups)
    wm = w.to(acc).reshape(groups, cout // groups, -1)
    gcols = torch.matmul(gf.transpose(0, 1), wm).transpose(0, 1)
    gcols = gcols.reshape(bsz, *out_sp, cin, *ksize).movedim(1 + n, 1)
    gx = torch.zeros(x_shape, dtype=acc, device=g.device)
    for kidx in _taps(ksize):
        sl = _tap_slices(kidx, strides, dilation, out_sp)
        gx[(slice(None), slice(None)) + sl] += gcols[(Ellipsis,) + kidx]
    return gx.to(dt)


def conv_bwd_dw_reference(g, x, w_shape, strides=1, dilation=1, groups=1):
    """Plain PyTorch weight gradient: ``g^T @ patches`` a group."""
    strides, dilation, out_sp, dt, acc = _bwd_operands(
        g, x, strides, dilation, groups, x.shape, w_shape)
    cout, rows = w_shape[0], x.shape[0] * prod(out_sp)
    gf = g.to(acc).movedim(1, -1).reshape(rows, groups, cout // groups)
    pm = _patches(x.to(acc), tuple(w_shape[2:]), strides, dilation, out_sp)
    pm = pm.reshape(rows, groups, -1).transpose(0, 1)   # (G, R, Cg*K)
    return torch.matmul(gf.permute(1, 2, 0), pm).reshape(w_shape).to(dt)


def conv_bwd_reference(g, x, w, strides=1, dilation=1, groups=1):
    """Plain PyTorch ``(gx, gw)``."""
    return (conv_bwd_dx_reference(g, w, x.shape, strides, dilation, groups),
            conv_bwd_dw_reference(g, x, w.shape, strides, dilation, groups))


def _operands(*ts):
    """The CUDA tensors in their common dtype, contiguous; raises on what
    the kernels do not take."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    dev = ts[0].device
    if dt not in _DTYPES or any(t.device != dev for t in ts):
        raise TypeError(f"conv: operands must be float32/bfloat16 on one "
                        f"device, got "
                        f"{[(t.dtype, str(t.device)) for t in ts]}")
    return tuple(t.to(dt).contiguous() for t in ts)


def _geom(x_shape, w_shape, out_sp, strides, dilation, groups):
    """The kernels' 19 geometry ints: (B, Cin, Cout, G, D, H, W, OD, OH, OW,
    KD, KH, KW, sd, sh, sw, dd, dh, dw), 1-D and 2-D padded with leading
    unit dims."""
    lead = (1,) * (5 - len(x_shape))
    one = (1,) * (3 - len(out_sp))
    vals = (x_shape[0], x_shape[1], w_shape[0], groups,
            *lead, *x_shape[2:], *one, *out_sp, *lead, *w_shape[2:],
            *one, *strides, *one, *dilation)
    if max(vals) >= 2 ** 31:
        raise ValueError(f"conv: a dimension exceeds int32: {vals}")
    return (ctypes.c_int * len(vals))(*vals)


# --- the tensor-core route: shapes, tiles and splits (pure functions) ------
_VIEWS = {"fwd": 0, "dx": 1, "dw": 2}
# csrc/conv_tc.cu: 128-row tiles; tile widths by dtype; the depth of a stage
# (128 bytes of a row); the tensor-core rate of a stage's products
_TILE_M = 128
TILE_WIDTHS = {torch.float32: (64, 128), torch.bfloat16: (64, 128, 256)}
_STAGE_K = {torch.float32: 32, torch.bfloat16: 64}
# per multiprocessor of 132, at half the card's peak: bf16 at 989 TFLOP/s,
# float32 as three tf32 passes at 495
_SM_FLOPS = {torch.float32: 495e12 / 3 / 132 / 2,
             torch.bfloat16: 989e12 / 132 / 2}
_PARTIAL_BPS = 3e12      # a split's f32 partial, written and read back
_INT32 = 2 ** 31


def _copy_width(dtype):
    """Elements of one 16-byte copy."""
    return 16 // torch.tensor([], dtype=dtype).element_size()


def staged_channels(cg, groups, dtype):
    """Channels of a group of x as the tensor-core kernels read it: Cg when
    it is a multiple of the copy width; with one group, Cin padded with
    zeros up to it when that at most triples it (the stem: 3 -> 4 float32,
    8 bf16); None otherwise."""
    w = _copy_width(dtype)
    if cg % w == 0:
        return cg
    cp = -(-cg // w) * w
    return cp if groups == 1 and cp <= 3 * cg else None


def conv_route(x_shape, w_shape, groups, dtype):
    """'tc' (csrc/conv_tc.cu, tensor cores) or 'simt' (csrc/conv.cu, CUDA
    cores) for a call, from its shapes and dtype alone (the module's
    docstring states the rule)."""
    cin, cout = x_shape[1], w_shape[0]
    cg, og = cin // groups, cout // groups
    cp = staged_channels(cg, groups, dtype)
    if cp is None or og < 32 or og % _copy_width(dtype):
        return "simt"
    kk, bsz = prod(w_shape[2:]), x_shape[0]
    sizes = (bsz * prod(x_shape[2:]) * groups * cp, prod(x_shape),
             cout * kk * cp, bsz * cout * prod(x_shape[2:]))
    return "tc" if max(sizes) < _INT32 else "simt"


def tile_width(n, dtype):
    """The tile's columns for a GEMM N columns wide: the narrowest that
    holds them, else the widest."""
    widths = TILE_WIDTHS[dtype]
    return next((w for w in widths if w >= n), widths[-1])


def conv_splits(tiles, stages, bn, out_elems, dtype, sms):
    """Splits of a reduction of ``stages`` stages over ``tiles`` output
    tiles of ``bn`` columns: the count that minimises an estimate of the
    call's time, whole waves of blocks (one a multiprocessor) over the
    stages each split runs (plus two of pipeline fill), plus writing and
    reading each split's float32 partial of ``out_elems``.  At least 4
    stages a split, at most 128 splits."""
    stage_s = 2 * _TILE_M * bn * _STAGE_K[dtype] / _SM_FLOPS[dtype]

    def cost(s):
        waves = -(-tiles * s // sms)
        partials = 0 if s == 1 else 2 * s * out_elems * 4 / _PARTIAL_BPS
        return waves * (-(-stages // s) + 2) * stage_s + partials

    return min(range(1, max(1, min(128, stages // 4)) + 1), key=cost)


def _class_taps(k, s, d):
    """Taps of one dimension reaching the input positions of residue 0
    modulo the stride (the largest class), as csrc/conv_common.cuh's
    taps_for counts them."""
    return sum(1 for t in range(k) if (t * d) % s == 0)


@functools.lru_cache(maxsize=None)
def conv_plan(view, x_shape, w_shape, out_sp, strides, dilation, groups,
              dtype, sms):
    """The tensor-core kernels' GEMM for ``view`` ('fwd', 'dx', 'dw'):
    dict of ``cp`` (staged channels of a group of x), ``m``, ``n``, ``k``
    (a group's GEMM; dx: its largest residue class), ``blocks`` (output
    tiles over groups and classes), ``bn``, ``stages``, ``splits`` and
    ``part`` (the elements of a split's f32 partial: the output's, dw's
    gw^T with padded channels).  Memoised (the shapes are tuples): one
    dict a distinct call, which callers only read."""
    bsz, cin = x_shape[:2]
    cout, kk = w_shape[0], prod(w_shape[2:])
    cg, og = cin // groups, cout // groups
    cp = staged_channels(cg, groups, dtype)
    rows = bsz * prod(out_sp)
    if view == "fwd":
        m, n, k, grid_z, part = rows, og, kk * cp, groups, rows * cout
    elif view == "dx":
        m = bsz * prod(-(-s // st) for s, st in zip(x_shape[2:], strides))
        n = cg
        k = og * prod(_class_taps(kd, st, dl) for kd, st, dl in
                      zip(w_shape[2:], strides, dilation))
        grid_z, part = groups * prod(strides), prod(x_shape)
    else:
        m, n, k, grid_z, part = kk * cp, og, rows, groups, cout * kk * cp
    bn = tile_width(n, dtype)
    blocks = -(-m // _TILE_M) * -(-n // bn) * grid_z
    stages = -(-k // _STAGE_K[dtype])
    return dict(cp=cp, m=m, n=n, k=k, bn=bn, blocks=blocks, stages=stages,
                part=part,
                splits=conv_splits(blocks, stages, bn, part, dtype, sms))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(name, fn, *args):
    err = fn(*args)
    _build.check(err, fn.__name__)
    runtime.count_launch(name)


def conv_layout_reference(t, nb, r, c, p, split=False):
    """Plain PyTorch :func:`conv_layout`."""
    out = torch.zeros((nb, c, p), device=t.device, dtype=t.dtype)
    out[..., :r] = t.reshape(nb, r, c).transpose(1, 2)
    if not split:
        return out
    hi = tf32_round(out)
    return hi, tf32_round(out - hi)


def conv_layout(t, nb, r, c, p, split=False):
    """The tensor-core route's staging: contiguous ``t`` viewed as (nb, r,
    c) -> (nb, c, p) with out[b][j][i] = t[b][i][j], zero for r <= i < p
    (NCHW -> channels-last with channels padded to p; the weight's
    reorders).  With ``split`` (float32) the pair (hi, lo) of its tf32
    parts, hi = tf32(out) and lo = tf32(out - hi), which the f32 forward
    and input gradient take.  ``lg_conv_layout`` on CUDA tensors,
    :func:`conv_layout_reference` on CPU tensors."""
    if split and t.dtype != torch.float32:
        raise TypeError(f"conv_layout: split needs float32, got {t.dtype}")
    if not t.is_cuda:
        return conv_layout_reference(t, nb, r, c, p, split)
    outs = [torch.empty((nb, c, p), device=t.device, dtype=t.dtype)
            for _ in range(2 if split else 1)]
    ptrs = [None] + [o.data_ptr() for o in outs] if split \
        else [outs[0].data_ptr(), None, None]
    _launch("conv_layout", _build.library().lg_conv_layout, t.data_ptr(),
            *ptrs, nb, r, c, p, int(t.dtype == torch.bfloat16), _stream(t))
    return tuple(outs) if split else outs[0]


def _stage_x(x, cp, groups, split=False):
    """x (B, Cin, *S) channels-last, (B, S, G * Cp)."""
    bsz, cin = x.shape[:2]
    return conv_layout(x, bsz, cin, prod(x.shape[2:]), groups * cp, split)


def _stage_dy(g, split=False):
    """The output gradient (B, Cout, *OS) channels-last, (B, OS, Cout)."""
    bsz, cout = g.shape[:2]
    return conv_layout(g, bsz, cout, prod(g.shape[2:]), cout, split)


def _hl(staged):
    """(operand, its lo part or None) of a staging: the f32 forward and
    input gradient take tf32 (hi, lo) pairs, the rest one tensor."""
    return staged if isinstance(staged, tuple) else (staged, None)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(t):
    return _sm_count(t.device.index)


def _tc(view, a, b, out, geom, plan):
    """One tensor-core launch (and, when split or dw, the ordered sum) into
    ``out`` of the staged operands ``a`` and ``b`` (each a tensor or a
    tf32 (hi, lo) pair)."""
    (a, a_lo), (b, b_lo) = _hl(a), _hl(b)
    part = None
    if plan["splits"] > 1 or view == "dw":
        part = torch.empty((plan["splits"], plan["part"]), device=out.device,
                           dtype=torch.float32)
    _launch(f"conv_{'bwd_' if view != 'fwd' else ''}{view}",
            _build.library().lg_conv_tc, _VIEWS[view], a.data_ptr(),
            None if a_lo is None else a_lo.data_ptr(), b.data_ptr(),
            None if b_lo is None else b_lo.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), geom, plan["cp"],
            plan["bn"], plan["splits"], int(out.dtype == torch.bfloat16),
            _stream(out))


def conv_fwd(x, w, strides=1, dilation=1, groups=1):
    """The convolution of ``x`` with ``w``: the CUDA kernels of
    :func:`conv_route`'s route on CUDA tensors, :func:`conv_fwd_reference`
    on CPU tensors."""
    strides, dilation, out_sp = _shapes(x, w, strides, dilation, groups)
    if not x.is_cuda:
        return conv_fwd_reference(x, w, strides, dilation, groups)
    x, w = _operands(x, w)
    y = torch.empty((x.shape[0], w.shape[0], *out_sp), device=x.device,
                    dtype=x.dtype)
    geom = _geom(x.shape, w.shape, out_sp, strides, dilation, groups)
    lib = _build.library()
    with torch.cuda.device(x.device):
        if conv_route(x.shape, w.shape, groups, x.dtype) == "simt":
            _launch("conv_fwd_simt", lib.lg_conv_fwd, x.data_ptr(),
                    w.data_ptr(), y.data_ptr(), geom,
                    int(x.dtype == torch.bfloat16), _stream(x))
            return y
        plan = conv_plan("fwd", x.shape, w.shape, out_sp, strides, dilation,
                         groups, x.dtype, _sms(x))
        cout, cg = w.shape[:2]
        f32 = x.dtype == torch.float32
        ws = conv_layout(w, cout, cg, prod(w.shape[2:]), plan["cp"], f32)
        _tc("fwd", _stage_x(x, plan["cp"], groups, f32), ws, y, geom, plan)
    return y


def dw_split(rows, cols, groups, reduction, sms):
    """(splits, chunk) of the CUDA-core weight gradient's reduction over
    ``reduction`` output positions: enough blocks for about four waves on
    ``sms`` multiprocessors, chunks of at least 256 positions, a multiple of
    the kernel's 16-deep K slice."""
    tiles = ceil(rows / 64) * ceil(cols / 64) * groups
    want = max(1, ceil(4 * sms / tiles))
    chunk = max(256, ceil(reduction / want))
    chunk = ceil(chunk / _BK) * _BK
    while groups * ceil(reduction / chunk) > _MAX_GRID:
        chunk *= 2
    return ceil(reduction / chunk), chunk


def _dx(g, gs, w, x_shape, out_sp, strides, dilation, groups):
    """The input gradient on CUDA operands; ``gs``: the bf16 output
    gradient staged channels-last for the tensor-core route (None: stage
    it; f32 stages its own tf32 parts)."""
    gx = torch.empty(x_shape, device=g.device, dtype=g.dtype)
    geom = _geom(x_shape, w.shape, out_sp, strides, dilation, groups)
    lib = _build.library()
    if conv_route(x_shape, w.shape, groups, g.dtype) == "simt":
        _launch("conv_bwd_dx_simt", lib.lg_conv_bwd_dx, g.data_ptr(),
                w.data_ptr(), gx.data_ptr(), geom,
                int(g.dtype == torch.bfloat16), _stream(g))
        return gx
    plan = conv_plan("dx", x_shape, w.shape, out_sp, strides, dilation,
                     groups, g.dtype, _sms(g))
    og, f32 = w.shape[0] // groups, g.dtype == torch.float32
    wt = conv_layout(w, groups, og, prod(w.shape[1:]), og, f32)
    _tc("dx", _stage_dy(g, f32) if gs is None else gs, wt, gx, geom, plan)
    return gx


def _dw(g, gs, x, w_shape, out_sp, strides, dilation, groups):
    """The weight gradient on CUDA operands (``gs`` as :func:`_dx`'s)."""
    gw = torch.empty(w_shape, device=g.device, dtype=g.dtype)
    geom = _geom(x.shape, w_shape, out_sp, strides, dilation, groups)
    lib = _build.library()
    if conv_route(x.shape, w_shape, groups, g.dtype) == "simt":
        cout, cols = w_shape[0], prod(w_shape[1:])
        splits, chunk = dw_split(cout // groups, cols, groups,
                                 x.shape[0] * prod(out_sp), _sms(g))
        part = torch.empty((splits, cout * cols), device=g.device,
                           dtype=torch.float32)
        _launch("conv_bwd_dw_simt", lib.lg_conv_bwd_dw, g.data_ptr(),
                x.data_ptr(), gw.data_ptr(), part.data_ptr(), geom, splits,
                chunk, int(g.dtype == torch.bfloat16), _stream(g))
        return gw
    plan = conv_plan("dw", x.shape, w_shape, out_sp, strides, dilation,
                     groups, g.dtype, _sms(g))
    _tc("dw", _stage_x(x, plan["cp"], groups),
        _stage_dy(g) if gs is None else gs, gw, geom, plan)
    return gw


def conv_bwd_dx(g, w, x_shape, strides=1, dilation=1, groups=1):
    """The input gradient of :func:`conv_fwd` for an input of shape
    ``x_shape`` and the output gradient ``g``: the CUDA kernels on CUDA
    tensors, :func:`conv_bwd_dx_reference` on CPU tensors."""
    if not g.is_cuda:
        return conv_bwd_dx_reference(g, w, x_shape, strides, dilation,
                                     groups)
    strides, dilation, out_sp, _, _ = _bwd_operands(
        g, w, strides, dilation, groups, x_shape, w.shape)
    g, w = _operands(g, w)
    with torch.cuda.device(g.device):
        return _dx(g, None, w, tuple(x_shape), out_sp, strides, dilation,
                   groups)


def conv_bwd_dw(g, x, w_shape, strides=1, dilation=1, groups=1):
    """The weight gradient of :func:`conv_fwd` for a weight of shape
    ``w_shape`` and the output gradient ``g``: the CUDA kernels (a split
    reduction and its fixed-order sum) on CUDA tensors,
    :func:`conv_bwd_dw_reference` on CPU tensors."""
    if not g.is_cuda:
        return conv_bwd_dw_reference(g, x, w_shape, strides, dilation,
                                     groups)
    strides, dilation, out_sp, _, _ = _bwd_operands(
        g, x, strides, dilation, groups, x.shape, w_shape)
    g, x = _operands(g, x)
    with torch.cuda.device(g.device):
        return _dw(g, None, x, tuple(w_shape), out_sp, strides, dilation,
                   groups)


def conv_bwd(g, x, w, strides=1, dilation=1, groups=1, need_dx=True):
    """``(gx, gw)`` of :func:`conv_fwd` for the output gradient ``g``
    (``gx`` is None when ``need_dx`` is false); on the tensor-core route in
    bf16 both gradients read one channels-last staging of ``g``."""
    if not g.is_cuda:
        gx = conv_bwd_dx_reference(g, w, x.shape, strides, dilation,
                                   groups) if need_dx else None
        return gx, conv_bwd_dw_reference(g, x, w.shape, strides, dilation,
                                         groups)
    strides, dilation, out_sp, _, _ = _bwd_operands(
        g, x, strides, dilation, groups, x.shape, w.shape)
    g, x, w = _operands(g, x, w)
    with torch.cuda.device(g.device):
        gs = None
        if g.dtype == torch.bfloat16 and \
                conv_route(x.shape, w.shape, groups, g.dtype) == "tc":
            gs = _stage_dy(g)
        gx = _dx(g, gs, w, tuple(x.shape), out_sp, strides, dilation,
                 groups) if need_dx else None
        return gx, _dw(g, gs, x, tuple(w.shape), out_sp, strides, dilation,
                       groups)
