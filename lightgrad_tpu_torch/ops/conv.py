"""N-D convolution: the CUDA implicit-GEMM kernels and their plain twins.

Counterpart of ``lightgrad_tpu/ops/conv.py`` (kernel 4: ``_conv_fwd_impl``,
``_conv_bwd_impl`` and ``_group_matmul``, a patch matrix of XLA slices fed
to the Pallas GEMM).  Layouts follow the JAX package: x ``(B, Cin, *S)``, w
``(Cout, Cin/groups, *K)``, output ``(B, Cout, *S_out)``, 1-, 2- or 3-D,
VALID padding (the caller pads), int or tuple ``strides`` and
``dilation``, any ``groups`` (depthwise included).

On CUDA tensors :func:`conv_fwd` launches ``lg_conv_fwd``, and
:func:`conv_bwd` the input and weight gradients :func:`conv_bwd_dx`
(``lg_conv_bwd_dx``) and :func:`conv_bwd_dw` (``lg_conv_bwd_dw``) of
``csrc/conv.cu``: implicit GEMMs that gather their patches inside the
tile loads, with no patch matrix in device memory.  float32 is true float32
(no TF32, the JAX package's ``Precision.HIGHEST``); bfloat16 sums in
float32 and rounds once.  On CPU tensors they run
:func:`conv_fwd_reference` / :func:`conv_bwd_reference`, which follow the
JAX algorithm: patches by strided slices, a product per group, and the
tap-wise scatter-add of the input gradient.
"""

import ctypes
import itertools
from math import ceil, prod

import torch

from . import _build, runtime

__all__ = ["conv_fwd", "conv_bwd", "conv_bwd_dx", "conv_bwd_dw",
           "conv_fwd_reference", "conv_bwd_reference",
           "conv_bwd_dx_reference", "conv_bwd_dw_reference"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID = 65535
_BK = 16              # the kernels' K slice: a dw chunk is a multiple of it


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


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(name, fn, *args):
    err = fn(*args)
    _build.check(err, fn.__name__)
    runtime.count_launch(name)


def conv_fwd(x, w, strides=1, dilation=1, groups=1):
    """The convolution of ``x`` with ``w``: the CUDA kernel on CUDA tensors,
    :func:`conv_fwd_reference` on CPU tensors."""
    strides, dilation, out_sp = _shapes(x, w, strides, dilation, groups)
    if not x.is_cuda:
        return conv_fwd_reference(x, w, strides, dilation, groups)
    x, w = _operands(x, w)
    y = torch.empty((x.shape[0], w.shape[0], *out_sp), device=x.device,
                    dtype=x.dtype)
    geom = _geom(x.shape, w.shape, out_sp, strides, dilation, groups)
    with torch.cuda.device(x.device):
        _launch("conv_fwd", _build.library().lg_conv_fwd, x.data_ptr(),
                w.data_ptr(), y.data_ptr(), geom,
                int(x.dtype == torch.bfloat16), _stream(x))
    return y


def dw_split(rows, cols, groups, reduction, sms):
    """(splits, chunk) of the weight gradient's reduction over ``reduction``
    output positions: enough blocks for about four waves on ``sms``
    multiprocessors, chunks of at least 256 positions, a multiple of the
    kernel's 16-deep K slice."""
    tiles = ceil(rows / 64) * ceil(cols / 64) * groups
    want = max(1, ceil(4 * sms / tiles))
    chunk = max(256, ceil(reduction / want))
    chunk = ceil(chunk / _BK) * _BK
    while groups * ceil(reduction / chunk) > _MAX_GRID:
        chunk *= 2
    return ceil(reduction / chunk), chunk


def conv_bwd_dx(g, w, x_shape, strides=1, dilation=1, groups=1):
    """The input gradient of :func:`conv_fwd` for an input of shape
    ``x_shape`` and the output gradient ``g``: the CUDA kernel on CUDA
    tensors, :func:`conv_bwd_dx_reference` on CPU tensors."""
    if not g.is_cuda:
        return conv_bwd_dx_reference(g, w, x_shape, strides, dilation,
                                     groups)
    strides, dilation, out_sp, _, _ = _bwd_operands(
        g, w, strides, dilation, groups, x_shape, w.shape)
    g, w = _operands(g, w)
    gx = torch.empty(x_shape, device=g.device, dtype=g.dtype)
    geom = _geom(x_shape, w.shape, out_sp, strides, dilation, groups)
    with torch.cuda.device(g.device):
        _launch("conv_bwd_dx", _build.library().lg_conv_bwd_dx,
                g.data_ptr(), w.data_ptr(), gx.data_ptr(), geom,
                int(g.dtype == torch.bfloat16), _stream(g))
    return gx


def conv_bwd_dw(g, x, w_shape, strides=1, dilation=1, groups=1):
    """The weight gradient of :func:`conv_fwd` for a weight of shape
    ``w_shape`` and the output gradient ``g``: the CUDA kernels (the split
    reduction and its fixed-order sum) on CUDA tensors,
    :func:`conv_bwd_dw_reference` on CPU tensors."""
    if not g.is_cuda:
        return conv_bwd_dw_reference(g, x, w_shape, strides, dilation,
                                     groups)
    strides, dilation, out_sp, _, _ = _bwd_operands(
        g, x, strides, dilation, groups, x.shape, w_shape)
    g, x = _operands(g, x)
    geom = _geom(x.shape, w_shape, out_sp, strides, dilation, groups)
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    cout, cols = w_shape[0], prod(w_shape[1:])
    splits, chunk = dw_split(cout // groups, cols, groups,
                             x.shape[0] * prod(out_sp), sms)
    part = torch.empty((splits, cout * cols), device=g.device,
                       dtype=torch.float32)
    gw = torch.empty(w_shape, device=g.device, dtype=g.dtype)
    with torch.cuda.device(g.device):
        _launch("conv_bwd_dw", _build.library().lg_conv_bwd_dw,
                g.data_ptr(), x.data_ptr(), gw.data_ptr(), part.data_ptr(),
                geom, splits, chunk, int(g.dtype == torch.bfloat16),
                _stream(g))
    return gw


def conv_bwd(g, x, w, strides=1, dilation=1, groups=1, need_dx=True):
    """``(gx, gw)`` of :func:`conv_fwd` for the output gradient ``g``
    (``gx`` is None when ``need_dx`` is false)."""
    gx = conv_bwd_dx(g, w, x.shape, strides, dilation, groups) \
        if need_dx else None
    return gx, conv_bwd_dw(g, x, w.shape, strides, dilation, groups)
