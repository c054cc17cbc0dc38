"""Port parity: the tensor-core conv kernels' decomposition (csrc/conv_tc.cu).

A plain PyTorch model of what the kernels compute, built from the wrapper's
own planning (``conv_plan``: staged channels, tile width, splits) and
staging (``conv_layout``): x and dy channels-last, the reduction over
(kd, kh, kw, c) with c fastest, the stem's channels padded with zeros to
the 16-byte copy width, the input gradient a residue class of the stride at
a time over only the taps that reach it, and each reduction split into
ranges of whole stages summed in split order.  The model is held against
``conv_fwd_reference`` / ``conv_bwd_reference`` and against the JAX
package's ``conv_fwd`` / ``conv_bwd`` in pallas (interpret) and xla modes,
under both dtypes' plans (float32: 32-deep stages, copies of 4 channels;
bf16: 64-deep, 8), computed in float32.  Also the pure functions that
choose the route, the tile and the splits.
"""

import itertools
from math import prod

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgrad_tpu.ops.conv import conv_bwd as jax_conv_bwd
from lightgrad_tpu.ops.conv import conv_fwd as jax_conv_fwd
from lightgrad_tpu_torch.ops.conv import (_shapes, conv_bwd_reference,
                                          conv_fwd_reference, conv_layout,
                                          conv_plan, conv_route,
                                          conv_splits, staged_channels,
                                          tile_width)
from lightgrad_tpu_torch.ops.matmul import tf32_round
from tests.torch_port import jax_kernel_mode, rand, to_np

# float32 on every side; sums of up to a few hundred terms in another order
TOL = dict(rtol=3e-5, atol=3e-5)
STAGE_K = {torch.float32: 32, torch.bfloat16: 64}
PLANS = [torch.float32, torch.bfloat16]

# (x shape, w shape, strides, dilation, groups): shapes the tensor-core
# route takes in both dtypes
CASES = [
    ((2, 3, 23, 21), (32, 3, 7, 7), 2, 1, 1),         # the stem: 3 -> 4 / 8
    ((2, 16, 11, 10), (32, 16, 3, 3), 2, 1, 1),       # 3x3/s2
    ((2, 16, 9, 8), (32, 16, 1, 1), 2, 1, 1),         # the 1x1/s2 projection
    ((2, 16, 13, 12), (32, 16, 3, 3), 1, 2, 1),       # dilated
    ((2, 32, 9, 9), (64, 16, 3, 3), (2, 1), 1, 2),    # grouped, Cg 16
    ((2, 16, 21), (32, 16, 5), 2, 1, 1),              # 1-D
    ((1, 8, 5, 7, 6), (32, 8, 3, 2, 3), (1, 2, 1), (2, 1, 1), 1),  # 3-D
]


def _ids(case):
    xs, ws, st, dl, g = case
    return f"x{xs}-w{ws}-s{st}-d{dl}-g{g}".replace(" ", "")


def _geometry(xs, ws, st, dl, g):
    x, w = torch.empty(xs, device="meta"), torch.empty(ws, device="meta")
    return _shapes(x, w, st, dl, g)


def _split_sum(a, b, splits, bk):
    """a (M, K) @ b (N, K)^T with K split into `splits` ranges of whole
    bk-deep stages (as csrc/conv_tc.cu: ceil(stages / splits) a split, the
    last ones possibly empty), each summed apart and then added in order
    from zero (sum_partials_kernel)."""
    k = a.shape[1]
    stages = -(-k // bk)
    per = -(-stages // splits)
    out = torch.zeros(a.shape[0], b.shape[0], dtype=a.dtype)
    for s in range(splits):
        lo, hi = min(k, s * per * bk), min(k, (s + 1) * per * bk)
        out = out + a[:, lo:hi] @ b[:, lo:hi].T
    return out


def _stage_x(x, cp, g, split=False):
    """x (B, Cin, *S) -> channels-last (B, *S, G * cp), as conv_layout (with
    ``split``: its tf32 (hi, lo) parts)."""
    bsz, cin, *sp = x.shape
    out = conv_layout(x.contiguous(), bsz, cin, prod(sp), g * cp, split)
    return tuple(t.reshape(bsz, *sp, g * cp) for t in out) if split \
        else out.reshape(bsz, *sp, g * cp)


def _pad3(t, n):
    """A channels-last (B, *S, C) tensor with unit leading spatial dims up
    to 3, as the kernels see 1-D and 2-D convolutions."""
    return t.reshape(t.shape[0], *(1,) * (3 - n), *t.shape[1:])


def _tap_slices(kidx, st, dl, out_sp):
    return tuple(slice(k * d, k * d + s * (o - 1) + 1, s)
                 for k, d, s, o in zip(kidx, dl, st, out_sp))


def _patches(xs, grp, cp, ksize, st, dl, out_sp):
    """The forward's A operand (M, KK * cp) from staged x: rows the output
    positions, columns (kd, kh, kw, c) with c fastest."""
    cols = []
    for kidx in itertools.product(*[range(k) for k in ksize]):
        sl = _tap_slices(kidx, st, dl, out_sp)
        cols.append(xs[(slice(None),) + sl][..., grp * cp:(grp + 1) * cp]
                    .reshape(-1, cp))
    return torch.stack(cols, 1).reshape(-1, len(cols) * cp)


def model_fwd(x, w, st, dl, g, plan_dtype, splits=None, passes=None):
    """y as csrc/conv_tc.cu's forward computes it.  ``passes``: the f32
    kernel's tf32 products of the staged hi and lo parts, summed in
    float64 -- ("hh", "hl", "lh") its three, ("hh",) one pass."""
    st, dl, out_sp = _geometry(x.shape, w.shape, st, dl, g)
    plan = conv_plan("fwd", x.shape, w.shape, out_sp, st, dl, g, plan_dtype,
                     132)
    cp, splits = plan["cp"], splits or plan["splits"]
    cout, cg, ksize = w.shape[0], w.shape[1], tuple(w.shape[2:])
    og, kk = cout // g, prod(ksize)
    if passes:
        parts = dict(zip("hl", _stage_x(x, cp, g, True)))
        wparts = dict(zip("hl", (t.reshape(cout, kk * cp) for t in conv_layout(
            w.contiguous(), cout, cg, kk, cp, True))))
        return sum(model_fwd_pair(parts[p[0]], wparts[p[1]], x.shape[0], cp,
                                  ksize, st, dl, out_sp, g)
                   for p in passes).float()
    xs = _stage_x(x, cp, g)
    ws = conv_layout(w.contiguous(), cout, cg, kk, cp).reshape(cout, kk * cp)
    outs = []
    for grp in range(g):
        a = _patches(xs, grp, cp, ksize, st, dl, out_sp)
        assert a.shape[1] == plan["k"]
        outs.append(_split_sum(a, ws[grp * og:(grp + 1) * og], splits,
                               STAGE_K[plan_dtype]))
    y = torch.cat(outs, 1).reshape(x.shape[0], *out_sp, cout)
    return y.movedim(-1, 1)


def model_fwd_pair(xs, ws, bsz, cp, ksize, st, dl, out_sp, g):
    """One tf32 product of the forward, patches of staged ``xs`` against
    staged weight rows ``ws``, in float64, NCHW."""
    og = ws.shape[0] // g
    outs = [_patches(xs.double(), grp, cp, ksize, st, dl, out_sp)
            @ ws[grp * og:(grp + 1) * og].double().T for grp in range(g)]
    return torch.cat(outs, 1).reshape(bsz, *out_sp, -1).movedim(-1, 1)


def taps_for(r, k, s, d):
    """csrc/conv_common.cuh's taps_for: (k0, p, n), the taps k0 + j p (j <
    n) of one dimension whose offset k d is r modulo s."""
    p = next((i for i in range(1, s) if i * d % s == 0), s)
    for k0 in range(min(p, k)):
        if k0 * d % s == r:
            return k0, p, (k - 1 - k0) // p + 1
    return 0, p, 0


def model_dx(gy, w, x_shape, st, dl, g, plan_dtype, splits=None):
    """gx as csrc/conv_tc.cu's input gradient computes it: a residue class
    of the stride at a time, each position written once."""
    st, dl, out_sp = _geometry(x_shape, w.shape, st, dl, g)
    plan = conv_plan("dx", x_shape, w.shape, out_sp, st, dl, g, plan_dtype,
                     132)
    splits = splits or plan["splits"]
    n = len(out_sp)
    bsz, cin, *sp = x_shape
    cout, cg, ksize = w.shape[0], w.shape[1], tuple(w.shape[2:])
    og, kk = cout // g, prod(ksize)
    ys = _pad3(conv_layout(gy.contiguous(), bsz, cout, prod(out_sp), cout)
               .reshape(bsz, *out_sp, cout), n)
    wt = conv_layout(w.contiguous(), g, og, cg * kk, og).reshape(g, cg, kk,
                                                                  og)
    sp3, st3, dl3 = ((1,) * (3 - n) + tuple(v) for v in (sp, st, dl))
    k3, o3 = (1,) * (3 - n) + ksize, (1,) * (3 - n) + tuple(out_sp)
    gx = torch.full((bsz, cin, *sp3), float("nan"))
    for res in itertools.product(*[range(s) for s in st3]):
        taps = [taps_for(r, k, s, d) for r, k, s, d in zip(res, k3, st3, dl3)]
        cls = [range(r, size, s) for r, size, s in zip(res, sp3, st3)]
        cdims = [len(c) for c in cls]
        for grp in range(g):
            cols_a, cols_b = [], []
            for j in itertools.product(*[range(t[2]) for t in taps]):
                kidx = [t[0] + jj * t[1] for t, jj in zip(taps, j)]
                q = [(k * d - r) // s for k, d, r, s in
                     zip(kidx, dl3, res, st3)]
                # dy at (class index - q), zero outside
                a = torch.zeros(bsz, *cdims, og)
                lo = [max(0, qq) for qq in q]
                hi = [min(cd, od + qq) for cd, od, qq in zip(cdims, o3, q)]
                dst = tuple(slice(a0, h) for a0, h in zip(lo, hi))
                src = tuple(slice(a0 - qq, h - qq) for a0, h, qq in
                            zip(lo, hi, q))
                a[(slice(None),) + dst] = ys[(slice(None),) + src][
                    ..., grp * og:(grp + 1) * og]
                cols_a.append(a.reshape(-1, og))
                tap = (kidx[0] * k3[1] + kidx[1]) * k3[2] + kidx[2]
                cols_b.append(wt[grp, :, tap, :])
            if cols_a:
                a = torch.cat(cols_a, 1)
                b = torch.cat(cols_b, 1)
                out = _split_sum(a, b, splits, STAGE_K[plan_dtype])
            else:        # a class no tap reaches (1x1/s2): zeros
                out = torch.zeros(bsz * prod(cdims), cg)
            out = out.reshape(bsz, *cdims, cg).movedim(-1, 1)
            idx = (slice(None), slice(grp * cg, (grp + 1) * cg)) + tuple(
                slice(r, None, s) for r, s in zip(res, st3))
            assert torch.isnan(gx[idx]).all()       # written once
            gx[idx] = out
    assert not torch.isnan(gx).any()                # every position
    return gx.reshape(x_shape)


def model_dw(gy, x, w_shape, st, dl, g, plan_dtype, splits=None):
    """gw as csrc/conv_tc.cu's weight gradient computes it: gw^T (KK * cp,
    Og) = patches^T @ dy over the positions, split, padded channels
    dropped."""
    st, dl, out_sp = _geometry(x.shape, w_shape, st, dl, g)
    plan = conv_plan("dw", x.shape, w_shape, out_sp, st, dl, g, plan_dtype,
                     132)
    cp, splits = plan["cp"], splits or plan["splits"]
    cout, cg, ksize = w_shape[0], w_shape[1], tuple(w_shape[2:])
    og, kk, bsz = cout // g, prod(ksize), x.shape[0]
    xs = _stage_x(x, cp, g)
    ys = conv_layout(gy.contiguous(), bsz, cout, prod(out_sp), cout) \
        .reshape(-1, cout)
    gws = []
    for grp in range(g):
        a = _patches(xs, grp, cp, ksize, st, dl, out_sp)     # (R, KK cp)
        assert a.shape[1] == plan["m"] and a.shape[0] == plan["k"]
        gt = _split_sum(a.T, ys[:, grp * og:(grp + 1) * og].T, splits,
                        STAGE_K[plan_dtype])                 # (KK cp, og)
        gws.append(gt.reshape(kk, cp, og)[:, :cg].permute(2, 1, 0))
    return torch.cat(gws, 0).reshape(w_shape)


def _inputs(xs, ws, seed=0):
    rng = np.random.default_rng(seed)
    return rand(rng, *xs), rand(rng, *ws, scale=0.3)


@pytest.mark.parametrize("plan_dtype", PLANS, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_route_takes_the_cases(case, plan_dtype):
    xs, ws, st, dl, g = case
    assert conv_route(xs, ws, g, plan_dtype) == "tc"


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("plan_dtype", PLANS, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_model_matches_reference_and_jax(case, plan_dtype, mode):
    xs, ws, st, dl, g = case
    x, w = _inputs(xs, ws)
    with jax_kernel_mode(mode):
        want = np.asarray(jax_conv_fwd(jnp.asarray(x), jnp.asarray(w), st,
                                       dl, g))
        gy = rand(np.random.default_rng(1), *want.shape)
        jgx, jgw = jax_conv_bwd(jnp.asarray(gy), jnp.asarray(x),
                                jnp.asarray(w), st, dl, g)
    tx, tw, tg = (torch.from_numpy(a) for a in (x, w, gy))
    y = model_fwd(tx, tw, st, dl, g, plan_dtype)
    gx = model_dx(tg, tw, tx.shape, st, dl, g, plan_dtype)
    gw = model_dw(tg, tx, tw.shape, st, dl, g, plan_dtype)
    rgx, rgw = conv_bwd_reference(tg, tx, tw, st, dl, g)
    for got, ref, jax_ref in ((y, conv_fwd_reference(tx, tw, st, dl, g),
                               want), (gx, rgx, jgx), (gw, rgw, jgw)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(to_np(got), to_np(ref), **TOL)
        np.testing.assert_allclose(to_np(got), np.asarray(jax_ref), **TOL)


@pytest.mark.parametrize("splits", [2, 3, 7])
@pytest.mark.parametrize("case", CASES[1:4], ids=_ids)
def test_split_reduction_sums_in_a_fixed_order(case, splits):
    """Any split of the reduction agrees with the unsplit one, and the same
    split gives the same bits again (the partials are added in order)."""
    xs, ws, st, dl, g = case
    x, w = (torch.from_numpy(a) for a in _inputs(xs, ws, seed=3))
    y1 = model_fwd(x, w, st, dl, g, torch.float32, splits=1)
    gy = torch.from_numpy(rand(np.random.default_rng(4), *y1.shape))
    for model, args in ((model_fwd, (x, w)), (model_dx, (gy, w, x.shape)),
                        (model_dw, (gy, x, w.shape))):
        one = model(*args, st, dl, g, torch.float32, splits=1)
        many = model(*args, st, dl, g, torch.float32, splits=splits)
        np.testing.assert_allclose(to_np(many), to_np(one), **TOL)
        assert torch.equal(many, model(*args, st, dl, g, torch.float32,
                                       splits=splits))


@pytest.mark.parametrize("plan_dtype", PLANS, ids=["f32", "bf16"])
def test_stem_pads_its_channels_to_the_copy_width(plan_dtype):
    """The stem's 3 channels are staged as 4 (f32) or 8 (bf16), zeros past
    3, in x and in the weight; the reduction is 49 taps of them."""
    xs, ws = (2, 3, 23, 21), (32, 3, 7, 7)
    cp = staged_channels(3, 1, plan_dtype)
    assert cp == {torch.float32: 4, torch.bfloat16: 8}[plan_dtype]
    x, w = (torch.from_numpy(a) for a in _inputs(xs, ws, seed=5))
    xs_ = _stage_x(x, cp, 1)
    assert xs_.shape == (2, 23, 21, cp)
    assert torch.equal(xs_[..., :3], x.permute(0, 2, 3, 1))
    assert not xs_[..., 3:].any()
    st, dl, out_sp = _geometry(xs, ws, 2, 1, 1)
    plan = conv_plan("fwd", xs, ws, out_sp, st, dl, 1, plan_dtype, 132)
    assert plan["k"] == 49 * cp and plan["cp"] == cp


@pytest.mark.parametrize("case", CASES[:3] + CASES[4:5], ids=_ids)
def test_f32_is_three_tf32_passes_of_the_staged_parts(case):
    """The f32 forward and input gradient take x (dy) and the weight staged
    as tf32 hi and lo parts: hi hi + hi lo + lo hi is within a few f32 ulps
    of a float64 convolution, where one pass (hi hi) is not."""
    xs, ws, st, dl, g = case
    x, w = (torch.from_numpy(a) for a in _inputs(xs, ws, seed=6))
    want = conv_fwd_reference(x.double(), w.double(), st, dl, g)
    scale = want.abs().max().item()

    def err(passes):
        got = model_fwd(x, w, st, dl, g, torch.float32, passes=passes)
        return (got.double() - want).abs().max().item() / scale

    assert err(("hh", "hl", "lh")) < 2e-6 < err(("hh",))


def test_staged_tf32_parts():
    """conv_layout's split: hi and lo are tf32 (13 low mantissa bits zero),
    hi = tf32(x) and lo = tf32(x - hi), so hi + lo is x to about 2^-22."""
    t = torch.from_numpy(rand(np.random.default_rng(7), 2, 5, 7))
    hi, lo = conv_layout(t, 2, 5, 7, 8, split=True)
    raw = conv_layout(t, 2, 5, 7, 8)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi, tf32_round(raw))
    assert torch.equal(lo, tf32_round(raw - hi))
    assert ((hi + lo - raw).abs() <= 2.0 ** -21 * raw.abs()).all()
    with pytest.raises(TypeError, match="float32"):
        conv_layout(t.bfloat16(), 2, 5, 7, 8, split=True)


def test_layout_is_a_padded_transpose():
    t = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
    out = conv_layout(t, 2, 3, 5, 4)
    assert out.shape == (2, 5, 4)
    assert torch.equal(out[..., :3], t.transpose(1, 2))
    assert not out[..., 3].any()


@pytest.mark.parametrize("s,d", [(1, 1), (2, 1), (2, 2), (3, 2), (4, 6)])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_residue_classes_take_exactly_their_taps(k, s, d):
    """Each tap's offset k d falls in exactly one residue class modulo the
    stride, and taps_for lists exactly the taps of each class."""
    seen = []
    for r in range(s):
        k0, p, n = taps_for(r, k, s, d)
        got = [k0 + j * p for j in range(n)]
        assert got == [t for t in range(k) if t * d % s == r]
        seen += got
    assert sorted(seen) == list(range(k))


# ResNet-18's convolutions at batch 32, inputs after padding
RESNET18 = [
    ((32, 3, 230, 230), (64, 3, 7, 7), 2),
    ((32, 64, 58, 58), (64, 64, 3, 3), 1),
    ((32, 64, 58, 58), (128, 64, 3, 3), 2),
    ((32, 128, 30, 30), (128, 128, 3, 3), 1),
    ((32, 64, 56, 56), (128, 64, 1, 1), 2),
    ((32, 128, 30, 30), (256, 128, 3, 3), 2),
    ((32, 256, 16, 16), (256, 256, 3, 3), 1),
    ((32, 128, 28, 28), (256, 128, 1, 1), 2),
    ((32, 256, 16, 16), (512, 256, 3, 3), 2),
    ((32, 512, 9, 9), (512, 512, 3, 3), 1),
    ((32, 256, 14, 14), (512, 256, 1, 1), 2),
]


@pytest.mark.parametrize("dtype", PLANS, ids=["f32", "bf16"])
@pytest.mark.parametrize("xs,ws,st", RESNET18, ids=str)
def test_every_resnet18_conv_takes_the_tensor_cores(xs, ws, st, dtype):
    assert conv_route(xs, ws, 1, dtype) == "tc"
    stv, dl, out_sp = _geometry(xs, ws, st, 1, 1)
    for view in ("fwd", "dx", "dw"):
        plan = conv_plan(view, xs, ws, out_sp, stv, dl, 1, dtype, 132)
        assert 1 <= plan["splits"] <= max(1, plan["stages"] // 4)
        assert plan["bn"] in {torch.float32: (64, 128),
                              torch.bfloat16: (64, 128, 256)}[dtype]


# ResNet-20's convolutions on the digits path (batch 128, 28 x 28, one
# channel), inputs after padding, and the route each takes in both dtypes
RESNET20_DIGITS = [
    ((128, 1, 30, 30), (16, 1, 3, 3), 1, "simt"),      # the stem
    ((128, 16, 30, 30), (16, 16, 3, 3), 1, "simt"),
    ((128, 16, 30, 30), (32, 16, 3, 3), 2, "tc"),
    ((128, 16, 28, 28), (32, 16, 1, 1), 2, "tc"),
    ((128, 32, 16, 16), (32, 32, 3, 3), 1, "tc"),
    ((128, 32, 16, 16), (64, 32, 3, 3), 2, "tc"),
    ((128, 32, 14, 14), (64, 32, 1, 1), 2, "tc"),
    ((128, 64, 9, 9), (64, 64, 3, 3), 1, "tc"),
]


@pytest.mark.parametrize("dtype", PLANS, ids=["f32", "bf16"])
@pytest.mark.parametrize("xs,ws,st,route", RESNET20_DIGITS, ids=str)
def test_resnet20_digits_routes(xs, ws, st, route, dtype):
    """The 16-channel layers stay on the CUDA cores; every wider conv takes
    the tensor cores, its plan within the split rule (f32 16 channels: K
    144, four and a half stages)."""
    assert conv_route(xs, ws, 1, dtype) == route
    if route == "simt":
        return
    stv, dl, out_sp = _geometry(xs, ws, st, 1, 1)
    for view in ("fwd", "dx", "dw"):
        plan = conv_plan(view, xs, ws, out_sp, stv, dl, 1, dtype, 132)
        assert 1 <= plan["splits"] <= max(1, plan["stages"] // 4)


def test_conv_plan_is_memoised():
    """One plan a distinct call, whether the shapes come as torch.Size or
    tuples, equal to a fresh evaluation."""
    xs, ws = torch.Size((32, 64, 58, 58)), torch.Size((64, 64, 3, 3))
    args = ("dw", xs, ws, (56, 56), (1, 1), (1, 1), 1, torch.float32, 132)
    plan = conv_plan(*args)
    assert conv_plan("dw", tuple(xs), tuple(ws), *args[3:]) is plan
    assert conv_plan.__wrapped__(*args) == plan


@pytest.mark.parametrize("xs,ws,g,dtype,route", [
    ((128, 1, 30, 30), (8, 1, 3, 3), 1, torch.float32, "simt"),    # MNIST c1
    ((128, 8, 16, 16), (16, 8, 3, 3), 1, torch.float32, "simt"),   # MNIST c2
    ((128, 3, 34, 34), (16, 3, 3, 3), 1, torch.float32, "simt"),   # R-20 stem
    ((128, 16, 34, 34), (16, 16, 3, 3), 1, torch.float32, "simt"),
    ((128, 16, 34, 34), (32, 16, 3, 3), 1, torch.float32, "tc"),   # R-20 l2
    ((128, 32, 18, 18), (64, 32, 3, 3), 1, torch.bfloat16, "tc"),
    ((2, 2, 9, 9), (32, 2, 3, 3), 1, torch.float32, "tc"),      # 2 -> 4
    ((2, 2, 9, 9), (32, 2, 3, 3), 1, torch.bfloat16, "simt"),   # 2 -> 8
    ((2, 32, 9, 9), (32, 1, 3, 3), 32, torch.float32, "simt"),  # depthwise
    ((2, 64, 9, 9), (128, 16, 3, 3), 4, torch.bfloat16, "tc"),  # Cg 16
    ((2, 48, 9, 9), (128, 12, 3, 3), 4, torch.float32, "tc"),   # Cg 12
    ((2, 48, 9, 9), (128, 12, 3, 3), 4, torch.bfloat16, "simt"),
    ((2, 64, 9, 9), (36, 64, 3, 3), 1, torch.float32, "tc"),    # Og 36
    ((2, 64, 9, 9), (36, 64, 3, 3), 1, torch.bfloat16, "simt"),
    ((2048, 64, 256, 256), (64, 64, 3, 3), 1, torch.float32, "simt"),  # 2^31
])
def test_conv_route_rule(xs, ws, g, dtype, route):
    assert conv_route(xs, ws, g, dtype) == route


def test_tile_width_is_the_narrowest_that_holds_the_columns():
    assert [tile_width(n, torch.bfloat16) for n in (3, 64, 65, 128, 200,
                                                    512)] == \
        [64, 64, 128, 128, 256, 256]
    assert [tile_width(n, torch.float32) for n in (16, 64, 96, 512)] == \
        [64, 64, 128, 128]


@pytest.mark.parametrize("tiles,stages,bn,out,dtype,want", [
    (784, 9, 64, 6422528, torch.bfloat16, 1),     # layer 1 fwd: many tiles
    (3136, 7, 64, 25690112, torch.float32, 1),    # the stem: 7 stages
    (26, 72, 256, 802816, torch.bfloat16, None),  # layer 4 fwd: splits
    (5, 1568, 64, 36864, torch.bfloat16, None),   # layer 1 dw
])
def test_conv_splits(tiles, stages, bn, out, dtype, want):
    s = conv_splits(tiles, stages, bn, out, dtype, 132)
    assert 1 <= s <= max(1, min(128, stages // 4))
    if want is not None:
        assert s == want
    else:
        # few tiles over a long reduction: split until the card is busy,
        # within one wave of blocks
        assert s > 1 and tiles * s <= 2 * 132
