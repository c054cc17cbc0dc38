"""Port parity: the conv kernel family.  The port's ``conv_fwd`` and
``conv_bwd`` (CPU plain versions: patches by strided slices, one product a
group, the tap-wise scatter-add) against ``lightgrad_tpu.ops.conv`` in
pallas (interpret) and xla modes: 1-, 2- and 3-D; strides 1 and 2 and
dilation 2; groups 1, 2 and depthwise; 1 and 3 input channels with ragged
channel and spatial sizes.  The JAX package's grouped backward takes XLA in
every mode (``conv.py:125``), so a grouped case compares with XLA there.
Also the pure-Python parts of the CUDA path: the kernels' geometry ints,
the weight gradient's split of its reduction, and the raising on calls no
convolution has."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgrad_tpu.ops.conv import conv_bwd as jax_conv_bwd
from lightgrad_tpu.ops.conv import conv_fwd as jax_conv_fwd
from lightgrad_tpu_torch.ops.conv import (_geom, conv_bwd,
                                          conv_bwd_reference, conv_fwd,
                                          conv_fwd_reference, dw_split)
from tests.torch_port import jax_kernel_mode, rand, to_np

# f32 on both sides (true f32 products); sums of up to 108 terms in another
# order
TOL = dict(rtol=2e-5, atol=2e-5)

# (x shape, w shape, strides, dilation, groups)
CASES = [
    ((2, 3, 17), (4, 3, 3), 1, 1, 1),                 # 1-D
    ((2, 3, 18), (5, 3, 4), 2, 1, 1),                 # 1-D, strided, ragged
    ((1, 4, 19), (4, 2, 3), 1, 2, 2),                 # 1-D, dilated, grouped
    ((2, 1, 11, 9), (6, 1, 3, 3), 1, 1, 1),           # MNIST's Cin = 1
    ((2, 3, 15, 13), (5, 3, 7, 7), 2, 1, 1),          # the stem: 7x7/s2
    ((2, 3, 12, 10), (4, 3, 3, 3), (2, 1), (1, 2), 1),  # anisotropic
    ((2, 6, 9, 9), (6, 3, 3, 3), 2, 1, 2),            # grouped, strided
    ((2, 5, 10, 11), (5, 1, 3, 3), 1, 2, 5),          # depthwise, dilated
    ((2, 4, 9, 8), (7, 4, 1, 1), 2, 1, 1),            # the 1x1/s2 projection
    ((1, 3, 5, 6, 7), (4, 3, 2, 3, 2), (1, 2, 1), 1, 1),  # 3-D
    ((2, 4, 6, 5, 7), (4, 2, 3, 2, 2), 1, (2, 1, 2), 2),  # 3-D, grouped
]


def _ids(case):
    xs, ws, st, dl, g = case
    return f"x{xs}-w{ws}-s{st}-d{dl}-g{g}".replace(" ", "")


def _inputs(xs, ws, seed=0):
    rng = np.random.default_rng(seed)
    return rand(rng, *xs), rand(rng, *ws, scale=0.3)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_conv_fwd_and_bwd_match_jax(case, mode):
    xs, ws, st, dl, g = case
    x, w = _inputs(xs, ws)
    with jax_kernel_mode(mode):
        want = np.asarray(jax_conv_fwd(jnp.asarray(x), jnp.asarray(w), st,
                                       dl, g))
        gy = rand(np.random.default_rng(1), *want.shape)
        jgx, jgw = jax_conv_bwd(jnp.asarray(gy), jnp.asarray(x),
                                jnp.asarray(w), st, dl, g)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = conv_fwd(tx, tw, st, dl, g)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(to_np(got), want, **TOL)
    gx, gw = conv_bwd(torch.from_numpy(gy), tx, tw, st, dl, g)
    assert gx.shape == tx.shape and gw.shape == tw.shape
    np.testing.assert_allclose(to_np(gx), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(to_np(gw), np.asarray(jgw), **TOL)


@pytest.mark.parametrize("case", CASES[1::2], ids=_ids)
def test_conv_matches_jax_autodiff_of_its_forward(case):
    """The backward is the gradient of the forward: jax.vjp of the JAX
    package's XLA forward against the port's plain backward."""
    xs, ws, st, dl, g = case
    x, w = _inputs(xs, ws, seed=2)
    with jax_kernel_mode("xla"):
        y, vjp = jax.vjp(lambda a, b: jax_conv_fwd(a, b, st, dl, g),
                         jnp.asarray(x), jnp.asarray(w))
        gy = rand(np.random.default_rng(3), *y.shape)
        jgx, jgw = vjp(jnp.asarray(gy))
    gx, gw = conv_bwd_reference(torch.from_numpy(gy), torch.from_numpy(x),
                                torch.from_numpy(w), st, dl, g)
    np.testing.assert_allclose(to_np(gx), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(to_np(gw), np.asarray(jgw), **TOL)


def test_bf16_and_f64_keep_their_dtype():
    """bf16 inputs sum in f32 and round once; float64 (the plain twins of
    the card's checks) stays float64 throughout."""
    x, w = _inputs((2, 3, 9, 9), (4, 3, 3, 3), seed=4)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    y = conv_fwd(xb, wb, 2)
    assert y.dtype == torch.bfloat16
    want = conv_fwd(xb.float(), wb.float(), 2).to(torch.bfloat16)
    assert torch.equal(y, want)
    x64, w64 = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    y64 = conv_fwd_reference(x64, w64, 2)
    gx, gw = conv_bwd_reference(torch.ones_like(y64), x64, w64, 2)
    assert y64.dtype == gx.dtype == gw.dtype == torch.float64
    torch.testing.assert_close(
        y64, torch.nn.functional.conv2d(x64, w64, stride=2))


def test_need_dx_false_skips_the_input_gradient():
    x, w = _inputs((2, 3, 8, 8), (4, 3, 3, 3), seed=5)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    gy = torch.ones(2, 4, 6, 6)
    gx, gw = conv_bwd(gy, tx, tw, need_dx=False)
    assert gx is None
    torch.testing.assert_close(gw, conv_bwd(gy, tx, tw)[1])


@pytest.mark.parametrize("xs,ws,st,dl,g,msg", [
    ((2, 3, 8, 8), (4, 2, 3, 3), 1, 1, 1, "groups"),     # Cin mismatch
    ((2, 4, 8, 8), (6, 1, 3, 3), 1, 1, 3, "groups"),     # 4 % 3
    ((2, 3, 4, 4), (4, 3, 5, 5), 1, 1, 1, "exceeds"),    # kernel too big
    ((2, 3, 8, 8), (4, 3, 3, 3), 0, 1, 1, "strides"),
    ((2, 3, 8), (4, 3, 3, 3), 1, 1, 1, "spatial dims"),
])
def test_calls_no_convolution_has_raise(xs, ws, st, dl, g, msg):
    x, w = torch.zeros(xs), torch.zeros(ws)
    with pytest.raises(ValueError, match=msg):
        conv_fwd(x, w, st, dl, g)


@pytest.mark.parametrize("xs,ws,st,dl,want", [
    ((2, 3, 17), (4, 3, 3), 2, 1,
     (2, 3, 4, 1, 1, 1, 17, 1, 1, 8, 1, 1, 3, 1, 1, 2, 1, 1, 1)),
    ((32, 64, 58, 58), (128, 64, 3, 3), 2, 1,
     (32, 64, 128, 1, 1, 58, 58, 1, 28, 28, 1, 3, 3, 1, 2, 2, 1, 1, 1)),
    ((1, 3, 5, 6, 7), (4, 3, 2, 3, 2), (1, 2, 1), (1, 1, 2),
     (1, 3, 4, 1, 5, 6, 7, 4, 2, 5, 2, 3, 2, 1, 2, 1, 1, 1, 2)),
])
def test_kernel_geometry_pads_to_three_spatial_dims(xs, ws, st, dl, want):
    n = len(xs) - 2
    st_n = (st,) * n if isinstance(st, int) else st
    dl_n = (dl,) * n if isinstance(dl, int) else dl
    y = conv_fwd_reference(torch.zeros(xs), torch.zeros(ws), st_n, dl_n)
    geom = _geom(xs, ws, tuple(y.shape[2:]), st_n, dl_n, 1)
    assert tuple(geom) == want


@pytest.mark.parametrize("rows,cols,groups,reduction", [
    (64, 576, 1, 100352),       # ResNet-18 layer 1 at batch 32
    (64, 147, 1, 401408),       # the stem
    (512, 4608, 1, 1568),       # layer 4: M = B*7*7 is small
    (1, 9, 512, 1000),          # depthwise
    (8, 9, 1, 7),               # fewer positions than one slice
    (1, 9, 60000, 1 << 20),     # groups x splits capped by the grid
])
def test_weight_gradient_split_covers_the_reduction(rows, cols, groups,
                                                    reduction):
    splits, chunk = dw_split(rows, cols, groups, reduction, 132)
    assert chunk % 16 == 0 and chunk >= 256
    assert (splits - 1) * chunk < reduction <= splits * chunk
    assert groups * splits <= 65535
    if reduction >= 100000 and groups == 1:   # enough blocks to fill 132 SMs
        assert splits * -(-rows // 64) * -(-cols // 64) >= 132
