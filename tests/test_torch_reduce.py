"""Port parity: the reduce kernel family.  The port's ``reduce`` (CPU plain
version) against ``lightgrad_tpu.ops.reduce.reduce`` in pallas (interpret)
and xla modes, over ops x axes x keepdims x dtypes; the stride merging
the CUDA kernel is launched with (``_merge``); and the card's plan
(``_plan``: the three-stride walk, the split of R), evaluated on the CPU as
the kernels evaluate it."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.ops.reduce import reduce as jax_reduce
from lightgrad_tpu_torch.ops.reduce import _merge, reduce, reduce_reference
from tests.torch_port import jax_kernel_mode, to_np

# the module itself: the package's ``ops.reduce`` is the function
rmod = importlib.import_module("lightgrad_tpu_torch.ops.reduce")

# float32: sums of up to 300 elements in another order; bfloat16: inputs
# exact in bf16, f32 sums on both sides, one rounding of the result
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2),
       "int32": dict(rtol=0, atol=0)}


def _input(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-9, 10, (4, 5, 6)).astype(np.float32)
    if dtype == "float32":
        x += rng.standard_normal(x.shape).astype(np.float32)
    return x


# The JAX package's pallas kernel masks int32 max/min with a float +-inf
# that does not survive the cast to int32, so int32 max/min are held
# against its xla mode only.
_MODES = [(op, dtype, mode) for op in ("sum", "max", "min")
          for dtype in ("float32", "bfloat16", "int32")
          for mode in ("pallas", "xla")
          if not (dtype == "int32" and op != "sum" and mode == "pallas")]


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [None, 0, -1, (0, 1), (0, 2), 1])
@pytest.mark.parametrize("op,dtype,mode", _MODES)
def test_reduce_matches_jax(op, axis, keepdims, dtype, mode):
    x = _input(dtype)
    with jax_kernel_mode(mode):
        want = jax_reduce(jnp.asarray(x, dtype=dtype), op, axis=axis,
                          keepdims=keepdims)
    got = reduce(torch.from_numpy(x).to(getattr(torch, dtype)), op,
                 axis=axis, keepdims=keepdims)
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype)[6:] == str(want.dtype)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])


def test_reduce_of_a_view_and_empty_axes():
    """A transposed (strided) input reduces like its contiguous copy; no
    axes is the identity."""
    x = torch.from_numpy(_input("float32")).permute(2, 0, 1)
    torch.testing.assert_close(reduce(x, "sum", axis=(1, 2)),
                               x.contiguous().sum(dim=(1, 2)))
    assert reduce(x, "max", axis=()) is x


@pytest.mark.parametrize("sizes,strides,want", [
    ([8, 128], [98304, 768], (1024, 768)),     # leading axes of (8,128,768)
    ([768], [1], (768, 1)),
    ([8, 12], [98304, 64], None),              # heads of a transposed view
    ([4, 1, 5], [5, 7, 1], (20, 1)),           # size-1 dims are free
    ([3, 4], [0, 0], (12, 0)),                 # a broadcast (stride 0)
])
def test_merge_walks_axes_with_one_stride(sizes, strides, want):
    assert _merge(sizes, strides) == want


# --- the card's plan: the walk x[o * s2 + k * sk + i * s1] and its split --
N_SM = 132


def _walk(x, op, axes, plan):
    """The kernels' arithmetic on the CPU: each split slice reduced from
    ``x``'s storage by the plan's strides into an (S, K) partial, then the
    partials in slice order, as ``reduce_finish`` adds them."""
    flat = x.as_strided((x.untyped_storage().nbytes() // x.element_size(),),
                        (1,), 0)
    k = torch.arange(plan.k) * plan.sk + x.storage_offset()
    acc = x.dtype if x.dtype == torch.int32 else torch.float32
    parts = []
    for o_rng, i_rng in rmod._slices(plan):
        idx = (torch.tensor(list(o_rng))[:, None, None] * plan.s2
               + k[None, :, None]
               + torch.tensor(list(i_rng))[None, None, :] * plan.s1)
        vals = flat[idx].to(acc)
        parts.append(vals.sum((0, 2)) if op == "sum" else
                     getattr(torch, "a" + op)(vals, dim=(0, 2)))
    parts = torch.stack(parts)
    out = parts.sum(0) if op == "sum" else getattr(torch, "a" + op)(parts, 0)
    return out.to(x.dtype)


# (shape, axis, the view to take): BatchNorm's (0, 2, 3) over NCHW, a
# prefix, a suffix, axis=None, keepdims' axes, a transposed view's rows,
# a sliced (offset, strided) view
_LAYOUTS = [((4, 6, 5, 7), (0, 2, 3), None),
            ((6, 8, 12), (0, 1), None),
            ((6, 8, 12), (1, 2), None),
            ((5, 9, 33), None, None),
            ((3, 1, 40), (0, 2), None),
            ((12, 70), (0,), "t"),
            ((9, 40, 16), (0, 2), "slice")]


def _view(shape, how, dtype=torch.float32, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        -50, 50, shape).astype(np.float32)).to(dtype)
    if how == "t":
        return x.T
    if how == "slice":
        return x[1:, ::2]
    return x


@pytest.mark.parametrize("shape,axis,how", _LAYOUTS)
def test_plan_reads_the_layouts_in_place(shape, axis, how):
    """BatchNorm's NCHW (0, 2, 3), a prefix, a suffix, axis=None and views
    are walked where they lie: a plan, no transposed copy."""
    x = _view(shape, how)
    axes = rmod._normalize_axes(axis, x.dim())
    plan = rmod._plan(x.shape, x.stride(), axes, 4, N_SM)
    assert plan is not None
    assert plan.k * plan.n1 * plan.n2 == x.numel()


def test_plan_copies_only_unwalkable_layouts():
    """Kept axes that do not merge into one stride take the copy."""
    x = torch.zeros(4, 5, 6)
    assert rmod._plan(x.shape, x.stride(), (1,), 4, N_SM) is None
    y = x.permute(2, 0, 1)       # kept (6, 4) out of memory order
    assert rmod._plan(y.shape, y.stride(), (2,), 4, N_SM) is None


@pytest.mark.parametrize("shape,axis,how", _LAYOUTS + [
    ((4, 5, 6), (1,), None), ((64, 70), (1,), None),
    ((2, 3, 700), (2,), None)])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("min_slice", [32768, 64])
def test_plan_walk_matches_reference(shape, axis, how, op, dtype, min_slice,
                                     monkeypatch):
    """The plan's strides and slices, evaluated as the kernels evaluate
    them (one split at the default slice size, many at 64 bytes), give
    ``reduce_reference``'s result; an unwalkable layout through its
    transposed copy."""
    monkeypatch.setattr(rmod, "_MIN_SLICE_BYTES", min_slice)
    x = _view(shape, how, dtype)
    axes = rmod._normalize_axes(axis, x.dim())
    plan = rmod._plan(x.shape, x.stride(), axes, 4, N_SM)
    if plan is None:
        keep = [d for d in range(x.dim()) if d not in axes]
        x = x.permute(*keep, *axes).contiguous()
        axes = tuple(range(len(keep), x.dim()))
        plan = rmod._plan(x.shape, x.stride(), axes, 4, N_SM)
    want = reduce_reference(x, op, axis=axes)
    assert torch.equal(_walk(x, op, axes, plan), want.reshape(-1))


@pytest.mark.parametrize("shape,axes,itemsize", [
    ((8192, 768), (0,), 4), ((32, 64, 56, 56), (0, 2, 3), 4),
    ((32, 64, 56, 56), (0, 2, 3), 2), ((32, 512, 7, 7), (0, 2, 3), 4),
    ((32, 64, 56, 56), (0, 1, 2, 3), 2), ((1024, 30522), (1,), 4),
    ((4096, 8192), (0,), 2), ((5, 7), (0, 1), 4)])
def test_split_slices_cover_r_once_in_order(shape, axes, itemsize):
    """The split's slices partition R: every (o, i) in exactly one slice;
    the slices come in one fixed order (o outer, i inner) and fill the
    card's SMs several times over when K alone does not."""
    x = torch.empty(shape)
    plan = rmod._plan(shape, x.stride(), axes, itemsize, N_SM)
    slices = rmod._slices(plan)
    starts = [(o[0], i[0]) for o, i in slices]
    assert sorted(starts) == starts
    seen = [(o, i) for o_rng, i_rng in slices for o in o_rng for i in i_rng]
    assert len(seen) == len(set(seen)) == plan.n1 * plan.n2
    assert all(len(o) and len(i) for o, i in slices)
    assert slices == rmod._slices(
        rmod._plan(shape, x.stride(), axes, itemsize, N_SM))
    programs = -(-plan.k // plan.block_k) * plan.splits1 * plan.splits2
    total = plan.k * plan.n1 * plan.n2 * itemsize
    if total >= 8 * N_SM * rmod._MIN_SLICE_BYTES:
        assert programs >= 4 * N_SM, plan
    if plan.kind == "rows":
        assert plan.per1 % (16 // itemsize) == 0
