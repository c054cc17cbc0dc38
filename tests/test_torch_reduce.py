"""Port parity: the reduce kernel family.  The port's ``reduce`` (CPU plain
version) against ``lightgrad_tpu.ops.reduce.reduce`` in pallas (interpret)
and xla modes, over ops x axes x keepdims x dtypes; and the stride merging
the CUDA kernel is launched with (``_merge``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgrad_tpu.ops.reduce import reduce as jax_reduce
from lightgrad_tpu_torch.ops.reduce import _merge, reduce
from tests.torch_port import jax_kernel_mode, to_np

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
