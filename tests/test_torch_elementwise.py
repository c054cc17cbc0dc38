"""Port parity: the elementwise kernel family.  Every body of the port's
``ew`` (CPU plain version) against the JAX package's ``ew`` over the same
body, in pallas (interpret) and xla modes, on broadcast shapes; ``n_out=2``;
the int32 / bfloat16 dtype promotion; Python scalars rounded as the JAX
package's ``_scalar`` rounds them; tape ops with scalars, views and
broadcasts against the JAX tape; and the CUDA kernel's launch plan
(``_plan``: merged dims, operand modes, tiles, copies) replayed in numpy
program by program, as the kernel computes its offsets and masks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgrad_tpu.autograd.tpu.ops as jax_ops
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.ops.elementwise import ew as jax_ew
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.autograd.cuda import ops as tape_ops
from lightgrad_tpu_torch.ops import elementwise as _unused  # noqa: F401
from lightgrad_tpu_torch.ops.elementwise import (BODIES, COL, FLAT, INNER,
                                                 ONE, ROW, SCALAR, TRANS,
                                                 Scalar, _cached_plan, _plan,
                                                 ew, ew_reference, scalar)
from tests.torch_port import cpu_device, jax_kernel_mode, to_np  # noqa: F401

# f32 on both sides; the same formulas, transcendentals from two libraries
TOL = dict(rtol=1e-5, atol=1e-6)
# bodies whose operands must be positive (log, pow); b is a divisor in div
_POSITIVE = {"f_log", "b_log", "f_pow", "b2_pow", "b1_pow"}
# one broadcast pattern per arity: the first operand is the output's shape
# (a gradient), the rest broadcast against it
_SHAPES = {1: [(4, 3, 6)], 2: [(4, 3, 6), (3, 1)],
           3: [(4, 3, 6), (3, 1), (1, 6)], 4: [(4, 3, 6), (3, 1), (1, 6),
                                               (4, 3, 6)]}


def _arity(body):
    return _jax_body(body).__code__.co_argcount


def _jax_body(body):
    return getattr(jax_ops, "_" + body)


def _n_out(body):
    return 2 if body.startswith("b2_") else 1


def _inputs(body, seed=0):
    rng = np.random.default_rng(seed)
    xs = []
    for shape in _SHAPES[_arity(body)]:
        x = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if body not in _POSITIVE:
            x *= rng.choice([-1.0, 1.0], shape).astype(np.float32)
        xs.append(x)
    if body == "b_minmax":
        xs[2][0, :3] = xs[1][:, 0]      # some x == y pairs
    return xs


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("body", BODIES)
def test_body_matches_jax(body, mode):
    xs = _inputs(body)
    n_out = _n_out(body)
    with jax_kernel_mode(mode):
        want = jax_ew(_jax_body(body), *map(jnp.asarray, xs), n_out=n_out)
    got = ew(body, *map(torch.from_numpy, xs), n_out=n_out)
    want = want if n_out > 1 else (want,)
    got = got if n_out > 1 else (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype)[6:] == str(w.dtype)
        np.testing.assert_allclose(to_np(g), np.asarray(w, np.float32), **TOL)


def test_minmax_gradient_hits_the_maxima():
    """b_minmax routes the gradient to the elements equal to the max."""
    x = np.array([[1.0, 3.0, 3.0], [2.0, 0.0, -1.0]], np.float32)
    y = x.max(axis=1, keepdims=True)
    g = np.ones((2, 1), np.float32)
    got = ew("b_minmax", *map(torch.from_numpy, (g, x, y)))
    np.testing.assert_array_equal(to_np(got), [[0, 1, 1], [1, 0, 0]])


@pytest.mark.parametrize("a_dt,b_dt,scalar,want", [
    ("int32", "float32", True, "float32"),    # int32 tensor with a float
    ("bfloat16", "float32", False, "float32"),
    ("int32", "int32", False, "int32"),
    ("bfloat16", "bfloat16", False, "bfloat16"),
])
@pytest.mark.parametrize("body", ["f_mul", "f_add"])
def test_dtype_promotion_matches_jax(body, a_dt, b_dt, scalar, want):
    rng = np.random.default_rng(3)
    a = rng.integers(-5, 6, (4, 5)).astype(np.float32)
    b = np.float32(0.5) if scalar else \
        rng.integers(-5, 6, (1, 5)).astype(np.float32)
    ja = jnp.asarray(a, dtype=a_dt)
    jb = jnp.asarray(b, dtype=b_dt)
    ta = torch.from_numpy(a).to(getattr(torch, a_dt))
    tb = torch.as_tensor(b).to(getattr(torch, b_dt))
    with jax_kernel_mode("pallas"):
        jy = jax_ew(_jax_body(body), ja, jb)
    ty = ew(body, ta, tb)
    assert str(jy.dtype) == want and ty.dtype == getattr(torch, want)
    # bfloat16: JAX rounds each op, the port widens to f32 and rounds once
    tol = 1e-2 if want == "bfloat16" else 1e-6
    np.testing.assert_allclose(to_np(ty), np.asarray(jy, np.float32),
                               rtol=tol, atol=tol)


def test_int_division_promotes_to_float():
    a = torch.tensor([[7, -3]], dtype=torch.int32)
    b = torch.tensor([2], dtype=torch.int32)
    y = ew("f_div", a, b)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(to_np(y), [[3.5, -1.5]])


def test_two_outputs_are_both_gradients():
    rng = np.random.default_rng(5)
    g, a, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 3, 4), (2, 3, 4), (3, 1)))
    ga, gb = ew("b2_mul", *map(torch.from_numpy, (g, a, b)), n_out=2)
    assert ga.shape == gb.shape == (2, 3, 4)
    np.testing.assert_allclose(to_np(ga), g * b, **TOL)
    np.testing.assert_allclose(to_np(gb), g * a, **TOL)


def _ops(views):
    """``_plan``'s operands: (shape, strides) of each tensor, None for a
    Scalar."""
    return tuple(None if isinstance(v, Scalar) else (tuple(v.shape),
                                                     v.stride())
                 for v in views)


def _walk(plan):
    """Each program's tile as the kernel computes it: (out_off, i, i0, i1,
    i2, mask, mask_r, mask_i, masked), numpy arrays of the tile's shape."""
    D0, D1, D2, D3 = plan.dims
    rows, inner, rb, ib = D0 * D1 * D2, D3, plan.rb, plan.ib
    for pid in range(plan.grid):
        if plan.wrap:
            n = rows * inner
            i = pid * ib + np.arange(ib)
            row0 = pid * ib // inner
            j = i - row0 * inner
            over = j >= inner
            i2 = row0 + over
            mask = (i < n)[None, :]
            yield (i[None, :], np.where(over, j - inner, j), 0, 0, i2, mask,
                   mask, mask, not (plan.even or (pid + 1) * ib <= n))
            continue
        if plan.nouter == 0:
            i = pid * ib + np.arange(ib)
            r = np.arange(rb)
            i2, i1, i0 = r, 0, 0
            out_off = np.broadcast_to(i[None, :], (rb, ib))
            full = (pid + 1) * ib <= inner
        else:
            nib = -(-inner // ib)
            pr, pi = pid // nib, pid % nib
            i = pi * ib + np.arange(ib)
            rbase = pr * rb
            r = rbase + np.arange(rb)
            out_off = (r * inner)[:, None] + i[None, :]
            full = (pr + 1) * rb <= rows and (pi + 1) * ib <= inner
            if plan.nouter == 1:
                i2, i1, i0 = r, 0, 0
            elif plan.split:
                q = rbase // D2
                assert (rbase - q * D2) % rb == 0     # the hint it gives
                i2 = rbase - q * D2 + np.arange(rb)
                i1, i0 = (q % D1, q // D1) if plan.nouter == 3 else (q, 0)
            else:
                i2, t = r % D2, r // D2
                i1, i0 = (t % D1, t // D1) if plan.nouter == 3 else (t, 0)
        mask_i = (i < inner)[None, :]
        mask_r = (r < rows)[:, None]
        yield (out_off, i, i0, i1, i2, mask_r & mask_i, mask_r, mask_i,
               not (plan.even or full))


def _offsets(plan, mode, st, tile):
    """Operand offsets over the tile (broadcastable to it), by mode, with
    the alignment the kernel's hints promise asserted."""
    out_off, i, i0, i1, i2 = tile[:5]
    if mode == FLAT:
        return out_off
    if mode == ONE:
        return np.zeros((1, 1), np.int64)
    if mode == COL:
        return i[None, :]
    ro = i2 if mode == TRANS else i2 * st[2]
    if plan.nouter >= 2:
        ob = i1 * st[1] + (i0 * st[0] if plan.nouter == 3 else 0)
        if plan.aligned:
            assert np.all(np.asarray(ob) % 8 == 0)
        ro = ro + ob
    if mode == ROW:
        return np.asarray(ro)[None, :] if plan.wrap else \
            np.asarray(ro)[:, None]
    if mode == INNER:
        if plan.aligned:
            assert np.all(ro % 8 == 0)
        return ro[:, None] + i[None, :]
    col = i * st[3]
    if plan.aligned:
        assert np.all(col % 8 == 0)
    return ro[:, None] + col[None, :]


def _replay(plan, views):
    """The output the kernel's addressing assembles when each operand's
    value is its own storage index: every output element is written once,
    unmasked tiles stay in bounds, and each operand is read where numpy
    broadcasting reads it (a copied operand from its compact copy)."""
    n = int(np.prod(plan.shape))
    got = [np.full(n, -1.0) for _ in views]
    writes = np.zeros(n, np.int64)
    store = []
    for v, size in zip(views, plan.copies):
        if isinstance(v, Scalar):
            store.append(None)
            continue
        if size is not None:
            v = v.as_strided(size, v.stride(), v.storage_offset()).contiguous()
        flat = v.untyped_storage()
        base = torch.tensor([], dtype=v.dtype).set_(flat).numpy()
        store.append((base, v.storage_offset()))
    for tile in _walk(plan):
        out_off, mask, masked = tile[0], tile[5], tile[8]
        if plan.aligned:
            assert np.all(out_off[:, :1] % 8 == 0)
        if not masked:
            assert mask.all()
        m = np.broadcast_to(mask, out_off.shape)
        writes[out_off[m]] += 1
        for j, (mode, st, s) in enumerate(zip(plan.modes, plan.strides,
                                              store)):
            if s is None:
                continue
            off = np.broadcast_to(_offsets(plan, mode, st, tile),
                                  out_off.shape)
            got[j][out_off[m]] = s[0][s[1] + off[m]]
    assert np.all(writes == 1)
    return [g.reshape(plan.shape) for g in got]


def _numbered(shape, stride=None, offset=0):
    """A view whose elements are their own storage indices."""
    stride = stride or torch.empty(shape).stride()
    need = offset + sum((s - 1) * st for s, st in zip(shape, stride)) + 1
    return torch.arange(max(need, 1), dtype=torch.float64).as_strided(
        shape, stride, offset)


def _check_replay(views, modes=None, copies=0):
    plan = _plan(_ops(views), 4)
    out = torch.broadcast_shapes(*(v.shape for v in views
                                   if not isinstance(v, Scalar)))
    assert plan.shape == tuple(out)
    for v, got in zip(views, _replay(plan, views)):
        if not isinstance(v, Scalar):
            np.testing.assert_array_equal(
                got, np.broadcast_to(v.numpy(), tuple(out)))
    if modes is not None:
        assert plan.modes == tuple(modes)
    assert sum(c is not None for c in plan.copies) == copies
    return plan


@pytest.mark.parametrize("shapes", [
    [(8, 12, 16, 16), (8, 1, 1, 16)],          # scores + additive mask
    [(32, 48), (48,)],                         # bias add
    [(5, 1, 7), (1, 6, 1), ()],                # crossed broadcast + scalar
    [(2, 3, 4, 5), (2, 3, 4, 5)],              # same shape: no index math
    [(4, 1), (4, 6), (1, 6)],                  # both sides broadcast
])
def test_kernel_addressing_reads_the_broadcast(shapes):
    """The plan the CUDA kernel is launched with addresses every operand
    as numpy broadcasting does, without materialising it, and writes each
    output element once."""
    plan = _check_replay([_numbered(s) for s in shapes])
    if shapes[0] == shapes[-1] and len(set(shapes)) == 1:
        assert plan.modes == (FLAT, FLAT) and plan.nouter == 0


def test_kernel_addressing_merges_dims():
    """Dims with one broadcast signature merge: the masked scores are 3-D
    to the kernel; a pattern needing more than 4 dims raises."""
    plan = _plan((((8, 12, 16, 16), (3072, 256, 16, 1)),
                  ((8, 1, 1, 16), (16, 16, 16, 1))), 4)
    assert plan.dims == (1, 8, 192, 16) and plan.modes == (FLAT, INNER)
    with pytest.raises(ValueError):
        _plan((((2, 1, 2, 1, 2), (4, 4, 2, 2, 1)),
               ((1, 2, 1, 2, 1), (4, 2, 2, 1, 1))), 4)


# The main paths' layout classes: (label, views, modes, rows x inner split)
def _classes():
    rot = _numbered((1, 5, 4, 48))[..., :16].permute(0, 2, 1, 3)
    return [
        ("BatchNorm x - mean", [_numbered((4, 8, 14, 14)),
                                _numbered((1, 8, 1, 1))], (FLAT, ROW)),
        ("bias add", [_numbered((24, 96)), _numbered((96,))], (FLAT, COL)),
        ("padding mask", [_numbered((2, 3, 16, 16)),
                          _numbered((2, 1, 1, 16))], (FLAT, INNER)),
        ("one-hot compare", [_numbered((40, 1)), _numbered((96,))],
         (ROW, COL)),
        ("GELU", [_numbered((48, 96))], (FLAT,)),
        ("scalar multiply", [_numbered((6, 40)), scalar(0.125,
                                                        torch.float32)],
         (FLAT, SCALAR)),
        ("rotary slice (a view)", [rot, _numbered((1, 1, 5, 16))],
         (INNER, INNER)),
        ("rotary half of the slice", [rot[..., :8]], (INNER,)),
        ("transposed weight gradient", [_numbered((64, 96)),
                                        _numbered((96, 64)).T],
         (FLAT, TRANS)),
        ("transposed last two (BERT)", [_numbered((2, 16, 24), (384, 1, 16)),
                                        _numbered((2, 16, 24)),
                                        _numbered((24,))],
         (TRANS, FLAT, COL)),
        ("expanded per-channel gradient", [
            _numbered((1, 8, 1, 1)).expand(4, 8, 14, 14),
            _numbered((4, 8, 14, 14))], (ROW, FLAT)),
        ("expanded last dim", [_numbered((1, 6, 5), (6, 1, 0)),
                               _numbered((1, 6, 5))], (ROW, FLAT)),
        ("padded slice (max pool)", [
            _numbered((2, 3, 9, 9))[:, :, 1:8, 1:8],
            _numbered((2, 3, 7, 7))], (INNER, FLAT)),
        ("odd length", [_numbered((1001,)), _numbered((1001,))],
         (FLAT, FLAT)),
        ("vocab-wide bias gradient (flat walk)", [
            _numbered((4, 3, 1001)), _numbered((4, 3, 1001)),
            _numbered((1001,))], (FLAT, FLAT, COL)),
        ("vocab-wide rows less their max (flat walk)", [
            _numbered((12, 1001)), _numbered((12, 1))], (FLAT, ROW)),
        ("four canonical dims", [_numbered((2, 3, 4, 5)),
                                 _numbered((2, 1, 4, 1))], (FLAT, ROW)),
        ("four canonical dims, a tile within D2", [
            _numbered((2, 3, 64, 5)), _numbered((2, 1, 64, 1)),
            _numbered((2, 3, 64, 5), (960, 320, 1, 64))],
         (FLAT, ROW, TRANS)),
    ]


@pytest.mark.parametrize("case", range(18))
def test_plan_reads_views_in_place(case):
    """Every main-path class, views included (a rotary slice, a transposed
    operand, an expanded one, a slice of a padded tensor): the kernel reads
    each operand through its own strides, with no copy, as broadcasting
    reads it."""
    label, views, modes = _classes()[case]
    plan = _check_replay(views, modes)
    assert plan.wrap == ("flat walk" in label)
    if "four" in label:
        assert plan.nouter == 3 and plan.split == ("within" in label)


def test_plan_skips_operands_the_body_never_reads():
    """``b2_add`` / ``b2_sub`` read only g: the operands they ignore shape
    the output and nothing else, so a broadcast bias leaves a flat walk
    (BERT's vocab-wide bias gradient, BatchNorm's at 14 x 14)."""
    for shapes in ([(8, 3, 1001), (8, 3, 1001), (1001,)],
                   [(4, 6, 14, 14), (4, 6, 14, 14), (1, 6, 1, 1)]):
        key = tuple((s, torch.empty(s).stride(), torch.float32, 0)
                    for s in shapes)
        for body in ("b2_add", "b2_sub"):
            plan = _cached_plan(body, 2, key).plan
            assert plan.modes == (FLAT, SCALAR, SCALAR)
            assert plan.nouter == 0 and plan.shape == shapes[0]
        assert _cached_plan("b2_mul", 2, key).plan.nouter > 0
    plan = _plan((((5, 7), (7, 1)), ((1, 7), (7, 1)), ((5, 1), (1, 1))), 4,
                 (1,))
    assert plan.shape == (5, 7) and plan.modes == (SCALAR, COL, SCALAR)


def test_plan_copies_only_the_view_that_cannot_merge():
    """A view whose strides keep more than 4 dims apart is copied, that
    operand alone, compacted; the other operands are read in place."""
    v = _numbered((2, 3, 4, 5, 6)).permute(0, 2, 1, 4, 3)
    plan = _check_replay([v, _numbered((2, 4, 3, 6, 5))], copies=1)
    assert plan.copies[1] is None and plan.nouter == 0
    # a broadcast operand that is copied keeps its broadcast dims out of
    # the copy
    e = _numbered((2, 3, 1, 5, 6)).permute(0, 2, 1, 4, 3).expand(
        2, 4, 3, 6, 5)
    plan = _check_replay([_numbered((2, 4, 3, 6, 5)), e], copies=1)
    assert plan.copies[1] == (2, 1, 3, 6, 5)


@pytest.mark.parametrize("rows,inner,itemsize,wrap,split", [
    (2048, 12544, 4, False, (8, 256, False)),   # BatchNorm at 112²
    (1024, 768, 4, False, (2, 256, False)),     # a bias add
    (12288, 128, 4, False, (4, 128, False)),    # the padding mask's rows
    (1, 25165824, 4, False, (1, 2048, False)),  # a large flat row: 8 KB
    (1, 25165824, 2, False, (1, 4096, False)),  # ... in bf16: 8 KB too
    (1, 3145728, 2, False, (1, 1024, False)),   # GELU: 16 tiles an SM
    (16384, 49, 4, False, (8, 64, False)),      # 7x7 maps: inner masked
    (4096, 784, 4, False, (16, 64, False)),     # 28x28: 6% padded, not 30%
    (4096, 196, 4, False, (32, 16, False)),     # 14x14: exact at 16 wide
    (1, 1000, 4, False, (1, 512, False)),       # small: tiles shrink
    (1024, 30522, 4, True, (1, 2048, True)),    # vocab rows: the flat walk
    (1024, 30522, 4, False, (1, 2048, False)),  # ... not where it may not
])
def test_tiles(rows, inner, itemsize, wrap, split):
    from lightgrad_tpu_torch.ops.elementwise import _tile
    assert _tile(rows, inner, itemsize, wrap=wrap) == split


def test_transposed_tiles_are_square():
    """A plan with a transposed operand reads it in runs of 32 rows."""
    from lightgrad_tpu_torch.ops.elementwise import _tile
    assert _tile(8192, 2048, 4, square=True) == (32, 64, False)
    assert _tile(3072, 768, 2, square=True) == (32, 64, False)


def test_cached_plan_key():
    """The plan is cached by (body, n_out, shapes, strides, dtypes,
    device): a repeated call plans nothing; other strides or a scalar's
    dtype make another entry."""
    f32 = torch.float32
    key = (((64, 768), (768, 1), f32, 0), ((768,), (1,), f32, 0))
    _cached_plan.cache_clear()
    a = _cached_plan("f_add", 1, key)
    assert _cached_plan("f_add", 1, key) is a
    assert _cached_plan.cache_info().hits == 1
    t = (((64, 768), (1, 64), f32, 0), ((768,), (1,), f32, 0))
    assert _cached_plan("f_add", 1, t).plan.modes == (TRANS, COL)
    i32 = torch.int32
    ints = (((4, 4), (4, 1), i32, 0), (None, None, f32, None))
    assert _cached_plan("f_mul", 1, ints).dtypes == (f32,)
    ints = (((4, 4), (4, 1), i32, 0), (None, None, i32, None))
    assert _cached_plan("f_mul", 1, ints).dtypes == (i32,)
    assert _cached_plan.cache_info().currsize == 4
    with pytest.raises(ValueError):          # operands on two devices
        _cached_plan("f_add", 1, (((4,), (1,), f32, 0),
                                  ((4,), (1,), f32, 1)))
    with pytest.raises(ValueError):          # a CPU tensor among them
        _cached_plan("f_add", 1, (((4,), (1,), f32, 0),
                                  ((4,), (1,), f32, -1)))


@pytest.mark.parametrize("dt,value", [("bfloat16", 1e-5), ("int32", 0.5),
                                      ("float32", 3), ("float32", -0.0),
                                      ("bfloat16", -0.0)])
def test_scalar_rounding_matches_jax(dt, value):
    """The op set's scalar, passed by value, has the dtype and the value
    of the JAX package's ``_scalar``: bf16 x 1e-5 rounds to bf16, int32 x
    0.5 promotes to float32, f32 + 3 stays float32, -0.0 keeps its sign
    (``x / -0.0`` is -inf) after +0.0 was rounded."""
    like = np.ones((2, 3), np.float32)
    t = torch.from_numpy(like).to(getattr(torch, dt))
    tape_ops._scalar(-value, t)             # the opposite sign seen first
    want = jax_ops._scalar(value, jnp.asarray(like, dtype=dt))
    got = tape_ops._scalar(value, t)
    assert isinstance(got, Scalar) and not isinstance(got.value,
                                                      torch.Tensor)
    assert str(got.dtype)[6:] == str(want.dtype)
    want = np.asarray(want, np.float32)
    assert float(got.value) == float(want)
    assert np.copysign(1.0, got.value) == np.copysign(1.0, want)
    assert type(got.value) is (int if dt == "int32" and
                               isinstance(value, int) else float)


def test_ew_refuses_another_triton(monkeypatch):
    """The direct launch mirrors one Triton release's launcher convention:
    the first launch under any other release raises, before any kernel is
    built or launched."""
    import sys
    import types

    import lightgrad_tpu_torch.ops.elementwise as em
    fake = types.ModuleType("triton")
    fake.__version__ = "9.0.0"
    monkeypatch.setitem(sys.modules, "triton", fake)
    monkeypatch.setattr(em, "_bodies", None)
    with pytest.raises(RuntimeError, match="Triton 9.0.0 is installed"):
        em._triton_bodies()


def test_ew_takes_scalars_by_value_on_cpu():
    """On CPU tensors ``ew`` gives a Scalar to ``ew_reference`` as a 0-d
    tensor of its dtype: the output dtype is the 0-d operand's promotion."""
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    y = ew("f_mul", x, scalar(0.5, torch.float32))
    assert y.dtype == torch.float32
    assert torch.equal(y, x.float() * 0.5)
    b = torch.ones(5, dtype=torch.bfloat16)
    z = ew("f_mul", b, scalar(1e-5, torch.bfloat16))
    assert z.dtype == torch.bfloat16
    assert torch.equal(z, ew_reference("f_mul", b, torch.tensor(
        1e-5, dtype=torch.bfloat16)))
    with pytest.raises(ValueError):
        scalar(1.0, torch.float64)


# tape programs with Python scalars, views and broadcasts: (fn, shapes)
_TAPE = {
    "transposed view, scalars, a bias": (
        lambda a, b: ((a.transpose() * 0.5 + b) - 3.0).relu() * 2,
        [(5, 4), (5,)]),
    "slices, a scalar divisor and power": (
        lambda a, b: (a[:, 1:3] / 4.0 + b) ** 2.0, [(6, 4), (2,)]),
    "a permuted operand and a broadcast": (
        lambda a, b: a.transpose(0, 2, 1) * b - 1, [(2, 3, 4), (1, 4, 1)]),
    "scalar on the left": (
        lambda a: 1.5 - a * 2.0 + 1e-5, [(3, 7)]),
    "compares with scalars": (
        lambda a: a.gt(0.25) * a + a.ge(a * 0.5) * 0.5, [(4, 6)]),
}


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("name", list(_TAPE))
def test_tape_scalars_views_broadcasts_match_jax(name, mode):
    """The tape's ops with Python scalars, views and broadcasts: forward
    and every input's gradient, the JAX tape (its kernels in ``mode``)
    against the port's CPU path, f32 at 2e-5."""
    fn, shapes = _TAPE[name]
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    w = None
    outs = {}
    for pkg in (JTensor, TTensor):
        ts = [pkg.from_numpy(a.copy()) for a in arrays]
        ctx = jax_kernel_mode(mode) if pkg is JTensor else _nullcontext()
        with ctx:
            y = fn(*ts)
            if w is None:
                w = rng.standard_normal(y.shape).astype(np.float32)
            (y * pkg.from_numpy(w, requires_grad=False)).sum().backward()
        outs[pkg] = [y.numpy()] + [t.grad.numpy() for t in ts]
    for j, t in zip(outs[JTensor], outs[TTensor]):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, np.asarray(j, np.float32), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("dt,value", [("bfloat16", 1e-5), ("int32", 0.5),
                                      ("float32", 3)])
def test_tape_scalar_ops_match_jax_dtypes(dt, value):
    """A tape multiply and add by a Python scalar: the JAX tape and the
    port give the same dtype and values (bf16: one rounding each side)."""
    rng = np.random.default_rng(11)
    a = rng.integers(-50, 50, (4, 5)).astype(np.float32) / 7
    j = JTensor(jnp.asarray(a, dtype=dt), requires_grad=False)
    t = TTensor(torch.from_numpy(a).to(getattr(torch, dt)),
                requires_grad=False)
    for f in (lambda x: x * value, lambda x: x + value):
        jy, ty = f(j), f(t)
        assert str(ty.dtype)[6:] == str(jy.dtype)
        tol = 1e-2 if dt == "bfloat16" else 1e-6
        np.testing.assert_allclose(to_np(ty.data),
                                   np.asarray(jy.data, np.float32),
                                   rtol=tol, atol=tol)


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
