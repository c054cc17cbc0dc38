"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from lightgrad_tpu_torch.ops.attention import (attention_bwd,
                                               attention_bwd_reference,
                                               attention_fwd_res,
                                               attention_fwd_reference)
from lightgrad_tpu_torch.ops.conv import (conv_bwd, conv_bwd_reference,
                                          conv_fwd, conv_fwd_reference)
from lightgrad_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from lightgrad_tpu_torch.ops.decode_stack import (
    decode_stack, decode_stack_batch, decode_stack_batch_reference,
    decode_stack_reference)
from lightgrad_tpu_torch.ops.layernorm import (
    layernorm_bwd_dx, layernorm_bwd_dx_reference, layernorm_fwd,
    layernorm_fwd_reference)
from lightgrad_tpu_torch.models.gpt import quantize_rows
from lightgrad_tpu_torch.ops.runtime import (launch_counts,
                                             reset_launch_counts)

pytestmark = pytest.mark.cuda

# f32: FFMA sums in another order than the reference's GEMMs (no TF32);
# bf16: inputs are bf16, sums f32, outputs rounded once to bf16
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device=g.device) * scale).to(dtype)


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,G,D,causal", [(1024, 1, 64, True),
                                          (100, 2, 64, False),
                                          (100, 1, 128, True)])
def test_flash_fwd_kernel(dev, S, G, D, causal, dtype):
    g = torch.Generator(device=dev).manual_seed(S + G + D)
    q = _randn(g, 4, S, D, dtype=dtype)
    k, v = (_randn(g, 4 // G, S, D, dtype=dtype) for _ in range(2))
    reset_launch_counts()
    out, lse = attention_fwd_res(q, k, v, D ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts()["attention_fwd"] == 1
    ref_out, ref_lse = attention_fwd_reference(q, k, v, D ** -0.5, causal)
    _close(out, ref_out, dtype)
    _close(lse, ref_lse, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,G,D,causal", [(1024, 1, 64, True),
                                          (100, 2, 64, False),
                                          (100, 2, 64, True),
                                          (100, 1, 128, True),
                                          (200, 2, 128, False)])
def test_flash_bwd_kernels(dev, S, G, D, causal, dtype):
    g = torch.Generator(device=dev).manual_seed(7 * S + G + D)
    q, do = (_randn(g, 4, S, D, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, 4 // G, S, D, dtype=dtype) for _ in range(2))
    out, lse = attention_fwd_res(q, k, v, D ** -0.5, causal=causal)
    reset_launch_counts()
    got = attention_bwd(do, q, k, v, D ** -0.5, causal, out=out, lse=lse)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["attention_bwd_dq"] == counts["attention_bwd_dkv"] == 1
    want = attention_bwd_reference(do, q, k, v, D ** -0.5, causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, dtype)
    again = attention_bwd(do, q, k, v, D ** -0.5, causal, out=out, lse=lse)
    for a, b in zip(got, again):              # no atomics: bit for bit
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", [(8192, 768), (37, 100), (5, 2048)])
def test_layernorm_kernels(dev, r, c, dtype):
    g = torch.Generator(device=dev).manual_seed(r + c)
    x = _randn(g, r, c, scale=3.0, dtype=dtype) + 1.5
    w = _randn(g, c, dtype=dtype)
    b = _randn(g, c, dtype=dtype)
    reset_launch_counts()
    y, xhat, rstd = layernorm_fwd(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert launch_counts()["layernorm_fwd"] == 1
    ry, rxhat, rrstd = layernorm_fwd_reference(x, w, b, 1e-5)
    assert xhat.dtype == rstd.dtype == torch.float32
    assert y.shape == x.shape and rstd.shape == (r, 1)
    _close(y, ry, dtype)
    _close(xhat, rxhat, torch.float32)
    _close(rstd, rrstd, torch.float32)
    gy = _randn(g, r, c, dtype=dtype)
    dx = layernorm_bwd_dx(gy, w, xhat, rstd)
    torch.cuda.synchronize()
    assert launch_counts()["layernorm_bwd"] == 1
    _close(dx, layernorm_bwd_dx_reference(gy, w, xhat, rstd), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos,window", [(0, 0), (37, 0), (1023, 0),
                                        (500, 16)])
def test_decode_attention_kernel(dev, pos, window, dtype):
    g = torch.Generator(device=dev).manual_seed(pos)
    q = _randn(g, 4, 3, 64, dtype=dtype)
    kc, vc = (_randn(g, 4, 1024, 64, dtype=dtype) for _ in range(2))
    out = decode_attention(q, kc, vc, pos, 0.125, window)
    torch.cuda.synchronize()
    _close(out, decode_attention_reference(q, kc, vc, pos, 0.125, window),
           dtype)


def _stack_inputs(g, dtype, L=3, d=768, W=256, R=4):
    H = d // 64
    slabs = _randn(g, L, 4 + 2 * R, d, d, scale=0.03, dtype=dtype)
    vecs = _randn(g, L, 9 + R, d, scale=0.1)
    vecs[:, 0] += 1
    vecs[:, 2] += 1
    return slabs, vecs.to(dtype), H, W


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,pos", [(1, 0), (1, 200), (4, 37), (8, 100)])
def test_decode_stack_kernel(dev, n, pos, dtype):
    g = torch.Generator(device=dev).manual_seed(n * 1000 + pos)
    slabs, vecs, H, W = _stack_inputs(g, dtype)
    cache = _randn(g, slabs.shape[0], 2, H, W, 64, dtype=dtype)
    x = _randn(g, n, slabs.shape[-1], dtype=dtype)
    got = decode_stack(x, cache, pos, slabs, vecs, eps=1e-5)
    torch.cuda.synchronize()
    want = decode_stack_reference(x, cache, pos, slabs, vecs, eps=1e-5)
    for a, b in zip(got, want):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n,pos", [(128, 1, 9), (128, 3, 40), (320, 2, 77)])
def test_decode_stack_kernel_other_widths(dev, d, n, pos, dtype):
    """Widths whose K chunks are 128 and 64 rows (768 takes 256)."""
    g = torch.Generator(device=dev).manual_seed(d + n)
    slabs, vecs, H, W = _stack_inputs(g, dtype, L=2, d=d)
    cache = _randn(g, 2, 2, H, W, 64, dtype=dtype)
    x = _randn(g, n, d, dtype=dtype)
    got = decode_stack(x, cache, pos, slabs, vecs, eps=1e-5)
    torch.cuda.synchronize()
    want = decode_stack_reference(x, cache, pos, slabs, vecs, eps=1e-5)
    for a, b in zip(got, want):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_stack_batch_kernel(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(5)
    slabs, vecs, H, W = _stack_inputs(g, dtype)
    poss = torch.tensor([0, 3, 255, 17, 64], device=dev, dtype=torch.int32)
    caches = _randn(g, 5, slabs.shape[0], 2, H, W, 64, dtype=dtype)
    x = _randn(g, 5, slabs.shape[-1], dtype=dtype)
    got = decode_stack_batch(x, caches, poss, slabs, vecs, eps=1e-5)
    torch.cuda.synchronize()
    want = decode_stack_batch_reference(x, caches, poss, slabs, vecs,
                                        eps=1e-5)
    for a, b in zip(got, want):
        _close(a, b, dtype)


def _int8_slabs(slabs):
    """int8 slabs and their (L, S, d) f32 scales per output column."""
    s = slabs.float().abs().amax(-2).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(slabs.float() / s[..., None, :]), -127, 127)
    return q.to(torch.int8), s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,pos", [(1, 0), (1, 200), (4, 37), (8, 255)])
@pytest.mark.parametrize("variant", ["int8", "kvq", "int8_kvq"])
def test_decode_stack_int8_kernels(dev, variant, n, pos, dtype):
    """The six int8 instantiations (here the three single-stream ones, the
    batched three below) against the plain version on the same operands."""
    g = torch.Generator(device=dev).manual_seed(n * 1000 + pos + 7)
    slabs, vecs, H, W = _stack_inputs(g, dtype)
    scales = None
    if "int8" in variant:
        slabs, scales = _int8_slabs(slabs)
    cache = _randn(g, slabs.shape[0], 2, H, W, 64, dtype=dtype)
    kvs = None
    if "kvq" in variant:
        cache, kvs = quantize_rows(cache)
    x = _randn(g, n, slabs.shape[-1], dtype=dtype)
    reset_launch_counts()
    got = decode_stack(x, cache, pos, slabs, vecs, scales, eps=1e-5,
                       kv_scales=kvs)
    torch.cuda.synchronize()
    assert launch_counts()["decode_stack_" + variant] == 1
    want = decode_stack_reference(x, cache, pos, slabs, vecs, scales,
                                  eps=1e-5, kv_scales=kvs)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["int8", "kvq", "int8_kvq"])
def test_decode_stack_batch_int8_kernels(dev, variant, dtype):
    g = torch.Generator(device=dev).manual_seed(9)
    slabs, vecs, H, W = _stack_inputs(g, dtype)
    scales = None
    if "int8" in variant:
        slabs, scales = _int8_slabs(slabs)
    poss = torch.tensor([0, 3, 255, 17, 64], device=dev, dtype=torch.int32)
    caches = _randn(g, 5, slabs.shape[0], 2, H, W, 64, dtype=dtype)
    kvs = None
    if "kvq" in variant:
        caches, kvs = quantize_rows(caches)
    x = _randn(g, 5, slabs.shape[-1], dtype=dtype)
    reset_launch_counts()
    got = decode_stack_batch(x, caches, poss, slabs, vecs, scales, eps=1e-5,
                             kv_scales=kvs)
    torch.cuda.synchronize()
    assert launch_counts()["decode_stack_batch_" + variant] == 1
    want = decode_stack_batch_reference(x, caches, poss, slabs, vecs, scales,
                                        eps=1e-5, kv_scales=kvs)
    for a, b in zip(got, want):
        _close(a, b, dtype)


def test_wrappers_raise_on_what_the_kernels_lack(dev):
    q = torch.zeros(2, 16, 32, device=dev)
    with pytest.raises(ValueError):
        attention_fwd_res(q, q, q, 1.0)                       # D = 32
    q = torch.zeros(2, 16, 64, device=dev)
    with pytest.raises(NotImplementedError):
        attention_fwd_res(q, q, q, 1.0, causal=True, window=4)
    with pytest.raises(ValueError):
        attention_fwd_res(q, q.transpose(0, 1), q, 1.0)       # strided
    out, lse = attention_fwd_res(q, q, q, 1.0, causal=True)
    with pytest.raises(ValueError):
        attention_bwd(q, q, q, q, 1.0, True)                  # no out / lse
    with pytest.raises(ValueError):
        attention_bwd(q.transpose(0, 1).contiguous().transpose(0, 1), q, q,
                      q, 1.0, True, out=out, lse=lse)         # strided g
    with pytest.raises(NotImplementedError):
        attention_bwd(q, q, q, q, 1.0, True, out=out, lse=lse, window=4)
    with pytest.raises(ValueError):
        layernorm_fwd(q, torch.ones(32, device=dev), torch.zeros(32,
                                                                 device=dev))
    with pytest.raises(ValueError):
        decode_stack(torch.zeros(9, 768, device=dev),
                     torch.zeros(1, 2, 12, 16, 64, device=dev), 0,
                     torch.zeros(1, 12, 768, 768, device=dev),
                     torch.zeros(1, 13, 768, device=dev), eps=1e-5)  # n = 9
    with pytest.raises(ValueError):               # int8 slabs, no scales
        decode_stack(torch.zeros(1, 768, device=dev),
                     torch.zeros(1, 2, 12, 16, 64, device=dev), 0,
                     torch.zeros(1, 12, 768, 768, device=dev,
                                 dtype=torch.int8),
                     torch.zeros(1, 13, 768, device=dev), eps=1e-5)
    x = torch.zeros(2, 3, 8, 8, device=dev)
    with pytest.raises(TypeError):                # float64
        conv_fwd(x.double(), torch.zeros(4, 3, 3, 3, device=dev,
                                         dtype=torch.float64))
    with pytest.raises(TypeError):                # operands on two devices
        conv_fwd(x, torch.zeros(4, 3, 3, 3))
    with pytest.raises(ValueError):               # kernel past the input
        conv_bwd(torch.zeros(2, 4, 1, 1, device=dev), x,
                 torch.zeros(4, 3, 9, 9, device=dev))


# --- the generic op set of the lightgrad tape --------------------------------
from lightgrad_tpu_torch.ops.elementwise import ew, ew_reference  # noqa: E402
from lightgrad_tpu_torch.ops.matmul import (matmul, matmul_reference,  # noqa
                                            matmul_vjp)
from lightgrad_tpu_torch.ops.reduce import reduce, reduce_reference  # noqa
from lightgrad_tpu_torch.ops.softmax import (softmax_bwd,  # noqa: E402
                                             softmax_bwd_reference,
                                             softmax_fwd,
                                             softmax_fwd_reference)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("body,shapes", [
    ("f_gelu", [(1024, 3072)]),
    ("b_gelu", [(1024, 3072), (1024, 3072)]),
    ("f_add", [(8, 12, 128, 128), (8, 1, 1, 128)]),     # the padding mask
    ("f_mul", [(1024, 768), ()]),                       # a scalar
    ("b2_mul", [(4, 33, 7), (4, 33, 7), (33, 1)]),      # two outputs
    ("b2_pow", [(5, 9), (5, 9), (9,), (5, 9)]),
    ("b_minmax", [(1024, 30), (1024, 30), (1024, 1)]),
    ("f_eq", [(64, 65), (1, 65)]),
])
def test_elementwise_kernel(dev, body, shapes, dtype):
    g = torch.Generator(device=dev).manual_seed(len(shapes))
    xs = [_randn(g, *s, dtype=dtype) for s in shapes]
    if "pow" in body:
        xs[1] = xs[1].abs() + 0.5
    if body == "b_minmax":
        xs[2] = xs[1].amax(-1, keepdim=True)
    n_out = 2 if body.startswith("b2_") else 1
    reset_launch_counts()
    got = ew(body, *xs, n_out=n_out)
    torch.cuda.synchronize()
    assert launch_counts()["elementwise"] == 1
    want = ew_reference(body, *xs, n_out=n_out)
    for a, b in zip(got if n_out > 1 else (got,), want if n_out > 1
                    else (want,)):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, dtype)


def test_elementwise_int32_and_views(dev):
    ids = torch.arange(-6, 6, device=dev, dtype=torch.int32).reshape(3, 4)
    half = torch.tensor(0.5, device=dev)
    y = ew("f_mul", ids, half)
    assert y.dtype == torch.float32
    assert torch.equal(y, ids.float() * 0.5)
    assert torch.equal(ew("f_add", ids, ids), ids + ids)
    x = torch.randn(6, 5, device=dev)
    assert torch.equal(ew("f_neg", x.T), -x.T)       # a transposed view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis,op", [
    ((1024, 768), 0, "sum"),          # a bias gradient: column sums
    ((8, 128, 3072), (0, 1), "sum"),
    ((1024, 30522), -1, "max"),       # the loss's row max
    ((1024, 30522), -1, "sum"),
    ((7, 33, 5), (0, 2), "min"),
    ((1000,), None, "sum"),
])
def test_reduce_kernel(dev, shape, axis, op, dtype):
    g = torch.Generator(device=dev).manual_seed(7)
    x = _randn(g, *shape, dtype=dtype)
    reset_launch_counts()
    got = reduce(x, op, axis=axis)
    torch.cuda.synchronize()
    assert launch_counts()["reduce"] == 1
    want = reduce_reference(x, op, axis=axis)
    assert got.shape == want.shape and got.dtype == want.dtype
    _close(got, want, dtype)


def test_reduce_kernel_strided_and_int(dev):
    x = torch.randn(8, 12, 64, device=dev).permute(2, 0, 1)
    _close(reduce(x, "sum", axis=(1, 2), keepdims=True),
           reduce_reference(x, "sum", axis=(1, 2), keepdims=True),
           torch.float32)
    ids = torch.randint(-50, 50, (37, 19), device=dev, dtype=torch.int32)
    for op in ("sum", "max", "min"):
        assert torch.equal(reduce(ids, op, axis=1),
                           reduce_reference(ids, op, axis=1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sa,sb,tb", [
    ((1024, 768), (768, 3072), False),
    ((1024, 768), (30522, 768), True),      # x @ W.T of the decoder
    ((37, 19), (19, 45), False),            # ragged M, N, K
    ((2, 3, 5, 7), (3, 7, 4), False),       # broadcast batch
])
def test_matmul_kernel(dev, sa, sb, tb, dtype):
    g = torch.Generator(device=dev).manual_seed(11)
    a = _randn(g, *sa, dtype=dtype)
    b = _randn(g, *sb, dtype=dtype)
    b = b.T if tb else b
    reset_launch_counts()
    got = matmul(a, b)
    torch.cuda.synchronize()
    assert launch_counts()["matmul"] == 1
    _close(got, matmul_reference(a, b), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_attention_views_and_vjp(dev, dtype):
    """q k^T and p v on (b, s, h, d) -> (b, h, s, d) views, no copies, and
    the gradients of a Linear with a shared weight."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = _randn(g, 8, 128, 768, dtype=dtype)
    q = x.reshape(8, 128, 12, 64).transpose(1, 2)
    k = _randn(g, 8, 128, 768, dtype=dtype).reshape(8, 128, 12, 64) \
        .transpose(1, 2)
    s = matmul(q, k.transpose(-1, -2))
    _close(s, matmul_reference(q, k.transpose(-1, -2)), dtype)
    p = torch.softmax(s.float(), -1).to(dtype)
    _close(matmul(p, k), matmul_reference(p, k), dtype)
    w = _randn(g, 3072, 768, dtype=dtype, scale=0.05)
    gy = _randn(g, 8, 128, 3072, dtype=dtype)
    ga, gb = matmul_vjp(gy, x, w.T)
    _close(ga, matmul_reference(gy, w), dtype)
    _close(gb, matmul_reference(x.reshape(-1, 768).T,
                                gy.reshape(-1, 3072)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 12, 128, 128), (1024, 30522), (5, 7)])
def test_softmax_kernels(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(13)
    x = _randn(g, *shape, scale=3.0, dtype=dtype)
    if len(shape) == 4:
        x[..., 100:] += -1e9
    dy = _randn(g, *shape, dtype=dtype)
    reset_launch_counts()
    y = softmax_fwd(x)
    dx = softmax_bwd(dy, y)
    torch.cuda.synchronize()
    assert launch_counts()["softmax_fwd"] == launch_counts()["softmax_bwd"] \
        == 1
    _close(y, softmax_fwd_reference(x), dtype)
    _close(dx, softmax_bwd_reference(dy, y), dtype)


# --- convolution: ResNet-18's shapes at batch 2, and the odd cases ----------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xs,ws,st,dl,groups", [
    ((2, 3, 230, 230), (64, 3, 7, 7), 2, 1, 1),      # the stem
    ((2, 64, 58, 58), (64, 64, 3, 3), 1, 1, 1),      # layer 1
    ((2, 64, 58, 58), (128, 64, 3, 3), 2, 1, 1),     # layer 2's first conv
    ((2, 64, 56, 56), (128, 64, 1, 1), 2, 1, 1),     # the 1x1/s2 projection
    ((2, 512, 9, 9), (512, 512, 3, 3), 1, 1, 1),     # layer 4
    ((2, 1, 30, 30), (8, 1, 3, 3), 1, 1, 1),         # MNIST's first conv
    ((2, 16, 21, 19), (32, 4, 3, 3), 1, 2, 4),       # grouped, dilated
    ((2, 8, 17, 15), (8, 1, 3, 3), 2, 1, 8),         # depthwise, strided
    ((2, 6, 37), (10, 6, 5), 2, 1, 1),               # 1-D
    ((2, 4, 7, 9, 8), (6, 2, 3, 2, 3), (1, 2, 1), (2, 1, 1), 2),  # 3-D
], ids=str)
def test_conv_kernels(dev, xs, ws, st, dl, groups, dtype):
    g = torch.Generator(device=dev).manual_seed(sum(xs) + sum(ws))
    x = _randn(g, *xs, dtype=dtype)
    w = _randn(g, *ws, scale=0.1, dtype=dtype)
    reset_launch_counts()
    y = conv_fwd(x, w, st, dl, groups)
    torch.cuda.synchronize()
    assert launch_counts()["conv_fwd"] == 1
    want = conv_fwd_reference(x, w, st, dl, groups)
    assert y.shape == want.shape and y.dtype == want.dtype
    _close(y, want, dtype)
    gy = _randn(g, *want.shape, dtype=dtype)
    reset_launch_counts()
    gx, gw = conv_bwd(gy, x, w, st, dl, groups)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["conv_bwd_dx"] == counts["conv_bwd_dw"] == 1
    rgx, rgw = conv_bwd_reference(gy, x, w, st, dl, groups)
    _close(gx, rgx, dtype)
    _close(gw, rgw, dtype)
    again = conv_bwd(gy, x, w, st, dl, groups)        # no atomics
    assert torch.equal(gx, again[0]) and torch.equal(gw, again[1])
    assert conv_bwd(gy, x, w, st, dl, groups, need_dx=False)[0] is None
