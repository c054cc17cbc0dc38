"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from lightgrad_tpu_torch.autograd import flash_block
from lightgrad_tpu_torch.ops.attention import (attention_bwd,
                                               attention_bwd_fused,
                                               attention_bwd_fused_reference,
                                               attention_bwd_passes_reference,
                                               attention_bwd_reference,
                                               attention_fwd_res,
                                               attention_fwd_reference,
                                               flash_block_reference,
                                               fused_rows, set_flash_fused)
from lightgrad_tpu_torch.ops.conv import (conv_bwd, conv_bwd_reference,
                                          conv_fwd, conv_fwd_reference)
from lightgrad_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference, decode_merge,
    decode_merge_reference, split_partials, visible_range)
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
@pytest.mark.parametrize("S,G,D,window", [(300, 4, 128, 64),
                                          (257, 2, 64, 100),
                                          (200, 1, 32, 17),
                                          (150, 2, 8, 40),
                                          (130, 1, 80, 130),
                                          (100, 8, 256, 33),
                                          (90, 1, 200, 1000),
                                          (64, 2, 16, 0),
                                          (70, 1, 256, 0)])
def test_flash_kernels_window_and_head_dims(dev, S, G, D, window, dtype):
    """The band (below, at and past S) and every instantiation (D 32, 64,
    128, 256, and 8, 16, 80, 200 through a wider one): forward and both
    backward passes against the plain versions, causal, grouped."""
    g = torch.Generator(device=dev).manual_seed(5 * S + G + D + window)
    B = 8
    q, do = (_randn(g, B, S, D, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, B // G, S, D, dtype=dtype) for _ in range(2))
    sc = D ** -0.5
    reset_launch_counts()
    out, lse = attention_fwd_res(q, k, v, sc, causal=True, window=window)
    got = attention_bwd(do, q, k, v, sc, True, out=out, lse=lse,
                        window=window)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["attention_fwd"] == counts["attention_bwd_dq"] \
        == counts["attention_bwd_dkv"] == 1
    ro, rl = attention_fwd_reference(q, k, v, sc, True, window=window)
    _close(out, ro, dtype)
    _close(lse, rl, torch.float32)
    want = attention_bwd_reference(do, q, k, v, sc, True, window=window)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, dtype)
    if 0 < window < S:      # the band reaches something: a wrong one fails
        full = attention_fwd_reference(q, k, v, sc, True)[0]
        assert (full.float() - ro.float()).abs().max() > 0.05


# the bf16 forward rounds P to bf16 before P V, as the TPU kernel does
# (p.astype(v.dtype)): error held to tol * rms(ref) plus one ulp of each
# element, f32 to the f32 tolerance
FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}


def _close_ulp(got, want, dtype, tol=None):
    ref = want.float()
    rms = ref.pow(2).mean().sqrt().item()
    excess = ((got.float() - ref).abs() - ULP[dtype] * ref.abs()).max()
    assert excess.item() <= (FWD_TOL[dtype] if tol is None else tol) * rms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,G,D,causal,window,lens", [
    (100, 1, 8, True, 0, None), (130, 2, 24, False, 0, None),
    (257, 4, 80, True, 0, None), (65, 8, 200, True, 0, None),
    (129, 1, 64, False, 0, "edges"), (200, 2, 128, True, 0, "edges"),
    (300, 1, 256, True, 17, None), (150, 4, 128, True, 40, None),
    (64, 1, 32, False, 0, None), (1, 1, 64, True, 0, None)])
def test_flash_fwd_every_instantiation(dev, S, G, D, causal, window, lens,
                                       dtype):
    """The forward (bf16: the tensor-core kernel, D 64, 128, 256; f32: the
    SIMT kernel) at head dims that are no instantiation (8, 24, 80, 200), S
    not a multiple of the 64-row tiles, G 1-8, causal and not, a window
    narrower than a K tile, and lengths of 0, 1 and S (padded rows exactly
    0, their lse 0)."""
    g = torch.Generator(device=dev).manual_seed(11 * S + G + D + window)
    B = 8
    q = _randn(g, B, S, D, dtype=dtype)
    k, v = (_randn(g, B // G, S, D, dtype=dtype) for _ in range(2))
    lengths = None
    if lens:
        lengths = torch.tensor([0, 1, S, S // 2, 3, S - 1, S, 2],
                               device=dev, dtype=torch.int32)
    reset_launch_counts()
    out, lse = attention_fwd_res(q, k, v, D ** -0.5, causal,
                                 lengths=lengths, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["attention_fwd"] == 1
    ro, rl = attention_fwd_reference(q, k, v, D ** -0.5, causal, lengths,
                                     window)
    _close_ulp(out, ro, dtype)
    _close(lse, rl, torch.float32)
    if lengths is not None:
        pad = torch.arange(S, device=dev)[None, :] >= lengths[:, None]
        assert bool((out[pad] == 0).all()) and bool((lse[..., 0][pad] == 0)
                                                    .all())
    again, _ = attention_fwd_res(q, k, v, D ** -0.5, causal, lengths=lengths,
                                 window=window)
    assert torch.equal(out, again)


def test_tape_attention_window_grouped(dev):
    """The tape's attention op with a window and grouped K/V (a Mistral
    layer's call shape, small): both directions launch the kernels and
    match torch autograd through the plain forward."""
    from lightgrad_tpu_torch.autograd import Tensor

    g = torch.Generator(device=dev).manual_seed(11)
    data = [_randn(g, 2, h, 96, 128) for h in (8, 2, 2)]
    q, k, v = (Tensor(t) for t in data)
    reset_launch_counts()
    y = q.attention(k, v, scale=128 ** -0.5, causal=True, window=24)
    (y * y).sum().backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["attention_fwd"] == counts["attention_bwd_dq"] == 1
    ts = [t.clone().requires_grad_() for t in data]
    ref = attention_fwd_reference(*ts, 128 ** -0.5, True, window=24)[0]
    (ref * ref).sum().backward()
    _close(y.data, ref, torch.float32)
    for t, r in zip((q, k, v), ts):
        _close(t.grad.data, r.grad, torch.float32)


@pytest.mark.parametrize("hidden,heads", [(512, 2), (320, 4)])
def test_tape_neox_step_fused_backward(dev, hidden, heads):
    """A 2-layer Pythia-shaped NeoX (head dim 256, or 80; rotary_pct 0.25,
    parallel residual) one step on the tape with the fused flash backward,
    against the same weights on the CPU, whose ops run the kernels' plain
    versions (the recompute backward for attention): logits and every
    gradient; the fused kernel launched once a layer and the two passes
    never."""
    import numpy as np

    from lightgrad_tpu_torch import load_numpy_params
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.autograd.cuda import device
    from lightgrad_tpu_torch.models.neox import NeoX, NeoXConfig

    cfg = dict(vocab_size=512, hidden_size=hidden,
               intermediate_size=4 * hidden, num_hidden_layers=2,
               num_attention_heads=heads, max_position_embeddings=256)
    B, S = 2, 200
    ids = np.random.default_rng(hidden).integers(0, 512, (B, S + 1))
    ids = ids.astype(np.int32)

    def step(model):
        logits = model(Tensor.from_numpy(ids[:, :-1], requires_grad=False))
        loss = lg_loss.cross_entropy(
            logits.reshape(B * S, 512),
            Tensor.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False))
        loss.backward()
        return logits.data.cpu(), {n: t.grad.data.cpu()
                                   for n, t in model.named_parameters()}

    lg_random.seed(0)
    model = NeoX(NeoXConfig(**cfg))
    state = {n: t.numpy() for n, t in model.named_parameters()}
    prev = set_flash_fused(True)
    try:
        reset_launch_counts()
        logits, grads = step(model)
        torch.cuda.synchronize()
        counts = launch_counts()
        prev_dev = device.set_default_device("cpu")
        try:
            twin = NeoX(NeoXConfig(**cfg))
            load_numpy_params(twin, state)
            want_logits, want = step(twin)
        finally:
            device.set_default_device(prev_dev)
    finally:
        set_flash_fused(prev)
    assert counts["attention_bwd_fused"] == 2
    assert counts["attention_bwd_dq"] == counts["attention_bwd_dkv"] == 0
    _close(logits, want_logits, torch.float32)
    for n, g in grads.items():
        err = (g - want[n]).abs().max().item()
        assert err <= 1e-3 * want[n].abs().max().item(), (n, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,G,D,causal", [(128, 1, 64, False),
                                          (128, 1, 64, True),
                                          (128, 2, 64, False),
                                          (100, 2, 128, True)])
def test_flash_kernels_with_lengths(dev, S, G, D, causal, dtype):
    """Per-row lengths from 0 to S: padded query rows give out 0 and lse 0,
    padded keys dk = dv = 0, padded rows dq 0, and nothing is NaN."""
    g = torch.Generator(device=dev).manual_seed(3 * S + G + D + causal)
    B = 8
    q, do = (_randn(g, B, S, D, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, B // G, S, D, dtype=dtype) for _ in range(2))
    lens = torch.tensor([S, 0, 1, 63, 64, 65, S - 1, S // 2], device=dev,
                        dtype=torch.int32)
    reset_launch_counts()
    out, lse = attention_fwd_res(q, k, v, D ** -0.5, causal, lengths=lens)
    got = attention_bwd(do, q, k, v, D ** -0.5, causal, out=out, lse=lse,
                        lengths=lens)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["attention_fwd"] == counts["attention_bwd_dq"] \
        == counts["attention_bwd_dkv"] == 1
    ref_out, ref_lse = attention_fwd_reference(q, k, v, D ** -0.5, causal,
                                               lens)
    _close(out, ref_out, dtype)
    _close(lse, ref_lse, torch.float32)
    want = attention_bwd_reference(do, q, k, v, D ** -0.5, causal,
                                   lengths=lens)
    for a, b in zip(got, want):
        assert torch.isfinite(a.float()).all()
        _close(a, b, dtype)
    rows = torch.arange(S, device=dev)[None, :] >= lens[:, None].long()
    assert (out[rows] == 0).all() and (lse[..., 0][rows] == 0).all()
    assert (got[0][rows] == 0).all()
    if G == 1:
        assert (got[1][rows] == 0).all() and (got[2][rows] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D,causal", [(1024, 64, True), (100, 64, False),
                                        (200, 128, True), (96, 128, False),
                                        (300, 32, True), (100, 32, False),
                                        (200, 80, True), (129, 80, False),
                                        (150, 200, True), (100, 200, False),
                                        (300, 256, True), (64, 256, False)])
def test_flash_fused_backward_kernel(dev, S, D, causal, dtype):
    """The fused kernel against the plain version and the two passes, bit
    for bit on a rerun, at every instantiation (D 32, 64, 128, 256) and
    through the next wider one (d 80, 200); calls the JAX rule keeps off it
    (lengths, grouped queries) stay on the two passes."""
    g = torch.Generator(device=dev).manual_seed(11 * S + D + causal)
    q, do, k, v = (_randn(g, 4, S, D, dtype=dtype) for _ in range(4))
    out, lse = attention_fwd_res(q, k, v, D ** -0.5, causal=causal)
    two_pass = attention_bwd(do, q, k, v, D ** -0.5, causal, out=out, lse=lse)
    prev = set_flash_fused(True)
    try:
        reset_launch_counts()
        got = attention_bwd(do, q, k, v, D ** -0.5, causal, out=out, lse=lse)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["attention_bwd_fused"] == 1
        assert counts["attention_bwd_dq"] == counts["attention_bwd_dkv"] == 0
        again = attention_bwd(do, q, k, v, D ** -0.5, causal, out=out,
                              lse=lse)
        # lengths and grouped-query calls take the two passes
        reset_launch_counts()
        lens = torch.full((4,), S // 2, device=dev, dtype=torch.int32)
        o2, l2 = attention_fwd_res(q, k, v, D ** -0.5, causal, lengths=lens)
        attention_bwd(do, q, k, v, D ** -0.5, causal, out=o2, lse=l2,
                      lengths=lens)
        o3, l3 = attention_fwd_res(q, k[:2], v[:2], D ** -0.5, causal)
        attention_bwd(do, q, k[:2], v[:2], D ** -0.5, causal, out=o3, lse=l3)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["attention_bwd_fused"] == 0
        assert counts["attention_bwd_dq"] == counts["attention_bwd_dkv"] == 2
    finally:
        set_flash_fused(prev)
    want = attention_bwd_reference(do, q, k, v, D ** -0.5, causal)
    for a, b, c, d in zip(got, want, two_pass, again):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, dtype)
        _close(a, c, dtype)
        assert torch.equal(a, d)                  # no atomics: bit for bit


# The bf16 backward kernels (tensor cores) round p and ds to bf16 as the TPU
# kernels do; their plain versions round the same way, so only the sums'
# order and an operand that rounds the other way part them: past one ulp
# of each element, within BWD_TOL of the reference's rms.
BWD_TOL = 1e-2


@pytest.mark.parametrize("S,G,D,causal,window,lens", [
    (300, 1, 64, True, 0, None), (257, 4, 64, False, 0, None),
    (200, 1, 128, True, 0, "edges"), (300, 4, 128, True, 64, None),
    (150, 2, 256, True, 0, None), (100, 1, 256, True, 33, None),
    (129, 4, 8, False, 0, "edges"), (200, 4, 80, True, 40, None),
    (90, 2, 200, False, 0, None), (64, 1, 256, False, 0, "edges")])
def test_flash_bwd_tc_kernels(dev, S, G, D, causal, window, lens):
    """The bf16 tensor-core dq and dk/dv passes at every instantiation (D
    64, 128, 256) and through a wider one (d 8, 80, 200), with lengths of
    0, 1 and S, a window and GQA 4:1, against the two passes' plain
    version; bit for bit on a rerun; padded rows exactly 0."""
    g = torch.Generator(device=dev).manual_seed(13 * S + G + D + window)
    B, bf16 = 8, torch.bfloat16
    q, do = (_randn(g, B, S, D, dtype=bf16) for _ in range(2))
    k, v = (_randn(g, B // G, S, D, dtype=bf16) for _ in range(2))
    lengths = None
    if lens:
        lengths = torch.tensor([0, 1, S, S // 2, 3, S - 1, S, 2],
                               device=dev, dtype=torch.int32)
    sc = D ** -0.5
    out, lse = attention_fwd_res(q, k, v, sc, causal, lengths=lengths,
                                 window=window)
    reset_launch_counts()
    got = attention_bwd(do, q, k, v, sc, causal, out=out, lse=lse,
                        lengths=lengths, window=window)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["attention_bwd_dq"] == counts["attention_bwd_dkv"] == 1
    want = attention_bwd_passes_reference(do, q, k, v, out, lse, sc, causal,
                                          lengths, window)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == bf16
        _close_ulp(a, b, bf16, BWD_TOL)
    again = attention_bwd(do, q, k, v, sc, causal, out=out, lse=lse,
                          lengths=lengths, window=window)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if lengths is not None:
        pad = torch.arange(S, device=dev)[None, :] >= lengths[:, None].long()
        assert bool((got[0][pad] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D,causal", [(1024, 64, True), (200, 64, False),
                                        (300, 128, True), (129, 80, False),
                                        (256, 256, True), (100, 200, False),
                                        (200, 8, True)])
def test_flash_fused_kernel_orders_dq(dev, S, D, causal, dtype):
    """The fused kernel (bf16: tensor cores; f32: CUDA cores), dq summed
    over the key blocks in order in the kernel, against its plain version,
    which sums in the same order: bit for bit on a rerun."""
    g = torch.Generator(device=dev).manual_seed(17 * S + D + causal)
    q, do, k, v = (_randn(g, 8, S, D, dtype=dtype) for _ in range(4))
    sc = D ** -0.5
    out, lse = attention_fwd_res(q, k, v, sc, causal)
    dcap = (do.float() * out.float()).sum(-1).contiguous()
    reset_launch_counts()
    got = attention_bwd_fused(do, q, k, v, lse, dcap, sc, causal)
    torch.cuda.synchronize()
    assert launch_counts()["attention_bwd_fused"] == 1
    want = attention_bwd_fused_reference(do, q, k, v, out, lse, dcap, sc,
                                         causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == dtype
        if dtype == torch.float32:
            _close(a, b, dtype)
        else:
            _close_ulp(a, b, dtype, BWD_TOL)
    for _ in range(3):
        again = attention_bwd_fused(do, q, k, v, lse, dcap, sc, causal)
        for a, b in zip(got, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fused_kernel_keeps_no_dq_slabs(dev, dtype):
    """At a Pythia-1B-shaped call (4 x 2048 x 256, causal) the fused call
    allocates its outputs, one f32 dq buffer and the turn counters: far
    below the nk x BH x S x d f32 slabs of the TPU kernel's scheme."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, S, D = 4, 2048, 256
    q, do, k, v = (_randn(g, B, S, D, dtype=dtype) for _ in range(4))
    out, lse = attention_fwd_res(q, k, v, D ** -0.5, True)
    dcap = (do.float() * out.float()).sum(-1).contiguous()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = attention_bwd_fused(do, q, k, v, lse, dcap, D ** -0.5, True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    isz = q.element_size()
    nk = -(-S // fused_rows(D, dtype))
    # dq f32 (and its cast), dk, dv, the ticket and turns, 1 MB of slack
    bound = B * S * D * (4 + 3 * isz) + 4 * (1 + B * nk) + 2 ** 20
    slabs = nk * B * S * D * 4
    assert peak <= bound < slabs, (peak, bound, slabs)
    assert all(torch.isfinite(t.float()).all() for t in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_kernel(dev, causal, dtype):
    """flash_block's out, lse and its gradients with a nonzero lse
    cotangent against torch autograd through the plain version, on chunks
    of a longer sequence (strided views)."""
    g = torch.Generator(device=dev).manual_seed(21 + causal)
    q, k, v = (_randn(g, 8, 512, 64, dtype=dtype) for _ in range(3))
    w = _randn(g, 8, 256, 64)
    wl = _randn(g, 8, 256, 1)

    def run(fn):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        o, l = fn(*(t[:, 256:] for t in ts), 0.125, causal)
        ((o.float() * w).sum() + (l * wl).sum()).backward()
        return (o, l, *(t.grad[:, 256:] for t in ts))

    reset_launch_counts()
    got = run(flash_block)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_block"] == 2 and counts["attention_fwd"] == 1
    assert counts["attention_bwd_dq"] == counts["attention_bwd_dkv"] == 1
    want = run(flash_block_reference)
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        _close(a, b, torch.float32 if name == "lse" else dtype)


@pytest.mark.parametrize("D", [64, 128])
def test_dq_kernel_refines_dcap(dev, D):
    """Given a dcap off by 1e-3 and an lse cotangent, the dq kernel's dq and
    refined dcap are those of the exact dcap."""
    from lightgrad_tpu_torch.ops.attention import attention_bwd_dq

    g = torch.Generator(device=dev).manual_seed(D)
    q, k, v, do = (_randn(g, 4, 300, D) for _ in range(4))
    out, lse = attention_fwd_res(q, k, v, D ** -0.5, causal=True)
    dlse = _randn(g, 4, 300)
    dcap = ((do * out).sum(-1) - dlse).contiguous()
    want = attention_bwd_dq(do, q, k, v, lse, dcap, D ** -0.5, True,
                            dlse=dlse)
    refined = torch.empty_like(dcap)
    got = attention_bwd_dq(do, q, k, v, lse, dcap + 1e-3, D ** -0.5, True,
                           dlse=dlse, dcap_out=refined)
    _close(got, want, torch.float32)
    _close(refined, dcap, torch.float32)


def test_lengths_must_be_int32_of_the_rows(dev):
    q = torch.zeros(2, 16, 64, device=dev)
    for bad in (torch.tensor([3, 16], device=dev),              # int64
                torch.tensor([3], device=dev, dtype=torch.int32),
                torch.tensor([3, 16], dtype=torch.int32)):      # on the host
        with pytest.raises(ValueError):
            attention_fwd_res(q, q, q, 1.0, lengths=bad)
    with pytest.raises(ValueError, match="multiple of 8"):
        attention_fwd_res(q[..., :20].contiguous(), q[..., :20].contiguous(),
                          q[..., :20].contiguous(), 1.0)


def test_narrow_and_offsets_do_not_synchronise(dev):
    """A device start never reaches the host: narrow's forward and
    backward, and DeviceDataset.offsets(), under sync debug mode."""
    from lightgrad_tpu_torch import data
    from lightgrad_tpu_torch.autograd import Tensor

    x = Tensor(torch.randn(64, 5, device=dev))
    ds = data.DeviceDataset((torch.arange(40.0).reshape(20, 2),),
                            shuffle=False, batchsize=4)
    start = Tensor(torch.tensor(60, device=dev, dtype=torch.int32),
                   requires_grad=False)          # the upload syncs: before
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = x.narrow(start, 8)                    # clamps to 56
        y.backward(allow_fill=True)               # narrow's backward alone
        offs = list(ds.offsets())
        batch = ds.tensors[0].narrow(offs[2], 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(y.data, x.data[56:])
    want = torch.zeros_like(x.data)
    want[56:] = 1.0
    assert torch.equal(x.grad.data, want)
    assert torch.equal(batch.data.cpu(),
                       torch.arange(16.0, 24.0).reshape(4, 2))


def test_tape_attention_lengths_does_not_synchronise(dev):
    """The tape's attention op with (batch,) lengths, forward and
    backward: the lengths never reach the host."""
    from lightgrad_tpu_torch.autograd import Tensor

    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (Tensor(_randn(g, 2, 3, 128, 64)) for _ in range(3))
    lens = Tensor(torch.tensor([128, 70], device=dev, dtype=torch.int32),
                  requires_grad=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = q.attention(k, v, scale=0.125, lengths=lens)
        y.backward(allow_fill=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = attention_fwd_reference(q.data, k.data, v.data, 0.125,
                                   lengths=lens.data.repeat_interleave(3))[0]
    _close(y.data, want, torch.float32)
    assert torch.isfinite(q.grad.data).all()


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
@pytest.mark.parametrize("KV,G,hd,W,pos,window", [(1, 8, 256, 8192, 8191, 0),
                                                  (1, 8, 256, 8192, 4096, 0),
                                                  (8, 4, 128, 8192, 6000,
                                                   4096),
                                                  (2, 3, 8, 64, 40, 9),
                                                  (2, 2, 80, 3000, 2999, 0),
                                                  (3, 1, 16, 100, 50, 0)])
def test_decode_attention_head_dims(dev, KV, G, hd, W, pos, window, dtype):
    """Any head dim, G up to 8, and visible ranges past one chunk of
    scores (2048 keys): Gemma-2B's and Mistral-7B's decode shapes."""
    g = torch.Generator(device=dev).manual_seed(pos + hd)
    q = _randn(g, KV, G, hd, dtype=dtype)
    kc, vc = (_randn(g, KV, W, hd, dtype=dtype) for _ in range(2))
    reset_launch_counts()
    out = decode_attention(q, kc, vc, pos, hd ** -0.5, window)
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == 1
    _close(out, decode_attention_reference(q, kc, vc, pos, hd ** -0.5,
                                           window), dtype)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd,W,pos,window,n_split", [
    (1, 8, 256, 8192, 4096, 0, None), (8, 4, 128, 8192, 6000, 4096, None),
    (12, 1, 64, 1024, 512, 0, None), (2, 3, 8, 64, 0, 0, None),
    (2, 2, 80, 3000, 5000, 0, None), (1, 8, 256, 8192, 4096, 0, 256),
    (1, 5, 200, 700, 699, 0, 11), (4, 2, 40, 300, 250, 100, 100),
    (3, 8, 24, 129, 128, 0, 2), (2, 4, 128, 500, 300, 0, 1)])
def test_decode_attention_splits(dev, monkeypatch, KV, G, hd, W, pos, window,
                                 n_split, dtype):
    """The split kernel and its merge at the planner's splits (Gemma-2B's,
    Mistral-7B's and GPT-2's decode shapes, pos 0, pos past W) and at forced
    ones (256, one key a split, 1, 2): against the plain version, one
    launch of the split kernel, the merge exactly where there are splits,
    and bit for bit on a rerun."""
    import lightgrad_tpu_torch.ops.decode_attention  # noqa: F401
    import sys
    mod = sys.modules["lightgrad_tpu_torch.ops.decode_attention"]
    lo, hi = visible_range(W, pos, window)
    if n_split is not None:
        monkeypatch.setattr(mod, "decode_splits", lambda *a: n_split)
    n = mod.decode_splits(KV, hi - lo + 1, hd, dtype)
    g = torch.Generator(device=dev).manual_seed(pos + hd + G)
    q = _randn(g, KV, G, hd, dtype=dtype)
    kc, vc = (_randn(g, KV, W, hd, dtype=dtype) for _ in range(2))
    reset_launch_counts()
    out = decode_attention(q, kc, vc, pos, hd ** -0.5, window)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["decode_attention"] == 1
    assert counts["decode_attention_merge"] == (n > 1)
    want = decode_attention_reference(q, kc, vc, pos, hd ** -0.5, window)
    _close_ulp(out, want, dtype, 1e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.equal(out, decode_attention(q, kc, vc, pos, hd ** -0.5,
                                             window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_merge_kernel(dev, dtype):
    """The merge kernel alone against its plain version, on partials made
    by the plain split arithmetic (Gemma-2B's shape, 65 splits)."""
    g = torch.Generator(device=dev).manual_seed(3)
    q = _randn(g, 1, 8, 256, dtype=dtype)
    kc, vc = (_randn(g, 1, 8192, 256, dtype=dtype) for _ in range(2))
    part = split_partials(q, kc, vc, 4096, 0.0625, 0, 65)
    reset_launch_counts()
    out = decode_merge(part, torch.empty_like(q), 65)
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention_merge"] == 1
    _close_ulp(out, decode_merge_reference(part, 1, 8, 256, 65, dtype), dtype,
               1e-2 if dtype == torch.bfloat16 else 1e-5)


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
    for d in (4, 20, 264):
        q = torch.zeros(2, 16, d, device=dev)
        with pytest.raises(ValueError):
            attention_fwd_res(q, q, q, 1.0)                   # head dim
        with pytest.raises(ValueError):
            decode_attention(q[:, :1], q, q, 3, 1.0)
    q = torch.zeros(2, 16, 64, device=dev)
    with pytest.raises(ValueError):                           # G = 9
        decode_attention(torch.zeros(1, 9, 64, device=dev), q[:1], q[:1], 3,
                         1.0)
    with pytest.raises(ValueError):
        attention_fwd_res(q, q.transpose(0, 1), q, 1.0)       # strided
    out, lse = attention_fwd_res(q, q, q, 1.0, causal=True)
    with pytest.raises(ValueError):
        attention_bwd(q, q, q, q, 1.0, True)                  # no out / lse
    with pytest.raises(ValueError):
        attention_bwd(q.transpose(0, 1).contiguous().transpose(0, 1), q, q,
                      q, 1.0, True, out=out, lse=lse)         # strided g
    for d in (20, 264):                             # fused, head dim
        qd = torch.zeros(2, 16, d, device=dev)
        with pytest.raises(ValueError, match="head dim"):
            attention_bwd_fused(qd, qd, qd, qd, lse, lse[..., 0], 1.0, True)
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
