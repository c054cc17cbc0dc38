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
                                               attention_bwd_tf32x3_reference,
                                               attention_fwd_res,
                                               attention_fwd_reference,
                                               attention_fwd_tf32x3_reference,
                                               dkv_splits,
                                               flash_block_reference,
                                               fused_rows, set_flash_fused,
                                               TURN_ROWS)
from lightgrad_tpu_torch.ops.conv import (conv_bwd, conv_bwd_dw, conv_bwd_dx,
                                          conv_bwd_reference, conv_fwd,
                                          conv_fwd_reference, conv_route)
from lightgrad_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_batch,
    decode_attention_batch_reference, decode_attention_reference,
    decode_merge, decode_merge_reference, split_partials)
from lightgrad_tpu_torch.ops.decode_stack import (
    decode_stack, decode_stack_batch, decode_stack_batch_reference,
    decode_stack_reference)
from lightgrad_tpu_torch.ops.layernorm import (
    layernorm_bwd, layernorm_bwd_dx, layernorm_bwd_dx_reference,
    layernorm_bwd_reference, layernorm_fwd, layernorm_fwd_reference,
    layernorm_fwd_stats, layernorm_fwd_stats_reference)
from lightgrad_tpu_torch.models.gpt import quantize_rows
from lightgrad_tpu_torch.ops.runtime import (launch_counts,
                                             reset_launch_counts)

pytestmark = pytest.mark.cuda

# f32: three tf32 passes, summed in another order than the reference's
# GEMMs (no TF32);
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
    """The forward (bf16: D 64, 128, 256; f32, three tf32 passes: D 32,
    64, 96, 128, 256) at head dims that are no instantiation (8, 24, 80,
    200), S not a multiple of the 64-row tiles, G 1-8, causal and not, a
    window narrower than a K tile, and lengths of 0, 1 and S (padded rows
    exactly 0, their lse 0)."""
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


@pytest.mark.parametrize("S,G,D,causal,window,lens", [
    (300, 1, 64, True, 0, None), (257, 4, 64, False, 0, "edges"),
    (200, 1, 128, True, 0, "edges"), (300, 4, 128, True, 64, None),
    (150, 4, 256, True, 0, None), (100, 1, 256, True, 33, None),
    (130, 2, 32, True, 0, None), (200, 4, 80, True, 40, None),
    (129, 2, 80, False, 0, "edges"), (64, 1, 256, False, 0, "edges"),
    (129, 4, 16, False, 0, "edges")])
def test_flash_bwd_tf32_kernels(dev, S, G, D, causal, window, lens):
    """The f32 tensor-core dq and dk/dv passes (three tf32 passes) at every
    instantiation (D 32, 64, 96, 128, 256) and through a wider one (d 16,
    80),
    with lengths of 0, 1 and S, a window, and G 4 with the query heads
    shared over dkv_splits blocks, against the plain version within
    TOL[f32]; bit for bit on a rerun; padded rows exactly 0."""
    g = torch.Generator(device=dev).manual_seed(19 * S + G + D + window)
    B = 8
    q, do = (_randn(g, B, S, D) for _ in range(2))
    k, v = (_randn(g, B // G, S, D) for _ in range(2))
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
    if G == 4:      # two KV rows: the dk/dv pass shares out the heads
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert dkv_splits(B // G, G, S, sms) > 1
    want = attention_bwd_reference(do, q, k, v, sc, causal, lengths=lengths,
                                   window=window)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
        _close(a, b, torch.float32)
    again = attention_bwd(do, q, k, v, sc, causal, out=out, lse=lse,
                          lengths=lengths, window=window)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if lengths is not None:
        pad = torch.arange(S, device=dev)[None, :] >= lengths[:, None].long()
        assert bool((got[0][pad] == 0).all())


@pytest.mark.parametrize("S,G,D,causal,window,lens", [
    (100, 1, 8, True, 0, None), (130, 2, 40, False, 0, "edges"),
    (257, 4, 80, True, 1, None), (65, 2, 200, True, 0, "edges"),
    (300, 1, 96, True, 70, None), (77, 8, 128, False, 0, "edges"),
    (129, 1, 32, True, 0, "edges"), (1, 1, 256, True, 0, None)])
def test_flash_fwd_tf32_kernel(dev, S, G, D, causal, window, lens):
    """The f32 forward (three tf32 passes on the tensor cores) at head dims
    that are no instantiation (8, 40, 80, 200) and at D 32, 96, 128, 256,
    S no multiple of the 64- or 128-row query tiles and 32-key tiles, G
    1-8, a window of 1 and one narrower than a tile, lengths of 0, 1 and S:
    against the plain version and the three-pass model within TOL[f32];
    padded rows exactly 0 with an lse of 0; bit for bit on a rerun."""
    g = torch.Generator(device=dev).manual_seed(29 * S + G + D + window)
    B = 8
    q = _randn(g, B, S, D)
    k, v = (_randn(g, B // G, S, D) for _ in range(2))
    lengths = None
    if lens:
        lengths = torch.tensor([0, 1, S, S // 2, 3, S - 1, S, 2],
                               device=dev, dtype=torch.int32)
    sc = D ** -0.5
    reset_launch_counts()
    out, lse = attention_fwd_res(q, k, v, sc, causal, lengths=lengths,
                                 window=window)
    torch.cuda.synchronize()
    assert launch_counts()["attention_fwd"] == 1
    for want in (attention_fwd_reference(q, k, v, sc, causal, lengths,
                                         window),
                 attention_fwd_tf32x3_reference(q, k, v, sc, causal, lengths,
                                                window)):
        _close(out, want[0], torch.float32)
        _close(lse, want[1], torch.float32)
    if lengths is not None:
        pad = torch.arange(S, device=dev)[None, :] >= lengths[:, None]
        assert bool((out[pad] == 0).all()) and bool((lse[..., 0][pad] == 0)
                                                    .all())
    again = attention_fwd_res(q, k, v, sc, causal, lengths=lengths,
                              window=window)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("D", [64, 256])
def test_flash_fwd_f32_is_not_one_tf32_pass(dev, D):
    """The f32 forward meets the bar that the same arithmetic with one tf32
    pass a product fails: within TOL[f32] of the float64 forward (the
    largest error over max(1, the largest |element|))."""
    g = torch.Generator(device=dev).manual_seed(31 + D)
    q, k, v = (_randn(g, 4, 256, D) for _ in range(3))
    sc = D ** -0.5
    got = attention_fwd_res(q, k, v, sc, True)
    one = attention_fwd_tf32x3_reference(q, k, v, sc, True,
                                         product=_one_tf32_pass)
    want = attention_fwd_reference(q.double(), k.double(), v.double(), sc,
                                   True)

    def err(xs):
        return max(((x.double() - w).abs().max()
                    / w.abs().max().clamp_min(1.0)).item()
                   for x, w in zip(xs, want))

    assert err(got) <= TOL[torch.float32], err(got)
    assert err(one) > TOL[torch.float32], err(one)   # tells them apart


@pytest.mark.parametrize("S,D,causal", [(100, 8, True), (130, 40, False),
                                        (257, 80, True), (65, 200, True),
                                        (300, 96, False), (200, 256, True),
                                        (70, 32, True), (1, 64, True)])
def test_flash_fused_tf32_kernel(dev, S, D, causal):
    """The f32 fused backward (three tf32 passes, dq summed over the key
    blocks in order) at head dims that are no instantiation (8, 40, 80,
    200) and at D 32, 64, 96, 256, S no multiple of the key blocks (64 or
    128 rows) or the 32- and 16-row query tiles: against its plain version
    and the three-pass model within TOL[f32]; bit for bit on reruns."""
    g = torch.Generator(device=dev).manual_seed(37 * S + D + causal)
    q, do, k, v = (_randn(g, 4, S, D) for _ in range(4))
    sc = D ** -0.5
    out, lse = attention_fwd_res(q, k, v, sc, causal)
    dcap = (do * out).sum(-1).contiguous()
    reset_launch_counts()
    got = attention_bwd_fused(do, q, k, v, lse, dcap, sc, causal)
    torch.cuda.synchronize()
    assert launch_counts()["attention_bwd_fused"] == 1
    for product in (None, matmul_tf32x3_reference):
        want = attention_bwd_fused_reference(do, q, k, v, out, lse, dcap, sc,
                                             causal, product=product)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
            _close(a, b, torch.float32)
    for _ in range(2):
        again = attention_bwd_fused(do, q, k, v, lse, dcap, sc, causal)
        for a, b in zip(got, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D,causal", [(1024, 64, True), (200, 64, False),
                                        (300, 128, True), (129, 80, False),
                                        (256, 256, True), (100, 200, False),
                                        (200, 8, True)])
def test_flash_fused_kernel_orders_dq(dev, S, D, causal, dtype):
    """The fused kernel (tensor cores; f32 as three tf32 passes), dq summed
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
    bound = B * S * D * (4 + 3 * isz) + 4 * (1 + B * -(-S // TURN_ROWS)) \
        + 2 ** 20
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
@pytest.mark.parametrize("r,c", [(8192, 768), (4096, 2048), (2048, 2560),
                                 (37, 100)])
def test_layernorm_autograd_pair(dev, r, c, dtype):
    """The autograd path's forward (y, mean, rstd: nothing of (r, c) but y)
    and its one backward (dx, dw, db) against their plain versions; dw and
    db bitwise the same from run to run."""
    g = torch.Generator(device=dev).manual_seed(r + c + 1)
    x = _randn(g, r, c, scale=3.0, dtype=dtype) + 1.5
    w, b = _randn(g, c, dtype=dtype), _randn(g, c, dtype=dtype)
    reset_launch_counts()
    y, mean, rstd = layernorm_fwd_stats(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert launch_counts()["layernorm_fwd"] == 1
    ry, rmean, rrstd = layernorm_fwd_stats_reference(x, w, b, 1e-5)
    assert mean.shape == rstd.shape == (r, 1)
    assert mean.dtype == rstd.dtype == torch.float32
    _close(y, ry, dtype)
    _close(mean, rmean, torch.float32)
    _close(rstd, rrstd, torch.float32)
    gy = _randn(g, r, c, dtype=dtype)
    reset_launch_counts()
    got = layernorm_bwd(gy, x, w, mean, rstd)
    torch.cuda.synchronize()
    assert launch_counts()["layernorm_bwd"] == 2
    want = layernorm_bwd_reference(gy, x, w, mean, rstd)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and a.shape == e.shape
        _close(a, e, dtype)
    again = layernorm_bwd(gy, x, w, mean, rstd)
    assert all(torch.equal(a, e) for a, e in zip(got, again))


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
    Mistral-7B's and GPT-2's decode shapes, pos 0, pos past W; planned from
    the most rows the cache shows, so short positions leave blocks empty)
    and at forced ones (256, one key a split, 1, 2): against the plain
    version, one launch of the split kernel, the merge exactly where there
    are splits, and bit for bit on a rerun."""
    import lightgrad_tpu_torch.ops.decode_attention  # noqa: F401
    import sys
    mod = sys.modules["lightgrad_tpu_torch.ops.decode_attention"]
    if n_split is not None:
        monkeypatch.setattr(mod, "decode_splits", lambda *a: n_split)
    n = mod.plan_splits(KV, W, window, hd, dtype)
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
@pytest.mark.parametrize("KV,G,hd,W,window,poss", [
    (8, 4, 128, 8192, 4096, (4600, 32, 700, 8191)),   # Mistral-7B's engine
    (1, 8, 256, 8192, 0, (1200, 16, 500, 0)),         # Gemma-2B's
    (2, 3, 80, 300, 40, (0, 299, 150, 320, 77))])     # any hd, past W
def test_decode_attention_batch_kernel(dev, KV, G, hd, W, window, poss,
                                       dtype):
    """The slot axis: B slots at their own device positions over the
    strided per-slot views of a stacked (B, L, 2, KV, W, hd) cache, one
    launch for all (and one merge), against the plain batched version and
    against B single calls."""
    g = torch.Generator(device=dev).manual_seed(hd + W)
    B, L = len(poss), 2
    caches = _randn(g, B, L, 2, KV, W, hd, dtype=dtype)
    q = _randn(g, B, KV, G, hd, dtype=dtype)
    pt = torch.tensor(poss, device=dev, dtype=torch.int32)
    kc, vc = caches[:, 1, 0], caches[:, 1, 1]
    reset_launch_counts()
    out = decode_attention_batch(q, kc, vc, pt, hd ** -0.5, window)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["decode_attention_batch"] == 1
    assert counts["decode_attention_merge"] <= 1
    want = decode_attention_batch_reference(q, kc, vc, pt, hd ** -0.5,
                                            window)
    _close_ulp(out, want, dtype, 1e-2 if dtype == torch.bfloat16 else 1e-4)
    for b, pos in enumerate(poss):
        one = decode_attention(q[b], kc[b].contiguous(), vc[b].contiguous(),
                               pos, hd ** -0.5, window)
        assert torch.equal(one, out[b])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd,W,window", [(8, 4, 128, 8192, 4096),
                                              (1, 8, 256, 8192, 0),
                                              (12, 1, 64, 1024, 0)])
def test_decode_attention_replays_at_a_device_position(dev, KV, G, hd, W,
                                                       window, dtype):
    """Captured in a CUDA graph at one position, decode attention replays
    at whatever position the int32 tensor then holds: each replay equals an
    eager call at the new position (single and batched)."""
    g = torch.Generator(device=dev).manual_seed(hd)
    q = _randn(g, KV, G, hd, dtype=dtype)
    kc, vc = (_randn(g, KV, W, hd, dtype=dtype) for _ in range(2))
    qb = _randn(g, 3, KV, G, hd, dtype=dtype)
    kb, vb = (_randn(g, 3, KV, W, hd, dtype=dtype) for _ in range(2))
    pos = torch.tensor([5], device=dev, dtype=torch.int32)
    poss = torch.tensor([5, 9, 1], device=dev, dtype=torch.int32)
    fns = (lambda: decode_attention(q, kc, vc, pos, hd ** -0.5, window),
           lambda: decode_attention_batch(qb, kb, vb, poss, hd ** -0.5,
                                          window))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn in fns]
    # past W; far past it only unbanded (a band there sees no key)
    for p in (5, 100, W - 1, W + 300) + (() if window else (2 * W,)):
        pos.fill_(p)
        poss.copy_(torch.tensor([p, max(0, p - 77), p // 2], device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(outs[0], decode_attention(q, kc, vc, p,
                                                     hd ** -0.5, window))
        assert torch.equal(outs[1], decode_attention_batch(
            qb, kb, vb, poss.clone(), hd ** -0.5, window))
        _close_ulp(outs[0], decode_attention_reference(
            q, kc, vc, p, hd ** -0.5, window), dtype,
            1e-2 if dtype == torch.bfloat16 else 1e-4)


def _sync_free(fn):
    """Run ``fn`` under sync debug mode "error": any host read of a device
    value raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("window", [None, 6])
def test_llama_step_and_step_batch_do_not_synchronise(dev, window):
    """LLaMA's step at a device position and its batched step_batch never
    read a position to the host; step_batch equals one step a slot."""
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig

    lg_random.seed(0)
    model = Llama(LlamaConfig(vocab_size=64, hidden_size=64,
                              intermediate_size=96, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2,
                              max_position_embeddings=16,
                              sliding_window=window))
    fns = model._kv_functions()
    toks = torch.randint(0, 64, (16,), device=dev)
    caches = torch.stack([fns.init_cache() for _ in range(3)])
    for b, n in enumerate((5, 9, 2)):
        fns.prefill(caches[b], toks, n)
    poss = torch.tensor([5, 9, 2], device=dev, dtype=torch.int32)
    nxt = torch.tensor([3, 7, 11], device=dev)
    ref = caches.clone()
    singles = [fns.step(ref[b], poss[b], nxt[b])[1] for b in range(3)]
    _, logits = _sync_free(lambda: fns.step_batch(caches, poss, nxt))
    one = _sync_free(lambda: fns.step(ref[0].clone(), poss[0], nxt[0])[1])
    for b in range(3):
        _close(logits[b], singles[b], torch.float32)
    _close(one, singles[0], torch.float32)
    _close(caches, ref, torch.float32)


@pytest.mark.parametrize("window", [None, 5])
def test_llama_generate_batch_and_engine_match_generate(dev, window):
    """On the card: LLaMA's greedy ``generate_batch`` (the batched
    ``step_batch``) and an engine of 2 slots over 3 ragged requests give
    each prompt's one-by-one ``generate`` tokens."""
    from lightgrad_tpu_torch import InferenceEngine, random as lg_random
    from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig

    lg_random.seed(1)
    model = Llama(LlamaConfig(vocab_size=61, hidden_size=64,
                              intermediate_size=96, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2,
                              max_position_embeddings=32,
                              sliding_window=window))
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 61, (n,), generator=g).tolist()
               for n in (4, 13, 9)]
    want = [model.generate(p, max_new_tokens=7) for p in prompts]
    assert model.generate_batch(prompts, max_new_tokens=7) == want
    engine = InferenceEngine(model, slots=2)
    reqs = [engine.submit(p, 7) for p in prompts]
    engine.run()
    assert [r.tokens for r in reqs] == want


def test_gpt_step_does_not_synchronise(dev):
    """GPT-2's step at a device position, through the stack kernel and
    through the unrolled branch, never reads it to the host."""
    from lightgrad_tpu_torch import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=128, n_positions=64, n_embd=128, n_layer=2,
                    n_head=2)
    model = GPT(cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, 128, (64,), device=dev)
    for pack in (True, False):
        fns = model._kv_functions(pack_stack=pack)
        cache = fns.init_cache()
        fns.prefill(cache, toks, 10)
        ref = cache.clone()
        want = fns.step(ref, 10, 42)[1]
        pos = torch.tensor(10, device=dev, dtype=torch.int32)
        tok = torch.tensor(42, device=dev)
        got = _sync_free(lambda: fns.step(cache, pos, tok)[1])
        _close(got, want, torch.float32)
        _close(cache, ref, torch.float32)


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
                                            matmul_tf32x3_reference,
                                            matmul_vjp, tf32_round)
from lightgrad_tpu_torch.ops.reduce import reduce, reduce_reference  # noqa
import importlib  # noqa: E402

# the module: the package's ``ops.reduce`` is the function
rmod = importlib.import_module("lightgrad_tpu_torch.ops.reduce")
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
    assert launch_counts()["reduce"] == _launches(x, axis)
    want = reduce_reference(x, op, axis=axis)
    assert got.shape == want.shape and got.dtype == want.dtype
    _close(got, want, dtype)


def _launches(x, axis):
    """1, or 2 where the plan splits R (the second stage)."""
    axes = rmod._normalize_axes(axis, x.dim())
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = rmod._plan(x.shape, x.stride(), axes, x.element_size(), n_sm)
    if plan is None:
        keep = [d for d in range(x.dim()) if d not in axes]
        y = x.permute(*keep, *axes).contiguous()
        plan = rmod._plan(y.shape, y.stride(), range(len(keep), x.dim()),
                          x.element_size(), n_sm)
    return 1 + (plan.splits1 * plan.splits2 > 1)


# the layout classes of the main paths: rows, columns, BatchNorm's
# three-stride walk, a whole tensor, and views
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("shape,axis,how", [
    ((1024, 30522), -1, None), ((8192, 768), 0, None),
    ((8, 128, 3072), (0, 1), None), ((2, 2048, 6144), (0, 1), None),
    ((32, 64, 56, 56), (0, 2, 3), None), ((32, 512, 7, 7), (0, 2, 3), None),
    ((32, 128, 28, 28), (0, 2, 3), None), ((32, 64, 56, 56), None, None),
    ((9, 32, 64, 56, 56), 0, None), ((1, 8192, 4096), 2, None),
    ((4097, 33), None, None), ((300, 1000), 0, "t"), ((9, 40, 1000), (0, 2),
                                                      "slice")])
def test_reduce_layouts(dev, shape, axis, how, op, dtype):
    g = torch.Generator(device=dev).manual_seed(11)
    x = _randn(g, *shape, dtype=dtype)
    if how == "t":
        x = x.T
    elif how == "slice":
        x = x[1:, ::2, 3:]
    got = reduce(x, op, axis=axis)
    want = reduce_reference(x, op, axis=axis)
    assert got.shape == want.shape and got.dtype == want.dtype
    _close(got, want, dtype)
    assert torch.equal(reduce(x, op, axis=axis, keepdims=True),
                       got.reshape(reduce_reference(
                           x, op, axis=axis, keepdims=True).shape))


def test_reduce_batchnorm_axes_make_no_copy(dev):
    """(0, 2, 3) over a 32 x 64 x 56 x 56 f32 NCHW tensor is read in place:
    the call allocates less than 1% of the input beyond nothing."""
    x = torch.randn(32, 64, 56, 56, device=dev)
    reduce(x, "sum", axis=(0, 2, 3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    y = reduce(x, "sum", axis=(0, 2, 3))
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - before
    assert grown < 0.01 * x.numel() * x.element_size(), grown
    _close(y, reduce_reference(x, "sum", axis=(0, 2, 3)), torch.float32)


def test_reduce_split_is_bitwise_repeatable(dev):
    """A split column sum and a split whole-tensor sum give the same bits
    in every run (fixed-order partials, no atomics)."""
    x = torch.randn(8192, 768, device=dev)
    assert _launches(x, 0) == 2
    first = reduce(x, "sum", axis=0)
    for _ in range(3):
        assert torch.equal(reduce(x, "sum", axis=0), first)
    whole = reduce(x, "sum")
    assert torch.equal(reduce(x, "sum"), whole)


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


def _f64_err(got, a, b):
    """Largest error of ``got`` against the float64 product a @ b, over the
    largest |element| of that product (at least 1)."""
    want = torch.matmul(a.double(), b.double())
    return ((got.double() - want).abs().max()
            / want.abs().max().clamp_min(1.0)).item()


def _misaligned(g, *shape, dtype):
    """A tensor of ``shape`` whose storage starts one element past a 16-byte
    boundary, so its rows cannot feed 16-byte copies."""
    n = 1
    for s in shape:
        n *= s
    return _randn(g, n + 1, dtype=dtype)[1:].reshape(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "small_k", "both_transposed",
                                  "broadcast_batch", "attention_views",
                                  "misaligned", "no_unit_stride", "k_zero",
                                  "folded_vjp", "gemv"])
def test_matmul_tensor_core_shapes(dev, case, dtype):
    """The tensor-core kernel at the edges of its contract: ragged M, N and
    K (M < 64, K not a multiple of a stage's depth), both operands
    transposed, a broadcast batch, attention's (b, h, s, d) views, operands
    at a storage offset that breaks 16-byte alignment, operands with no
    unit stride (element loads), K = 0, the VJP's
    weight gradient with the batch folded into K, and one row.  bf16
    against the plain version; f32 against the float64 product within
    TOL[f32] and within 4x cuBLAS f32's own error (TF32 off)."""
    import importlib
    mm = importlib.import_module("lightgrad_tpu_torch.ops.matmul")
    g = torch.Generator(device=dev).manual_seed(21)
    r = lambda *s: _randn(g, *s, dtype=dtype)  # noqa: E731
    if case == "ragged":
        pairs = [(r(37, 19), r(19, 45)), (r(5, 200), r(200, 130))]
    elif case == "small_k":
        pairs = [(r(70, 3), r(3, 300)), (r(129, 33), r(33, 257))]
    elif case == "both_transposed":
        pairs = [(r(96, 200).T, r(72, 96).T), (r(40, 8).T, r(16, 40).T)]
    elif case == "broadcast_batch":
        pairs = [(r(2, 1, 70, 64), r(3, 64, 136)), (r(150, 72), r(4, 72, 24))]
    elif case == "attention_views":
        q = r(2, 200, 4 * 64).reshape(2, 200, 4, 64).transpose(1, 2)
        k = r(2, 200, 4 * 64).reshape(2, 200, 4, 64).transpose(1, 2)
        pairs = [(q, k.transpose(-1, -2)), (r(2, 4, 200, 200), k)]
    elif case == "misaligned":
        pairs = [(_misaligned(g, 130, 64, dtype=dtype), r(64, 96)),
                 (r(130, 64), _misaligned(g, 96, 64, dtype=dtype).T)]
    elif case == "no_unit_stride":
        pairs = [(r(40, 96)[:, ::2], r(48, 30)),
                 (r(40, 48), r(48, 60)[:, ::2])]
    elif case == "k_zero":
        pairs = [(r(33, 0), r(0, 17))]
    elif case == "folded_vjp":
        pairs = []
    else:
        pairs = [(r(1, 768), r(3072, 768).T), (r(768, 1).T, r(768, 40))]
    for a, b in pairs:
        mm.loader_counts.update(dict.fromkeys(mm.LOADERS, 0))
        reset_launch_counts()
        got = matmul(a, b)
        torch.cuda.synchronize()
        assert launch_counts()["matmul"] == 1
        assert launch_counts()["matmul_pack"] == 0
        assert got.shape == torch.broadcast_shapes(
            a.shape[:-2], b.shape[:-2]) + (a.shape[-2], b.shape[-1])
        if case == "misaligned":   # 4-byte copies (f32), element loads
            n_elem = mm.loader_counts["elem-k"] + mm.loader_counts["elem-mn"]
            assert (n_elem, mm.loader_counts["scalar"]) == (
                (1, 0) if dtype == torch.float32 else (0, 1))
        _check_matmul(got, a, b, dtype)
    if case == "folded_vjp":
        x, w = r(4, 96, 160), r(120, 160)
        gy = r(4, 96, 120)
        ga, gb = matmul_vjp(gy, x, w.T)
        _check_matmul(ga, gy, w, dtype)
        _check_matmul(gb, x.reshape(-1, 160).T, gy.reshape(-1, 120), dtype)


# f32 against float64: 4x cuBLAS f32's own error, or 4 ulps of the
# product's scale where cuBLAS is exact to its last bits (a short K)
F32_ULPS = 4 * 2.0 ** -23


def _check_matmul(got, a, b, dtype):
    if dtype == torch.bfloat16:
        _close(got, matmul_reference(a, b), dtype)
        return
    err = _f64_err(got, a, b)
    lib = _f64_err(torch.matmul(a, b), a, b)
    assert err <= TOL[torch.float32], err
    assert err <= max(4 * lib, F32_ULPS), (err, lib)


def test_matmul_f32_is_not_one_tf32_pass(dev):
    """The f32 kernel meets the bar that cuBLAS with TF32 on fails: within
    4x cuBLAS f32's error against the float64 product (TF32 off)."""
    g = torch.Generator(device=dev).manual_seed(22)
    a, b = _randn(g, 1024, 768), _randn(g, 3072, 768).T
    err = _f64_err(matmul(a, b), a, b)
    lib = _f64_err(torch.matmul(a, b), a, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = _f64_err(torch.matmul(a, b), a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    bar = max(4 * lib, F32_ULPS)
    assert err <= bar, (err, lib)
    assert tf32 > bar, (tf32, bar)                # the bar tells them apart


def _one_tf32_pass(a, b):
    """One tf32 product: each operand rounded to tf32, summed in f64."""
    return torch.matmul(tf32_round(a).double(), tf32_round(b).double()).float()


@pytest.mark.parametrize("D", [64, 256])
def test_flash_bwd_f32_is_not_one_tf32_pass(dev, D):
    """The f32 passes meet the bar that the same arithmetic with one tf32
    pass a product fails: within TOL[f32] of the float64 backward (the
    largest error over max(1, the largest |element|))."""
    g = torch.Generator(device=dev).manual_seed(23 + D)
    q, do, k, v = (_randn(g, 4, 256, D) for _ in range(4))
    sc = D ** -0.5
    out, lse = attention_fwd_res(q, k, v, sc, True)
    got = attention_bwd(do, q, k, v, sc, True, out=out, lse=lse)
    one = attention_bwd_tf32x3_reference(do, q, k, v, out, lse, sc, True,
                                         product=_one_tf32_pass)
    # the causal backward in float64 (the plain version computes in f32)
    q4, k4, v4, g4 = (t.double() for t in (q, k, v, do))
    s = torch.einsum("bqd,bkd->bqk", q4, k4) * sc
    s = s.masked_fill(torch.ones_like(s[0], dtype=torch.bool).triu(1),
                      float("-inf"))
    p = torch.softmax(s, -1)
    dp = torch.einsum("bqd,bkd->bqk", g4, v4)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    want = (torch.einsum("bqk,bkd->bqd", ds, k4) * sc,
            torch.einsum("bqk,bqd->bkd", ds, q4) * sc,
            torch.einsum("bqk,bqd->bkd", p, g4))

    def err(x, w):
        return ((x.double() - w).abs().max()
                / w.abs().max().clamp_min(1.0)).item()

    kernel = max(err(a, w) for a, w in zip(got, want))
    tf32 = max(err(a, w) for a, w in zip(one, want))
    assert kernel <= TOL[torch.float32], kernel
    assert tf32 > TOL[torch.float32], tf32       # the bar tells them apart


@pytest.mark.parametrize("sa,sb", [((1024, 768), (3072, 768)),
                                   ((37, 19), (45, 19))])
def test_matmul_default_precision(dev, sa, sb):
    """set_precision('default'): f32 operands rounded to bf16, one pass, an
    f32 result, against its plain version."""
    from lightgrad_tpu_torch.ops.matmul import (matmul_default_reference,
                                                set_precision)
    g = torch.Generator(device=dev).manual_seed(23)
    a, b = _randn(g, *sa), _randn(g, *sb).T
    prev = set_precision("default")
    try:
        got = matmul(a, b)
    finally:
        set_precision(prev)
    assert got.dtype == torch.float32
    want = matmul_default_reference(a, b)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.abs().max().item()), err


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
# (x, w, strides, dilation, groups, route): the route conv_route gives in
# both dtypes ("tc": csrc/conv_tc.cu, "simt": csrc/conv.cu)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xs,ws,st,dl,groups,route", [
    ((2, 3, 230, 230), (64, 3, 7, 7), 2, 1, 1, "tc"),     # the stem
    ((2, 64, 58, 58), (64, 64, 3, 3), 1, 1, 1, "tc"),     # layer 1
    ((2, 64, 58, 58), (128, 64, 3, 3), 2, 1, 1, "tc"),    # layer 2's first
    ((2, 128, 30, 30), (128, 128, 3, 3), 1, 1, 1, "tc"),  # layer 2
    ((2, 64, 56, 56), (128, 64, 1, 1), 2, 1, 1, "tc"),    # 1x1/s2 projection
    ((2, 128, 30, 30), (256, 128, 3, 3), 2, 1, 1, "tc"),  # layer 3's first
    ((2, 256, 16, 16), (256, 256, 3, 3), 1, 1, 1, "tc"),  # layer 3
    ((2, 128, 28, 28), (256, 128, 1, 1), 2, 1, 1, "tc"),  # its projection
    ((2, 256, 16, 16), (512, 256, 3, 3), 2, 1, 1, "tc"),  # layer 4's first
    ((2, 512, 9, 9), (512, 512, 3, 3), 1, 1, 1, "tc"),    # layer 4 (splits)
    ((2, 256, 14, 14), (512, 256, 1, 1), 2, 1, 1, "tc"),  # its projection
    ((2, 64, 13, 11), (128, 16, 3, 3), 1, 1, 4, "tc"),    # grouped, Cg 16
    ((2, 32, 21, 19), (64, 32, 3, 3), 1, 2, 1, "tc"),     # dilated
    ((2, 32, 37), (64, 32, 5), 2, 1, 1, "tc"),            # 1-D
    ((2, 16, 7, 9, 8), (32, 16, 3, 2, 3), (1, 2, 1), (2, 1, 1), 1,
     "tc"),                                               # 3-D
    ((2, 1, 30, 30), (8, 1, 3, 3), 1, 1, 1, "simt"),      # MNIST's first conv
    ((2, 16, 34, 34), (16, 16, 3, 3), 1, 1, 1, "simt"),   # ResNet-20 layer 1
    ((2, 16, 21, 19), (32, 4, 3, 3), 1, 2, 4, "simt"),    # grouped, dilated
    ((2, 8, 17, 15), (8, 1, 3, 3), 2, 1, 8, "simt"),      # depthwise, strided
    ((2, 6, 37), (10, 6, 5), 2, 1, 1, "simt"),            # 1-D
    ((2, 4, 7, 9, 8), (6, 2, 3, 2, 3), (1, 2, 1), (2, 1, 1), 2,
     "simt"),                                             # 3-D
    # ResNet-20 on the digits path (batch 128, 28 x 28): its 16-channel
    # layer, then every conv on the tensor cores (f32 K 144: a partial stage)
    ((128, 16, 30, 30), (16, 16, 3, 3), 1, 1, 1, "simt"),
    ((128, 16, 30, 30), (32, 16, 3, 3), 2, 1, 1, "tc"),
    ((128, 16, 28, 28), (32, 16, 1, 1), 2, 1, 1, "tc"),
    ((128, 32, 16, 16), (32, 32, 3, 3), 1, 1, 1, "tc"),
    ((128, 32, 16, 16), (64, 32, 3, 3), 2, 1, 1, "tc"),
    ((128, 32, 14, 14), (64, 32, 1, 1), 2, 1, 1, "tc"),
    ((128, 64, 9, 9), (64, 64, 3, 3), 1, 1, 1, "tc"),
], ids=str)
def test_conv_kernels(dev, xs, ws, st, dl, groups, route, dtype):
    assert conv_route(xs, ws, groups, dtype) == route
    sfx = "" if route == "tc" else "_simt"
    g = torch.Generator(device=dev).manual_seed(sum(xs) + sum(ws))
    x = _randn(g, *xs, dtype=dtype)
    w = _randn(g, *ws, scale=0.1, dtype=dtype)
    reset_launch_counts()
    y = conv_fwd(x, w, st, dl, groups)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["conv_fwd" + sfx] == 1
    # the tensor-core route stages x and the weight
    assert counts["conv_layout"] == (2 if route == "tc" else 0)
    want = conv_fwd_reference(x, w, st, dl, groups)
    assert y.shape == want.shape and y.dtype == want.dtype
    _close(y, want, dtype)
    gy = _randn(g, *want.shape, dtype=dtype)
    reset_launch_counts()
    gx, gw = conv_bwd(gy, x, w, st, dl, groups)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["conv_bwd_dx" + sfx] == counts["conv_bwd_dw" + sfx] == 1
    # bf16: dy once for both gradients, the weight for dx, x for dw; f32:
    # dy's tf32 parts and the weight's for dx, raw dy and x for dw
    want = 3 if dtype == torch.bfloat16 else 4
    assert counts["conv_layout"] == (want if route == "tc" else 0)
    rgx, rgw = conv_bwd_reference(gy, x, w, st, dl, groups)
    _close(gx, rgx, dtype)
    _close(gw, rgw, dtype)
    again = conv_bwd(gy, x, w, st, dl, groups)        # no atomics
    assert torch.equal(gx, again[0]) and torch.equal(gw, again[1])
    assert torch.equal(gx, conv_bwd_dx(gy, w, x.shape, st, dl, groups))
    assert torch.equal(gw, conv_bwd_dw(gy, x, w.shape, st, dl, groups))
    assert conv_bwd(gy, x, w, st, dl, groups, need_dx=False)[0] is None
