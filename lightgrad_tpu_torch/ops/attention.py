"""Scaled-dot-product attention: the flash kernels and their plain twins.

Counterpart of ``lightgrad_tpu/ops/attention.py``.  On CUDA tensors
:func:`attention_fwd` and :func:`attention_fwd_res` launch the hand-written
flash-forward kernel (``csrc/flash_fwd.cu``) and :func:`attention_bwd` the
two flash-backward kernels (``csrc/flash_bwd.cu``: the dq pass
:func:`attention_bwd_dq` and the dk/dv pass :func:`attention_bwd_dkv`); on
CPU tensors they run :func:`attention_fwd_reference` and
:func:`attention_bwd_reference`, the plain versions of the same functions.

Layout as in the JAX package: q (..., S, D); k, v (..., S, D) with the
leading dims' product B/G -- query row block ``b`` reads KV block ``b // G``
(grouped-query, kv-major head order).  ``attention_fwd_res`` also returns the
log-sum-exp residual, (B, S, 1) float32.
"""

from math import prod

import torch

from . import _build, runtime

__all__ = ["attention_fwd", "attention_fwd_res", "attention_fwd_reference",
           "attention_bwd", "attention_bwd_dq", "attention_bwd_dkv",
           "attention_bwd_reference"]

_NEG_INF = -1e30


def _probs(q4, k3, scale, causal, lengths, window):
    """Softmax probabilities (f32) of the grouped scores, with the scores
    and the row validity mask (None without ``lengths``)."""
    bkv, groups, s, _ = q4.shape
    dev = q4.device
    scores = torch.einsum("bgqd,bkd->bgqk", q4, k3) * scale
    rowv = None
    if causal:
        row = torch.arange(s, device=dev)[:, None]
        col = torch.arange(s, device=dev)[None, :]
        ok = col <= row
        if window:
            ok = ok & (row - col < window)
        scores = scores.masked_fill(~ok, _NEG_INF)
    if lengths is not None:
        lens = torch.as_tensor(lengths, device=dev).reshape(bkv * groups, 1)
        valid = torch.arange(s, device=dev)[None, :] < lens      # (b, s)
        colm = valid.reshape(bkv, groups, 1, s)
        rowv = valid.reshape(bkv, groups, s, 1)
        scores = scores.masked_fill(~colm, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if rowv is not None:
        # padded query rows: zeros (the JAX package's contract)
        p = torch.where(rowv, p, 0.0)
    return p, scores, rowv


def _grouped(q, k, *rest):
    """(b, bkv, s, d) of the call, q as (bkv, G, s, d) f32, and k and the
    other KV-shaped tensors as (bkv, s, d) f32."""
    s, d = q.shape[-2], q.shape[-1]
    b, bkv = prod(q.shape[:-2]), prod(k.shape[:-2])
    q4 = q.reshape(bkv, b // bkv, s, d).float()
    return (b, bkv, s, d), q4, [t.reshape(bkv, s, d).float()
                                for t in (k, *rest)]


def attention_fwd_reference(q, k, v, scale: float, causal: bool = False,
                            lengths=None, window: int = 0):
    """Plain PyTorch (out, lse): the JAX package's ``xla`` path
    (``_attn_fwd_impl``) written in torch.  Softmax in float32."""
    (b, _, s, _), q4, (k3, v3) = _grouped(q, k, v)
    p, scores, rowv = _probs(q4, k3, scale, causal, lengths, window)
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    if rowv is not None:
        lse = torch.where(rowv, lse, 0.0)
    out = torch.einsum("bgqk,bkd->bgqd", p, v3).to(q.dtype).reshape(q.shape)
    return out, lse.reshape(b, s, 1)


def attention_bwd_reference(g, q, k, v, scale: float, causal: bool = False,
                            out=None, lse=None, lengths=None, window: int = 0):
    """Plain PyTorch (dq, dk, dv): the JAX package's recompute path
    (``_attn_bwd_impl``) written in torch, softmax in float32.  ``out`` and
    ``lse`` are accepted for the signature's sake and not read: the
    probabilities are recomputed from q and k."""
    _, q4, (k3, v3) = _grouped(q, k, v)
    g4 = g.reshape(q4.shape).float()
    p, _, _ = _probs(q4, k3, scale, causal, lengths, window)
    dv = torch.einsum("bgqk,bgqd->bkd", p, g4)
    dp = torch.einsum("bgqd,bkd->bgqk", g4, v3)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bgqk,bkd->bgqd", ds, k3) * scale
    dk = torch.einsum("bgqk,bgqd->bkd", ds, q4) * scale
    return (dq.to(q.dtype).reshape(q.shape), dk.to(k.dtype).reshape(k.shape),
            dv.to(v.dtype).reshape(v.shape))


def _check(fn, q, k, v, **same_as_q):
    """Validate a CUDA call; returns (b, bkv, s, d)."""
    s, d = q.shape[-2], q.shape[-1]
    b, bkv = prod(q.shape[:-2]), prod(k.shape[:-2])
    for name, t in dict(q=q, k=k, v=v, **same_as_q).items():
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous tensor of "
                             f"q's device and dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: unsupported dtype {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"{fn}: head dim {d} not in (64, 128)")
    if k.shape[-2:] != (s, d) or v.shape != k.shape or b % bkv \
            or any(t.shape != q.shape for t in same_as_q.values()):
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    return b, bkv, s, d


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _flash_fwd_cuda(q, k, v, scale, causal):
    b, bkv, s, d = _check("attention_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, s, 1), device=q.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.lg_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, b // bkv, s, d, float(scale),
            int(bool(causal)), int(q.dtype == torch.bfloat16), _stream(q))
    _build.check(err, "lg_flash_fwd")
    runtime.count_launch("attention_fwd")
    return out, lse


def _bwd_launch(entry, fn, g, q, k, v, lse, dcap, scale, causal, *outs):
    b, bkv, s, d = _check(fn, q, k, v, g=g)
    for name, t in (("lse", lse), ("dcap", dcap)):
        if t.dtype != torch.float32 or t.numel() != b * s \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous float32 "
                             f"tensor of B*S = {b * s} elements")
    with torch.cuda.device(q.device):
        err = getattr(_build.library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dcap.data_ptr(), *(t.data_ptr() for t in outs),
            b, b // bkv, s, d, float(scale), int(bool(causal)),
            int(q.dtype == torch.bfloat16), _stream(q))
    _build.check(err, entry)
    runtime.count_launch(fn)


def attention_bwd_dq(g, q, k, v, lse, dcap, scale: float,
                     causal: bool = False):
    """dq of the flash backward given the forward's ``lse`` and
    ``dcap = rowsum(g * out)`` (f32, B*S): the dq kernel on CUDA, the plain
    recompute version (which needs neither) on CPU."""
    if not q.is_cuda:
        return attention_bwd_reference(g, q, k, v, scale, causal)[0]
    dq = torch.empty_like(q)
    _bwd_launch("lg_flash_bwd_dq", "attention_bwd_dq", g, q, k, v, lse, dcap,
                scale, causal, dq)
    return dq


def attention_bwd_dkv(g, q, k, v, lse, dcap, scale: float,
                      causal: bool = False):
    """(dk, dv) of the flash backward, as :func:`attention_bwd_dq`."""
    if not q.is_cuda:
        return attention_bwd_reference(g, q, k, v, scale, causal)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("lg_flash_bwd_dkv", "attention_bwd_dkv", g, q, k, v, lse,
                dcap, scale, causal, dk, dv)
    return dk, dv


def _cuda_unported(fn, lengths, window):
    if lengths is not None or window:
        raise NotImplementedError(
            f"{fn} on CUDA: lengths/window are not ported yet")


def attention_fwd_res(q, k, v, scale: float, causal: bool = False,
                      lengths=None, window: int = 0):
    """(out, lse): flash kernel on CUDA, plain version on CPU.  ``lengths``
    and ``window`` are served by the plain version only; on CUDA they raise
    until the decoder-training slice ports them."""
    if window:
        assert causal, "sliding window attention is causal-only"
    if q.is_cuda:
        _cuda_unported("attention_fwd", lengths, window)
        return _flash_fwd_cuda(q, k, v, scale, causal)
    return attention_fwd_reference(q, k, v, scale, causal, lengths, window)


def attention_fwd(q, k, v, scale: float, causal: bool = False,
                  lengths=None, window: int = 0):
    return attention_fwd_res(q, k, v, scale, causal, lengths, window)[0]


def attention_bwd(g, q, k, v, scale: float, causal: bool = False,
                  out=None, lse=None, lengths=None, window: int = 0):
    """(dq, dk, dv) of ``attention_fwd`` for the output cotangent ``g``.
    On CUDA the two flash-backward kernels, which need the forward's
    ``out`` and ``lse``; on CPU the plain recompute version."""
    if window:
        assert causal, "sliding window attention is causal-only"
    if q.is_cuda:
        _cuda_unported("attention_bwd", lengths, window)
        if out is None or lse is None or out.shape != q.shape:
            raise ValueError("attention_bwd on CUDA needs the forward's "
                             "out and lse")
        # D = rowsum(dO * O) in f32: a plain reduction, as the JAX package
        # leaves it to XLA
        dcap = (g.float() * out.float()).sum(-1).contiguous()
        dq = attention_bwd_dq(g, q, k, v, lse, dcap, scale, causal)
        return (dq, *attention_bwd_dkv(g, q, k, v, lse, dcap, scale, causal))
    return attention_bwd_reference(g, q, k, v, scale, causal, out, lse,
                                   lengths, window)
