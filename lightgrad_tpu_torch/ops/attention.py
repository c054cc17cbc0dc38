"""Scaled-dot-product attention forward: the flash kernel and its plain twin.

Counterpart of ``lightgrad_tpu/ops/attention.py`` (forward only).  On CUDA
tensors :func:`attention_fwd` and :func:`attention_fwd_res` launch the
hand-written flash-forward kernel (``csrc/flash_fwd.cu``); on CPU tensors they
run :func:`attention_fwd_reference`, the plain version of the same function.

Layout as in the JAX package: q (..., S, D); k, v (..., S, D) with the
leading dims' product B/G -- query row block ``b`` reads KV block ``b // G``
(grouped-query, kv-major head order).  ``attention_fwd_res`` also returns the
log-sum-exp residual, (B, S, 1) float32.
"""

from math import prod

import torch

from . import _build, runtime

__all__ = ["attention_fwd", "attention_fwd_res", "attention_fwd_reference"]

_NEG_INF = -1e30


def attention_fwd_reference(q, k, v, scale: float, causal: bool = False,
                            lengths=None, window: int = 0):
    """Plain PyTorch (out, lse): the JAX package's ``xla`` path
    (``_attn_fwd_impl``) written in torch.  Softmax in float32."""
    shape = q.shape
    s, d = shape[-2], shape[-1]
    b = prod(shape[:-2])
    bkv = prod(k.shape[:-2])
    groups = b // bkv
    q4 = q.reshape(bkv, groups, s, d).float()
    k3 = k.reshape(bkv, s, d).float()
    v3 = v.reshape(bkv, s, d).float()
    scores = torch.einsum("bgqd,bkd->bgqk", q4, k3) * scale
    rowv = None
    if causal:
        row = torch.arange(s, device=q.device)[:, None]
        col = torch.arange(s, device=q.device)[None, :]
        ok = col <= row
        if window:
            ok = ok & (row - col < window)
        scores = scores.masked_fill(~ok, _NEG_INF)
    if lengths is not None:
        lens = torch.as_tensor(lengths, device=q.device).reshape(b, 1)
        valid = torch.arange(s, device=q.device)[None, :] < lens      # (b, s)
        colm = valid.reshape(bkv, groups, 1, s)
        rowv = valid.reshape(bkv, groups, s, 1)
        scores = scores.masked_fill(~colm, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    if rowv is not None:
        # padded query rows: zeros and lse 0 (the JAX package's contract)
        p = torch.where(rowv, p, 0.0)
        lse = torch.where(rowv, lse, 0.0)
    out = torch.einsum("bgqk,bkd->bgqd", p, v3).to(q.dtype).reshape(shape)
    return out, lse.reshape(b, s, 1)


def _flash_fwd_cuda(q, k, v, scale, causal):
    shape = q.shape
    s, d = shape[-2], shape[-1]
    b = prod(shape[:-2])
    bkv = prod(k.shape[:-2])
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"attention_fwd: {name} must be a contiguous "
                             f"tensor of q's device and dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention_fwd: unsupported dtype {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"attention_fwd: head dim {d} not in (64, 128)")
    if k.shape[-2:] != (s, d) or v.shape != k.shape or b % bkv:
        raise ValueError(f"attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    out = torch.empty_like(q)
    lse = torch.empty((b, s, 1), device=q.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.lg_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, b // bkv, s, d, float(scale),
            int(bool(causal)), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "lg_flash_fwd")
    runtime.count_launch("attention_fwd")
    return out, lse


def attention_fwd_res(q, k, v, scale: float, causal: bool = False,
                      lengths=None, window: int = 0):
    """(out, lse): flash kernel on CUDA, plain version on CPU.  ``lengths``
    and ``window`` are served by the plain version only; on CUDA they raise
    until the decoder-training slice ports them."""
    if window:
        assert causal, "sliding window attention is causal-only"
    if q.is_cuda:
        if lengths is not None or window:
            raise NotImplementedError(
                "attention_fwd on CUDA: lengths/window are not ported yet")
        return _flash_fwd_cuda(q, k, v, scale, causal)
    return attention_fwd_reference(q, k, v, scale, causal, lengths, window)


def attention_fwd(q, k, v, scale: float, causal: bool = False,
                  lengths=None, window: int = 0):
    return attention_fwd_res(q, k, v, scale, causal, lengths, window)[0]
