"""One decoded token's attention over a fixed-window KV cache.

Counterpart of ``lightgrad_tpu/ops/decode_attention.py``.  On CUDA tensors
:func:`decode_attention` launches ``csrc/decode_attention.cu`` (scores,
``col <= pos`` mask, optional window band, softmax and context in one
launch); on CPU tensors it runs :func:`decode_attention_reference`.

Grouped-query native: q is (KV, G, hd), the G query heads served by each KV
head (G <= 8 on CUDA); the cache is (KV, W, hd), with any head dim hd % 8 ==
0, 8 <= hd <= 256.  ``pos`` is a host int.
"""

import torch

from . import _build, runtime

__all__ = ["decode_attention", "decode_attention_reference"]

_NEG_INF = -1e30


def decode_attention_reference(q, kc, vc, pos: int, scale: float,
                               window: int = 0):
    """Plain PyTorch version (the JAX package's ``_xla_impl``), f32 math."""
    W = kc.shape[1]
    col = torch.arange(W, device=q.device)
    ok = col <= pos
    if window:
        ok = ok & (col > pos - window)
    s = torch.einsum("kgd,ksd->kgs", q.float(), kc.float()) * scale
    s = s.masked_fill(~ok[None, None, :], _NEG_INF)
    out = torch.einsum("kgs,ksd->kgd", torch.softmax(s, dim=-1), vc.float())
    return out.to(q.dtype)


def decode_attention(q, kc, vc, pos: int, scale: float, window: int = 0):
    """q (KV, G, hd); kc, vc (KV, W, hd); keys at ``<= pos`` visible,
    optionally banded by ``window``.  Returns (KV, G, hd) in q's dtype."""
    if not q.is_cuda:
        return decode_attention_reference(q, kc, vc, pos, scale, window)
    KV, G, hd = q.shape
    W = kc.shape[1]
    for name, t in (("q", q), ("kc", kc), ("vc", vc)):
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a contiguous "
                             f"tensor of q's device and dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: unsupported dtype {q.dtype}")
    if kc.shape != (KV, W, hd) or vc.shape != kc.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs cache "
                         f"{tuple(kc.shape)}, {tuple(vc.shape)}")
    if hd % 8 or not 8 <= hd <= 256 or not 1 <= G <= 8:
        raise ValueError(f"decode_attention: head dim {hd} (a multiple of 8 "
                         f"in [8, 256]) or group {G} (1..8) the kernel lacks")
    pos = int(pos)
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.lg_decode_attention(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), KV, G,
            W, hd, pos, int(window), float(scale),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"lg_decode_attention (G={G}, hd={hd}, W={W}, "
                      f"pos={pos}, window={window})")
    runtime.count_launch("decode_attention")
    return out
