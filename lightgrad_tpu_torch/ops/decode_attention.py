"""One decoded token's attention over a fixed-window KV cache.

Counterpart of ``lightgrad_tpu/ops/decode_attention.py``.  On CUDA tensors
:func:`decode_attention` launches ``csrc/decode_attention.cu``: scores,
``col <= pos`` mask, optional window band, softmax and context, with the
visible keys split over :func:`decode_splits` blocks a KV head and, where
a head has more than one, the splits merged by a second kernel (counted as
``decode_attention_merge``).  On CPU tensors it runs
:func:`decode_attention_reference`; :func:`decode_attention_split_reference`
is the split kernel's arithmetic in plain PyTorch.

Grouped-query native: q is (KV, G, hd), the G query heads served by each KV
head (G <= 8 on CUDA); the cache is (KV, W, hd), with any head dim hd % 8 ==
0, 8 <= hd <= 256.  ``pos`` is a host int.
"""

import torch

from . import _build, runtime

__all__ = ["decode_attention", "decode_attention_reference",
           "decode_attention_split_reference", "decode_merge",
           "decode_merge_reference", "decode_splits", "split_bounds",
           "split_partials", "visible_range"]

_NEG_INF = -1e30
# The split planner's constants: the card's SMs (H100 SXM) and the blocks
# it aims at (two an SM); the keys a range is counted in, by dtype: the
# bf16 kernel's stage of 64 keys (csrc/decode_attention.cu: kTcKeys), and
# 32 for the f32 kernel, whose blocks gain from short ranges; the most
# splits the merge takes (kMaxSplit).
SMS = 132
BLOCKS = 2 * SMS
SPLIT_KEYS = {torch.bfloat16: 64, torch.float32: 32}
MAX_SPLITS = 256


def visible_range(W: int, pos: int, window: int = 0):
    """(lo, hi): the cache rows a token at ``pos`` sees, [max(0, pos -
    window + 1), min(pos, W - 1)] (window 0: from 0)."""
    lo = max(0, pos - window + 1) if window else 0
    return lo, min(pos, W - 1)


def decode_splits(KV: int, nv: int, hd: int, dtype) -> int:
    """Blocks a KV head for ``nv`` visible keys: about BLOCKS over the KV
    heads (1 where the heads alone fill them), each range a whole number of
    SPLIT_KEYS[dtype] keys as near as the ranges can be even -- a range of
    65 bf16 keys would take two stages for one key -- and never more than
    ``nv`` (no empty range) or MAX_SPLITS.  ``hd`` does not enter."""
    del hd
    units = -(-nv // SPLIT_KEYS[dtype])          # stages of the range
    per = -(-units // -(-BLOCKS // KV))          # stages a split
    return int(max(1, min(-(-units // per), nv, MAX_SPLITS)))


def split_bounds(lo: int, nv: int, n_split: int):
    """The n_split + 1 boundaries of the kernel's contiguous key ranges:
    lo + s * nv // n_split (n_split clamped to [1, nv])."""
    n_split = max(1, min(n_split, nv))
    return [lo + s * nv // n_split for s in range(n_split + 1)]


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


def split_partials(q, kc, vc, pos: int, scale: float, window: int = 0,
                   n_split: int = 1):
    """The split kernel's partials in plain PyTorch, f32, in its layout: a
    flat tensor of the contexts (KV, n_split, G, hd) relative to each
    range's max, then the maxima m (KV, n_split, G), then the denominators
    l (KV, n_split, G), over the ranges of :func:`split_bounds`."""
    lo, hi = visible_range(kc.shape[1], int(pos), window)
    bounds = split_bounds(lo, hi - lo + 1, n_split)
    qf = q.float()
    ms, ls, accs = [], [], []
    for b, e in zip(bounds[:-1], bounds[1:]):
        s = torch.einsum("kgd,ksd->kgs", qf, kc[:, b:e].float()) * scale
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("kgs,ksd->kgd", p, vc[:, b:e].float()))
    return torch.cat([torch.stack(accs, 1).reshape(-1),
                      torch.stack(ms, 1).reshape(-1),
                      torch.stack(ls, 1).reshape(-1)])


def _unpack(part, KV, G, hd, n_split):
    n = KV * n_split * G
    return (part[:n * hd].reshape(KV, n_split, G, hd),
            part[n * hd:n * (hd + 1)].reshape(KV, n_split, G, 1),
            part[n * (hd + 1):n * (hd + 2)].reshape(KV, n_split, G, 1))


def decode_merge_reference(part, KV: int, G: int, hd: int, n_split: int,
                           dtype=torch.float32):
    """Plain PyTorch merge of split partials (:func:`split_partials`'s
    layout) into (KV, G, hd): sum_s acc_s e^(m_s - M) / sum_s l_s
    e^(m_s - M), M = max_s m_s."""
    acc, m, l = _unpack(part.float(), KV, G, hd, n_split)
    w = torch.exp(m - m.amax(1, keepdim=True))
    return ((acc * w).sum(1) / (l * w).sum(1)).to(dtype)


def decode_attention_split_reference(q, kc, vc, pos: int, scale: float,
                                     window: int = 0, n_split: int = 1):
    """The split kernel's arithmetic in plain PyTorch, f32: each range's
    (m, l, acc) -- row max, denominator, context relative to that max --
    over the ranges of :func:`split_bounds` (n_split clamped to [1, nv]),
    then the merge."""
    lo, hi = visible_range(kc.shape[1], int(pos), window)
    n_split = max(1, min(n_split, hi - lo + 1))
    KV, G, hd = q.shape
    return decode_merge_reference(
        split_partials(q, kc, vc, pos, scale, window, n_split), KV, G, hd,
        n_split, q.dtype)


def decode_merge(part, out, n_split: int):
    """Merge split partials (:func:`split_partials`'s layout, f32) into
    ``out`` (KV, G, hd): the merge kernel on CUDA tensors, its plain
    version on CPU ones.  Returns ``out``."""
    KV, G, hd = out.shape
    if not part.is_cuda:
        return out.copy_(decode_merge_reference(part, KV, G, hd, n_split,
                                                out.dtype))
    if part.dtype != torch.float32 or part.numel() != KV * n_split * G \
            * (hd + 2) or not part.is_contiguous() \
            or not out.is_contiguous() or part.device != out.device:
        raise ValueError(f"decode_merge: partials of {KV * n_split * G} "
                         f"rows of {hd} + 2 f32 on out's device")
    with torch.cuda.device(out.device):
        err = _build.library().lg_decode_merge(
            part.data_ptr(), out.data_ptr(), KV, G, hd, n_split,
            int(out.dtype == torch.bfloat16),
            torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, f"lg_decode_merge (KV={KV}, G={G}, hd={hd}, "
                      f"n_split={n_split})")
    runtime.count_launch("decode_attention_merge")
    return out


def decode_attention(q, kc, vc, pos: int, scale: float, window: int = 0):
    """q (KV, G, hd); kc, vc (KV, W, hd); keys at ``<= pos`` visible,
    optionally banded by ``window``.  Returns (KV, G, hd) in q's dtype."""
    if not q.is_cuda:
        return decode_attention_reference(q, kc, vc, pos, scale, window)
    KV, G, hd = q.shape
    W = kc.shape[1]
    for name, t in (("q", q), ("kc", kc), ("vc", vc)):
        # 16-byte rows: the kernel reads 16 bytes at a time
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be a contiguous, "
                             f"16-byte aligned tensor of q's device and dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: unsupported dtype {q.dtype}")
    if kc.shape != (KV, W, hd) or vc.shape != kc.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs cache "
                         f"{tuple(kc.shape)}, {tuple(vc.shape)}")
    if hd % 8 or not 8 <= hd <= 256 or not 1 <= G <= 8:
        raise ValueError(f"decode_attention: head dim {hd} (a multiple of 8 "
                         f"in [8, 256]) or group {G} (1..8) the kernel lacks")
    pos = int(pos)
    lo, hi = visible_range(W, pos, window)
    if pos < 0 or lo > hi:
        raise ValueError(f"decode_attention: no visible key at pos {pos}, "
                         f"window {window}, W {W}")
    n_split = decode_splits(KV, hi - lo + 1, hd, q.dtype)
    out = torch.empty_like(q)
    part = None if n_split == 1 else torch.empty(
        KV * n_split * G * (hd + 2), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = _build.library().lg_decode_attention(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), KV, G, W, hd, pos,
            int(window), float(scale), n_split,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"lg_decode_attention (G={G}, hd={hd}, W={W}, "
                      f"pos={pos}, window={window}, n_split={n_split})")
    runtime.count_launch("decode_attention")
    return out if part is None else decode_merge(part, out, n_split)
