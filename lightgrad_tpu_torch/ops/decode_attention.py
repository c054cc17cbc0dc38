"""One decoded token's attention over a fixed-window KV cache.

Counterpart of ``lightgrad_tpu/ops/decode_attention.py``.  On CUDA tensors
:func:`decode_attention` launches ``csrc/decode_attention.cu``: scores,
``col <= pos`` mask, optional window band, softmax and context, with the
keys split over :func:`decode_splits` blocks a KV head and, where a head
has more than one, the splits merged by a second kernel (counted as
``decode_attention_merge``).  :func:`decode_attention_batch` is the same
kernel with a slot axis: B slots, each with its own position and cache,
in one launch -- the JAX package's ``jax.vmap`` of the kernel under
LLaMA's batched decode step.  On CPU tensors they run
:func:`decode_attention_reference` / :func:`decode_attention_batch_reference`;
:func:`decode_attention_split_reference` is the split kernel's arithmetic
in plain PyTorch.

Grouped-query native: q is (KV, G, hd), the G query heads served by each KV
head (G <= 8 on CUDA); the cache is (KV, W, hd), with any head dim hd % 8 ==
0, 8 <= hd <= 256.  ``pos`` is a host int or an int32 tensor of one element
on q's device, which the kernel reads there (the JAX kernel's SMEM scalar):
a step captured in a CUDA graph replays at whatever position the tensor
then holds, and nothing reads it to the host.  The split count is planned
from the most rows the cache can show, ``min(W, window or W)``, never from
the position; at a short position some blocks find no key and write an
empty partial, which the merge weighs 0.
"""

import torch

from . import _build, runtime

__all__ = ["decode_attention", "decode_attention_batch",
           "decode_attention_batch_reference", "decode_attention_reference",
           "decode_attention_split_reference", "decode_merge",
           "decode_merge_reference", "decode_splits", "max_visible",
           "plan_splits", "split_bounds", "split_partials", "visible_range"]

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


def max_visible(W: int, window: int = 0) -> int:
    """The most cache rows a token can see: the window, or all W."""
    return window if 0 < window < W else W


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


def plan_splits(KV: int, W: int, window: int, hd: int, dtype) -> int:
    """The kernel's split count: :func:`decode_splits` over the most rows
    the cache can show (:func:`max_visible`), whatever the position."""
    return decode_splits(KV, max_visible(W, window), hd, dtype)


def split_bounds(lo: int, nv: int, n_split: int):
    """The n_split + 1 boundaries of the kernel's contiguous key ranges:
    lo + s * nv // n_split; where n_split exceeds nv some are empty."""
    return [lo + s * nv // n_split for s in range(n_split + 1)]


def _col_mask(W: int, pos, window: int, device):
    """(..., W) visibility of the cache rows at ``pos`` (an int, or an
    int tensor of any shape), read on the device: ``col <= pos`` and, with
    a window, ``col > pos - window``."""
    col = torch.arange(W, device=device)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=device, dtype=torch.long)[..., None]
    ok = col <= pos
    if window:
        ok = ok & (col > pos - window)
    return ok


def decode_attention_reference(q, kc, vc, pos, scale: float,
                               window: int = 0):
    """Plain PyTorch version (the JAX package's ``_xla_impl``), f32 math;
    ``pos`` a host int or a one-element tensor, not read to the host."""
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(())
    ok = _col_mask(kc.shape[1], pos, window, q.device)
    s = torch.einsum("kgd,ksd->kgs", q.float(), kc.float()) * scale
    s = s.masked_fill(~ok[None, None, :], _NEG_INF)
    out = torch.einsum("kgs,ksd->kgd", torch.softmax(s, dim=-1), vc.float())
    return out.to(q.dtype)


def decode_attention_batch_reference(q, kc, vc, poss, scale: float,
                                     window: int = 0):
    """Plain version of :func:`decode_attention_batch`: slot b's queries q[b]
    (KV, G, hd) over its cache kc[b], vc[b] (KV, W, hd) at poss[b]."""
    ok = _col_mask(kc.shape[2], poss, window, q.device)          # (B, W)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), kc.float()) * scale
    s = s.masked_fill(~ok[:, None, None, :], _NEG_INF)
    out = torch.einsum("bkgs,bksd->bkgd", torch.softmax(s, dim=-1),
                       vc.float())
    return out.to(q.dtype)


def split_partials(q, kc, vc, pos, scale: float, window: int = 0,
                   n_split: int = 1):
    """The split kernel's partials in plain PyTorch, f32, in its layout: a
    flat tensor of the contexts (KV, n_split, G, hd) relative to each
    range's max, then the maxima m (KV, n_split, G), then the denominators
    l (KV, n_split, G), over the visible rows cut at lo + s * nv //
    n_split.  ``pos`` stays on the device: each range is a mask over all
    W rows, and an empty one gives the kernel's empty partial (m -1e30, l
    0, context 0)."""
    W = kc.shape[1]
    if isinstance(pos, torch.Tensor):
        p = pos.reshape(()).to(device=q.device, dtype=torch.long)
    else:
        p = torch.tensor(int(pos), device=q.device)
    hi = p.clamp(max=W - 1)
    lo = (p - window + 1).clamp(min=0) if window else torch.zeros_like(p)
    nv = (hi - lo + 1).clamp(min=0)
    col = torch.arange(W, device=q.device)
    s = torch.einsum("kgd,ksd->kgs", q.float(), kc.float()) * scale
    vf = vc.float()
    ms, ls, accs = [], [], []
    for sp in range(n_split):
        b = lo + sp * nv // n_split
        e = lo + (sp + 1) * nv // n_split
        ok = (col >= b) & (col < e)
        sm = s.masked_fill(~ok, _NEG_INF)
        m = sm.amax(-1)
        pr = torch.where(ok, torch.exp(sm - m[..., None]), 0.0)
        ms.append(m)
        ls.append(pr.sum(-1))
        accs.append(torch.einsum("kgs,ksd->kgd", pr, vf))
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


def decode_attention_split_reference(q, kc, vc, pos, scale: float,
                                     window: int = 0, n_split: int = 1):
    """The split kernel's arithmetic in plain PyTorch, f32: each range's
    (m, l, acc) -- row max, denominator, context relative to that max --
    over the ranges of :func:`split_partials` (empty where n_split exceeds
    the visible rows), then the merge."""
    KV, G, hd = q.shape
    return decode_merge_reference(
        split_partials(q, kc, vc, pos, scale, window, n_split), KV, G, hd,
        n_split, q.dtype)


def decode_merge(part, out, n_split: int):
    """Merge split partials (:func:`split_partials`'s layout, f32, one such
    block a slot) into ``out`` (KV, G, hd) or (B, KV, G, hd): the merge
    kernel on CUDA tensors, its plain version on CPU ones.  Returns
    ``out``."""
    KV, G, hd = out.shape[-3:]
    B = out.numel() // (KV * G * hd)
    if not part.is_cuda:
        per = KV * n_split * G * (hd + 2)
        for b, o in enumerate(out.reshape(B, KV, G, hd)):
            o.copy_(decode_merge_reference(part[b * per:(b + 1) * per], KV, G,
                                           hd, n_split, out.dtype))
        return out
    if part.dtype != torch.float32 or part.numel() != B * KV * n_split * G \
            * (hd + 2) or not part.is_contiguous() \
            or not out.is_contiguous() or part.device != out.device:
        raise ValueError(f"decode_merge: partials of {B * KV * n_split * G} "
                         f"rows of {hd} + 2 f32 on out's device")
    with torch.cuda.device(out.device):
        err = _build.library().lg_decode_merge(
            part.data_ptr(), out.data_ptr(), B, KV, G, hd, n_split,
            int(out.dtype == torch.bfloat16),
            torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, f"lg_decode_merge (B={B}, KV={KV}, G={G}, hd={hd}, "
                      f"n_split={n_split})")
    runtime.count_launch("decode_attention_merge")
    return out


def _check_pos(pos, n, dev, name):
    """A device position tensor: int32, ``n`` elements, contiguous, on
    ``dev``."""
    if pos.dtype != torch.int32 or pos.numel() != n or pos.device != dev \
            or not pos.is_contiguous():
        raise ValueError(f"{name}: positions must be {n} contiguous int32 on "
                         f"{dev}, got {pos.dtype} {tuple(pos.shape)} on "
                         f"{pos.device}")


def _launch(name, q, kc, vc, pos, scale, window):
    """q (B, KV, G, hd) contiguous; kc, vc (B, KV, W, hd), each slot's
    (KV, W, hd) contiguous, slots kc.stride(0) apart (vc's alike); pos an
    int (every slot) or a (B,) int32 device tensor."""
    B, KV, G, hd = q.shape
    W = kc.shape[2]
    inner = (W * hd, hd, 1)
    for tname, t in (("q", q), ("kc", kc), ("vc", vc)):
        # 16-byte rows: the kernel reads 16 bytes at a time
        if t.device != q.device or t.dtype != q.dtype or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be a 16-byte aligned "
                             f"tensor of q's device and dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    if kc.shape != (B, KV, W, hd) or vc.shape != kc.shape \
            or not q.is_contiguous() or kc.stride()[1:] != inner \
            or vc.stride() != kc.stride() \
            or (B > 1 and kc.stride(0) * kc.element_size() % 16):
        raise ValueError(f"{name}: q {tuple(q.shape)} vs caches "
                         f"{tuple(kc.shape)}, {tuple(vc.shape)} (each slot's "
                         f"cache contiguous, slots at one 16-byte stride)")
    if hd % 8 or not 8 <= hd <= 256 or not 1 <= G <= 8:
        raise ValueError(f"{name}: head dim {hd} (a multiple of 8 in "
                         f"[8, 256]) or group {G} (1..8) the kernel lacks")
    if isinstance(pos, torch.Tensor):
        _check_pos(pos, B, q.device, name)
        poss, pos0 = pos.data_ptr(), 0
    else:
        poss, pos0 = None, int(pos)
        lo, hi = visible_range(W, pos0, window)
        if pos0 < 0 or lo > hi:
            raise ValueError(f"{name}: no visible key at pos {pos0}, window "
                             f"{window}, W {W}")
    n_split = plan_splits(KV, W, window, hd, q.dtype)
    out = torch.empty_like(q)
    part = None if n_split == 1 else torch.empty(
        B * KV * n_split * G * (hd + 2), device=q.device,
        dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = _build.library().lg_decode_attention(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), poss, pos0, B,
            kc.stride(0) if B > 1 else 0, KV, G, W, hd, int(window),
            float(scale), n_split, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"lg_decode_attention (B={B}, G={G}, hd={hd}, W={W}, "
                      f"window={window}, n_split={n_split})")
    runtime.count_launch(name)
    return out if part is None else decode_merge(part, out, n_split)


def decode_attention(q, kc, vc, pos, scale: float, window: int = 0):
    """q (KV, G, hd); kc, vc (KV, W, hd); keys at ``<= pos`` visible,
    optionally banded by ``window``; ``pos`` a host int or a one-element
    int32 tensor on q's device.  Returns (KV, G, hd) in q's dtype.
    Sharded operands (``DTensor``) are taken replicated, as GSPMD takes
    the operands of a call it cannot partition in the JAX package."""
    if runtime.is_sharded(q, kc, vc, pos):
        return runtime.sharded("decode_attention", runtime.replicated,
                               decode_attention, q, kc, vc, pos, scale,
                               window)
    if not q.is_cuda:
        return decode_attention_reference(q, kc, vc, pos, scale, window)
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(1)
    if not kc.is_contiguous() or not vc.is_contiguous():
        raise ValueError("decode_attention: kc and vc must be contiguous")
    return _launch("decode_attention", q[None], kc[None], vc[None], pos,
                   scale, window)[0]


def decode_attention_batch(q, kc, vc, poss, scale: float, window: int = 0):
    """B slots at once: q (B, KV, G, hd); kc, vc (B, KV, W, hd), each slot's
    cache contiguous -- the strided views ``caches[:, l, 0]`` / ``[:, l,
    1]`` of a stacked (B, L, 2, KV, W, hd) cache take no copy; poss (B,)
    int32 on q's device, slot b's keys at ``<= poss[b]`` visible (banded by
    ``window``).  One launch for all slots (and one merge).  Returns (B, KV,
    G, hd) in q's dtype; sharded operands replicated, as
    :func:`decode_attention`."""
    if runtime.is_sharded(q, kc, vc, poss):
        return runtime.sharded("decode_attention_batch", runtime.replicated,
                               decode_attention_batch, q, kc, vc, poss, scale,
                               window)
    if not q.is_cuda:
        return decode_attention_batch_reference(q, kc, vc, poss, scale,
                                                window)
    return _launch("decode_attention_batch", q, kc, vc, poss, scale, window)
