"""Scaled-dot-product attention: the flash kernels and their plain twins.

Counterpart of ``lightgrad_tpu/ops/attention.py``.  On CUDA tensors
:func:`attention_fwd` and :func:`attention_fwd_res` launch the hand-written
flash-forward kernel (``csrc/flash_fwd.cu``: bfloat16 on the tensor cores,
float32 on the CUDA cores) and :func:`attention_bwd` the
flash backward (``csrc/flash_bwd.cu``): the two passes, the dq pass
:func:`attention_bwd_dq` and the dk/dv pass :func:`attention_bwd_dkv`, or,
after ``set_flash_fused(True)`` and where its rule allows, the fused kernel
:func:`attention_bwd_fused` (bfloat16 on the tensor cores, float32 on the
CUDA cores, as the forward).  All three kernels take per-row ``lengths``;
the forward and the two passes take a causal sliding ``window``, and all
three any head dim d with d % 8 == 0, 8 <= d <= 256.
:func:`flash_block_fwd` / :func:`flash_block_bwd` are the two directions of
``flash_block`` (``autograd/ops.py``): (out, lse) differentiable through
lse.  On CPU tensors every wrapper runs its plain version.

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
           "attention_bwd_fused", "attention_bwd_fused_reference",
           "attention_bwd_passes_reference", "attention_bwd_reference",
           "dkv_splits", "fused_rows", "set_flash_fused",
           "flash_block_fwd", "flash_block_bwd", "flash_block_reference"]

_NEG_INF = -1e30
# Backward scheme selector, as the JAX package's _FUSED_BWD: off by default.
_FUSED_BWD = False
# Key rows per block of the fused kernel by dtype and instantiation D
# (float32: Cfg<D>::kRows, bfloat16: Tc<D>::BR of csrc/flash_bwd.cu, which
# asserts these values).  A head dim d runs the narrowest D >= d.  dq is the
# sum of the key blocks' shares in ascending order, in the kernel and in its
# plain version.
FUSED_ROWS = {torch.float32: {32: 64, 64: 64, 128: 32, 256: 16},
              torch.bfloat16: {64: 64, 128: 64, 256: 64}}


def fused_rows(d: int, dtype=torch.float32) -> int:
    """Key rows a block of the fused kernel holds at head dim ``d`` in
    ``dtype``: those of the instantiation that serves d (f32 d 80: D 128's
    32).  A d past 256, which only the plain version takes, gets D 256's."""
    rows = FUSED_ROWS[torch.bfloat16 if dtype == torch.bfloat16
                      else torch.float32]
    return rows[min((D for D in rows if D >= d), default=256)]


def set_flash_fused(on: bool) -> bool:
    """Let :func:`attention_bwd` take the fused backward kernel where the
    JAX package's rule does (no ``lengths``, no ``window``, G == 1);
    returns the previous setting."""
    global _FUSED_BWD
    prev = _FUSED_BWD
    _FUSED_BWD = bool(on)
    return prev


def _masks(bkv, groups, s, dev, causal, lengths, window):
    """Key validity, broadcastable to (bkv, G, s, s), and query-row validity,
    (bkv, G, s, 1); None where nothing is masked."""
    keys = rows = None
    if causal:
        row = torch.arange(s, device=dev)[:, None]
        col = torch.arange(s, device=dev)[None, :]
        keys = col <= row
        if window:
            keys = keys & (row - col < window)
    if lengths is not None:
        lens = torch.as_tensor(lengths, device=dev).reshape(bkv * groups, 1)
        valid = torch.arange(s, device=dev)[None, :] < lens      # (b, s)
        cols = valid.reshape(bkv, groups, 1, s)
        keys = cols if keys is None else keys & cols
        rows = valid.reshape(bkv, groups, s, 1)
    return keys, rows


def _probs(q4, k3, scale, causal, lengths, window):
    """Softmax probabilities (f32) of the grouped scores, with the scores
    and the row validity mask (None without ``lengths``)."""
    bkv, groups, s, _ = q4.shape
    scores = torch.einsum("bgqd,bkd->bgqk", q4, k3) * scale
    keys, rows = _masks(bkv, groups, s, q4.device, causal, lengths, window)
    if keys is not None:
        scores = scores.masked_fill(~keys, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if rows is not None:
        # padded query rows: zeros (the JAX package's contract)
        p = torch.where(rows, p, 0.0)
    return p, scores, rows


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


def _rounded(x, dtype):
    """``x`` rounded to the inputs' ``dtype`` and widened back: the TPU
    kernels' ``p.astype`` / ``ds.astype`` before a product (the bf16
    kernels' tensor-core operands); the identity in float32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _bwd_from_residuals(g, q, k, v, lse, dcap, scale, causal, lengths=None,
                        block_rows=None, refine=False, dlse=None, window=0):
    """Plain PyTorch (dq, dk, dv, dcap) in the flash kernels' own
    arithmetic, from the forward's ``lse`` and ``dcap`` (rowsum(g * out),
    less lse's cotangent ``dlse`` where there is one): p = exp(s * scale -
    lse) and ds = p (dp - dcap) on the valid pairs, zero elsewhere, both
    rounded to the input dtype before their products (bfloat16), as the
    TPU kernels do.  ``refine``: the float32 dq pass's correction, dcap +=
    sum_j ds_ij / sum_j p_ij - dlse_i, before ds is used; the dcap
    returned is the one used.  ``block_rows``: dq as the sum of the shares
    of key blocks of that many keys, taken in ascending order, the fused
    kernel's scheme."""
    (b, bkv, s, d), q4, (k3, v3) = _grouped(q, k, v)
    groups = b // bkv
    g4 = g.reshape(q4.shape).float()
    scores = torch.einsum("bgqd,bkd->bgqk", q4, k3) * scale
    p = torch.exp(scores - lse.reshape(bkv, groups, s, 1).float())
    dp = torch.einsum("bgqd,bkd->bgqk", g4, v3)
    ds = p * (dp - dcap.reshape(bkv, groups, s, 1).float())
    keys, rows = _masks(bkv, groups, s, q.device, causal, lengths, window)
    for m in (keys, rows):
        if m is not None:       # select: masked scores may overflow exp
            p, ds = torch.where(m, p, 0.0), torch.where(m, ds, 0.0)
    dcap = dcap.reshape(bkv, groups, s, 1).float()
    if refine:
        psum = p.sum(-1, keepdim=True)
        corr = ds.sum(-1, keepdim=True) / psum.clamp_min(1e-30)
        if dlse is not None:
            corr = corr - dlse.reshape(corr.shape).float()
        corr = torch.where(psum > 0, corr, 0.0)
        ds, dcap = ds - corr * p, dcap + corr
    p, ds = _rounded(p, q.dtype), _rounded(ds, q.dtype)
    dv = torch.einsum("bgqk,bgqd->bkd", p, g4)
    dk = torch.einsum("bgqk,bgqd->bkd", ds, q4) * scale
    if block_rows is None:
        dq = torch.einsum("bgqk,bkd->bgqd", ds, k3) * scale
    else:
        dq = None
        for j in range(0, s, block_rows):
            share = torch.einsum("bgqk,bkd->bgqd", ds[..., j:j + block_rows],
                                 k3[:, j:j + block_rows]) * scale
            dq = share if dq is None else dq + share
    return (dq.to(q.dtype).reshape(q.shape), dk.to(k.dtype).reshape(k.shape),
            dv.to(v.dtype).reshape(v.shape), dcap.reshape(b, s))


def attention_bwd_fused_reference(g, q, k, v, out, lse, dcap, scale: float,
                                  causal: bool = False):
    """Plain PyTorch (dq, dk, dv) of the fused backward (the JAX package's
    ``_flash_bwd_fused``): dq as the f32 sum of the key blocks' shares in
    ascending order (the JAX package's slabs, summed in the kernel's
    order), cast to q's dtype.  G == 1, no lengths or window.  ``out`` is
    accepted for the signature's sake; ``dcap`` carries what it gives."""
    if prod(q.shape[:-2]) != prod(k.shape[:-2]):
        raise ValueError("the fused backward takes no grouped-query call")
    return _bwd_from_residuals(
        g, q, k, v, lse, dcap, scale, causal,
        block_rows=fused_rows(q.shape[-1], q.dtype))[:3]


def _dcap(g, out, dlse=None):
    """dcap = rowsum(g * out) in f32, less lse's cotangent ``dlse`` where
    there is one; a plain reduction, as the JAX package leaves it to XLA.
    Returns (dcap, dlse), both contiguous f32 (dlse None without one)."""
    dcap = (g.float() * out.float()).sum(-1)
    if dlse is not None:
        dlse = dlse.float().reshape(dcap.shape).contiguous()
        dcap = dcap - dlse
    return dcap.contiguous(), dlse


def attention_bwd_passes_reference(g, q, k, v, out, lse, scale: float,
                                   causal: bool = False, lengths=None,
                                   window: int = 0, dlse=None):
    """Plain PyTorch (dq, dk, dv) of the two passes from the forward's
    (out, lse), in their arithmetic: dcap from :func:`_dcap`, refined by
    the float32 dq pass (not in bfloat16, as the TPU kernel), p and ds
    rounded to bfloat16 before their products in bfloat16."""
    dcap, dlse = _dcap(g, out, dlse)
    return _bwd_from_residuals(g, q, k, v, lse, dcap, scale, causal, lengths,
                               refine=q.dtype != torch.bfloat16, dlse=dlse,
                               window=window)[:3]


def _check(fn, q, k, v, **same_as_q):
    """Validate a CUDA call; returns (b, bkv, s, d)."""
    s, d = q.shape[-2], q.shape[-1]
    b, bkv = prod(q.shape[:-2]), prod(k.shape[:-2])
    for name, t in dict(q=q, k=k, v=v, **same_as_q).items():
        # 16-byte rows: the kernels read four elements at a time
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be a contiguous, 16-byte "
                             f"aligned tensor of q's device and dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: unsupported dtype {q.dtype}")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"{fn}: head dim {d} on CUDA must be a multiple of "
                         f"8 in [8, 256]")
    if k.shape[-2:] != (s, d) or v.shape != k.shape or b % bkv \
            or any(t.shape != q.shape for t in same_as_q.values()):
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    return b, bkv, s, d


def _lens_ptr(fn, lengths, q, b):
    """The kernels' ``lens`` argument: None (no lengths) or the pointer of a
    contiguous int32 tensor of B elements on q's device."""
    if lengths is None:
        return None
    if not isinstance(lengths, torch.Tensor) \
            or lengths.dtype != torch.int32 or lengths.numel() != b \
            or lengths.device != q.device or not lengths.is_contiguous():
        raise ValueError(f"{fn}: lengths must be a contiguous int32 tensor "
                         f"of B = {b} elements on q's device")
    return lengths.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _flash_fwd_cuda(q, k, v, scale, causal, lengths=None, window=0):
    b, bkv, s, d = _check("attention_fwd", q, k, v)
    lens = _lens_ptr("attention_fwd", lengths, q, b)
    out = torch.empty_like(q)
    lse = torch.empty((b, s, 1), device=q.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.lg_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), lens, b, b // bkv, s, d, float(scale),
            int(bool(causal)), min(int(window), s),
            int(q.dtype == torch.bfloat16), _stream(q))
    _build.check(err, "lg_flash_fwd")
    runtime.count_launch("attention_fwd")
    return out, lse


def _bwd_check(fn, g, q, k, v, lse, dcap, **rows):
    """Validate a backward call; ``rows``: more f32 tensors of B*S
    elements (None where absent)."""
    b, bkv, s, d = _check(fn, q, k, v, g=g)
    for name, t in dict(lse=lse, dcap=dcap, **rows).items():
        if t is not None and (t.dtype != torch.float32 or t.numel() != b * s
                              or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous float32 "
                             f"tensor of B*S = {b * s} elements")
    return b, bkv, s, d


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bwd_launch(entry, fn, g, q, k, v, lse, dcap, scale, causal, lengths,
                window, ptrs, tail=(), **rows):
    """Launch a backward pass; ``ptrs`` follow dcap, and ``tail`` window,
    in the entry's order."""
    b, bkv, s, d = _bwd_check(fn, g, q, k, v, lse, dcap, **rows)
    lens = _lens_ptr(fn, lengths, q, b)
    with torch.cuda.device(q.device):
        err = getattr(_build.library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dcap.data_ptr(), *ptrs, lens, b, b // bkv, s, d,
            float(scale), int(bool(causal)), min(int(window), s), *tail,
            int(q.dtype == torch.bfloat16), _stream(q))
    _build.check(err, entry)
    runtime.count_launch(fn)


def dkv_splits(kv_rows: int, groups: int, s: int, sms: int) -> int:
    """Blocks that share a KV row's query heads in the bf16 dk/dv pass: the
    fewest (a divisor of G) that bring its grid of KV rows x 64-key blocks
    to two blocks an SM, or G.  Each writes f32 dk / dv partials, summed
    after the kernel in order."""
    want = -(-2 * sms // (kv_rows * -(-s // 64)))
    return max(n for n in range(1, groups + 1)
               if groups % n == 0 and n <= max(1, want))


def attention_bwd_dq(g, q, k, v, lse, dcap, scale: float,
                     causal: bool = False, lengths=None, dlse=None,
                     dcap_out=None, window: int = 0):
    """dq of the flash backward given the forward's ``lse`` and
    ``dcap = rowsum(g * out) - dlse`` (f32, B*S; ``dlse``, lse's cotangent,
    where there is one): the dq kernel on CUDA, its plain version (the same
    arithmetic from lse and dcap) on CPU.  In float32 the pass refines
    dcap against its own p and dp, which corrects dq; ``dcap_out`` (f32,
    B*S) receives the refined dcap, which the dk/dv pass should take.  In
    bfloat16 (the tensor-core kernel) it takes dcap as given, as the TPU
    kernel does, and ``dcap_out`` receives dcap."""
    if not q.is_cuda:
        dq, _, _, refined = _bwd_from_residuals(
            g, q, k, v, lse, dcap, scale, causal, lengths,
            refine=q.dtype != torch.bfloat16, dlse=dlse, window=window)
        if dcap_out is not None:
            dcap_out.copy_(refined.reshape(dcap_out.shape))
        return dq
    dq = torch.empty_like(q)
    _bwd_launch("lg_flash_bwd_dq", "attention_bwd_dq", g, q, k, v, lse, dcap,
                scale, causal, lengths, window,
                (_ptr(dlse), dq.data_ptr(), _ptr(dcap_out)), dlse=dlse,
                dcap_out=dcap_out)
    return dq


def attention_bwd_dkv(g, q, k, v, lse, dcap, scale: float,
                      causal: bool = False, lengths=None, window: int = 0):
    """(dk, dv) of the flash backward, as :func:`attention_bwd_dq`; dcap is
    taken as given (the dq pass's, on the backward's path).  In bfloat16
    with few KV rows the query heads of a group are shared over
    :func:`dkv_splits` blocks, whose f32 partials are summed after the
    kernel in order."""
    if not q.is_cuda:
        return _bwd_from_residuals(g, q, k, v, lse, dcap, scale, causal,
                                   lengths, window=window)[1:3]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kv_rows, s = prod(k.shape[:-2]), q.shape[-2]
    splits, part = 1, None
    if q.dtype == torch.bfloat16 and prod(q.shape[:-2]) > kv_rows:
        splits = dkv_splits(
            kv_rows, prod(q.shape[:-2]) // kv_rows, s,
            torch.cuda.get_device_properties(q.device).multi_processor_count)
    if splits > 1:
        part = torch.empty((splits, 2, *k.shape), device=q.device,
                           dtype=torch.float32)
    _bwd_launch("lg_flash_bwd_dkv", "attention_bwd_dkv", g, q, k, v, lse,
                dcap, scale, causal, lengths, window,
                (dk.data_ptr(), dv.data_ptr(), _ptr(part)), (splits,))
    if part is not None:        # the partials' sum, in order
        sums = part.sum(0)
        dk.copy_(sums[0])
        dv.copy_(sums[1])
    return dk, dv


def attention_bwd_fused(g, q, k, v, lse, dcap, scale: float,
                        causal: bool = False):
    """(dq, dk, dv) from one fused kernel (G == 1, no lengths, any head dim
    the two passes take): dk and dv directly; dq summed by the kernel into
    one f32 (B, S, d) buffer, the key blocks' shares in ascending order
    (a turn counter per query tile, B * ceil(S / fused_rows) int32 beside a
    work-item ticket), then cast to q's dtype, as the JAX package casts
    its slab sum.  The plain version on CPU."""
    if not q.is_cuda:
        return attention_bwd_fused_reference(g, q, k, v, None, lse, dcap,
                                             scale, causal)
    fn = "attention_bwd_fused"
    b, bkv, s, d = _bwd_check(fn, g, q, k, v, lse, dcap)
    if b != bkv:
        raise ValueError(f"{fn}: the fused kernel takes no grouped-query "
                         f"call (B {b}, KV rows {bkv})")
    nk = -(-s // fused_rows(d, q.dtype))
    dq = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    turns = torch.zeros(1 + b * nk, device=q.device, dtype=torch.int32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _build.library().lg_flash_bwd_fused(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dcap.data_ptr(), dq.data_ptr(), turns.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, d, float(scale),
            int(bool(causal)), int(q.dtype == torch.bfloat16), _stream(q))
    _build.check(err, "lg_flash_bwd_fused")
    runtime.count_launch(fn)
    return dq.to(q.dtype), dk, dv


def attention_fwd_res(q, k, v, scale: float, causal: bool = False,
                      lengths=None, window: int = 0):
    """(out, lse): the flash kernel on CUDA, with ``lengths`` (a contiguous
    int32 tensor of B elements) or without; the plain version on CPU.
    ``window`` > 0 bands the causal mask: row i sees keys i - window < j <=
    i (Mistral's semantics; a window of S or more bands nothing)."""
    if window:
        assert causal, "sliding window attention is causal-only"
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, scale, causal, lengths, window)
    return attention_fwd_reference(q, k, v, scale, causal, lengths, window)


def attention_fwd(q, k, v, scale: float, causal: bool = False,
                  lengths=None, window: int = 0):
    return attention_fwd_res(q, k, v, scale, causal, lengths, window)[0]


def _flash_bwd(g, q, k, v, out, lse, scale, causal, dlse=None,
               lengths=None, window=0):
    """The flash backward from the forward's (out, lse), as the JAX
    package's ``_flash_bwd``: dcap = rowsum(g * out) in f32, less lse's
    cotangent ``dlse`` where it has one; then the fused kernel where the
    switch and the JAX rule allow (no lengths, no window, G == 1), else the
    two passes, the dk/dv pass taking the dq pass's dcap (refined in
    float32)."""
    if out is None or lse is None or out.shape != q.shape:
        raise ValueError("the flash backward needs the forward's out and lse")
    dcap, dlse = _dcap(g, out, dlse)
    if _FUSED_BWD and lengths is None and not window \
            and prod(q.shape[:-2]) == prod(k.shape[:-2]):
        return attention_bwd_fused(g, q, k, v, lse, dcap, scale, causal)
    refined = torch.empty_like(dcap)
    dq = attention_bwd_dq(g, q, k, v, lse, dcap, scale, causal, lengths,
                          dlse=dlse, dcap_out=refined, window=window)
    return (dq, *attention_bwd_dkv(g, q, k, v, lse, refined, scale, causal,
                                   lengths, window=window))


def attention_bwd(g, q, k, v, scale: float, causal: bool = False,
                  out=None, lse=None, lengths=None, window: int = 0):
    """(dq, dk, dv) of ``attention_fwd`` for the output cotangent ``g``.
    On CUDA the flash backward kernels, which need the forward's ``out``
    and ``lse``: the two passes, or the fused kernel after
    ``set_flash_fused(True)`` where there are no lengths or window and
    G == 1.  On CPU the plain recompute version."""
    if window:
        assert causal, "sliding window attention is causal-only"
    if not q.is_cuda:
        return attention_bwd_reference(g, q, k, v, scale, causal, out, lse,
                                       lengths, window)
    return _flash_bwd(g, q, k, v, out, lse, scale, causal, lengths=lengths,
                      window=window)


def flash_block_fwd(q, k, v, scale: float, causal: bool = False):
    """Forward of ``flash_block`` (the JAX package's kernel 10): one
    (Q, K-chunk) flash pass, (out, lse), on the flash-forward kernel."""
    out, lse = attention_fwd_res(q, k, v, scale, causal)
    if q.is_cuda:
        runtime.count_launch("flash_block")
    return out, lse


def flash_block_bwd(g, glse, q, k, v, out, lse, scale: float,
                    causal: bool = False):
    """Backward of ``flash_block`` for the cotangents of out (``g``) and of
    lse (``glse``): lse's enters every score as dcap - dlse."""
    grads = _flash_bwd(g, q, k, v, out, lse, scale, causal, dlse=glse)
    if q.is_cuda:
        runtime.count_launch("flash_block")
    return grads


def flash_block_reference(q, k, v, scale: float, causal: bool = False):
    """Plain ``flash_block``: (out, lse) of :func:`attention_fwd_reference`,
    differentiable in q, k and v by torch autograd, lse included."""
    return attention_fwd_reference(q, k, v, scale, causal)
