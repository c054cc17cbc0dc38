"""Whole-stack GPT-2 decode megakernel: n <= 8 rows through every layer of a
decode step in ONE launch.

Counterpart of ``lightgrad_tpu/ops/decode_stack.py``.  On CUDA tensors
:func:`decode_stack` (single stream: ``step`` and ``extend``) and
:func:`decode_stack_batch` (B independent slots: the serving tick) launch the
cooperative kernel of ``csrc/decode_stack.cu``; on CPU tensors they run
:func:`decode_stack_reference` / :func:`decode_stack_batch_reference`, the
plain versions of the same functions.

Both keep the JAX contract: the kernel only READS the cache and emits the new
K/V rows as ``kv (L, 2, n, d)``; the caller scatters them.  The JAX package's
VMEM planner (``_plan_chunks`` / ``stack_fits``) is replaced by
:func:`stack_supported`, the CUDA kernel's own fit check, which the model
wiring consults before packing.

int8 serving (the JAX ``_kernel_int8`` / ``_kernel_kvq`` /
``_kernel_int8_kvq`` and their batched ``_kernel_b_*`` twins): ``scales``
(L, S, d) f32 makes the slabs int8 with a scale per output column
(``quantize_serving``); ``kv_scales`` (..., L, 2, H, W, 1) f32 makes the
cache int8 rows with a scale per row (``quantize_kv``).  Either, or both,
selects one instantiation of the same CUDA kernel, counted under its own
name (``decode_stack_int8``, ``decode_stack_batch_kvq``, ...).  The
emitted ``kv`` then stays in ``x.dtype`` at full precision; the caller
quantizes it.  One divergence from the JAX kernel: the TPU's int8 product
rounds the activations to bf16 before its MXU dot
(``lightgrad_tpu/ops/decode_stack.py`` ``gemm``); here, as in the JAX
package's unrolled ``mm``, they stay f32.
"""

import torch
import torch.nn.functional as F

from . import _build, runtime

__all__ = ["pack_gpt_stack", "stack_supported", "plan_stack",
           "stack_smem", "decode_stack", "decode_stack_batch",
           "decode_stack_reference", "decode_stack_batch_reference"]

# csrc/decode_stack.cu `supported()`: kHD, the d alignment, kMaxD, kMaxN
_HD, _D_ALIGN, _MAX_D, _MAX_N = 64, 64, 4096, 8
# csrc/decode_stack.cu's schedule: kSlotBig, kSlotSmall, kRingMax, kChunk,
# kPassCols, kThreads, the dynamic shared memory a block may take (kSmemDyn)
_SLOT_BIG, _SLOT_SMALL, _RING_MAX = 32768, 16384, 196608
_CHUNK, _PASS_COLS = 32, 1024
_THREADS, _SMEM_DYN = 256, 232448 - 2048


def _share(total, b, G):
    """(first, count) of ``total`` items dealt to block b of G (the
    kernel's ``share_of``): counts differ by at most one."""
    v0 = total * b // G
    return v0, total * (b + 1) // G - v0


def stack_smem(n, d, R, n_sm, wbytes):
    """(dynamic shared memory bytes, ring slot bytes, ring slots) of a
    launch (the kernel's ``layout_of``): the ring takes what the staged rows
    (n x d f32), the K-way reduction (32 KB), a product's column biases and
    scales (8 KB) and the block's GELU rows leave of 227 KB, at most 192 KB,
    in 32 KB slots where four fit, else 16 KB."""
    ve = 16 // wbytes
    nj = -(-(R * d // ve) // n_sm) * ve
    other = (n * d * 4 + _THREADS * _MAX_N * 16 + 2 * 4 * _THREADS * 4
             + ((n * nj * 4 + 15) & ~15))
    ring = min(_SMEM_DYN - other, _RING_MAX)
    slot = _SLOT_BIG if ring >= 4 * _SLOT_BIG else _SLOT_SMALL
    return (ring // slot) * slot + other, slot, ring // slot


def plan_stack(n, d, R, H, W, positions, n_sm, wbytes, cbytes=None,
               batched=True):
    """The schedule the kernel follows (``make_plan`` in
    ``csrc/decode_stack.cu``), one entry a block (one block an SM).

    Weights of ``wbytes`` bytes are dealt in 16-byte column vectors, the
    same columns in every layer: ``qkv`` / ``proj`` columns of the (d, 3d)
    and (d, d) products, ``fc`` the block's hidden units (its fc columns,
    and the same rows of fc2 against all d outputs), ``resid`` the residual
    columns it sums fc2's partials into.  ``chunks``: its attention chunks,
    (group, head, first cache row, rows), 32-key pieces of the cache rows
    each group sees (``positions``: one a slot in batched mode, else
    ``[pos0]`` for the one group of extend mode; clamped to W), dealt
    evenly in (group, head, chunk) order.  ``stages``: the stages (16 or
    32 KB, :func:`stack_smem`) a layer the block streams; ``bytes``: the
    weight and cache bytes a layer it streams (``cbytes`` the cache's
    element size, ``wbytes`` by default)."""
    cbytes = cbytes or wbytes
    slot = stack_smem(n, d, R, n_sm, wbytes)[1]
    ve = 16 // wbytes
    lens = [min(max(int(p), 0), W) for p in positions]
    assert len(lens) == (n if batched else 1)
    nch = [max(1, -(-ln // _CHUNK)) for ln in lens]
    chunks = [(g, h, s * _CHUNK, min(_CHUNK, max(0, lens[g] - s * _CHUNK)))
              for g in range(len(lens)) for h in range(H)
              for s in range(nch[g])]
    gw_full = min(d, _PASS_COLS)
    passes = [gw_full] * (d // gw_full) + ([d % gw_full] if d % gw_full
                                           else [])
    blocks = []
    for b in range(n_sm):
        e = {}
        nst = 0
        nbytes = 0
        for name, ncols, K in (("qkv", 3 * d, d), ("proj", d, d),
                               ("fc", R * d, d)):
            v0, nv = _share(ncols // ve, b, n_sm)
            e[name] = (v0 * ve, (v0 + nv) * ve)
            if nv:
                kt = min(K, (slot // (nv * 16)) & ~3)
                nst += -(-K // kt)
            nbytes += nv * 16 * K
        nj = e["fc"][1] - e["fc"][0]
        if nj:
            nst += sum(-(-nj // (slot // (gw * wbytes))) for gw in passes)
        nbytes += nj * d * wbytes
        q0, nq = _share(d // 4, b, n_sm)
        e["resid"] = (4 * q0, 4 * (q0 + nq))
        c0, nc = _share(len(chunks), b, n_sm)
        e["chunks"] = chunks[c0:c0 + nc]
        # a stage holds as many chunks' K and V rows (and int8 row scales)
        # as fit a slot
        cps = slot // (2 * _CHUNK * _HD * cbytes + (256 if cbytes == 1
                                                       else 0))
        nst += -(-nc // cps)
        nbytes += sum(2 * rows * _HD * cbytes for *_, rows in e["chunks"])
        e["stages"], e["bytes"] = nst, nbytes
        blocks.append(e)
    return blocks


def stack_supported(*, d: int, hd: int, n: int = 8) -> bool:
    """True when the CUDA megakernel takes this shape: head dim 64, d a
    multiple of 64 up to 4096, 1 <= n <= 8 rows.  Its shared memory
    (:func:`stack_smem`) and workspace do not depend on the window, so any
    W fits (the launch refuses only a window of millions of positions,
    whose chunk count overflows its 32-bit schedule).  ``n=8`` sizes the
    check for the largest ``extend`` the packed stack may serve."""
    return (hd == _HD and d % _D_ALIGN == 0 and _D_ALIGN <= d <= _MAX_D
            and 1 <= n <= _MAX_N)


def pack_gpt_stack(p, L: int, d: int, R: int = 4):
    """Pack per-layer GPT weights (``h.{l}.*`` names, torch (out, in)
    layout) into ``stack#slabs (L, 4+2R, d, d)`` -- each slab stored [in,
    out] so every product is ``row @ slab`` -- and ``stack#vecs (L, 9+R,
    d)``: ln_1 w/b, ln_2 w/b, proj bias, fc2 bias, q/k/v biases, fc biases.
    The same layout as the JAX package's ``pack_gpt_stack``.

    int8 serving weights (``name#q`` int8 / ``name#s`` per-output-channel
    scale pairs from ``GPT.quantize_serving``) give int8 slabs and
    ``stack#scales (L, 4+2R, d)`` f32, each slab's scale per output
    column; fc2's single scale row serves all R of its slabs.  (The JAX
    package stores them (L, S, 1, d) for Mosaic's tiling rule only.)"""
    int8 = "h.0.attn.c_attn.weight#q" in p
    sfx = "#q" if int8 else ""
    slabs, vecs, scales = [], [], []
    for l in range(L):
        pre = f"h.{l}."
        wqkv = p[pre + "attn.c_attn.weight" + sfx]         # (3d, d)
        wfc = p[pre + "c_fc.weight" + sfx]                 # (Rd, d)
        wfc2 = p[pre + "c_proj.weight" + sfx]              # (d, Rd)
        rows = [wqkv[i * d:(i + 1) * d].T for i in range(3)]
        rows.append(p[pre + "attn.c_proj.weight" + sfx].T)
        rows += [wfc[i * d:(i + 1) * d].T for i in range(R)]
        rows += [wfc2[:, i * d:(i + 1) * d].T for i in range(R)]
        slabs.append(torch.stack(rows))
        if int8:
            sq = p[pre + "attn.c_attn.weight#s"]
            sf = p[pre + "c_fc.weight#s"]
            sc = [sq[i * d:(i + 1) * d] for i in range(3)]
            sc.append(p[pre + "attn.c_proj.weight#s"])
            sc += [sf[i * d:(i + 1) * d] for i in range(R)]
            sc += [p[pre + "c_proj.weight#s"]] * R
            scales.append(torch.stack(sc).float())
        bq, bf = p[pre + "attn.c_attn.bias"], p[pre + "c_fc.bias"]
        vr = [p[pre + "ln_1.weight"], p[pre + "ln_1.bias"],
              p[pre + "ln_2.weight"], p[pre + "ln_2.bias"],
              p[pre + "attn.c_proj.bias"], p[pre + "c_proj.bias"]]
        vr += [bq[i * d:(i + 1) * d] for i in range(3)]
        vr += [bf[i * d:(i + 1) * d] for i in range(R)]
        vecs.append(torch.stack(vr))
    out = {"stack#slabs": torch.stack(slabs).contiguous(),
           "stack#vecs": torch.stack(vecs).contiguous()}
    if int8:
        out["stack#scales"] = torch.stack(scales).contiguous()
    return out


def _stack_reference(x, caches, slots, lens, self_vis, slabs, vecs, eps, R,
                     scales=None, kv_scales=None):
    """f32 math throughout, residual kept f32 across layers (as the kernel
    does).  caches (slots, L, 2, H, W, hd); row r reads slot ``slots[r]``'s
    cache rows < ``lens[r]`` plus the in-flight rows ``self_vis[r]`` marks.
    int8 slabs are dequantized by their column ``scales``; int8 cache rows
    by their ``kv_scales`` (slots, L, 2, H, W, 1)."""
    n, d = x.shape
    L = slabs.shape[0]
    H, W, hd = caches.shape[3:]
    scale = 1.0 / float(hd) ** 0.5
    dev = x.device
    seen = torch.arange(W, device=dev)[None, :] < lens[:, None]    # (n, W)
    xacc = x.float()
    kv = torch.empty((L, 2, n, d), device=dev, dtype=torch.float32)
    for l in range(L):
        sl, vec = slabs[l].float(), vecs[l].float()
        if scales is not None:
            sl = sl * scales[l][:, None, :]
        h = F.layer_norm(xacc, (d,), vec[0], vec[1], eps)
        q, k, v = (h @ sl[i] + vec[6 + i] for i in range(3))
        kv[l, 0], kv[l, 1] = k, v
        kc = caches[slots, l, 0].float()                           # (n,H,W,hd)
        vc = caches[slots, l, 1].float()
        if kv_scales is not None:
            kc = kc * kv_scales[slots, l, 0]
            vc = vc * kv_scales[slots, l, 1]
        qh = q.reshape(n, H, hd)
        sc = torch.einsum("nhd,nhwd->nhw", qh, kc) * scale
        sc = sc.masked_fill(~seen[:, None, :], -1e30)
        ss = torch.einsum("nhd,jhd->nhj", qh, k.reshape(n, H, hd)) * scale
        ss = ss.masked_fill(~self_vis[:, None, :], -1e30)
        pr = torch.softmax(torch.cat([sc, ss], -1), -1)
        att = (torch.einsum("nhw,nhwd->nhd", pr[..., :W], vc)
               + torch.einsum("nhj,jhd->nhd", pr[..., W:],
                              v.reshape(n, H, hd)))
        xacc = xacc + att.reshape(n, d) @ sl[3] + vec[4]
        h2 = F.layer_norm(xacc, (d,), vec[2], vec[3], eps)
        out = vec[5]
        for i in range(R):
            fc = F.gelu(h2 @ sl[4 + i] + vec[9 + i], approximate="tanh")
            out = out + fc @ sl[4 + R + i]
        xacc = xacc + out
    return xacc.to(x.dtype), kv.to(_kv_dtype(x, caches, kv_scales))


def _kv_dtype(x, cache, kv_scales):
    """The emitted rows' dtype: the cache's, or x's over an int8 cache."""
    return x.dtype if kv_scales is not None else cache.dtype


def decode_stack_reference(x, cache, pos, slabs, vecs, scales=None, *,
                           eps, R=4, kv_scales=None):
    """Plain version of :func:`decode_stack` (``pos`` a host int or a
    one-element tensor, not read to the host)."""
    n = x.shape[0]
    dev = x.device
    rows = torch.arange(n, device=dev)
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(()).to(device=dev, dtype=torch.long)
    return _stack_reference(
        x, cache[None], torch.zeros(n, dtype=torch.long, device=dev),
        torch.zeros(n, dtype=torch.long, device=dev) + pos,
        rows[None, :] <= rows[:, None],
        slabs, vecs, eps, R, scales,
        None if kv_scales is None else kv_scales[None])


def decode_stack_batch_reference(x, caches, poss, slabs, vecs, scales=None,
                                 *, eps, R=4, kv_scales=None):
    """Plain version of :func:`decode_stack_batch`."""
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    return _stack_reference(x, caches, rows, poss.to(x.device).long(),
                            rows[None, :] == rows[:, None], slabs, vecs, eps,
                            R, scales, kv_scales)


def _variant(name, scales, kv_scales):
    """The launch-counted name of one instantiation: the JAX function's name
    plus ``_int8`` (int8 slabs) and/or ``_kvq`` (int8 cache)."""
    return name + ("_int8" if scales is not None else "") \
        + ("_kvq" if kv_scales is not None else "")


def _check(name, t, tname, dtypes, shape, dev):
    if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name}: {tname} must be a contiguous "
                         f"{' or '.join(map(str, dtypes))} tensor of shape "
                         f"{shape} on {dev}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


# device index -> the int32 words every stack call on it shares: the grid
# barrier's count, which a call leaves reusable (csrc/decode_stack.cu's
# grid_barrier), and the attention pairs' counters, each reset by its last
# block.  Two calls never overlap on a device: a block takes an SM's shared
# memory, so one call's blocks start only as the other's have left.
_SYNC = {}


def _sync_words(lib, dev):
    """The device's zeroed sync words, made on its first call outside
    stream capture (a launch being captured before then gets words of its
    own, zeroed by a node of the graph)."""
    sync = _SYNC.get(dev.index)
    if sync is None:
        sync = torch.zeros(lib.lg_decode_stack_sync_words(), device=dev,
                           dtype=torch.int32)
        if not torch.cuda.is_current_stream_capturing():
            _SYNC[dev.index] = sync
    return sync


def _launch(name, x, cache, slot_stride, poss, pos0, slabs, vecs, scales,
            kv_scales, eps, R, pos_dev=None):
    n, d = x.shape
    L, S = slabs.shape[:2]
    H, W, hd = cache.shape[-3:]
    if S != 4 + 2 * R or H * hd != d:
        raise ValueError(f"{name}: slabs {tuple(slabs.shape)}, cache "
                         f"{tuple(cache.shape)}, x {tuple(x.shape)}")
    if not stack_supported(d=d, hd=hd, n=n):
        raise ValueError(f"{name}: kernel lacks d={d}, hd={hd}, n={n} "
                         f"(gate with stack_supported())")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    dev, dt, i8 = x.device, x.dtype, torch.int8
    _check(name, x, "x", (dt,), (n, d), dev)
    _check(name, slabs, "slabs", (i8,) if scales is not None else (dt,),
           (L, S, d, d), dev)
    _check(name, vecs, "vecs", (dt,), (L, 9 + R, d), dev)
    _check(name, cache, "cache", (i8,) if kv_scales is not None else (dt,),
           tuple(cache.shape[:-5]) + (L, 2, H, W, hd), dev)
    if scales is not None:
        _check(name, scales, "scales", (torch.float32,), (L, S, d), dev)
    if kv_scales is not None:
        _check(name, kv_scales, "kv_scales", (torch.float32,),
               tuple(cache.shape[:-1]) + (1,), dev)
    lib = _build.library()
    x_out = torch.empty_like(x)
    kv = torch.empty((L, 2, n, d), device=dev,
                     dtype=_kv_dtype(x, cache, kv_scales))
    with torch.cuda.device(dev):
        ws = torch.empty(lib.lg_decode_stack_workspace(n, d, R), device=dev,
                         dtype=torch.float32)
        sync = _sync_words(lib, dev)
        err = lib.lg_decode_stack(
            x.data_ptr(), cache.data_ptr(), slot_stride,
            None if poss is None else poss.data_ptr(), pos0,
            None if pos_dev is None else pos_dev.data_ptr(),
            slabs.data_ptr(), vecs.data_ptr(),
            None if scales is None else scales.data_ptr(),
            None if kv_scales is None else kv_scales.data_ptr(),
            x_out.data_ptr(), kv.data_ptr(), ws.data_ptr(), sync.data_ptr(),
            n, L, d, H, W, R,
            float(eps), float(1.0 / float(hd) ** 0.5),
            int(dt == torch.bfloat16), int(scales is not None),
            int(kv_scales is not None),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, name)
    runtime.count_launch(name)
    return x_out, kv


def _replicated2(shapes, *args):
    return runtime.replicated(shapes, n_out=2)


def decode_stack(x, cache, pos, slabs, vecs, scales=None, *, eps, R=4,
                 kv_scales=None):
    """n decode rows at positions pos..pos+n-1 through the whole stack.

    x (n, d) residual input (embeddings summed); cache (L, 2, H, W, hd);
    ``pos`` a host int or a one-element int32 tensor on x's device, which
    the kernel reads there; slabs/vecs/scales from :func:`pack_gpt_stack`.
    Returns ``(x_out (n, d), kv (L, 2, n, d))``: cache rows < pos are seen
    by every row, the n in-flight rows see each other causally (``extend``
    semantics, at full precision), and the caller scatters ``kv`` into rows
    pos..pos+n-1.  ``kv_scales`` (L, 2, H, W, 1) f32: ``cache`` is the int8
    row store; ``kv`` is then in x's dtype.  Sharded operands (``DTensor``)
    are taken replicated, as GSPMD takes a call it cannot partition."""
    if runtime.is_sharded(x, cache, pos, slabs, vecs, scales, kv_scales):
        return runtime.sharded(
            "decode_stack", _replicated2,
            lambda *a: decode_stack(*a[:6], eps=eps, R=R, kv_scales=a[6]),
            x, cache, pos, slabs, vecs, scales, kv_scales)
    if not x.is_cuda:
        return decode_stack_reference(x, cache, pos, slabs, vecs, scales,
                                      eps=eps, R=R, kv_scales=kv_scales)
    name = _variant("decode_stack", scales, kv_scales)
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or pos.numel() != 1 \
                or pos.device != x.device:
            raise ValueError(f"{name}: pos must be one int32 on {x.device}, "
                             f"got {pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
        return _launch(name, x, cache, 0, None, 0, slabs, vecs, scales,
                       kv_scales, eps, R, pos_dev=pos)
    return _launch(name, x, cache, 0, None, int(pos), slabs, vecs, scales,
                   kv_scales, eps, R)


def decode_stack_batch(x, caches, poss, slabs, vecs, scales=None, *, eps,
                       R=4, kv_scales=None):
    """B independent slots, one row each, through the whole stack with one
    weight stream.

    x (B, d); caches (B, L, 2, H, W, hd); poss a (B,) int32 tensor on x's
    device; ``kv_scales`` (B, L, 2, H, W, 1) as in :func:`decode_stack`.
    Row b attends slot b's cache rows < poss[b] plus its own new row.
    Returns ``(x_out (B, d), kv (L, 2, B, d))``; the caller scatters slot
    b's rows at poss[b].  Sharded operands replicated, as
    :func:`decode_stack`."""
    if runtime.is_sharded(x, caches, poss, slabs, vecs, scales, kv_scales):
        return runtime.sharded(
            "decode_stack_batch", _replicated2,
            lambda *a: decode_stack_batch(*a[:6], eps=eps, R=R,
                                          kv_scales=a[6]),
            x, caches, poss, slabs, vecs, scales, kv_scales)
    if not x.is_cuda:
        return decode_stack_batch_reference(x, caches, poss, slabs, vecs,
                                            scales, eps=eps, R=R,
                                            kv_scales=kv_scales)
    B = x.shape[0]
    if caches.shape[0] != B or poss.shape != (B,) \
            or poss.device != x.device or poss.dtype != torch.int32 \
            or not poss.is_contiguous():
        raise ValueError(f"decode_stack_batch: caches {tuple(caches.shape)}"
                         f" and poss {tuple(poss.shape)} {poss.dtype} must "
                         f"match x's {B} rows (poss int32 on the card)")
    return _launch(_variant("decode_stack_batch", scales, kv_scales), x,
                   caches, caches[0].numel(), poss, 0, slabs, vecs, scales,
                   kv_scales, eps, R)
