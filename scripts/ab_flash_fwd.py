"""Time the float32 flash forward of one checkout of the port, so that two
checkouts can be compared on one card.

    python3 scripts/ab_flash_fwd.py --tree DIR

imports ``lightgrad_tpu_torch`` from DIR (a checkout of any commit since the
LLaMA family's flash kernels were ported), builds its kernels there, and
prints one JSON line: the card's name and power limit (``nvidia-smi``), and
for each shape of PERF.md's rows 7, 7b, 7D, 7W and 10 (the forward of
``flash_block``), float32 (FWD_ROWS below):

- ``ms``: ``attention_fwd_res``'s CUDA-graph time (device time of 10
  replayed calls), and ``eager_ms`` (20 eager calls, launch included);
- ``library_ms``: one PyTorch call of the same function by CUDA graph:
  SDPA (causal, or a boolean band or key mask; ``enable_gqa`` for grouped
  queries), and for ``flash_block``'s (out, lse) the efficient-attention op
  that returns lse; null where PyTorch refuses it;
- ``bound_ms``: the larger of the call's bytes at 3.35 TB/s and its
  operations (q k^T and p v, 2 d each per valid pair) as three tf32 passes
  at 495 TFLOP/s, and ``bound_ffma_ms``, the operations once at the 67
  TFLOP/s of FP32 FFMA;
- ``f64_err`` / ``f64_err_rms``: the largest error of out against the
  forward evaluated in float64 (the first KV group; four heads where G is
  1), over max(1, the largest |element|) and over the reference's rms, and
  the same of the plain f32 version (``attention_fwd_reference``).

Run it for two checkouts in the order A, B, B, A within one machine to
compare them; each run is its own process.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HBM_BPS, TF32_OPS, FFMA_OPS = 3.35e12, 495e12, 67e12

# (row, query heads, KV heads, S, head dim, window, causal, lengths):
# GPT-2 small's prefill (7), BERT-base's heads without a mask (7b: the call
# shape of the TPU kernel's two-heads-a-step variant) and with its lengths,
# the d 256 training shape with 2 KV heads and Gemma-2B's prefill (7D), the
# char example's head dim 32 at G 2 (7D), Mistral-7B's banded layer (7W),
# and flash_block's chunk (10's forward, not causal)
FWD_ROWS = (("7_gpt2", 12, 12, 1024, 64, 0, True, False),
            ("7b_bert", 96, 96, 128, 64, 0, False, False),
            ("7_lengths", 96, 96, 128, 64, 0, False, True),
            ("7D_d256_train", 16, 2, 1024, 256, 0, True, False),
            ("7D_gemma", 8, 1, 8192, 256, 0, True, False),
            ("7D_d32", 64, 32, 64, 32, 0, True, False),
            ("7W_mistral", 32, 8, 8192, 128, 4096, True, False),
            ("10_flash_block", 96, 96, 256, 64, 0, False, False))


def cuda_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=10):
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / iters


def bert_lengths(h, s, dev):
    """chip_smoke.py's BERT lengths: 8 examples of s // 2 to s valid rows
    (the first full), each repeated over its h / 8 heads."""
    lens = np.random.default_rng(0).integers(s // 2, s + 1, size=8)
    lens[0] = s
    return torch.as_tensor(lens, device=dev,
                           dtype=torch.int32).repeat_interleave(h // 8)


def valid_pairs(h, s, window, causal, lens):
    """(query, key) pairs the call's mask keeps, over all h heads."""
    if lens is not None:
        n = lens.double()
        return float((n * (n + 1) / 2 if causal else n * n).sum())
    i = np.arange(s)
    per_row = np.minimum(i + 1, window if window else s) if causal \
        else np.full(s, s)
    return float(h * per_row.sum())


def bound(h, kvh, s, hd, window, causal, lens):
    """(three-pass bound, FFMA bound) in ms: q, k, v read and out, lse
    written (with lengths, the valid rows of q, k and v), against 4 hd
    operations a valid pair."""
    rows = h * s if lens is None else float(lens.sum())
    kv_rows = kvh * s if lens is None else rows * kvh / h
    nbytes = 4 * (rows * hd + 2 * kv_rows * hd + h * s * hd + h * s)
    ops = 4 * hd * valid_pairs(h, s, window, causal, lens)
    by_bytes = nbytes / HBM_BPS * 1e3
    return (max(by_bytes, 3 * ops / TF32_OPS * 1e3),
            max(by_bytes, ops / FFMA_OPS * 1e3))


def library(q, k, v, window, causal, lens, block):
    """One PyTorch call of the same forward at q (H, S, d), k and v (KV,
    S, d): SDPA, or for flash_block the efficient-attention op with lse."""
    import torch.nn.functional as F

    s = q.shape[1]
    q4, k4, v4 = q[None], k[None], v[None]
    if block:
        return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
            q4, k4, v4, None, True)
    kw = {"enable_gqa": k.shape[0] != q.shape[0]}
    i = torch.arange(s, device=q.device)
    if lens is not None:
        kw["attn_mask"] = (i[None, :] < lens[:, None])[None, :, None]
    elif window:
        kw["attn_mask"] = (i[None, :] <= i[:, None]) & \
            (i[:, None] - i[None, :] < window)
    else:
        kw["is_causal"] = causal
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, **kw)


def fwd_f64(q, k, v, sc, causal, window, lens):
    """out of softmax(q k^T sc) v in float64: q (H, S, d), k and v (KV, S,
    d), grouped; padded query rows (``lengths``) get zeros."""
    H, S, d = q.shape
    KV = k.shape[0]
    q4 = q.double().reshape(KV, H // KV, S, d)
    i = torch.arange(S, device=q.device)
    valid = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        valid = i[None, :] <= i[:, None]
        if window:
            valid = valid & (i[:, None] - i[None, :] < window)
    valid = valid.expand(KV, H // KV, S, S)
    if lens is not None:
        ok = (i[None, :] < lens.reshape(H, 1).long()).reshape(KV, H // KV, S)
        valid = valid & ok[..., None, :] & ok[..., :, None]
    s = torch.einsum("bgqd,bkd->bgqk", q4, k.double()) * sc
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), -1)
    p = torch.where(valid, p, 0.0)       # rows with no valid key: zeros
    return torch.einsum("bgqk,bkd->bgqd", p, v.double()).reshape(q.shape)


def f64_errors(att, q, k, v, sc, causal, window, lens, got):
    """Errors of ``got`` and of the plain f32 forward against the float64
    forward of the first KV group (four query heads where G is 1): over
    max(1, the largest |element|) and over the reference's rms."""
    G = q.shape[0] // k.shape[0]
    n, kv = (G, 1) if G > 1 else (4, 4)
    part = (q[:n], k[:kv], v[:kv])
    ln = None if lens is None else lens[:n]
    want = fwd_f64(*part, sc, causal, window, ln)
    plain = att.attention_fwd_reference(*part, sc, causal, ln, window)[0]
    res = {}
    for key, x in (("kernel", got[:n]), ("plain_f32", plain)):
        err = (x.double() - want).abs().max()
        res[key] = {"f64_err": (err / want.abs().max().clamp_min(1.0)).item(),
                    "f64_err_rms": (err / want.pow(2).mean().sqrt()).item()}
    return res


def forward_rows(att):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    res = {}
    for name, h, kvh, s, hd, window, causal, bert in FWD_ROWS:
        lens = bert_lengths(h, s, dev) if bert else None
        sc = hd ** -0.5
        q = torch.randn(h, s, hd, generator=g, device=dev)
        k, v = (torch.randn(kvh, s, hd, generator=g, device=dev)
                for _ in range(2))
        r = {}
        fn = lambda: att.attention_fwd_res(q, k, v, sc, causal, lengths=lens,
                                           window=window)
        try:
            r["ms"], r["eager_ms"] = graph_ms(fn), cuda_ms(fn)
            out = fn()[0]
            r.update(f64_errors(att, q, k, v, sc, causal, window, lens, out))
            del out
        except (RuntimeError, ValueError, TypeError) as e:
            r["ms"] = r["eager_ms"] = None
            r["refused"] = str(e).splitlines()[0][:160]
        try:
            r["library_ms"] = graph_ms(library(q, k, v, window, causal, lens,
                                               name.startswith("10_")))
        except RuntimeError:
            r["library_ms"] = None
        r["bound_ms"], r["bound_ffma_ms"] = bound(h, kvh, s, hd, window,
                                                  causal, lens)
        res[name] = r
        del q, k, v
        torch.cuda.empty_cache()
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="checkout whose lightgrad_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_flash_fwd: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import lightgrad_tpu_torch as lg
    from lightgrad_tpu_torch.ops import attention as att

    if os.path.dirname(os.path.dirname(os.path.abspath(lg.__file__))) != tree:
        sys.exit(f"ab_flash_fwd: imported {lg.__file__}, not from {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"tree": args.tree, "card": smi,
                      "forward": forward_rows(att)}))


if __name__ == "__main__":
    main()
