"""Time the flash backward and GPT-2 small's bf16 training step of one
checkout of the port, so that two checkouts can be compared on one card.

    python3 scripts/ab_flash_bwd.py --tree DIR [--steps N]

imports ``lightgrad_tpu_torch`` from DIR (a checkout of any commit since the
GPT-2 training step was ported), builds its kernels there, and prints one
JSON line:

- the card's name and power limit (``nvidia-smi``);
- at GPT-2 small's attention shape at batch 8 (96 x 1024 x 64, causal), in
  float32 and bfloat16, CUDA-event means over 20 calls of: the forward
  (``attention_fwd_res``; also at batch 1, 12 x 1024 x 64), rowsum + the two
  backward passes (``attention_bwd``), the dq pass alone, the dk/dv pass
  alone, and, where the checkout has ``set_flash_fused``, rowsum + the
  fused kernel + its slab sum;
- the forward at the LLaMA family's prefill shapes, where the checkout
  takes them (else null): Mistral-7B's layer (32 x 8192 x 128, 8 KV
  heads, window 4096) and Gemma-2B's (8 x 8192 x 256, 1 KV head);
- the backward's pieces by CUDA graph (device time of 10 replayed calls) at
  the shapes of PERF.md's rows 8, 8D, 8W, 9 and 9D, causal, and BERT-base's
  lengths shape (96 x 128 x 64, lengths 64-128, not causal), float32 and
  bfloat16: the dq pass, the dk/dv pass and, where G is 1 and there are no
  lengths, the fused kernel (with its dq sum and cast); PyTorch's SDPA
  backward (dq, dk, dv in one ``torch.autograd.grad``) beside them, its
  eager time too; in float32 also each pass's largest error against the
  float64 backward of its first KV group (four heads where G is 1), over
  max(1, the largest |element|) and over the reference's rms, the same of
  the fused kernel, and the f32 fused kernel's time in two variants of the
  checkout's flash_bwd.cu, each built alone (FUSED_VARIANTS; null for a
  checkout whose source lacks their lines): without its ordered dq
  read-modify-write (``fused_no_dq_rmw_ms``: the turn wait, the turn
  hand-over and the dq loads taken out, the share still computed and
  stored), and with each tile's share held in registers through the next
  tile's products and added to dq only then, so that the wait for its turn
  overlaps them (``fused_lag_ms``);
- GPT-2 small (published widths, random weights from seed 0) on 8 x 1024
  random tokens: tok/s as the median of steps 2-N and the peak memory, in
  float32 with Adam and in bf16 ``MixedPrecision`` + AdamW, each with the
  two-pass backward and, where the checkout has it, the fused one.

Run it for two checkouts in the order A, B, B, A within one machine to
compare them; each run is its own process.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

GPT2_SMALL = dict(vocab_size=50257, n_positions=1024, n_embd=768,
                  n_layer=12, n_head=12, layer_norm_epsilon=1e-5)
BATCH, LR = 8, 6e-4


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


# (row, query heads, KV heads, S, head dim, window, causal, lengths):
# PERF.md's rows 8 / 9 (GPT-2 small at batch 8), 8D (16 x 1024 x 256, 2 KV
# heads; 64 x 64 x 32, G 2), 9D (Pythia-1B's and Pythia-2.8B's layers), 8W
# (Mistral-7B's layer) and 8's lengths shape (BERT-base, 8 x 12 heads)
BWD_ROWS = (("8_9_gpt2", 96, 96, 1024, 64, 0, True, False),
            ("8D_d256", 16, 2, 1024, 256, 0, True, False),
            ("9D_pythia1b", 16, 16, 2048, 256, 0, True, False),
            ("9D_pythia2p8b", 32, 32, 2048, 80, 0, True, False),
            ("8W_mistral", 32, 8, 8192, 128, 4096, True, False),
            ("8D_d32", 64, 32, 64, 32, 0, True, False),
            ("9D_d32", 64, 64, 256, 32, 0, True, False),
            ("8_lengths", 96, 96, 128, 64, 0, False, True))

# variants of the f32 fused kernel: key -> (old, new) lines of flash_bwd.cu.
# fused_no_dq_rmw_ms: no wait for the turn, no hand-over, no load of the
# running sum (each share stored as it is); fused_lag_ms: each tile's share
# (tile pq) added to dq after the next tile's products, the last at the end
FUSED_VARIANTS = {
    "fused_no_dq_rmw_ms": (
        ("(size_t)bkv * nq + tile;\n    dq_wait_turn(turn, kb);",
         "(size_t)bkv * nq + tile;\n    (void)turn;"),
        ("    dq_pass_turn(turn, kb);\n  };", "  };"),
        ("old[nb] = kb > 0 && cg * DQW", "old[nb] = false && cg * DQW")),
    "fused_lag_ms": (
        ("  float share[NQ][4];\n  auto flush_dq",
         "  float share[NQ][4];\n  int pq = -1;\n  auto flush_dq"),
        ("      zero_frag(share);",
         "      if (pq >= 0) flush_dq(pq);\n      zero_frag(share);"),
        ("      flush_dq(qt);\n    }\n", "      pq = qt;\n    }\n"),
        ("    qe = nqe;\n  }\n\n#pragma unroll\n  for (int i = 0; i < 2; ++i) "
         "{\n    const int j = j0 + 8 * i;\n    if (j >= S) continue;\n    "
         "const size_t r = ((size_t)bkv * S + j) * d;",
         "    qe = nqe;\n  }\n  if constexpr (FUSED) {\n    if (pq >= 0) "
         "flush_dq(pq);\n  }\n\n#pragma unroll\n  for (int i = 0; i < 2; "
         "++i) {\n    const int j = j0 + 8 * i;\n    if (j >= S) continue;"
         "\n    const size_t r = ((size_t)bkv * S + j) * d;")),
}


def variant_builds(build, tmp):
    """Start building the checkout's flash_bwd.cu alone once per
    FUSED_VARIANTS entry whose lines it has (``build``: its ops._build
    module): {key: (library path, nvcc process)}."""
    text = open(os.path.join(build._CSRC, "flash_bwd.cu")).read()
    procs = {}
    for key, subs in FUSED_VARIANTS.items():
        if not all(old in text for old, _ in subs):
            continue
        where = os.path.join(tmp, key)
        shutil.copytree(build._CSRC, where)
        path = os.path.join(where, "flash_bwd.cu")
        patched = text
        for old, new in subs:
            patched = patched.replace(old, new)
        with open(path, "w") as f:
            f.write(patched)
        so = os.path.join(where, "lib.so")
        procs[key] = so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


class FusedFrom:
    """The checkout's kernel library with ``lg_flash_bwd_fused`` taken from
    another library."""

    def __init__(self, main, lib):
        self.main, self.lib = main, lib

    def __getattr__(self, name):
        return getattr(self.lib if name == "lg_flash_bwd_fused"
                       else self.main, name)


def bert_lengths(h, s, dev):
    """chip_smoke.py's BERT lengths: 8 examples of s // 2 to s valid rows
    (the first full), each repeated over its h / 8 heads."""
    import numpy as np

    lens = np.random.default_rng(0).integers(s // 2, s + 1, size=8)
    lens[0] = s
    return torch.as_tensor(lens, device=dev,
                           dtype=torch.int32).repeat_interleave(h // 8)


def bwd_f64(do, q, k, v, sc, causal, lengths=None, window=0):
    """(dq, dk, dv) of softmax(q k^T sc) v in float64, by the recompute
    backward's formulas: q, do (H, S, d); k, v (KV, S, d), grouped; padded
    query rows and keys (``lengths``) get zero gradients."""
    H, S, d = q.shape
    KV = k.shape[0]
    q4, g4 = (t.double().reshape(KV, H // KV, S, d) for t in (q, do))
    k3, v3 = k.double(), v.double()
    i = torch.arange(S, device=q.device)
    valid = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        valid = i[None, :] <= i[:, None]
        if window:
            valid = valid & (i[:, None] - i[None, :] < window)
    valid = valid.expand(KV, H // KV, S, S)
    if lengths is not None:
        ok = (i[None, :] < lengths.reshape(H, 1).long()).reshape(
            KV, H // KV, S)
        valid = valid & ok[..., None, :] & ok[..., :, None]
    s = torch.einsum("bgqd,bkd->bgqk", q4, k3) * sc
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), -1)
    p = torch.where(valid, p, 0.0)       # rows with no valid key: zeros
    del s
    dp = torch.einsum("bgqd,bkd->bgqk", g4, v3)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del dp
    return (torch.einsum("bgqk,bkd->bgqd", ds, k3).reshape(q.shape) * sc,
            torch.einsum("bgqk,bgqd->bkd", ds, q4) * sc,
            torch.einsum("bgqk,bgqd->bkd", p, g4))


def f64_errors(q, k, v, do, sc, causal, window, lengths, got, over="max"):
    """Largest error of each of got's (dq, dk, dv) against :func:`bwd_f64`
    of the first KV group (four query heads where G is 1), over max(1, the
    largest |element|), or with ``over`` "rms" over the reference's rms."""
    G = q.shape[0] // k.shape[0]
    n, kv = (G, 1) if G > 1 else (4, 4)
    want = bwd_f64(do[:n], q[:n], k[:kv], v[:kv], sc, causal,
                   None if lengths is None else lengths[:n], window)
    scale = [w.pow(2).mean().sqrt() if over == "rms"
             else w.abs().max().clamp_min(1.0) for w in want]
    return [((a[:m].double() - w).abs().max() / sc_).item()
            for a, w, m, sc_ in zip(got, want, (n, kv, kv), scale)]


def sdpa_backward_ms(q, k, v, do, window, causal=True, lengths=None):
    """PyTorch's SDPA backward (dq, dk and dv in one
    ``torch.autograd.grad``) at q (H, S, d), k and v (KV, S, d), causal
    (banded by a boolean mask where ``window``) or with a key mask from
    ``lengths``: its CUDA-graph time, as the graph time of forward and
    backward together less that of the forward alone (a graph captures the
    backward only with its forward), and its eager time over a retained
    graph."""
    import torch.nn.functional as F

    s = q.shape[1]
    ts = [t.detach().unsqueeze(0).requires_grad_() for t in (q, k, v)]
    kw = {"enable_gqa": k.shape[0] != q.shape[0]}
    if lengths is not None:
        i = torch.arange(s, device=q.device)
        kw["attn_mask"] = (i[None, :] < lengths[:, None])[None, :, None]
    elif window:
        i = torch.arange(s, device=q.device)
        kw["attn_mask"] = (i[None, :] <= i[:, None]) & \
            (i[:, None] - i[None, :] < window)
    else:
        kw["is_causal"] = causal
    g = do.unsqueeze(0)
    both = graph_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*ts, **kw), ts, g))
    with torch.no_grad():
        fwd = graph_ms(lambda: F.scaled_dot_product_attention(*ts, **kw))
    o = F.scaled_dot_product_attention(*ts, **kw)
    eager = cuda_ms(lambda: torch.autograd.grad(o, ts, g, retain_graph=True),
                    5)
    return both - fwd, eager


def backward_rows(att, builds=()):
    """Graph-timed ms of the backward's pieces at BWD_ROWS, causal, and of
    SDPA's backward at the same inputs; null where the checkout refuses a
    call.  ``builds``: :func:`variant_builds`'s."""
    from lightgrad_tpu_torch.ops import _build

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    fused = getattr(att, "set_flash_fused", None)
    variants = {}
    for key, (so, proc) in dict(builds).items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"ab_flash_bwd: variant {key} failed:\n{log}")
        variants[key] = ctypes.CDLL(so)
        entry = variants[key].lg_flash_bwd_fused
        entry.argtypes, entry.restype = _build._SIGNATURES[
            "lg_flash_bwd_fused"]
    res = {}
    for name, h, kvh, s, hd, window, causal, bert in BWD_ROWS:
        lens = bert_lengths(h, s, dev) if bert else None
        for dtype in (torch.float32, torch.bfloat16):
            sc = hd ** -0.5
            q, do = (torch.randn(h, s, hd, generator=g, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(kvh, s, hd, generator=g, device=dev)
                    .to(dtype) for _ in range(2))
            out, lse = att.attention_fwd_res(q, k, v, sc, causal,
                                             lengths=lens, window=window)
            dcap = (do.float() * out.float()).sum(-1).contiguous()
            r = {}

            def timed(key, fn):
                try:
                    r[key] = graph_ms(fn)
                except (RuntimeError, ValueError, TypeError):
                    r[key] = None

            timed("dq_ms", lambda: att.attention_bwd_dq(
                do, q, k, v, lse, dcap, sc, causal, lens, window=window))
            timed("dkv_ms", lambda: att.attention_bwd_dkv(
                do, q, k, v, lse, dcap, sc, causal, lens, window=window))
            has_fused = kvh == h and lens is None and fused is not None
            if has_fused:
                timed("fused_ms", lambda: att.attention_bwd_fused(
                    do, q, k, v, lse, dcap, sc, True))
            for key in FUSED_VARIANTS if has_fused \
                    and dtype == torch.float32 else ():
                r[key] = None
                if key in variants:
                    main_lib = _build.library()
                    _build._lib = FusedFrom(main_lib, variants[key])
                    try:
                        timed(key, lambda: att.attention_bwd_fused(
                            do, q, k, v, lse, dcap, sc, True))
                    finally:
                        _build._lib = main_lib
            try:
                r["sdpa_bwd_ms"], r["sdpa_bwd_eager_ms"] = sdpa_backward_ms(
                    q, k, v, do, window, causal, lens)
            except RuntimeError:
                r["sdpa_bwd_ms"] = r["sdpa_bwd_eager_ms"] = None
            if dtype == torch.float32:
                got = att.attention_bwd(do, q, k, v, sc, causal, out=out,
                                        lse=lse, lengths=lens, window=window)
                r["f64_err_dq_dk_dv"], r["f64_err_rms_dq_dk_dv"] = (
                    f64_errors(q, k, v, do, sc, causal, window, lens, got,
                               over) for over in ("max", "rms"))
                if has_fused:
                    got = att.attention_bwd_fused(do, q, k, v, lse, dcap, sc,
                                                  True)
                    r["fused_f64_err_dq_dk_dv"], \
                        r["fused_f64_err_rms_dq_dk_dv"] = (
                            f64_errors(q, k, v, do, sc, causal, window, lens,
                                       got, over) for over in ("max", "rms"))
                del got
            res[f"{name}_{str(dtype)[6:]}"] = r
            del q, k, v, do, out, lse, dcap
            torch.cuda.empty_cache()
    return res


def backward_times(att):
    """ms of the flash forward and the backward's pieces at 96 x 1024 x 64
    (the forward also at 12 x 1024 x 64), causal."""
    dev = torch.device("cuda")
    bh, s, hd = BATCH * GPT2_SMALL["n_head"], GPT2_SMALL["n_positions"], 64
    sc = hd ** -0.5
    g = torch.Generator(device=dev).manual_seed(8)
    fused = getattr(att, "set_flash_fused", None)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(bh, s, hd, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        out, lse = att.attention_fwd_res(q, k, v, sc, True)
        dcap = (do.float() * out.float()).sum(-1).contiguous()
        name = str(dtype)[6:]
        res[name] = {
            "fwd_ms": cuda_ms(lambda: att.attention_fwd_res(q, k, v, sc,
                                                            True)),
            "fwd_b1_ms": cuda_ms(lambda: att.attention_fwd_res(
                q[:GPT2_SMALL["n_head"]], k[:GPT2_SMALL["n_head"]],
                v[:GPT2_SMALL["n_head"]], sc, True)),
            "two_pass_ms": cuda_ms(lambda: att.attention_bwd(
                do, q, k, v, sc, True, out=out, lse=lse)),
            "dq_ms": cuda_ms(lambda: att.attention_bwd_dq(
                do, q, k, v, lse, dcap, sc, True)),
            "dkv_ms": cuda_ms(lambda: att.attention_bwd_dkv(
                do, q, k, v, lse, dcap, sc, True)),
        }
        if fused is not None:
            prev = fused(True)
            try:
                res[name]["fused_ms"] = cuda_ms(lambda: att.attention_bwd(
                    do, q, k, v, sc, True, out=out, lse=lse))
            finally:
                fused(prev)
        del q, k, v, do, out, lse, dcap
        torch.cuda.empty_cache()
    return res


# (name, query heads, KV heads, S, head dim, window)
LLAMA_FWD = (("mistral_window", 32, 8, 8192, 128, 4096),
             ("gemma_d256", 8, 1, 8192, 256, 0))


def llama_forward_times(att):
    """ms of the causal forward at the LLaMA prefill shapes, f32 and
    bf16; null where the checkout refuses the shape."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    res = {}
    for name, h, kvh, s, hd, window in LLAMA_FWD:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(h, s, hd, generator=g, device=dev).to(dtype)
            k, v = (torch.randn(kvh, s, hd, generator=g, device=dev)
                    .to(dtype) for _ in range(2))
            key = f"{name}_{str(dtype)[6:]}_ms"
            try:
                res[key] = cuda_ms(lambda: att.attention_fwd_res(
                    q, k, v, hd ** -0.5, True, window=window))
            except (RuntimeError, ValueError, TypeError):
                res[key] = None
            del q, k, v
            torch.cuda.empty_cache()
    return res


def train_step(lg, steps, f32=False):
    """tok/s (median of steps 2-N) and peak GiB of GPT-2 small's bf16
    MixedPrecision + AdamW step, or with ``f32`` its float32 + Adam step."""
    from lightgrad_tpu_torch import GPT, GPTConfig, amp, optim
    from lightgrad_tpu_torch.loss import cross_entropy

    dev = torch.device("cuda")
    cfg = GPTConfig(**GPT2_SMALL)
    b, t, vocab = BATCH, cfg.n_positions, cfg.vocab_size
    model = GPT(cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    if f32:
        mp = optim.Adam(model.parameters(), lr=LR)
    else:
        mp = amp.MixedPrecision(model, lambda ps: optim.AdamW(ps, lr=LR),
                                torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(11)
    ids = torch.randint(0, vocab, (b, t), generator=g, device=dev)
    tgt = torch.randint(0, vocab, (b * t,), generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = cross_entropy(model(ids).reshape(b * t, vocab), tgt)
        mp.zero_grad()
        loss.backward()
        mp.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        del loss
    later = sorted(times[1:])
    del model, mp
    torch.cuda.empty_cache()
    return {"tok_s": b * t / later[len(later) // 2],
            "step_s": times, "losses": losses,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="checkout whose lightgrad_tpu_torch is timed")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_flash_bwd: no CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import lightgrad_tpu_torch as lg
    from lightgrad_tpu_torch.ops import attention as att

    if os.path.dirname(os.path.dirname(os.path.abspath(lg.__file__))) != tree:
        sys.exit(f"ab_flash_bwd: imported {lg.__file__}, not from {tree}")
    from lightgrad_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    tmp = tempfile.mkdtemp()
    try:
        builds = variant_builds(_build, tmp)
        rec = {"tree": args.tree, "card": smi,
               "backward": backward_times(att),
               "backward_rows": backward_rows(att, builds)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec.update({"llama_forward": llama_forward_times(att),
                "train_f32": train_step(lg, args.steps, f32=True),
                "train_bf16": train_step(lg, args.steps)})
    fused = getattr(att, "set_flash_fused", None)
    if fused is not None:
        prev = fused(True)
        try:
            rec["train_f32_fused"] = train_step(lg, args.steps, f32=True)
            rec["train_bf16_fused"] = train_step(lg, args.steps)
        finally:
            fused(prev)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
