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
  the shapes of PERF.md's rows 8, 8D, 8W, 9 and 9D, float32 and bfloat16:
  the dq pass, the dk/dv pass and, where G is 1, the fused kernel (with its
  dq sum and cast); PyTorch's SDPA backward (dq, dk, dv in one
  ``torch.autograd.grad``) beside them, its eager time too;
- GPT-2 small (published widths, random weights from seed 0), bf16
  ``MixedPrecision`` + AdamW on 8 x 1024 random tokens: tok/s as the median
  of steps 2-N and the peak memory, with the two-pass backward, and with the
  fused one where the checkout has it.

Run it for two checkouts in the order A, B, B, A within one machine to
compare them; each run is its own process.
"""

import argparse
import json
import os
import subprocess
import sys
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


# (row, query heads, KV heads, S, head dim, window): PERF.md's rows 8 / 9
# (GPT-2 small at batch 8), 8D (16 x 1024 x 256, 2 KV heads), 9D
# (Pythia-1B's and Pythia-2.8B's layers) and 8W (Mistral-7B's layer)
BWD_ROWS = (("8_9_gpt2", 96, 96, 1024, 64, 0),
            ("8D_d256", 16, 2, 1024, 256, 0),
            ("9D_pythia1b", 16, 16, 2048, 256, 0),
            ("9D_pythia2p8b", 32, 32, 2048, 80, 0),
            ("8W_mistral", 32, 8, 8192, 128, 4096))


def sdpa_backward_ms(q, k, v, do, window):
    """PyTorch's SDPA backward (dq, dk and dv in one
    ``torch.autograd.grad``) at q (H, S, d), k and v (KV, S, d), causal
    (banded by a boolean mask where ``window``): its CUDA-graph time, as the
    graph time of forward and backward together less that of the forward
    alone (a graph captures the backward only with its forward), and its
    eager time over a retained graph."""
    import torch.nn.functional as F

    s = q.shape[1]
    ts = [t.detach().unsqueeze(0).requires_grad_() for t in (q, k, v)]
    kw = {"enable_gqa": k.shape[0] != q.shape[0]}
    if window:
        i = torch.arange(s, device=q.device)
        kw["attn_mask"] = (i[None, :] <= i[:, None]) & \
            (i[:, None] - i[None, :] < window)
    else:
        kw["is_causal"] = True
    g = do.unsqueeze(0)
    both = graph_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*ts, **kw), ts, g))
    with torch.no_grad():
        fwd = graph_ms(lambda: F.scaled_dot_product_attention(*ts, **kw))
    o = F.scaled_dot_product_attention(*ts, **kw)
    eager = cuda_ms(lambda: torch.autograd.grad(o, ts, g, retain_graph=True),
                    5)
    return both - fwd, eager


def backward_rows(att):
    """Graph-timed ms of the backward's pieces at BWD_ROWS, causal, and of
    SDPA's backward at the same inputs; null where the checkout refuses a
    call."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    fused = getattr(att, "set_flash_fused", None)
    res = {}
    for name, h, kvh, s, hd, window in BWD_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            sc = hd ** -0.5
            q, do = (torch.randn(h, s, hd, generator=g, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(kvh, s, hd, generator=g, device=dev)
                    .to(dtype) for _ in range(2))
            out, lse = att.attention_fwd_res(q, k, v, sc, True,
                                             window=window)
            dcap = (do.float() * out.float()).sum(-1).contiguous()
            r = {}

            def timed(key, fn):
                try:
                    r[key] = graph_ms(fn)
                except (RuntimeError, ValueError, TypeError):
                    r[key] = None

            timed("dq_ms", lambda: att.attention_bwd_dq(
                do, q, k, v, lse, dcap, sc, True, window=window))
            timed("dkv_ms", lambda: att.attention_bwd_dkv(
                do, q, k, v, lse, dcap, sc, True, window=window))
            if kvh == h and fused is not None:
                timed("fused_ms", lambda: att.attention_bwd_fused(
                    do, q, k, v, lse, dcap, sc, True))
            try:
                r["sdpa_bwd_ms"], r["sdpa_bwd_eager_ms"] = sdpa_backward_ms(
                    q, k, v, do, window)
            except RuntimeError:
                r["sdpa_bwd_ms"] = r["sdpa_bwd_eager_ms"] = None
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


def train_step(lg, steps):
    """tok/s (median of steps 2-N) and peak GiB of GPT-2 small's bf16
    MixedPrecision + AdamW step."""
    from lightgrad_tpu_torch import GPT, GPTConfig, amp, optim
    from lightgrad_tpu_torch.loss import cross_entropy

    dev = torch.device("cuda")
    cfg = GPTConfig(**GPT2_SMALL)
    b, t, vocab = BATCH, cfg.n_positions, cfg.vocab_size
    model = GPT(cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rec = {"tree": args.tree, "card": smi, "backward": backward_times(att),
           "backward_rows": backward_rows(att),
           "llama_forward": llama_forward_times(att),
           "train_bf16": train_step(lg, args.steps)}
    fused = getattr(att, "set_flash_fused", None)
    if fused is not None:
        prev = fused(True)
        try:
            rec["train_bf16_fused"] = train_step(lg, args.steps)
        finally:
            fused(prev)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
