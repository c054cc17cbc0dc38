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
