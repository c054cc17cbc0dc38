"""Time the decode-attention kernel of one checkout of the port at the
serving paths' shapes, so that two checkouts can be compared on one card.

    python3 scripts/ab_decode_attention.py --tree DIR

imports ``lightgrad_tpu_torch`` from DIR, builds its kernels there, and
prints one JSON line: the card's name and power limit (``nvidia-smi``), and
for float32 and bfloat16 the CUDA-event mean over 50 eager calls of
``decode_attention`` (launch work included), the device time of one call
from 50 calls replayed in a CUDA graph (``*_graph``), and its max abs error
against the plain version, at

- GPT-2 small's step: q (12, 1, 64), W 1024, pos 512, and pos 10;
- Mistral-7B's: q (8, 4, 128), W 8192, pos 6000, window 4096, pos 4500
  (its serving path's ``generate``) and pos 1500;
- Gemma-2B's: q (1, 8, 256), W 8192, pos 4096, and pos 1000 (null where
  the checkout's kernel refuses head dim 256);
- examples/llama.py's char model: q (2, 2, 32), W 192, pos 100.

Run it for two checkouts in the order A, B, B, A within one machine to
compare them; each run is its own process.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

# (name, KV, G, hd, W, pos, window)
SHAPES = (("gpt2", 12, 1, 64, 1024, 512, 0),
          ("gpt2_pos10", 12, 1, 64, 1024, 10, 0),
          ("mistral_4500", 8, 4, 128, 8192, 4500, 4096),
          ("mistral", 8, 4, 128, 8192, 6000, 4096),
          ("gemma", 1, 8, 256, 8192, 4096, 0),
          ("mistral_short", 8, 4, 128, 8192, 1500, 4096),
          ("gemma_short", 1, 8, 256, 8192, 1000, 0),
          ("char", 2, 2, 32, 192, 100, 0))


def cuda_ms(fn, iters=50):
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


def graph_ms(fn, iters=50):
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed between two CUDA events (no host launch work)."""
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
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    from lightgrad_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": args.tree, "card": smi}
    for dtype in (torch.float32, torch.bfloat16):
        for name, KV, G, hd, W, pos, window in SHAPES:
            q = torch.randn(KV, G, hd, generator=g, device=dev).to(dtype)
            kc, vc = (torch.randn(KV, W, hd, generator=g, device=dev)
                      .to(dtype) for _ in range(2))
            key = f"{name}_{str(dtype)[6:]}"
            try:
                got = decode_attention(q, kc, vc, pos, hd ** -0.5, window)
            except (RuntimeError, ValueError) as e:
                out[key] = None
                out[key + "_refused"] = str(e).splitlines()[0][:120]
                continue
            want = decode_attention_reference(q, kc, vc, pos, hd ** -0.5,
                                              window)
            out[key + "_err"] = (got.float() - want.float()).abs().max() \
                .item()
            call = (lambda: decode_attention(q, kc, vc, pos, hd ** -0.5,
                                             window))
            out[key] = cuda_ms(call)
            try:
                out[key + "_graph"] = graph_ms(call)
            except RuntimeError as e:  # a launch the capture refuses
                out[key + "_graph"] = None
                out[key + "_graph_refused"] = str(e).splitlines()[0][:120]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
