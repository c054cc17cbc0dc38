"""Time three rules for Mixtral's routed FFN in the decode functions, one
layer at Mixtral-8x7B's widths (d 4096, ff 14336, 8 experts, top-2,
SwiGLU, bfloat16), over B rows routed at random:

- ``gather``: each row's k expert stacks picked by ``index_select``, then
  einsum products over the copies (the JAX package's step);
- ``loop``: every expert over the rows, one expert at a time, weighted by
  its gate (zero where a row did not choose it);
- ``batched``: every expert over the rows by three batched products over
  the (E, d, ff) stacks read in place, weighted so (the port's
  ``Llama._kv_functions``).

    python3 scripts/ab_moe_ffn.py [--rows 1 4] [--iters 20]

prints the card's name and power limit (``nvidia-smi``), then one JSON line
a (rule, B): the device ms of a call (CUDA events, median of ``iters``
calls after 3 warm ones), the bytes the rule moves (stacks read, copies
written and read again) and the time they take at 3.35 TB/s, the kernels
a call launches (``torch.profiler``), and the largest difference from the
``batched`` rule's output."""

import argparse
import functools
import json
import subprocess

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

HBM_BPS = 3.35e12
D, FF, E, K = 4096, 14336, 8, 2


def gather(h, w1, w3, w2, gates, ids):
    B, k = ids.shape
    rows = ids.reshape(-1)
    a1, a3, a2 = (w.index_select(0, rows).view(B, k, *w.shape[1:])
                  for w in (w1, w3, w2))
    g = torch.einsum("bd,bkdf->bkf", h, a1)
    u = torch.einsum("bd,bkdf->bkf", h, a3)
    y = torch.einsum("bkf,bkfd->bkd", F.silu(g) * u, a2)
    return torch.einsum("bk,bkd->bd", gates, y)


def combine(h, gates, ids):
    return torch.zeros((h.shape[0], E), device=h.device,
                       dtype=h.dtype).scatter(-1, ids, gates)


def loop(h, w1, w3, w2, gates, ids):
    comb = combine(h, gates, ids)
    out = None
    for e in range(E):
        y = (F.silu(h @ w1[e]) * (h @ w3[e])) @ w2[e] * comb[:, e:e + 1]
        out = y if out is None else out + y
    return out


def batched(h, w1, w3, w2, gates, ids):
    comb = combine(h, gates, ids)
    y = (F.silu(h @ w1) * (h @ w3)) @ w2
    return (y * comb.T[:, :, None]).sum(0)


def device_ms(fn, iters):
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def launches(fn):
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in trace.events()
               if e.device_type == DeviceType.CUDA)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16

    def rand(*shape, scale):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dt)

    w1, w3 = (rand(E, D, FF, scale=D ** -0.5) for _ in range(2))
    w2 = rand(E, FF, D, scale=FF ** -0.5)
    stack = 3 * D * FF * 2
    for B in args.rows:
        h = rand(B, D, scale=1.0)
        probs = torch.softmax(torch.randn(B, E, device="cuda",
                                          generator=gen), -1)
        top, ids = probs.topk(K, -1)
        gates = (top / top.sum(-1, keepdim=True)).to(dt)
        ref = batched(h, w1, w3, w2, gates, ids)
        moved = {"gather": 3 * B * K * stack, "loop": E * stack,
                 "batched": E * stack}
        for name, rule in (("gather", gather), ("loop", loop),
                           ("batched", batched)):
            call = functools.partial(rule, h, w1, w3, w2, gates, ids)
            err = (call().float() - ref.float()).abs().max().item()
            print(json.dumps({
                "rule": name, "rows": B, "ms": device_ms(call, args.iters),
                "bytes": moved[name],
                "bytes_ms": moved[name] / HBM_BPS * 1e3,
                "launches": launches(call), "max_abs_diff": err}),
                flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
