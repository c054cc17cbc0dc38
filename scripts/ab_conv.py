"""Time the conv kernels and ResNet-18's training step of one checkout of
the port, so that two checkouts can be compared on one card.

    python3 scripts/ab_conv.py --tree DIR [--steps N] [--no-steps]
                               [--no-kernels] [--staging]

imports ``lightgrad_tpu_torch`` from DIR (a checkout of any commit since the
conv path was ported), builds its kernels there, and prints one JSON line:

- the card's name and power limit (``nvidia-smi``);
- unless ``--no-kernels``, at each of the 11 distinct convolutions of
  ResNet-18's step at batch 32
  (with how many times a step runs each), in float32 and bfloat16: the
  device time by CUDA graph (10 replayed calls, the wrapper's whole call)
  of ``conv_fwd``, ``conv_bwd_dx`` and ``conv_bwd_dw``, beside cuDNN's
  (``F.conv2d``, ``conv2d_input``, ``conv2d_weight``; TF32 off, and for
  float32 also on), the least time the card could take (the larger of the
  bytes at 3.35 TB/s and the products at 989 TFLOP/s in bf16, or three
  tf32 passes at 495 TFLOP/s in f32), and the largest error against a
  float64 convolution over the largest |float64| element;
- with ``--staging`` (a checkout with ``conv_layout``, since the conv
  kernels' tensor-core rebuild), the staging's device time by CUDA graph
  in both dtypes: the stem's x channels-last with its 3 channels padded to
  one 16-byte chunk (float32 also as the tf32 hi / lo parts the forward
  takes), layer 1's x, and the sum over a step of the forward's weight
  reorders (Cout, Cg, KK) -> (Cout, KK, Cp) of the 11 shapes;
- unless ``--no-steps``, ResNet-18's float32 training step on the tape
  (32 x 3 x 224 x 224 random images, AdamW): images/s as the median of
  steps 2-N, the host time that queues forward + backward a tape op
  (median of steps 2-N over the ops the tape's profiler counts in a
  step), and one profiled step's device time by kernel family (conv, its
  staging, everything else) and its idle share of the median step (the
  profiled step's own wall time carries the profiler's start-up).

Run it for two checkouts in the order A, B, B, A within one machine to
compare them; each run is its own process.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BPS, BF16_OPS, TF32_OPS = 3.35e12, 989e12, 495e12
# ResNet-18's convolutions at batch 32, inputs after padding: (name, x, w,
# stride, forward / input-gradient / weight-gradient calls a step)
SHAPES = (
    ("stem 3->64 7x7/s2", (32, 3, 230, 230), (64, 3, 7, 7), 2, (1, 0, 1)),
    ("64->64 3x3", (32, 64, 58, 58), (64, 64, 3, 3), 1, (4, 4, 4)),
    ("64->128 3x3/s2", (32, 64, 58, 58), (128, 64, 3, 3), 2, (1, 1, 1)),
    ("128->128 3x3", (32, 128, 30, 30), (128, 128, 3, 3), 1, (3, 3, 3)),
    ("64->128 1x1/s2", (32, 64, 56, 56), (128, 64, 1, 1), 2, (1, 1, 1)),
    ("128->256 3x3/s2", (32, 128, 30, 30), (256, 128, 3, 3), 2, (1, 1, 1)),
    ("256->256 3x3", (32, 256, 16, 16), (256, 256, 3, 3), 1, (3, 3, 3)),
    ("128->256 1x1/s2", (32, 128, 28, 28), (256, 128, 1, 1), 2, (1, 1, 1)),
    ("256->512 3x3/s2", (32, 256, 16, 16), (512, 256, 3, 3), 2, (1, 1, 1)),
    ("512->512 3x3", (32, 512, 9, 9), (512, 512, 3, 3), 1, (3, 3, 3)),
    ("256->512 1x1/s2", (32, 256, 14, 14), (512, 256, 1, 1), 2, (1, 1, 1)),
)
# kernel-name fragment -> family of a profiled step's device time
FAMILIES = (("layout_", "conv layout"), ("conv_", "conv"),
            ("sum_partials", "conv"), ("sum_dw", "conv"))


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
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def rel_err(got, want64):
    return float((got.double() - want64).abs().max()
                 / want64.abs().max().clamp_min(1e-30))


def kernels():
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from lightgrad_tpu_torch.ops.conv import (conv_bwd_dw, conv_bwd_dx,
                                              conv_fwd)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for name, xs, ws, st, calls in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            fan_in = ws[1] * ws[2] * ws[3]
            x = torch.randn(xs, generator=g, device=dev).to(dtype)
            w = (torch.randn(ws, generator=g, device=dev)
                 * fan_in ** -0.5).to(dtype)
            y = conv_fwd(x, w, st)
            gy = torch.randn(y.shape, generator=g, device=dev).to(dtype)
            isz = x.element_size()
            ops = 2 * y.numel() * fan_in
            bound = max((x.numel() + w.numel() + y.numel()) * isz / HBM_BPS,
                        ops / BF16_OPS if dtype == torch.bfloat16
                        else 3 * ops / TF32_OPS) * 1e3
            x64, w64, gy64 = x.double(), w.double(), gy.double()
            rec = {"shape": name, "dtype": str(dtype)[6:], "calls": calls,
                   "bound_ms": bound}
            for kern, fn, lib, ref in (
                    ("fwd", lambda: conv_fwd(x, w, st),
                     lambda t=x, u=w: F.conv2d(t, u, stride=st),
                     lambda: F.conv2d(x64, w64, stride=st)),
                    ("dx", lambda: conv_bwd_dx(gy, w, x.shape, st),
                     lambda u=w, v=gy: conv2d_input(x.shape, u, v,
                                                    stride=st),
                     lambda: conv2d_input(x.shape, w64, gy64, stride=st)),
                    ("dw", lambda: conv_bwd_dw(gy, x, w.shape, st),
                     lambda t=x, v=gy: conv2d_weight(t, w.shape, v,
                                                     stride=st),
                     lambda: conv2d_weight(x64, w.shape, gy64, stride=st))):
                rec[kern + "_ms"] = graph_ms(fn)
                rec[kern + "_cudnn_ms"] = graph_ms(lib)
                want = ref()
                rec[kern + "_err"] = rel_err(fn(), want)
                if dtype == torch.float32:
                    rec[kern + "_cudnn_err"] = rel_err(lib(), want)
                    torch.backends.cudnn.allow_tf32 = True
                    rec[kern + "_cudnn_tf32_ms"] = graph_ms(lib)
                    rec[kern + "_cudnn_tf32_err"] = rel_err(lib(), want)
                    torch.backends.cudnn.allow_tf32 = False
                del want
            del x, w, y, gy, x64, w64, gy64
            torch.cuda.empty_cache()
            print(json.dumps(rec), file=sys.stderr, flush=True)
            out.append(rec)
    return out


def staging():
    """Graph times of conv_layout at the stem's x, layer 1's x and the
    forward's weight reorders of a step."""
    from lightgrad_tpu_torch.ops.conv import conv_layout

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        cw = 16 // torch.tensor([], dtype=dtype).element_size()
        rec = {"dtype": str(dtype)[6:]}
        for name, (_, xs, ws, _, _) in (("stem_x", SHAPES[0]),
                                        ("layer1_x", SHAPES[1])):
            x = torch.randn(xs, generator=g, device=dev).to(dtype)
            cp = -(-xs[1] // cw) * cw
            view = (xs[0], xs[1], xs[2] * xs[3], cp)
            rec[name + "_ms"] = graph_ms(lambda: conv_layout(x, *view))
            if dtype == torch.float32:
                rec[name + "_split_ms"] = graph_ms(
                    lambda: conv_layout(x, *view, split=True))
            del x
        total = 0.0
        for _, xs, ws, _, calls in SHAPES:
            w = torch.randn(ws, generator=g, device=dev).to(dtype)
            cp = -(-ws[1] // cw) * cw
            view = (ws[0], ws[1], ws[2] * ws[3], cp)
            total += calls[0] * graph_ms(lambda: conv_layout(
                w, *view, split=dtype == torch.float32))
            del w
        rec["weights_step_ms"] = total
        torch.cuda.empty_cache()
        print(json.dumps(rec), file=sys.stderr, flush=True)
        out.append(rec)
    return out


def resnet_step(n):
    """ResNet-18's float32 tape step: images/s (median of steps 2-n) and
    one profiled step's device time by family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.models import resnet18
    from lightgrad_tpu_torch.utils.profiler import Profiler

    lg_random.seed(0)
    model = resnet18()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    x = Tensor(torch.randn(32, 3, 224, 224, generator=gen, device=dev),
               requires_grad=False)
    y = Tensor(torch.randint(0, 1000, (32,), generator=gen,
                             device=dev).to(torch.int32), requires_grad=False)
    opt = optim.AdamW(list(model.parameters()), lr=1e-3)

    def step():
        t0 = time.perf_counter()
        loss = lg_loss.cross_entropy(model(x), y)
        opt.zero_grad()
        loss.backward()
        queued = time.perf_counter() - t0   # forward + backward queued
        opt.step()
        return queued

    times, host = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with Profiler() as prof:
        step()
    n_ops = sum(prof.fwd_count.values()) + sum(prof.bwd_count.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    fams = {"conv": 0.0, "conv layout": 0.0, "other": 0.0}
    for e in trace.events():
        if e.device_type == DeviceType.CUDA:
            fam = next((f for k, f in FAMILIES if k in e.name), "other")
            fams[fam] += e.time_range.elapsed_us() / 1e3
    busy = sum(fams.values())
    step_ms = float(np.median(times[1:])) * 1e3
    rec = {"images_s": 32e3 / step_ms,
           "step_s": [round(t, 4) for t in times], "tape_ops": n_ops,
           "host_us_op": float(np.median(host[1:])) * 1e6 / n_ops,
           "device_ms": fams, "busy_ms": busy, "profiled_wall_ms": wall,
           "idle": 1 - busy / step_ms}
    print(json.dumps(rec), file=sys.stderr, flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--no-steps", action="store_true")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--staging", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_conv: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import lightgrad_tpu_torch
    from lightgrad_tpu_torch.ops import _build

    assert os.path.dirname(lightgrad_tpu_torch.__file__).startswith(tree)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
    rec = {"tree": args.tree, "card": smi,
           "build_s": time.perf_counter() - t0}
    if not args.no_kernels:
        rec["conv"] = kernels()
    if args.staging:
        rec["staging"] = staging()
    if not args.no_steps:
        rec["resnet18"] = resnet_step(args.steps)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
