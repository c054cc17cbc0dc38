"""Time the reduce and LayerNorm kernels, and the training steps that run
them, of one checkout of the port, so that two checkouts can be compared
on one card.

    python3 scripts/ab_reduce.py --tree DIR [--steps N] [--no-steps]
                                 [--tally] [--no-kernels]

imports ``lightgrad_tpu_torch`` from DIR (a checkout of any commit since the
tape was ported), builds its kernels there, and prints one JSON line:

- the card's name and power limit (``nvidia-smi``);
- unless ``--no-kernels``, ``ops.reduce.reduce`` by CUDA graph (device time
  of 10 replayed calls, the wrapper's whole call) at the layout classes the
  main paths give it (``CLASSES``: rows, columns, BatchNorm's three-stride
  walk, a whole tensor), sum and max, float32 and bfloat16, beside one
  PyTorch call over the same dims (``torch.sum`` / ``torch.amax``), the
  least time the card could take (input read once, output written once, at
  3.35 TB/s), the largest error against ``reduce_reference``, whether two
  calls agree bit for bit, and the device memory a call allocates beyond
  its output over the input's size, and the host µs of a split column
  sum's eager call; then LayerNorm's forward and whole
  backward (dx, dw, db) as the autograd Functions run them at the widths
  the paths run (``LN_SHAPES``), beside ``F.layer_norm`` and aten's
  three-gradient ``native_layer_norm_backward``, with their bounds, and
  the host µs of their eager calls on 64 rows;
- with ``--tally``, one training step of each main path (ResNet-18,
  BERT-base, Pythia-1B, Mistral-7B and Gemma-2B on the tape, GPT-2 small
  float32 and bfloat16 AMP on torch.autograd) with every call of
  ``reduce`` and of the LayerNorm wrappers counted by (K, R, layout class,
  dtype) and (rows, columns, dtype), and where the checkout plans its
  reduces (``_plan``), each call's kernel and split count or "copy";
- unless ``--no-steps``, the float32 tape steps of ResNet-18 (32 x 3 x
  224²), BERT-base (masked LM, 8 x 128) and Pythia-1B (2 x 2048, fused
  flash backward) and GPT-2 small's bfloat16 AMP step (8 x 1024):
  tokens/s or images/s and the host ms that queue a step (medians of
  steps 2-N), peak memory, and one
  profiled step's device time by kernel family (reduce, layernorm, plain
  torch, ...) with its idle share of the median step.

Run it for two checkouts in the order A, B, B, A within one machine to
compare them; each run is its own process.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from collections import Counter
from math import prod

import numpy as np
import torch

HBM_BPS = 3.35e12
# (label, shape, axis): the layout classes of reduce on the main paths
CLASSES = (
    ("row: MLM loss row sum 1024x30522, axis -1", (1024, 30522), -1),
    ("column: GPT-2 width bias gradient 8192x768, axis 0", (8192, 768), 0),
    ("column: Pythia-1B MLP bias gradient 4096x8192, axis 0",
     (4096, 8192), 0),
    ("column: BERT bias gradient (8, 128, 3072), axes (0, 1)",
     (8, 128, 3072), (0, 1)),
    ("three-stride: BatchNorm 32x64x56x56, axes (0, 2, 3)",
     (32, 64, 56, 56), (0, 2, 3)),
    ("three-stride: BatchNorm 32x64x112x112, axes (0, 2, 3)",
     (32, 64, 112, 112), (0, 2, 3)),
    ("three-stride: BatchNorm 32x512x7x7, axes (0, 2, 3)",
     (32, 512, 7, 7), (0, 2, 3)),
    ("whole: 32x64x56x56, axis None", (32, 64, 56, 56), None),
)
# (label, rows, columns): GPT-2 and BERT (768), Pythia-1B (2 x 2048 rows of
# 2048), Pythia-2.8B (1 x 2048 rows of 2560)
LN_SHAPES = (("8192x768", 8192, 768), ("4096x2048", 4096, 2048),
             ("2048x2560", 2048, 2560))
FAMILIES = (("matmul_tc_kernel", "matmul"), ("ew_kernel", "elementwise"),
            ("reduce_rows", "reduce"), ("lg_reduce_", "reduce"),
            ("softmax_", "softmax"),
            ("ln_", "layernorm"), ("true>(", "fused flash backward"),
            ("flash", "attention"), ("layout_", "conv layout"),
            ("conv_", "conv"), ("sum_partials", "conv"), ("sum_dw", "conv"))
PYTHIA_1B = dict(vocab_size=50304, hidden_size=2048, intermediate_size=8192,
                 num_hidden_layers=16, num_attention_heads=8,
                 max_position_embeddings=2048, rotary_pct=0.25,
                 rotary_emb_base=10000.0, layer_norm_eps=1e-5,
                 use_parallel_residual=True)
MISTRAL_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                  num_hidden_layers=2, num_attention_heads=32,
                  num_key_value_heads=8, max_position_embeddings=8192,
                  rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=4096,
                  tie_word_embeddings=False)
GEMMA_2B = dict(vocab_size=256000, hidden_size=2048, intermediate_size=16384,
                num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=1, head_dim=256,
                max_position_embeddings=8192, rms_norm_eps=1e-6,
                rope_theta=10000.0, hidden_act="gelu_pytorch_tanh",
                rms_offset=True, scale_embeddings=True,
                tie_word_embeddings=True)
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12)
GPT2_SMALL = dict(vocab_size=50257, n_positions=1024, n_embd=768,
                  n_layer=12, n_head=12, layer_norm_epsilon=1e-5)


def log(rec):
    print(json.dumps(rec), file=sys.stderr, flush=True)


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


def host_us(fn, calls=200):
    """Wall µs a call of ``calls`` eager calls ended by one synchronise: at
    these sizes the host's launch work, not the device, sets it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def rel_err(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1.0))


def reduce_kernels():
    from lightgrad_tpu_torch.ops.reduce import reduce, reduce_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for label, shape, axis in CLASSES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            for op, lib in (("sum", torch.sum), ("max", torch.amax)):
                dims = tuple(range(x.dim())) if axis is None else axis
                y = reduce(x, op, axis=axis)
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                y2 = reduce(x, op, axis=axis)
                torch.cuda.synchronize()
                extra = (torch.cuda.max_memory_allocated() - before
                         - y2.numel() * y2.element_size())
                nbytes = (x.numel() + y.numel()) * x.element_size()
                rec = {"class": label, "dtype": str(dtype)[6:], "op": op,
                       "ms": graph_ms(lambda: reduce(x, op, axis=axis)),
                       "library_ms": graph_ms(lambda: lib(x, dims)),
                       "bound_ms": nbytes / HBM_BPS * 1e3,
                       "err": rel_err(y, reduce_reference(x, op, axis)),
                       "bitwise_repeat": bool(torch.equal(y, y2)),
                       "extra_memory_over_input": extra / (
                           x.numel() * x.element_size())}
                log(rec)
                out.append(rec)
                del y, y2
            del x
            torch.cuda.empty_cache()
    # host work a call, at BERT-base's bias gradient (a split column sum)
    x = torch.randn(8, 128, 768, generator=g, device=dev)
    rec = {"host_us_a_call": host_us(lambda: reduce(x, "sum", axis=(0, 1))),
           "shape": "(8, 128, 768), axes (0, 1)"}
    log(rec)
    out.append(rec)
    return out


def layernorm_pair(lnm):
    """(forward, backward) as the checkout's autograd Functions run them:
    forward(x, w, b) -> saved state, backward(g, state) -> (dx, dw, db).
    Before the LayerNorm redesign the backward was the dx kernel and the
    torch.nn Function's plain torch dw / db (``tape`` False) or the tape's
    elementwise multiply and two column reduces (``tape`` True)."""
    if hasattr(lnm, "layernorm_bwd"):
        def fwd(x, w, b):
            y, mean, rstd = lnm.layernorm_fwd_stats(x, w, b, 1e-5)
            return y, (x, w, mean, rstd)

        def bwd(g, state, tape=False):
            return lnm.layernorm_bwd(g, *state)
        return fwd, bwd

    from lightgrad_tpu_torch.ops.elementwise import ew
    from lightgrad_tpu_torch.ops.reduce import reduce

    def fwd(x, w, b):
        y, xhat, rstd = lnm.layernorm_fwd(x, w, b, 1e-5)
        return y, (w, xhat, rstd)

    def bwd(g, state, tape=False):
        w, xhat, rstd = state
        dx = lnm.layernorm_bwd_dx(g, w, xhat, rstd)
        if tape:
            return (dx, reduce(ew("f_mul", g, xhat), "sum", axis=0),
                    reduce(g, "sum", axis=0))
        g32 = g.float()
        return (dx, (g32 * xhat).sum(0).to(w.dtype),
                g32.sum(0).to(w.dtype))
    return fwd, bwd


def layernorm_kernels():
    import torch.nn.functional as F

    from lightgrad_tpu_torch.ops import layernorm as lnm

    fwd, bwd = layernorm_pair(lnm)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    out = []
    for label, r, c in LN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.tensor([], dtype=dtype).element_size()
            x = (torch.randn(r, c, generator=g, device=dev) * 2 + 0.5).to(
                dtype)
            w, b = (torch.randn(c, generator=g, device=dev).to(dtype)
                    for _ in range(2))
            gy = torch.randn(r, c, generator=g, device=dev).to(dtype)
            y, state = fwd(x, w, b)
            saved = sum(t.numel() * t.element_size() for t in state
                        if t is not x and t is not w)
            reads_x = any(t is x for t in state)
            ref = F.layer_norm(x.float(), (c,), w.float(), b.float(), 1e-5)
            dx, dw, db = bwd(gy, state)
            xr = x.float().requires_grad_()
            wr, br = (t.float().requires_grad_() for t in (w, b))
            yr = F.layer_norm(xr, (c,), wr, br, 1e-5)
            rdx, rdw, rdb = torch.autograd.grad(yr, (xr, wr, br), gy.float())
            _, mean, lrstd = torch.ops.aten.native_layer_norm(x, [c], w, b,
                                                              1e-5)
            rec = {"shape": label, "dtype": str(dtype)[6:],
                   "saved_bytes_beyond_x_w": saved,
                   "fwd_ms": graph_ms(lambda: fwd(x, w, b)),
                   "fwd_library_ms": graph_ms(
                       lambda: F.layer_norm(x, (c,), w, b, 1e-5)),
                   # x, w, b read; y written; the residuals the autograd
                   # Function saves beyond x and w
                   "fwd_bound_ms": ((2 * r * c + 2 * c) * isz + saved)
                   / HBM_BPS * 1e3,
                   "bwd_ms": graph_ms(lambda: bwd(gy, state)),
                   "bwd_tape_ms": graph_ms(lambda: bwd(gy, state, True)),
                   "bwd_library_ms": graph_ms(
                       lambda: torch.ops.aten.native_layer_norm_backward(
                           gy, x, [c], mean, lrstd, w, b,
                           [True, True, True])),
                   # g and the saved residuals (x or xhat, w, statistics)
                   # read; dx, dw, db written
                   "bwd_bound_ms": ((2 * r * c + 3 * c) * isz + saved
                                    + reads_x * r * c * isz) / HBM_BPS * 1e3,
                   "err_y": rel_err(y, ref), "err_dx": rel_err(dx, rdx),
                   "err_dw": rel_err(dw, rdw), "err_db": rel_err(db, rdb)}
            if hasattr(lnm, "layernorm_bwd"):
                again = bwd(gy, state)
                rec["bitwise_repeat"] = all(
                    torch.equal(a, b2) for a, b2 in zip((dx, dw, db), again))
            log(rec)
            out.append(rec)
            del x, w, b, gy, y, state, dx, dw, db, xr, wr, br, yr
            torch.cuda.empty_cache()
    # host work a call, on 64 rows of 768: the launches, not the device
    x, gy = (torch.randn(64, 768, generator=g, device=dev) for _ in range(2))
    w, b = (torch.randn(768, generator=g, device=dev) for _ in range(2))
    _, state = fwd(x, w, b)
    rec = {"shape": "64x768 host",
           "fwd_host_us": host_us(lambda: fwd(x, w, b)),
           "bwd_host_us": host_us(lambda: bwd(gy, state)),
           "bwd_tape_host_us": host_us(lambda: bwd(gy, state, True))}
    log(rec)
    out.append(rec)
    return out


# --- the tally ----------------------------------------------------------
def layout_class(shape, strides, axes):
    """The layout class of a reduce call: "whole" (nothing kept), "row"
    (the reduced axes are one contiguous run), "column" (the kept axes are
    one contiguous run and the reduced axes one strided run),
    "three-stride" (the kept axes one run between two reduced runs, as
    BatchNorm's (0, 2, 3) over NCHW), "copy" (no such walk: a transposed
    copy in any design), "strided" (one run, neither contiguous)."""
    def runs(dims):
        dims = sorted(dims, key=lambda t: -t[1])
        out = []
        for n, s in dims:
            if out and out[-1][1] == s * n:
                out[-1] = (out[-1][0] * n, s)
            else:
                out.append((n, s))
        return out

    dims = [(n, s, d in axes) for d, (n, s) in enumerate(zip(shape, strides))
            if n != 1]
    kept = [(n, s) for n, s, red in dims if not red]
    red = runs([(n, s) for n, s, r in dims if r])
    if not kept:
        return "whole"
    k = [(kept[-1])]
    for n, s in reversed(kept[:-1]):
        if s != k[0][1] * k[0][0]:
            return "copy"
        k[0] = (k[0][0] * n, k[0][1])
    if len(red) > 2:
        return "copy"
    if len(red) == 2:
        return "three-stride"
    if red and red[0][1] == 1:
        return "row"
    if k[0][1] == 1:
        return "column"
    return "strided"


def install_tally():
    """Wrap ``reduce`` and the LayerNorm wrappers wherever the package
    binds them; returns the Counter the wrappers add to."""
    # the package's names shadow these modules (ops.reduce is the function)
    lnm = importlib.import_module("lightgrad_tpu_torch.ops.layernorm")
    rm = importlib.import_module("lightgrad_tpu_torch.ops.reduce")

    tally = Counter()
    orig_reduce = rm.reduce

    def reduce(x, op, axis=None, keepdims=False):
        rank = x.dim()
        if axis is None:
            axes = tuple(range(rank))
        else:
            a = axis if isinstance(axis, (tuple, list)) else (axis,)
            axes = tuple(sorted({i % rank for i in a}))
        if axes and x.is_cuda:
            k = prod(x.shape[d] for d in range(rank) if d not in axes)
            r = prod(x.shape[d] for d in axes)
            key = ("reduce", op, layout_class(x.shape, x.stride(), axes), k,
                   r, str(x.dtype)[6:], tuple(x.shape), axes)
            if hasattr(rm, "_plan"):    # the checkout's own walk and split
                plan = rm._plan(tuple(x.shape), x.stride(), axes,
                                x.element_size(), rm._n_sm(x.device))
                key += (("copy",) if plan is None else (
                    plan.kind, plan.splits1 * plan.splits2),)
            tally[key] += 1
        return orig_reduce(x, op, axis=axis, keepdims=keepdims)

    wraps = {id(orig_reduce): reduce}
    for name in dir(lnm):
        fn = getattr(lnm, name)
        if (callable(fn) and name.startswith("layernorm_")
                and not name.endswith("_reference")
                and getattr(fn, "__module__", "") == lnm.__name__):
            def wrapped(*args, _fn=fn, _name=name):
                t = args[0]
                c = args[1].numel() if _name.startswith("layernorm_fwd") \
                    else t.shape[-1]
                if t.is_cuda:
                    tally[(_name, t.numel() // c, c, str(t.dtype)[6:])] += 1
                return _fn(*args)
            wraps[id(fn)] = wrapped
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("lightgrad_tpu_torch"):
            continue
        for name, val in list(vars(mod).items()):
            if id(val) in wraps:
                setattr(mod, name, wraps[id(val)])
    return tally


def tally_paths():
    """One training step of each main path under the tally's wrappers."""
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
    from lightgrad_tpu_torch.models.neox import NeoX, NeoXConfig

    tally = install_tally()
    out = {}
    for name, make, step in (
            ("ResNet-18", None, lambda: resnet_step(1)),
            ("BERT-base", lambda: BertForMaskedLM(BertConfig(**BERT_BASE)),
             None),
            ("Pythia-1B", lambda: NeoX(NeoXConfig(**PYTHIA_1B)), None),
            ("Mistral-7B (2 layers, 1 x 8192)",
             lambda: Llama(LlamaConfig(**MISTRAL_7B)), None),
            ("Gemma-2B (2 layers, 2 x 1024)",
             lambda: Llama(LlamaConfig(**GEMMA_2B)), None),
            ("GPT-2 small f32 Adam", None,
             lambda: gpt2_steps(1, torch.float32)),
            ("GPT-2 small bf16 AMP", None,
             lambda: gpt2_steps(1, torch.bfloat16))):
        tally.clear()
        if step is None:
            cfg = {"BERT-base": (BERT_BASE, 8, 128, False),
                   "Pythia-1B": (PYTHIA_1B, 2, 2048, True),
                   "Mistral-7B (2 layers, 1 x 8192)": (MISTRAL_7B, 1, 8192,
                                                       False),
                   "Gemma-2B (2 layers, 2 x 1024)": (GEMMA_2B, 2, 1024,
                                                     False)}[name]
            lm_steps(name, make, *cfg, n=1)
        else:
            step()
        rows = [{"fn": k[0], "key": list(k[1:]), "calls": v}
                for k, v in sorted(tally.items(), key=lambda kv: -kv[1])]
        out[name] = rows
        log({"tally": name, "rows": rows})
        torch.cuda.empty_cache()
    return out


# --- steps ------------------------------------------------------------------
def breakdown(step, step_ms):
    """One profiled step's device ms by kernel family, and its idle share
    of the median step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        step()
        torch.cuda.synchronize()
    fams = Counter()
    launches = Counter()
    for e in trace.events():
        if e.device_type == DeviceType.CUDA:
            fam = next((f for k, f in FAMILIES if k in e.name),
                       "plain torch")
            fams[fam] += e.time_range.elapsed_us() / 1e3
            launches[fam] += 1
    busy = sum(fams.values())
    return {"device_ms": dict(fams), "device_launches": dict(launches),
            "busy_ms": busy, "idle": 1 - busy / step_ms}


def run_steps(step, n, per_step, unit):
    """Median of steps 2-n: rate, and the host ms that queue a step (no
    step reads the device, so ``step()`` returns once all is queued)."""
    times, host = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = float(np.median(times[1:] or times)) * 1e3
    rec = {unit: per_step * 1e3 / step_ms, "step_s": [round(t, 4)
                                                      for t in times],
           "host_ms": float(np.median(host[1:] or host)) * 1e3,
           "peak_gib": peak}
    if n > 1:
        rec.update(breakdown(step, step_ms))
    return rec


def lm_steps(name, make, cfg, B, S, fused, n):
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor

    lg_random.seed(0)
    model = make()
    V = cfg["vocab_size"]
    ids = np.random.default_rng(12).integers(0, V, (B, S + 1)) \
        .astype(np.int32)
    x = Tensor.from_numpy(ids[:, :-1], requires_grad=False)
    y = Tensor.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False)
    kw = {}
    if name == "BERT-base":
        lengths = np.random.default_rng(0).integers(64, 129, size=B)
        mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
        kw["attention_mask"] = Tensor.from_numpy(mask, requires_grad=False)
    opt = optim.AdamW(list(model.parameters()), lr=1e-4)

    def step():
        logits = model(x, **kw)
        loss = lg_loss.cross_entropy(logits.reshape(B * S, V), y,
                                     ignore_index=-100)
        opt.zero_grad()
        loss.backward()
        opt.step()

    prev = None
    if fused:
        from lightgrad_tpu_torch.ops.attention import set_flash_fused
        prev = set_flash_fused(True)
    try:
        rec = {"model": name, **run_steps(step, n, B * S, "tok_s")}
    finally:
        if fused:
            set_flash_fused(prev)
    del model, opt
    torch.cuda.empty_cache()
    log(rec)
    return rec


def resnet_step(n):
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.models import resnet18

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
        loss = lg_loss.cross_entropy(model(x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()

    rec = {"model": "ResNet-18", **run_steps(step, n, 32, "images_s")}
    del model, opt
    torch.cuda.empty_cache()
    log(rec)
    return rec


def gpt2_steps(n, dtype):
    from lightgrad_tpu_torch import GPT, GPTConfig, amp, optim
    from lightgrad_tpu_torch.loss import cross_entropy

    dev = torch.device("cuda")
    cfg = GPTConfig(**GPT2_SMALL)
    B, T, V = 8, cfg.n_positions, cfg.vocab_size
    model = GPT(cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    if dtype == torch.float32:
        opt = optim.Adam(model.parameters(), lr=6e-4)
        zero_grad, update = opt.zero_grad, opt.step
    else:
        opt = amp.MixedPrecision(model, lambda ps: optim.AdamW(ps, lr=6e-4),
                                 dtype)
        zero_grad, update = opt.zero_grad, opt.step
    g = torch.Generator(device=dev).manual_seed(11)
    ids = torch.randint(0, V, (B, T), generator=g, device=dev)
    tgt = torch.randint(0, V, (B * T,), generator=g, device=dev)

    def step():
        loss = cross_entropy(model(ids).reshape(B * T, V), tgt)
        zero_grad()
        loss.backward()
        update()

    rec = {"model": f"GPT-2 small {str(dtype)[6:]}",
           **run_steps(step, n, B * T, "tok_s")}
    del model, opt
    torch.cuda.empty_cache()
    log(rec)
    return rec


def steps(n):
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from lightgrad_tpu_torch.models.neox import NeoX, NeoXConfig

    return [resnet_step(n),
            lm_steps("BERT-base",
                     lambda: BertForMaskedLM(BertConfig(**BERT_BASE)),
                     BERT_BASE, 8, 128, False, n),
            lm_steps("Pythia-1B", lambda: NeoX(NeoXConfig(**PYTHIA_1B)),
                     PYTHIA_1B, 2, 2048, True, n),
            gpt2_steps(n, torch.bfloat16)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--no-steps", action="store_true")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--tally", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_reduce: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.environ.setdefault("LIGHTGRAD_FAKE_DATA", "1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import lightgrad_tpu_torch
    from lightgrad_tpu_torch.ops import _build

    if os.path.dirname(os.path.dirname(os.path.abspath(
            lightgrad_tpu_torch.__file__))) != tree:
        print(f"ab_reduce: imported {lightgrad_tpu_torch.__file__}, not "
              f"from {tree}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
    rec = {"tree": args.tree, "card": smi,
           "build_s": time.perf_counter() - t0}
    if not args.no_kernels:
        rec["reduce"] = reduce_kernels()
        rec["layernorm"] = layernorm_kernels()
    if args.tally:
        rec["tally"] = tally_paths()
    if not args.no_steps:
        rec["steps"] = steps(args.steps)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
