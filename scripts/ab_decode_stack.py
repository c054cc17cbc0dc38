"""Time the whole-stack decode kernel, and the GPT-2 serving paths that run
it, of one checkout of the port, so that two checkouts can be compared on
one card.

    python3 scripts/ab_decode_stack.py --tree DIR [--no-kernels]
        [--engine N] [--barriers] [--stamps] [--iters N]

imports ``lightgrad_tpu_torch`` from DIR (a checkout of any commit since the
int8 stack variants were ported), builds its kernels there, and prints one
JSON line:

- the card's name and power limit (``nvidia-smi``);
- unless ``--no-kernels``, ``decode_stack`` / ``decode_stack_batch`` in all
  four variants ("", ``_int8``, ``_kvq``, ``_int8_kvq``), float32 and
  bfloat16, on GPT-2 small's widths (d 768, L 12, H 12, W 1024; random
  weights from a seed, packed by ``pack_gpt_stack``, int8 slabs by
  ``quantize_serving``) at the shapes of ``SHAPES``: by CUDA graph (device
  time of ``--iters`` replayed calls; "eager" where stream capture refuses
  the launch), each with its bound (the slabs, vecs, rows in and out and the
  visible cache rows read once, at 3.35 TB/s), its bound share, its largest
  error against the plain version (over max(1, |ref|)) and whether two calls
  agree bit for bit;
- with ``--engine N``, GPT-2 small's ``InferenceEngine`` over chip_smoke's 32
  ragged requests (``slots=8``, ``steps_per_tick=8``) N times in float32 and
  bfloat16 (tok/s of each run), the bfloat16 single-stream decode ms a
  token after a 960-token prompt (N runs of 48 tokens less a 1-token run),
  and a ``torch.profiler`` window of one engine tick and of one
  single-stream step: the stack kernel's device ms and launches, all device
  ms, the wall ms and the device's idle share;
- with ``--barriers``, the cost of 97 grid-wide barriers in a kernel of
  empty phases, ``cooperative_groups`` ``grid.sync()`` against an
  arrive / spin barrier (``red.release.gpu`` / ``ld.acquire.gpu``), at the
  grids of 2 and 1 blocks an SM (256 and 512 threads);
- with ``--stamps``, one call's split into the phases between its grid
  barriers, from ``%globaltimer`` stamps written by block 0: the tree's
  ``csrc/decode_stack.cu`` is built alone with a stamp after every barrier
  (its ``LG_STACK_STAMP()`` hooks where it has them, else after every
  ``grid.sync();``) and swapped in through ``_build._lib``, and timed at
  shapes (a) at 512 and (c); each ``--variant NAME[+NAME...]`` adds such a
  build of the source with the edits of ``PATCHES`` (experiments: some
  give wrong results, and a tree whose source lacks an edit's text fails).

Run it for two checkouts in the order P, C, C, P within one machine to
compare them; each run is its own process.
"""

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BPS = 3.35e12
GPT2_SMALL = dict(vocab_size=50257, n_positions=1024, n_embd=768,
                  n_layer=12, n_head=12, layer_norm_epsilon=1e-5)
# (label, batched, n, positions); main() adds shape (d), the middle tick of
# the engine's own traffic (chip_smoke.engine_tick_positions)
SHAPES = [("a: n 1, pos 512", False, 1, [512]),
          ("a: n 1, pos 960", False, 1, [960]),
          ("b: n 4, pos 37", False, 4, [37]),
          ("c: B 8, smoke poss", True, 8, [0, 5, 37, 100, 511, 1000, 1023,
                                           17])]
VARIANTS = ("", "_int8", "_kvq", "_int8_kvq")
# --variant edits of csrc/decode_stack.cu: (text, replacement) pairs
PATCHES = {
    # no weight copies (the boxes' cp.async, fc2's bulk rows) or no cache
    # copies: wrong results, the chain of phases alone
    "no_weights": [("  if (t >= kThreads / nv * nv) return;\n",
                    "  return;\n"),
                   ("    for (int r = t; r < rows; r += kThreads)\n"
                    "      bulk_copy(dst + r * rb, src + (size_t)r * d, rb, "
                    "bar, pol);\n    tx = rows * rb;\n", "")],
    "no_cache": [("      const int rows = c.rows;\n",
                  "      const int rows = 0;\n")],
    # block 0's stamps inside the phases too (LG_STACK_SUB() hooks)
    "substamps": [("#ifdef LG_STACK_SUBSTAMPS", "#if 1")],
    # the stream under L2's normal policy, not evict-first
    "no_hint": [("L2::evict_first", "L2::evict_normal")],
    # 16 KB ring slots at every width
    "slot16": [("  s.slot = ring >= 4 * kSlotBig ? kSlotBig : kSlotSmall;\n",
                "  s.slot = kSlotSmall;\n")],
    # one slot of the ring left empty (the design's first version)
    "ring_less1": [("min(rg.cur + p.slots, pl.per_layer * p.L)",
                    "min(rg.cur + p.slots - 1, pl.per_layer * p.L)"),
                   ("issue_upto<TW, TC>(p, pl, rg, p.slots);",
                    "issue_upto<TW, TC>(p, pl, rg, p.slots - 1);")],
    # the next layer's first stages issued before the block arrives at the
    # barrier after phase 5, not while it waits there
    "pace5_before": [("      barrier_arrive(count);\n      pace(pl.per_layer);\n"
                      "      barrier_wait(count, target += G);\n",
                      "      pace(pl.per_layer);\n"
                      "      grid_barrier(count, target += G);\n")],
}


def log(rec):
    print(json.dumps(rec), file=sys.stderr, flush=True)


def graph_ms(fn, iters):
    """Device ms of one call: ``iters`` calls captured in a CUDA graph and
    replayed between two CUDA events; (ms, "graph"), or 20 eager calls
    (ms, "eager") where capture refuses the launch."""
    fn()
    torch.cuda.synchronize()
    try:
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
    except Exception as e:  # capture refused: say so, time eager calls
        log({"capture_refused": repr(e)[:300]})
        torch.cuda.synchronize()
        return eager_ms(fn), "eager"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms, "graph"


def eager_ms(fn, iters=20):
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


def stack_cost(n, L, d, H, lens, dtype, w_int8, kv_int8, R=4):
    """Bytes of one whole-stack call, as chip_smoke.py's ``stack_cost``."""
    isz = torch.tensor([], dtype=dtype).element_size()
    S, hd = 4 + 2 * R, d // H
    return (L * S * d * d * (1 if w_int8 else isz)
            + (L * S * d * 4 if w_int8 else 0) + L * (9 + R) * d * isz
            + 2 * n * d * isz + L * 2 * n * d * isz
            + sum(lens) * L * 2 * H * (hd * (1 if kv_int8 else isz)
                                       + (4 if kv_int8 else 0)))


def rel_err(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1.0))


def gpt2(dtype=torch.float32):
    from lightgrad_tpu_torch import GPT, GPTConfig

    dev = torch.device("cuda")
    model = GPT(GPTConfig(**GPT2_SMALL), device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    return model.to(dtype) if dtype != torch.float32 else model


def stack_kernels(iters):
    ds = importlib.import_module("lightgrad_tpu_torch.ops.decode_stack")
    from lightgrad_tpu_torch.models.gpt import quantize_rows

    model = gpt2()
    cfg = model.cfg
    L, d, H, W = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_positions
    hd, eps, dev = d // H, cfg.layer_norm_epsilon, torch.device("cuda")
    qp = model.quantize_serving()._kv_functions().step.params
    model.quantize_serving(False)
    slabs8, scales8 = qp["stack#slabs"], qp["stack#scales"]
    del qp
    g = torch.Generator(device=dev).manual_seed(1)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        p = {k: t.detach().to(dtype) for k, t in model.named_parameters()
             if k.startswith("h.")}
        packed = ds.pack_gpt_stack(p, L, d)
        slabs, vecs = packed["stack#slabs"], packed["stack#vecs"]
        del p, packed
        caches = torch.randn((8, L, 2, H, W, hd), generator=g,
                             device=dev).to(dtype)
        caches8, kvs8 = quantize_rows(caches)
        for label, batched, n, poss in SHAPES:
            x = torch.randn((n, d), generator=g, device=dev).to(dtype)
            for sfx in VARIANTS:
                w8, k8 = "_int8" in sfx, "_kvq" in sfx
                sl, scl = (slabs8, scales8) if w8 else (slabs, None)
                if batched:
                    c, kvs = (caches8, kvs8) if k8 else (caches, None)
                    pt = torch.tensor(poss, device=dev, dtype=torch.int32)

                    def run(c=c, kvs=kvs, pt=pt, sl=sl, scl=scl):
                        return ds.decode_stack_batch(x, c, pt, sl, vecs, scl,
                                                     eps=eps, kv_scales=kvs)

                    def plain(c=c, kvs=kvs, pt=pt, sl=sl, scl=scl):
                        return ds.decode_stack_batch_reference(
                            x, c, pt, sl, vecs, scl, eps=eps, kv_scales=kvs)
                    lens = [min(q, W) for q in poss]
                else:
                    c, kvs = (caches8[0], kvs8[0]) if k8 \
                        else (caches[0], None)
                    pos = poss[0]

                    def run(c=c, kvs=kvs, pos=pos, sl=sl, scl=scl):
                        return ds.decode_stack(x, c, pos, sl, vecs, scl,
                                               eps=eps, kv_scales=kvs)

                    def plain(c=c, kvs=kvs, pos=pos, sl=sl, scl=scl):
                        return ds.decode_stack_reference(
                            x, c, pos, sl, vecs, scl, eps=eps, kv_scales=kvs)
                    lens = [min(pos, W)]
                a, b = run(), run()
                want = plain()
                err = max(rel_err(a[0], want[0]), rel_err(a[1], want[1]))
                same = bool(torch.equal(a[0], b[0]) and torch.equal(a[1],
                                                                    b[1]))
                ms, how = graph_ms(run, iters)
                bound = stack_cost(n, L, d, H, lens, dtype, w8, k8) \
                    / HBM_BPS * 1e3
                rec = {"shape": label, "dtype": str(dtype)[6:],
                       "variant": "decode_stack" + ("_batch" if batched
                                                    else "") + sfx,
                       "ms": ms, "timing": how, "bound_ms": bound,
                       "bound_share": bound / ms, "rel_err": err,
                       "repeats_bitwise": same}
                log(rec)
                out.append(rec)
        del caches, caches8, kvs8, slabs, vecs
        torch.cuda.empty_cache()
    return out


def _profile(fn):
    """(stack kernel device ms, its launches, all device ms, wall ms) of one
    call of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    stack = dev = 0.0
    launches = 0
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        us = e.device_time_total if hasattr(e, "device_time_total") \
            else e.cuda_time_total
        dev += us / 1e3
        if "decode_stack_kernel" in e.name:
            stack += us / 1e3
            launches += 1
    return {"stack_ms": stack, "stack_launches": launches, "device_ms": dev,
            "wall_ms": wall, "idle": max(0.0, 1 - dev / wall)}


def engine(n_runs):
    from chip_smoke import serving_requests
    from lightgrad_tpu_torch import InferenceEngine

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = gpt2(dtype)
        vocab = model.cfg.vocab_size
        reqs = serving_requests(vocab)
        model.generate(reqs[0][0], max_new_tokens=4)
        rates = []
        for _ in range(n_runs):
            eng = InferenceEngine(model, slots=8, steps_per_tick=8)
            for p, n in reqs:
                eng.submit(p, n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = eng.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert len(done) == 32
            rates.append(sum(n for _, n in reqs) / dt)
        # one tick's decode (steps_per_tick step_batch calls over 8 busy
        # slots at the engine's positions) and one single-stream step
        fns = model._kv_functions()
        caches = torch.stack([fns.init_cache() for _ in range(8)])
        poss = torch.tensor(SHAPES[-1][3], device="cuda", dtype=torch.int32)
        toks = torch.randint(0, vocab, (8,), device="cuda")

        def tick():
            for _ in range(8):
                fns.step_batch(caches, poss, toks)
        tick()
        rec = {"engine_tok_s": rates, "engine_tick": _profile(tick)}
        del caches
        cache = fns.init_cache()
        fns.step(cache, 960, 7)
        rec["single_step_960"] = _profile(lambda: fns.step(cache, 960, 7))
        if dtype == torch.bfloat16:
            rng = np.random.default_rng(5)
            prompt = [int(t) for t in rng.integers(0, vocab, 960)]
            model.generate(prompt[:8], max_new_tokens=2)
            per_tok = []
            for _ in range(n_runs):
                times = []
                for k in (1, 48):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model.generate(prompt, max_new_tokens=k)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                per_tok.append((times[1] - times[0]) / 47 * 1e3)
            rec["single_ms_per_token_after_960"] = per_tok
        out[str(dtype)[6:]] = rec
        log({"engine": str(dtype)[6:], **rec})
        del model, fns, cache
        torch.cuda.empty_cache()
    return out


BARRIER_CU = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__global__ void cg_barriers(int k, float* sink) {
  cg::grid_group g = cg::this_grid();
  float a = threadIdx.x;
  for (int i = 0; i < k; ++i) { a = a * 1.0001f + 1.f; g.sync(); }
  if (a == 12345.f) sink[0] = a;
}

// count reaches G * (i + 1) at barrier i: a monotonic word, zeroed per call
__global__ void spin_barriers(int k, unsigned* count, float* sink) {
  float a = threadIdx.x;
  for (int i = 0; i < k; ++i) {
    a = a * 1.0001f + 1.f;
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned target = gridDim.x * (unsigned)(i + 1);
      red_release(count, 1u);
      while (ld_acquire(count) < target) {}
    }
    __syncthreads();
  }
  if (a == 12345.f) sink[0] = a;
}

extern "C" int lg_sm_count() {
  int s = 0;
  cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, 0);
  return s;
}

extern "C" int lg_barriers(int kind, int blocks, int threads, int k,
                           void* count, void* sink, void* stream) {
  void* args_cg[] = {&k, &sink};
  void* args_spin[] = {&k, &count, &sink};
  cudaError_t e = kind == 0
      ? cudaLaunchCooperativeKernel((const void*)cg_barriers, dim3(blocks),
                                    dim3(threads), args_cg, 0,
                                    (cudaStream_t)stream)
      : cudaLaunchCooperativeKernel((const void*)spin_barriers, dim3(blocks),
                                    dim3(threads), args_spin, 0,
                                    (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
"""

STAMP_PRELUDE = r"""
#define LG_STACK_STAMPS 1
__device__ unsigned long long lg_stamp_buf[2][1024];
__device__ int lg_stamp_i;
__device__ __forceinline__ void lg_stamp(int& i) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && i < 1024) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    lg_stamp_buf[0][i] = t;
    lg_stamp_buf[1][i] = clock64();
    lg_stamp_i = i + 1;
  }
  ++i;
}
"""
STAMP_EPILOGUE = r"""
extern "C" int lg_stack_stamps(unsigned long long* out, int* n) {
  cudaError_t e =
      cudaMemcpyFromSymbol(out, lg_stamp_buf, sizeof(lg_stamp_buf));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(n, lg_stamp_i, sizeof(int));
}
"""


def _nvcc(src, so, tree, defines=()):
    from lightgrad_tpu_torch.ops import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I",
           os.path.join(tree, "lightgrad_tpu_torch", "csrc"), "-shared",
           "-o", so, src]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr[-6000:])
    return time.perf_counter() - t0


def barriers(tree):
    """ms of 97 barriers (a kernel of 97 empty phases less one of 1)."""
    work = os.path.join(tree, "lightgrad_tpu_torch", "build", "ab_barriers")
    os.makedirs(work, exist_ok=True)
    src, so = os.path.join(work, "b.cu"), os.path.join(work, "b.so")
    with open(src, "w") as f:
        f.write(BARRIER_CU)
    _nvcc(src, so, tree)
    lib = ctypes.CDLL(so)
    lib.lg_barriers.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    sms = lib.lg_sm_count()
    sink = torch.zeros(1, device="cuda")
    out = []
    for blocks, threads in ((2 * sms, 256), (sms, 256), (sms, 512)):
        for kind, name in ((0, "grid.sync"), (1, "arrive/spin")):
            def launch(k):
                count = torch.zeros(1, device="cuda", dtype=torch.int32)
                err = lib.lg_barriers(
                    kind, blocks, threads, k, count.data_ptr(),
                    sink.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            t97 = eager_ms(lambda: launch(97), 50)
            t1 = eager_ms(lambda: launch(1), 50)
            rec = {"barrier": name, "blocks": blocks, "threads": threads,
                   "ms_97": t97, "ms_1": t1,
                   "us_per_barrier": (t97 - t1) / 96 * 1e3}
            log(rec)
            out.append(rec)
    return out


def _stamped_builds(tree, variants):
    """Build the tree's decode_stack.cu alone, with phase stamps, as it is
    ("") and with each ``variants`` label's ``PATCHES``, all nvcc processes
    at once; returns {label: (library path, build seconds)}."""
    from lightgrad_tpu_torch.ops import _build

    csrc = os.path.join(tree, "lightgrad_tpu_torch", "csrc")
    with open(os.path.join(csrc, "decode_stack.cu")) as f:
        text = f.read()
    if "LG_STACK_STAMP(" not in text:   # a tree without hooks: patch them in
        text = text.replace("cg::grid_group grid = cg::this_grid();",
                            "cg::grid_group grid = cg::this_grid();\n"
                            "  int lg_si = 0; lg_stamp(lg_si);")
        text = text.replace("grid.sync();", "grid.sync(); lg_stamp(lg_si);")
    work = os.path.join(tree, "lightgrad_tpu_torch", "build", "ab_stamps")
    os.makedirs(work, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for label in [""] + variants:
        src_v = text
        for name in label.split("+") if label else ():
            for old, new in PATCHES[name]:
                if old not in src_v:
                    raise ValueError(f"--variant {name}: {old!r} is not in "
                                     f"{csrc}/decode_stack.cu")
                src_v = src_v.replace(old, new)
        src = os.path.join(work, f"decode_stack_{label or 'tree'}.cu")
        with open(src, "w") as f:
            f.write('#include "common.cuh"\n' + STAMP_PRELUDE + src_v
                    + STAMP_EPILOGUE)
        so = os.path.join(work, f"stamped_{label or 'tree'}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-shared",
               "-o", so, src]
        procs[label] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE,
                                             text=True))
    out = {}
    for label, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{label}: {err[-6000:]}")
        out[label] = (so, time.perf_counter() - t0)
    return out


def stamps(tree, variants, iters):
    """Block 0's phase split of one call of each shape (f32 and bf16, float
    variant), from stamped builds of the tree's decode_stack.cu: the tree as
    it is ("") at every shape, and each ``variants`` build (``PATCHES``) at
    shapes (a) at 512 and (c); every build's graph time at those two."""
    ds = importlib.import_module("lightgrad_tpu_torch.ops.decode_stack")
    from lightgrad_tpu_torch.ops import _build

    builds = _stamped_builds(tree, variants)
    model = gpt2()
    cfg = model.cfg
    L, d, H, W = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_positions
    dev = torch.device("cuda")
    out = {"build_s": {k: v[1] for k, v in builds.items()}}
    buf = (ctypes.c_ulonglong * 2048)()
    cnt = ctypes.c_int()
    saved = _build._lib
    packed = {}
    g = torch.Generator(device=dev).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        p = {k: t.detach().to(dtype) for k, t in model.named_parameters()
             if k.startswith("h.")}
        packed[dtype] = (ds.pack_gpt_stack(p, L, d),
                         torch.randn((8, L, 2, H, W, d // H), generator=g,
                                     device=dev).to(dtype))
    try:
        for label, (so, _) in builds.items():
            lib = ctypes.CDLL(so)
            for name, (args, res) in _build._SIGNATURES.items():
                if name.startswith("lg_decode_stack") and hasattr(lib, name):
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = args, res
            _build._lib = lib
            for dtype in (torch.float32, torch.bfloat16):
                pk, caches = packed[dtype]
                for shape, batched, n, poss in SHAPES:
                    timed = shape in (SHAPES[0][0], SHAPES[3][0])
                    if label and not timed:
                        continue
                    x = torch.randn((n, d), generator=g, device=dev).to(dtype)
                    pt = torch.tensor(poss, device=dev, dtype=torch.int32)

                    def run():
                        if batched:
                            return ds.decode_stack_batch(
                                x, caches, pt, pk["stack#slabs"],
                                pk["stack#vecs"], eps=1e-5)
                        return ds.decode_stack(x, caches[0], poss[0],
                                               pk["stack#slabs"],
                                               pk["stack#vecs"], eps=1e-5)
                    splits = []
                    for _ in range(5):
                        run()
                        torch.cuda.synchronize()
                        assert lib.lg_stack_stamps(buf, ctypes.byref(cnt)) == 0
                        ns = np.array(buf[:cnt.value], dtype=np.float64)
                        splits.append(np.diff(ns) / 1e3)  # µs between stamps
                    sp = np.median(np.stack(splits), axis=0)
                    # the per-layer phases, after a prologue where there is
                    # one
                    pro = len(sp) % L
                    rec = {"build": label, "shape": shape,
                           "dtype": str(dtype)[6:], "stamps": int(cnt.value),
                           "total_us": float(sp.sum()),
                           "prologue_us": float(sp[:pro].sum()),
                           "phase_us_mean_over_layers":
                               sp[pro:].reshape(L, -1).mean(axis=0).tolist()}
                    if timed:
                        rec["ms"], rec["timing"] = graph_ms(run, iters)
                    log(rec)
                    out[f"{label} {shape} {str(dtype)[6:]}"] = rec
    finally:
        _build._lib = saved
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--engine", type=int, default=0)
    ap.add_argument("--barriers", action="store_true")
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME[+NAME]",
                    help="with --stamps: also a build of decode_stack.cu "
                         f"with these edits, of {sorted(PATCHES)}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_decode_stack: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import lightgrad_tpu_torch
    from lightgrad_tpu_torch.ops import _build

    if os.path.dirname(os.path.dirname(os.path.abspath(
            lightgrad_tpu_torch.__file__))) != tree:
        print(f"ab_decode_stack: imported {lightgrad_tpu_torch.__file__}, "
              f"not from {tree}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    lib = _build.library()
    rec = {"tree": args.tree, "card": smi,
           "build_s": time.perf_counter() - t0,
           "grids": {f"{t}{'/w8' * w}{'/kv8' * k}": lib.lg_decode_stack_grid(
               t == "bf16", w, k) for t in ("f32", "bf16") for w in (0, 1)
               for k in (0, 1)}}
    log({"card": smi, "grids": rec["grids"]})
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from chip_smoke import engine_tick_positions
    ticks = engine_tick_positions(GPT2_SMALL["vocab_size"])
    SHAPES.append(("d: B 8, engine tick", True, 8, ticks[len(ticks) // 2]))
    rec["engine_tick_positions"] = SHAPES[-1][3]
    if args.barriers:
        rec["barriers"] = barriers(tree)
    if args.stamps:
        rec["stamps"] = stamps(tree, args.variant, args.iters)
    if not args.no_kernels:
        rec["kernels"] = stack_kernels(args.iters)
    if args.engine:
        rec["engine"] = engine(args.engine)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
