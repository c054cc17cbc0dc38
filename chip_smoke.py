"""Smoke run of the PyTorch port's GPT-2 serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles lightgrad_tpu_torch/csrc/*.cu for sm_90a;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the serving path's shapes, in float32 and bfloat16 -- max
     abs / rel error against a stated tolerance, CUDA-event times of both;
  4. main path, GPT-2 small at its published widths (vocab 50257, 1024
     positions, d 768, 12 layers, 12 heads; seeded random weights), once in
     float32 and once after ``model.to(torch.bfloat16)``: ``generate``,
     ``generate_batch``, an ``InferenceEngine`` over 32 ragged requests, and
     a teacher-forced check of prefill + cached steps (packed whole-stack
     kernel and unrolled branch) against a plain full-sequence forward;
  5. every kernel of the path was launched by phase 4.
The line before the last is a JSON object of per-kernel results; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# References on the card run in full float32: no TF32 in matmuls or convs.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNEL_SOURCES = {
    "attention_fwd": ("lightgrad_tpu_torch/csrc/flash_fwd.cu",
                      "lightgrad_tpu/ops/attention.py:267"),
    "decode_attention": ("lightgrad_tpu_torch/csrc/decode_attention.cu",
                         "lightgrad_tpu/ops/decode_attention.py:64"),
    "decode_stack": ("lightgrad_tpu_torch/csrc/decode_stack.cu",
                     "lightgrad_tpu/ops/decode_stack.py:282"),
    "decode_stack_batch": ("lightgrad_tpu_torch/csrc/decode_stack.cu",
                           "lightgrad_tpu/ops/decode_stack.py:423"),
}
# Kernel vs plain version, max |err| <= tol * max(1, max |reference|).
# float32: the same f32 math summed in another order (FFMA chains against
# cuBLAS/ATen reductions, no TF32).  bfloat16: bf16 inputs, f32 sums, one
# rounding of the output to bf16 (2^-8 relative) on either side.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# KV-cache decoding vs a plain full-sequence forward of the same model.
# float32: other summation order through 12 layers.  bfloat16: both paths
# round every product and LayerNorm to bf16, at different points.
PATH_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
GPT2_SMALL = dict(vocab_size=50257, n_positions=1024, n_embd=768,
                  n_layer=12, n_head=12, layer_norm_epsilon=1e-5)


def log(*a):
    print(*a, flush=True)


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


def errors(got, want):
    got = got.float()
    want = want.float()
    abs_err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    return abs_err, abs_err / scale


def check(name, dtype, got, want, tol):
    abs_err, rel = errors(got, want)
    ok = bool(torch.isfinite(got.float()).all()) and rel <= tol
    log(f"  {name} {str(dtype)[6:]}: max_abs_err={abs_err:.3e} "
        f"rel={rel:.3e} tol={tol:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype}: {abs_err} (rel {rel}) > {tol}")
    return abs_err


def phase_kernels(model, results):
    """Phase 3: each kernel vs its plain version at the main path's shapes."""
    from lightgrad_tpu_torch.ops.attention import (attention_fwd_res,
                                                   attention_fwd_reference)
    from lightgrad_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    from lightgrad_tpu_torch.ops.decode_stack import (
        decode_stack, decode_stack_batch, decode_stack_batch_reference,
        decode_stack_reference, pack_gpt_stack)

    cfg = model.cfg
    L, d, H, W = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_positions
    hd, eps, dev = d // H, cfg.layer_norm_epsilon, torch.device("cuda")
    sc = hd ** -0.5
    g = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[dtype]

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        def record(name, err, ms, plain_ms):
            r = results.setdefault(name, {"max_abs_err": 0.0})
            key = "" if dtype == torch.float32 else "bf16_"
            r[key + "max_abs_err"] = max(r.get(key + "max_abs_err", 0.0), err)
            if ms is not None:
                r[key + "ms"], r[key + "plain_ms"] = ms, plain_ms
                log(f"  {name} {str(dtype)[6:]}: kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms")

        # flash forward: prefill's causal attention, (H, W, hd)
        q, k, v = rnd(H, W, hd), rnd(H, W, hd), rnd(H, W, hd)
        out, lse = attention_fwd_res(q, k, v, sc, causal=True)
        ro, rl = attention_fwd_reference(q, k, v, sc, True)
        err = check("attention_fwd out", dtype, out, ro, tol)
        check("attention_fwd lse", dtype, lse, rl, KERNEL_TOL[torch.float32])
        record("attention_fwd", err,
               cuda_ms(lambda: attention_fwd_res(q, k, v, sc, True)),
               cuda_ms(lambda: attention_fwd_reference(q, k, v, sc, True)))

        # decode attention: one token, (H, 1, hd) over W cache rows
        kc, vc = rnd(H, W, hd), rnd(H, W, hd)
        q1 = rnd(H, 1, hd)
        for pos in (0, 37, W - 1):
            got = decode_attention(q1, kc, vc, pos, sc)
            want = decode_attention_reference(q1, kc, vc, pos, sc)
            err = check(f"decode_attention pos={pos}", dtype, got, want, tol)
            record("decode_attention", err, None, None)
        record("decode_attention", 0.0,
               cuda_ms(lambda: decode_attention(q1, kc, vc, 512, sc)),
               cuda_ms(lambda: decode_attention_reference(q1, kc, vc, 512, sc)))

        # whole-stack kernel on the model's own packed weights
        p = {n: t.detach().to(dtype) for n, t in model.named_parameters()
             if n.startswith("h.")}
        packed = pack_gpt_stack(p, L, d)
        slabs, vecs = packed["stack#slabs"], packed["stack#vecs"]
        del p
        cache = rnd(L, 2, H, W, hd)
        for n in (1, 4):
            x = rnd(n, d)
            for pos in (0, 37, 1000):
                got = decode_stack(x, cache, pos, slabs, vecs, eps=eps)
                want = decode_stack_reference(x, cache, pos, slabs, vecs,
                                              eps=eps)
                err = max(check(f"decode_stack n={n} pos={pos} x", dtype,
                                got[0], want[0], tol),
                          check(f"decode_stack n={n} pos={pos} kv", dtype,
                                got[1], want[1], tol))
                record("decode_stack", err, None, None)
        x1 = rnd(1, d)
        record("decode_stack", 0.0,
               cuda_ms(lambda: decode_stack(x1, cache, 512, slabs, vecs,
                                            eps=eps)),
               cuda_ms(lambda: decode_stack_reference(x1, cache, 512, slabs,
                                                      vecs, eps=eps), 5))
        del cache
        B = 8
        caches = rnd(B, L, 2, H, W, hd)
        poss = torch.tensor([0, 5, 37, 100, 511, 1000, 1023, 17],
                            device=dev, dtype=torch.int32)
        xb = rnd(B, d)
        got = decode_stack_batch(xb, caches, poss, slabs, vecs, eps=eps)
        want = decode_stack_batch_reference(xb, caches, poss, slabs, vecs,
                                            eps=eps)
        err = max(check("decode_stack_batch B=8 x", dtype, got[0], want[0],
                        tol),
                  check("decode_stack_batch B=8 kv", dtype, got[1], want[1],
                        tol))
        record("decode_stack_batch", err,
               cuda_ms(lambda: decode_stack_batch(xb, caches, poss, slabs,
                                                  vecs, eps=eps)),
               cuda_ms(lambda: decode_stack_batch_reference(
                   xb, caches, poss, slabs, vecs, eps=eps), 5))
        del caches, slabs, vecs, packed
        torch.cuda.empty_cache()


def plain_forward(model, ids):
    """Logits of a full causal forward with plain PyTorch attention: no
    cache, no hand-written kernel -- the reference the KV path must meet."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.ops.attention import attention_fwd_reference

    cfg = model.cfg
    p = dict(model.named_parameters())
    T, d, H = ids.shape[0], cfg.n_embd, cfg.n_head
    eps = cfg.layer_norm_epsilon

    def ln(x, pre):
        return F.layer_norm(x, (d,), p[pre + ".weight"], p[pre + ".bias"], eps)

    def lin(x, pre):
        return F.linear(x, p[pre + ".weight"], p[pre + ".bias"])

    x = p["wte.weight"][ids] + p["wpe.weight"][:T]
    for l in range(cfg.n_layer):
        pre = f"h.{l}."
        qkv = lin(ln(x, pre + "ln_1"), pre + "attn.c_attn")
        q, k, v = (t.reshape(T, H, d // H).transpose(0, 1)
                   for t in qkv.split(d, -1))
        att = attention_fwd_reference(q, k, v, (d // H) ** -0.5, True)[0]
        x = x + lin(att.transpose(0, 1).reshape(T, d), pre + "attn.c_proj")
        x = x + lin(F.gelu(lin(ln(x, pre + "ln_2"), pre + "c_fc"),
                           approximate="tanh"), pre + "c_proj")
    return ln(x, "ln_f") @ p["wte.weight"].T


def teacher_forced(model, dtype, rng):
    """Prefill + 4 cached steps on both branches vs plain_forward."""
    vocab = model.cfg.vocab_size
    seq = [int(t) for t in rng.integers(0, vocab, 20)]
    P = 16
    dev = model.wte.weight.device
    with torch.no_grad():
        want = plain_forward(model, torch.tensor(seq, device=dev))
    for branch, pack in (("packed", None), ("unrolled", False)):
        fns = model._kv_functions(pack_stack=pack)
        assert ("stack#slabs" in fns.step.params) == (pack is None), branch
        toks = torch.zeros(model.cfg.n_positions, dtype=torch.long)
        toks[:P] = torch.tensor(seq[:P])
        with torch.no_grad():
            cache, lg = fns.prefill(fns.init_cache(), toks.to(dev), P)
            rows = [lg]
            for pos in range(P, len(seq)):
                cache, lg = fns.step(cache, pos, seq[pos])
                rows.append(lg)
        got = torch.stack(rows)
        assert got.shape == (len(seq) - P + 1, vocab)
        check(f"teacher-forced {branch} logits", dtype, got, want[P - 1:],
              PATH_TOL[dtype])
        del fns, cache
    torch.cuda.empty_cache()


def phase_main_path(model, dtype):
    """Phase 4 for one dtype; returns the kernels' launch counts."""
    from lightgrad_tpu_torch import InferenceEngine
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    vocab = model.cfg.vocab_size
    reset_launch_counts()
    rng = np.random.default_rng(3)
    prompt = [int(t) for t in rng.integers(0, vocab, 12)]
    model.generate(prompt, max_new_tokens=4)     # packs weights, warms cuBLAS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=32)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert len(out) == len(prompt) + 32 and all(0 <= t < vocab for t in out)
    log(f"  generate: 32 tokens in {dt:.3f} s ({32 / dt:.1f} tok/s, "
        f"prefill included)")

    prompts = [[int(t) for t in rng.integers(0, vocab, n)]
               for n in (5, 17, 9, 30)]
    t0 = time.perf_counter()
    outs = model.generate_batch(prompts, max_new_tokens=24)
    dt = time.perf_counter() - t0
    assert [len(o) for o in outs] == [len(pr) + 24 for pr in prompts]
    log(f"  generate_batch: 4 x 24 tokens in {dt:.3f} s "
        f"({96 / dt:.1f} tok/s)")

    # the serving traffic of bench.py's engine benchmark: 32 ragged greedy
    # requests, prompts 8-48 tokens, 16-128 new tokens
    rng7 = np.random.default_rng(7)
    reqs = [([int(t) for t in rng7.integers(0, vocab,
                                            int(rng7.integers(8, 49)))],
             int(rng7.integers(16, 129))) for _ in range(32)]
    engine = InferenceEngine(model, slots=8, steps_per_tick=8)
    handles = [engine.submit(p, n) for p, n in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert len(done) == 32 and all(r.done for r in handles)
    for r, (_, n) in zip(handles, reqs):
        assert r.n_generated == n, (r.id, r.n_generated, n)
        assert all(0 <= t < vocab for t in r.tokens)
    ntok = sum(n for _, n in reqs)
    log(f"  engine: 32 requests, {ntok} tokens in {dt:.3f} s "
        f"({ntok / dt:.1f} tok/s; {engine.stats})")

    # the unrolled branch is the same entry point without the packed stack
    model._kv_fns = model._kv_functions(pack_stack=False)
    out_u = model.generate(prompt, max_new_tokens=8)
    assert len(out_u) == len(prompt) + 8
    del model._kv_fns
    teacher_forced(model, dtype, rng)
    torch.cuda.synchronize()
    return launch_counts()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from lightgrad_tpu_torch import GPT, GPTConfig
    from lightgrad_tpu_torch.ops import KERNELS, _build

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"build: nvcc {_build.build_seconds():.1f} s, loaded in "
        f"{time.perf_counter() - t0:.1f} s; stack kernel grid "
        f"{lib.lg_decode_stack_grid(0)} blocks")

    dev = torch.device("cuda")
    model = GPT(GPTConfig(**GPT2_SMALL), device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))

    # 3. kernels vs plain versions
    results = {}
    log("kernels vs plain versions:")
    phase_kernels(model, results)

    # 4. main path, f32 then bf16
    launches = dict.fromkeys(KERNELS, 0)
    for dtype in (torch.float32, torch.bfloat16):
        if dtype != torch.float32:
            model.to(dtype)
        log(f"main path, GPT-2 small, {str(dtype)[6:]}:")
        counts = phase_main_path(model, dtype)
        log(f"  launches: {counts}")
        # 5. every kernel of the path ran
        missing = [k for k in KERNELS if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path "
                                 f"({dtype}): {missing}")
        for k in KERNELS:
            launches[k] += counts[k]

    kernels = []
    for name in KERNELS:
        src, replaces = KERNEL_SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **results[name]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
