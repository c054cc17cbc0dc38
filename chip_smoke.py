"""Smoke run of the PyTorch port's GPT-2 serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles lightgrad_tpu_torch/csrc/*.cu for sm_90a;
  3. kernels: each hand-written kernel (CUDA C++ or Triton) against its
     plain PyTorch version on the card, at its path's shapes, in float32 and
     bfloat16 -- max abs / rel error against a stated tolerance, CUDA-event
     times of both;
  4. serving path, GPT-2 small at its published widths (vocab 50257, 1024
     positions, d 768, 12 layers, 12 heads; seeded random weights), once in
     float32 and once after ``model.to(torch.bfloat16)``: ``generate``,
     ``generate_batch``, an ``InferenceEngine`` over 32 ragged requests, and
     a teacher-forced check of prefill + cached steps (packed whole-stack
     kernel and unrolled branch) against a plain full-sequence forward;
  5. training path, the same model on 8 x 1024 random tokens: (a) float32
     with Adam, (b) bfloat16 ``MixedPrecision`` with AdamW, 5 steps each on
     one batch -- the loss must be finite and fall, and step 1's gradients
     of every parameter must match a plain step (the ``_reference`` versions
     under torch autograd);
  6. every kernel of each path was launched by that path, and every kernel
     of the package by some path.
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

# name -> (route, source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "attention_fwd": ("cuda", "lightgrad_tpu_torch/csrc/flash_fwd.cu",
                      "lightgrad_tpu/ops/attention.py:267"),
    "decode_attention": ("cuda", "lightgrad_tpu_torch/csrc/decode_attention.cu",
                         "lightgrad_tpu/ops/decode_attention.py:64"),
    "decode_stack": ("cuda", "lightgrad_tpu_torch/csrc/decode_stack.cu",
                     "lightgrad_tpu/ops/decode_stack.py:282"),
    "decode_stack_batch": ("cuda", "lightgrad_tpu_torch/csrc/decode_stack.cu",
                           "lightgrad_tpu/ops/decode_stack.py:423"),
    "attention_bwd_dq": ("cuda", "lightgrad_tpu_torch/csrc/flash_bwd.cu",
                         "lightgrad_tpu/ops/attention.py:604"),
    "attention_bwd_dkv": ("cuda", "lightgrad_tpu_torch/csrc/flash_bwd.cu",
                          "lightgrad_tpu/ops/attention.py:636"),
    "layernorm_fwd": ("triton", "lightgrad_tpu_torch/ops/layernorm.py",
                      "lightgrad_tpu/ops/layernorm.py:54"),
    "layernorm_bwd": ("triton", "lightgrad_tpu_torch/ops/layernorm.py",
                      "lightgrad_tpu/ops/layernorm.py:85"),
}
SERVING_KERNELS = ("attention_fwd", "decode_attention", "decode_stack",
                   "decode_stack_batch")
TRAINING_KERNELS = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv",
                    "layernorm_fwd", "layernorm_bwd")
# Kernel vs plain version, max |err| <= tol * max(1, max |reference|).
# float32: the same f32 math summed in another order (FFMA chains against
# cuBLAS/ATen reductions, no TF32).  bfloat16: bf16 inputs, f32 sums, one
# rounding of the output to bf16 (2^-8 relative) on either side.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# KV-cache decoding vs a plain full-sequence forward of the same model, and
# step 1's gradients (max |err| / max |reference| per parameter) vs a plain
# step.  float32: other summation order through 12 layers.  bfloat16: both
# paths round every product and LayerNorm to bf16, at different points.
PATH_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 5, 6e-4
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


def record(results, dtype, name, err, ms=None, plain_ms=None):
    """Fold one comparison (and, when timed, both times) into ``results``:
    f32 under plain keys, bf16 under ``bf16_`` keys."""
    r = results.setdefault(name, {"max_abs_err": 0.0})
    key = "" if dtype == torch.float32 else "bf16_"
    r[key + "max_abs_err"] = max(r.get(key + "max_abs_err", 0.0), err)
    if ms is not None:
        r[key + "ms"], r[key + "plain_ms"] = ms, plain_ms
        log(f"  {name} {str(dtype)[6:]}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")


def phase_kernels(model, results):
    """Phase 3, serving kernels: each vs its plain version at the serving
    path's shapes."""
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

        # flash forward: prefill's causal attention, (H, W, hd)
        q, k, v = rnd(H, W, hd), rnd(H, W, hd), rnd(H, W, hd)
        out, lse = attention_fwd_res(q, k, v, sc, causal=True)
        ro, rl = attention_fwd_reference(q, k, v, sc, True)
        err = check("attention_fwd out", dtype, out, ro, tol)
        check("attention_fwd lse", dtype, lse, rl, KERNEL_TOL[torch.float32])
        record(results, dtype, "attention_fwd", err,
               cuda_ms(lambda: attention_fwd_res(q, k, v, sc, True)),
               cuda_ms(lambda: attention_fwd_reference(q, k, v, sc, True)))

        # decode attention: one token, (H, 1, hd) over W cache rows
        kc, vc = rnd(H, W, hd), rnd(H, W, hd)
        q1 = rnd(H, 1, hd)
        for pos in (0, 37, W - 1):
            got = decode_attention(q1, kc, vc, pos, sc)
            want = decode_attention_reference(q1, kc, vc, pos, sc)
            err = check(f"decode_attention pos={pos}", dtype, got, want, tol)
            record(results, dtype, "decode_attention", err, None, None)
        record(results, dtype, "decode_attention", 0.0,
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
                record(results, dtype, "decode_stack", err, None, None)
        x1 = rnd(1, d)
        record(results, dtype, "decode_stack", 0.0,
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
        record(results, dtype, "decode_stack_batch", err,
               cuda_ms(lambda: decode_stack_batch(xb, caches, poss, slabs,
                                                  vecs, eps=eps)),
               cuda_ms(lambda: decode_stack_batch_reference(
                   xb, caches, poss, slabs, vecs, eps=eps), 5))
        del caches, slabs, vecs, packed
        torch.cuda.empty_cache()


def plain_forward(model, ids):
    """Logits (..., T, vocab) of a full causal forward of ``ids`` (..., T)
    through the plain PyTorch versions of the kernels: no cache, no
    hand-written kernel -- the reference the KV path and, under autograd,
    the training step must meet."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.ops.attention import attention_fwd_reference
    from lightgrad_tpu_torch.ops.layernorm import layernorm_fwd_reference

    cfg = model.cfg
    p = dict(model.named_parameters())
    *lead, T = ids.shape
    d, H = cfg.n_embd, cfg.n_head
    eps = cfg.layer_norm_epsilon

    def ln(x, pre):
        return layernorm_fwd_reference(x, p[pre + ".weight"],
                                       p[pre + ".bias"], eps)[0]

    def lin(x, pre):
        return F.linear(x, p[pre + ".weight"], p[pre + ".bias"])

    x = p["wte.weight"][ids] + p["wpe.weight"][:T]
    for l in range(cfg.n_layer):
        pre = f"h.{l}."
        qkv = lin(ln(x, pre + "ln_1"), pre + "attn.c_attn")
        q, k, v = (t.reshape(*lead, T, H, d // H).transpose(-3, -2)
                   for t in qkv.split(d, -1))
        att = attention_fwd_reference(q, k, v, (d // H) ** -0.5, True)[0]
        x = x + lin(att.transpose(-3, -2).reshape(*lead, T, d),
                    pre + "attn.c_proj")
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


def phase_train_kernels(results):
    """Phase 3, training kernels: the flash backward and the LayerNorm
    kernels vs their plain versions, at the training path's shapes."""
    from lightgrad_tpu_torch.ops.attention import (
        attention_bwd, attention_bwd_dkv, attention_bwd_dq,
        attention_bwd_reference, attention_fwd_res)
    from lightgrad_tpu_torch.ops.layernorm import (
        layernorm_bwd_dx, layernorm_bwd_dx_reference, layernorm_fwd,
        layernorm_fwd_reference)

    cfg = GPT2_SMALL
    d, H, T = cfg["n_embd"], cfg["n_head"], cfg["n_positions"]
    hd, dev = d // H, torch.device("cuda")
    B = TRAIN_BATCH
    g = torch.Generator(device=dev).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[dtype]

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        # flash backward: GPT-2's training shape (B*H, T, hd) causal, then
        # a grouped-query (G = 2) and a non-causal case at a small shape
        for bh, G, S, causal in ((B * H, 1, T, True), (8, 2, 200, True),
                                 (8, 1, 200, False)):
            q, do = rnd(bh, S, hd), rnd(bh, S, hd)
            k, v = rnd(bh // G, S, hd), rnd(bh // G, S, hd)
            sc = hd ** -0.5
            out, lse = attention_fwd_res(q, k, v, sc, causal)
            got = attention_bwd(do, q, k, v, sc, causal, out=out, lse=lse)
            want = attention_bwd_reference(do, q, k, v, sc, causal)
            tag = f"attention_bwd ({bh}, {S}, {hd}) G={G} causal={causal}"
            errs = [check(f"{tag} {n}", dtype, a, w, tol)
                    for n, a, w in zip(("dq", "dk", "dv"), got, want)]
            record(results, dtype, "attention_bwd_dq", errs[0])
            record(results, dtype, "attention_bwd_dkv", max(errs[1:]))
            if S != T:
                continue
            dcap = (do.float() * out.float()).sum(-1).contiguous()
            plain_ms = cuda_ms(lambda: attention_bwd_reference(
                do, q, k, v, sc, causal), 5)
            record(results, dtype, "attention_bwd_dq", 0.0,
                   cuda_ms(lambda: attention_bwd_dq(do, q, k, v, lse, dcap,
                                                    sc, causal)), plain_ms)
            record(results, dtype, "attention_bwd_dkv", 0.0,
                   cuda_ms(lambda: attention_bwd_dkv(do, q, k, v, lse, dcap,
                                                     sc, causal)), plain_ms)
            whole = cuda_ms(lambda: attention_bwd(do, q, k, v, sc, causal,
                                                  out=out, lse=lse))
            log(f"  attention_bwd {str(dtype)[6:]}: rowsum + both kernels "
                f"{whole:.4f} ms, plain {plain_ms:.4f} ms (the plain time "
                f"stands beside each pass)")
            del q, do, k, v, out, lse, got, want, dcap
            torch.cuda.empty_cache()

        # LayerNorm at the training path's rows: (B*T, d)
        x = rnd(B * T, d) * 2.0 + 0.5
        w, b = rnd(d), rnd(d)
        y, xhat, rstd = layernorm_fwd(x, w, b, 1e-5)
        ry, rxhat, rrstd = layernorm_fwd_reference(x, w, b, 1e-5)
        err = max(check("layernorm_fwd y", dtype, y, ry, tol),
                  check("layernorm_fwd xhat", dtype, xhat, rxhat,
                        KERNEL_TOL[torch.float32]),
                  check("layernorm_fwd rstd", dtype, rstd, rrstd,
                        KERNEL_TOL[torch.float32]))
        record(results, dtype, "layernorm_fwd", err,
               cuda_ms(lambda: layernorm_fwd(x, w, b, 1e-5)),
               cuda_ms(lambda: layernorm_fwd_reference(x, w, b, 1e-5)))
        gy = rnd(B * T, d)
        dx = layernorm_bwd_dx(gy, w, xhat, rstd)
        err = check("layernorm_bwd dx", dtype, dx,
                    layernorm_bwd_dx_reference(gy, w, xhat, rstd), tol)
        record(results, dtype, "layernorm_bwd", err,
               cuda_ms(lambda: layernorm_bwd_dx(gy, w, xhat, rstd)),
               cuda_ms(lambda: layernorm_bwd_dx_reference(gy, w, xhat, rstd)))
        del x, y, xhat, rstd, gy, dx
        torch.cuda.empty_cache()


def phase_train(dtype, card):
    """Phase 5 for one configuration: (a) float32 + Adam, (b) bfloat16
    MixedPrecision + AdamW; 5 steps on one batch of random tokens.  Returns
    the kernels' launch counts of the 5 steps."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch import GPT, GPTConfig, amp, optim
    from lightgrad_tpu_torch.loss import cross_entropy
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    cfg = GPTConfig(**GPT2_SMALL)
    B, T, V = TRAIN_BATCH, cfg.n_positions, cfg.vocab_size
    model = GPT(cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    if dtype == torch.float32:
        opt = optim.Adam(model.parameters(), lr=TRAIN_LR)
        zero_grad, update = opt.zero_grad, opt.step
    else:
        mp = amp.MixedPrecision(
            model, lambda ps: optim.AdamW(ps, lr=TRAIN_LR), dtype)
        zero_grad, update = mp.zero_grad, mp.step
    params = dict(model.named_parameters())
    g = torch.Generator(device=dev).manual_seed(11)
    ids = torch.randint(0, V, (B, T), generator=g, device=dev)
    tgt = torch.randint(0, V, (B * T,), generator=g, device=dev)

    # the plain step on the same weights: reference ops, torch autograd
    plain_loss = F.cross_entropy(plain_forward(model, ids).float()
                                 .reshape(B * T, V), tgt)
    plain_grads = torch.autograd.grad(plain_loss, list(params.values()))
    plain_grads = dict(zip(params, plain_grads))
    del plain_loss
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model(ids)
        loss = cross_entropy(logits.reshape(B * T, V), tgt)
        zero_grad()
        loss.backward()
        if step == 0:               # the check's time is not the step's
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            grad_check(params, plain_grads, dtype)
            del plain_grads
            t0 += time.perf_counter() - c0
        update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        del logits, loss
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    tok_s = B * T / float(np.median(times[1:]))
    log(f"  losses: {[round(x, 4) for x in losses]} "
        f"({'finite, falling' if ok else 'FAIL'})")
    log(f"  {B}x{T} tokens a step: {tok_s:.1f} tok/s (median of steps "
        f"2-{TRAIN_STEPS}, step times {[round(t, 4) for t in times]} s); "
        f"peak memory {peak / 2**30:.2f} GiB; {card}")
    if not ok:
        raise AssertionError(f"training loss not finite and falling: "
                             f"{losses}")
    return counts


def grad_check(params, plain_grads, dtype):
    """Step 1's kernel-path gradient of every parameter vs the plain step:
    max |err| / max |reference| within PATH_TOL."""
    worst, worst_name = 0.0, None
    for name, p in params.items():
        want = plain_grads[name].float()
        got = p.grad.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"gradient of {name} is not finite")
        rel = (got - want).abs().max().item() / max(
            want.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    ok = worst <= PATH_TOL[dtype]
    log(f"  step-1 gradients of {len(params)} parameters vs the plain step: "
        f"worst rel {worst:.3e} ({worst_name}) tol {PATH_TOL[dtype]:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"gradient of {worst_name}: rel {worst}")


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
    phase_train_kernels(results)

    # 4.-6. each path, with the kernels it launched
    launches = dict.fromkeys(KERNELS, 0)

    def tally(path, counts, path_kernels):
        log(f"  launches: {counts}")
        missing = [k for k in path_kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {missing}")
        for k in KERNELS:
            launches[k] += counts[k]

    for dtype in (torch.float32, torch.bfloat16):
        if dtype != torch.float32:
            model.to(dtype)
        log(f"serving path, GPT-2 small, {str(dtype)[6:]}:")
        tally(f"serving ({dtype})", phase_main_path(model, dtype),
              SERVING_KERNELS)
    del model
    torch.cuda.empty_cache()
    for dtype, what in ((torch.float32, "float32, Adam"),
                        (torch.bfloat16, "bfloat16 MixedPrecision, AdamW")):
        log(f"training path, GPT-2 small, {what}:")
        tally(f"training ({what})", phase_train(dtype, card),
              TRAINING_KERNELS)
        torch.cuda.empty_cache()
    missing = [k for k in KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels no path launched: {missing}")

    kernels = []
    for name in KERNELS:
        route, src, replaces = KERNEL_SOURCES[name]
        kernels.append({"name": name, "route": route, "source": src,
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
