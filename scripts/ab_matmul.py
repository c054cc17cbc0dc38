"""Time the tape's matmul kernel and the tape's training steps of one
checkout of the port, so that two checkouts can be compared on one card.

    python3 scripts/ab_matmul.py --tree DIR [--steps N] [--no-steps]

imports ``lightgrad_tpu_torch`` from DIR (a checkout of any commit since the
tape was ported), builds its kernels there, and prints one JSON line:

- the card's name and power limit (``nvidia-smi``);
- ``ops.matmul.matmul`` by CUDA graph (device time of 10 replayed calls) at
  four shapes, in float32 and bfloat16, beside one cuBLAS call
  (``torch.matmul``, TF32 off) and the least time the card could take (the
  larger of the bytes at 3.35 TB/s and the operations at 989 TFLOP/s in
  bf16, or three tf32 passes at 495 TFLOP/s in f32): BERT-base's decoder
  (1024 x 768 @ (30522 x 768)^T, PERF.md row 3), Mistral-7B's f32 MLP
  up-projection (8192 x 4096 @ (14336 x 4096)^T), its weight gradient with
  the batch folded into K ((8192 x 4096)^T @ 8192 x 14336, A read along
  m), and Pythia-1B's QKV (4096 x 2048 @ (6144 x 2048)^T); each with the
  largest error against a float64 product over the largest |float64|
  element (f32: also cuBLAS's with TF32 off and on);
- unless ``--no-steps``, the tape's training steps in float32, AdamW, on
  random tokens or images, tok/s (images/s) as the median of steps 2-N:
  Mistral-7B (2 layers, 1 x 8192), Gemma-2B (2 layers, 2 x 1024),
  Pythia-1B (16 layers, 2 x 2048, fused flash backward), Pythia-2.8B (2
  layers, 1 x 2048, fused), BERT-base (masked LM, 8 x 128, padding mask)
  and ResNet-18 (32 x 3 x 224 x 224).

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
# (name, M, N, K, A read along m (a^T), B given as (N, K) (W^T))
SHAPES = (("row 3: BERT decoder 1024x768 @ (30522x768)^T",
           1024, 30522, 768, False, True),
          ("Mistral-7B MLP up 8192x4096 @ (14336x4096)^T",
           8192, 14336, 4096, False, True),
          ("Mistral-7B MLP up, weight gradient (8192x4096)^T @ 8192x14336",
           4096, 14336, 8192, True, False),
          ("Pythia-1B QKV 4096x2048 @ (6144x2048)^T",
           4096, 6144, 2048, False, True))
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
PYTHIA_1B = dict(vocab_size=50304, hidden_size=2048, intermediate_size=8192,
                 num_hidden_layers=16, num_attention_heads=8,
                 max_position_embeddings=2048, rotary_pct=0.25,
                 rotary_emb_base=10000.0, layer_norm_eps=1e-5,
                 use_parallel_residual=True)
PYTHIA_2P8B = dict(PYTHIA_1B, hidden_size=2560, intermediate_size=10240,
                   num_hidden_layers=2, num_attention_heads=32)
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12)


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
                 / want64.abs().max().clamp_min(1.0))


def kernels():
    from lightgrad_tpu_torch.ops.matmul import matmul

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for name, M, N, K, a_t, b_t in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((K, M) if a_t else (M, K), generator=g,
                            device=dev).to(dtype)
            b = (torch.randn((N, K) if b_t else (K, N), generator=g,
                             device=dev) * K ** -0.5).to(dtype)
            a = a.T if a_t else a
            b = b.T if b_t else b
            isz = a.element_size()
            ops = 2 * M * N * K
            bound = max((M * K + K * N + M * N) * isz / HBM_BPS,
                        ops / BF16_OPS if dtype == torch.bfloat16
                        else 3 * ops / TF32_OPS) * 1e3
            rec = {"shape": name, "dtype": str(dtype)[6:],
                   "ms": graph_ms(lambda: matmul(a, b)),
                   "cublas_ms": graph_ms(lambda: torch.matmul(a, b)),
                   "bound_ms": bound}
            want = torch.matmul(a.double(), b.double())
            rec["err"] = rel_err(matmul(a, b), want)
            if dtype == torch.float32:
                rec["cublas_err"] = rel_err(torch.matmul(a, b), want)
                torch.backends.cuda.matmul.allow_tf32 = True
                rec["cublas_tf32_err"] = rel_err(torch.matmul(a, b), want)
                rec["cublas_tf32_ms"] = graph_ms(lambda: torch.matmul(a, b))
                torch.backends.cuda.matmul.allow_tf32 = False
            del want, a, b
            torch.cuda.empty_cache()
            print(json.dumps(rec), file=sys.stderr, flush=True)
            out.append(rec)
    return out


def timed_steps(step, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times[1:])), times


def lm_steps(name, model, B, S, V, n, lr=3e-4, fused=False, mask=None):
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch.autograd import Tensor

    ids = np.random.default_rng(12).integers(0, V, (B, S + 1)) \
        .astype(np.int32)
    x = Tensor.from_numpy(ids[:, :-1], requires_grad=False)
    y = Tensor.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False)
    kw = {} if mask is None else {"attention_mask": mask}
    opt = optim.AdamW(list(model.parameters()), lr=lr)

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
        med, times = timed_steps(step, n)
    finally:
        if fused:
            set_flash_fused(prev)
    rec = {"model": name, "tok_s": B * S / med,
           "step_s": [round(t, 4) for t in times]}
    print(json.dumps(rec), file=sys.stderr, flush=True)
    return rec


def steps(n):
    from lightgrad_tpu_torch import random as lg_random

    out = []
    from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
    for name, cfg, B, S in (("Mistral-7B (2 layers)", MISTRAL_7B, 1, 8192),
                            ("Gemma-2B (2 layers)", GEMMA_2B, 2, 1024)):
        lg_random.seed(0)
        model = Llama(LlamaConfig(**cfg))
        out.append(lm_steps(name, model, B, S, cfg["vocab_size"], n))
        del model
        torch.cuda.empty_cache()
    from lightgrad_tpu_torch.models.neox import NeoX, NeoXConfig
    for name, cfg, B, S in (("Pythia-1B", PYTHIA_1B, 2, 2048),
                            ("Pythia-2.8B (2 layers)", PYTHIA_2P8B, 1, 2048)):
        lg_random.seed(0)
        model = NeoX(NeoXConfig(**cfg))
        out.append(lm_steps(name, model, B, S, cfg["vocab_size"], n,
                            fused=True))
        del model
        torch.cuda.empty_cache()
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    lg_random.seed(0)
    model = BertForMaskedLM(BertConfig(**BERT_BASE))
    lengths = np.random.default_rng(0).integers(64, 129, size=8)
    mask = (np.arange(128)[None, :] < lengths[:, None]).astype(np.float32)
    out.append(lm_steps("BERT-base", model, 8, 128, BERT_BASE["vocab_size"],
                        n, lr=1e-4,
                        mask=Tensor.from_numpy(mask, requires_grad=False)))
    del model
    torch.cuda.empty_cache()

    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import optim
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

    med, times = timed_steps(step, n)
    rec = {"model": "ResNet-18", "images_s": 32 / med,
           "step_s": [round(t, 4) for t in times]}
    print(json.dumps(rec), file=sys.stderr, flush=True)
    out.append(rec)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--no-steps", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_matmul: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.environ.setdefault("LIGHTGRAD_FAKE_DATA", "1")
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
           "build_s": time.perf_counter() - t0, "matmul": kernels()}
    if not args.no_steps:
        rec["steps"] = steps(args.steps)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
