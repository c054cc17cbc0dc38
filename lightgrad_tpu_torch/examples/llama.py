"""Train a small character-level LLaMA (RoPE/RMSNorm/SwiGLU/GQA) and sample.

Counterpart of ``examples/llama.py``: hidden 128, 4 layers, 4 heads, 2 KV
heads (head dim 32), Adam at 3e-4 on 16 x 64 characters of the README, on
the tape (flash attention at head dim 32, the tape's elementwise, reduce
and matmul kernels), the step compiled by ``lightgrad_tpu_torch.jit``;
``--amp`` computes in bf16 over f32 master weights.  Then 120 tokens of KV-cache decode (prefill attention
and the decode attention kernel).  ``--pretrained <hf-name>`` loads a
HuggingFace LLaMA-family checkpoint through the fetch cache instead.

    python -m lightgrad_tpu_torch.examples.llama [--amp] [--device cpu]
"""

import time

import torch

import lightgrad_tpu_torch as light
from lightgrad_tpu_torch.autograd.cuda.device import synchronize
from lightgrad_tpu_torch.examples import (char_corpus, char_windows,
                                          device_parser, on_device)
from lightgrad_tpu_torch.models import Llama, LlamaConfig


def build(vocab_size: int, seq: int = 64, use_amp=False):
    """The char LLaMA, seeded, and its optimizer (Adam, or bf16
    ``MixedPrecision`` over it)."""
    cfg = LlamaConfig(vocab_size=vocab_size, hidden_size=128,
                      intermediate_size=256, num_hidden_layers=4,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=max(seq, 192))
    light.random.seed(0)
    model = Llama(cfg)
    if use_amp:
        opt = light.amp.MixedPrecision(
            model, lambda ps: light.optim.Adam(ps, lr=3e-4),
            compute_dtype=torch.bfloat16)
        print("AMP: bf16 compute, f32 master weights")
    else:
        opt = light.optim.Adam(model.parameters(), lr=3e-4)
    return model, opt


def train_step(model, opt, x, y):
    """One step on ``x`` (B, S) ids and their next ids ``y``."""
    b, s = x.shape
    logits = model(x).reshape(b * s, model.cfg.vocab_size)
    loss = light.loss.cross_entropy(logits, y.reshape(-1))
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss


def train_char_llama(steps=300, batch=16, seq=64, use_amp=False,
                     device="cuda"):
    chars, stoi, data = char_corpus()
    print(f"corpus: {len(data)} chars, vocab {len(chars)}")
    with on_device(device):
        model, opt = build(len(chars), seq, use_amp)
        xs, ys = char_windows(data, steps * batch, seq)
        xs_dev = light.Tensor.from_numpy(xs, requires_grad=False)
        ys_dev = light.Tensor.from_numpy(ys, requires_grad=False)

        fn = light.jit(lambda x, y: train_step(model, opt, x, y))
        t0, losses = None, []
        for i in range(steps):
            loss = fn(xs_dev.narrow(i * batch, batch),
                      ys_dev.narrow(i * batch, batch))
            losses.append(loss.data)
            if i == 2:
                synchronize()
                t0 = time.perf_counter()
            if (i + 1) % 50 == 0:
                print(f"step {i + 1}: loss {loss.item():.4f}")
        synchronize()
        dt = time.perf_counter() - t0
        print(f"{steps - 3} steps in {dt:.2f}s "
              f"({(steps - 3) / dt:.1f} steps/s)")

        ids = [stoi.get(c, 0) for c in "lightgrad"]
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=120, temperature=0.6)
        gen = time.perf_counter() - t0
    print(f"KV-cache decode: 120 tokens in {gen:.2f}s ({120 / gen:.1f} tok/s)")
    text = "".join(chars[i] for i in out)
    print("sample:", repr(text))
    return {"seconds": dt, "steps_per_s": (steps - 3) / dt,
            "losses": [float(v) for v in losses], "tok_per_s": 120 / gen,
            "sample": text, "tokens": out}


def run_pretrained(name: str, prompt: str, device="cuda"):
    with on_device(device):
        model, cfg = Llama.from_pretrained(name)
        ids = [1] + list(prompt.encode("utf-8"))  # byte fallback
        out = model.generate(ids, max_new_tokens=30, temperature=0.7)
    print(out)
    return {"ids": out}


if __name__ == "__main__":
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--pretrained", default=None,
                    help="HF model name, e.g. JackFram/llama-68m")
    ap.add_argument("--prompt", default="The tensor processing unit")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--amp", action="store_true", help="bf16 master-weight AMP")
    args = ap.parse_args()
    if args.pretrained:
        run_pretrained(args.pretrained, args.prompt, device=args.device)
    else:
        train_char_llama(steps=args.steps, use_amp=args.amp,
                         device=args.device)
