"""Train a small character-level GPT on this repo's README, then sample.

Counterpart of ``examples/gpt.py``, on the port's ``torch.nn`` GPT:
n_embd 128, 4 layers, 4 heads, 64 positions, batch 16, Adam at 3e-4, on
``torch.autograd`` through the flash-attention forward and backward and the
fused LayerNorm, then ``generate`` of the rest of the 64-token window on the
serving path (prefill attention, the whole-stack decode kernel).  The
step is compiled by ``lightgrad_tpu_torch.jit``: its batches are
``torch.Tensor`` arguments, and the parameters and Adam's state, updated in
place, are read and written in place by the graph.  ``--pretrained``
loads HuggingFace GPT-2 through the fetch cache and generates text
instead.

    python -m lightgrad_tpu_torch.examples.gpt [--steps 300] [--device cpu]
"""

import time

import torch

import lightgrad_tpu_torch as light
from lightgrad_tpu_torch.autograd.cuda.device import synchronize
from lightgrad_tpu_torch.examples import (char_corpus, char_windows,
                                          device_parser, on_device)
from lightgrad_tpu_torch.models import GPT, GPTConfig, GPT2Tokenizer


def build(vocab_size: int, seq: int = 64, device="cuda"):
    """The char GPT, seeded, and its Adam."""
    device = torch.device(device)
    cfg = GPTConfig(vocab_size=vocab_size, n_positions=seq, n_embd=128,
                    n_layer=4, n_head=4)
    model = GPT(cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(0))
    optim = light.optim.Adam(list(model.parameters()), lr=3e-4)
    return model, optim


def train_step(model, optim, x, y):
    """One step on ``x`` (B, S) ids and their next ids ``y``."""
    b, s = x.shape
    logits = model(x).reshape(b * s, model.cfg.vocab_size)
    loss = light.loss.cross_entropy(logits, y.reshape(-1))
    optim.zero_grad()
    loss.backward()
    optim.step()
    return loss


def sample(model, chars, stoi, prompt="lightgrad", temperature=0.6):
    """The prompt continued to the model's window (KV-cache decode needs
    prompt + new <= n_positions)."""
    ids = [stoi.get(c, 0) for c in prompt]
    out = model.generate(ids, max_new_tokens=model.cfg.n_positions - len(ids),
                         temperature=temperature)
    return "".join(chars[i] for i in out)


def train_char_gpt(steps=300, batch=16, seq=64, device="cuda"):
    chars, stoi, data = char_corpus()
    print(f"corpus: {len(data)} chars, vocab {len(chars)}")
    with on_device(device):
        model, optim = build(len(chars), seq, device)

        # device-resident training windows
        xs, ys = char_windows(data, steps * batch, seq)
        xs_dev = torch.from_numpy(xs).long().to(device)
        ys_dev = torch.from_numpy(ys).long().to(device)

        fn = light.jit(lambda x, y: train_step(model, optim, x, y))
        t0, losses = None, []
        for i in range(steps):
            loss = fn(xs_dev.narrow(0, i * batch, batch),
                      ys_dev.narrow(0, i * batch, batch))
            losses.append(loss.detach())
            if i == 2:
                synchronize()
                t0 = time.perf_counter()
            if (i + 1) % 50 == 0:
                print(f"step {i + 1}: loss {loss.item():.4f}")
        synchronize()
        dt = time.perf_counter() - t0
        print(f"{steps - 3} steps in {dt:.2f}s "
              f"({(steps - 3) / dt:.1f} steps/s)")

    text = sample(model, chars, stoi)
    print("sample:", repr(text))
    return {"seconds": dt, "steps_per_s": (steps - 3) / dt,
            "losses": [float(v) for v in losses], "sample": text,
            "model": model}


def run_pretrained(prompt: str, device="cuda"):
    model, cfg = GPT.from_pretrained("gpt2", device=device)
    tok = GPT2Tokenizer.from_pretrained("gpt2")
    ids = tok.encode(prompt)
    out = model.generate(ids, max_new_tokens=30, temperature=0.7)
    print(tok.decode(out))
    return {"ids": out}


if __name__ == "__main__":
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--pretrained", action="store_true")
    ap.add_argument("--prompt", default="The tensor processing unit")
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    if args.pretrained:
        run_pretrained(args.prompt, device=args.device)
    else:
        train_char_gpt(steps=args.steps, device=args.device)
