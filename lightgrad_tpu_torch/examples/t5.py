"""Train a tiny T5 on a character-reversal task, then decode with it.

Counterpart of ``examples/t5.py``: teacher-forced seq2seq training (d_model
64, 2 + 2 layers, 4 heads, 16 relative-position buckets, Adam at 3e-3,
batch 32 of 8 symbols) with cross-attention and relative-position biases,
eagerly on the tape (matmul, softmax, elementwise, reduce kernels), then
greedy generation.  Reversal is impossible for a causal LM without an
encoder, so a falling loss and correct reversals show the encoder-decoder
path itself.  ``--pretrained`` loads HuggingFace t5-small through the
fetch cache instead.

    python -m lightgrad_tpu_torch.examples.t5 [--steps 800] [--device cpu]
"""

import time

import numpy as np

import lightgrad_tpu_torch as light
from lightgrad_tpu_torch.autograd.cuda.device import synchronize
from lightgrad_tpu_torch.examples import device_parser, on_device
from lightgrad_tpu_torch.models import T5Config, T5ForConditionalGeneration

VOCAB = 30  # 0=pad/start, 1=eos, 2..29 = symbols


def make_batch(rng, batch, seq):
    src = rng.integers(2, VOCAB, (batch, seq)).astype(np.int32)
    labels = src[:, ::-1].copy()  # target: the reversed string
    return src, labels


def build(seq=8):
    """The tiny T5, seeded, and its Adam."""
    cfg = T5Config(vocab_size=VOCAB, d_model=64, d_kv=16, d_ff=128,
                   num_layers=2, num_decoder_layers=2, num_heads=4,
                   relative_attention_num_buckets=16,
                   relative_attention_max_distance=seq + 2,
                   dropout_rate=0.0)
    light.random.seed(0)
    model = T5ForConditionalGeneration(cfg)
    optim = light.optim.Adam(model.parameters(), lr=3e-3)
    return model, optim


def train_step(model, optim, x, d, y):
    """One teacher-forced step: sources ``x``, decoder inputs ``d`` (the
    labels shifted right), labels ``y``."""
    b, s = y.shape
    logits = model(x, d).reshape(b * s, VOCAB)
    loss = light.loss.cross_entropy(logits, y.reshape(-1))
    optim.zero_grad()
    loss.backward()
    optim.step()
    return loss


def decode(model, seq):
    """Greedy reversals of four held-out strings: (sources, labels,
    outputs)."""
    src, labels = make_batch(np.random.default_rng(999), 4, seq)
    out = model.generate(light.Tensor.from_numpy(src, requires_grad=False),
                         max_new_tokens=seq)
    return src, labels, np.asarray(out)


def train(steps=800, batch=32, seq=8, device="cuda"):
    with on_device(device):
        model, optim = build(seq)
        rng = np.random.default_rng(0)
        # one device-resident pool of batches, sliced at each step's offset
        src_all, lab_all = make_batch(rng, steps * batch, seq)
        dec_all = model.shift_right(lab_all)
        src_dev, dec_dev, lab_dev = (
            light.Tensor.from_numpy(a, requires_grad=False)
            for a in (src_all, dec_all, lab_all))

        fn = light.jit(lambda x, d, y: train_step(model, optim, x, d, y))
        t0, losses = None, []
        for i in range(steps):
            off = i * batch
            loss = fn(src_dev.narrow(off, batch), dec_dev.narrow(off, batch),
                      lab_dev.narrow(off, batch))
            losses.append(loss.data)
            if i == 2:
                synchronize()  # past record + compile (the kernels' builds)
                t0 = time.perf_counter()
            if i % 100 == 0 or i == steps - 1:
                print(f"step {i:4d}  loss {loss.item():.4f}")
        rate = None
        if t0 is not None:
            synchronize()
            dt = time.perf_counter() - t0
            rate = (steps - 3) / dt
            print(f"{steps - 3} steps in {dt:.2f}s = {rate:.1f} steps/s")

        # decode a few held-out strings
        model.eval()
        src, labels, out = decode(model, seq)
    correct = (out[:, :seq] == labels).all(axis=1)
    for s, o, ok in zip(src, out, correct):
        print(f"  {[int(v) for v in s]} -> {[int(v) for v in o[:seq]]} "
              f"{'OK' if ok else 'MISS'}")
    print(f"exact reversals: {int(correct.sum())}/{len(correct)}")
    return {"accuracy": float(correct.mean()), "steps_per_s": rate,
            "losses": [float(v) for v in losses]}


def pretrained_demo(device="cuda"):
    with on_device(device):
        model, cfg = T5ForConditionalGeneration.from_pretrained("t5-small")
    n = sum(int(np.prod(p.shape)) for p in model.parameters())
    print("loaded t5-small;", n, "params")
    return {"params": n}


if __name__ == "__main__":
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--pretrained", action="store_true")
    args = ap.parse_args()
    if args.pretrained:
        pretrained_demo(args.device)
    else:
        train(steps=args.steps, device=args.device)
