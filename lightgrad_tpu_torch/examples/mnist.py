"""MNIST training: MLP and CNN.

Counterpart of ``examples/mnist.py``: the same two models, AdaBelief
(1e-3 for the MLP, 3e-3 for the CNN), batch 128 narrowed from the whole
training set resident on the device, cross-entropy, then the accuracy on
2,000 test digits.  The step is compiled by ``lightgrad_tpu_torch.jit`` (one
CUDA graph a step) unless ``--no-jit``; ``--profile`` times each tape op
with the port's ``Profiler``, so it runs the eager tape.  Synthetic digits stand in for MNIST under
``LIGHTGRAD_FAKE_DATA=1`` or without the network.

    python -m lightgrad_tpu_torch.examples.mnist [--model cnn] [--device cpu]
"""

import time

import numpy as np

import lightgrad_tpu_torch as light
import lightgrad_tpu_torch.nn as nn
from lightgrad_tpu_torch.autograd.cuda.device import synchronize
from lightgrad_tpu_torch.examples import device_parser, on_device


class CNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv2d(1, 8, kernelsize=3, pad=1)
        self.c2 = nn.Conv2d(8, 16, kernelsize=3, pad=1)
        self.l1 = nn.Linear(7 * 7 * 16, 10)

    def forward(self, x):
        y = self.c1(x).max_pool(kernel=(2, 2)).relu()
        y = self.c2(y).max_pool(kernel=(2, 2)).relu()
        return self.l1(y.reshape(y.shape[0], -1))


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.l1 = nn.Linear(28 * 28, 128)
        self.l2 = nn.Linear(128, 10)

    def forward(self, x):
        return self.l2(self.l1(x).relu())


def build(model_kind="mlp"):
    """The model and its optimizer: the CNN converges well at a higher lr;
    the MLP keeps the reference's 1e-3."""
    model = MLP() if model_kind == "mlp" else CNN()
    optim = light.optim.AdaBelief(
        model.parameters(), lr=1e-3 if model_kind == "mlp" else 3e-3)
    return model, optim


def prep(model_kind, x):
    return x.reshape(x.shape[0], -1) if model_kind == "mlp" else x.reshape(
        x.shape[0], 1, 28, 28)


def train_step(model, optim, model_kind, x, y):
    """One step on a batch of images ``x`` and labels ``y``."""
    out = model(prep(model_kind, x))
    loss = light.loss.cross_entropy(out, y)
    optim.zero_grad()
    loss.backward()
    optim.step()
    return loss


def evaluate(model, test, model_kind) -> float:
    correct = total = 0
    with light.no_grad():
        for x, y in test:
            pred = model(prep(model_kind, x)).numpy().argmax(-1)
            correct += int((pred == y.numpy()).sum())
            total += len(pred)
    return correct / total


def main(model_kind="mlp", steps=200, batch=128, use_jit=True, profile=False,
         viz=False, device="cuda"):
    with on_device(device):
        mnist = light.data.MNIST(train=True, batchsize=batch)
        # device-resident pipeline: whole train set on the card, batches
        # are slices
        train = light.data.DeviceDataset(mnist.tensors, batchsize=batch)
        test = light.data.MNIST(train=False, n=2_000, shuffle=False,
                                batchsize=256)
        model, optim = build(model_kind)
        xs_dev, ys_dev = train.tensors

        def step(x, y):
            return train_step(model, optim, model_kind, x, y)

        if profile and use_jit:
            # the per-op profiler observes tape dispatches; a compiled step
            # is one graph replay
            print("profiling runs the eager tape (per-op timings)")
            use_jit = False
        step_fn = light.jit(step) if use_jit else step

        profiler = light.Profiler() if profile else None
        done, t0, losses = 0, None, []
        while done < steps:
            for off in train.offsets():
                if done >= steps:
                    break
                x, y = xs_dev.narrow(off, batch), ys_dev.narrow(off, batch)
                if profiler:
                    with profiler:
                        loss = step_fn(x, y)
                else:
                    loss = step_fn(x, y)
                losses.append(loss.data)
                done += 1
                if done == 3:
                    # steps 1-2 are the jit record + compile phases (and
                    # build the kernels)
                    synchronize()
                    t0 = time.perf_counter()
                if done % 50 == 0:
                    print(f"step {done}: loss {loss.item():.4f}")
        synchronize()
        dt = time.perf_counter() - t0
        timed = max(steps - 3, 1)
        print(f"{timed} steps in {dt:.3f}s ({timed / dt:.1f} steps/s)")
        if profiler:
            profiler.print(topn=15)

        acc = evaluate(model, test, model_kind)
        print(f"test accuracy: {acc:.4f}")
        if viz and model_kind == "cnn":
            visualize_filters(model, "mnist_cnn_filters.png")
    return {"seconds": dt, "accuracy": acc, "steps_per_s": timed / dt,
            "losses": [float(v) for v in losses]}


def visualize_filters(model, path):
    """Plot the first conv layer's learned filters."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping filter visualization")
        return
    w = model.c1.w.numpy()  # (out_c, 1, k, k)
    n = w.shape[0]
    fig, axes = plt.subplots(1, n, figsize=(1.4 * n, 1.6))
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.imshow(w[i, 0], cmap="gray")
        ax.set_title(f"f{i}", fontsize=8)
        ax.axis("off")
    fig.suptitle("conv1 filters")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"filters written to {path}")


if __name__ == "__main__":
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--model", default="mlp", choices=["mlp", "cnn"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--no-jit", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--viz", action="store_true",
                    help="save learned conv-filter plot (cnn only)")
    args = ap.parse_args()
    main(args.model, args.steps, args.batch, use_jit=not args.no_jit,
         profile=args.profile, viz=args.viz, device=args.device)
