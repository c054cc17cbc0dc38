"""Manual gradient descent on a random tensor expression.

Counterpart of ``examples/gradient_descent.py``: minimizes
``sum((a.tanh() + b.sigmoid()) @ (c.relu() - a.sigmoid()))`` by hand-rolled
SGD with in-place parameter updates under no_grad, on the tape's kernels
(elementwise, reduce, matmul).

    python -m lightgrad_tpu_torch.examples.gradient_descent [--device cpu]
"""

import time

import lightgrad_tpu_torch as light
from lightgrad_tpu_torch.autograd.cuda.device import synchronize
from lightgrad_tpu_torch.examples import device_parser, on_device


def build():
    """The three (64, 64) parameters, uniform in [-1, 1), on the default
    device."""
    return tuple(light.uniform(-1, 1, (64, 64)) for _ in range(3))


def step(params, lr: float):
    """One epoch: the loss, its gradients, and ``p += grad * -lr``."""
    a, b, c = params
    y = (a.tanh() + b.sigmoid()) @ (c.relu() - a.sigmoid())
    loss = (y * y).sum()
    for p in params:
        p.zero_grad()
    loss.backward()
    with light.no_grad():
        for p in params:
            p += p.grad * (-lr)
    return loss


def main(epochs: int = 100, lr: float = 0.001, device="cuda"):
    with on_device(device):
        params = build()
        t0 = time.perf_counter()
        losses = [step(params, lr).data for _ in range(epochs)]
        synchronize()
        dt = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    print(f"final loss {losses[-1]:.6f} after {epochs} epochs in {dt:.3f}s")
    return {"seconds": dt, "losses": losses}


if __name__ == "__main__":
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    main(device=args.device)
