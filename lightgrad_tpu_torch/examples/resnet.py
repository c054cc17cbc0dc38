"""ResNet training / pretrained-checkpoint inference.

Counterpart of ``examples/resnet.py``: trains a CIFAR-style ResNet-20 on
MNIST (BatchNorm running statistics, residual projections, global average
pooling) with AdamW at 3e-3, batch 128, on the tape's conv, elementwise,
reduce and matmul kernels, the step compiled by ``lightgrad_tpu_torch.jit``;
``--amp`` trains bf16 compute over f32 master weights.  ``--pretrained`` loads the torchvision ResNet-18
checkpoint (``torch.load(weights_only=True)`` through the fetch cache) and
classifies a synthetic batch instead.

    python -m lightgrad_tpu_torch.examples.resnet [--amp] [--device cpu]
"""

import io
import time

import numpy as np
import torch

import lightgrad_tpu_torch as light
from lightgrad_tpu_torch.autograd.cuda.device import synchronize
from lightgrad_tpu_torch.examples import device_parser, on_device
from lightgrad_tpu_torch.models.resnet import (load_torchvision_state_dict,
                                               resnet18, resnet20)


def build(amp=False):
    """ResNet-20 for 1-channel digits and its optimizer (AdamW, or bf16
    ``MixedPrecision`` over it)."""
    light.random.seed(0)
    model = resnet20(num_classes=10, in_channels=1)
    if amp:
        opt = light.amp.MixedPrecision(
            model, lambda ps: light.optim.AdamW(ps, lr=3e-3,
                                                weight_decay=0.01))
    else:
        opt = light.optim.AdamW(model.parameters(), lr=3e-3,
                                weight_decay=0.01)
    return model, opt


def train_step(model, opt, x, y):
    """One step on ``x`` (B, 784) images and labels ``y``."""
    loss = light.loss.cross_entropy(
        model(x.reshape(x.shape[0], 1, 28, 28)), y)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss


def evaluate(model, test) -> float:
    model.eval()  # BatchNorm switches to running stats
    correct = total = 0
    with light.no_grad():
        for x, y in test:
            x = x.reshape(x.shape[0], 1, 28, 28)
            pred = model(x).numpy().argmax(-1)
            correct += int((pred == y.numpy()).sum())
            total += len(pred)
    model.train()
    return correct / total


def train(steps=150, batch=128, amp=False, device="cuda"):
    with on_device(device):
        mnist = light.data.MNIST(train=True, batchsize=batch)
        train_set = light.data.DeviceDataset(mnist.tensors, batchsize=batch)
        test = light.data.MNIST(train=False, n=2_000, shuffle=False,
                                batchsize=256)
        model, opt = build(amp)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"ResNet-20: {n_params/1e3:.0f}k params")

        xs_dev, ys_dev = train_set.tensors
        step_fn = light.jit(lambda x, y: train_step(model, opt, x, y))
        done, t0, losses = 0, None, []
        while done < steps:
            for off in train_set.offsets():
                if done >= steps:
                    break
                loss = step_fn(xs_dev.narrow(off, batch),
                               ys_dev.narrow(off, batch))
                losses.append(loss.data)
                done += 1
                if done == 3:  # steps 1-2 are record + compile
                    synchronize()
                    t0 = time.perf_counter()
                if done % 25 == 0:
                    print(f"step {done}: loss {loss.item():.4f}")
        synchronize()
        dt = time.perf_counter() - t0
        timed = max(steps - 3, 1)
        print(f"{timed} steps in {dt:.3f}s ({timed / dt:.1f} steps/s)")
        acc = evaluate(model, test)
        print(f"test accuracy: {acc:.4f}")
    return {"seconds": dt, "accuracy": acc, "steps_per_s": timed / dt,
            "losses": [float(v) for v in losses]}


def pretrained_inference(device="cuda"):
    """Load torchvision ResNet-18 ImageNet weights and classify a synthetic
    batch (sanity: logits finite, deterministic top-1)."""
    from lightgrad_tpu_torch.utils import fetch

    url = "https://download.pytorch.org/models/resnet18-f37072fd.pth"
    try:
        state = torch.load(io.BytesIO(fetch(url)), map_location="cpu",
                           weights_only=True)
    except Exception as e:  # noqa: BLE001 - offline: report and bail
        print(f"could not fetch torchvision checkpoint ({e}); "
              "run with network access for pretrained inference")
        return None
    with on_device(device):
        model = resnet18()
        load_torchvision_state_dict(model, state)
        model.eval()
        rng = np.random.default_rng(0)
        x = light.Tensor.from_numpy(
            rng.standard_normal((2, 3, 224, 224)).astype(np.float32),
            requires_grad=False)
        with light.no_grad():
            logits = model(x).numpy()
    print(f"logits: shape {logits.shape}, top-1 {logits.argmax(-1)}")
    return {"logits": logits}


if __name__ == "__main__":
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--amp", action="store_true", help="bf16 master-weight AMP")
    ap.add_argument("--pretrained", action="store_true",
                    help="torchvision ResNet-18 inference instead of training")
    args = ap.parse_args()
    if args.pretrained:
        pretrained_inference(args.device)
    else:
        train(args.steps, args.batch, amp=args.amp, device=args.device)
