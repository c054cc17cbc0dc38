"""DDPM on MNIST-class digits: train a time-conditioned UNet to denoise,
then draw samples by ancestral sampling.

Counterpart of ``examples/diffusion.py``: UNet base 32, T 200, batch 64,
Adam at 2e-4, EMA at 0.995, the 20,000-image pool resident on the device,
timesteps and noise drawn there each step.  The step (batch slice, draws,
loss, Adam, EMA update) is compiled by ``lightgrad_tpu_torch.jit`` on the
tape's conv, elementwise, reduce and matmul kernels; then ``sample`` of 16
images under the EMA average with ``jit=lightgrad_tpu_torch.jit``, and with
``--viz`` a grid of them in ``diffusion_samples.png``.

    python -m lightgrad_tpu_torch.examples.diffusion [--steps 400] [--viz] [--device cpu]
"""

import time

import numpy as np

import lightgrad_tpu_torch as light
from lightgrad_tpu_torch.autograd.cuda.device import synchronize
from lightgrad_tpu_torch.examples import device_parser, on_device
from lightgrad_tpu_torch.models import Diffusion, UNet


def build(timesteps=200, base=32, lr=2e-4, seed=0, ema_decay=0.995):
    """(diffusion, optimizer, EMA or None) around a seeded UNet."""
    light.random.seed(seed)
    unet = UNet(in_channels=1, base=base)
    dif = Diffusion(unet, timesteps=timesteps)
    optim = light.optim.Adam(unet.parameters(), lr=lr)
    ema = light.optim.EMA(unet.parameters(), decay=ema_decay) \
        if ema_decay else None
    return dif, optim, ema


def draw(data_dev, ti, off, batch, timesteps):
    """A step's batch at ``off`` with its timesteps and noise, drawn on the
    device (``randint_like`` / ``randn_like``)."""
    x0 = data_dev.narrow(off, batch)
    return x0, ti.randint_like(0, timesteps), x0.randn_like()


def train_step(dif, optim, ema, x0, t, z):
    """One noise-prediction step at timesteps ``t`` with noise ``z``."""
    loss = dif.loss(x0, t, z)
    optim.zero_grad()
    loss.backward()
    optim.step()
    if ema is not None:
        ema.update()
    return loss


def main(steps=400, batch=64, timesteps=200, base=32, lr=2e-4, viz=False,
         seed=0, ema_decay=0.995, device="cuda"):
    with on_device(device):
        mnist = light.data.MNIST(train=True, n=20_000, shuffle=False)
        train_x = mnist.tensors[0].numpy().astype(np.float32)  # [0, 1]
        data = train_x.reshape(-1, 1, 28, 28) * 2.0 - 1.0      # [-1, 1]

        dif, optim, ema = build(timesteps, base, lr, seed, ema_decay)
        n_params = sum(p.numel() for p in dif.model.parameters())
        print(f"UNet {n_params/1e3:.0f}k params, T={timesteps}")

        # device-resident pipeline: the image pool lives on the card
        # (shuffled once); each step slices its batch and draws timesteps
        # and noise there
        rng = np.random.default_rng(seed)
        rng.shuffle(data)
        light.random.seed(seed)
        data_dev = light.Tensor.from_numpy(data, requires_grad=False)
        ti = light.Tensor.from_numpy(np.zeros(batch, np.int32),
                                     requires_grad=False)
        n_off = (len(data) - batch) // batch

        # the slice at a device offset and the draws run inside the
        # compiled step (a replay draws afresh from the tape's generator)
        fn = light.jit(lambda off: train_step(dif, optim, ema, *draw(
            data_dev, ti, off, batch, timesteps)))
        offs = light.Tensor.from_numpy(
            (np.arange(steps) % n_off * batch).astype(np.int32),
            requires_grad=False)

        def step(i):
            return fn(offs[i])

        step(0)  # record (builds the kernels)
        synchronize()
        t0 = time.perf_counter()
        losses = []
        for i in range(1, steps + 1):
            loss = step(i - 1)
            losses.append(loss.data)
            if i % 50 == 0 or i == 1:
                print(f"step {i}: loss {float(loss.item()):.4f}", flush=True)
        synchronize()
        dt = time.perf_counter() - t0
        print(f"{steps} steps in {dt:.1f}s ({steps/dt:.1f} steps/s)")

        print("sampling 16 digits" + (" (EMA weights)" if ema else "") +
              "...")
        t0 = time.perf_counter()
        if ema is not None:
            with ema.average_parameters():
                imgs = dif.sample(16, seed=seed + 1, jit=light.jit).numpy()
        else:
            imgs = dif.sample(16, seed=seed + 1, jit=light.jit).numpy()
        sample_s = time.perf_counter() - t0
    print(f"sampled in {sample_s:.1f}s, "
          f"range [{imgs.min():.2f}, {imgs.max():.2f}]")
    out = {"seconds": dt, "steps_per_s": steps / dt,
           "losses": [float(v) for v in losses], "images": imgs,
           "sample_seconds": sample_s, "diffusion": dif, "optim": optim,
           "ema": ema}
    if viz:
        save_grid(imgs, "diffusion_samples.png")
    return out


def save_grid(imgs, path):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001 - any import failure: no plot
        print("matplotlib unavailable; skipping sample grid")
        return
    fig, axes = plt.subplots(4, 4, figsize=(6, 6))
    for ax, im in zip(axes.ravel(), imgs):
        ax.imshow(np.clip((im[0] + 1) / 2, 0, 1), cmap="gray")
        ax.axis("off")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")


if __name__ == "__main__":
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--timesteps", type=int, default=200)
    ap.add_argument("--base", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--viz", action="store_true")
    ap.add_argument("--ema", type=float, default=0.995,
                    help="EMA decay for sampling weights (0 disables)")
    args = ap.parse_args()
    main(steps=args.steps, batch=args.batch, timesteps=args.timesteps,
         base=args.base, lr=args.lr, viz=args.viz, ema_decay=args.ema,
         device=args.device)
