"""The CUDA backend's device: where new ``CudaTensor``s are made.

Counterpart of ``lightgrad_tpu/autograd/tpu/device.py``.  The default
device is ``"cuda"`` and is set here, and only here.  Nothing falls back to
the CPU when no card is found: making a tensor then fails.  Tests on a host
without a card choose ``"cpu"`` explicitly with :func:`set_default_device`;
every op then runs the kernels' plain PyTorch versions, since a kernel
wrapper dispatches on the device of the tensors it is given.
"""

import torch

__all__ = ["default_device", "set_default_device", "device_count",
           "synchronize"]

_device = torch.device("cuda")


def default_device() -> torch.device:
    return _device


def set_default_device(device) -> torch.device:
    """Make new tensors on ``device``; returns the previous default."""
    global _device
    prev, _device = _device, torch.device(device)
    return prev


def device_count() -> int:
    return torch.cuda.device_count()


def synchronize(t=None) -> None:
    """Wait until the card has finished all queued work (of ``t``'s device,
    or the default device's); a no-op on the CPU."""
    dev = t.data.device if t is not None else _device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
