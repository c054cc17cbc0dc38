"""The JAX package's ten example scripts on the port.

Each module keeps the name, functions, arguments, defaults and printed lines
of its counterpart in ``examples/`` and runs as

    python -m lightgrad_tpu_torch.examples.<name> [--device cpu]

on ``cuda`` unless the caller names the CPU (``--device cpu``, or
``device="cpu"`` to its function); nothing moves to the CPU when no GPU is
found.  Each step the JAX script compiles with ``light.jit`` is compiled
here by ``lightgrad_tpu_torch.jit`` (a CUDA graph a step on the card); a
timed window skips the record and compile calls and ends with a device sync
before the clock is read.  Each script is cut into a ``build`` function and a step
function, which its ``main`` calls and a test can call with its own model,
batches and noise.
The functions return a dict of what they measured (losses, rates, the
trained model) beside what they print.

The helpers below are what the scripts share: the device they run on, their
``--device`` option, and the character corpus of the two char models.
"""

import argparse
import contextlib
import os

import numpy as np
import torch

from ..autograd.cuda import device as _device

__all__ = ["on_device", "device_parser", "char_corpus", "char_windows"]


@contextlib.contextmanager
def on_device(device):
    """New lightgrad tensors on ``device`` inside the block (the previous
    default after it); yields the ``torch.device``."""
    prev = _device.set_default_device(device)
    try:
        yield torch.device(device)
    finally:
        _device.set_default_device(prev)


def device_parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--device`` option."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    return ap


def char_corpus():
    """The repository's README.md as characters: ``(chars, stoi, data)``,
    ``data`` the int32 ids of the text."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "README.md")
    with open(path, encoding="utf-8") as f:
        text = f.read()
    chars = sorted(set(text))
    stoi = {c: i for i, c in enumerate(chars)}
    return chars, stoi, np.array([stoi[c] for c in text], dtype=np.int32)


def char_windows(data, n: int, seq: int, seed: int = 0):
    """``n`` random training windows of ``seq`` ids and their next-id
    targets, drawn as the JAX char examples draw them."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(data) - seq - 1, n)
    xs = np.stack([data[s: s + seq] for s in starts])
    ys = np.stack([data[s + 1: s + seq + 1] for s in starts])
    return xs, ys
