"""Data pipeline: ``Dataset``, ``DeviceDataset``, ``LMDataset`` and ``MNIST``.

Counterpart of ``lightgrad_tpu/data.py``.  ``DeviceDataset`` keeps the
whole set on the default device; a batch is a ``narrow`` of it and an
epoch's shuffle a gather there, so a step moves no data from the host.
Shuffles draw ``torch.randperm`` from the generator of the tensors' device
(``lightgrad_tpu_torch.random``); the JAX package draws its permutation
from its native library, so the two orders differ.

MNIST comes from the fetch cache or the mirrors, and falls back to a
deterministic synthetic digit set (bit-identical to the JAX package's for
the same seed) when ``LIGHTGRAD_FAKE_DATA=1`` or no mirror answers.
"""

import gzip
import os
from math import ceil

import numpy as np
import torch

from . import random
from .autograd import AbstractTensor, Tensor, no_grad
from .autograd.cuda import device
from .utils.fetch import fetch

__all__ = ["Dataset", "DeviceDataset", "LMDataset", "MNIST"]


def _permutation(n: int, dev) -> torch.Tensor:
    return torch.randperm(n, generator=random.generator(dev), device=dev)


class Dataset:
    def __init__(self, tensors, shuffle: bool = True, batchsize: int = 8):
        assert all(t.shape[0] == tensors[0].shape[0] for t in tensors[1:])
        self._tensors = tuple(tensors)
        self._shuffle, self._bs = shuffle, batchsize

    @property
    def tensors(self) -> tuple:
        return self._tensors

    @property
    def n(self) -> int:
        return self._tensors[0].shape[0]

    def shuffle(self):
        """One permutation for every tensor: pairs stay aligned."""
        idx = _permutation(self.n, self._tensors[0].data.device)
        self._tensors = tuple(t[idx].detach() for t in self._tensors)

    def __getitem__(self, i):
        return tuple(t[i, ...].detach() for t in self._tensors)

    def __iter__(self):
        if self._shuffle:
            self.shuffle()
        for i in range(len(self)):
            yield self[i * self._bs: (i + 1) * self._bs]

    def __len__(self) -> int:
        return ceil(self.n / self._bs)


class DeviceDataset(Dataset):
    """The whole dataset on the default device: batches are ``narrow``
    slices, epoch shuffles gathers on the device, and every batch has the
    same shape (the last ragged batch is dropped)."""

    def __init__(self, tensors, shuffle: bool = True, batchsize: int = 8):
        dev = device.default_device()

        def resident(t):
            if isinstance(t, AbstractTensor):
                return Tensor(t.data.to(dev), requires_grad=False)
            return Tensor.from_numpy(
                t.numpy() if hasattr(t, "numpy") else t, requires_grad=False)

        super().__init__(tuple(resident(t) for t in tensors),
                         shuffle=shuffle, batchsize=batchsize)

    def __len__(self) -> int:
        return self.n // self._bs

    def shuffle(self):
        # rebinds each tensor's buffer in place: the tensor objects a step
        # holds see the new epoch's order
        idx = _permutation(self.n, self._tensors[0].data.device)
        with no_grad():
            for t in self._tensors:
                t._set_data(t[idx].detach().data)

    def __getitem__(self, i):
        """Batch ``i`` (a batch index, unlike the base class's row index)
        as slices of the resident tensors."""
        with no_grad():
            return tuple(t.narrow(i * self._bs, self._bs).detach()
                         for t in self._tensors)

    def __iter__(self):
        if self._shuffle:
            self.shuffle()
        for i in range(len(self)):
            yield self[i]

    def offsets(self):
        """Batch offsets as 0-d int32 device tensors, for a step that
        narrows the resident tensors itself (a ``jit``-compiled step takes
        the offset as its argument, and its graph reads the resident
        tensors in place)::

            for off in ds.offsets():
                loss = train_step(xs.narrow(off, B), ys.narrow(off, B))

        One device ``arange`` an epoch: no upload and no read to the host
        a batch."""
        if self._shuffle:
            self.shuffle()
        offs = torch.arange(len(self), dtype=torch.int32,
                            device=self._tensors[0].data.device) * self._bs
        for i in range(len(self)):
            yield Tensor(offs[i], requires_grad=False)


class LMDataset(DeviceDataset):
    """Causal-LM windows over a 1-D token stream, on the device: ``(N,
    seq)`` inputs and their next-token targets (``stride`` sets the
    overlap; default none), shuffled with one permutation so pairs stay
    aligned."""

    def __init__(self, tokens, seq: int, stride: int = None,
                 shuffle: bool = True, batchsize: int = 8):
        tokens = np.asarray(tokens)
        assert tokens.ndim == 1, f"token stream must be 1-D, got {tokens.shape}"
        assert len(tokens) > seq, (len(tokens), seq)
        stride = stride or seq
        starts = np.arange(0, len(tokens) - seq, stride)
        xs = np.stack([tokens[s:s + seq] for s in starts]).astype(np.int32)
        ys = np.stack([tokens[s + 1:s + seq + 1]
                       for s in starts]).astype(np.int32)
        self.seq = seq
        super().__init__((xs, ys), shuffle=shuffle, batchsize=batchsize)


_MNIST_MIRRORS = [
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
]


def _synthetic_digits(n: int, seed: int = 0):
    """Deterministic stand-in digit set: translated dilated class templates
    (the JAX package's, draw for draw)."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 10, size=n).astype(np.int16)
    xs = np.zeros((n, 28, 28), dtype=np.float32)
    tmpl_rng = np.random.default_rng(1234)
    templates = (tmpl_rng.random((10, 20, 20)) > 0.6).astype(np.float32)
    for i, y in enumerate(ys):
        dx, dy = rng.integers(0, 8, size=2)
        xs[i, dx: dx + 20, dy: dy + 20] = templates[y]
        xs[i] += rng.normal(0, 0.1, (28, 28)).astype(np.float32)
    return np.clip(xs, 0, 1), ys


class MNIST(Dataset):
    def __init__(self, train: bool = True, n: int = 60_000, **kwargs):
        n = min(n, 60_000 if train else 10_000)
        img_name = "train-images-idx3-ubyte.gz" if train \
            else "t10k-images-idx3-ubyte.gz"
        lbl_name = "train-labels-idx1-ubyte.gz" if train \
            else "t10k-labels-idx1-ubyte.gz"
        x = y = None
        if os.environ.get("LIGHTGRAD_FAKE_DATA") != "1":
            for base in _MNIST_MIRRORS:
                try:
                    def parse(raw):
                        return np.frombuffer(gzip.decompress(raw),
                                             dtype=np.uint8)

                    x = parse(fetch(base + img_name))[
                        0x10: 0x10 + n * 28 * 28]
                    x = x.reshape(-1, 28, 28).astype(np.float32) / 255.0
                    y = parse(fetch(base + lbl_name))[8: 8 + n].astype(
                        np.int16)
                    break
                except Exception as e:  # noqa: BLE001 - any failure: next mirror
                    print(f"MNIST fetch from {base} failed: {e}")
        if x is None:
            print("MNIST unavailable; using deterministic synthetic digits")
            x, y = _synthetic_digits(n, seed=0 if train else 1)
        super().__init__(
            (Tensor.from_numpy(x, requires_grad=False),
             Tensor.from_numpy(y, requires_grad=False)),
            **kwargs,
        )
