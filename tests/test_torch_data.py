"""Port parity: the data pipeline.  ``_synthetic_digits`` is bit-identical
to the JAX package's; ``MNIST`` under ``LIGHTGRAD_FAKE_DATA=1`` holds the
same digits; ``fetch`` reads the JAX package's cache (same directory, same
md5 file names) without the network; ``Dataset`` / ``DeviceDataset`` serve
batches in order without a shuffle, ``offsets()`` as 0-d int tensors that
``narrow`` the resident tensors, and a shuffle keeps (x, y) pairs aligned;
``LMDataset`` builds the JAX package's windows.  The shuffle's permutation
itself differs from the JAX package's (torch.randperm against its native
library), so only its properties are compared."""

import hashlib

import numpy as np
import pytest
import torch

import lightgrad_tpu.data as jdata
from lightgrad_tpu.utils.fetch import fetch as jfetch
from lightgrad_tpu_torch import data as tdata
from lightgrad_tpu_torch import random as trandom
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.utils.fetch import fetch as tfetch
from tests.torch_port import cpu_device  # noqa: F401


@pytest.mark.parametrize("n,seed", [(1, 0), (50, 0), (37, 1)])
def test_synthetic_digits_are_bit_identical(n, seed):
    tx, ty = tdata._synthetic_digits(n, seed)
    jx, jy = jdata._synthetic_digits(n, seed)
    assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("train", [True, False])
def test_mnist_falls_back_to_the_same_synthetic_digits(train, monkeypatch):
    monkeypatch.setenv("LIGHTGRAD_FAKE_DATA", "1")
    t = tdata.MNIST(train=train, n=64, shuffle=False, batchsize=16)
    j = jdata.MNIST(train=train, n=64, shuffle=False, batchsize=16)
    for a, b in zip(t.tensors, j.tensors):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert t.tensors[1].dtype == torch.int32 and len(t) == len(j) == 4


def test_fetch_reads_the_shared_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("LIGHTGRAD_CACHE", str(tmp_path))
    url = "https://example.invalid/mnist/train-labels-idx1-ubyte.gz"
    (tmp_path / hashlib.md5(url.encode()).hexdigest()).write_bytes(b"abc")
    assert tfetch(url) == jfetch(url) == b"abc"


def _pairs(n=10):
    xs = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    ys = np.arange(n, dtype=np.int32)
    return xs, ys


def test_dataset_batches_in_order_without_shuffle():
    xs, ys = _pairs()
    ds = tdata.Dataset((TTensor.from_numpy(xs, requires_grad=False),
                        TTensor.from_numpy(ys, requires_grad=False)),
                       shuffle=False, batchsize=4)
    batches = list(ds)
    assert len(ds) == len(batches) == 3          # the ragged last batch too
    np.testing.assert_array_equal(batches[2][0].numpy(), xs[8:])
    np.testing.assert_array_equal(
        np.concatenate([b[1].numpy() for b in batches]), ys)
    np.testing.assert_array_equal(ds[3][0].numpy(), xs[3])


def test_device_dataset_offsets_and_narrow():
    xs, ys = _pairs()
    ds = tdata.DeviceDataset((xs, ys), shuffle=False, batchsize=4)
    assert len(ds) == 2                          # whole batches only
    tx, ty = ds.tensors
    assert tx.device == torch.device("cpu") and ty.dtype == torch.int32
    offs = list(ds.offsets())
    assert [o.shape for o in offs] == [(), ()]
    assert [int(o.numpy()) for o in offs] == [0, 4]
    assert offs[0].dtype == torch.int32
    for i, off in enumerate(offs):
        np.testing.assert_array_equal(tx.narrow(off, 4).numpy(),
                                      xs[4 * i: 4 * i + 4])
        np.testing.assert_array_equal(ds[i][1].numpy(), ys[4 * i: 4 * i + 4])
    # every offset narrows the batch that __getitem__ gives, epoch after
    # epoch (one device arange each)
    for _ in range(2):
        for i, off in enumerate(ds.offsets()):
            for t, want in zip(ds.tensors, ds[i]):
                np.testing.assert_array_equal(t.narrow(off, 4).numpy(),
                                              want.numpy())
    # tensors from another dataset are taken over, not copied back to numpy
    again = tdata.DeviceDataset(ds.tensors, shuffle=False, batchsize=4)
    np.testing.assert_array_equal(again.tensors[0].numpy(), xs)


@pytest.mark.parametrize("cls", ["Dataset", "DeviceDataset"])
def test_shuffle_keeps_pairs_aligned(cls):
    xs, ys = _pairs(50)
    trandom.seed(3)
    tensors = (TTensor.from_numpy(xs, requires_grad=False),
               TTensor.from_numpy(ys, requires_grad=False))
    ds = getattr(tdata, cls)(tensors, shuffle=True, batchsize=10)
    held = ds.tensors
    seen_x, seen_y = [], []
    for bx, by in ds:
        seen_x.append(bx.numpy())
        seen_y.append(by.numpy())
    sx, sy = np.concatenate(seen_x), np.concatenate(seen_y)
    np.testing.assert_array_equal(sx, xs[sy])        # pairs aligned
    assert sorted(sy.tolist()) == list(range(50))    # a permutation
    assert sy.tolist() != list(range(50))
    if cls == "DeviceDataset":                       # rebound in place
        assert all(a is b for a, b in zip(held, ds.tensors))
    # the same seed gives the same order
    trandom.seed(3)
    ds2 = getattr(tdata, cls)(tensors, shuffle=True, batchsize=10)
    np.testing.assert_array_equal(np.concatenate([b[1].numpy()
                                                  for b in ds2]), sy)


@pytest.mark.parametrize("seq,stride", [(8, None), (5, 3)])
def test_lm_dataset_windows_match_the_jax_package(seq, stride):
    tokens = np.random.default_rng(0).integers(0, 50, 61)
    t = tdata.LMDataset(tokens, seq, stride=stride, shuffle=False,
                        batchsize=2)
    j = jdata.LMDataset(tokens, seq, stride=stride, shuffle=False,
                        batchsize=2)
    assert len(t) == len(j) and t.seq == seq
    for a, b in zip(t.tensors, j.tensors):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    x, y = t.tensors
    np.testing.assert_array_equal(x.numpy()[:, 1:], y.numpy()[:, :-1])
