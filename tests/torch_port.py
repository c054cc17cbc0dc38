"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs and weights come from numpy seeds and go through both packages as
numpy arrays.  The JAX side runs on the CPU in ``pallas`` (interpret) or
``xla`` kernel mode; the port side runs its CPU plain versions.
"""

import contextlib

import numpy as np
import pytest
import torch

import lightgrad_tpu.nn as jax_nn
from lightgrad_tpu.autograd.tensor import AbstractTensor as JaxAbstractTensor
from lightgrad_tpu.ops import runtime as jax_runtime


@contextlib.contextmanager
def jax_kernel_mode(mode):
    """Run the JAX package in ``mode`` ('pallas' = interpret off-TPU, or
    'xla'), restoring the previous mode afterwards."""
    prev = jax_runtime.set_kernel_mode(mode)
    try:
        yield
    finally:
        jax_runtime.set_kernel_mode(prev)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def to_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


@pytest.fixture(autouse=True)
def cpu_device():
    """New lightgrad tensors of the port on the CPU for the test (the port's
    default device is "cuda"); import this fixture into a test module to
    apply it there."""
    from lightgrad_tpu_torch.autograd.cuda import device

    prev = device.set_default_device("cpu")
    yield
    device.set_default_device(prev)


@pytest.fixture
def jax_batchnorm_true_gradient(monkeypatch):
    """The JAX package's ``BatchNorm2d`` updates its running statistics from
    ``m.detach()`` / ``v.detach()``, and its ``detach`` cuts a tensor from
    the tape in place: its training gradient treats the batch mean and
    variance as constants.  The port's keeps them on the tape.  For parity,
    the JAX layer runs here with a ``detach`` that returns a new graph-free
    tensor, as the port's ``BatchNorm2d`` reads ``copy()``."""
    forward = jax_nn.BatchNorm2d.forward

    def patched(self, x):
        with monkeypatch.context() as m:
            m.setattr(JaxAbstractTensor, "detach",
                      lambda t: t.copy(requires_grad=False))
            return forward(self, x)

    monkeypatch.setattr(jax_nn.BatchNorm2d, "forward", patched)
