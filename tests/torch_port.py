"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs and weights come from numpy seeds and go through both packages as
numpy arrays.  The JAX side runs on the CPU in ``pallas`` (interpret) or
``xla`` kernel mode; the port side runs its CPU plain versions.
"""

import contextlib

import numpy as np
import pytest
import torch

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
