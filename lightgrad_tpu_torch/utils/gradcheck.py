"""Numerical gradient checking.

Counterpart of ``lightgrad_tpu/utils/gradcheck.py``: the analytic Jacobian,
one backward pass an output element, against the central-difference
numerical Jacobian, at the reference's tolerances (atol = rtol = 5e-4).
Works on any tape tensor: the numpy ``CpuTensor`` and the ``CudaTensor``
on either device (the perturbed inputs go to ``type(x).from_numpy``, so a
``CudaTensor`` goes to the default device).
"""

import numpy as np

from ..autograd.grads import Gradients
from ..autograd.tensor import AbstractTensor

__all__ = ["jacobian", "numerical_jacobian", "gradcheck", "assert_gradcheck"]


def jacobian(f, x: AbstractTensor) -> np.ndarray:
    """(x.numel(), f(x).numel()) analytic Jacobian of ``f`` at ``x``."""
    assert isinstance(x, AbstractTensor) and x.requires_grad
    y = f(x)
    assert isinstance(y, AbstractTensor) and y.requires_grad
    ni, nj = x.numel(), y.numel()
    y = y.reshape(-1)
    jac = np.empty((ni, nj), dtype=np.float64)
    for j in range(nj):
        y.zero_grad(traverse_graph=True)
        y[j].backward()
        jac[:, j] = x.grad.numpy().reshape(-1)
    return jac


@Gradients.no_grad()
def numerical_jacobian(f, x: AbstractTensor, eps: float = 1e-4) -> np.ndarray:
    """The same Jacobian by central differences of step ``eps``."""
    assert isinstance(x, AbstractTensor)
    ni = x.numel()
    nj = f(x).numel()
    jac = np.empty((ni, nj), dtype=np.float64)
    base = x.numpy()
    for i, idx in enumerate(np.ndindex(x.shape)):
        h = np.zeros_like(base)
        h[idx] = eps
        y_add = f(type(x).from_numpy(base + h)).numpy().reshape(-1)
        y_sub = f(type(x).from_numpy(base - h)).numpy().reshape(-1)
        jac[i, :] = (y_add - y_sub) / (2 * eps)
    return jac


def gradcheck(f, x, eps=1e-3, atol=5e-4, rtol=5e-4) -> bool:
    return np.allclose(jacobian(f, x), numerical_jacobian(f, x, eps),
                       atol=atol, rtol=rtol)


def assert_gradcheck(f, x, eps=1e-3, atol=5e-4, rtol=5e-4):
    np.testing.assert_allclose(jacobian(f, x), numerical_jacobian(f, x, eps),
                               atol=atol, rtol=rtol)
