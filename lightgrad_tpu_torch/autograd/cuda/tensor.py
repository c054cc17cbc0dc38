"""The CUDA tensor: a ``torch.Tensor`` wrapped in the lightgrad tape.

Counterpart of ``lightgrad_tpu/autograd/tpu/tensor.py``.  ``.data`` is a
``torch.Tensor`` on an explicit device: new tensors go to
``device.default_device()``, and an op's result lies where its operands do.
Buffers have value semantics (see ``autograd/tensor.py``): ``copy`` aliases,
in-place ops rebind.  Kernel launches are asynchronous; ``numpy()`` and
``item()`` wait for the card.
"""

import numpy as np
import torch

from ..tensor import AbstractTensor
from ...utils.profiler import set_sync_fn
from . import device

__all__ = ["CudaTensor", "torch_dtype"]

set_sync_fn(lambda: device.synchronize())

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float32,
    np.dtype(np.float16): torch.float16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int32, np.dtype(np.int8): torch.int8,
    # MNIST's int16 labels: the integer kernels take int32
    np.dtype(np.int16): torch.int32,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype for ``dtype``: a torch dtype, a numpy dtype or type, or
    a name ('float32', 'bfloat16', ...).  64-bit types narrow to 32 bits,
    as the JAX package's 32-bit mode does."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) \
        or str(dtype)
    if name == "bfloat16":
        return torch.bfloat16
    return _NP_TO_TORCH[np.dtype(name)]


def _from_host(a, dtype=None):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes; torch cannot wrap it
        a = a.astype(np.float32)
    dt = torch_dtype(dtype if dtype is not None else a.dtype)
    # torch.tensor copies: the tensor never aliases the caller's array
    return torch.tensor(a, device=device.default_device()).to(dt)


class CudaTensor(AbstractTensor):
    def __init__(self, data, requires_grad: bool = True, dtype=None):
        if not isinstance(data, torch.Tensor):
            data = _from_host(data, dtype)
        elif dtype is not None and data.dtype != torch_dtype(dtype):
            data = data.to(torch_dtype(dtype))
        super().__init__(data, requires_grad=requires_grad)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape)

    @property
    def device(self) -> torch.device:
        return self.data.device

    # --- initializers ------------------------------------------------------
    @staticmethod
    def empty(shape, requires_grad: bool = True, dtype=torch.float32):
        return CudaTensor(torch.empty(shape, dtype=torch_dtype(dtype),
                                      device=device.default_device()),
                          requires_grad=requires_grad)

    @staticmethod
    def zeros(shape, requires_grad: bool = True, dtype=torch.float32):
        return CudaTensor(torch.zeros(shape, dtype=torch_dtype(dtype),
                                      device=device.default_device()),
                          requires_grad=requires_grad)

    @staticmethod
    def ones(shape, requires_grad: bool = True, dtype=torch.float32):
        return CudaTensor(torch.ones(shape, dtype=torch_dtype(dtype),
                                     device=device.default_device()),
                          requires_grad=requires_grad)

    @staticmethod
    def uniform(low, high, shape, requires_grad: bool = True):
        """U(low, high) float32, drawn on the device from the generator of
        ``lightgrad_tpu_torch.random``."""
        from ... import random

        dev = device.default_device()
        u = torch.rand(shape, generator=random.generator(dev), device=dev)
        return CudaTensor(u * (float(high) - float(low)) + float(low),
                          requires_grad=requires_grad)

    @staticmethod
    def from_numpy(a: np.ndarray, requires_grad: bool = True):
        """Integer and bool arrays keep their kind (64-bit narrowed to 32);
        everything else becomes float32, as in the JAX package."""
        a = np.asarray(a)
        dtype = None if a.dtype.kind in "iub" else np.float32
        return CudaTensor(_from_host(a, dtype), requires_grad=requires_grad)

    def copy(self, requires_grad: bool = True):
        # value semantics: aliasing is a correct zero-cost copy
        return CudaTensor(self.data, requires_grad=requires_grad)

    def numpy(self) -> np.ndarray:
        """A host copy (bfloat16 comes back as float32: numpy has none)."""
        d = self.data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.cpu().numpy()


AbstractTensor.register_backend("cuda", CudaTensor)
