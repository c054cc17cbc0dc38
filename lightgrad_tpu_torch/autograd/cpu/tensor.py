"""The numpy tensor: the tape's golden oracle backend.

Counterpart of ``lightgrad_tpu/autograd/cpu/tensor.py``: float32 by
default, numpy storage, the whole initializer contract.  The CUDA backend
is tested against it (the reference's "compare with cpu" pattern): the
same numpy inputs go through ``CpuTensor`` and ``CudaTensor`` ops, and the
forwards and gradients must agree.

Registering it as backend "cpu" installs ``.cpu()`` on every tape tensor:
on a ``CudaTensor`` it means "a ``CpuTensor`` of the same values", as in
the JAX package, not torch's ``Tensor.cpu()``.  ``.cuda()`` goes back.
"""

import numpy as np

from ..tensor import AbstractTensor

__all__ = ["CpuTensor"]


class CpuTensor(AbstractTensor):
    def __init__(self, data, requires_grad: bool = True, dtype=np.float32):
        if not isinstance(data, np.ndarray):
            data = np.asarray(data)
        if dtype is not None and data.dtype != dtype:
            data = data.astype(dtype)
        if not data.flags.writeable:
            # e.g. views over another library's buffers
            data = data.copy()
        super().__init__(data, requires_grad=requires_grad)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape)

    # --- initializers ------------------------------------------------------
    @staticmethod
    def empty(shape, requires_grad: bool = True, dtype=np.float32):
        return CpuTensor(np.empty(shape, dtype=dtype),
                         requires_grad=requires_grad, dtype=dtype)

    @staticmethod
    def zeros(shape, requires_grad: bool = True, dtype=np.float32):
        return CpuTensor(np.zeros(shape, dtype=dtype),
                         requires_grad=requires_grad, dtype=dtype)

    @staticmethod
    def ones(shape, requires_grad: bool = True, dtype=np.float32):
        return CpuTensor(np.ones(shape, dtype=dtype),
                         requires_grad=requires_grad, dtype=dtype)

    @staticmethod
    def uniform(low, high, shape, requires_grad: bool = True):
        return CpuTensor(
            np.random.uniform(low, high, size=shape).astype(np.float32),
            requires_grad=requires_grad)

    @staticmethod
    def from_numpy(a: np.ndarray, requires_grad: bool = True):
        a = np.asarray(a)
        # integer arrays (labels, ids) keep their type; floats become f32
        dtype = a.dtype if a.dtype.kind in "iub" else np.float32
        return CpuTensor(a, requires_grad=requires_grad, dtype=dtype)

    def copy(self, requires_grad: bool = True):
        return CpuTensor(self.data.copy(), requires_grad=requires_grad,
                         dtype=self.data.dtype)

    def numpy(self) -> np.ndarray:
        return self.data


AbstractTensor.register_backend("cpu", CpuTensor)
