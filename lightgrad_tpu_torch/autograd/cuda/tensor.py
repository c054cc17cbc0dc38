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

from .. import tensor as _tape
from ..tensor import AbstractTensor
from ...utils.profiler import set_sync_fn
from . import device

__all__ = ["CudaTensor", "torch_dtype", "upload", "set_device_init"]

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


def upload(a, dev, dtype=None) -> torch.Tensor:
    """Host array ``a`` as a tensor on ``dev`` (of ``dtype``, else of the
    array's own kind), a copy that never aliases the caller's array.  Inside
    a step that ``jit`` records or runs, the step answers instead: a host
    array there is a constant of the step, uploaded once by the recording
    step and read in place by every later run."""
    if _tape._trace is not None:
        return _tape._trace.on_upload(np.asarray(a), torch.device(dev),
                                      dtype)
    t = torch.tensor(a, device=dev)
    return t if dtype is None else t.to(dtype)


def _from_host(a, dtype=None):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes; torch cannot wrap it
        a = a.astype(np.float32)
    dt = torch_dtype(dtype if dtype is not None else a.dtype)
    return upload(a, device.default_device(), dt)


# where the initializers draw (``set_device_init``): the tape's device
# generators until a call says otherwise, a seeded device stream of their
# own, or host numpy (``None``)
_TAPE_STREAM = object()
_init_seed = _TAPE_STREAM
_init_generators = {}


def set_device_init(seed=None):
    """Route ``Tensor.uniform`` (and so ``xavier`` and every layer's
    initializer) as the JAX package's ``set_device_init`` does: a seed puts
    them on a device stream of their own, seeded by it (the initializers
    move no bytes to the card); ``None`` draws them on the host with
    ``np.random.uniform``, so ``np.random.seed`` repeats them, and uploads
    them.  Until the first call they draw from the generator of
    ``lightgrad_tpu_torch.random`` (the port's divergence: the JAX
    package starts on the host)."""
    global _init_seed
    _init_seed = None if seed is None else int(seed)
    _init_generators.clear()


def _init_generator(dev):
    g = _init_generators.get(dev)
    if g is None:
        g = _init_generators[dev] = torch.Generator(device=dev)
        g.manual_seed(_init_seed)
    return g


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
        """U(low, high) float32: drawn on the device from the generator of
        ``lightgrad_tpu_torch.random``, or from the seeded stream that
        :func:`set_device_init` gave, or on the host by
        ``np.random.uniform`` after ``set_device_init(None)``."""
        if _init_seed is None:
            a = np.random.uniform(low, high, size=shape).astype(np.float32)
            return CudaTensor(a, requires_grad=requires_grad)
        from ... import random

        dev = device.default_device()
        gen = random.generator(dev) if _init_seed is _TAPE_STREAM \
            else _init_generator(dev)
        u = torch.rand(shape, generator=gen, device=dev)
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
        """A host copy (bfloat16 comes back as float32: numpy has none); of
        a sharded buffer (``DTensor``), the whole array.  Refused inside a
        step ``jit`` captures or runs: a host read there would wait for the
        card."""
        if _tape._trace is not None:
            _tape._trace.on_host_read(self)
        d = self.data.detach()
        if hasattr(d, "full_tensor"):
            d = d.full_tensor()
        if d.dtype == torch.bfloat16:
            d = d.float()
        # a CPU buffer is copied too: a compiled step's slots are written in
        # place at every call
        return d.numpy().copy() if d.device.type == "cpu" else d.cpu().numpy()


AbstractTensor.register_backend("cuda", CudaTensor)
