"""Two tapes.  The lightgrad tape -- ``Tensor`` (= ``CudaTensor``),
``Function``, ``Gradients``, and the numpy oracle ``CpuTensor`` -- ported
from ``lightgrad_tpu.autograd``; and
the ``torch.autograd.Function``s ``attention``, ``layernorm`` and ``matmul``
of the ``torch.nn`` GPT-2 model, and ``flash_block``."""

from .grads import Gradients, no_grad
from .function import Function, composite
from .tensor import AbstractTensor
from . import ops  # install device-agnostic derived ops / dunders
from .ops import attention, flash_block, layernorm, matmul
from .cpu import CpuTensor
from .cuda import CudaTensor

# the default tensor: the CUDA backend, as TpuTensor is the JAX package's
Tensor = CudaTensor

__all__ = ["Gradients", "no_grad", "Function", "composite", "AbstractTensor",
           "CpuTensor", "CudaTensor", "Tensor", "ops", "attention",
           "flash_block", "layernorm", "matmul"]
