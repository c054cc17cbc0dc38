"""lightgrad_tpu_torch: the PyTorch / CUDA port of lightgrad_tpu.

This package imports ``torch`` and never ``jax``.  Its modules mirror the
JAX package's names.  Ported so far: lightgrad's define-by-run tape
(``Tensor`` = ``CudaTensor``, ``Function``, ``no_grad``) with its op set,
the nn/loss/optim layers over it, int8 ``quant`` and BERT on it; and, on
``torch.autograd``, GPT-2 serving (KV decoding, the continuous-batching
engine, int8 weights and KV cache) and training (forward, losses,
optimizers, master-weight AMP).  The tape also carries the vision path:
convolution, BatchNorm and pooling layers, ResNet (``models.resnet18``,
``resnet20``) and the ``data`` pipeline (``DeviceDataset``, MNIST), and the
LLaMA family (``Llama``: LLaMA, Mistral's sliding window, Qwen2, Gemma),
trained on the tape and served through its KV functions, and the GPT-NeoX /
Pythia family (``NeoX``) on the tape.  Both
run on hand-written Hopper kernels on a CUDA device and on their plain
PyTorch versions on the CPU."""

from . import (amp, autograd, data, loss, models, nn, ops, optim, quant,
               random)
from .autograd import (AbstractTensor, CudaTensor, Function, Gradients,
                       Tensor, no_grad)
from .models import (GPT, GPTConfig, ByteTokenizer, Llama, LlamaConfig,
                     NeoX, NeoXConfig, RMSNorm, generate_batch)
from .serving import InferenceEngine, Request
from .weights import load_numpy_params

# tensor initializer shortcuts, as lightgrad_tpu/__init__.py has them
empty, zeros, ones = Tensor.empty, Tensor.zeros, Tensor.ones
uniform, xavier = Tensor.uniform, Tensor.xavier
from_numpy = Tensor.from_numpy


def einsum(spec: str, *operands):
    """``einsum("ab,bc->ac", a, b)``: differentiable contraction (method
    form ``a.einsum(spec, b)``; grammar in autograd/einsum_spec.py)."""
    return operands[0].einsum(spec, *operands[1:])


__all__ = ["amp", "autograd", "data", "loss", "models", "nn", "ops", "optim",
           "quant", "random",
           "AbstractTensor", "CudaTensor", "Function", "Gradients", "Tensor",
           "no_grad", "empty", "zeros", "ones", "uniform", "xavier",
           "from_numpy", "einsum", "GPT", "GPTConfig", "ByteTokenizer",
           "Llama", "LlamaConfig", "NeoX", "NeoXConfig", "RMSNorm",
           "generate_batch", "InferenceEngine", "Request",
           "load_numpy_params"]
