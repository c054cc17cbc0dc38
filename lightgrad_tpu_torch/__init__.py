"""lightgrad_tpu_torch: the PyTorch / CUDA port of lightgrad_tpu.

This package imports ``torch`` and never ``jax``.  Its modules mirror the
JAX package's names.  Two slices are ported: serving (GPT-2 KV decoding and
the continuous-batching engine) and training (the differentiable GPT-2
forward, losses, optimizers and master-weight AMP).  Both run on
hand-written Hopper kernels on a CUDA device and on their plain PyTorch
versions on the CPU."""

from . import amp, autograd, loss, nn, ops, optim
from .models import GPT, GPTConfig, ByteTokenizer, generate_batch
from .serving import InferenceEngine, Request
from .weights import load_numpy_params

__all__ = ["amp", "autograd", "loss", "nn", "ops", "optim", "GPT",
           "GPTConfig", "ByteTokenizer", "generate_batch", "InferenceEngine",
           "Request", "load_numpy_params"]
