"""lightgrad_tpu_torch: the PyTorch / CUDA port of lightgrad_tpu.

This package imports ``torch`` and never ``jax``.  Its modules mirror the
JAX package's names; its serving slice (GPT-2 KV decoding and the
continuous-batching engine) runs on hand-written Hopper kernels on a CUDA
device and on their plain PyTorch versions on the CPU."""

from . import ops
from .models import GPT, GPTConfig, ByteTokenizer, generate_batch
from .serving import InferenceEngine, Request
from .weights import load_numpy_params

__all__ = ["ops", "GPT", "GPTConfig", "ByteTokenizer", "generate_batch",
           "InferenceEngine", "Request", "load_numpy_params"]
