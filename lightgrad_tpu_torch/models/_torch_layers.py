"""``torch.nn`` layers of the GPT-2 model that call the port's fused ops.

Counterpart of the ``LayerNorm`` of ``lightgrad_tpu/nn.py`` for the
``torch.nn.Module`` GPT-2 (``models/gpt.py``).  The lightgrad layers are in
``lightgrad_tpu_torch/nn.py``.
"""

import torch

from ..autograd.ops import layernorm

__all__ = ["LayerNorm"]


class LayerNorm(torch.nn.Module):
    """Layer normalization over the trailing ``shape``, through the fused
    LayerNorm kernels.  Parameters ``weight`` (ones) and ``bias`` (zeros)."""

    def __init__(self, shape, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.shape = tuple(shape) if isinstance(shape, (tuple, list)) \
            else (shape,)
        self.eps = eps
        kw = {"device": device, "dtype": dtype}
        self.weight = torch.nn.Parameter(torch.ones(self.shape, **kw))
        self.bias = torch.nn.Parameter(torch.zeros(self.shape, **kw))

    def forward(self, x):
        if tuple(x.shape[-len(self.shape):]) != self.shape:
            raise ValueError(f"LayerNorm shape mismatch: {tuple(x.shape)} vs "
                             f"{self.shape}")
        return layernorm(x.contiguous(), self.weight, self.bias, self.eps)

    def extra_repr(self):
        return f"{self.shape}, eps={self.eps}"
