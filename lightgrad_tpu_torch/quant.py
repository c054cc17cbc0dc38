"""Post-training int8 quantization of the lightgrad tape's layers.

Counterpart of ``lightgrad_tpu/quant.py``: converts a trained float model in
place,

    quantize_module(model)     # every nn.Linear -> QuantLinear

Scheme: symmetric per-output-channel int8 weights (``scale = absmax/127``,
no zero-point), dynamic per-row int8 activations quantized inside the op
(``CudaTensor.quant_linear``, autograd/cuda/ops.py).  The epilogue applies
both scales in f32 and casts back to the activation dtype.  Backward is the
straight-through estimator through the dequantized weight, so a quantized
model can still be fine-tuned.

The torch.nn GPT-2 model of ``models/gpt.py`` quantizes its decode path
with ``GPT.quantize_serving``; ``quantize_module`` converts the tape's
``nn.Linear`` only.
"""

import numpy as np
import torch

from . import nn

__all__ = ["quantize_weight", "QuantLinear", "quantize_module"]


def quantize_weight(w: np.ndarray, axis: int = 1):
    """Symmetric per-channel int8 quantization of a (out, in) weight.

    Returns ``(wq int8, scale f32)`` with ``scale`` shaped (out,) when
    reducing over ``axis=1``.  ``absmax==0`` rows (dead channels) get
    scale 0 -- they dequantize to exactly 0, matching the float weight.
    """
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=axis)
    scale = absmax / 127.0
    safe = np.where(scale == 0.0, 1.0, scale)
    wq = np.clip(np.round(w / np.expand_dims(safe, axis)), -127, 127)
    return wq.astype(np.int8), scale.astype(np.float32)


class QuantLinear(nn.Module):
    """Drop-in int8 replacement for :class:`nn.Linear`.

    Holds the quantized weight and its per-channel scale as *buffers* (not
    trained; ``parameters()`` yields only the float bias, if any), so
    ``state_dict`` / ``load_parameters`` round-trip the quantized model
    exactly.
    """

    def __init__(self, wq, wscale, bias=None):
        super().__init__()
        self.register_buffer("weight_q", wq)
        self.register_buffer("weight_scale", wscale)
        self.bias = bias
        self.out_features, self.in_features = wq.shape

    @classmethod
    def from_linear(cls, lin: "nn.Linear") -> "QuantLinear":
        """The layer's weight quantized on the host, as the JAX package
        does; the buffers go to the weight's device."""
        w = lin.weight
        wq, ws = quantize_weight(w.numpy(), axis=1)
        return cls(*(type(w)(torch.from_numpy(a).to(w.device),
                             requires_grad=False) for a in (wq, ws)),
                   bias=lin.bias)

    def forward(self, x):
        return x.quant_linear(self.weight_q, self.weight_scale, self.bias)


def quantize_module(module: "nn.Module",
                    min_features: int = 0) -> "nn.Module":
    """Recursively replace every ``nn.Linear`` with a :class:`QuantLinear`.

    ``min_features`` skips small layers (e.g. classifier heads on tiny
    label spaces) where quantization error is not worth the bytes saved.
    Returns the module, converted in place.
    """
    def _maybe(lin):
        return (QuantLinear.from_linear(lin)
                if min(lin.weight.shape) >= min_features else lin)

    if isinstance(module, nn.ModuleList):
        # ModuleList doubles as a python list: replace through __setitem__
        # so iteration and indexing see the converted layer too
        for i, sub in enumerate(list(module)):
            if isinstance(sub, nn.Linear):
                new = _maybe(sub)
                if new is not sub:
                    module[i] = new
            else:
                quantize_module(sub, min_features=min_features)
        return module
    for name, sub in list(module._modules.items()):
        if isinstance(sub, nn.Linear):
            new = _maybe(sub)
            if new is not sub:
                setattr(module, name, new)
        else:
            quantize_module(sub, min_features=min_features)
    return module
