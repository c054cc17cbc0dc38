"""Carrying weights across from the JAX package.

``load_numpy_params(model, named)`` copies ``{name: array}`` -- for example
``{n: np.asarray(t.data) for n, t in jax_model.named_parameters()}`` -- into
the port's model: a ``torch.nn.Module`` (GPT-2) or a lightgrad
``nn.Module`` (BERT, ResNet), the latter through its ``load_parameters``.
A lightgrad module takes its buffers too (BatchNorm's running statistics),
so the JAX model's whole ``state_dict()`` loads.  Both packages store
Linear weights as torch's (out, in) and convolution kernels as (out, in,
*K), so nothing is transposed; names and shapes must match exactly.
"""

import numpy as np
import torch

from . import nn

__all__ = ["load_numpy_params"]


@torch.no_grad()
def load_numpy_params(model, named: dict):
    params = dict(model.named_parameters())
    if isinstance(model, nn.Module):
        params.update(model.named_buffers())
    missing = sorted(set(params) - set(named))
    extra = sorted(set(named) - set(params))
    if missing or extra:
        raise KeyError(f"load_numpy_params: missing {missing}, "
                       f"unexpected {extra}")
    arrays = {}
    for name, t in params.items():
        arr = np.asarray(named[name])
        if arr.dtype.name == "bfloat16":   # ml_dtypes; torch cannot wrap it
            arr = arr.astype(np.float32)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"load_numpy_params: {name} has shape "
                             f"{tuple(arr.shape)}, the model {tuple(t.shape)}")
        arrays[name] = arr
    # checked all before changing any
    if isinstance(model, nn.Module):
        model.load_parameters(arrays)   # rebinds each tensor's storage
    else:
        for name, t in params.items():
            t.copy_(torch.tensor(arrays[name]))
    model.__dict__.pop("_kv_fns", None)    # decode functions hold old weights
    return model
