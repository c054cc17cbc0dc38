"""Module system and layers of the lightgrad tape.

Counterpart of ``lightgrad_tpu/nn.py`` for the layers the ported paths
need, with its names and parameter names: ``Module`` (``parameters``,
``named_parameters``, ``register_buffer``, ``named_buffers``,
``load_parameters``, ``state_dict``, ``train``/``eval``), ``ModuleList``,
``Sequential``, ``Linear``,
``Embedding``, ``LayerNorm``, ``Dropout``, ``ReLU``, ``GELU``, ``Tanh``,
``Flatten``.  Parameters are lightgrad tensors (``CudaTensor``).

The JAX package's ``register_param_or_module`` tells its ``jit`` step
compiler to drop programs that captured a rebound parameter; ``jit`` is not
ported, so there is nothing to tell.  The ``torch.nn`` layers of the GPT-2
model are in ``models/_torch_layers.py``.
"""

import numpy as np
import torch

from .autograd import AbstractTensor, Tensor
from .autograd.cuda.tensor import torch_dtype

__all__ = ["Module", "ModuleList", "Sequential", "Linear", "LayerNorm",
           "Embedding", "Dropout", "ReLU", "GELU", "Tanh", "Flatten"]


def _fan_in_uniform(shape, fan_in):
    """Layer-default initializer ``U(-1/sqrt(fan_in), +1/sqrt(fan_in))``."""
    bound = 1.0 / float(np.sqrt(fan_in))
    return Tensor.uniform(-bound, bound, shape)


class Module:
    def __init__(self):
        object.__setattr__(self, "_params", {})
        object.__setattr__(self, "_modules", {})
        object.__setattr__(self, "_buffers", {})
        object.__setattr__(self, "training", True)

    def register_buffer(self, name: str, tensor):
        """Non-parameter persistent state (``QuantLinear``'s int8 weight and
        its scales): saved by ``state_dict`` and loaded by
        ``load_parameters``, never yielded by ``parameters()``, so no
        optimizer touches it."""
        self._buffers[name] = tensor
        object.__setattr__(self, name, tensor)
        return tensor

    def named_buffers(self, prefix: str = "", separator: str = "."):
        pfx = (prefix + separator) if prefix else ""
        for name, b in self._buffers.items():
            yield pfx + name, b
        for name, m in self._modules.items():
            yield from m.named_buffers(prefix=pfx + name, separator=separator)

    def forward(self, *args, **kwargs):
        raise NotImplementedError()

    def train(self, mode: bool = True):
        """Set training mode recursively (affects Dropout)."""
        object.__setattr__(self, "training", mode)
        for m in self._modules.values():
            m.train(mode)
        return self

    def eval(self):
        return self.train(False)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def __setattr__(self, name, val):
        if isinstance(val, (AbstractTensor, Module)):
            self.register_param_or_module(name, val)
        object.__setattr__(self, name, val)

    def register_param_or_module(self, name, val):
        if isinstance(val, AbstractTensor):
            self._modules.pop(name, None)
            self._params[name] = val
        elif isinstance(val, Module):
            self._params.pop(name, None)
            self._modules[name] = val
        return val

    def unregister_param_or_module(self, name):
        return self._params.pop(name, None) or self._modules.pop(name, None)

    def parameters(self):
        yield from self._params.values()
        for m in self._modules.values():
            yield from m.parameters()

    def named_parameters(self, prefix: str = "", separator: str = "."):
        prefix = (prefix + separator) if prefix else ""
        for name, p in self._params.items():
            yield prefix + name, p
        for name, m in self._modules.items():
            yield from m.named_parameters(prefix=prefix + name,
                                          separator=separator)

    def zero_grad(self):
        """Zero every parameter's gradient."""
        for p in self.parameters():
            p.zero_grad()
        return self

    def load_parameters(self, param_dict: dict, prefix: str = "",
                        separator: str = ".") -> None:
        """Rebind every parameter to the value under its name (a numpy array
        or a lightgrad tensor), keeping the parameter's device and dtype.
        The tensor objects stay the same, so an optimizer holding them
        sees the loaded values.  Buffers load the same way when their name
        is present and keep their value when it is not."""
        if prefix:
            prefix += separator
        for key, p in self._params.items():
            full = prefix + key
            if full not in param_dict:
                raise KeyError(f"{full} not found in param dict")
            _load_into(p, param_dict[full], full)
        for key, b in self._buffers.items():
            if prefix + key in param_dict:
                _load_into(b, param_dict[prefix + key], prefix + key)
        for key, m in self._modules.items():
            m.load_parameters(param_dict, prefix=prefix + key,
                              separator=separator)

    def state_dict(self, prefix: str = "", separator: str = ".") -> dict:
        """name -> np.ndarray snapshot of parameters and buffers."""
        pfx = (prefix + separator) if prefix else ""
        out = {pfx + n: p.numpy() for n, p in self._params.items()}
        out.update({pfx + n: b.numpy() for n, b in self._buffers.items()})
        for name, m in self._modules.items():
            out.update(m.state_dict(prefix=pfx + name, separator=separator))
        return out


def _load_into(t, new, name):
    """Set lightgrad tensor ``t`` to ``new`` (an array or a tensor) in
    place, keeping ``t``'s device and dtype."""
    if isinstance(new, AbstractTensor):
        new = new.data
    elif not isinstance(new, torch.Tensor):
        new = np.asarray(new)
        if new.dtype.name == "bfloat16":   # ml_dtypes
            new = new.astype(np.float32)
        new = torch.tensor(new)
    if tuple(new.shape) != t.shape:
        raise ValueError(f"shape mismatch for {name}: "
                         f"{tuple(new.shape)} != {t.shape}")
    t._set_data(new.to(device=t.data.device, dtype=t.dtype, copy=True))


class ModuleList(Module, list):
    def __init__(self, *elements):
        Module.__init__(self)
        list.__init__(self, elements)
        for i, e in enumerate(elements):
            self.register_param_or_module(str(i), e)

    def __setitem__(self, i, e):
        assert i < len(self)
        self.unregister_param_or_module(str(i))
        self.register_param_or_module(str(i), e)
        return list.__setitem__(self, i, e)

    def append(self, e):
        self.register_param_or_module(str(len(self)), e)
        return list.append(self, e)


class Sequential(ModuleList):
    """Chain of modules applied in order."""

    def forward(self, x):
        for m in self:
            x = m(x)
        return x


class ReLU(Module):
    def forward(self, x):
        return x.relu()


class GELU(Module):
    def forward(self, x):
        return x.gelu()


class Tanh(Module):
    def forward(self, x):
        return x.tanh()


class Flatten(Module):
    """Collapse all non-batch axes."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


def _amp_input(x, w):
    """Autocast boundary: a low-precision layer fed a wider float input
    computes in the weight's dtype; the cast is on the tape, so the input's
    gradient flows back in its own dtype."""
    wd, xd = torch_dtype(w.dtype), torch_dtype(x.dtype)
    if wd != xd and wd.itemsize < xd.itemsize and xd.is_floating_point:
        return x.astype(wd)
    return x


class Linear(Module):
    def __init__(self, in_feats: int, out_feats: int, bias: bool = True):
        super().__init__()
        self.weight = _fan_in_uniform((out_feats, in_feats), in_feats)
        self.bias = _fan_in_uniform((out_feats,), in_feats) if bias else None

    def forward(self, x):
        # the matmul kernel reads W.T through its strides: no copy
        y = _amp_input(x, self.weight) @ self.weight.T(1, 0)
        return y + self.bias if self.bias is not None else y


class LayerNorm(Module):
    def __init__(self, shape, eps: float = 1e-5):
        super().__init__()
        self.shape = tuple(shape) if isinstance(shape, (tuple, list)) \
            else (shape,)
        self.eps = eps
        self.weight = Tensor.ones(self.shape)
        self.bias = Tensor.zeros(self.shape)

    def forward(self, x):
        if tuple(x.shape[-len(self.shape):]) != self.shape:
            raise ValueError(f"LayerNorm shape mismatch: {x.shape} vs "
                             f"{self.shape}")
        return x.layernorm(self.weight, self.bias, eps=self.eps)


class Embedding(Module):
    """Token id -> vector gather."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.weight = Tensor.xavier((num_embeddings, embedding_dim))

    def forward(self, ids):
        return self.weight[ids]


class Dropout(Module):
    """Inverted dropout; identity in eval mode (``module.eval()``)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return x.dropout(p=self.p, training=self.training)
