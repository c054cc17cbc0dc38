"""Module system and layers of the lightgrad tape.

Counterpart of ``lightgrad_tpu/nn.py`` for the layers the ported paths
need, with its names and parameter names: ``Module`` (``parameters``,
``named_parameters``, ``register_buffer``, ``named_buffers``,
``map_parameters``, ``load_parameters``, ``state_dict``,
``train``/``eval``), ``ModuleList``,
``Sequential``, ``Linear``, ``Conv2d``, ``ConvTranspose2d``,
``BatchNorm2d``, ``GroupNorm``, ``MaxPool2d``, ``AvgPool2d``,
``Embedding``, ``LayerNorm``, ``Dropout``, ``ReLU``, ``GELU``, ``Tanh``,
``Flatten`` and ``MoE``.  Parameters are lightgrad tensors (``CudaTensor``).

A buffer stays a buffer when an in-place op rebinds its attribute
(``self.running_mean *= ...``); in the JAX package that assignment also
files the buffer among the parameters.

The JAX package's ``register_param_or_module`` tells its ``jit`` step
compiler to drop programs that captured a rebound parameter; ``jit`` is not
ported, so there is nothing to tell.  The ``torch.nn`` layers of the GPT-2
model are in ``models/_torch_layers.py``.
"""

import math

import numpy as np
import torch

from .autograd import AbstractTensor, Tensor
from .autograd.cuda.tensor import torch_dtype

__all__ = ["Module", "ModuleList", "Sequential", "Linear", "Conv2d",
           "ConvTranspose2d", "BatchNorm2d", "LayerNorm", "Embedding",
           "Dropout", "ReLU", "GELU", "Tanh", "Flatten", "GroupNorm",
           "MaxPool2d", "AvgPool2d", "MoE"]


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
        if name in self._buffers:
            self._buffers[name] = val
        elif isinstance(val, (AbstractTensor, Module)):
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

    def map_parameters(self, fn):
        """Rebind every parameter to ``fn(parameter)``, recursively (e.g.
        ``lambda p: p.astype("bfloat16")`` to serve in bf16).  Decode
        functions built over the old tensors (``_kv_fns``) are dropped."""
        for key, p in list(self._params.items()):
            self.__setattr__(key, fn(p))
        for m in self._modules.values():
            m.map_parameters(fn)
        self.__dict__.pop("_kv_fns", None)
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


class Conv2d(Module):
    """2-D convolution.  ``pad`` takes an int (symmetric), a ``(lo, hi)``
    pair (asymmetric), or ``"same"`` (stride-1 output size == input size,
    even kernels too) / ``"valid"`` (no padding).  ``dilation`` spaces the
    kernel taps; ``groups`` splits the channels into independent
    convolutions (both channel counts divisible by it)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernelsize: int = 3, stride: int = 1, pad=None,
                 bias: bool = True, dilation: int = 1, groups: int = 1):
        super().__init__()
        assert in_channels % groups == 0 and out_channels % groups == 0, \
            f"groups={groups} must divide channels ({in_channels}, " \
            f"{out_channels})"
        fan_in = (in_channels // groups) * kernelsize * kernelsize
        self.w = _fan_in_uniform(
            (out_channels, in_channels // groups, kernelsize, kernelsize),
            fan_in)
        self.b = _fan_in_uniform((1, out_channels, 1, 1), fan_in) \
            if bias else None
        self.s, self.d, self.g = stride, dilation, groups
        k_eff = (kernelsize - 1) * dilation + 1
        if pad is None:
            pad = k_eff // 2
        if pad == "same":
            pad = ((k_eff - 1) // 2, k_eff // 2)
        elif pad == "valid":
            pad = 0
        assert isinstance(pad, (int, tuple)), f"bad pad spec {pad!r}"
        self.p = pad

    def forward(self, x):
        x = _amp_input(x, self.w)
        needs_pad = self.p != 0 and self.p != (0, 0)
        y = (x.pad(self.p) if needs_pad else x).conv(
            self.w, strides=self.s, dilation=self.d, groups=self.g)
        return y + self.b if self.b is not None else y


class ConvTranspose2d(Module):
    """2-D transposed convolution: torch's weight layout ``(in_channels,
    out_channels/groups, k, k)`` and output size, on the ``conv_transpose``
    composite."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernelsize: int = 3, stride: int = 1, pad: int = 0,
                 output_padding: int = 0, bias: bool = True,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        assert in_channels % groups == 0 and out_channels % groups == 0
        fan_in = (in_channels // groups) * kernelsize * kernelsize
        self.w = _fan_in_uniform(
            (in_channels, out_channels // groups, kernelsize, kernelsize),
            fan_in)
        self.b = _fan_in_uniform((1, out_channels, 1, 1), fan_in) \
            if bias else None
        self.s, self.p, self.op = stride, pad, output_padding
        self.d, self.g = dilation, groups

    def forward(self, x):
        y = _amp_input(x, self.w).conv_transpose(
            self.w, strides=self.s, dilation=self.d, groups=self.g,
            output_padding=self.op, pad=self.p)
        return y + self.b if self.b is not None else y


class BatchNorm2d(Module):
    """Batch normalization over (B, C, H, W) with running statistics.

    The running mean and variance are buffers: in ``state_dict``, never
    among the parameters.  In training they are updated under ``no_grad``
    by the tape's in-place ops, which rebind the same tensor objects; the
    variance tracked is the unbiased one, as torch's.  The update reads
    graph-free copies of the batch statistics: the JAX package's
    ``detach()`` cuts them from the tape in place, so its training gradient
    treats them as constants; here the gradient is the true one."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True):
        super().__init__()
        self.c = num_features
        self.eps, self.momentum = eps, momentum
        if affine:
            self.weight = Tensor.ones((num_features,))
            self.bias = Tensor.zeros((num_features,))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", Tensor.zeros(
            (num_features,), requires_grad=False))
        self.register_buffer("running_var", Tensor.ones(
            (num_features,), requires_grad=False))

    def forward(self, x):
        assert len(x.shape) == 4 and x.shape[1] == self.c, x.shape
        c = self.c
        if self.training:
            m = x.mean(axis=(0, 2, 3))
            d = x - m.reshape(1, c, 1, 1)
            v = (d * d).mean(axis=(0, 2, 3))
            n = x.shape[0] * x.shape[2] * x.shape[3]
            from .autograd import no_grad

            with no_grad():
                mom = self.momentum
                self.running_mean *= (1.0 - mom)
                self.running_mean += m.copy(requires_grad=False) * mom
                self.running_var *= (1.0 - mom)
                self.running_var += v.copy(requires_grad=False) * (
                    mom * n / max(n - 1, 1))
            xh = d / (v.reshape(1, c, 1, 1) + self.eps).pow(0.5)
        else:
            m = self.running_mean.reshape(1, c, 1, 1)
            v = self.running_var.reshape(1, c, 1, 1)
            xh = (x - m) / (v + self.eps).pow(0.5)
        if self.weight is not None:
            xh = xh * self.weight.reshape(1, c, 1, 1) \
                + self.bias.reshape(1, c, 1, 1)
        return xh


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


class GroupNorm(Module):
    """Group normalization: normalize over (C/groups, *spatial) per group,
    per-channel affine; no running statistics."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__()
        assert num_channels % num_groups == 0, (num_groups, num_channels)
        self.groups, self.channels, self.eps = num_groups, num_channels, eps
        if affine:
            self.weight = Tensor.ones((num_channels,))
            self.bias = Tensor.zeros((num_channels,))

    def forward(self, x):
        n, c = x.shape[0], x.shape[1]
        assert c == self.channels, (c, self.channels)
        xs = x.reshape(n, self.groups, -1)
        mu = xs.mean(axis=-1, keepdims=True)
        d = xs - mu
        var = (d * d).mean(axis=-1, keepdims=True)
        xn = (d * (var + self.eps) ** -0.5).reshape(*x.shape)
        if not hasattr(self, "weight"):
            return xn
        shape = (1, c) + (1,) * (len(x.shape) - 2)
        return xn * self.weight.reshape(*shape) + self.bias.reshape(*shape)


class MaxPool2d(Module):
    """Module over the ``max_pool2d`` op (torch semantics: stride defaults
    to the kernel, int padding pads with -inf)."""

    def __init__(self, kernel: int = 2, stride: int = None, padding: int = 0):
        super().__init__()
        self.kernel = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return x.max_pool2d(kernel=self.kernel, stride=self.stride,
                            padding=self.padding)


class AvgPool2d(Module):
    """Module over ``mean_pool`` (non-overlapping windows: stride ==
    kernel)."""

    def __init__(self, kernel: int = 2):
        super().__init__()
        self.kernel = (kernel, kernel) if isinstance(kernel, int) else kernel

    def forward(self, x):
        return x.mean_pool(kernel=self.kernel)


class Dropout(Module):
    """Inverted dropout; identity in eval mode (``module.eval()``)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return x.dropout(p=self.p, training=self.training)


class MoE(Module):
    """Mixture-of-experts FFN, the JAX package's class: stacked expert
    weights ``w1 (E, d, h)``, ``w2 (E, h, d)`` (and ``w3`` for SwiGLU
    experts), a bias-free ``router``, optional always-on shared experts
    ``ws1`` / ``ws2``.

    * ``dispatch="dense"``: every expert processes every token; the router
      softmax weights the mixture.
    * ``dispatch="top1"`` / ``"topk"``: each token routes to its top-k
      experts (k argmax passes, an exact tie to the lowest index), subject
      to a per-expert capacity ``ceil(k T / E * capacity_factor)``; a
      routing past it is dropped (its output is zero).  Slot positions come
      from a device ``cumsum``, the dispatch and combine are one-hot
      products, and the expert FFNs are batched products ``(E, C, d) @
      (E, d, h)`` through the matmul kernel.  Nothing is read on the host.

    After a routed forward, ``aux_loss`` (Switch load balancing on the
    first choice) and ``z_loss`` (router logsumexp squared) are plain
    attributes.  Slot positions are counted in float32 whatever the compute
    dtype: the JAX package counts them in the router's dtype, which under
    bf16 rounds positions past 256 and puts two tokens in one slot."""

    def __init__(self, dim: int, hidden: int, n_experts: int,
                 dispatch: str = "dense", capacity_factor: float = 1.25,
                 k: int = 2, normalize_gates: bool = True,
                 n_shared: int = 0, ffn: str = "gelu"):
        super().__init__()
        assert dispatch in ("dense", "top1", "topk"), dispatch
        assert ffn in ("gelu", "swiglu"), ffn
        self.n_experts = n_experts
        self.dispatch = dispatch
        self.capacity_factor = capacity_factor
        self.k = 1 if dispatch == "top1" else k
        assert 1 <= self.k <= n_experts, (self.k, n_experts)
        self.normalize_gates = normalize_gates
        self.router = Linear(dim, n_experts, bias=False)
        self.ffn = ffn
        self.w1 = _fan_in_uniform((n_experts, dim, hidden), dim)
        self.w2 = _fan_in_uniform((n_experts, hidden, dim), hidden)
        if ffn == "swiglu":
            # Mixtral's experts: w2(silu(w1 x) * w3 x)
            self.w3 = _fan_in_uniform((n_experts, dim, hidden), dim)
        self.n_shared = n_shared
        if n_shared:
            self.ws1 = _fan_in_uniform((n_shared, dim, hidden), dim)
            self.ws2 = _fan_in_uniform((n_shared, hidden, dim), hidden)

    def _shared(self, t, n_tok, dim):
        tb = t.reshape(1, n_tok, dim)
        return ((tb @ self.ws1).gelu() @ self.ws2).sum(axis=0)

    def _experts(self, xe):
        """Per-expert FFN on stacked input ``(E, n, d)`` -> ``(E, n, d)``."""
        if self.ffn == "swiglu":
            g = xe @ self.w1
            return (g.sigmoid() * g * (xe @ self.w3)) @ self.w2
        return (xe @ self.w1).gelu() @ self.w2

    def _dense(self, t, n_tok, dim):
        gates = self.router(t).softmax(axis=-1)      # (T, E)
        tb = t.reshape(1, n_tok, dim)                # broadcast over experts
        h = self._experts(tb)                        # (E, T, d)
        w = gates.T(1, 0).reshape(self.n_experts, n_tok, 1)
        return (h * w).sum(axis=0)                   # (T, d)

    @staticmethod
    def _argmax_onehot(scores):
        """First-match argmax one-hot along the last axis (no gradient): an
        exact tie goes to the lowest index, so no token is dispatched
        twice."""
        is_max = scores.eq(scores.max(axis=-1, keepdims=True))   # (T, E)
        earlier = is_max.cumsum(axis=-1) - is_max                # exclusive
        return is_max * (earlier * -1.0 + 1.0).gt(0.5)           # earlier == 0

    def _topk(self, t, n_tok, dim):
        n_exp, k = self.n_experts, self.k
        cap = max(1, math.ceil(k * n_tok / n_exp * self.capacity_factor))
        logits = self.router(t)                      # (T, E)
        probs = logits.softmax(axis=-1)

        # router z-loss (ST-MoE): mean squared logsumexp of the logits
        m = logits.max(axis=-1, keepdims=True)
        lse = (logits - m).exp().sum(axis=-1, keepdims=True).log() + m
        object.__setattr__(self, "z_loss", (lse * lse).mean())

        # route: k argmax passes, each masking the experts already chosen
        onehots, gates = [], []
        remaining = probs
        for _ in range(k):
            oh = self._argmax_onehot(remaining)
            onehots.append(oh)
            gates.append((probs * oh).sum(axis=-1, keepdims=True))
            if len(onehots) < k:
                remaining = remaining * (oh * -1.0 + 1.0)
        if self.normalize_gates and k > 1:
            denom = gates[0]
            for g in gates[1:]:
                denom = denom + g
            gates = [g / (denom + 1e-9) for g in gates]

        # Switch load-balancing loss on the first choice: E sum_e f_e P_e
        frac = onehots[0].mean(axis=0)               # (E,)
        mean_prob = probs.mean(axis=0)               # (E,)
        object.__setattr__(
            self, "aux_loss", (frac * mean_prob).sum() * float(n_exp))

        # capacity: slot positions by a device cumsum, choice-major (every
        # first choice claims its slot before any second choice), counted
        # in float32
        f32 = torch.float32
        slots = type(t)(torch.arange(cap, dtype=f32, device=t.data.device),
                        requires_grad=False).reshape(1, cap)
        disp = comb = filled = None
        for oh, gate in zip(onehots, gates):
            oh = oh if oh.dtype == f32 else oh.astype(f32)
            pos = oh.cumsum(axis=0) - oh             # (T, E) exclusive
            if filled is not None:
                pos = pos + filled
            keep = oh * (pos * -1.0 + float(cap)).gt(0.5)        # pos < cap
            kept = keep.sum(axis=0, keepdims=True)
            filled = kept if filled is None else filled + kept
            pos_tok = (pos * keep).sum(axis=-1, keepdims=True)   # (T, 1)
            poh = pos_tok.eq(slots)                  # (T, C) slot one-hot
            d = (keep.reshape(n_tok, n_exp, 1) * poh.reshape(n_tok, 1, cap))
            d = d.reshape(n_tok, n_exp * cap)
            if d.dtype != t.dtype:
                d = d.astype(t.dtype)
            disp = d if disp is None else disp + d
            dg = d * gate
            comb = dg if comb is None else comb + dg

        # expert FFN and combine
        xd = disp.T(1, 0) @ t                        # (E*C, d)
        h = self._experts(xd.reshape(n_exp, cap, dim))
        return comb @ h.reshape(n_exp * cap, dim)

    def forward(self, x):
        lead, dim = x.shape[:-1], x.shape[-1]
        t = x.reshape(-1, dim)                       # (T, d)
        n_tok = t.shape[0]
        if self.dispatch in ("top1", "topk"):
            y = self._topk(t, n_tok, dim)
        else:
            y = self._dense(t, n_tok, dim)
        if self.n_shared:
            y = y + self._shared(t, n_tok, dim)
        return y.reshape(*lead, dim)
