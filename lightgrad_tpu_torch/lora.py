"""LoRA: low-rank adaptation for parameter-efficient fine-tuning.

Counterpart of ``lightgrad_tpu/lora.py`` (arXiv:2106.09685): a frozen
Linear ``W`` learns a rank-r update, ``W x + (alpha / r) * B A x`` with
``A (r, in)`` uniform in +-1/sqrt(in) and ``B (out, r)`` zero, so training
starts at the pretrained function.  ``merge_lora`` folds ``scaling * B @ A``
into the base weight in place and thaws every parameter.

Both model worlds, dispatched by module type: a ``torch.nn`` model (GPT-2;
its ``torch.nn.Linear``s wrapped by :class:`TorchLoRALinear`, the adapters
``nn.Parameter``s) or a lightgrad tape model (LLaMA, BERT, NeoX; its
``nn.Linear``s wrapped by :class:`LoRALinear`, the adapter products on the
tape's matmul kernel).  ``A`` is drawn from ``generator``; when it is None,
from torch's default generator (``torch.nn``) or the device's generator of
``lightgrad_tpu_torch.random`` (the tape).  The adapters are float32; over
a narrower base (bfloat16) the adapter path runs in float32 and its delta
is rounded to the base's dtype before the add (the JAX package would widen
the layer's output instead).
As in the JAX package, a scanned stack's Linears are not wrapped: they are
views of stacked parameters.

    model, cfg = Llama.from_pretrained(...)
    lora.apply_lora(model, rank=8, targets=("q_proj", "v_proj"))
    opt = AdamW(lora.lora_parameters(model), lr=1e-4)
    ... train ...
    lora.merge_lora(model)        # back to plain Linears, weights updated
"""

import numpy as np
import torch

from . import nn
from .autograd import Tensor, no_grad

__all__ = ["LoRALinear", "TorchLoRALinear", "apply_lora", "lora_parameters",
           "merge_lora", "lora_state_dict", "mark_only_lora_trainable"]

_ADAPTERS = ("lora_A", "lora_B")


def _draw_a(rank, in_f, device, generator):
    """``A``: U(-1/sqrt(in), 1/sqrt(in)) float32, as ``uniform`` draws."""
    bound = 1.0 / float(np.sqrt(in_f))
    u = torch.rand((rank, in_f), generator=generator, device=device,
                   dtype=torch.float32)
    return u * (2 * bound) - bound


class LoRALinear(nn.Module):
    """A frozen tape ``nn.Linear`` plus a trainable rank-``r`` bypass:
    ``forward(x) = base(x) + dropout(x) @ A.T @ B.T * (alpha / r)``."""

    def __init__(self, base: nn.Linear, rank: int, alpha: float = None,
                 dropout: float = 0.0, generator=None):
        super().__init__()
        out_f, in_f = base.weight.shape
        self.base = base
        self.rank = int(rank)
        self.alpha = float(alpha if alpha is not None else rank)
        self.scaling = self.alpha / self.rank
        self.dropout = float(dropout)
        for p in base.parameters():
            p._set_requires_grad(False)
        dev = base.weight.data.device
        if generator is None:
            from . import random

            generator = random.generator(dev)
        self.lora_A = Tensor(_draw_a(self.rank, in_f, dev, generator))
        self.lora_B = Tensor(torch.zeros((out_f, self.rank), device=dev))

    def forward(self, x):
        y = self.base(x)
        h = x if x.dtype == self.lora_A.dtype else x.astype(self.lora_A.dtype)
        if self.dropout and self.training:
            h = h.dropout(p=self.dropout, training=True)
        delta = (h @ self.lora_A.T(1, 0)) @ self.lora_B.T(1, 0)
        if self.scaling != 1.0:
            delta = delta * self.scaling
        if delta.dtype != y.dtype:
            delta = delta.astype(y.dtype)
        return y + delta

    def unwrap(self) -> nn.Linear:
        """Merge ``scaling * B @ A`` into the base weight (in place: the
        same tensor, a new buffer) and return the re-thawed base."""
        w = self.base.weight
        with no_grad():
            delta = (self.lora_B @ self.lora_A) * self.scaling
            if delta.dtype != w.dtype:
                delta = delta.astype(w.dtype)
            w._set_data((w + delta).data)
        for p in self.base.parameters():
            p._set_requires_grad(True)
        return self.base


class TorchLoRALinear(torch.nn.Module):
    """:class:`LoRALinear` for a ``torch.nn.Linear`` (the GPT-2 model)."""

    def __init__(self, base: torch.nn.Linear, rank: int, alpha: float = None,
                 dropout: float = 0.0, generator=None):
        super().__init__()
        out_f, in_f = base.weight.shape
        self.rank = int(rank)
        self.alpha = float(alpha if alpha is not None else rank)
        self.scaling = self.alpha / self.rank
        self.dropout = float(dropout)
        dev = base.weight.device
        # registered before the base: the JAX layer's parameter order
        self.lora_A = torch.nn.Parameter(_draw_a(self.rank, in_f, dev,
                                                 generator))
        self.lora_B = torch.nn.Parameter(torch.zeros((out_f, self.rank),
                                                     device=dev))
        self.base = base
        base.requires_grad_(False)

    def forward(self, x):
        y = self.base(x)
        h = x.to(self.lora_A.dtype)
        if self.dropout and self.training:
            h = torch.nn.functional.dropout(h, self.dropout, training=True)
        delta = (h @ self.lora_A.T) @ self.lora_B.T
        if self.scaling != 1.0:
            delta = delta * self.scaling
        return y + delta.to(y.dtype)

    @torch.no_grad()
    def unwrap(self) -> torch.nn.Linear:
        w = self.base.weight
        w.add_(((self.lora_B @ self.lora_A) * self.scaling).to(w.dtype))
        self.base.requires_grad_(True)
        return self.base


def _children(module):
    if isinstance(module, torch.nn.Module):
        return list(module.named_children())
    return list(module._modules.items())


def _walk_linears(module, prefix=""):
    for name, sub in _children(module):
        full = f"{prefix}.{name}" if prefix else name
        if (isinstance(sub, (nn.Linear, torch.nn.Linear))
                and not isinstance(sub, (LoRALinear, TorchLoRALinear))):
            yield module, name, full, sub
        else:
            yield from _walk_linears(sub, full)


def apply_lora(model, rank: int = 8, alpha: float = None,
               targets=("q_proj", "v_proj"), dropout: float = 0.0,
               freeze_rest: bool = True, generator=None):
    """Wrap every Linear whose attribute name is in ``targets`` with a LoRA
    layer; optionally freeze every other parameter.  Returns the wrapped
    layers' paths."""
    targets = set(targets) if targets is not None else None
    wrapped = []
    for parent, name, full, lin in _walk_linears(model):
        if targets is not None and name not in targets:
            continue
        cls = TorchLoRALinear if isinstance(lin, torch.nn.Module) \
            else LoRALinear
        setattr(parent, name, cls(lin, rank, alpha, dropout, generator))
        wrapped.append(full)
    if not wrapped:
        raise ValueError(f"no Linear matched targets {sorted(targets or ())}")
    if freeze_rest:
        mark_only_lora_trainable(model)
    return wrapped


def _is_adapter(name):
    return name.rsplit(".", 1)[-1] in _ADAPTERS


def mark_only_lora_trainable(model):
    """Freeze every parameter except lora_A / lora_B (embedding tables,
    norms, biases included -- the strict LoRA recipe)."""
    for name, p in model.named_parameters():
        if isinstance(p, torch.Tensor):
            p.requires_grad_(_is_adapter(name))
        else:
            p._set_requires_grad(_is_adapter(name))
    return model


def lora_parameters(model):
    """The trainable adapter tensors (pass to the optimizer)."""
    return [p for n, p in model.named_parameters() if _is_adapter(n)]


def lora_state_dict(model) -> dict:
    """Adapter-only state (numpy, float32), loadable into a model that
    already has the same ``apply_lora`` layout."""
    return {n: (p.detach().float().cpu().numpy()
                if isinstance(p, torch.Tensor) else p.numpy())
            for n, p in model.named_parameters() if _is_adapter(n)}


def merge_lora(model):
    """Fold every adapter into its base weight, restore plain Linears and
    re-thaw all parameters.  Returns the merged layers' paths."""
    merged = []

    def walk(module, prefix=""):
        for name, sub in _children(module):
            full = f"{prefix}.{name}" if prefix else name
            if isinstance(sub, (LoRALinear, TorchLoRALinear)):
                setattr(module, name, sub.unwrap())
                merged.append(full)
            else:
                walk(sub, full)

    walk(model)
    for p in model.parameters():
        if isinstance(p, torch.Tensor):
            p.requires_grad_(True)
        else:
            p._set_requires_grad(True)
    return merged
