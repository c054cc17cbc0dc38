"""Mixed-precision training: bf16 compute with f32 master weights.

Counterpart of ``lightgrad_tpu/amp.py``:

* :func:`set_matmul_precision` sets the float32 matmul kernel's precision:
  'highest' (the default: three tf32 passes, float32 accuracy, as the TPU's
  HIGHEST passes) or 'default' (operands rounded to bf16, one pass);
* :func:`cast_module` casts a module's parameters to a dtype in place;
* :class:`GradScaler` is dynamic loss scaling with tensor-resident state;
* :class:`MixedPrecision` is the master-weight recipe: f32 masters are
  snapshotted before the module is cast to the compute dtype; each
  ``step()`` upcasts the compute gradients, unscales them, replaces NaN and
  infinities, hands them to the optimizer over the masters, gates a
  non-finite step away on the device, and requantizes the masters into the
  compute parameters.  bf16 rounding therefore never accumulates across
  steps.

Both take a ``torch.nn.Module`` (GPT-2's trainer: ``Parameter``s cast by
``Module.to`` and written in place, gradients in ``.grad``) or a lightgrad
tape module (BERT, ResNet, LLaMA, NeoX: each parameter rebound through
``Module.map_parameters``, as the JAX package casts, and each step's
masters and compute parameters rebound to fresh buffers, as the tape's
value semantics ask); the module's type decides.  A tape module's buffers
(BatchNorm's running statistics) keep their dtype, as in the JAX package.

Nothing here reads a tensor on the host, so a step never waits for the
device.
"""

import torch

from .autograd import no_grad
from .autograd.cuda.tensor import torch_dtype
from .ops.matmul import set_precision as _set_precision

__all__ = ["set_matmul_precision", "cast_module", "GradScaler",
           "MixedPrecision"]


def set_matmul_precision(p: str) -> str:
    """'highest' (float32 accuracy, the default) or 'default' (bf16 passes)
    for the tape's float32 products; returns the previous setting."""
    return _set_precision(p)


def cast_module(module, dtype=torch.bfloat16):
    """Cast every floating parameter of ``module`` to ``dtype`` in place;
    returns the module.  A ``torch.nn.Module`` keeps its Parameter objects;
    a tape module's parameters are rebound to cast tensors that keep their
    ``requires_grad``."""
    if isinstance(module, torch.nn.Module):
        return module.to(dtype)
    dtype = torch_dtype(dtype)

    def cast(p):
        with no_grad():
            q = p.astype(dtype)
        return q.detach()._set_requires_grad(p.requires_grad)

    return module.map_parameters(cast)


class GradScaler:
    """Dynamic loss scaling with tensor-resident state.

    ``scale(loss)`` multiplies by the current scale; after the backward,
    :class:`MixedPrecision` computes a finite gate and calls
    :meth:`update`.  On an overflow step the scale is multiplied by
    ``backoff_factor``; after ``growth_interval`` consecutive good steps it
    is multiplied by ``growth_factor``.  All updates are scalar tensor
    arithmetic, with no host read."""

    def __init__(self, init_scale: float = 2.0 ** 15,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000, enabled: bool = True):
        self.enabled = enabled
        self._init = float(init_scale)
        self._gf, self._bf = float(growth_factor), float(backoff_factor)
        self._gi = int(growth_interval)
        self._scale = None   # scalar f32 tensor, made on first use
        self._count = None   # consecutive good steps

    def _materialize(self, device):
        if self._scale is None:
            self._scale = torch.tensor(self._init, dtype=torch.float32,
                                       device=device)
            self._count = torch.zeros((), device=device)

    def scale(self, loss):
        if not self.enabled:
            return loss
        self._materialize(loss.device)
        return loss * self._scale

    def inv_scale(self, device):
        if not self.enabled:
            return None
        self._materialize(device)
        return self._scale ** -1.0

    @torch.no_grad()
    def update(self, ok) -> None:
        """``ok``: scalar {0,1} tensor -- 1 iff every gradient was finite."""
        if not self.enabled:
            return
        self._materialize(ok.device)
        grown = ((self._count + 1.0) >= float(self._gi)).float()
        new_scale = self._scale * (
            ok * (1.0 + (self._gf - 1.0) * grown) + (1.0 - ok) * self._bf)
        new_count = (self._count + 1.0) * ok * (1.0 - grown)
        self._scale.copy_(new_scale)
        self._count.copy_(new_count)

    def scale_value(self) -> float:
        """The current scale, read on the host."""
        return float(self._scale) if self._scale is not None else self._init


class MixedPrecision:
    """Master-weight AMP: compute in ``compute_dtype``, optimize f32 masters.

    Usage::

        mp = amp.MixedPrecision(model, lambda ps: optim.AdamW(ps, lr=3e-4))
        loss = loss_fn(model(x))
        mp.zero_grad()
        mp.scale(loss).backward()
        mp.step()
    """

    def __init__(self, model, optimizer_factory,
                 compute_dtype=torch.bfloat16, scaler: GradScaler = None):
        self.model = model
        self.compute_dtype = compute_dtype = torch_dtype(compute_dtype)
        self.scaler = scaler
        # a tape module's tensors are rebound, never written in place
        self._tape = not isinstance(model, torch.nn.Module)
        with torch.no_grad():
            if self._tape:
                self.masters = [type(p)(p.data.float(), requires_grad=True)
                                for p in model.parameters()]
            else:
                self.masters = [p.detach().float().clone().requires_grad_(
                    True) for p in model.parameters()]
        cast_module(model, compute_dtype)
        self.compute_params = list(model.parameters())
        if len(self.compute_params) != len(self.masters):
            raise RuntimeError("MixedPrecision: the cast changed the "
                               "module's parameter list")
        self.optim = optimizer_factory(self.masters)
        if scaler is not None and self.masters:
            scaler._materialize(self.masters[0].data.device)

    def zero_grad(self):
        for p in self.compute_params:
            if self._tape:
                p.zero_grad()
            else:
                p.grad = None

    def scale(self, loss):
        return self.scaler.scale(loss) if self.scaler is not None else loss

    def _grads(self):
        if not self._tape:
            return [p.grad if p.grad is not None else torch.zeros_like(p)
                    for p in self.compute_params]
        return [p.grad.data if p.grad is not None else torch.zeros_like(
            p.data) for p in self.compute_params]

    def _set_master_grad(self, m, g32):
        if not self._tape:
            m.grad = g32
        elif m.grad is None:
            m.add_grad(type(m)(g32, requires_grad=False))
        else:
            m.grad._set_data(g32)

    @torch.no_grad()
    def step(self):
        grads = self._grads()
        # finite gate, on the device: 1 iff every gradient is finite
        ok = torch.stack([torch.isfinite(g).all() for g in grads]) \
            .all().float()
        inv = (self.scaler.inv_scale(ok.device)
               if self.scaler is not None else None)
        for g, m in zip(grads, self.masters):
            # NaN and infinities to 0, as the JAX package's nan_to_num
            g32 = g.float().nan_to_num(0.0, 0.0, 0.0)
            self._set_master_grad(m, g32 * inv if inv is not None else g32)
        self.optim._gate = ok
        try:
            self.optim.step()
        finally:
            self.optim._gate = None
        for p, m in zip(self.compute_params, self.masters):
            if self._tape:
                # requantize: round to nearest even, a fresh buffer
                p._set_data(m.data.to(self.compute_dtype))
            else:
                p.copy_(m)
        if self.scaler is not None:
            self.scaler.update(ok)
