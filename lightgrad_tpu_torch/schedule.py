"""Learning-rate schedules.

Counterpart of ``lightgrad_tpu/schedule.py``: ``LRScheduler``, ``StepLR``,
``CosineAnnealingLR`` and ``WarmupCosine``, with its schedule values.  The
scheduler turns the optimizer's ``lr`` into a 0-d float32 tensor on the
parameters' device, and ``step()`` writes each new value into it in place.
A step that captured the tensor (a ``jit``-compiled step's CUDA graph,
``amp.MixedPrecision``) therefore sees every new value, and an optimizer
step reads the rate on the device, with no host synchronisation.  ``last_lr`` is the one host read;
``step()`` returns the value it wrote without reading it back.

    optim = lightgrad_tpu_torch.optim.Adam(model.parameters(), lr=3e-4)
    sched = lightgrad_tpu_torch.schedule.WarmupCosine(optim, warmup=100,
                                                      total=10_000)
    for batch in data:
        ...; optim.step()
        sched.step()

The schedule's arithmetic runs on the host in Python floats; the value is
rounded to float32 as it is written (the JAX package's
``np.asarray(v, np.float32)``).
"""

import math

import numpy as np
import torch

__all__ = ["LRScheduler", "StepLR", "CosineAnnealingLR", "WarmupCosine"]


class LRScheduler:
    """Base: owns the step counter and the tensor-resident lr."""

    def __init__(self, optimizer):
        self.optim = optimizer
        lr = optimizer.lr
        self.base_lr = float(lr.item() if isinstance(lr, torch.Tensor)
                             else lr)
        params = optimizer.parameters
        dev = params[0].device if params else None
        self._lr_t = torch.tensor(self.base_lr, dtype=torch.float32,
                                  device=dev)
        optimizer.lr = self._lr_t
        self.step_n = 0

    def get_lr(self) -> float:
        """Schedule value at the current step (host-side float math)."""
        raise NotImplementedError()

    @property
    def last_lr(self) -> float:
        return float(self._lr_t.item())

    def step(self) -> float:
        """Advance one step and write the new lr into the live tensor (a
        fill launched with the value, nothing read back); returns the new
        lr as written, float32-rounded."""
        self.step_n += 1
        v = float(np.float32(self.get_lr()))
        self._lr_t.fill_(v)
        return v


class StepLR(LRScheduler):
    """Multiply lr by ``gamma`` every ``step_size`` steps."""

    def __init__(self, optimizer, step_size: int, gamma: float = 0.1):
        super().__init__(optimizer)
        self.step_size, self.gamma = int(step_size), float(gamma)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.step_n // self.step_size)


class CosineAnnealingLR(LRScheduler):
    """Cosine decay from base lr to ``eta_min`` over ``t_max`` steps."""

    def __init__(self, optimizer, t_max: int, eta_min: float = 0.0):
        super().__init__(optimizer)
        self.t_max, self.eta_min = int(t_max), float(eta_min)

    def get_lr(self):
        t = min(self.step_n, self.t_max)
        cos = 0.5 * (1 + math.cos(math.pi * t / self.t_max))
        return self.eta_min + (self.base_lr - self.eta_min) * cos


class WarmupCosine(LRScheduler):
    """Linear warmup to base lr over ``warmup`` steps, then cosine decay to
    ``min_lr`` at ``total`` steps -- the standard transformer recipe."""

    def __init__(self, optimizer, warmup: int, total: int,
                 min_lr: float = 0.0):
        super().__init__(optimizer)
        assert total > warmup >= 0
        self.warmup, self.total = int(warmup), int(total)
        self.min_lr = float(min_lr)

    def get_lr(self):
        t = self.step_n
        if t < self.warmup:
            return self.base_lr * t / self.warmup
        frac = min(1.0, (t - self.warmup) / (self.total - self.warmup))
        cos = 0.5 * (1 + math.cos(math.pi * frac))
        return self.min_lr + (self.base_lr - self.min_lr) * cos
