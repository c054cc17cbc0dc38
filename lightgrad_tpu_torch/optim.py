"""Optimizers: SGD, Adam, AdamW, AdaBelief, Lion, RMSprop, Adagrad,
Adafactor, Muon; EMA shadow weights; global-norm gradient clipping.

Counterpart of ``lightgrad_tpu/optim.py``, with its update rules.
Parameters are either ``torch.nn.Parameter``s (or leaf tensors), whose
gradients are ``.grad`` and which are updated in place, or lightgrad
tensors (the tape's ``CudaTensor``), whose ``.data`` and ``.grad.data`` the
same rules read and which are rebound to a fresh buffer, as the tape's
value semantics ask.  ``zero_grad`` then calls each tensor's ``zero_grad``.
A parameter whose gradient is None is left alone.  Updates run under
``torch.no_grad()``; the optimizers' own state is updated in place.

All state is tensors on the parameters' device, the step counter included,
and the bias corrections are ``exp(t * ln beta)`` of that counter, so a step
needs no host sync.  ``amp.MixedPrecision`` sets ``_gate``, a {0, 1} scalar
tensor: a 0 gate skips the step algebraically (parameters AND state
untouched) without reading the tensor on the host.
"""

import contextlib
import math

import torch

from .autograd import AbstractTensor

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "AdaBelief", "Lion",
           "RMSprop", "Adagrad", "Adafactor", "Muon", "EMA",
           "clip_grad_norm"]


class Optimizer:
    def __init__(self, parameters):
        params = tuple(parameters)
        # lightgrad tensors: the rules run on their buffers, read afresh at
        # every step (load_parameters may have rebound them)
        self._tape = params if params and isinstance(
            params[0], AbstractTensor) else None
        self.parameters = tuple(p.data for p in params) \
            if self._tape else params
        # optional scalar {0,1} tensor set by amp.MixedPrecision: a 0 gate
        # algebraically skips the step
        self._gate = None

    def zero_grad(self):
        if self._tape is not None:
            for p in self._tape:
                p.zero_grad()
            return
        for p in self.parameters:
            p.grad = None

    def _grads(self):
        if self._tape is None:
            return [p.grad for p in self.parameters]
        return [None if p.grad is None else p.grad.data for p in self._tape]

    @torch.no_grad()
    def step(self):
        if self._tape is not None:
            self.parameters = tuple(p.data for p in self._tape)
        for i, (p, grad) in enumerate(zip(self.parameters, self._grads())):
            if grad is None:
                continue
            d = self.compute_delta(grad, i)
            d = d * self._gate if self._gate is not None else d
            if self._tape is None:
                p += d
            else:
                self._tape[i]._set_data((p + d).to(p.dtype))
        if self._tape is not None:
            self.parameters = tuple(p.data for p in self._tape)

    def compute_delta(self, grad, idx):
        raise NotImplementedError()

    def _gates(self):
        """(multiplier of an update, multiplier that keeps the old state):
        (1, 0) ungated, (gate, 1 - gate) under a gate."""
        if self._gate is None:
            return 1.0, 0.0
        return self._gate, 1.0 - self._gate

    def _scalar(self):
        dev = self.parameters[0].device if self.parameters else None
        return torch.zeros((), device=dev)


class SGD(Optimizer):
    """Stochastic gradient descent with optional momentum and L2 weight decay
    (torch-style: decay is folded into the gradient before momentum)."""

    def __init__(self, parameters, lr: float, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(parameters)
        self.lr, self.momentum, self.wd = lr, momentum, weight_decay
        self.velocity = ([torch.zeros_like(p) for p in self.parameters]
                         if momentum else None)

    def compute_delta(self, grad, i):
        if self.wd:
            grad = grad + self.parameters[i] * self.wd
        if self.velocity is None:
            return grad * (-self.lr)
        g1, keep = self._gates()
        v = self.velocity[i]
        v *= self.momentum * g1 + keep
        v += grad * (-self.lr) * g1
        return v


class Adam(Optimizer):
    """ADAptive Moment estimation; the step counter is a tensor."""

    def __init__(self, parameters, lr: float, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8):
        super().__init__(parameters)
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.t = self._scalar()
        self.m = [torch.zeros_like(p) for p in self.parameters]
        self.v = [torch.zeros_like(p) for p in self.parameters]

    @torch.no_grad()
    def step(self):
        self.t += 1.0 if self._gate is None else self._gate
        # beta^t as exp(t * ln(beta)); t is 0 only when every step so far
        # was gate-skipped, and the denominator then bumps to 1 (the moments
        # are all zero there, the correction only has to stay finite)
        d1 = 1.0 - (self.t * math.log(self.b1)).exp()
        d2 = 1.0 - (self.t * math.log(self.b2)).exp()
        self._bc1 = 1.0 / (d1 + (d1 == 0))
        self._bc2 = 1.0 / (d2 + (d2 == 0))
        super().step()

    def _second_moment_update(self, grad, i):
        return grad * grad

    def compute_delta(self, grad, i):
        g1, keep = self._gates()
        m, v = self.m[i], self.v[i]
        m *= self.b1 * g1 + keep
        m += grad * ((1 - self.b1) * g1)
        v *= self.b2 * g1 + keep
        v += self._second_moment_update(grad, i) * ((1 - self.b2) * g1)
        m_hat = m * self._bc1
        v_hat = v * self._bc2
        return m_hat * (-self.lr) / (v_hat.sqrt() + self.eps)


class AdamW(Adam):
    """Adam with DECOUPLED weight decay (https://arxiv.org/abs/1711.05101):
    ``-lr * wd * p`` joins the delta instead of the gradient, so it stays
    out of the moments.  Under ``amp.MixedPrecision`` it decays the f32
    masters, and the gate zeroes it on skipped steps."""

    def __init__(self, parameters, lr: float, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01):
        super().__init__(parameters, lr, beta1, beta2, eps)
        self.wd = weight_decay

    def compute_delta(self, grad, i):
        d = super().compute_delta(grad, i)
        if self.wd:
            d = d + self.parameters[i] * (-self.lr * self.wd)
        return d


class AdaBelief(Adam):
    """Adapting Stepsizes by the Belief in Observed Gradients
    (https://arxiv.org/abs/2010.07468)."""

    def _second_moment_update(self, grad, i):
        d = grad - self.m[i]
        return d * d


class Lion(Optimizer):
    """EvoLved Sign Momentum (https://arxiv.org/abs/2302.06675):
    ``delta = -lr * sign(b1*m + (1-b1)*g)``, then ``m = b2*m + (1-b2)*g``;
    decoupled weight decay like AdamW."""

    def __init__(self, parameters, lr: float = 1e-4, beta1: float = 0.9,
                 beta2: float = 0.99, weight_decay: float = 0.0):
        super().__init__(parameters)
        self.lr, self.b1, self.b2, self.wd = lr, beta1, beta2, weight_decay
        self.m = [torch.zeros_like(p) for p in self.parameters]

    def compute_delta(self, grad, i):
        g1, keep = self._gates()
        m = self.m[i]
        sign = torch.sign(m * self.b1 + grad * (1 - self.b1))
        m *= self.b2 * g1 + keep
        m += grad * ((1 - self.b2) * g1)
        d = sign * (-self.lr)
        if self.wd:
            d = d + self.parameters[i] * (-self.lr * self.wd)
        return d


class RMSprop(Optimizer):
    """RMSprop with optional momentum and the centered variant (torch
    semantics: eps outside the sqrt; the momentum buffer accumulates
    ``g / denom``)."""

    def __init__(self, parameters, lr: float = 1e-2, alpha: float = 0.99,
                 eps: float = 1e-8, momentum: float = 0.0,
                 centered: bool = False):
        super().__init__(parameters)
        self.lr, self.alpha, self.eps = lr, alpha, eps
        self.momentum, self.centered = momentum, centered
        self.sq = [torch.zeros_like(p) for p in self.parameters]
        self.buf = ([torch.zeros_like(p) for p in self.parameters]
                    if momentum else None)
        self.avg = ([torch.zeros_like(p) for p in self.parameters]
                    if centered else None)

    def compute_delta(self, grad, i):
        g1, keep = self._gates()
        sq = self.sq[i]
        sq *= self.alpha * g1 + keep
        sq += grad * grad * ((1 - self.alpha) * g1)
        if self.centered:
            avg = self.avg[i]
            avg *= self.alpha * g1 + keep
            avg += grad * ((1 - self.alpha) * g1)
            denom = (sq - avg * avg).sqrt() + self.eps
        else:
            denom = sq.sqrt() + self.eps
        if self.buf is None:
            return grad * (-self.lr * g1) / denom
        buf = self.buf[i]
        buf *= self.momentum * g1 + keep
        buf += grad * g1 / denom
        return buf * (-self.lr * g1)


class Adagrad(Optimizer):
    """Adagrad: ``sum += g^2``, ``delta = -lr * g / (sqrt(sum) + eps)``
    (torch semantics, ``lr_decay=0``)."""

    def __init__(self, parameters, lr: float = 1e-2, eps: float = 1e-10):
        super().__init__(parameters)
        self.lr, self.eps = lr, eps
        self.sum = [torch.zeros_like(p) for p in self.parameters]

    def compute_delta(self, grad, i):
        g1, _ = self._gates()
        s = self.sum[i]
        s += grad * grad * g1
        return grad * (-self.lr * g1) / (s.sqrt() + self.eps)


class Adafactor(Optimizer):
    """Adafactor (https://arxiv.org/abs/1804.04235): the second moments of a
    matrix are stored factored, one row and one column vector whose rank-1
    product estimates each element -- O(n+m) state, not O(n*m).  Increasing
    decay ``1 - t^-0.8``, per-block RMS clipping, optional parameter-scale
    multiplication, optional momentum, decoupled decay (optax's rules)."""

    def __init__(self, parameters, lr: float = 1.0,
                 min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, clipping_threshold: float = 1.0,
                 scale_parameter: bool = True, momentum: float = 0.0,
                 weight_decay: float = 0.0, eps: float = 1e-30,
                 min_param_scale: float = 1e-3):
        super().__init__(parameters)
        self.lr, self.decay_rate, self.eps = lr, decay_rate, eps
        self.clip = clipping_threshold
        self.scale_parameter = scale_parameter
        self.min_param_scale = min_param_scale
        self.momentum, self.wd = momentum, weight_decay
        self.t = self._scalar()
        # per parameter: either (v_row, v_col) over two axes, or a full v
        self.v_row, self.v_col, self.v, self._dims = [], [], [], []
        for p in self.parameters:
            dims = self._factored_dims(p.shape, min_dim_size_to_factor)
            self._dims.append(dims)
            if dims is not None:
                d1, d0 = dims
                kw = {"device": p.device, "dtype": p.dtype}
                self.v_row.append(torch.zeros(
                    [n for a, n in enumerate(p.shape) if a != d0], **kw))
                self.v_col.append(torch.zeros(
                    [n for a, n in enumerate(p.shape) if a != d1], **kw))
                self.v.append(None)
            else:
                self.v_row.append(None)
                self.v_col.append(None)
                self.v.append(torch.zeros_like(p))
        self.m = ([torch.zeros_like(p) for p in self.parameters]
                  if momentum else None)

    @staticmethod
    def _factored_dims(shape, min_size):
        """The two LARGEST axes (optax convention), or None if the
        second-largest is below the factoring threshold."""
        if len(shape) < 2:
            return None
        order = sorted(range(len(shape)), key=lambda a: (shape[a], a))
        if shape[order[-2]] < min_size:
            return None
        return order[-2], order[-1]

    @torch.no_grad()
    def step(self):
        self.t += 1.0 if self._gate is None else self._gate
        # t is 0 only if every step was gate-skipped: keep 0^-0.8 finite
        t_safe = self.t + (self.t == 0)
        self._dr = 1.0 - t_safe ** (-self.decay_rate)
        super().step()

    def compute_delta(self, grad, i):
        g1, keep = self._gates()
        dr = self._dr
        shape = grad.shape
        gsq = grad * grad + self.eps
        if self._dims[i] is not None:
            d1, d0 = self._dims[i]
            vr, vc = self.v_row[i], self.v_col[i]
            vr *= dr * g1 + keep
            vr += gsq.mean(dim=d0) * ((1.0 - dr) * g1)
            vc *= dr * g1 + keep
            vc += gsq.mean(dim=d1) * ((1.0 - dr) * g1)
            # rank-1 reconstruction, row side normalised by its mean
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_mean = vr.mean(dim=reduced_d1, keepdim=True)
            rf_shape = list(shape)
            rf_shape[d0] = 1
            cf_shape = list(shape)
            cf_shape[d1] = 1
            u = grad * (vr / row_mean).reshape(rf_shape) ** -0.5 \
                * vc.reshape(cf_shape) ** -0.5
        else:
            v = self.v[i]
            v *= dr * g1 + keep
            v += gsq * ((1.0 - dr) * g1)
            u = grad * v ** -0.5
        if self.clip:
            # per-block RMS clipping: u /= max(1, rms(u)/threshold)
            rms_u = (u * u).mean().sqrt()
            over = (rms_u > self.clip).float()
            u = u * (over * (self.clip / (rms_u + self.eps)) + (1.0 - over))
        u = u * self.lr
        if self.scale_parameter:
            # relative step: scale by max(rms(p), min_param_scale)
            p = self.parameters[i]
            rms_p = (p * p).mean().sqrt()
            big = (rms_p > self.min_param_scale).float()
            u = u * (big * rms_p + (1.0 - big) * self.min_param_scale)
        if self.m is not None:
            m = self.m[i]
            m *= self.momentum * g1 + keep
            m += u * ((1.0 - self.momentum) * g1)
            u = m
        if self.wd:
            u = u + self.parameters[i] * self.wd
        return u * -1.0


class Muon(Optimizer):
    """Muon: momentum + Newton-Schulz orthogonalisation of the update
    (Jordan et al. 2024).  Matrices (conv kernels flattened to
    (out, in*kh*kw)) take the orthogonalised momentum; parameters with
    ndim < 2 take AdamW with its own hyperparameters.  As in the JAX
    package, the step counter is a host int and the gate only scales the
    final delta."""

    _NS_A, _NS_B, _NS_C = 3.4445, -4.7750, 2.0315

    def __init__(self, parameters, lr: float = 0.02, momentum: float = 0.95,
                 nesterov: bool = True, ns_steps: int = 5,
                 adamw_lr: float = 3e-4, beta1: float = 0.9,
                 beta2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(parameters)
        self.lr, self.momentum, self.nesterov = lr, momentum, nesterov
        self.ns_steps, self.wd = ns_steps, weight_decay
        self.adamw_lr, self.b1, self.b2, self.eps = adamw_lr, beta1, beta2, eps
        self.buf = [torch.zeros_like(p) for p in self.parameters]
        # second moments only for the AdamW branch (ndim < 2)
        self.v = [torch.zeros_like(p) if p.ndim < 2 else None
                  for p in self.parameters]
        self.t = 0

    def _ns5(self, g, rows: int, cols: int):
        """Orthogonalise the (rows, cols) matrix ``g``: X ~ U V^T of its
        SVD."""
        a, b, c = self._NS_A, self._NS_B, self._NS_C
        tall = rows > cols
        x = g.T if tall else g
        x = x * (((x * x).sum()).sqrt() + 1e-7) ** -1.0
        for _ in range(self.ns_steps):
            xxt = x @ x.T
            bmat = xxt * b + (xxt @ xxt) * c
            x = x * a + bmat @ x
        return x.T if tall else x

    def step(self):
        self.t += 1
        super().step()

    def compute_delta(self, grad, i):
        p = self.parameters[i]
        m = self.buf[i]
        if p.ndim >= 2:
            m *= self.momentum
            m += grad
            g = grad + m * self.momentum if self.nesterov else m
            rows, cols = p.shape[0], p.numel() // p.shape[0]
            o = self._ns5(g.reshape(rows, cols), rows, cols).reshape(p.shape)
            u = o * max(1.0, rows / cols) ** 0.5
            if self.wd:
                u = u + p * self.wd
            return u * (-self.lr)
        v = self.v[i]
        m *= self.b1
        m += grad * (1.0 - self.b1)
        v *= self.b2
        v += grad * grad * (1.0 - self.b2)
        mhat = m * (1.0 / (1.0 - self.b1 ** self.t))
        vhat = v * (1.0 / (1.0 - self.b2 ** self.t))
        u = mhat * (vhat.sqrt() + self.eps) ** -1.0
        if self.wd:
            u = u + p * self.wd
        return u * (-self.adamw_lr)


class EMA:
    """Exponential moving average of parameters (shadow weights):
    ``s = decay*s + (1-decay)*p`` per ``update()``, in place.
    ``average_parameters()`` swaps the shadow values into the parameters for
    the length of a ``with`` block."""

    def __init__(self, parameters, decay: float = 0.999):
        if not 0.0 < decay < 1.0:
            raise ValueError("EMA decay must be in (0, 1)")
        self.parameters = tuple(parameters)
        self.decay = decay
        self.shadow = [p.detach().clone() for p in self.parameters]

    @torch.no_grad()
    def update(self):
        """Fold the current parameter values into the shadow average."""
        k = 1.0 - self.decay
        for s, p in zip(self.shadow, self.parameters):
            s += (p - s) * k

    def state_dict(self) -> dict:
        return {f"ema.{i}": s.clone() for i, s in enumerate(self.shadow)}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        for i, s in enumerate(self.shadow):
            s.copy_(torch.as_tensor(d[f"ema.{i}"]))

    @torch.no_grad()
    def copy_to(self, parameters=None) -> None:
        """Overwrite ``parameters`` (default: the tracked ones) with the
        shadow values."""
        ps = self.parameters if parameters is None else tuple(parameters)
        for s, p in zip(self.shadow, ps):
            p.copy_(s)

    @contextlib.contextmanager
    def average_parameters(self):
        """Parameters hold the EMA values inside the block; their live
        values come back on exit."""
        raw = [p.detach().clone() for p in self.parameters]
        self.copy_to()
        try:
            yield self
        finally:
            with torch.no_grad():
                for p, r in zip(self.parameters, raw):
                    p.copy_(r)


@torch.no_grad()
def clip_grad_norm(parameters, max_norm: float):
    """Scale all gradients so their global L2 norm is at most ``max_norm``,
    with no host sync: ``min(1, max_norm / (norm + 1e-6))`` is a scalar
    tensor multiplied into every gradient in place (a lightgrad gradient is
    rebound).  Returns the norm (a scalar f32 tensor)."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        raise ValueError("clip_grad_norm: no parameter has a gradient")
    grads = [p.grad.data if isinstance(p, AbstractTensor) else p.grad
             for p in params]
    norm = sum((g.float() ** 2).sum() for g in grads).sqrt()
    over = (norm > max_norm).float()
    scale = over * (max_norm / (norm + 1e-6)) + (1.0 - over)
    for p in params:
        if isinstance(p, AbstractTensor):
            g = p.grad          # the tape's imul rebinds the same object
            g *= scale
        else:
            p.grad *= scale
    return norm
