"""Losses: MSE and cross-entropy, for either tape.

Counterpart of ``lightgrad_tpu/loss.py``, with its formulas.  Each loss
takes either kind of tensor and dispatches on the type of its first
argument, at the one entry point:

* a lightgrad tensor goes through the tape ``Function``s carried over from
  the JAX package (``_TapeMSE``, ``_TapeCrossEntropy``), whose ops reach the
  port's kernels (elementwise, reduce) like any other tape op;
* a ``torch.Tensor`` goes through a ``torch.autograd.Function`` with the
  same analytic backward, in plain PyTorch (the JAX package's losses were
  plain XLA).

Cross-entropy's forward is in log-sum-exp form and never materialises the
probabilities; its single backward pass recomputes them from the saved
logits.  Both run in float32 whatever the logits' dtype, and the gradient
is cast back to it.
"""

import numpy as np
import torch

from .autograd import AbstractTensor, Function

__all__ = ["mse", "cross_entropy"]


class _MSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, y_hat):
        err = y - y_hat
        ctx.save_for_backward(err)
        return (err * err).mean() * 0.5

    @staticmethod
    def backward(ctx, out_grad):
        (err,) = ctx.saved_tensors
        return err * (out_grad / err.numel()), None


class _TapeMSE(Function):
    """``mse`` on the lightgrad tape (``lightgrad_tpu.loss.mse``)."""

    def forward(ctx, y, y_hat):
        err = y - y_hat
        ctx.save_for_backward(err)
        return (err ** 2.0).mean() * 0.5

    def backward(ctx, out_grad):
        (err,) = ctx.get_saved_tensors()
        return err * out_grad * (1.0 / err.numel())


def mse(y, y_hat):
    """Mean squared error: ``mean((y - y_hat)^2) / 2``.  ``y_hat`` is the
    target and, as in the JAX package, receives no gradient."""
    if isinstance(y, AbstractTensor):
        return _TapeMSE(y, y_hat)
    return _MSE.apply(y, y_hat)


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, labels, ignore_index, label_smoothing):
        n, k = y.shape
        eps = float(label_smoothing)
        labels = labels.long()
        valid = denom = None
        if ignore_index is not None:
            valid = (labels != ignore_index).float()
            # ignored labels may be out of range (-100): gather column 0
            labels = labels * valid.long()
            denom = valid.sum()
        m = y.max(dim=-1, keepdim=True).values
        lse = (y - m).float().exp().sum(-1).log() + m.reshape(n).float()
        picked = y[torch.arange(n, device=y.device), labels].float()
        nll = lse - picked
        if eps:
            # (1-eps)*nll + eps*mean_j(lse - y_j) == the smoothed target
            nll = nll * (1.0 - eps) + (lse - y.mean(-1).float()) * eps
        total = (nll * valid).sum() / denom if valid is not None \
            else nll.mean()
        ctx.save_for_backward(y, labels, lse, valid, denom)
        ctx.eps = eps
        return total

    @staticmethod
    def backward(ctx, out_grad):
        y, labels, lse, valid, denom = ctx.saved_tensors
        n, k = y.shape
        eps = ctx.eps
        # d/dlogits = probs - ((1-eps) onehot + eps/K), masked + normalised;
        # the probabilities recomputed as exp(y - lse), updated in place
        g = (y.float() - lse[:, None]).exp_()
        g[torch.arange(n, device=y.device), labels] -= 1.0 - eps
        if eps:
            g -= eps / k
        if valid is not None:
            g *= (valid / denom)[:, None]
        else:
            g *= 1.0 / n
        g *= out_grad
        return g.to(y.dtype), None, None, None


class _TapeCrossEntropy(Function):
    """``cross_entropy`` on the lightgrad tape
    (``lightgrad_tpu.loss.cross_entropy``): every step is a tape op, so the
    row max and sums reach the reduce kernel and the passes over the logits
    the elementwise kernel."""

    def forward(ctx, y, labels, ignore_index: int = None,
                label_smoothing: float = 0.0):
        n = labels.shape[0]
        k = y.shape[-1]
        eps = float(label_smoothing)
        if ignore_index is not None:
            valid = labels.eq(ignore_index) * -1.0 + 1.0     # float {0,1}
            # ignored labels may be out of range (-100): gather column 0
            labels = labels * valid.astype(labels.dtype)
            denom = valid.sum()
        else:
            valid, denom = None, None
        m = y.max(axis=-1, keepdims=True)
        lse = (y - m).astype(np.float32).exp().sum(axis=-1).log() \
            + m.reshape(n).astype(np.float32)
        picked = y[np.arange(n), labels].astype(np.float32)
        nll = lse - picked
        if eps:
            # (1-eps)*nll + eps*mean_j(lse - y_j) == the smoothed target
            nll = nll * (1.0 - eps) \
                + (lse - y.mean(axis=-1).astype(np.float32)) * eps
        if valid is not None:
            total = (nll * valid).sum() / denom
        else:
            total = nll.mean()
        ctx.save_for_backward(y, labels, lse, n, k, eps, valid, denom)
        return total

    def backward(ctx, out_grad):
        y, labels, lse, n, k, eps, valid, denom = ctx.get_saved_tensors()
        # d/dlogits = probs - ((1-eps) onehot + eps/K), masked + normalised;
        # the onehot is a broadcast equality (no scatter)
        ar = type(y).from_numpy(np.arange(k, dtype=np.int32),
                                requires_grad=False)
        oh = labels.reshape(n, 1).eq(ar).astype(np.float32)
        g = (y.astype(np.float32) - lse.reshape(n, 1)).exp()
        if eps:
            g = g - oh * (1.0 - eps) - eps / k
        else:
            g = g - oh
        if valid is not None:
            g = g * (valid.reshape(n, 1) / denom)
        else:
            g = g * (1.0 / n)
        return (g * out_grad).astype(y.dtype)


def cross_entropy(y, labels, ignore_index: int = None,
                  label_smoothing: float = 0.0):
    """Mean softmax cross-entropy of logits ``y`` (n, k) against integer
    ``labels`` (n,).  ``ignore_index`` drops rows whose label equals it and
    normalises by the valid-row count (at least one row must be valid);
    ``label_smoothing`` trains against ``(1-eps) * onehot + eps/K``."""
    if isinstance(y, AbstractTensor):
        return _TapeCrossEntropy(y, labels, ignore_index=ignore_index,
                                 label_smoothing=label_smoothing)
    return _CrossEntropy.apply(y, labels, ignore_index, label_smoothing)
