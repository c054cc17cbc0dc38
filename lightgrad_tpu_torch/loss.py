"""Losses: MSE and cross-entropy.

Counterpart of ``lightgrad_tpu/loss.py``, with its formulas: each loss is a
``torch.autograd.Function`` with an analytic backward.  Cross-entropy's
forward is in log-sum-exp form and never materialises the probabilities;
its single backward pass recomputes them from the saved logits.  Both run in
float32 whatever the logits' dtype, and the gradient is cast back to it.
They are plain PyTorch: the JAX package's losses were plain XLA too.
"""

import torch

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


def mse(y, y_hat):
    """Mean squared error: ``mean((y - y_hat)^2) / 2``.  ``y_hat`` is the
    target and, as in the JAX package, receives no gradient."""
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


def cross_entropy(y, labels, ignore_index: int = None,
                  label_smoothing: float = 0.0):
    """Mean softmax cross-entropy of logits ``y`` (n, k) against integer
    ``labels`` (n,).  ``ignore_index`` drops rows whose label equals it and
    normalises by the valid-row count (at least one row must be valid);
    ``label_smoothing`` trains against ``(1-eps) * onehot + eps/K``."""
    return _CrossEntropy.apply(y, labels, ignore_index, label_smoothing)
