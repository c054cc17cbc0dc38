"""Fused layer ops as ``torch.autograd.Function``s.

Counterpart of the ``layernorm`` and ``attention`` Functions of
``lightgrad_tpu/autograd/tpu/ops.py``: the forward runs the fused kernel and
saves its residuals, the backward runs the kernel's backward.  On CUDA
tensors both directions launch the hand-written kernels (ops/layernorm.py,
ops/attention.py); on CPU tensors, their plain versions.
"""

import torch

from ..ops.attention import attention_bwd, attention_fwd_res
from ..ops.layernorm import layernorm_bwd_dx, layernorm_fwd

__all__ = ["attention", "layernorm"]


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        y, xhat, rstd = layernorm_fwd(x, w, b, eps)
        ctx.save_for_backward(w, xhat, rstd)
        ctx.x_shape = x.shape
        return y

    @staticmethod
    def backward(ctx, g):
        w, xhat, rstd = ctx.saved_tensors
        r, c = xhat.shape
        g2 = g.reshape(r, c).contiguous()
        dx = layernorm_bwd_dx(g2, w, xhat, rstd).reshape(ctx.x_shape)
        # weight and bias gradients: plain row sums in f32, as the JAX
        # package leaves them to its reduce op
        g32 = g2.float()
        dw = (g32 * xhat).sum(0).reshape(w.shape).to(w.dtype)
        db = g32.sum(0).reshape(w.shape).to(w.dtype)
        return dx, dw, db, None


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = attention_fwd_res(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # the cotangent arrives through transpose(1, 2).reshape: strided
        dq, dk, dv = attention_bwd(g.contiguous(), q, k, v, ctx.scale,
                                   ctx.causal, out=out, lse=lse)
        return dq, dk, dv, None, None


def layernorm(x, w, b, eps: float = 1e-5):
    """Fused layer normalization over the trailing dims of ``w``'s shape."""
    return _LayerNorm.apply(x, w, b, float(eps))


def attention(q, k, v, scale: float, causal: bool = False):
    """Fused scaled-dot-product attention over (..., S, D) q/k/v; k and v
    may carry fewer leading rows (grouped-query, kv-major)."""
    return _Attention.apply(q, k, v, float(scale), bool(causal))
