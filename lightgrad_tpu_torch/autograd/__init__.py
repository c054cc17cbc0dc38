"""The port's differentiable fused ops.  The tape is ``torch.autograd``."""

from . import ops
from .ops import attention, layernorm

__all__ = ["ops", "attention", "layernorm"]
