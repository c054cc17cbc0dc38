"""Gradient bookkeeping: the grad-enabled state and the reverse-mode walk.

Counterpart of ``lightgrad_tpu/autograd/grads.py``, unchanged in behaviour:
the backward walk computes one reverse-topological order over the
``Function`` DAG and processes each node once, after every consumer of its
output has accumulated into that output's gradient.  Nodes hold their
outputs weakly (``function.py``).
"""

from functools import wraps

__all__ = ["Gradients", "no_grad"]


class _NoGradHandler:
    """Context-manager *and* decorator that disables gradient tracking."""

    def __enter__(self):
        Gradients.disable()
        return self

    def __exit__(self, *exc):
        Gradients.enable()
        return False

    def __call__(self, fn):
        @wraps(fn)
        def wrapper(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return wrapper


class Gradients:
    """Global (nested) gradient-enable switch + the backward graph walk."""

    _disable_depth = 0

    @staticmethod
    def disable():
        Gradients._disable_depth += 1

    @staticmethod
    def enable():
        Gradients._disable_depth = max(0, Gradients._disable_depth - 1)

    @staticmethod
    def _is_enabled() -> bool:
        return Gradients._disable_depth == 0

    @staticmethod
    def no_grad() -> _NoGradHandler:
        return _NoGradHandler()

    @staticmethod
    def backward(ctx, grad) -> None:
        """Run reverse-mode accumulation starting from tape node ``ctx``,
        whose output's seed gradient is ``grad``."""
        if ctx is None:
            return
        # iterative DFS post-order over the Function DAG
        order = []
        seen = set()
        stack = [(ctx, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for t in node.parent_tensors:
                if t.requires_grad and t.ctx is not None:
                    stack.append((t.ctx, False))
        # consumers before producers (reversed post-order)
        with Gradients.no_grad():
            for node in reversed(order):
                # a node is reached through its live output's ctx
                out_grad = grad if node is ctx else node.out().grad
                if out_grad is None:
                    # output unreachable from the seed
                    continue
                node._backpropagate(out_grad)


no_grad = Gradients.no_grad
