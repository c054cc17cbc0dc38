"""Tape nodes: the ``Function`` base class and the composite-op helper.

Counterpart of ``lightgrad_tpu/autograd/function.py``, unchanged in
behaviour: an op is a ``Function`` subclass with ``forward(ctx, *args)`` /
``backward(ctx, out_grad)`` and ``ctx.save_for_backward(...)``; calling the
class applies it.  A tape node is attached only when gradients are enabled
and some parent requires a gradient.  :func:`composite` wraps a derived op
built from primitives, which record on the tape themselves.  Gradients are
un-broadcast here, so backend ops return "natural" gradients.

One difference: a node holds its output weakly (``f.out`` is a
``weakref``).  The output holds the node (``ctx``) and the node its inputs,
so a step's graph is freed by reference counting as soon as its loss is
dropped; with a strong ``out`` every node would sit in a reference cycle
and its saved device buffers would wait for Python's cyclic collector.
"""

import weakref

from .grads import Gradients
from ..ops.runtime import is_sharded
from ..utils.profiler import Tracker

__all__ = ["Function", "composite"]


def _unbroadcast(grad, shape):
    """Reduce ``grad`` back to ``shape`` by summing over broadcast axes
    (through the backend's ``sum``: the reduce kernel on CUDA)."""
    if grad.shape == tuple(shape):
        return grad
    extra = len(grad.shape) - len(shape)
    if extra > 0:
        grad = grad.sum(axis=tuple(range(extra)))
    axes = tuple(i for i, s in enumerate(shape)
                 if s == 1 and grad.shape[i] != 1)
    if axes:
        grad = grad.sum(axis=axes, keepdims=True)
    return grad


class _FunctionMeta(type):
    """Calling a Function subclass applies it: builds the tape node, runs
    ``forward`` under ``no_grad`` and attaches the node to the output."""

    def __call__(cls, *args, **kwargs):
        from .tensor import AbstractTensor

        # keyword arguments must be configuration, not differentiable inputs
        assert not any(
            isinstance(v, AbstractTensor) and v.requires_grad
            for v in kwargs.values()
        ), f"{cls.__name__}: tensors requiring grad must be positional"

        f = object.__new__(cls)
        f.parents = tuple(a for a in args if isinstance(a, AbstractTensor))
        f.out = None
        f._saved = ()
        if f.parents:
            tensor_cls = type(f.parents[0])
            assert all(type(t) is tensor_cls for t in f.parents), (
                f"{cls.__name__}: all tensor operands must share one backend, "
                f"got {[type(t).__name__ for t in f.parents]}")

        with Tracker(cls.__name__):
            with Gradients.no_grad():
                out = f.forward(*args, **kwargs)

        if any(out is t for t in f.parents):
            # in-place op returning one of its inputs: never rewire the tape
            assert not (Gradients._is_enabled() and out.requires_grad), (
                f"in-place {cls.__name__} on a tensor requiring grad is not "
                f"differentiable -- wrap the update in no_grad()")
            return out
        if Gradients._is_enabled() and any(t.requires_grad for t in f.parents):
            out._set_ctx(f)
            out._set_requires_grad(True)
            f.out = weakref.ref(out)
        else:
            out._set_requires_grad(False)
        return out


class Function(metaclass=_FunctionMeta):
    """Base class of every primitive op / tape node.

    Subclasses implement ``forward(ctx, *args, **kwargs) -> Tensor`` and
    ``backward(ctx, out_grad) -> grad | tuple-of-grads`` (one per parent
    tensor, ``None`` allowed).  ``forward`` runs with gradients disabled.
    """

    @property
    def parent_tensors(self):
        return self.parents

    def save_for_backward(self, *items):
        self._saved = self._saved + items

    def get_saved_tensors(self):
        return self._saved

    def forward(ctx, *args, **kwargs):
        raise NotImplementedError()

    def backward(ctx, out_grad):
        raise NotImplementedError(
            f"{type(ctx).__name__} does not support backpropagation")

    def _backpropagate(self, out_grad) -> None:
        with Tracker(type(self).__name__, backward=True):
            grads = self.backward(out_grad)
        grads = grads if isinstance(grads, tuple) else (grads,)
        # fewer grads than parents is allowed: trailing parents (e.g. loss
        # targets) receive no gradient
        assert len(grads) <= len(self.parents), (
            f"{type(self).__name__}.backward returned {len(grads)} gradients "
            f"for {len(self.parents)} inputs")
        for t, g in zip(self.parents, grads):
            if g is None or not t.requires_grad:
                continue
            if is_sharded(g.data) and not is_sharded(t.data):
                # a whole tensor met sharded ones (the parallel layer): its
                # gradient is the whole sum, on every rank
                g = type(g)(g.data.full_tensor(), requires_grad=False)
            g = _unbroadcast(g, t.shape)
            assert g.shape == t.shape, (
                f"{type(self).__name__}: gradient shape {g.shape} does not "
                f"match input shape {t.shape}")
            t.add_grad(g)


def composite(fn):
    """Wrap a device-agnostic derived op built from primitive tensor ops.

    The wrapped function runs with gradients enabled: its primitive sub-ops
    record directly on the tape.  The whole call is tracked as a single
    profiler entry; nested primitive trackers are suppressed.
    """

    def wrapper(*args, **kwargs):
        with Tracker(fn.__name__):
            return fn(*args, **kwargs)

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper
