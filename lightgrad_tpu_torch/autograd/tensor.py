"""The device-agnostic tensor: data + grad + tape edge.

Counterpart of ``lightgrad_tpu/autograd/tensor.py``: ``data``/``grad``/
``requires_grad``/``ctx``, ``backward(allow_fill)``, ``add_grad``,
``zero_grad(traverse_graph)``, the initializer contract
(``empty/zeros/ones/uniform/xavier/from_numpy/numpy/copy/item/numel``) and
the ``register_op`` / ``register_method`` / ``register_backend`` extension
points, and the hooks of the ``jit`` step compiler: while ``_trace`` is set,
the constructor reports each new tensor (``on_create``), ``_set_data``
each rebind before it happens (``on_write``) and ``.data`` each read
(``on_read``), as ``lightgrad_tpu/autograd/tensor.py``'s hooks do.

Buffers have value semantics, as the JAX package's immutable arrays do: an
op never writes into a buffer it did not allocate; in-place ops rebind the
tensor to a fresh buffer (``_set_data``).  So aliasing a buffer (``copy``,
views from ``reshape``/``transpose``) is always safe.  The one writer in
place is a compiled step (``jit``): it binds the state it rebinds to slots
it allocated and writes them at every run, so a view of such a tensor's
buffer follows the step.
"""

from functools import reduce

import numpy as np

from .function import Function
from .grads import Gradients

__all__ = ["AbstractTensor"]


# active trace recorder (set by lightgrad_tpu_torch.jit while it records a
# step function's read/write/create sets, captures it or runs its slots;
# None in normal eager execution)
_trace = None


class AbstractTensor:
    def __init__(self, data, requires_grad: bool = True):
        self.__data = data
        self.__grad = None
        self.__requires_grad = requires_grad
        self.__ctx = None
        if _trace is not None:
            _trace.on_create(self)

    # --- tape plumbing -----------------------------------------------------
    def _set_ctx(self, ctx) -> "AbstractTensor":
        assert ctx is None or isinstance(ctx, Function)
        self.__ctx = ctx
        return self

    def _set_data(self, data) -> "AbstractTensor":
        # hook BEFORE the assignment: the recorder snapshots the buffer the
        # write replaces
        if _trace is not None:
            _trace.on_write(self)
        self.__data = data
        return self

    def _set_requires_grad(self, flag: bool) -> "AbstractTensor":
        self.__requires_grad = bool(flag)
        return self

    def detach(self) -> "AbstractTensor":
        self.__ctx = None
        return self

    @property
    def ctx(self):
        return self.__ctx

    @property
    def data(self):
        if _trace is not None:
            _trace.on_read(self)
        return self.__data

    def _raw_data(self):
        """Backing buffer without triggering trace hooks."""
        return self.__data

    @property
    def grad(self):
        return self.__grad

    @property
    def requires_grad(self) -> bool:
        return self.__requires_grad

    # --- shape / dtype introspection (backend-provided) --------------------
    @property
    def dtype(self):
        raise NotImplementedError()

    @property
    def shape(self) -> tuple:
        raise NotImplementedError()

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return int(reduce(lambda a, b: a * b, self.shape, 1))

    def item(self):
        return self.numpy().item()

    def __repr__(self):
        return (f"{type(self).__name__}(shape={self.shape}, dtype={self.dtype}"
                f", requires_grad={self.requires_grad})")

    # --- initializer contract (implemented per backend) --------------------
    @staticmethod
    def empty(shape, requires_grad: bool = True, dtype=None):
        raise NotImplementedError()

    @staticmethod
    def zeros(shape, requires_grad: bool = True, dtype=None):
        raise NotImplementedError()

    @staticmethod
    def ones(shape, requires_grad: bool = True, dtype=None):
        raise NotImplementedError()

    @staticmethod
    def uniform(low, high, shape, requires_grad: bool = True):
        raise NotImplementedError()

    @staticmethod
    def from_numpy(a: np.ndarray, requires_grad: bool = True):
        raise NotImplementedError()

    @classmethod
    def xavier(cls, shape, requires_grad: bool = True) -> "AbstractTensor":
        with Gradients.no_grad():
            t = cls.uniform(-1, 1, shape=shape)
            t = t * (1.0 / np.sqrt(t.numel()))
        return t.detach()._set_requires_grad(requires_grad)

    def copy(self, requires_grad: bool = True) -> "AbstractTensor":
        raise NotImplementedError()

    def numpy(self) -> np.ndarray:
        raise NotImplementedError()

    # --- gradients ---------------------------------------------------------
    def backward(self, allow_fill: bool = False) -> None:
        if self.__ctx is None:
            return
        if self.shape == (1,) or len(self.shape) == 0 or allow_fill:
            # seed in the output's own dtype: an f32 seed would promote every
            # gradient of a bf16 model
            self.__grad = type(self).ones(
                self.shape, requires_grad=False, dtype=self.dtype)
        else:
            raise RuntimeError("can only backpropagate from scalar tensors "
                               "(or pass allow_fill=True)")
        Gradients.backward(self.__ctx, self.__grad)

    @Gradients.no_grad()
    def add_grad(self, grad) -> None:
        if not self.__requires_grad:
            return
        if self.__grad is None:
            self.__grad = grad.copy(requires_grad=False)
        else:
            self.__grad += grad

    def zero_grad(self, traverse_graph: bool = False) -> None:
        if self.__requires_grad:
            if self.__grad is None:
                self.__grad = type(self).zeros(
                    self.shape, requires_grad=False, dtype=self.dtype)
            else:
                self.__grad.fill(0)
        if traverse_graph and self.__ctx is not None:
            assert all(t is not self for t in self.__ctx.parent_tensors)
            for t in self.__ctx.parent_tensors:
                t.zero_grad(traverse_graph=True)

    # --- op / backend registration -----------------------------------------
    @classmethod
    def register_op(cls, name: str = None, op: type = None,
                    overwrite: bool = False):
        if op is None:
            # decorator form: @Cls.register_op("name")
            return lambda op_cls: cls.register_op(
                name if name is not None else op_cls.__name__, op_cls,
                overwrite=overwrite)
        if not issubclass(op, Function):
            raise TypeError(f"ops must inherit from Function "
                            f"(got {op.__name__})")
        if not overwrite and name in cls.__dict__:
            raise RuntimeError(f"op {name!r} already registered on "
                               f"{cls.__name__}")
        dispatch = lambda self, *args, **kwargs: op(self, *args, **kwargs)
        dispatch.__name__ = name
        setattr(cls, name, dispatch)
        return op

    @classmethod
    def register_method(cls, name: str, fn, overwrite: bool = False):
        """Install a plain callable (e.g. a :func:`composite`) as a method."""
        if not overwrite and name in cls.__dict__:
            raise RuntimeError(f"method {name!r} already registered on "
                               f"{cls.__name__}")
        setattr(cls, name, fn)
        return fn

    @staticmethod
    def register_backend(name: str, tensor_cls: type):
        """Install ``.{name}()`` converters on every tensor class."""
        if not issubclass(tensor_cls, AbstractTensor):
            raise TypeError(f"backend tensors must inherit from "
                            f"AbstractTensor (got {tensor_cls.__name__})")

        def convert(t, *args, **kwargs):
            if type(t) is tensor_cls:
                return t
            return tensor_cls.from_numpy(t.numpy(), *args, **kwargs)

        convert.__name__ = name
        setattr(AbstractTensor, name, convert)
