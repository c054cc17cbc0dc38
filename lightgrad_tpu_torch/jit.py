"""The step compiler: a tape step captured once into a CUDA graph and replayed.

Counterpart of ``lightgrad_tpu/jit.py``.  The eager tape launches one kernel
per op from Python, so a small model's step is bound by the host.
``lightgrad_tpu_torch.jit`` records which tensors a step function reads,
writes and creates, then captures the *entire* step (forward, backward graph
walk, optimizer update) into one ``torch.cuda.CUDAGraph`` over static slots,
and replays it: one launch from the host a step, on captured device state.

Usage::

    step = lightgrad_tpu_torch.jit(lambda x, y: train_step(model, optim, x, y))
    for x, y in data:
        loss = step(x, y)          # one graph replay per step

Contract for the wrapped function:
* tensor arguments are positional ``CudaTensor``s; shapes may vary (each new
  shape signature records + compiles once);
* parameters/optimizer state may be read from closures -- they are captured
  automatically and read as runtime state (never baked as constants);
* no host synchronization inside (``.numpy()`` / ``.item()`` on interior
  tensors fail under capture -- call them on the returned tensors);
* python-level state must live in tensors (our optimizers comply).
A host array uploaded inside the function (``from_numpy`` of an ``arange``,
a numpy index) is a constant of the step, as a numpy value is a constant of
a JAX trace: the recording step uploads it and every later run reads that
upload in place.  A value the recording step did not upload fails, since a
graph cannot upload from pageable host memory; pass values that change as
tensor arguments.

Three phases, as the JAX module is cut:

1. record (first call of a shape signature): ``fn`` runs eagerly, on a side
   stream, under a recorder that the tape's hooks feed (``on_create``,
   ``on_write``, ``on_read``; ``autograd/tensor.py``).  It returns the real
   first step's result.  It is also the graph's warm-up: kernel builds, the
   allocator and lazy initialisations all run outside the capture.
2. compile (second call): the tensors the step touched are sorted as the JAX
   module sorts them -- the arguments get a static slot each; the captures
   the step rebinds (parameters, BatchNorm buffers, ...) get a static slot
   that the graph ends by writing back into (a captured ``copy_``, where XLA
   donates); the other captures are read in place.  Then ``fn`` is captured
   over the slots, with the tape's device generator registered so that each
   replay draws fresh noise, and every tape tensor the Python pass rebound
   is restored.  Device state outside the tape (optimizer moments, the step
   counter, a schedule's ``lr``, the loss scaler) is updated in place by the
   step and so read and written in place by the graph.
3. run (every later call): copy the arguments into their slots, replay,
   bind every rebound capture to its slot, and return outputs copied out of
   the graph's pool (they stay valid after the next call).  The step records
   again when :func:`invalidate_captures` has moved the epoch since the
   record (a parameter rebound on a module; checked before the compile as
   well as before each run), when a captured tensor's buffer is no longer
   the one the graph reads (a load, a user's rebind, an EMA swap: a graph
   bakes addresses, so the guard compares buffers, where JAX compares
   shapes), when a parameter or buffer of a ``torch.nn`` module the step
   called is no longer the buffer the graph reads (such a step's state
   passes through no tape hook: the record notes the modules it calls), or
   when the tape's generator was replaced (``random.seed``).

On the CPU (``set_default_device("cpu")``) the same record, slot and
write-back code runs, and the "graph" is the captured pass re-run over the
slots at every call: the capture itself is the only part that needs a card.
On CUDA tensors a failed capture raises :class:`CaptureError`, which names
the contract and the op; ``jit`` never runs the step eagerly instead.

The launch counts of ``ops.runtime`` and the matmul loader counts stay true:
the wrappers count while the graph is captured, those counts are taken back,
and every replay adds them again.

Not ported: the JAX package records by abstract tracing under
``jax.eval_shape`` by default, which has no counterpart here (the record
step is a real eager step), and its ``LIGHTGRAD_RECORD``,
``LIGHTGRAD_STAGE_RECORD`` and ``LIGHTGRAD_STAGE_FAST`` switches (abstract
or eager recording, staging the eager one to the host backend) have none
either.  This module has no switch of its own.
"""

import contextlib
import ctypes
import gc
import time
import traceback

import torch

from . import random as _random
from .autograd import tensor as _tape
from .autograd.cuda.device import default_device
from .autograd.cuda.tensor import CudaTensor
from .autograd.tensor import AbstractTensor
from .ops import runtime as _runtime
from .ops.matmul import loader_counts as _loaders

__all__ = ["jit", "invalidate_captures", "CaptureError"]

_Sharded = _runtime.DTensor or ()

# bumped whenever user code rebinds a tensor a compiled step may have
# captured by object identity (e.g. ``model.w = Tensor(...)`` -- see
# nn.Module.register_param_or_module).  A compiled step notes the epoch when
# it records and records again when it has moved, before its compile too.
_capture_epoch = 0

CONTRACT = ("inside a compiled step: no host synchronisation (.numpy(), "
            ".item(), a device value read on the host), no host array the "
            "recording step did not upload, and only ops that CUDA graph "
            "capture accepts")


def invalidate_captures():
    """Mark all captured-by-identity compiled steps stale (cheap, global)."""
    global _capture_epoch
    _capture_epoch += 1


def capture_epoch() -> int:
    """The epoch :func:`invalidate_captures` moves: a compiled function
    notes it when it records and records again once it has moved."""
    return _capture_epoch


class CaptureError(RuntimeError):
    """A step broke ``jit``'s contract while it was captured (or, on the
    CPU, run over its slots); the step was not run eagerly instead."""


def _is_tensor(x):
    return isinstance(x, AbstractTensor)


def _is_arg_tensor(x):
    """A tape tensor, or a ``torch.Tensor`` (a step of the ``torch.nn``
    GPT takes its batches as such)."""
    return isinstance(x, (AbstractTensor, torch.Tensor))


def _buf(x):
    return x._raw_data() if _is_tensor(x) else x


def _upload_key(a, dev, dtype):
    return (str(dev), str(dtype), a.dtype.str, a.shape, a.tobytes())


class _Recorder:
    """Observes tensor reads/writes/creations during the recording step,
    and uploads its host arrays into the step's table of constants.

    Only tensors that existed before the step are held: an intermediate is
    known by its id, so recording pins none of the step's activations."""

    def __init__(self):
        self.reads = {}
        self.writes = {}
        self.created = set()
        self.constants = {}
        self.modules = {}       # torch.nn modules the step called

    def on_module(self, module, inputs):
        self.modules.setdefault(id(module), module)

    def on_read(self, t):
        if id(t) not in self.created:
            self.reads.setdefault(id(t), t)

    def on_write(self, t):
        if id(t) not in self.created:
            self.writes.setdefault(id(t), t)

    def on_create(self, t):
        self.created.add(id(t))

    def on_upload(self, a, dev, dtype):
        key = _upload_key(a, dev, dtype)
        c = self.constants.get(key)
        if c is None:
            c = torch.tensor(a, device=dev)
            c = self.constants[key] = c if dtype is None else c.to(dtype)
        return c

    def on_host_read(self, t):
        pass            # the recording step is eager: host reads are fine


class _Pass:
    """Observes one pass of ``fn`` over the slots (the capture, or on the
    CPU a run): the first write of each tensor that existed before the pass
    is snapshot so the pass can be undone, the buffers such tensors are read
    at are kept alive (the graph reads them in place), uploads are looked up
    among the step's constants and host reads are refused."""

    def __init__(self, constants):
        self.constants = constants
        self.created = set()
        self.saved = {}         # id -> (tensor, buffer, ctx) before its write
        self.keep = {}          # id -> buffer read in place

    def on_read(self, t):
        tid = id(t)
        if tid not in self.created and tid not in self.saved:
            self.keep.setdefault(tid, t._raw_data())

    def on_write(self, t):
        tid = id(t)
        if tid not in self.created and tid not in self.saved:
            self.saved[tid] = (t, t._raw_data(), t.ctx)

    def on_create(self, t):
        self.created.add(id(t))

    def on_upload(self, a, dev, dtype):
        c = self.constants.get(_upload_key(a, dev, dtype))
        if c is None:
            raise CaptureError(
                f"jit: a host array {a.dtype}{list(a.shape)} was uploaded "
                f"with a value the recording step did not upload; {CONTRACT}"
                f" (pass values that change as tensor arguments)")
        return c

    def on_host_read(self, t):
        raise CaptureError(f"jit: Tensor.numpy() / .item() of {t!r}; "
                           f"{CONTRACT}")

    def undo(self):
        for t, d, c in self.saved.values():
            t._set_data(d)
            t._set_ctx(c)


class _TraceScope:
    def __init__(self, recorder):
        self.recorder = recorder

    def __enter__(self):
        self.prev = _tape._trace
        _tape._trace = self.recorder
        return self.recorder

    def __exit__(self, *exc):
        _tape._trace = self.prev
        return False


def _flatten(out):
    """Leaves of a (nested) tuple / list / dict output and a rebuilder."""
    if isinstance(out, (tuple, list)):
        parts = [_flatten(o) for o in out]
        leaves = [x for p, _ in parts for x in p]
        sizes = [len(p) for p, _ in parts]
        kind = type(out)

        def build(xs):
            items, i = [], 0
            for (_, b), n in zip(parts, sizes):
                items.append(b(xs[i:i + n]))
                i += n
            return kind(items)
        return leaves, build
    if isinstance(out, dict):
        keys = list(out)
        leaves, build = _flatten([out[k] for k in keys])
        return leaves, lambda xs: dict(zip(keys, build(xs)))
    return [out], lambda xs: xs[0]


def _local(x):
    return x.to_local() if _runtime.is_sharded(x) else x


def _key(d):
    """What a graph bakes of a buffer it reads in place."""
    d = _local(d)
    return (d.data_ptr(), tuple(d.shape), d.dtype, d.stride())


def _module_keys(modules):
    """What a graph bakes of the ``torch.nn`` modules a step called and
    their submodules (a step of the ``torch.nn`` GPT reads its parameters
    through no tape hook): the objects of each module's children,
    parameters and buffers, and the tensors' buffer addresses.  A
    ``setattr`` of a new parameter or submodule,
    ``load_state_dict(assign=True)`` or ``.to()`` changes them."""
    objs = []
    for m in modules:
        objs += m._modules.values()
        objs += m._parameters.values()
        objs += m._buffers.values()
    return ([id(t) for t in objs],
            [(t.to_local() if isinstance(t, _Sharded) else t).data_ptr()
             for t in objs if isinstance(t, torch.Tensor)])


def _counts():
    return dict(_runtime._launches), dict(_loaders)


def _where(exc):
    """The innermost frame of ``exc``'s traceback outside torch."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "/torch/" not in f.filename]
    if not frames:
        return "?"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} in {f.name}: {f.line}"


@contextlib.contextmanager
def _no_collection():
    """The cyclic garbage collector held off: a CUDA graph it frees while
    another is being captured destroys its executable there, which the
    capture does not permit and which ends it."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


_streams = {}


def _side_stream(dev):
    s = _streams.get(dev)
    if s is None:
        s = _streams[dev] = torch.cuda.Stream(dev)
    return s


@contextlib.contextmanager
def _sync_allowed(dev):
    """Torch's sync debug mode off on a card (host reads and the capture's
    synchronisation are allowed inside)."""
    if dev.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _on_side_stream(dev, run):
    """``run()`` on the side stream the captures take, after the current
    stream's work and before its next: a record's lazy set-up (a library's
    workspace, the allocator's blocks) happens where the capture runs."""
    main = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = run()
    main.wait_stream(side)
    return out


_libcuda = None


def _graph_nodes(graph):
    """The node count of a captured graph (the driver's
    ``cuGraphGetNodes``), or None where the driver does not say."""
    global _libcuda
    try:
        if _libcuda is None:
            _libcuda = ctypes.CDLL("libcuda.so.1")
        n = ctypes.c_size_t(0)
        err = _libcuda.cuGraphGetNodes(ctypes.c_void_p(
            graph.raw_cuda_graph()), None, ctypes.byref(n))
    except (OSError, AttributeError, RuntimeError):
        return None
    return int(n.value) if err == 0 else None


class _Captured:
    """A captured CUDA graph, its node count, the seconds its capture
    took, and the kernel launches (and matmul loader choices) a replay
    counts."""

    def __init__(self, graph, nodes, seconds, launches, loaders):
        self.graph, self.nodes, self.seconds = graph, nodes, seconds
        self.launches, self.loaders = launches, loaders

    def replay(self):
        self.graph.replay()
        for k, n in self.launches.items():
            _runtime._launches[k] += n
        for k, n in self.loaders.items():
            _loaders[k] += n


def _capture(dev, run, what, generators=(), pool=None, on_error=None):
    """``run()`` captured into a CUDA graph on the side stream, with the
    cyclic collector held off and torch's sync debug mode off: (the
    :class:`_Captured` graph, run's output).  ``generators`` are
    registered with the graph; ``pool`` is a graph memory pool to share.
    Capture launches nothing: the counts it took are taken back, and each
    replay adds them again.  A failure runs ``on_error()`` and raises
    :class:`CaptureError` naming ``what``."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for g in generators:
        graph.register_generator_state(g)
    before = _counts()
    main = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    err = out = None
    with _sync_allowed(dev):
        torch.cuda.synchronize(dev)
        side.wait_stream(main)
        with torch.cuda.device(dev), torch.cuda.stream(side), \
                _no_collection():
            graph.capture_begin(pool=pool)
            try:
                out = run()
            except Exception as e:  # noqa: BLE001 - re-raised below
                err = e
            finally:
                try:
                    graph.capture_end()
                except Exception as e:  # noqa: BLE001 - re-raised below
                    err = err or e
        main.wait_stream(side)
    after = _counts()
    launches = {k: v - before[0][k] for k, v in after[0].items()
                if v != before[0][k]}
    loaders = {k: v - before[1][k] for k, v in after[1].items()
               if v != before[1][k]}
    _runtime._launches.update(before[0])
    _loaders.update(before[1])
    if err is not None:
        if on_error is not None:
            on_error()
        if isinstance(err, CaptureError):
            raise err
        raise CaptureError(
            f"{what} into a CUDA graph failed at {_where(err)}: "
            f"{type(err).__name__}: {err}; {CONTRACT}") from err
    nodes = _graph_nodes(graph)
    graph.instantiate()
    return _Captured(graph, nodes, time.perf_counter() - t0, launches,
                     loaders), out


class _State:
    """One shape signature's record and, once compiled, its graph."""

    def __init__(self, rec, args, dev):
        arg_ids = {id(t) for t in args if _is_tensor(t)}
        self.dev = dev
        self.captured = [t for tid, t in rec.reads.items()
                         if tid not in arg_ids]
        self.mutated = [t for tid, t in rec.writes.items()
                        if tid not in arg_ids]
        # arguments the step rebinds: their final buffers are outputs
        self.arg_writes = [i for i, t in enumerate(
            t for t in args if _is_arg_tensor(t)) if id(t) in rec.writes]
        self.constants = rec.constants
        # the modules the step called and their submodules
        self.modules = list({id(m): m for root in rec.modules.values()
                             for m in root.modules()}.values())
        self.epoch = _capture_epoch
        self.compiled = False


class _CompiledStep:
    def __init__(self, fn):
        self.fn = fn
        self.cache = {}  # shape signature -> _State

    def _signature(self, args):
        return tuple(
            (tuple(t.shape), str(t.dtype), str(_buf(t).device))
            if _is_arg_tensor(t) else ("static", repr(t))
            for t in args
        )

    def __call__(self, *args):
        sig = self._signature(args)
        state = self.cache.get(sig)
        if state is not None and self._stale(state):
            del self.cache[sig]
            state = None
        if state is None:
            return self._record(sig, args)
        if not state.compiled:
            self._compile(state, args)
        return self._run(state, args)

    # -- phase 1: an eager step under the recorder ---------------------------
    def _record(self, sig, args):
        rec = _Recorder()
        dev = next((_buf(t).device for t in args if _is_arg_tensor(t)),
                   None) or default_device()
        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            rec.on_module)
        try:
            if dev.type == "cuda" and torch.cuda.is_available():
                def run():
                    with _TraceScope(rec):
                        return self.fn(*args)
                out = _on_side_stream(dev, run)
            else:
                with _TraceScope(rec):
                    out = self.fn(*args)
        finally:
            hook.remove()
        # a step without tensor arguments runs where its state lies
        found = [_buf(t) for t in args if _is_arg_tensor(t)] \
            + [t._raw_data() for t in rec.reads.values()] \
            + [_buf(x) for x in _flatten(out)[0] if _is_arg_tensor(x)]
        state = _State(rec, args, found[0].device if found else dev)
        self.cache[sig] = state
        return out

    # -- one pass of fn over the slots ---------------------------------------
    def _pass(self, state, args):
        """Run ``fn`` with every argument and rebound capture on its slot,
        write the rebound captures' results into their slots, and undo every
        rebind the pass made.  Returns the output leaves' buffers."""
        tensor_args = [t for t in args if _is_arg_tensor(t)]
        slot_of = {id(t): s for t, s in zip(tensor_args, state.arg_slots)}
        call = [slot_of[id(a)] if isinstance(a, torch.Tensor) else a
                for a in args]
        swap = [(t, s) for t, s in zip(tensor_args, state.arg_slots)
                if _is_tensor(t)] + list(zip(state.mutated, state.mut_slots))
        before = [(t, t._raw_data(), t.ctx) for t, _ in swap]
        for t, s in swap:
            t._set_data(s)
        scope = _Pass(state.constants)
        try:
            with _TraceScope(scope):
                out = self.fn(*call)
            leaves, build = _flatten(out)
            finals = [t._raw_data() for t in state.mutated]
            for t, f, s in zip(state.mutated, finals, state.mut_slots):
                if f.shape != s.shape or f.dtype != s.dtype:
                    raise CaptureError(
                        f"jit: the step rebinds {t!r} from {tuple(s.shape)} "
                        f"{s.dtype} to {tuple(f.shape)} {f.dtype}; a "
                        f"compiled step's state keeps its shape and dtype")
            # a result that shares a slot's memory is copied first, so no
            # write-back reads a slot another write-back has overwritten
            slots = {_local(s).untyped_storage().data_ptr()
                     for s in state.mut_slots}
            finals = [f.clone() if f is not s and
                      _local(f).untyped_storage().data_ptr() in slots else f
                      for f, s in zip(finals, state.mut_slots)]
            for f, s in zip(finals, state.mut_slots):
                if f is not s:
                    s.copy_(f)
            datas = [x._raw_data() if _is_tensor(x) else
                     x.detach() if isinstance(x, torch.Tensor) else x
                     for x in leaves]
            datas += [tensor_args[i]._raw_data() for i in state.arg_writes]
            kinds = [_is_tensor(x) for x in leaves]
        finally:
            scope.undo()
            for t, d, c in before:
                t._set_data(d)
                t._set_ctx(c)
        state.keep = scope.keep
        return datas, kinds, build

    # -- phase 2: slots, then the capture -------------------------------------
    def _compile(self, state, args):
        mut_ids = {id(t) for t in state.mutated}
        state.const = [(t, t._raw_data()) for t in state.captured
                       if id(t) not in mut_ids]
        state.arg_slots = [_buf(t).detach().clone() for t in args
                           if _is_arg_tensor(t)]
        state.mut_slots = [t._raw_data().clone() for t in state.mutated]
        state.graph = None
        if state.dev.type == "cuda":
            self._capture(state, args)
        # from here on the step's state lives in its slots
        for t, s in zip(state.mutated, state.mut_slots):
            t._set_data(s)
        state.module_keys = _module_keys(state.modules)
        state.compiled = True

    def _capture(self, state, args):
        dev = state.dev
        gen = _random.generator(dev)
        gen_state = gen.get_state()

        def restore():
            # a capture that did not end leaves its registered generator
            # in capture mode: the device draws from a fresh one at the
            # same place in the stream
            fresh = torch.Generator(device=gen.device)
            fresh.set_state(gen_state)
            _random._generators[gen.device] = fresh

        state.graph, state.outs = _capture(
            dev, lambda: self._pass(state, args),
            f"jit: capturing {getattr(self.fn, '__name__', self.fn)}",
            generators=(gen,), on_error=restore)
        state.gen = gen

    def _stale(self, state):
        """Whether the step must record again: a rebind since the record
        (the epoch; checked before the compile too, as the captured sets
        may no longer be what ``fn`` reads), or since the compile a buffer
        the graph reads or writes that is no longer the tensor's."""
        if state.epoch != _capture_epoch:
            return True
        if not state.compiled:
            return False
        if _module_keys(state.modules) != state.module_keys:
            return True
        for t, s in zip(state.mutated, state.mut_slots):
            if t._raw_data() is not s:
                return True
        if not all(t._raw_data() is d or _key(t._raw_data()) == _key(d)
                   for t, d in state.const):
            return True
        return state.graph is not None and \
            _random._generators.get(state.gen.device) is not state.gen

    # -- phase 3: copy in, replay, bind, copy out ----------------------------
    def _run(self, state, args):
        tensor_args = [t for t in args if _is_arg_tensor(t)]
        for t, s in zip(tensor_args, state.arg_slots):
            s.copy_(_buf(t))
        if state.graph is None:
            datas, kinds, build = self._pass(state, args)
        else:
            state.graph.replay()
            datas, kinds, build = state.outs
        n = len(kinds)
        for i, d in zip(state.arg_writes, datas[n:]):
            tensor_args[i]._set_data(d.clone())
        leaves = [CudaTensor(d.clone(), requires_grad=False) if k else
                  d.clone() if isinstance(d, torch.Tensor) else d
                  for d, k in zip(datas[:n], kinds)]
        return build(leaves)


def jit(fn):
    """Compile an eager-tape step function into one CUDA graph."""
    return _CompiledStep(fn)
