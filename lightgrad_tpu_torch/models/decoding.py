"""KV-cache decoding over the ``_kv_functions`` contract (GPT, LLaMA), compiled.

Counterpart of ``lightgrad_tpu/models/decoding.py``: :class:`KVFns`,
:class:`ParamFn`, host-loop :func:`generate_batch`, whole-generation
decoding on the device (:func:`generate_device`,
:func:`generate_batch_device`), :func:`beam_search`, and speculative
decoding (:func:`generate_speculative`, :func:`speculative_accept`,
:func:`generate_speculative_device`).

Compiled as the JAX package compiles them.  There, ``ParamFn`` wraps each
decode function in ``jax.jit``; here it captures it into a CUDA graph: the
first call of a signature runs eagerly (the record, which also warms the
kernels' builds and the allocator), the second captures the call into a
``torch.cuda.CUDAGraph`` over static slots and replays it, and every later
call replays it.  The arguments that change from call to call (positions,
tokens, a prompt, ``n_real``; a Python int becomes an int32 device scalar)
are copied into the slots; the cache and any other argument the function
writes in place are read and written at their addresses, which are part
of the signature, as the shapes are.  Parameters are read in place: a
``.params`` entry rebound, or :func:`lightgrad_tpu_torch.invalidate_captures`
(a tape module's rebound parameter), records again.  ``.fn`` and
``.params`` stay reachable: ``pf.fn(pf.params, *args)`` is the eager call
the tests hold the graphs against.  On the CPU the same slot code runs and
the function is re-run over the slots at each call, as ``jit`` does.  A
failed capture raises ``CaptureError``; nothing falls back to eager.  Only
the functions of a model whose parameters are ``DTensor``s (the parallel
layer) are built eager, decided when they are built.

A JAX ``lax.scan`` / ``while_loop`` over the whole generation becomes a
loop on the host that replays one compiled step (with its on-device
sampling, the token written into the output buffer and the position moved
on the device) without reading the device: capturing the unrolled loop
would grow with ``max_new_tokens``.  The state such a loop steps (the
stacked cache, positions, tokens, the output buffer) is kept on the
model's :class:`KVFns` for each signature, so a second call with the same
signature replays without capturing again; the cache is zeroed on the
device at each call.  The sampling generator of the device loops is kept
the same way, registered with every graph that draws from it and reseeded
by ``seed=`` at each call.  Beam search keeps ``beam_size`` beam caches
and reorders them by a device gather into the same buffers; the
speculative device loop replays one graph a round.

A cache is one tensor or a tuple of tensors (``quantize_kv``'s int8 rows
and their scales); :func:`cache_map`, :func:`stacked_zeros` and
:func:`cache_slot` treat both alike, as ``jax.tree_util.tree_map`` does in
the JAX package.  The functions write the cache IN PLACE (the JAX package
returned a new array).

The device loops move data between host and device only inside
:func:`_host_io`, which counts each transfer in :data:`host_transfers` and
runs it with torch's sync debug mode off: a caller may run a whole
generation under ``torch.cuda.set_sync_debug_mode("error")``, and any
other host read of a device value raises (build the model's decode
functions first, e.g. by one ``generate``: building them uploads their
constants).  The functions cache nothing on the model beyond its
``_kv_fns``.
"""

import contextlib
from collections import Counter

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef

from ..jit import (_capture, _flatten, _key, _module_keys, _on_side_stream,
                   _sync_allowed, capture_epoch)

__all__ = ["KVFns", "ParamFn", "generate_batch", "generate_device",
           "generate_batch_device", "beam_search", "generate_speculative",
           "generate_speculative_device", "speculative_accept", "cache_map",
           "stacked_zeros", "cache_slot", "host_transfers",
           "release_decoding"]

# host <-> device transfers of the device loops, by function: an upload of
# the prompts, a readback of the tokens, and the speculative loop's read of
# (n, done) once a round
host_transfers = Counter()


def cache_map(fn, cache):
    """``fn`` applied to each tensor of a cache (one tensor, or a tuple)."""
    if isinstance(cache, tuple):
        return tuple(fn(c) for c in cache)
    return fn(cache)


def stacked_zeros(cache, n: int):
    """A zeroed cache of ``n`` slots: each tensor with a leading slot dim."""
    return cache_map(lambda c: c.new_zeros((n,) + tuple(c.shape)), cache)


def cache_slot(caches, i: int):
    """Slot ``i`` of a stacked cache, as views (writes go to the stack)."""
    return cache_map(lambda c: c[i], caches)


def _device(cache):
    return (cache[0] if isinstance(cache, tuple) else cache).device


@contextlib.contextmanager
def _host_io(fn: str, dev):
    """A host <-> device transfer of ``fn``'s device loop: counted in
    :data:`host_transfers`, and run with torch's sync debug mode off."""
    host_transfers[fn] += 1
    with _sync_allowed(dev):
        yield


def _leaves(a):
    """The tensors of an argument: a tensor, or a (nested) tuple of them."""
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, (tuple, list)):
        return [t for x in a for t in _leaves(x)]
    return []


def _param_leaves(params):
    """The tensors of ``.params``: a dict's values, or a tuple of dicts."""
    if isinstance(params, dict):
        return list(params.values())
    if isinstance(params, (tuple, list)):
        return [t for q in params for t in _param_leaves(q)]
    return [params]


def _is_int(a):
    return isinstance(a, (int, np.integer)) \
        and not isinstance(a, (bool, np.bool_))


class _Signature:
    """One signature's record and, once compiled, its slots and graph."""

    def __init__(self, dev, params, static, owners):
        self.dev = dev
        self.epoch = capture_epoch()
        self.params = _param_leaves(params)
        self.static = static        # the values ``static_of`` gave
        self.owners = owners        # weak refs to the in-place buffers
        self.slots = None           # argument index -> static slot
        self.cap = None             # jit's _Captured graph, on a card
        self.outs = self.build = None


class ParamFn:
    """``fn(params, *args)`` bound to ``params`` and compiled: the
    counterpart of the JAX package's ``jax.jit`` of it (module docstring).

    ``by_address``: the indices of the arguments read and written in place
    at their addresses (a cache, a loop's state); every other tensor or
    int argument is copied into a static slot at each call.
    ``generators``: the ``torch.Generator``s ``fn`` draws from, registered
    with each graph.  ``static_of``: a function of the call's arguments
    whose values join the signature and are passed to ``fn`` after them
    (as ``jax.jit``'s static arguments: a shape taken from a host int).
    ``compiled=False`` (a model with sharded parameters) makes every call
    eager.  The capture itself is ``jit``'s; a function's graphs share one
    memory pool (they replay one at a time, and each call copies its
    outputs out).  A signature whose in-place buffers have been freed is
    dropped when the next one records; :meth:`release` drops them all.
    ``captures`` counts the signatures compiled (on the card: the graphs
    captured); :meth:`graphs` reports the live ones."""

    def __init__(self, fn, params, by_address=(0,), generators=(),
                 compiled: bool = True, static_of=None):
        self.fn = fn
        self.params = params
        self.by_address = frozenset(by_address)
        self.generators = tuple(generators)
        self.compiled = compiled
        self.static_of = static_of
        self.captures = 0
        self._sigs = {}
        self._pool = None

    def __call__(self, *args):
        if not self.compiled:
            return self.fn(self.params, *args)
        static = tuple(self.static_of(*args)) if self.static_of else ()
        sig = (self._signature(args), static)
        st = self._sigs.get(sig)
        if st is not None and self._stale(st):
            del self._sigs[sig]
            st = None
        if st is None:
            return self._record(sig, args, static)
        if st.slots is None:
            try:
                self._compile(st, args)
            except BaseException:
                del self._sigs[sig]
                raise
        return self._run(st, args)

    def graphs(self):
        """Per compiled signature: its graph's nodes, the seconds its
        capture took and the kernel launches a replay counts (on the CPU,
        where nothing is captured, nodes and seconds are None)."""
        return [{"nodes": st.cap and st.cap.nodes,
                 "capture_s": st.cap and st.cap.seconds,
                 "launches": dict(st.cap.launches) if st.cap else {}}
                for st in self._sigs.values() if st.slots is not None]

    def release(self):
        """Drop every signature: their graphs and the shared pool return
        their device memory; the next call records again."""
        self._sigs.clear()
        self._pool = None

    def _signature(self, args):
        sig = []
        for i, a in enumerate(args):
            if i in self.by_address:
                sig.append(tuple(_key(t) + (t.device,) for t in _leaves(a)))
            elif isinstance(a, torch.Tensor):
                sig.append((tuple(a.shape), a.dtype, a.device))
            elif _is_int(a):
                sig.append(int)
            else:
                sig.append(("static", repr(a)))
        return tuple(sig)

    def _stale(self, st):
        if st.epoch != capture_epoch():
            return True
        now = _param_leaves(self.params)
        return len(now) != len(st.params) or \
            any(a is not b for a, b in zip(now, st.params))

    def _device_of(self, args):
        for t in _leaves(list(args)) + _param_leaves(self.params):
            if isinstance(t, torch.Tensor):
                return t.device
        return torch.device("cpu")

    # -- record: the first call of a signature, eager --------------------
    def _record(self, sig, args, static):
        # the signatures over buffers freed since (an engine's caches)
        # go, with their graphs
        for k in [k for k, st in self._sigs.items()
                  if any(w.expired() for w in st.owners)]:
            del self._sigs[k]
        dev = self._device_of(args)
        owners = [StorageWeakRef(t.untyped_storage())
                  for i in self.by_address if i < len(args)
                  for t in _leaves(args[i])]
        self._sigs[sig] = _Signature(dev, self.params, static, owners)

        def run():
            return self.fn(self.params, *args, *static)
        return _on_side_stream(dev, run) if dev.type == "cuda" else run()

    # -- compile: the slots, then the capture ----------------------------
    def _compile(self, st, args):
        slots = {}
        for i, a in enumerate(args):
            if i in self.by_address:
                continue
            if isinstance(a, torch.Tensor):
                slots[i] = a.detach().clone()
            elif _is_int(a):
                slots[i] = torch.full((), int(a), dtype=torch.int32,
                                      device=st.dev)
        st.slots = slots
        self.captures += 1
        if st.dev.type == "cuda":
            self._capture(st, args)

    def _call(self, st, args):
        return [st.slots.get(i, a) for i, a in enumerate(args)] \
            + list(st.static)

    def _capture(self, st, args):
        st.cap, out = _capture(
            st.dev, lambda: self.fn(self.params, *self._call(st, args)),
            f"ParamFn: capturing {getattr(self.fn, '__name__', self.fn)}",
            generators=self.generators, pool=self._pool)
        self._pool = st.cap.graph.pool()
        # each output: a tensor of an in-place argument (given back as the
        # caller's own), a tensor of the graph's pool (copied out at each
        # call), or a Python value
        own = {id(t): (i, j) for i in self.by_address if i < len(args)
               for j, t in enumerate(_leaves(args[i]))}
        leaves, st.build = _flatten(out)
        st.outs = [("arg", own[id(x)]) if id(x) in own else
                   ("pool", x) if isinstance(x, torch.Tensor) else ("value", x)
                   for x in leaves]

    # -- run: copy in, replay, copy out ----------------------------------
    def _run(self, st, args):
        for i, s in st.slots.items():
            a = args[i]
            if isinstance(a, torch.Tensor):
                s.copy_(a)
            else:
                s.fill_(int(a))
        if st.cap is None:
            return self.fn(self.params, *self._call(st, args))
        st.cap.replay()
        return st.build([_leaves(args[v[0]])[v[1]] if kind == "arg"
                         else v.clone() if kind == "pool" else v
                         for kind, v in st.outs])


def _own(pf):
    """A :class:`ParamFn` of ``pf``'s function, parameters and options,
    with graphs of its own (an engine's, freed with the engine)."""
    return ParamFn(pf.fn, pf.params, by_address=pf.by_address,
                   generators=pf.generators, compiled=pf.compiled,
                   static_of=pf.static_of)


class KVFns:
    """The (init_cache, prefill, step) triple every ``_kv_functions``
    returns, iterable for the 3-way unpack, plus ``extend`` (K tokens at
    positions pos0..pos0+K-1 in one pass) and ``step_batch`` (B slots in one
    weight stream).  ``workspace`` holds what the loops keep for each
    signature (stacked caches, loop state, compiled loop bodies)."""

    def __init__(self, init_cache, prefill, step, extend=None,
                 step_batch=None):
        self.init_cache = init_cache
        self.prefill = prefill
        self.step = step
        self.extend = extend
        self.step_batch = step_batch
        self.workspace = {}
        self.weights = None

    def __iter__(self):
        return iter((self.init_cache, self.prefill, self.step))

    def functions(self):
        """Every :class:`ParamFn` of these functions and of the loops."""
        out = [self.prefill, self.step, self.extend, self.step_batch]
        for v in self.workspace.values():
            out += [v] if isinstance(v, ParamFn) else \
                [x for x in v if isinstance(x, ParamFn)] \
                if isinstance(v, tuple) else []
        return [f for f in out if isinstance(f, ParamFn)]

    def release(self):
        """Drop what the loops keep (stacked caches, loop state, compiled
        loop bodies) and every compiled graph of the functions: their
        device memory returns, and the next call records again."""
        for f in self.functions():
            f.release()
        self.workspace.clear()

    def generator(self, dev):
        """The device loops' sampling generator on ``dev``: one, kept, so
        that the graphs that draw from it can register it."""
        key = ("generator", str(dev))
        g = self.workspace.get(key)
        if g is None:
            g = self.workspace[key] = torch.Generator(device=dev)
        return g


def last_row(x, n_real):
    """Row ``n_real - 1`` of ``x (W, d)`` as (1, d): ``n_real`` a host
    int, or an int device scalar read there through an index tensor (as a
    compiled prefill takes it; the JAX package traces it)."""
    if isinstance(n_real, torch.Tensor):
        return x.index_select(0, n_real.reshape(1).long() - 1)
    return x[n_real - 1][None]


def _window(model):
    cfg = model.cfg
    return getattr(cfg, "n_positions", None) or cfg.max_position_embeddings


def _log_softmax(x):
    x = np.asarray(x, np.float64)
    m = x.max()
    e = np.exp(x - m)
    return x - m - np.log(e.sum())


def _weights(model):
    """What a model's decode functions read their parameters from: a
    ``torch.nn`` model's module keys (``jit``'s guard), a tape model's
    parameter buffers (``load_parameters`` rebinds them), or None for an
    object with ``_kv_functions`` alone (its functions are kept)."""
    if isinstance(model, torch.nn.Module):
        return _module_keys(list(model.modules()))
    params = getattr(model, "parameters", None)
    return None if params is None else [t._raw_data() for t in params()]


def _same_weights(was, now):
    """Whether two :func:`_weights` of a model are the same weights."""
    if isinstance(now, tuple):
        return was == now
    return len(was) == len(now) and all(a is b for a, b in zip(was, now))


def _kv(model):
    """The model's :class:`KVFns`, built at first use, and built again
    when a parameter, buffer or submodule it had is no longer the object
    or buffer it was: the functions read the parameters they were built
    over."""
    fns = model.__dict__.get("_kv_fns")
    now = _weights(model)
    if fns is not None and fns.weights is not None \
            and not _same_weights(fns.weights, now):
        fns.release()
        fns = None
    if fns is None:
        fns = model._kv_fns = model._kv_functions()
        fns.weights = now
    return fns


def release_decoding(model):
    """Drop the model's kept decode state (:meth:`KVFns.release`): the
    stacked caches and loop state its loops keep for each signature, and
    every compiled graph of its decode functions."""
    fns = model.__dict__.get("_kv_fns")
    if fns is not None:
        fns.release()


def _stack(fns, key, n: int):
    """The stacked cache of ``n`` slots the loops keep under ``key``,
    zeroed on the device: allocated once, so a compiled function that
    writes it replays at the same address at every call."""
    caches = fns.workspace.get((key, n))
    if caches is None:
        caches = fns.workspace[(key, n)] = stacked_zeros(fns.init_cache(), n)
    else:
        cache_map(torch.Tensor.zero_, caches)
    return caches


def _admit_program(fns):
    """``admit(caches, slot, toks, n_real) -> logits``: the prefill into
    slot ``slot`` of a stacked cache, compiled once for every slot (the JAX
    engine's ``admit_impl``): the prompt is prefilled into a fresh cache,
    which is then copied into the slot at a device index.  A new
    :class:`ParamFn` at each call (an engine keeps its own)."""
    prefill, init_cache = fns.prefill, fns.init_cache

    def admit_fn(p, caches, slot, toks, n_real, *static):
        cache, logits = prefill.fn(p, init_cache(), toks, n_real, *static)
        at = slot.reshape(1).long() if isinstance(slot, torch.Tensor) \
            else slice(slot, slot + 1)
        for dst, src in zip(_leaves(caches), _leaves(cache)):
            dst[at] = src[None]
        return logits

    static_of = None
    if prefill.static_of is not None:
        def static_of(caches, slot, toks, n_real):
            return prefill.static_of(None, toks, n_real)

    return ParamFn(admit_fn, prefill.params, compiled=prefill.compiled,
                   static_of=static_of)


def _admit_fn(fns):
    """The loops' admission (:func:`_admit_program`), kept on ``fns``."""
    admit = fns.workspace.get("admit")
    if admit is None:
        admit = fns.workspace["admit"] = _admit_program(fns)
    return admit


def _prefill_rows(fns, caches, toks, prompts):
    """Each prompt prefilled into its slot of ``caches`` by the compiled
    admission (one graph for every slot): (B, V) logits."""
    admit = _admit_fn(fns)
    return torch.stack([admit(caches, i, toks[i], len(pr))
                        for i, pr in enumerate(prompts)])


def _categorical(prob, generator):
    """One draw from each row of ``prob (..., V)`` as ``torch.multinomial
    (prob, 1)`` makes it after its checks (the exponential race: argmax of
    p / q with q ~ Exp(1)), minus those checks' host read: the same ids
    from the same generator state.  Returns int64 ids (...)."""
    q = torch.empty_like(prob).exponential_(1, generator=generator)
    return torch.argmax(prob / q, dim=-1)


def _device_sample(logits, generator, temperature: float, top_k: int,
                   top_p: float):
    """On-device sampling of (..., V) logits: greedy (temperature <= 0),
    temperature, top-k and top-p truncation.  ``generator`` is a
    ``torch.Generator`` on the logits' device.  Mirrors the host sampler
    (gpt._sample) minus repetition_penalty.  Nothing is read to the host.
    Returns int64 ids (...)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    lg = logits.float()
    if top_k and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    z = (lg - lg.max(-1, keepdim=True).values) / temperature
    if 0.0 < top_p < 1.0:
        prob = torch.softmax(z, -1)
        psort, order = torch.sort(prob, dim=-1, descending=True)
        keep_sorted = torch.cumsum(psort, -1) - psort < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        z = z.masked_fill(~keep, float("-inf"))
    return _categorical(torch.softmax(z, -1), generator)


def _trim_eos(seq, eos_id):
    out = []
    for t in seq:
        out.append(int(t))
        if eos_id is not None and int(t) == eos_id:
            break
    return out


def _padded(prompts, W):
    """(B, W) int64 host tensor of the prompts, right-padded with 0."""
    toks = torch.zeros((len(prompts), W), dtype=torch.long)
    for i, pr in enumerate(prompts):
        toks[i, :len(pr)] = torch.as_tensor(pr, dtype=torch.long)
    return toks


def generate_batch(model, prompts, max_new_tokens: int,
                   temperature: float = 0.0, rng=None, top_k: int = 0,
                   top_p: float = 0.0, eos_id: int = None):
    """B ragged prompts decode together: one compiled prefill per prompt
    into its slot of a stacked cache, then one compiled ``step_batch``
    call per generated round for the whole batch, sampled on the host.
    Finished rows re-write their last cache slot harmlessly until every row
    hits ``eos_id``.

    Returns a list of B token lists (prompt + generated, eos included)."""
    from .gpt import _sample

    W = _window(model)
    B = len(prompts)
    lens = [len(p) for p in prompts]
    assert max(lens) + max_new_tokens <= W, (
        f"prompt+new must fit the window ({max(lens)}+{max_new_tokens} > {W})")
    fns = _kv(model)
    caches = _stack(fns, "batch", B)
    toks = _padded(prompts, W).to(_device(caches))
    logits = _prefill_rows(fns, caches, toks, prompts)
    rng = rng or np.random.default_rng(0)
    outs = [list(p) for p in prompts]
    finished = [False] * B
    for t in range(max_new_tokens):
        if t > 0:
            pos = torch.tensor([len(o) - 1 for o in outs], dtype=torch.int32)
            tok = torch.tensor([o[-1] for o in outs], dtype=torch.long)
            caches, logits = fns.step_batch(caches, pos.to(toks.device),
                                            tok.to(toks.device))
        lg = logits.float().cpu().numpy()
        for i in range(B):
            if finished[i]:
                continue
            outs[i].append(int(_sample(lg[i], temperature, rng, top_k=top_k,
                                       top_p=top_p)))
            if eos_id is not None and outs[i][-1] == eos_id:
                finished[i] = True
        if all(finished):
            break
    return outs


def _first_tokens(model, fns, prompts, fn, key):
    """Upload the prompts (one transfer of ``fn``), prefill each into its
    slot of the stacked cache kept under ``key``: (caches, (B, V) logits,
    (B,) int32 device positions of the next token)."""
    W = _window(model)
    caches = _stack(fns, key, len(prompts))
    dev = _device(caches)
    toks = _padded(prompts, W)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    with _host_io(fn, dev):
        toks, poss = toks.to(dev), lens.to(dev)
    return caches, _prefill_rows(fns, caches, toks, prompts), poss


def _loop_state(fns, B, max_new_tokens, dev):
    """The device loop's state for B rows, kept for the signature: the
    positions, the last tokens, the eos flags, the eos id, the output
    buffer and the step index."""
    key = ("loop state", B, max_new_tokens)
    st = fns.workspace.get(key)
    if st is None:
        st = fns.workspace[key] = dict(
            poss=torch.zeros(B, dtype=torch.int32, device=dev),
            tok=torch.zeros(B, dtype=torch.long, device=dev),
            done=torch.zeros(B, dtype=torch.bool, device=dev),
            eos=torch.zeros(B, dtype=torch.long, device=dev),
            out=torch.zeros((B, max_new_tokens), dtype=torch.long,
                            device=dev),
            i=torch.zeros(1, dtype=torch.long, device=dev))
    return st


def _loop_body(fns, batched, gen, temperature, top_k, top_p):
    """One compiled step of the device loop, for one sampling signature:
    the step over all B rows, the on-device sample, the eos hold, the
    token written into the output buffer at the device index, and the
    positions moved on, all in place (as the JAX package's scan carry)."""
    key = ("loop body", batched, temperature, top_k, top_p)
    body = fns.workspace.get(key)
    if body is not None:
        return body
    if not batched:
        step = fns.step

        def advance(p, caches, poss, tok):
            return step.fn(p, cache_slot(caches, 0), poss, tok)[1][None]
    elif fns.step_batch is not None:
        step = fns.step_batch

        def advance(p, caches, poss, tok):
            return step.fn(p, caches, poss, tok)[1]
    else:
        step = fns.step

        def advance(p, caches, poss, tok):
            return torch.stack([
                step.fn(p, cache_slot(caches, b), poss[b:b + 1],
                        tok[b:b + 1])[1] for b in range(tok.shape[0])])

    def body_fn(p, caches, poss, tok, done, eos, out, i):
        logits = advance(p, caches, poss, tok)
        nxt = _device_sample(logits, gen, temperature, top_k, top_p)
        t = torch.where(done, eos, nxt)
        done.logical_or_(t == eos)
        out.index_copy_(1, i, t[:, None])
        tok.copy_(t)
        poss.add_(1)
        i.add_(1)

    body = fns.workspace[key] = ParamFn(
        body_fn, step.params, by_address=range(7), generators=(gen,),
        compiled=step.compiled)
    return body


def _device_loop(fns, batched, caches, logits, poss, max_new_tokens, gen,
                 temperature, top_k, top_p, eos_id):
    """The decode loop of :func:`generate_device` / ``_batch_device`` on
    the device: the first token sampled from the prefill's logits, then
    one replay of the compiled loop body a token; after ``eos_id`` a row
    keeps feeding (and holding) eos, as the JAX package's scan carry does,
    for the fixed cost of ``max_new_tokens`` steps.  Returns the (B,
    max_new_tokens) int64 token buffer on the device, not read back."""
    B = logits.shape[0]
    st = _loop_state(fns, B, max_new_tokens, logits.device)
    st["eos"].fill_(-1 if eos_id is None else eos_id)
    tok = _device_sample(logits, gen, temperature, top_k, top_p)
    st["tok"].copy_(tok)
    torch.eq(tok, st["eos"], out=st["done"])
    st["out"][:, 0] = tok
    st["poss"].copy_(poss)
    st["i"].fill_(1)
    body = _loop_body(fns, batched, gen, temperature, top_k, top_p)
    for _ in range(1, max_new_tokens):
        body(caches, st["poss"], st["tok"], st["done"], st["eos"],
             st["out"], st["i"])
    return st["out"]


@torch.no_grad()
def generate_device(model, ids, max_new_tokens: int, temperature: float = 0.0,
                    top_k: int = 0, top_p: float = 0.0, eos_id: int = None,
                    seed: int = 0):
    """Whole-generation decoding on the device: one compiled prefill, then
    ``max_new_tokens - 1`` replays of the compiled step with its on-device
    sampling (``_device_sample`` with the model's kept
    ``torch.Generator``, reseeded by ``seed``).  The host uploads the
    prompt once and reads the tokens back once; inside the loop nothing
    reads the device, so the host enqueues replays ahead of the card
    instead of waiting for every token's logits as ``generate`` does.

    No streaming callback and no repetition_penalty (it needs the emitted
    history on the host); post-eos steps still run.  Returns prompt +
    generated ids (eos included, post-eos slots trimmed)."""
    W = _window(model)
    assert len(ids) + max_new_tokens <= W, (
        f"prompt+new must fit the window ({len(ids)}+{max_new_tokens} > {W})")
    fns = _kv(model)
    caches, logits, poss = _first_tokens(model, fns, [list(ids)],
                                         "generate_device", "loop")
    gen = fns.generator(logits.device).manual_seed(seed)
    out = _device_loop(fns, False, caches, logits, poss, max_new_tokens, gen,
                       temperature, top_k, top_p, eos_id)
    with _host_io("generate_device", out.device):
        new = out[0].tolist()
    return list(ids) + _trim_eos(new, eos_id)


@torch.no_grad()
def generate_batch_device(model, prompts, max_new_tokens: int,
                          temperature: float = 0.0, top_k: int = 0,
                          top_p: float = 0.0, eos_id: int = None,
                          seed: int = 0):
    """Batched whole-generation decoding on the device: B ragged prompts,
    one compiled prefill each into a stacked cache, then one replay of the
    compiled ``step_batch`` round for all B rows (one weight stream; a
    model without it steps each slot in turn).  Sampled rows draw from one
    generator seeded by ``seed``.  One upload and one readback.

    Returns a list of B token lists (prompt + generated, trimmed at eos)."""
    W = _window(model)
    lens = [len(p) for p in prompts]
    assert max(lens) + max_new_tokens <= W, (
        f"prompt+new must fit the window ({max(lens)}+{max_new_tokens} > {W})")
    fns = _kv(model)
    caches, logits, poss = _first_tokens(model, fns, prompts,
                                         "generate_batch_device", "loop")
    gen = fns.generator(logits.device).manual_seed(seed)
    out = _device_loop(fns, True, caches, logits, poss, max_new_tokens, gen,
                       temperature, top_k, top_p, eos_id)
    with _host_io("generate_batch_device", out.device):
        new = out.tolist()
    return [list(pr) + _trim_eos(row, eos_id)
            for pr, row in zip(prompts, new)]


def _best(lp, n):
    """Indices of the ``n`` largest of ``lp``, ties in index order (so
    ``n = 1`` is ``np.argmax``)."""
    return np.argsort(-lp, kind="stable")[:n]


def _reorder(caches, parents):
    """Slot k of the stacked beam caches becomes a copy of slot
    ``parents[k]``: a device gather into the same buffers, so the step
    graphs over the slots replay at their addresses.  No-op when every
    beam keeps its slot."""
    if list(parents) == list(range(len(parents))):
        return
    idx = torch.tensor(parents, dtype=torch.long,
                       device=_device(caches))
    cache_map(lambda c: c[:len(parents)].copy_(c.index_select(0, idx)),
              caches)


@torch.no_grad()
def beam_search(model, ids, max_new_tokens: int, beam_size: int = 4,
                eos_id: int = None, length_penalty: float = 1.0):
    """Length-normalized beam search; returns the best token sequence
    (prompt + generated).  ``length_penalty`` > 1 favors longer outputs;
    hypotheses are scored ``logprob / n_generated**length_penalty``.
    The beam bookkeeping is host-side float64 numpy over the step's logits.

    The beams live in ``beam_size`` slots of one stacked cache, kept for
    the signature: the compiled prefill writes slot 0, each live beam
    steps its slot in place through the compiled step (one graph a slot),
    and each round's survivors are gathered into the slots on the device
    (:func:`_reorder`), where the JAX package shares immutable caches
    between them.  ``beam_size=1`` is exactly greedy decoding."""
    ids = list(ids)
    W = _window(model)
    assert len(ids) + max_new_tokens <= W, (
        f"beam search needs prompt+new <= window ({len(ids)}+{max_new_tokens}"
        f" > {W})")
    fns = _kv(model)
    stack = _stack(fns, "beam", beam_size)
    toks = _padded([ids], W).to(_device(stack))
    logits = _prefill_rows(fns, stack, toks, [ids])[0]
    lp = _log_softmax(logits.float().cpu().numpy())
    first = _best(lp, beam_size)
    _reorder(stack, [0] * len(first))
    # beam: (token list, cumulative logprob, slot)
    beams = [(ids + [int(t)], float(lp[t]), j) for j, t in enumerate(first)]
    done = []

    def finalize(seq, score):
        n_gen = len(seq) - len(ids)
        done.append((seq, score / n_gen ** length_penalty))

    def live(seq):
        return eos_id is None or seq[-1] != eos_id

    for _ in range(max_new_tokens - 1):
        candidates = []
        for seq, score, j in beams:
            if not live(seq):
                finalize(seq, score)
                continue
            _, logits = fns.step(cache_slot(stack, j), len(seq) - 1, seq[-1])
            lp = _log_softmax(logits.float().cpu().numpy())
            for t in _best(lp, beam_size):
                candidates.append((seq + [int(t)], score + float(lp[t]), j))
        if not candidates:
            break
        candidates.sort(key=lambda b: b[1], reverse=True)
        chosen = candidates[:beam_size]
        _reorder(stack, [j for _, _, j in chosen])
        beams = [(seq, score, k) for k, (seq, score, _) in enumerate(chosen)]
        if len(done) >= beam_size:
            break
    for seq, score, _ in beams:
        if live(seq):  # eos'd beams already final
            finalize(seq, score)
    return max(done, key=lambda d: d[1])[0]


def speculative_accept(p_draft, p_target, proposed, rng):
    """One speculative rejection-sampling decision (Leviathan et al. 2023,
    arXiv:2211.17192 App. A).  ``proposed`` was sampled from ``p_draft``;
    accept it with probability ``min(1, p_t[x] / p_d[x])``, otherwise
    resample from the residual ``normalize(max(p_t - p_d, 0))``.  The
    marginal law of the returned token is exactly ``p_target``.

    Returns ``(token, accepted)``."""
    x = int(proposed)
    if rng.random() < min(1.0, float(p_target[x])
                          / max(float(p_draft[x]), 1e-20)):
        return x, True
    resid = np.maximum(np.asarray(p_target, np.float64)
                       - np.asarray(p_draft, np.float64), 0.0)
    s = resid.sum()
    if s <= 0.0:  # distributions identical: rejection cannot occur, but
        return x, True  # guard the degenerate float case anyway
    return int(rng.choice(len(resid), p=resid / s)), False


def _verify(fns, cache, pos0, toks, params=None):
    """The target's logits at positions pos0..pos0+K-1 for ``toks (K,)``:
    one ``extend`` pass where the model has one (one weight read for the K
    rows), else K ``step``s; compiled, or with ``params`` the functions'
    ``.fn`` inside a caller's graph.  ``pos0`` a host int or an int32 (1,)
    device tensor.  Returns (cache, (K, V) logits)."""
    def call(f, *a):
        return f(*a) if params is None else f.fn(params, *a)
    if fns.extend is not None:
        return call(fns.extend, cache, pos0, toks)
    rows = []
    for i in range(toks.shape[0]):
        cache, lg = call(fns.step, cache, pos0 + i, toks[i:i + 1])
        rows.append(lg)
    return cache, torch.stack(rows)


@torch.no_grad()
def generate_speculative(model, draft, ids, max_new_tokens: int, k: int = 4,
                         eos_id: int = None, temperature: float = 0.0,
                         rng=None):
    """Draft-accelerated decoding (speculative decoding,
    https://arxiv.org/abs/2211.17192), driven from the host.

    Each round the cheap ``draft`` proposes ``k`` tokens autoregressively,
    then ``model`` scores all k+1 positions (one ``extend`` pass where the
    model has one, else k+1 steps).

    * ``temperature<=0`` (greedy): the longest draft prefix matching the
      target's own argmax choices is accepted, plus the target's
      correction/bonus token -- the output is plain greedy decoding of
      ``model``.
    * ``temperature>0`` (sampled): each proposal goes through
      :func:`speculative_accept` against the target's tempered softmax, so
      every emitted token's marginal law is the target distribution.

    Rejected proposals leave stale K/V rows beyond the accepted position;
    the ``<= pos`` attention mask hides them and the next round's writes
    overwrite them.  Both models must share a vocabulary.  Returns prompt
    + generated."""
    W = min(_window(model), _window(draft))
    ids = [int(t) for t in ids]
    # + k: a verify pass can write up to k rows past the final accepted
    # position; they must stay inside the window
    assert len(ids) + max_new_tokens + k <= W, (len(ids), max_new_tokens, k, W)
    t_fns, d_fns = _kv(model), _kv(draft)
    rng = rng or np.random.default_rng(0)
    sampled = temperature > 0.0

    def probs(logits):
        z = logits.float().cpu().numpy().astype(np.float64) / temperature
        z -= z.max(-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(-1, keepdims=True)

    # caches kept for the signature (a target that is its own draft keeps
    # two), so the compiled functions replay at their addresses
    t_cache = cache_slot(_stack(t_fns, "speculative target", 1), 0)
    d_cache = cache_slot(_stack(d_fns, "speculative draft", 1), 0)
    dev = _device(t_cache)
    t_cache, t_logits = t_fns.prefill(
        t_cache, _padded([ids], _window(model))[0].to(dev), len(ids))
    d_cache, _ = d_fns.prefill(
        d_cache, _padded([ids], _window(draft))[0].to(_device(d_cache)),
        len(ids))

    out = list(ids)
    if sampled:
        first = probs(t_logits)
        out.append(int(rng.choice(len(first), p=first)))
    else:
        out.append(int(torch.argmax(t_logits)))
    if eos_id is not None and out[-1] == eos_id:
        return out
    while len(out) - len(ids) < max_new_tokens:
        # budget-capped proposal length (never decode past max_new_tokens)
        kk = min(k, max_new_tokens - (len(out) - len(ids)))
        proposals, d_probs, tok, pos = [], [], out[-1], len(out) - 1
        for j in range(kk):
            d_cache, dl = d_fns.step(d_cache, pos + j, tok)
            if sampled:
                pd = probs(dl)
                tok = int(rng.choice(len(pd), p=pd))
                d_probs.append(pd)
            else:
                tok = int(torch.argmax(dl))
            proposals.append(tok)
        vt = torch.tensor([out[-1]] + proposals + [0] * (k - kk),
                          dtype=torch.long)
        t_cache, t_rows = _verify(t_fns, t_cache, len(out) - 1, vt.to(dev))
        if sampled:
            pt = probs(t_rows)
            accepted = []
            for m in range(kk):
                tok, ok = speculative_accept(d_probs[m], pt[m], proposals[m],
                                             rng)
                accepted.append(int(tok))
                if not ok:
                    break
            else:
                # every proposal accepted: free bonus token from the target
                accepted.append(int(rng.choice(pt.shape[1], p=pt[kk])))
        else:
            preds = t_rows.argmax(-1).tolist()
            m = 0
            while m < kk and proposals[m] == preds[m]:
                m += 1
            # preds[m] is the correction on mismatch, the free bonus token
            # when every proposal was accepted -- valid either way
            accepted = proposals[:m] + [preds[m]]
        new = accepted[: max_new_tokens - (len(out) - len(ids))]
        out.extend(new)
        if eos_id is not None and eos_id in new:
            return out[: out.index(eos_id, len(ids)) + 1]
    return out


def _accept_device(props, dlogits, trows, generator, temperature):
    """The accept rule of :func:`generate_speculative_device` on the
    device.  props (k,) the draft's proposals, dlogits (k, V) its logits,
    trows (k+1, V) the target's.  Returns (m, emit): m (1,) the number of
    accepted proposals, emit (k+1,) with emit[:m] = props[:m] and emit[m]
    the target's correction (or bonus token when m = k)."""
    k = props.shape[0]
    tail = torch.zeros(1, dtype=props.dtype, device=props.device)
    if temperature <= 0.0:
        preds = torch.argmax(trows, dim=-1)
        m = (props == preds[:k]).int().cumprod(0).sum().reshape(1)
        corr = preds.gather(0, m)
    else:
        tp = torch.softmax(trows.float() / temperature, -1)
        dp = torch.softmax(dlogits.float() / temperature, -1)
        us = torch.rand(k, generator=generator, device=props.device)
        px_t = tp[:k].gather(1, props[:, None])[:, 0]
        px_d = dp.gather(1, props[:, None])[:, 0]
        accept = us < torch.clamp(px_t / px_d.clamp_min(1e-20), max=1.0)
        m = accept.int().cumprod(0).sum().reshape(1)
        # rejection at m < k: resample the residual max(p_t - p_d, 0); a
        # degenerate all-zero residual keeps the proposal (identical
        # distributions cannot truly reject -- an f32 guard only)
        mr = m.clamp(max=k - 1)
        resid = (tp.index_select(0, mr) - dp.index_select(0, mr)).clamp_min(
            0.0)[0]
        rtok = torch.where(resid.sum() > 0,
                           _categorical(resid, generator).reshape(1),
                           props.gather(0, mr))
        # all k accepted: free bonus token from the target's k-th row
        btok = _categorical(tp[k], generator).reshape(1)
        corr = torch.where(m == k, btok, rtok)
    emit = torch.cat([props, tail]).scatter(0, m, corr)
    return m, emit


def _spec_round(t_fns, d_fns, k, temperature, gen):
    """One compiled round of :func:`generate_speculative_device`: the
    draft's k proposals (each a step and an on-device sample), the target's
    verify pass, the accept rule, the emitted tokens written into the
    buffer at the device count, and (n, done) and the last token moved on,
    all in place."""
    key = ("speculative round", k, temperature)
    kept = t_fns.workspace.get(key)
    if kept is not None and kept[0] is d_fns:
        return kept[1]

    def round_fn(params, d_cache, t_cache, state, last, buf, base, eos):
        tp, dp = params
        pos = base + state[0].int()
        tok, props, dlogits = last, [], []
        for i in range(k):
            _, dl = d_fns.step.fn(dp, d_cache, pos + i, tok)
            tok = _device_sample(dl[None], gen, temperature, 0, 0.0)
            props.append(tok)
            dlogits.append(dl)
        props = torch.cat(props)
        _, trows = _verify(t_fns, t_cache, pos, torch.cat([last, props]),
                           params=tp)
        m, emit = _accept_device(props, torch.stack(dlogits), trows, gen,
                                 temperature)
        # emit[:m+1] are real; the tail is overwritten by the next round's
        # write (from n+m+1) or trimmed on the host
        steps = torch.arange(k + 1, device=buf.device)
        buf.index_copy_(0, state[0] + steps, emit)
        hit = ((emit == eos) & (steps <= m)).any().reshape(1)
        state.copy_(torch.stack([state[0] + m + 1, state[1] | hit]))
        last.copy_(emit.gather(0, m))

    fn = ParamFn(round_fn, (t_fns.step.params, d_fns.step.params),
                 by_address=range(7), generators=(gen,),
                 compiled=t_fns.step.compiled and d_fns.step.compiled)
    t_fns.workspace[key] = (d_fns, fn)
    return fn


@torch.no_grad()
def generate_speculative_device(model, draft, ids, max_new_tokens: int,
                                k: int = 4, temperature: float = 0.0,
                                eos_id: int = None, seed: int = 0):
    """Speculative decoding with every round on the device: the draft's k
    proposals, the target's verify pass and the accept rule (greedy
    longest-prefix; sampled Leviathan rejection, residual resample and
    bonus token, in f32) run as one compiled round (:func:`_spec_round`)
    into a buffer of ``max_new_tokens + k`` slots.

    The JAX package's ``while_loop`` tests (n, done) once a round on the
    device.  Here the host reads those two values once a round -- the one
    host read inside the loop, counted in :data:`host_transfers` -- and
    nothing else; the tokens come back once at the end.  Greedy output is
    plain greedy decoding of ``model``, as :func:`generate_device`'s;
    sampled output is marginally exact.

    Both models must share a vocabulary.  Returns prompt + generated ids.
    """
    assert k >= 1, "need at least one draft proposal per round"
    fn = "generate_speculative_device"
    ids = [int(t) for t in ids]
    # + k: a verify pass can write up to k rows past the final accepted
    # position; they must stay inside both windows
    assert len(ids) + max_new_tokens + k <= min(_window(model),
                                                 _window(draft)), (
        len(ids), max_new_tokens, k, _window(model), _window(draft))
    t_fns, d_fns = _kv(model), _kv(draft)
    t_cache, t_logits, base = _first_tokens(model, t_fns, [ids], fn,
                                            "speculative target")
    d_cache, _, _ = _first_tokens(draft, d_fns, [ids], fn,
                                  "speculative draft")
    t_cache, d_cache = cache_slot(t_cache, 0), cache_slot(d_cache, 0)
    dev = t_logits.device
    gen = t_fns.generator(dev).manual_seed(seed)
    key = ("speculative state", k, max_new_tokens)
    st = t_fns.workspace.get(key)
    if st is None:
        st = t_fns.workspace[key] = dict(
            state=torch.zeros((2, 1), dtype=torch.long, device=dev),
            last=torch.zeros(1, dtype=torch.long, device=dev),
            buf=torch.zeros(max_new_tokens + k, dtype=torch.long,
                            device=dev),
            base=torch.zeros(1, dtype=torch.int32, device=dev),
            eos=torch.zeros(1, dtype=torch.long, device=dev))
    st["eos"].fill_(-1 if eos_id is None else eos_id)
    last = _device_sample(t_logits, gen, temperature, 0, 0.0)    # (1,)
    st["last"].copy_(last)
    st["buf"].zero_()
    st["buf"][:1] = last
    # (n, done)
    st["state"].copy_(torch.stack([torch.ones_like(last),
                                   (last == st["eos"]).long()]))
    st["base"].copy_(base - 1)     # the position of `last` is base + n
    rnd = _spec_round(t_fns, d_fns, k, temperature, gen)
    while True:
        with _host_io(fn, dev):
            n, done = st["state"].tolist()
        if n[0] >= max_new_tokens or done[0]:
            break
        rnd(d_cache, t_cache, st["state"], st["last"], st["buf"],
            st["base"], st["eos"])
    with _host_io(fn, dev):
        new = st["buf"][:min(n[0], max_new_tokens)].tolist()
    return ids + _trim_eos(new, eos_id)
