"""Time the elementwise kernel, and the training steps that run it, of one
checkout of the port, so that two checkouts can be compared on one card.

    python3 scripts/ab_elementwise.py --tree DIR [--steps N] [--no-steps]
                                      [--no-kernels] [--tally]
                                      [--paths NAME,...] [--tally-out FILE]
                                      [--classes RE] [--repeat N]

imports ``lightgrad_tpu_torch`` from DIR (a checkout of any commit since the
tape was ported), builds its kernels there, and prints one JSON line:

- the card's name and power limit (``nvidia-smi``) and the Triton version;
- unless ``--no-kernels``, ``ops.elementwise.ew`` by CUDA graph with L2
  flushed (operand sets rotated through at least ``FLUSH_BYTES``; the
  device time of the wrapper's whole call) at ``f_gelu`` (1024, 3072) and
  at the main paths' classes (``CLASSES``: body, operand shapes, strides
  of views, dtypes, Python scalars), float32 and bfloat16 where the path
  runs both, beside one PyTorch call for the same function (``LIBRARY``,
  null where none), the least time the card could take (each operand read
  once at its own size, outputs written once, at 3.35 TB/s), the widths of
  the kernel's global loads and stores (from the PTX Triton compiled), the
  largest error against ``ew_reference``, whether two calls agree bit for
  bit, and the launches and operand copies of one call (``--classes``: the
  classes whose label matches; ``--repeat N``: N timings a class, its ms
  their median); then the host µs
  of eager calls on 64 rows: the whole ``ew`` call, Triton's launch alone,
  the op set's scalar multiply (``_scalar`` then ``ew``), ``torch.add``
  and ``torch.mul``;
- with ``--tally``, one step of each main path that launches ``ew``
  (``PATHS``: ResNet-18, BERT-base, Pythia-1B, ResNet-20 on 128 digits,
  the 2-layer Mistral-7B and Gemma-2B tape steps, Pythia-1B greedy
  generate) with every ``ew`` call counted by class (body, dtypes,
  canonical dims, each operand's broadcast mode and layout: contiguous,
  a view, or a Python scalar), the operand copies and scalar uploads the
  calls made, each class's device µs in that step (its ``ew_kernel``
  launches matched in order in a ``torch.profiler`` trace), and every
  synchronisation that ``torch.cuda.set_sync_debug_mode("warn")`` reports
  with its source lines; the classes with at least 1% of a path's
  elementwise device time are then timed as above (``tally_classes``),
  and ``--tally-out`` writes every class with its recipe to a JSON file
  (``ab_elementwise_classes.json`` is the parent's, trimmed to those);
- unless ``--no-steps``, the float32 tape steps of ResNet-18 (32 x 3 x
  224²), BERT-base (masked LM, 8 x 128) and Pythia-1B (2 x 2048, fused
  flash backward): images/s or tokens/s and the host ms that queue a step
  (medians of steps 2-N), peak memory, and one profiled step's device time
  by kernel family with its idle share of the median step.

Run it for two checkouts in the order A, B, B, A within one machine to
compare them; each run is its own process.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter, defaultdict
from math import prod

import numpy as np
import torch

HBM_BPS = 3.35e12
# operand sets of one timed class are rotated through at least this many
# bytes, so that no replay finds its operands in the 50 MB L2
FLUSH_BYTES = 128 << 20
MAX_SETS = 4096
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
# the operands a body's function reads, where it does not read all: b2_add
# and b2_sub return g (and -g), a and b only shape the output
READS = {"b2_add": (0,), "b2_sub": (0,)}
# bodies whose tensor operands must be positive (log, pow)
POSITIVE = {"f_log", "b_log", "f_pow", "b2_pow", "b1_pow"}
FAMILIES = (("matmul_tc_kernel", "matmul"), ("ew_kernel", "elementwise"),
            ("reduce_rows", "reduce"), ("lg_reduce_", "reduce"),
            ("softmax_", "softmax"),
            ("ln_", "layernorm"), ("true>(", "fused flash backward"),
            ("flash", "attention"), ("layout_", "conv layout"),
            ("conv_", "conv"), ("sum_partials", "conv"), ("sum_dw", "conv"))
PYTHIA_1B = dict(vocab_size=50304, hidden_size=2048, intermediate_size=8192,
                 num_hidden_layers=16, num_attention_heads=8,
                 max_position_embeddings=2048, rotary_pct=0.25,
                 rotary_emb_base=10000.0, layer_norm_eps=1e-5,
                 use_parallel_residual=True)
MISTRAL_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                  num_hidden_layers=2, num_attention_heads=32,
                  num_key_value_heads=8, max_position_embeddings=8192,
                  rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=4096,
                  tie_word_embeddings=False)
GEMMA_2B = dict(vocab_size=256000, hidden_size=2048, intermediate_size=16384,
                num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=1, head_dim=256,
                max_position_embeddings=8192, rms_norm_eps=1e-6,
                rope_theta=10000.0, hidden_act="gelu_pytorch_tanh",
                rms_offset=True, scale_embeddings=True,
                tie_word_embeddings=True)
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12)


def T(shape, dtype="float32", stride=None, offset=0):
    """A tensor operand of a class: its shape, strides (None: contiguous)
    and storage offset, as the path gives it to ``ew``."""
    return {"kind": "tensor", "shape": list(shape), "dtype": dtype,
            "stride": None if stride is None else list(stride),
            "offset": offset}


def S(value, dtype="float32"):
    """A Python scalar operand, of the dtype the op set rounds it to."""
    return {"kind": "scalar", "value": value, "dtype": dtype}


# (label, body, n_out, operands): the gate's f_gelu at (1024, 3072), then
# the main paths' classes of ab_elementwise_classes.json: every class with
# at least 1% of a path's elementwise device time in the tally (--tally) of
# the tree before the kernel's redesign, labelled with its path and share
CLASSES = (("gate: f_gelu 1024x3072", "f_gelu", 1, [T((1024, 3072))]),) \
    + tuple((c["label"], c["body"], c["n_out"], c["operands"])
            for c in json.load(open(os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "ab_elementwise_classes.json"))))


def log(rec):
    print(json.dumps(rec), file=sys.stderr, flush=True)


# --- timing -------------------------------------------------------------
def graph_ms(calls, replays=3):
    """Device ms a call of ``calls`` (zero-argument callables): all of them
    captured once in a CUDA graph, replayed between two CUDA events."""
    for fn in calls[:2]:
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * len(calls))
    del graph
    torch.cuda.empty_cache()
    return ms


def host_us(fn, calls=300):
    """Wall µs a call of ``calls`` eager calls ended by one synchronise: at
    64 rows the host's launch work, not the device, sets it."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def rel_err(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1.0))


# --- the tree's API -------------------------------------------------------
def em():
    import importlib
    return importlib.import_module("lightgrad_tpu_torch.ops.elementwise")


def cuda_ops():
    import importlib
    return importlib.import_module("lightgrad_tpu_torch.autograd.cuda.ops")


def scalar_operand(value, dtype, dev):
    """A Python scalar as the tree's op set hands it to ``ew``: a Scalar
    where the tree takes scalars by value, else a 0-d device tensor (made
    here, before any timing, as ``_scalar`` would make it)."""
    mod = em()
    if hasattr(mod, "scalar"):
        return mod.scalar(value, dtype)
    return torch.tensor(value, dtype=dtype, device=dev)


def as_tensor_operand(x, dev):
    """``x`` as ``ew_reference`` takes it: a Scalar as a 0-d tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x.value, dtype=x.dtype, device=dev)


class Launches:
    """While active, records how the tree launches Triton kernels: the
    last ``JITFunction.run`` call (function, args, kwargs) with the PTX of
    the kernels it returned, and the last direct call of a compiled
    kernel's launcher (``CompiledKernel.run``) with its arguments."""

    def __init__(self):
        from triton.compiler.compiler import CompiledKernel
        from triton.runtime.jit import JITFunction
        self.cls, self.orig = JITFunction, JITFunction.run
        self.ck, self.ck_run = CompiledKernel, CompiledKernel.run
        self.last, self.direct, self.ptx = None, None, []

    def __enter__(self):
        orig, ck_run, me = self.orig, self.ck_run, self

        def run(fn, *args, **kwargs):
            me.last = (fn, args, kwargs)
            k = orig(fn, *args, **kwargs)
            asm = getattr(k, "asm", None)
            if asm and "ptx" in asm:
                me.ptx.append(asm["ptx"])
            return k

        def launcher(k):
            inner = ck_run.fget(k)

            def call(*args):
                me.direct = (inner, args)
                return inner(*args)
            return call
        self.cls.run = run
        self.ck.run = property(launcher)
        return self

    def __exit__(self, *exc):
        self.cls.run = self.orig
        self.ck.run = self.ck_run


def access_widths(ptx):
    """Byte widths of the global loads and stores in ``ptx``:
    {"ld": {width: count}, "st": {...}}."""
    out = {}
    for op in ("ld", "st"):
        c = Counter()
        for m in re.finditer(op + r"\.global((?:\.[a-zA-Z0-9_:]+)*)", ptx):
            parts = m.group(1).split(".")
            vec = next((int(p[1:]) for p in parts if re.fullmatch(r"v\d", p)),
                       1)
            bits = next((int(p[1:]) for p in parts
                         if re.fullmatch(r"[bfus]\d+", p)), 0)
            c[vec * bits // 8] += 1
        out[op] = dict(sorted(c.items()))
    return out


# --- classes --------------------------------------------------------------
def storage_numel(shape, stride, offset):
    if prod(shape) == 0:
        return offset
    return offset + sum((n - 1) * s for n, s in zip(shape, stride)) + 1


def contiguous_stride(shape):
    st, acc = [], 1
    for n in reversed(shape):
        st.append(acc)
        acc *= n
    return st[::-1]


def make_sets(body, ops, dev, gen, n_sets=None):
    """Operand sets of a class, each operand at its own layout in its own
    slice of one buffer; ``n_sets`` so that the sets span FLUSH_BYTES.
    Returns (sets, bytes a set reads, bytes of the outputs)."""
    specs, set_bytes = [], 0
    for op in ops:
        dt = DTYPES[op["dtype"]]
        if op["kind"] == "scalar":
            specs.append(None)
            continue
        shape = op["shape"]
        stride = op["stride"] or contiguous_stride(shape)
        need = storage_numel(shape, stride, op["offset"])
        pad = -(-need // 128) * 128
        specs.append((shape, stride, op["offset"], pad, dt))
        set_bytes += pad * torch.tensor([], dtype=dt).element_size()
    if n_sets is None:
        n_sets = max(2, min(MAX_SETS, -(-FLUSH_BYTES // max(set_bytes, 1))))
    bases = []
    for i, (op, sp) in enumerate(zip(ops, specs)):
        if sp is None:
            bases.append(None)
            continue
        shape, stride, off, pad, dt = sp
        n = pad * n_sets
        if dt == torch.int32:
            base = torch.randint(-5, 6, (n,), generator=gen, device=dev,
                                 dtype=torch.int32)
        else:
            base = torch.randn(n, generator=gen, device=dev)
            if body in POSITIVE:
                base = base.abs() + 0.5
            elif body in ("f_div", "b1_div", "b2_div", "b_log") and i > 0:
                base = base.sign() * (base.abs() + 0.5)
            base = base.to(dt)
        bases.append(base)
    sets = []
    for j in range(n_sets):
        xs = []
        for op, sp, base in zip(ops, specs, bases):
            if sp is None:
                xs.append(scalar_operand(op["value"], DTYPES[op["dtype"]],
                                         dev))
            else:
                shape, stride, off, pad, dt = sp
                xs.append(base.as_strided(shape, stride, j * pad + off))
        sets.append(xs)
    return sets, set_bytes


def class_cost(body, ops, outs):
    """Bytes the call must move: each tensor operand that ``body`` reads
    (``READS``) once at its own (broadcast) size, each output written
    once."""
    n = 0
    for j, op in enumerate(ops):
        if op["kind"] == "tensor" and j in READS.get(body, (j,)):
            stride = op["stride"] or contiguous_stride(op["shape"])
            n += prod(k for k, s in zip(op["shape"], stride) if s) \
                * torch.tensor([], dtype=DTYPES[op["dtype"]]).element_size()
    return n + sum(o.numel() * o.element_size() for o in outs)


def library_call(body):
    """One PyTorch call computing ``body``, or None."""
    import torch.nn.functional as F
    aten = torch.ops.aten
    return {
        "f_neg": torch.neg, "b_neg": torch.neg, "f_sin": torch.sin,
        "f_cos": torch.cos, "f_exp": torch.exp, "b_exp": torch.mul,
        "f_log": torch.log, "b_log": torch.div, "f_sigmoid": torch.sigmoid,
        "b_sigmoid": lambda g, y: aten.sigmoid_backward(g, y),
        "f_tanh": torch.tanh, "b_tanh": lambda g, y: aten.tanh_backward(g, y),
        "f_relu": torch.relu,
        "b_relu": lambda g, x: aten.threshold_backward(g, x, 0),
        "f_gelu": lambda x: F.gelu(x, approximate="tanh"),
        "b_gelu": lambda g, x: aten.gelu_backward(g, x, approximate="tanh"),
        "f_gelu_exact": F.gelu,
        "b_gelu_exact": lambda g, x: aten.gelu_backward(g, x),
        "f_add": torch.add, "b1_add": torch.clone, "f_sub": torch.sub,
        "f_mul": torch.mul, "b1_mul": torch.mul, "f_div": torch.div,
        "b1_div": torch.div, "f_pow": torch.pow,
    }.get(body)


def time_class(label, body, n_out, ops, dev, repeat=1):
    from lightgrad_tpu_torch.ops.runtime import (launch_counts,
                                                 reset_launch_counts)
    mod = em()
    gen = torch.Generator(device=dev).manual_seed(0)
    sets, set_bytes = make_sets(body, ops, dev, gen)
    xs = sets[0]
    if hasattr(mod, "_cached_plan"):    # so that the launch below goes
        mod._cached_plan.cache_clear()  # through JITFunction.run: its PTX
    with Launches() as cap:
        got = mod.ew(body, *xs, n_out=n_out)
    torch.cuda.synchronize()
    reset_launch_counts()
    again = mod.ew(body, *xs, n_out=n_out)
    torch.cuda.synchronize()
    counts = launch_counts()
    outs = got if n_out > 1 else (got,)
    agains = again if n_out > 1 else (again,)
    refs = mod.ew_reference(body, *(as_tensor_operand(x, dev) for x in xs),
                            n_out=n_out)
    refs = refs if n_out > 1 else (refs,)
    rec = {"class": label, "body": body, "operands": ops,
           "out": [[list(o.shape), str(o.dtype)[6:]] for o in outs],
           "sets": len(sets), "set_mb": set_bytes / 2**20,
           "ms_runs": [graph_ms([lambda x=x: mod.ew(body, *x, n_out=n_out)
                                 for x in sets]) for _ in range(repeat)],
           "bound_ms": class_cost(body, ops, outs) / HBM_BPS * 1e3,
           "err": max(rel_err(o, r) for o, r in zip(outs, refs)),
           "bitwise_repeat": all(torch.equal(a, b)
                                 for a, b in zip(outs, agains)),
           "launches": counts.get("elementwise", 0),
           "copies": counts.get("elementwise_copy", 0),
           "widths": access_widths("\n".join(cap.ptx)) if cap.ptx else None}
    lib = library_call(body)
    rec["library_ms"] = None
    if lib is not None:
        def lib_args(x):
            return [a.value if hasattr(a, "value") and not isinstance(
                a, torch.Tensor) else a for a in x]
        try:
            lib(*lib_args(xs))
            rec["library_ms"] = graph_ms([lambda x=x: lib(*lib_args(x))
                                          for x in sets])
        except Exception as e:      # a mix of dtypes the op does not take
            rec["library_error"] = f"{type(e).__name__}: {e}"[:200]
    rec["ms"] = float(np.median(rec["ms_runs"]))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(rec)
    del sets, xs, got, again, refs
    torch.cuda.empty_cache()
    return rec


def host_calls(dev):
    """Host µs of eager calls on 64 rows of 768: ``ew`` whole; Triton's
    launch as the tree makes it (``JITFunction.run``, or a compiled
    kernel's launcher called directly) and the wrapper's own share (the
    difference); the op set's multiply by a Python scalar; ``torch.add``
    and ``torch.mul``."""
    mod, ops = em(), cuda_ops()
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(64, 768, generator=g, device=dev)
    b = torch.randn(768, generator=g, device=dev)
    rec = {"shape": "64x768 + 768, f32"}
    rec["ew_us"] = host_us(lambda: mod.ew("f_add", x, b))
    with Launches() as cap:
        mod.ew("f_add", x, b)
    if cap.last is not None:
        fn, args, kwargs = cap.last
        rec["launch"] = "JITFunction.run"
        rec["launcher_us"] = host_us(lambda: cap.orig(fn, *args, **kwargs))
    elif cap.direct is not None:
        call, args = cap.direct
        rec["launch"] = "compiled kernel's launcher"
        rec["launcher_us"] = host_us(lambda: call(*args))
    if "launcher_us" in rec:
        rec["wrapper_us"] = rec["ew_us"] - rec["launcher_us"]
    rec["torch_add_us"] = host_us(lambda: torch.add(x, b))
    # the op set's multiply by a Python scalar: _scalar, then ew
    rec["scalar_mul_us"] = host_us(
        lambda: mod.ew("f_mul", x, ops._scalar(0.125, x)))
    rec["torch_mul_scalar_us"] = host_us(lambda: torch.mul(x, 0.125))
    log(rec)
    return rec


def kernels(dev, classes, repeat=1):
    out = [time_class(label, body, n_out, ops, dev, repeat)
           for label, body, n_out, ops in classes]
    for dt in ("bfloat16",):
        out.append(time_class(f"gate: f_gelu 1024x3072 {dt}", "f_gelu", 1,
                              [T((1024, 3072), dt)], dev, repeat))
    out.append(host_calls(dev))
    return out


# --- the tally ----------------------------------------------------------
def canonical(shapes):
    """The broadcast shape's dims merged where every operand has the same
    broadcast signature (the kernel's canonical shape), and each operand's
    signature over them ("f": full, "b": broadcast)."""
    rank = max([len(s) for s in shapes] + [1])
    aligned = [(1,) * (rank - len(s)) + tuple(s) for s in shapes]
    out = tuple(max(d) for d in zip(*aligned))
    keep = [d for d in range(rank) if out[d] != 1] or [rank - 1]
    sig = {d: tuple(a[d] != out[d] for a in aligned) for d in keep}
    groups = []
    for d in keep:
        if groups and sig[groups[-1][-1]] == sig[d]:
            groups[-1].append(d)
        else:
            groups.append([d])
    dims = tuple(prod(out[d] for d in g) for g in groups)
    sigs = ["".join("b" if sig[g[0]][i] else "f" for g in groups)
            for i in range(len(shapes))]
    return dims, sigs


def layout(x):
    if not isinstance(x, torch.Tensor):
        return "scalar"
    if x.dim() == 0:
        return "0-d"
    if x.is_contiguous():
        return "contiguous"
    if 0 in x.stride():
        return "expanded"
    if sorted(x.stride(), reverse=True) != list(x.stride()):
        return "permuted"
    return "strided"


class Tally:
    """Wraps ``ew`` (and the op set's ``_scalar``) wherever the package
    binds them: counts calls by class, in order."""

    def __init__(self):
        self.calls, self.recipes, self.seq = Counter(), {}, []
        self.copies, self.uploads = Counter(), Counter()
        self.scalars = {}           # id of a 0-d tensor _scalar made -> value
        self.syncs = Counter()
        mod, ops = em(), cuda_ops()
        self.orig_ew = mod.ew
        self.orig_scalar = getattr(ops, "_scalar", None)
        counted = "elementwise_copy" in getattr(
            __import__("lightgrad_tpu_torch.ops.runtime",
                       fromlist=["COPIES"]), "COPIES", ())
        from lightgrad_tpu_torch.ops.runtime import launch_counts
        me = self

        def ew(body, *xs, n_out=1):
            if not xs[0].is_cuda:
                return me.orig_ew(body, *xs, n_out=n_out)
            key, recipe = me.classify(body, xs, n_out)
            me.calls[key] += 1
            me.recipes.setdefault(key, recipe)
            before = launch_counts().get("elementwise_copy", 0)
            out = me.orig_ew(body, *xs, n_out=n_out)
            if counted:
                me.copies[key] += launch_counts().get(
                    "elementwise_copy", 0) - before
            else:           # the tree copies every non-contiguous operand
                me.copies[key] += sum(
                    isinstance(x, torch.Tensor) and not x.is_contiguous()
                    for x in xs)
            first = out[0] if n_out > 1 else out
            if first.numel():
                me.seq.append(key)
            return out

        def scalar(b, like):
            r = me.orig_scalar(b, like)
            if isinstance(r, torch.Tensor) and not isinstance(
                    b, torch.Tensor) and r.is_cuda:
                me.uploads[str(r.dtype)[6:]] += 1
                me.scalars[id(r)] = (b.item() if hasattr(b, "item") else b,
                                     r)
            return r

        wraps = {id(self.orig_ew): ew}
        if self.orig_scalar is not None:
            wraps[id(self.orig_scalar)] = scalar
        for m in list(sys.modules.values()):
            if not getattr(m, "__name__", "").startswith(
                    "lightgrad_tpu_torch"):
                continue
            for name, val in list(vars(m).items()):
                if id(val) in wraps:
                    setattr(m, name, wraps[id(val)])

    def classify(self, body, xs, n_out):
        shapes = [tuple(getattr(x, "shape", ())) for x in xs]
        dims, sigs = canonical(shapes)
        ops, parts = [], []
        for x, sig in zip(xs, sigs):
            lay = layout(x)
            if isinstance(x, torch.Tensor) and id(x) in self.scalars:
                lay = "scalar"
                ops.append(S(self.scalars[id(x)][0], str(x.dtype)[6:]))
            elif not isinstance(x, torch.Tensor):
                ops.append(S(x.value, str(x.dtype)[6:]))
            else:
                ops.append(T(x.shape, str(x.dtype)[6:],
                             None if x.is_contiguous() else x.stride(),
                             x.storage_offset() if not x.is_contiguous()
                             else 0))
            dt = str(x.dtype)[6:]
            parts.append(f"{dt}:{sig}:{lay}")
        key = (body, n_out, dims, tuple(parts))
        return key, (body, n_out, ops)

    def clear(self):
        self.calls.clear()
        self.seq.clear()
        self.copies.clear()
        self.uploads.clear()
        self.scalars.clear()
        self.syncs.clear()


def sync_hook(tally, tree):
    """A ``warnings.showwarning`` that files each warning by its message
    and the package's innermost three frames."""
    def hook(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(tree) and "scripts" not in
                  f.filename]
        where = tuple(f"{os.path.relpath(f.filename, tree)}:{f.lineno}"
                      for f in frames[-3:])
        tally.syncs[(str(message).splitlines()[0][:120], where)] += 1
    return hook


def profiled(step):
    """Run ``step`` under torch.profiler; the device events in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        step()
        torch.cuda.synchronize()
    evs = [e for e in trace.events() if e.device_type == DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    return evs


def tally_path(tally, name, step, tree):
    tally.clear()
    old_show = warnings.showwarning
    warnings.showwarning = sync_hook(tally, tree)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = sync_hook(tally, tree)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                evs = profiled(step)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        warnings.showwarning = old_show
    ew_evs = [e for e in evs if "ew_kernel" in e.name]
    us = defaultdict(float)
    matched = len(ew_evs) == len(tally.seq)
    if matched:
        for key, e in zip(tally.seq, ew_evs):
            us[key] += e.time_range.elapsed_us()
    else:           # the share by bytes moved, where the trace cannot say
        for key, n in tally.calls.items():
            body, n_out, ops = tally.recipes[key]
            us[key] = n * class_cost(body, ops, []) * (1 + n_out)
    total = sum(e.time_range.elapsed_us() for e in ew_evs)
    device = sum(e.time_range.elapsed_us() for e in evs)
    est = sum(us.values())
    rows = []
    for key, n in sorted(tally.calls.items(), key=lambda kv: -us[kv[0]]):
        rows.append({"body": key[0], "n_out": key[1], "dims": list(key[2]),
                     "operands": list(key[3]), "calls": n,
                     "copies": tally.copies[key],
                     "device_us": us[key] if matched else None,
                     "share": us[key] / (total if matched else est)
                     if (total if matched else est) else None,
                     "recipe": tally.recipes[key]})
    rec = {"path": name, "ew_calls": sum(tally.calls.values()),
           "classes": len(tally.calls), "ew_launches_traced": len(ew_evs),
           "matched": matched, "ew_device_us": total,
           "device_us": device, "copies": sum(tally.copies.values()),
           "scalar_uploads": dict(tally.uploads),
           "syncs": [{"message": m, "where": list(w), "count": c}
                     for (m, w), c in tally.syncs.most_common()],
           "rows": rows}
    log({k: v for k, v in rec.items() if k != "rows"})
    for r in rows[:40]:
        log({"path": name, **{k: v for k, v in r.items() if k != "recipe"}})
    return rec


def tally_paths(dev, tree, only):
    from lightgrad_tpu_torch import no_grad
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
    from lightgrad_tpu_torch.models.neox import NeoX, NeoXConfig

    tally = Tally()
    out = []

    def gen():
        from lightgrad_tpu_torch import random as lg_random
        lg_random.seed(0)
        model = NeoX(NeoXConfig(**PYTHIA_1B))
        prompt = [int(t) for t in np.random.default_rng(15).integers(
            0, PYTHIA_1B["vocab_size"], 64)]
        model.generate(prompt, max_new_tokens=1)       # warm
        return lambda: model.generate(prompt, max_new_tokens=2)

    paths = (
        ("ResNet-18", lambda: vision_step("resnet18", 32, 224, 3, 1000)),
        ("BERT-base", lambda: lm_step("BERT-base", lambda: BertForMaskedLM(
            BertConfig(**BERT_BASE)), BERT_BASE, 8, 128, False)),
        ("Pythia-1B", lambda: lm_step("Pythia-1B", lambda: NeoX(
            NeoXConfig(**PYTHIA_1B)), PYTHIA_1B, 2, 2048, True)),
        ("ResNet-20 digits", lambda: vision_step("resnet20", 128, 28, 1,
                                                 10)),
        ("Mistral-7B 2 layers", lambda: lm_step("Mistral-7B", lambda: Llama(
            LlamaConfig(**MISTRAL_7B)), MISTRAL_7B, 1, 8192, False)),
        ("Gemma-2B 2 layers", lambda: lm_step("Gemma-2B", lambda: Llama(
            LlamaConfig(**GEMMA_2B)), GEMMA_2B, 2, 1024, False)),
        ("Pythia-1B generate", gen))
    for name, make in paths:
        if only and name not in only:
            continue
        step, cleanup = make(), None
        if isinstance(step, tuple):
            step, cleanup = step
        step()                          # compiles; not tallied
        if name == "Pythia-1B generate":
            with no_grad():
                out.append(tally_path(tally, name, step, tree))
        else:
            out.append(tally_path(tally, name, step, tree))
        del step, cleanup
        torch.cuda.empty_cache()
    return out


def tallied_classes(paths, share=0.01):
    """The distinct classes with at least ``share`` of some path's
    elementwise device time, largest first."""
    seen, out = set(), []
    rows = sorted(((r["share"] or 0.0, p["path"], r) for p in paths
                   for r in p["rows"]), key=lambda t: -t[0])
    for s, path, r in rows:
        if s < share:
            break
        key = (r["body"], json.dumps(r["recipe"][2]))
        if key in seen:
            continue
        seen.add(key)
        out.append((f"{path}: {r['body']} {r['operands']} ({s:.1%})",
                    r["body"], r["n_out"], r["recipe"][2]))
    return out


# --- steps ------------------------------------------------------------------
def breakdown(step, step_ms):
    evs = profiled(step)
    fams, launches = Counter(), Counter()
    for e in evs:
        fam = next((f for k, f in FAMILIES if k in e.name), "plain torch")
        fams[fam] += e.time_range.elapsed_us() / 1e3
        launches[fam] += 1
    busy = sum(fams.values())
    return {"device_ms": dict(fams), "device_launches": dict(launches),
            "busy_ms": busy, "idle": 1 - busy / step_ms}


def run_steps(step, n, per_step, unit):
    times, host = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = float(np.median(times[1:] or times)) * 1e3
    rec = {unit: per_step * 1e3 / step_ms,
           "step_s": [round(t, 4) for t in times],
           "host_ms": float(np.median(host[1:] or host)) * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    rec.update(breakdown(step, step_ms))
    return rec


def lm_step(name, make, cfg, B, S, fused):
    """One AdamW training step of a tape language model, as a callable
    (with the flash switch set around it)."""
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor

    lg_random.seed(0)
    model = make()
    V = cfg["vocab_size"]
    ids = np.random.default_rng(12).integers(0, V, (B, S + 1)) \
        .astype(np.int32)
    x = Tensor.from_numpy(ids[:, :-1], requires_grad=False)
    y = Tensor.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False)
    kw = {}
    if name == "BERT-base":
        lengths = np.random.default_rng(0).integers(64, 129, size=B)
        mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
        kw["attention_mask"] = Tensor.from_numpy(mask, requires_grad=False)
    opt = optim.AdamW(list(model.parameters()), lr=1e-4)

    def step():
        prev = None
        if fused:
            from lightgrad_tpu_torch.ops.attention import set_flash_fused
            prev = set_flash_fused(True)
        try:
            logits = model(x, **kw)
            loss = lg_loss.cross_entropy(logits.reshape(B * S, V), y,
                                         ignore_index=-100)
            opt.zero_grad()
            loss.backward()
            opt.step()
        finally:
            if fused:
                set_flash_fused(prev)
    return step


def vision_step(kind, B, hw, cin, classes):
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch import models

    lg_random.seed(0)
    model = getattr(models, kind)(num_classes=classes, in_channels=cin)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    x = Tensor(torch.randn(B, cin, hw, hw, generator=gen, device=dev),
               requires_grad=False)
    y = Tensor(torch.randint(0, classes, (B,), generator=gen,
                             device=dev).to(torch.int32), requires_grad=False)
    if kind == "resnet20":
        opt = optim.AdamW(list(model.parameters()), lr=3e-3,
                          weight_decay=0.01)
    else:
        opt = optim.AdamW(list(model.parameters()), lr=1e-3)

    def step():
        loss = lg_loss.cross_entropy(model(x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
    return step


def steps(n):
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from lightgrad_tpu_torch.models.neox import NeoX, NeoXConfig

    out = []
    for name, make, per, unit in (
            ("ResNet-18", lambda: vision_step("resnet18", 32, 224, 3, 1000),
             32, "images_s"),
            ("BERT-base", lambda: lm_step(
                "BERT-base", lambda: BertForMaskedLM(BertConfig(**BERT_BASE)),
                BERT_BASE, 8, 128, False), 8 * 128, "tok_s"),
            ("Pythia-1B", lambda: lm_step(
                "Pythia-1B", lambda: NeoX(NeoXConfig(**PYTHIA_1B)),
                PYTHIA_1B, 2, 2048, True), 2 * 2048, "tok_s")):
        step = make()
        rec = {"model": name, **run_steps(step, n, per, unit)}
        log(rec)
        out.append(rec)
        del step
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--no-steps", action="store_true")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--tally", action="store_true")
    ap.add_argument("--paths", default="",
                    help="comma-separated names of PATHS to tally")
    ap.add_argument("--tally-out", default="",
                    help="write the whole tally (every class of every path, "
                         "with its recipe) to this JSON file")
    ap.add_argument("--classes", default="",
                    help="time only the CLASSES whose label matches this "
                         "regular expression")
    ap.add_argument("--repeat", type=int, default=1,
                    help="graph timings of each class (its ms: the median)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_elementwise: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.environ.setdefault("LIGHTGRAD_FAKE_DATA", "1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import triton

    import lightgrad_tpu_torch
    from lightgrad_tpu_torch.ops import _build

    if os.path.dirname(os.path.dirname(os.path.abspath(
            lightgrad_tpu_torch.__file__))) != tree:
        print(f"ab_elementwise: imported {lightgrad_tpu_torch.__file__}, not "
              f"from {tree}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
    dev = torch.device("cuda")
    rec = {"tree": args.tree, "card": smi, "triton": triton.__version__,
           "torch": torch.__version__, "build_s": time.perf_counter() - t0}
    log({k: rec[k] for k in ("card", "triton", "torch")})
    if not args.no_kernels:
        rec["kernels"] = kernels(dev, [c for c in CLASSES
                                       if re.search(args.classes, c[0])],
                                 args.repeat)
    if args.tally:
        only = set(filter(None, args.paths.split(",")))
        rec["tally"] = tally_paths(dev, tree, only)
        classes = tallied_classes(rec["tally"])
        rec["tally_classes"] = [time_class(label, body, n_out, ops, dev)
                                for label, body, n_out, ops in classes]
        if args.tally_out:
            with open(args.tally_out, "w") as f:
                json.dump({"card": smi, "tally": rec["tally"],
                           "classes": rec["tally_classes"]}, f)
    if not args.no_steps:
        rec["steps"] = steps(args.steps)
    print(json.dumps({k: v for k, v in rec.items() if k != "tally"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
