"""Device facts for the port's kernels.

The port has no kernel-mode switch: a wrapper given CUDA tensors launches its
hand-written kernel (or raises), and a wrapper given CPU tensors runs the
kernel's plain PyTorch version.  The device of the tensors is the only
dispatch rule, so this module only reports what that rule will do.

Above that dispatch sits the one rule for sharded operands
(:func:`sharded`): a wrapper given a ``DTensor`` (the parallel layer's
sharded arrays, ``lightgrad_tpu_torch/parallel``) picks one of the
placement strategies it declares, redistributes its operands to it, runs
itself on the local shards -- the kernel on the card, the plain version on
the CPU -- and wraps the results as ``DTensor``s again.  This stands where
GSPMD partitions a Pallas call in the JAX package.
"""

import torch

try:
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
except ImportError:         # a torch built without torch.distributed
    DTensor = Partial = Replicate = Shard = None

__all__ = ["device_kind", "device_name", "kernels_in_use", "KERNELS",
           "COPIES", "launch_counts", "reset_launch_counts", "is_sharded",
           "sharded", "redistribution_counts", "redistributions",
           "assert_local"]

# Every hand-written kernel of the port, by wrapper name.  A wrapper adds one
# to its count where it launches its kernel, and nowhere else.  The stack
# kernel's int8 instantiations count under their own names, as the JAX
# package has a Pallas variant for each.  ``flash_block`` counts one in each
# direction, beside the flash kernels it launches.  Decode attention counts
# its split kernel once a call (``decode_attention_batch``: once for all
# slots) and, where it splits a head's keys, the merge of the splits under
# its own name.  Convolution counts each route under its own names (the
# tensor-core kernels as ``conv_*``, the CUDA-core ones as ``conv_*_simt``),
# and the tensor-core route's channels-last staging as ``conv_layout``, one
# a staged tensor.
KERNELS = ("attention_fwd", "decode_attention", "decode_attention_batch",
           "decode_attention_merge",
           "decode_stack", "decode_stack_batch", "decode_stack_int8",
           "decode_stack_kvq",
           "decode_stack_int8_kvq", "decode_stack_batch_int8",
           "decode_stack_batch_kvq", "decode_stack_batch_int8_kvq",
           "attention_bwd_dq", "attention_bwd_dkv", "attention_bwd_fused",
           "flash_block", "layernorm_fwd", "layernorm_bwd", "elementwise",
           "reduce", "matmul", "softmax_fwd", "softmax_bwd", "conv_fwd",
           "conv_bwd_dx", "conv_bwd_dw", "conv_layout", "conv_fwd_simt",
           "conv_bwd_dx_simt", "conv_bwd_dw_simt")
# Copies a wrapper makes before a launch, counted beside the kernels: the
# matmul wrapper's packing of an operand whose batch strides the kernel
# cannot walk; the elementwise wrapper's copy of a view whose strides do not
# merge into the kernel's 4 dims.
COPIES = ("matmul_pack", "elementwise_copy")
_launches = dict.fromkeys(KERNELS + COPIES, 0)


def count_launch(name: str):
    _launches[name] += 1


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return dict(_launches)


def reset_launch_counts():
    """Zero the launch counts and the record of redistributions."""
    for name in _launches:
        _launches[name] = 0
    _redistributions.clear()


def device_kind(t: torch.Tensor = None) -> str:
    """'cuda' or 'cpu': of ``t`` when given, else of the default card."""
    if t is not None:
        return t.device.type
    return "cuda" if torch.cuda.is_available() else "cpu"


def device_name() -> str:
    """The card's name (``torch.cuda.get_device_name(0)``), or 'cpu'."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def kernels_in_use(t: torch.Tensor) -> bool:
    """True exactly when a wrapper given ``t`` launches its CUDA kernel."""
    return t.is_cuda


# ---------------------------------------------------------------------------
# kernels under DTensor
# ---------------------------------------------------------------------------
# (wrapper, global shape, placements before, placements after) of every
# operand :func:`sharded` redistributed since the last reset
_redistributions = []


def redistributions() -> list:
    """Every redistribution :func:`sharded` made since the last reset, as
    ``(wrapper, global shape, placements before, placements after)``."""
    return list(_redistributions)


def redistribution_counts() -> dict:
    """Redistributions per wrapper since the last reset."""
    out = {}
    for name, *_ in _redistributions:
        out[name] = out.get(name, 0) + 1
    return out


def is_sharded(*xs) -> bool:
    """True when any of ``xs`` is a ``DTensor``."""
    return DTensor is not None and any(isinstance(x, DTensor) for x in xs)


def assert_local(*ts):
    """Kernels bound with ctypes take raw pointers: a ``DTensor`` must
    never reach them (:func:`sharded` hands them local shards)."""
    assert not is_sharded(*ts), "a kernel launch was given a DTensor"


def _cost(have, want) -> float:
    """Relative price of one operand's move on one mesh dim: nothing when
    it stays, a collective (2) when it must travel, and a half more for
    splitting work that was whole (a move to Shard).  So a partial sum
    meets a replicated operand as an all-reduce, not a reduce-scatter --
    Megatron's one all-reduce per matmul pair, as GSPMD places it from the
    same annotations."""
    if have == want:
        return 0.0
    if want.is_partial():       # nothing becomes a partial sum by moving
        return float("inf")
    split = 0.5 if want.is_shard() else 0.0
    return split if have.is_replicate() else 2.0 + split


def sharded(name: str, strategies, fn, *args, **kwargs):
    """Run wrapper ``fn`` on ``args`` some of which are DTensors.

    ``strategies(shapes, *args, **kwargs)`` lists, for one mesh dim, the
    ``(input placements, output placements)`` under which ``fn`` is exact
    on local shards: one placement per tensor argument (in order) and one
    per output.  Each mesh dim takes the cheapest strategy its operands
    reach (the first among equals; every list ends in all-Replicate, which
    each reaches), the operands are redistributed to it (each move
    recorded), ``fn`` runs on the local shards (its kernel on CUDA, its
    plain version on the CPU) and its outputs come back as DTensors.
    Plain tensors among the arguments count as replicated.  Shards must
    be even (every dim a sharding splits is divisible by its mesh size)."""
    pos = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    mesh = next(args[i].device_mesh for i in pos
                if isinstance(args[i], DTensor))
    ts = [args[i] if isinstance(args[i], DTensor) else DTensor.from_local(
        args[i], mesh, [Replicate()] * mesh.ndim, run_check=False)
        for i in pos]
    shapes = [tuple(t.shape) for t in ts]
    cands = strategies(shapes, *args, **kwargs)
    want_in = [[None] * mesh.ndim for _ in ts]
    want_out = None
    for m in range(mesh.ndim):
        have = [t.placements[m] for t in ts]
        s_in, s_out = cands[min(range(len(cands)), key=lambda k: (
            sum(_cost(h, w) for h, w in zip(have, cands[k][0])), k))]
        if want_out is None:
            want_out = [[None] * mesh.ndim for _ in s_out]
        for j, p in enumerate(s_in):
            want_in[j][m] = p
        for j, p in enumerate(s_out):
            want_out[j][m] = p
    local = list(args)
    for i, t, want in zip(pos, ts, want_in):
        if tuple(t.placements) != tuple(want):
            _redistributions.append((name, tuple(t.shape),
                                     tuple(t.placements), tuple(want)))
            t = t.redistribute(mesh, want)
        local[i] = t.to_local()
    out = fn(*local, **kwargs)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(
        o if o is None else DTensor.from_local(o, mesh, pl, run_check=False)
        for o, pl in zip(outs, want_out))
    return wrapped[0] if single else wrapped


def replicated(shapes, *args, n_out: int = 1, **kwargs):
    """The one strategy of a kernel GSPMD could not partition in the JAX
    package (the decode kernels): every operand and output replicated."""
    return [((Replicate(),) * len(shapes), (Replicate(),) * n_out)]


def pointwise(shapes, n_out: int = 1, whole: int = 0):
    """Strategies of a kernel that maps broadcastable operands row by row:
    shard any dim of the broadcast output but its trailing ``whole`` dims,
    each operand on its own matching dim (replicated where it broadcasts);
    ``n_out`` outputs of the broadcast shape."""
    out = torch.broadcast_shapes(*shapes)
    nd = len(out)
    cands = []
    for d in range(nd - whole):
        if out[d] == 1:
            continue
        pl = tuple(Shard(d - nd + len(s)) if d - nd + len(s) >= 0
                   and s[d - nd + len(s)] == out[d] else Replicate()
                   for s in shapes)
        cands.append((pl, (Shard(d),) * n_out))
    cands.append(((Replicate(),) * len(shapes), (Replicate(),) * n_out))
    return cands
