"""Parameter / batch sharding over a device mesh.

Counterpart of ``lightgrad_tpu/parallel/shard.py``, with its rule tables
entry for entry.  Tensor-parallel layouts follow the Megatron split:
attention q/k/v and the MLP up-projection shard their *output* features
(row-parallel weights), the attention output projection and the MLP
down-projection shard their *input* features (column-parallel), so each
transformer block needs one all-reduce per matmul pair.  Embedding /
decoder tables shard over the vocabulary.

A spec is the JAX package's ``PartitionSpec`` kept as data (``P``, tuples
of mesh axis names or None); :func:`~.distributed.placements` turns it into
``DTensor`` placements.  :func:`shard_tensor` rebinds a tape tensor's
buffer, or a ``torch.nn`` parameter, to a ``DTensor`` on the mesh; the
kernels then run on its local shards by the placement strategies they
declare (``ops/runtime.py``), and DTensor's own rules carry the rest
(reshapes, gathers, plain products), inserting the collectives GSPMD
inserts in the JAX package.  The optimizers make their state
``zeros_like`` the parameters, so it takes the same placement.
"""

import math
import re

import torch

from .distributed import P, placements
from .mesh import axis_size

__all__ = ["shard_tensor", "shard_module", "partition_rules", "BERT_TP_RULES",
           "GPT_TP_RULES", "LLAMA_TP_RULES", "T5_TP_RULES", "MOE_EP_RULES",
           "GPT_MOE_RULES", "LLAMA_MOE_RULES", "NEOX_TP_RULES",
           "enable_sequence_parallel", "fsdp_spec", "fsdp_module", "P"]

_ATTENTION = ("BertSelfAttention", "CausalSelfAttention", "LlamaAttention")


def _children(m):
    kids = m._modules.values()
    return [k for k in kids if k is not None]


def enable_sequence_parallel(module, mesh, axis: str = "sp",
                             batch_axis: str = None):
    """Switch every self-attention submodule to ring attention over
    ``mesh[axis]`` (parallel/ring_attention.py).  Modules opt in by reading
    their ``_sequence_parallel`` attribute (models/bert.py, llama.py,
    gpt.py).  Returns the number of modules switched."""
    count = 0
    stack = [module]
    while stack:
        m = stack.pop()
        if type(m).__name__ in _ATTENTION:
            object.__setattr__(m, "_sequence_parallel", (mesh, axis, batch_axis))
            count += 1
        stack.extend(_children(m))
    return count


# (name regex, P) -- first match wins; unmatched -> replicated
BERT_TP_RULES = [
    (r"(query|key|value)\.weight$", P("tp", None)),
    (r"(query|key|value)\.bias$", P("tp")),
    (r"attention\.dense\.weight$", P(None, "tp")),
    (r"intermediate\.weight$", P("tp", None)),
    (r"intermediate\.bias$", P("tp")),
    (r"\.output\.weight$", P(None, "tp")),
    (r"(word_embeddings|decoder)\.weight$", P("tp", None)),
    (r"decoder\.bias$", P("tp")),
]

# GPT-2 (models/gpt.py): Linear weights are (out, in).  Both c_proj
# projections (attention output and MLP down) are column-parallel; c_attn /
# c_fc are row-parallel; the tied wte table shards over the vocabulary.
GPT_TP_RULES = [
    (r"attn\.c_attn\.weight$", P("tp", None)),
    (r"attn\.c_attn\.bias$", P("tp")),
    (r"c_fc\.weight$", P("tp", None)),
    (r"c_fc\.bias$", P("tp")),
    (r"c_proj\.weight$", P(None, "tp")),
    (r"wte\.weight$", P("tp", None)),
]

# LLaMA (models/llama.py): all Linears bias-free; gate/up row-parallel,
# down and attention output column-parallel; GQA k/v shard like q.
LLAMA_TP_RULES = [
    (r"(q_proj|k_proj|v_proj)\.weight$", P("tp", None)),
    (r"(q_proj|k_proj|v_proj)\.bias$", P("tp")),  # Qwen2 attention biases
    (r"(gate_proj|up_proj)\.weight$", P("tp", None)),
    (r"(o_proj|down_proj)\.weight$", P(None, "tp")),
    (r"(embed_tokens|lm_head)\.weight$", P("tp", None)),
]


def partition_rules(rules, name: str, stacked: bool = None) -> P:
    """Resolve a partition spec by name.  A scanned stack (scan.py,
    models/gpt.py ``ScannedBlocks``) registers each per-layer parameter
    family as ONE stacked ``(L, ...)`` tensor under the ``__``-mangled
    name -- those match the same rules after de-mangling, with a leading
    replicated layer axis prepended to the spec.  ``stacked=None`` infers
    stacking from the mangling convention."""
    if stacked is None:
        stacked = "__" in name
    if stacked:
        name = name.replace("__", ".")
    for pattern, spec in rules:
        if re.search(pattern, name):
            return P(None, *spec) if stacked else spec
    return P()


def _distribute(t, mesh, spec):
    from torch.distributed.tensor import distribute_tensor

    if hasattr(t, "placements"):        # already sharded: gather first
        t = t.full_tensor()
    # every rank holds the same values: each keeps its own slice, no scatter
    return distribute_tensor(t.detach(), mesh, placements(mesh, spec),
                             src_data_rank=None)


def shard_tensor(t, mesh, spec):
    """Re-place a tape tensor's buffer as a ``DTensor`` sharded by ``spec``
    (in place; returns ``t``).  A ``torch.Tensor`` cannot take a DTensor
    as its data: for one (a ``torch.nn.Parameter``), the sharded tensor is
    returned, a ``Parameter`` where ``t`` was one, and the caller puts it
    in ``t``'s place (:func:`shard_module` does so)."""
    if isinstance(t, torch.Tensor):
        new = _distribute(t.data, mesh, spec)
        return torch.nn.Parameter(new, requires_grad=t.requires_grad) \
            if isinstance(t, torch.nn.Parameter) else new
    t._set_data(_distribute(t.data, mesh, spec))
    return t


def _place(module, name, p, mesh, spec):
    if isinstance(module, torch.nn.Module):
        # a Parameter cannot take a DTensor as .data: a new Parameter in
        # the owning module's slot
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        sub.register_parameter(leaf, shard_tensor(p, mesh, spec))
        sub.__dict__.pop("_kv_fns", None)
    else:
        shard_tensor(p, mesh, spec)


def shard_module(module, mesh, rules=BERT_TP_RULES, verbose: bool = False):
    """Apply name-matched partition specs to every parameter of a tape
    ``nn.Module`` or a ``torch.nn.Module``."""
    for name, p in list(module.named_parameters()):
        spec = partition_rules(rules, name)
        if verbose:
            print(f"  {name}: {spec}")
        _place(module, name, p, mesh, spec)
    module.__dict__.pop("_kv_fns", None)
    return module


def fsdp_spec(shape, base: P, n_shard: int, axis: str = "fsdp",
              min_size: int = 2 ** 14, skip_leading: bool = False) -> P:
    """Extend ``base`` with a fully-sharded-data-parallel axis.

    Picks the LARGEST still-unsharded dimension divisible by ``n_shard`` and
    assigns it to ``axis``; tensors smaller than ``min_size`` elements keep
    ``base`` (the all-gather latency of a tiny bias outweighs its memory).
    ``skip_leading`` protects the layer axis of scan-stacked parameters."""
    dims = list(base) + [None] * (len(shape) - len(base))
    if math.prod(shape) >= min_size:
        lo = 1 if (skip_leading and len(shape) > 1) else 0
        cands = [i for i in range(lo, len(shape))
                 if dims[i] is None and shape[i] % n_shard == 0]
        if cands:
            dims[max(cands, key=lambda i: shape[i])] = axis
    while dims and dims[-1] is None:  # canonical form: P() == replicated
        dims.pop()
    return P(*dims)


def fsdp_module(module, mesh, axis: str = "fsdp", rules=None,
                min_size: int = 2 ** 14, verbose: bool = False):
    """ZeRO-3-style fully-sharded data parallelism by placement.

    Every parameter (and, through the optimizers' ``zeros_like`` state,
    every optimizer-state tensor) is stored sharded over ``mesh[axis]``.
    A kernel whose strategy needs a parameter whole gathers it before the
    use, and the gradient's partial sums reach the sharded parameter as a
    reduce-scatter in the update.  Pass the family's TP ``rules`` and the
    fsdp axis is laid on the largest dimension the TP split left
    unsharded.  Shard the BATCH over the same axis in the train step."""
    n = axis_size(mesh, axis)
    for name, p in list(module.named_parameters()):
        base = partition_rules(rules, name) if rules else P()
        spec = fsdp_spec(tuple(p.shape), base, n, axis=axis,
                         min_size=min_size, skip_leading="__" in name)
        if verbose:
            print(f"  {name}: {spec}")
        _place(module, name, p, mesh, spec)
    module.__dict__.pop("_kv_fns", None)
    return module


# expert-parallel rules for nn.MoE: stacked expert weights shard over 'ep'
MOE_EP_RULES = [
    (r"(^|\.)w1$", P("ep", None, None)),
    (r"(^|\.)w2$", P("ep", None, None)),
]

# GPT-NeoX / Pythia (models/neox.py): the fused QKV is per-HEAD packed, so
# row-sharding it over tp splits whole heads (heads % tp == 0 required);
# attention.dense and the MLP down-projection are column-parallel.
NEOX_TP_RULES = [
    (r"query_key_value\.weight$", P("tp", None)),
    (r"query_key_value\.bias$", P("tp")),
    (r"attention\.dense\.weight$", P(None, "tp")),
    (r"dense_h_to_4h\.weight$", P("tp", None)),
    (r"dense_h_to_4h\.bias$", P("tp")),
    (r"dense_4h_to_h\.weight$", P(None, "tp")),
    (r"(embed_in\.weight|embed_out\.weight)$", P("tp", None)),
]

# T5 (models/t5.py): q/k/v and the FFN up-projections (wi / gated wi_0+wi_1)
# row-parallel, attention output and FFN down column-parallel; the shared
# embedding shards over the vocabulary; the relative-position bias table
# shards its per-head axis with the heads.
T5_TP_RULES = [
    (r"\.(q|k|v)\.weight$", P("tp", None)),
    (r"\.(wi|wi_0|wi_1)\.weight$", P("tp", None)),
    (r"\.(o|wo)\.weight$", P(None, "tp")),
    (r"relative_attention_bias\.weight$", P(None, "tp")),
    (r"^shared\.weight$", P("tp", None)),
]

# GPT-MoE (models/gpt.py, GPTConfig(n_experts>0)): expert stacks over 'ep',
# router replicated (it is tiny and every token needs it), dense-block and
# attention projections per the usual Megatron TP split.  ep and tp can be
# the same mesh axis (pure EP: tp=1) or orthogonal axes.
GPT_MOE_RULES = [
    (r"moe\.(w1|w2|w3)$", P("ep", None, None)),  # shared ws1/ws2 replicate
    (r"moe\.router\.weight$", P()),
] + GPT_TP_RULES

# LLaMA-MoE / Mixtral (models/llama.py, LlamaConfig(num_local_experts>0)):
# routed SwiGLU expert stacks over 'ep', router replicated, the rest per
# the LLaMA Megatron split.
LLAMA_MOE_RULES = [
    (r"block_sparse_moe\.(w1|w2|w3)$", P("ep", None, None)),
    (r"block_sparse_moe\.router\.weight$", P()),
] + LLAMA_TP_RULES
