"""GPT-2 in PyTorch: the model, its training forward, KV-cache decoding and
generation.

Counterpart of ``lightgrad_tpu/models/gpt.py``: pre-LN GPT-2 (token +
position embeddings, causal self-attention, tanh-GELU MLP, weight-tied LM
head) as ``torch.nn.Module``s whose parameter names equal the JAX model's,
and the ``_kv_functions`` contract the serving engine drives.

The hand-written kernels on the training path (``GPT.forward`` under
``torch.autograd``): the fused LayerNorm forward and backward (ops/
layernorm.py, through models/_torch_layers.py) and the flash-attention
forward and backward (ops/attention.py, through autograd/ops.py), and, in
the mixture-of-experts blocks (``GPTConfig(n_experts=...)``), the experts'
batched products through the matmul kernel (ops/matmul.py; dispatch and
combine by index, models/_torch_layers.py).  On the serving path:
prefill's causal attention, the whole-stack decode kernel for ``step``,
``extend`` and ``step_batch`` (ops/decode_stack.py; its int8
instantiations under ``quantize_serving`` / ``quantize_kv``), and, when the
stack is not packed, the per-layer decode attention
(ops/decode_attention.py, float cache).  The serving path's LayerNorm,
GELU, the products outside the kernels (int8 ones included), the int8
cache's attention on the unrolled branch, the embedding gathers, the cache
scatters and sampling are plain PyTorch, as they were plain XLA in the JAX
package.
"""

import functools
import io
import json
import os
import re

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..autograd.ops import attention, matmul
from ._torch_layers import LayerNorm, MoE
from ..ops.attention import attention_fwd
from ..ops.decode_attention import decode_attention
from ..ops.decode_stack import (decode_stack, decode_stack_batch,
                                pack_gpt_stack, stack_supported)
from ..ops.runtime import is_sharded
from ..parallel.ring_attention import ring_attention_sharded
from ..scan import remat_mode
from .decoding import KVFns, ParamFn, _kv, _stack, cache_slot, last_row

__all__ = ["GPTConfig", "GPT", "ScannedBlocks", "ByteTokenizer",
           "GPT2Tokenizer", "quantize_rows"]


def quantize_rows(w):
    """Symmetric per-row int8 of ``w (..., k)``: ``(int8 rows, f32 scales
    (..., 1))``, scale ``max(absmax, 1e-8) / 127`` -- ``quantize_kv``'s
    cache rows (the JAX package's ``_q_rows``) and ``quantize_serving``'s
    weights, one scale per output channel.  ``torch.round`` rounds half to
    even, as ``jnp.round`` and ``np.round`` do."""
    w = w.float()
    s = w.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), s


def _sample(logits: np.ndarray, temperature: float, rng,
            top_k: int = 0, top_p: float = 0.0,
            repetition_penalty: float = 1.0, prev_ids=None) -> int:
    """Greedy (temperature<=0) or temperature sampling, optionally truncated
    to the top-k logits and/or the top-p (nucleus) probability mass.
    ``repetition_penalty`` > 1 damps logits of already-emitted ids (CTRL,
    Keskar et al.): positive logits divided by the penalty, negative ones
    multiplied."""
    logits = np.array(logits, np.float32)  # owned copy: the penalty writes
    if repetition_penalty != 1.0 and prev_ids:
        seen = np.asarray(sorted(set(int(i) for i in prev_ids)))
        seen = seen[seen < len(logits)]
        vals = logits[seen]
        logits[seen] = np.where(vals > 0, vals / repetition_penalty,
                                vals * repetition_penalty)
    if temperature <= 0:
        return int(np.argmax(logits))
    if top_k and top_k < len(logits):
        kth = np.partition(logits, -top_k)[-top_k]
        logits = np.where(logits < kth, -np.inf, logits)
    z = (logits - logits.max()) / temperature
    prob = np.exp(z)
    prob /= prob.sum()
    if 0.0 < top_p < 1.0:
        order = np.argsort(-prob)
        keep_sorted = np.cumsum(prob[order]) - prob[order] < top_p  # always >=1
        keep = np.zeros_like(prob, dtype=bool)
        keep[order[keep_sorted]] = True
        prob = np.where(keep, prob, 0.0)
        prob /= prob.sum()
    return int(rng.choice(len(prob), p=prob))


class GPTConfig:
    """The JAX package's config.  ``n_experts > 0`` makes every
    ``moe_every``-th block's FFN a mixture of experts (``MoE`` of
    models/_torch_layers.py): Mixtral-style top-k every block, Switch-style
    ``moe_dispatch="top1"`` every other block with ``moe_every=2``."""

    def __init__(self, vocab_size=50257, n_positions=1024, n_embd=768,
                 n_layer=12, n_head=12, layer_norm_epsilon=1e-5,
                 scan_layers=False, remat=False, n_experts=0, moe_every=1,
                 moe_k=2, moe_dispatch="topk", moe_hidden=None,
                 moe_capacity_factor=1.25, moe_shared=0, **unused):
        self.vocab_size = vocab_size
        self.n_positions = n_positions
        self.n_embd = n_embd
        self.n_layer = n_layer
        self.n_head = n_head
        self.layer_norm_epsilon = layer_norm_epsilon
        # scan_layers: the L blocks as stacked (L, ...) parameters applied
        # in one loop (ScannedBlocks); remat rematerialises block
        # activations in the backward: True / "full" recomputes the block,
        # "dots" keeps the Linears' products and recomputes the rest
        self.scan_layers = scan_layers
        self.remat = remat
        # the mixture-of-experts blocks: n_experts experts of width
        # moe_hidden, moe_k choices a token (moe_dispatch "topk" / "top1" /
        # "dense"), capacity factor, moe_shared always-on experts
        self.n_experts = n_experts
        self.moe_every = moe_every
        self.moe_k = moe_k
        self.moe_dispatch = moe_dispatch
        self.moe_hidden = moe_hidden if moe_hidden is not None else 4 * n_embd
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_shared = moe_shared
        if n_experts and scan_layers:
            raise ValueError(
                "scan_layers requires a homogeneous block stack; MoE blocks "
                "carry per-forward aux_loss state the scan cannot thread -- "
                "use scan_layers=False with n_experts")


class Linear(nn.Linear):
    """``torch.nn.Linear``, whose product on sharded operands (the parallel
    layer's ``DTensor``s) goes through the matmul kernel and its placement
    strategies (ops/runtime.py): DTensor's own rule for ``F.linear`` prices
    every placement of every mesh dim against every other, which on a
    three-axis mesh costs seconds a call on the host."""

    def forward(self, x):
        if not is_sharded(x, self.weight):
            return F.linear(x, self.weight, self.bias)
        y = matmul(x, self.weight.T)
        return y if self.bias is None else y + self.bias


def _split_heads(y, n, heads, hd):
    """``y (b, s, n * heads * hd)`` as ``(b, s, n, heads, hd)``.  A
    row-parallel product's output (``DTensor`` sharded over its features:
    GPT_TP_RULES splits the packed q|k|v rows in contiguous blocks, which
    cut across the q / k / v boundary) is made whole over its features and
    split again over the heads, the reshuffle GSPMD makes of the same
    annotation; a batch or sequence sharding stays."""
    b, s = y.shape[:2]
    if not is_sharded(y):
        return y.reshape(b, s, n, heads, hd)
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = y.device_mesh, y.placements
    keep = [p.is_shard() and p.dim < 2 for p in pl]     # batch / sequence
    y = y.redistribute(mesh, [p if k else Replicate()
                              for k, p in zip(keep, pl)])
    y = y.reshape(b, s, n, heads, hd)
    # the heads over the first mesh dim that divides them and splits
    # nothing else (tp's): a local slice, no traffic
    free = [m for m, k in enumerate(keep) if not k and mesh.size(m) > 1
            and heads % mesh.size(m) == 0]
    if not free:
        return y
    return y.redistribute(mesh, [Shard(3) if m == free[0] else p
                                 for m, p in enumerate(y.placements)])


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.n_head = cfg.n_head
        self.head_dim = cfg.n_embd // cfg.n_head
        kw = {"device": device, "dtype": dtype}
        self.c_attn = Linear(cfg.n_embd, 3 * cfg.n_embd, **kw)
        self.c_proj = Linear(cfg.n_embd, cfg.n_embd, **kw)

    def forward(self, x):
        b, s, h = x.shape
        qkv = _split_heads(self.c_attn(x), 3, self.n_head, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous()  # (b, heads, s, hd)
        scale = 1.0 / float(np.sqrt(self.head_dim))
        sp = getattr(self, "_sequence_parallel", None)
        if sp is not None:
            # sequence-parallel ring attention (parallel/ring_attention.py):
            # K/V shards rotate around the ring, causal rounds of strictly
            # later chunks are skipped.  Positions were added on the global
            # sequence upstream, so the shards carry their true offsets.
            mesh, axis, batch_axis = sp
            y = ring_attention_sharded(q, k, v, scale, mesh, axis=axis,
                                       causal=True, batch_axis=batch_axis)
            if not is_sharded(x):           # a model of whole tensors
                y = y.full_tensor()
        else:
            y = attention(q, k, v, scale, causal=True)
        return self.c_proj(y.transpose(1, 2).reshape(b, s, h))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, use_moe: bool = False, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln_1 = LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, **kw)
        self.attn = CausalSelfAttention(cfg, **kw)
        self.ln_2 = LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, **kw)
        if use_moe:
            # the sparse FFN; the residual carries capacity-dropped tokens
            self.moe = MoE(cfg.n_embd, cfg.moe_hidden, cfg.n_experts,
                           dispatch=cfg.moe_dispatch, k=cfg.moe_k,
                           capacity_factor=cfg.moe_capacity_factor,
                           n_shared=cfg.moe_shared, **kw)
        else:
            self.c_fc = Linear(cfg.n_embd, 4 * cfg.n_embd, **kw)
            self.c_proj = Linear(4 * cfg.n_embd, cfg.n_embd, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        if hasattr(self, "moe"):
            return x + self.moe(self.ln_2(x))
        return x + self.c_proj(_gelu(self.c_fc(self.ln_2(x))))


# remat="dots": the Linears' products, kept from the first pass;
# "dots_all" keeps the batched products too
_SAVED_PRODUCTS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
    "dots_all": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                 torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)}


def _dots_context(mode):
    saved = _SAVED_PRODUCTS[mode]

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


class ScannedBlocks(nn.Module):
    """GPT's L blocks as one module of stacked ``(L, ...)`` parameters,
    registered under the JAX package's names (``ln_1__weight``, ...) in its
    order, so ``load_numpy_params`` takes a scanned JAX GPT's
    ``named_parameters()``.  The forward runs a parameter-free template
    block on each layer's views (``torch.func.functional_call``), under
    ``torch.utils.checkpoint`` (non-reentrant) when ``remat``: "full"
    recomputes the block in the backward; "dots" keeps the outputs of
    ``aten.mm`` / ``aten.addmm`` (the Linears) and recomputes the rest, the
    flash-attention and LayerNorm functions included; "dots_all" keeps
    ``aten.bmm`` / ``aten.baddbmm`` too.  ``state_dict`` and
    ``load_state_dict`` use per-layer names (``h.0.ln_1.weight``)."""

    def __init__(self, blocks, remat=False):
        super().__init__()
        blocks = list(blocks)
        self.n_layers = len(blocks)
        self.remat = remat
        self._mode = remat_mode(remat)
        self._names = [n for n, _ in blocks[0].named_parameters()]
        self._keys = [n.replace(".", "__") for n in self._names]
        for n, key in zip(self._names, self._keys):
            self.register_parameter(key, nn.Parameter(torch.stack(
                [b.get_parameter(n).detach() for b in blocks])))
        # kept out of _modules: its own tensors are never parameters
        self.__dict__["_template"] = blocks[0].to("meta")

    def layer_params(self, l: int) -> dict:
        """{block parameter name: layer ``l``'s view of its stack}."""
        return {n: getattr(self, k)[l] for n, k in zip(self._names,
                                                       self._keys)}

    def fan_in(self, name: str) -> int:
        """The input width of the Linear that owns block parameter
        ``name``."""
        return self._template.get_submodule(name.rsplit(".", 1)[0]) \
            .in_features

    def _block(self, x, *params):
        return torch.func.functional_call(
            self._template, dict(zip(self._names, params)), (x,))

    def forward(self, x):
        # one unbind a stack: the backward stacks the layers' gradients once
        views = [getattr(self, k).unbind(0) for k in self._keys]
        for l in range(self.n_layers):
            ps = [v[l] for v in views]
            if self._mode is False:
                x = self._block(x, *ps)
            else:
                kw = {} if self._mode == "full" else {
                    "context_fn": functools.partial(_dots_context,
                                                    self._mode)}
                x = checkpoint(self._block, x, *ps, use_reentrant=False,
                               **kw)
        return x

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for l in range(self.n_layers):
            for n, v in self.layer_params(l).items():
                destination[f"{prefix}{l}.{n}"] = v if keep_vars \
                    else v.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        used = set()
        with torch.no_grad():
            for n, key in zip(self._names, self._keys):
                stack = getattr(self, key)
                for l in range(self.n_layers):
                    full = f"{prefix}{l}.{n}"
                    if full not in state_dict:
                        missing_keys.append(full)
                        continue
                    used.add(full)
                    v = state_dict[full]
                    if tuple(v.shape) != tuple(stack.shape[1:]):
                        error_msgs.append(
                            f"size mismatch for {full}: {tuple(v.shape)} "
                            f"!= {tuple(stack.shape[1:])}")
                        continue
                    stack[l].copy_(v)
        if strict:
            unexpected_keys.extend(k for k in state_dict
                                   if k.startswith(prefix) and k not in used)


class GPT(nn.Module):
    """GPT-2 causal language model (pre-LN, weight-tied LM head).

    Initialised as the JAX package initialises it: Linear weight and bias
    uniform in +-1/sqrt(fan_in), Embedding ``xavier`` (uniform in
    +-1/sqrt(numel)), LayerNorm ones and zeros -- drawn from ``generator``
    (the default torch generator when None) in parameter order."""

    def __init__(self, cfg: GPTConfig, *, device, dtype=torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        kw = {"device": "meta", "dtype": dtype}
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, **kw)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd, **kw)
        every = max(1, cfg.moe_every)
        blocks = [GPTBlock(cfg, use_moe=(cfg.n_experts > 0
                                         and i % every == every - 1), **kw)
                  for i in range(cfg.n_layer)]
        self.h = (ScannedBlocks(blocks, remat=cfg.remat) if cfg.scan_layers
                  else nn.ModuleList(blocks))
        self.ln_f = LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, **kw)
        self.to_empty(device=device)
        self._init_parameters(generator)

    def _layer_parameters(self):
        """(per-layer name, tensor) in the unscanned model's order: a
        scanned stack's layers as views, so both layouts draw the same
        weights from one generator."""
        scanned = isinstance(self.h, ScannedBlocks)
        for name, t in self.named_parameters():
            if not (scanned and name.startswith("h.")):
                yield name, t
            elif name == "h." + self.h._keys[0]:
                for l in range(self.h.n_layers):
                    for n, v in self.h.layer_params(l).items():
                        yield f"h.{l}.{n}", v

    def _fan_in(self, name, t):
        if t.dim() == 3:                    # an expert stack (E, in, out)
            return t.shape[1]
        if isinstance(self.h, ScannedBlocks) and name.startswith("h."):
            return self.h.fan_in(name.split(".", 2)[2])
        return self.get_submodule(name.rsplit(".", 1)[0]).in_features

    @torch.no_grad()
    def _init_parameters(self, generator):
        gdev = generator.device if generator is not None else "cpu"
        for name, t in self._layer_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if ".ln_" in name or name.startswith("ln_"):
                t.fill_(1.0 if leaf == "weight" else 0.0)
                continue
            if name.startswith(("wte.", "wpe.")):
                bound = 1.0 / float(np.sqrt(t.numel()))     # xavier
            else:
                bound = 1.0 / float(np.sqrt(self._fan_in(name, t)))
            u = torch.rand(t.shape, generator=generator, device=gdev,
                           dtype=torch.float32)
            t.copy_(u * (2 * bound) - bound)

    def _apply(self, fn, *args, **kwargs):
        # device/dtype moves invalidate the decode functions' packed weights
        self.__dict__.pop("_kv_fns", None)
        return super()._apply(fn, *args, **kwargs)

    def quantize_serving(self, enable: bool = True):
        """int8 weight-only decode: the decode functions store the 4
        per-layer matrices and a copy of the tied LM head as per-output-
        channel symmetric int8 (scale ``max(absmax, 1e-8) / 127`` in the
        compute dtype).  Training and ``forward`` are untouched.  The decode
        functions are rebuilt at the next generate call (models/decoding.py
        keeps no other state on the model)."""
        self._serve_quant = bool(enable)
        self.__dict__.pop("_kv_fns", None)
        return self

    def quantize_kv(self, enable: bool = True):
        """int8 KV cache: decode-cache rows stored as per-row symmetric int8
        with f32 scales; the cache becomes the pair ``(int8 rows (L, 2, H,
        W, hd), f32 scales (L, 2, H, W, 1))``.  Composes with
        :meth:`quantize_serving`.  The decode functions are rebuilt at the
        next generate call."""
        self._kv_quant = bool(enable)
        self.__dict__.pop("_kv_fns", None)
        return self

    def forward(self, input_ids):
        """Logits (b, s, vocab); differentiable (the training forward).
        Sets ``aux_loss`` and ``z_loss``: each the sum over the routed MoE
        blocks of theirs, None on a model without them.  Add ``aux_loss``
        times a weight to the training loss."""
        if is_sharded(input_ids, self.wte.weight):
            # sharded weights or tokens (the parallel layer): the whole
            # tensors beside them count as replicated -- the weights through
            # from_local, so their gradients come back whole, the rest
            # (positions, routing indices) by implicit replication
            from torch.distributed.tensor import DTensor, Replicate
            from torch.distributed.tensor.experimental import \
                implicit_replication
            from torch.nn.utils.stateless import _reparametrize_module

            mesh = next(t for t in (input_ids, self.wte.weight)
                        if is_sharded(t)).device_mesh

            def whole(t):
                return t if is_sharded(t) else DTensor.from_local(
                    t, mesh, [Replicate()] * mesh.ndim, run_check=False)

            params = {n: whole(p) for n, p in self.named_parameters()}
            with implicit_replication(), \
                    _reparametrize_module(self, params):
                return self._forward(whole(input_ids))
        return self._forward(input_ids)

    def _forward(self, input_ids):
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device)
        if is_sharded(input_ids):
            from torch.distributed.tensor import DTensor, Replicate

            mesh = input_ids.device_mesh
            pos = DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
        x = self.wte(input_ids) + self.wpe(pos)
        aux = zl = None
        if isinstance(self.h, ScannedBlocks):
            x = self.h(x)
        else:
            for block in self.h:
                x = block(x)
                moe = getattr(block, "moe", None)
                if moe is not None and moe.aux_loss is not None:
                    aux = moe.aux_loss if aux is None else aux + moe.aux_loss
                    zl = moe.z_loss if zl is None else zl + moe.z_loss
        self.aux_loss, self.z_loss = aux, zl
        x = self.ln_f(x)
        if is_sharded(x):       # as Linear: the kernel's placement rules
            return matmul(x, self.wte.weight.T)
        return x @ self.wte.weight.T        # weight-tied LM head

    @torch.no_grad()
    def generate(self, ids, max_new_tokens: int = 20, temperature: float = 0.0,
                 rng: np.random.Generator = None, use_cache: bool = True,
                 top_k: int = 0, top_p: float = 0.0, num_beams: int = 1,
                 eos_id: int = None, length_penalty: float = 1.0,
                 repetition_penalty: float = 1.0, stream=None):
        """Autoregressive decode; greedy when ``temperature=0``.

        ``use_cache=True``: one prefill of the prompt padded to the window,
        then one cached step per token.  ``use_cache=False``: full recompute
        of the right-padded window per token (under the causal mask the pad
        cannot reach the last real position), the window's forward compiled
        once by ``jit`` (a model with sharded parameters runs it eagerly).
        ``num_beams > 1``: beam search over the cached step
        (models/decoding.py)."""
        ids = list(ids)
        if num_beams > 1:
            from .decoding import beam_search

            assert temperature == 0.0, "beam search is deterministic"
            return beam_search(self, ids, max_new_tokens, beam_size=num_beams,
                               eos_id=eos_id, length_penalty=length_penalty)
        rng = rng or np.random.default_rng(0)
        if use_cache:
            return self._generate_kv(ids, max_new_tokens, temperature, rng,
                                     top_k=top_k, top_p=top_p,
                                     repetition_penalty=repetition_penalty,
                                     stream=stream, eos_id=eos_id)
        window = self.cfg.n_positions
        dev = self.wte.weight.device
        forward = self.forward
        if not is_sharded(self.wte.weight):
            if "_decode_fn" not in self.__dict__:
                from ..jit import jit

                self.__dict__["_decode_fn"] = jit(lambda x: self(x))
            forward = self._decode_fn
        for _ in range(max_new_tokens):
            ctx = ids[-window:]
            padded = torch.tensor([ctx + [0] * (window - len(ctx))],
                                  device=dev)
            logits = forward(padded)[0, len(ctx) - 1]
            ids.append(_sample(logits.float().cpu().numpy(), temperature, rng,
                               top_k=top_k, top_p=top_p,
                               repetition_penalty=repetition_penalty,
                               prev_ids=ids))
            if stream is not None:
                stream(ids[-1])
            if eos_id is not None and ids[-1] == eos_id:
                break
        return ids

    # --- KV-cache incremental decoding -----------------------------------
    def _kv_functions(self, pack_stack=None):
        """Build KVFns(init_cache, prefill, step, extend, step_batch) over
        the parameters.  The cache is one tensor ``(L, 2, n_head, W, hd)``,
        or under :meth:`quantize_kv` the pair of its int8 rows and their
        f32 row scales; the functions write new K/V rows into it IN PLACE
        (the JAX package returned a new array) and return it.
        Under :meth:`quantize_serving` the per-layer matrices and the LM
        head are int8 (``name#q``) with per-channel scales (``name#s``).

        ``pack_stack`` None packs the weights for the whole-stack decode
        kernel when the kernel takes the shape (``stack_supported``), True
        requires it, and False forces the unrolled per-layer branch (tests
        and the smoke run use it to hold the two branches against each
        other).  A model with MoE blocks or with Linears converted by
        ``quant.quantize_module`` has none: it raises ValueError
        (``generate(use_cache=False)`` decodes it)."""
        from ..quant import TorchQuantLinear

        cfg = self.cfg
        if cfg.n_experts:
            raise ValueError(
                "KV-cache decoding of a GPT with MoE blocks is not "
                "supported: decode it with generate(use_cache=False)")
        if any(isinstance(m, TorchQuantLinear) for m in self.modules()):
            raise ValueError(
                "KV-cache decoding of a GPT converted by "
                "quant.quantize_module is not supported: decode it with "
                "generate(use_cache=False) (GPT.quantize_serving quantizes "
                "the cached path)")
        H, L, W = cfg.n_head, cfg.n_layer, cfg.n_positions
        d = cfg.n_embd
        hd = d // H
        eps = cfg.layer_norm_epsilon
        # sharded weights (parallel.shard_module) decode whole: the decode
        # kernels take their operands replicated, as GSPMD gives a custom
        # call it cannot partition in the JAX package
        p = {name: t.detach().full_tensor() if is_sharded(t) else t.detach()
             for name, t in self.named_parameters()}
        if isinstance(self.h, ScannedBlocks):
            # scanned stack: per-layer views under the flat h.{l}. names
            for l in range(L):
                for n, v in self.h.layer_params(l).items():
                    p[f"h.{l}.{n}"] = v.detach().full_tensor() \
                        if is_sharded(v) else v.detach()
        scale = 1.0 / float(np.sqrt(hd))
        wte = p["wte.weight"]
        cdt = wte.dtype
        kv_quant = bool(getattr(self, "_kv_quant", False))
        if getattr(self, "_serve_quant", False):
            def int8(w):
                q, s = quantize_rows(w)
                return q, s[:, 0].to(cdt)

            big = [n for n in p if n.endswith(".weight") and p[n].ndim == 2
                   and not n.startswith(("wte.", "wpe."))]
            for n in big:
                p[n + "#q"], p[n + "#s"] = int8(p.pop(n))
            # the tied head reads wte: quantize a separate serving copy
            p["head#q"], p["head#s"] = int8(wte)
        if pack_stack is None:
            pack_stack = stack_supported(d=d, hd=hd, n=8)
        elif pack_stack and not stack_supported(d=d, hd=hd, n=8):
            raise ValueError(f"decode stack kernel lacks d={d}, hd={hd}")
        if pack_stack:
            p.update(pack_gpt_stack(p, L, d))

        def ln(x, pre):
            return F.layer_norm(x, (d,), p[pre + ".weight"], p[pre + ".bias"],
                                eps)

        def lin(x, pre):
            q = p.get(pre + ".weight#q")
            if q is None:
                return F.linear(x, p[pre + ".weight"], p[pre + ".bias"])
            return F.linear(x, q.to(cdt)) * p[pre + ".weight#s"] \
                + p[pre + ".bias"]

        def mlp(x, pre):
            return lin(_gelu(lin(ln(x, pre + "ln_2"), pre + "c_fc")),
                       pre + "c_proj")

        def head(x):
            x = ln(x, "ln_f")
            if "head#q" in p:
                return (x @ p["head#q"].T.to(cdt)) * p["head#s"]
            return x @ wte.T

        def store(cache, index, rows):
            """Write K/V ``rows (..., hd)`` at ``cache[index]``; an int8
            cache stores their :func:`quantize_rows`."""
            if kv_quant:
                cq, cs = cache
                cq[index], cs[index] = quantize_rows(rows)
            else:
                cache[index] = rows

        def stack(fn, x, cache, pos):
            """The whole-stack kernel ``fn`` over the packed weights."""
            cache, kvs = cache if kv_quant else (cache, None)
            return fn(x, cache, pos, p["stack#slabs"], p["stack#vecs"],
                      p.get("stack#scales"), eps=eps, kv_scales=kvs)

        def _write_and_attend(cache, l, q, k, v, pos):
            """Write layer ``l``'s new K/V rows at pos.. and attend.  q/k/v:
            (H, n, hd).  One row over a float cache: the decode-attention
            kernel; more rows: plain masked attention over the window.  An
            int8 cache: the new rows quantized first, then plain attention
            with the K scale on the score column and the V scale on the
            probabilities."""
            n = q.shape[1]
            rows = pos + torch.arange(n, device=q.device)
            # a device position's rows as an index tensor
            at = rows if isinstance(pos, torch.Tensor) else slice(pos,
                                                                  pos + n)
            store(cache, (l, slice(None), slice(None), at),
                  torch.stack([k, v]))
            vis = rows[:, None] >= torch.arange(W, device=q.device)[None]
            if kv_quant:
                cq, cs = cache
                s = torch.einsum("hqd,hkd->hqk", q.float(),
                                 cq[l, 0].float()) * scale
                s = (s * cs[l, 0, :, :, 0][:, None, :]).masked_fill(
                    ~vis[None], -1e30)
                pr = torch.softmax(s, -1) * cs[l, 1, :, :, 0][:, None, :]
                att = torch.einsum("hqk,hkd->hqd", pr,
                                   cq[l, 1].float()).to(cdt)
                return att.transpose(0, 1).reshape(n, d)
            kc, vc = cache[l, 0], cache[l, 1]
            if n == 1:
                att = decode_attention(q.contiguous(), kc, vc, pos, scale)
            else:
                s = torch.einsum("hqd,hkd->hqk", q.float(), kc.float()) * scale
                s = s.masked_fill(~vis[None], -1e30)
                att = (torch.softmax(s, -1) @ vc.float()).to(q.dtype)
            return att.transpose(0, 1).reshape(n, d)

        def _layers(cache, x, pos):
            """The unrolled per-layer decode of rows at pos.. (x (n, d))."""
            n = x.shape[0]
            for l in range(L):
                pre = f"h.{l}."
                qkv = lin(ln(x, pre + "ln_1"), pre + "attn.c_attn")
                q, k, v = (t.reshape(n, H, hd).transpose(0, 1)
                           for t in qkv.split(d, dim=-1))
                att = _write_and_attend(cache, l, q, k, v, pos)
                x = x + lin(att, pre + "attn.c_proj")
                x = x + mlp(x, pre)
            return x

        def init_cache():
            if kv_quant:
                return (torch.zeros((L, 2, H, W, hd), device=wte.device,
                                    dtype=torch.int8),
                        torch.zeros((L, 2, H, W, 1), device=wte.device,
                                    dtype=torch.float32))
            return torch.zeros((L, 2, H, W, hd), device=wte.device,
                               dtype=cdt)

        def prefill(p, cache, toks, n_real):
            """The prompt padded to the window in ONE parallel causal pass;
            writes all W K/V rows (quantized on write into an int8 cache,
            while the pass itself attends them at full precision).  Pad rows
            beyond ``n_real`` hold garbage K/V that decode steps overwrite
            before the ``<= pos`` mask ever exposes them."""
            x = p["wte.weight"][toks] + p["wpe.weight"][:W]
            for l in range(L):
                pre = f"h.{l}."
                qkv = lin(ln(x, pre + "ln_1"), pre + "attn.c_attn")
                q, k, v = (t.reshape(W, H, hd).transpose(0, 1).contiguous()
                           for t in qkv.split(d, dim=-1))      # (H, W, hd)
                store(cache, l, torch.stack([k, v]))
                att = attention_fwd(q, k, v, scale, causal=True)
                x = x + lin(att.transpose(0, 1).reshape(W, d),
                            pre + "attn.c_proj")
                x = x + mlp(x, pre)
            return cache, head(last_row(x, n_real))[0]

        def step(p, cache, pos, tok):
            """One token at position ``pos`` (a host int, or an int32 scalar
            on the model's device, which the kernels read there and nothing
            reads to the host): returns (cache, logits)."""
            # device scalars as one-element index tensors (a 0-d tensor
            # index would be read to the host)
            if isinstance(pos, torch.Tensor):
                pos = at = pos.reshape(1)
            else:
                at = slice(pos, pos + 1)
            emb = (p["wte.weight"][tok.reshape(1)]
                   if isinstance(tok, torch.Tensor) else p["wte.weight"][tok])
            x = emb + p["wpe.weight"][at]                           # (1, d)
            if "stack#slabs" in p:
                x, kv = stack(decode_stack, x, cache, pos)
                store(cache, (slice(None),) * 3 + (at,),
                      kv.reshape(L, 2, H, 1, hd))
            else:
                x = _layers(cache, x, pos)
            return cache, head(x)[0]

        def extend(p, cache, pos0, toks):
            """Score K tokens at positions pos0..pos0+K-1 in one pass (the
            speculative-verify primitive); row i attends keys <= pos0+i.
            ``pos0`` a host int, or an int32 scalar on the model's device
            that nothing reads to the host (its rows written through an
            index tensor, never a 0-d index)."""
            K = toks.shape[0]
            if isinstance(pos0, torch.Tensor):
                pos0 = pos0.reshape(1)
            rows = pos0 + torch.arange(K, device=toks.device)
            x = p["wte.weight"][toks] + p["wpe.weight"][rows]
            if "stack#slabs" in p and K <= 8:
                x, kv = stack(decode_stack, x, cache, pos0)
                at = (rows if isinstance(pos0, torch.Tensor)
                      else slice(pos0, pos0 + K))
                store(cache, (slice(None),) * 3 + (at,),
                      kv.reshape(L, 2, K, H, hd).transpose(2, 3))
            else:
                x = _layers(cache, x, pos0)
            return cache, head(x)

        def step_batch(p, caches, poss, toks):
            """B independent slots, one token each: caches (B, L, 2, H, W,
            hd) (or the pair of int8 rows and (B, L, 2, H, W, 1) scales),
            poss (B,) int32 and toks (B,) on the model's device.  One
            weight stream for all B rows through the stack kernel; without
            the packed stack, one unrolled step per slot.  Positions past
            the window (a slot decoding beyond its request inside a tick)
            clamp, as the JAX package's gathers and slice updates do."""
            B = toks.shape[0]
            pc = poss.long().clamp(max=W - 1)
            if "stack#slabs" not in p or not stack_supported(d=d, hd=hd, n=B):
                pi = pc.int()
                out = [step(p, cache_slot(caches, b), pi[b], toks[b])[1]
                       for b in range(B)]
                return caches, torch.stack(out)
            x = p["wte.weight"][toks] + p["wpe.weight"][pc]
            x, kv = stack(decode_stack_batch, x, caches, poss)
            dev = x.device
            idx = [torch.arange(n, device=dev).reshape(
                [n if i == j else 1 for j in range(4)])
                for i, n in enumerate((B, L, 2, H))]
            store(caches, (*idx, pc.reshape(B, 1, 1, 1)),
                  kv.reshape(L, 2, B, H, hd).permute(2, 0, 1, 3, 4))
            return caches, head(x)

        # compiled, but over sharded parameters (decided here, once)
        kw = dict(compiled=not any(is_sharded(t) for t in self.parameters()))
        return KVFns(init_cache, ParamFn(prefill, p, **kw),
                     ParamFn(step, p, **kw), ParamFn(extend, p, **kw),
                     ParamFn(step_batch, p, **kw))

    @torch.no_grad()
    def _generate_kv(self, ids, max_new_tokens, temperature, rng,
                     top_k: int = 0, top_p: float = 0.0,
                     repetition_penalty: float = 1.0, stream=None,
                     eos_id: int = None):
        W = self.cfg.n_positions
        assert len(ids) + max_new_tokens <= W, (
            f"KV-cache decode needs prompt+new <= n_positions "
            f"({len(ids)}+{max_new_tokens} > {W}); use use_cache=False for "
            f"sliding-window recompute")
        fns = _kv(self)
        _, prefill, step = fns
        # the cache kept for the signature: the compiled functions replay
        # at its address
        cache = cache_slot(_stack(fns, "generate", 1), 0)
        toks = torch.zeros(W, dtype=torch.long)
        toks[:len(ids)] = torch.as_tensor(ids, dtype=torch.long)
        cache, logits = prefill(cache, toks.to(self.wte.weight.device),
                                len(ids))
        out = list(ids)

        def emit(lg):
            out.append(_sample(lg.float().cpu().numpy(), temperature, rng,
                               top_k=top_k, top_p=top_p,
                               repetition_penalty=repetition_penalty,
                               prev_ids=out))
            if stream is not None:
                stream(out[-1])

        emit(logits)
        for _ in range(max_new_tokens - 1):
            if eos_id is not None and out[-1] == eos_id:
                break
            cache, logits = step(cache, len(out) - 1, out[-1])
            emit(logits)
        return out

    def generate_device(self, ids, max_new_tokens: int = 20,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 0.0, eos_id: int = None,
                        seed: int = 0):
        """Whole-generation decoding on the device (models/decoding.py:
        generate_device): position, token and sampling stay on the device,
        one readback a generation instead of one a token."""
        from .decoding import generate_device

        return generate_device(self, list(ids), max_new_tokens,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p, eos_id=eos_id, seed=seed)

    def generate_batch_device(self, prompts, max_new_tokens: int = 20,
                              temperature: float = 0.0, top_k: int = 0,
                              top_p: float = 0.0, eos_id: int = None,
                              seed: int = 0):
        """Batched whole-generation decoding on the device: B ragged
        prompts, one ``step_batch`` a round (models/decoding.py)."""
        from .decoding import generate_batch_device

        return generate_batch_device(self, prompts, max_new_tokens,
                                     temperature=temperature, top_k=top_k,
                                     top_p=top_p, eos_id=eos_id, seed=seed)

    @torch.no_grad()
    def generate_batch(self, prompts, max_new_tokens: int = 20,
                       temperature: float = 0.0,
                       rng: np.random.Generator = None, top_k: int = 0,
                       top_p: float = 0.0, eos_id: int = None):
        """B ragged prompts decode together (models/decoding.py).  Returns a
        list of B token lists (prompt + generated, eos included)."""
        from .decoding import generate_batch

        return generate_batch(self, prompts, max_new_tokens,
                              temperature=temperature, rng=rng, top_k=top_k,
                              top_p=top_p, eos_id=eos_id)


    # --- HF interop --------------------------------------------------------
    @staticmethod
    def remap_hf_state(state: dict) -> dict:
        """An HF GPT-2 state (numpy arrays or torch tensors) under this
        model's names: the ``transformer.`` prefix dropped, the attention's
        mask buffers and the tied ``lm_head`` skipped, ``mlp.`` removed, and
        the Conv1D weights (stored (in, out)) transposed to (out, in)."""
        out = {}
        for name, arr in state.items():
            name = name.removeprefix("transformer.")
            if name.endswith((".attn.bias", ".attn.masked_bias")):
                continue                    # causal-mask buffers
            if name == "lm_head.weight":
                continue                    # tied to wte
            name = name.replace(".mlp.c_fc.", ".c_fc.") \
                .replace(".mlp.c_proj.", ".c_proj.")
            if name.endswith(".weight") and any(
                    k in name for k in (".c_attn.", ".c_proj.", ".c_fc.")):
                arr = (arr.T.contiguous() if isinstance(arr, torch.Tensor)
                       else np.ascontiguousarray(arr.T))
            out[name] = arr
        return out

    def export_hf_state(self) -> dict:
        """``state_dict()`` under HF's GPT-2 names (the inverse of
        :meth:`remap_hf_state`): ``mlp.`` restored, Conv1D weights
        transposed back; contiguous CPU tensors in the parameters'
        dtype."""
        out = {}
        for name, t in self.state_dict().items():
            hf = name
            if ".attn." not in hf:
                hf = hf.replace(".c_fc.", ".mlp.c_fc.") \
                    .replace(".c_proj.", ".mlp.c_proj.")
            t = t.detach().cpu()
            if hf.endswith(".weight") and any(
                    k in hf for k in (".c_attn.", ".c_proj.", ".c_fc.")):
                t = t.T
            out[hf] = t.contiguous()
        return out

    def save_pretrained(self, directory: str) -> str:
        """Write ``pytorch_model.bin`` (``torch.save`` of
        :meth:`export_hf_state`) and the JAX package's ``config.json`` into
        ``directory``; returns the weights' path."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "pytorch_model.bin")
        torch.save(self.export_hf_state(), path)
        c = self.cfg
        cfg = {
            "model_type": "gpt2",
            "vocab_size": c.vocab_size,
            "n_positions": c.n_positions,
            "n_embd": c.n_embd,
            "n_layer": c.n_layer,
            "n_head": c.n_head,
            "layer_norm_epsilon": c.layer_norm_epsilon,
        }
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)
        return path

    @staticmethod
    def from_pretrained(name: str = "gpt2", *, device="cuda",
                        dtype=torch.float32):
        """(model, config) of an HF repository's ``config.json`` and
        ``pytorch_model.bin`` through :func:`utils.fetch` (which reads a
        file named md5(url) from ``LIGHTGRAD_CACHE`` before the network),
        on ``device``."""
        from ..utils import fetch

        url = f"https://huggingface.co/{name}/resolve/main/"
        cfg = GPTConfig(**json.loads(fetch(url + "config.json")))
        model = GPT(cfg, device=device, dtype=dtype)
        state = torch.load(io.BytesIO(fetch(url + "pytorch_model.bin")),
                           map_location="cpu", weights_only=True)
        model.load_state_dict(GPT.remap_hf_state(state))
        return model, cfg


class ByteTokenizer:
    """Offline fallback: raw UTF-8 bytes (vocab 256)."""

    vocab_size = 256

    def encode(self, text: str):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


class GPT2Tokenizer:
    """Byte-level BPE (GPT-2's), built from HF ``vocab.json`` and
    ``merges.txt``.  The JAX package merges through its native library when
    every merge's parts and result are vocabulary entries; the port runs its
    Python merge loop (``_bpe``) always, which gives the same ids."""

    # GPT-2's pre-split: contractions, letters, digits, other runs, spaces
    _PAT = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d| ?\w+| ?[^\s\w]+|\s+(?!\S)|\s+")

    def __init__(self, vocab: dict, merges):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_enc = self._bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self._cache = {}

    @staticmethod
    def _bytes_to_unicode():
        """Every byte as a printable character: the printable Latin-1 bytes
        map to themselves, the rest to 256 and up."""
        bs = (list(range(ord("!"), ord("~") + 1))
              + list(range(ord("\xa1"), ord("\xac") + 1))
              + list(range(ord("\xae"), ord("\xff") + 1)))
        cs = bs[:]
        n = 0
        for b in range(256):
            if b not in bs:
                bs.append(b)
                cs.append(256 + n)
                n += 1
        return dict(zip(bs, (chr(c) for c in cs)))

    def _bpe(self, token: str):
        """Merge the lowest-ranked adjacent pair until none is a merge."""
        word = list(token)
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p,
                                                               float("inf")))
            if best not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        return word

    def _encode_word(self, mapped: str):
        """One pre-split word (byte-mapped) -> vocab ids, cached; pieces
        outside the vocabulary are dropped, as the JAX package drops
        them."""
        ids = self._cache.get(mapped)
        if ids is None:
            ids = self._cache[mapped] = [
                self.encoder[p] for p in self._bpe(mapped)
                if p in self.encoder]
        return ids

    def encode(self, text: str):
        ids = []
        for tok in self._PAT.findall(text):
            ids.extend(self._encode_word(
                "".join(self.byte_enc[b] for b in tok.encode("utf-8"))))
        return ids

    def decode(self, ids):
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        return bytes(self.byte_dec.get(c, 32) for c in text).decode(
            "utf-8", errors="replace")

    @staticmethod
    def from_pretrained(name: str = "gpt2"):
        """``vocab.json`` and ``merges.txt`` of an HF repository through
        :func:`utils.fetch`."""
        from ..utils import fetch

        url = f"https://huggingface.co/{name}/resolve/main/"
        vocab = json.loads(fetch(url + "vocab.json"))
        merges_txt = fetch(url + "merges.txt").decode("utf-8")
        merges = [tuple(line.split()) for line in merges_txt.splitlines()[1:]
                  if line.strip()]
        return GPT2Tokenizer(vocab, merges)
