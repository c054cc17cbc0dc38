"""The LLaMA family on the lightgrad tape: RoPE, RMSNorm, SwiGLU / GELU,
grouped-query attention, Mistral's sliding window and Mixtral's experts.

Counterpart of ``lightgrad_tpu/models/llama.py``, with its class, function
and parameter names: one config covers LLaMA, Mistral (``sliding_window``),
Qwen2 (``attention_bias``), Gemma (``head_dim``, ``hidden_act="gelu"``,
``rms_offset``, ``scale_embeddings``, tied embeddings) and Mixtral
(``num_local_experts`` routed SwiGLU experts, top-``num_experts_per_tok``,
through ``nn.MoE`` with no capacity drops).  Every op of the training
forward runs on the tape's ``CudaTensor``s and so on the port's kernels:
the products through the matmul kernel (the expert products on its batch
path), RoPE, RMSNorm, SiLU / GELU, the router's softmax and bookkeeping and
the residual adds through the elementwise, reduce and softmax kernels, and
self-attention through the flash kernels -- grouped-query and banded by the
window inside the kernels, in both directions.

Serving (:meth:`Llama._kv_functions`) is plain PyTorch over the parameters'
tensors, as it was plain XLA in the JAX package, except for its two kernels:
prefill's causal (and banded) attention through the flash forward, and each
decode step's attention over a float cache through the decode-attention
kernel -- one launch for all slots in ``step_batch``, which runs the B
slots as one batch (the JAX package's ``jax.vmap`` of ``step``), positions
kept on the device.  :meth:`Llama.quantize_serving` (int8 weights) and
:meth:`Llama.quantize_kv` (an int8 cache, dequantized inside the score and
context products) are plain PyTorch, as in the JAX package.

Also here: the HF interop (:meth:`Llama.remap_hf_state`,
``export_hf_state``, ``save_pretrained``, ``from_pretrained``; the file is
HF's ``pytorch_model.bin``, written by ``torch.save`` and read by
``torch.load(weights_only=True)``) and :class:`LlamaTokenizer` over the
port's SentencePiece reader.

``LlamaConfig(scan_layers=True, remat=...)`` holds the layers as one
:class:`~lightgrad_tpu_torch.scan.ScannedStack` (stacked parameters under
the JAX package's names, one tape op, ``remat`` False / "full" / "dots");
the decode functions read per-layer views of the stacks.

Under ``parallel.enable_sequence_parallel`` attention is ring attention
over the mesh's sequence axis (parallel/ring_attention.py), K/V expanded to
q's head count first; a sliding window is refused there.
"""

import io
import json
import os
import re

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..autograd import Tensor, no_grad
from ..ops.attention import attention_fwd
from ..ops.decode_attention import decode_attention, decode_attention_batch
from ..ops.runtime import is_sharded
from ..scan import ScannedStack, layer_tensors
from .decoding import KVFns, ParamFn, _kv, _stack, cache_slot, last_row
from .gpt import quantize_rows

__all__ = ["LlamaConfig", "Llama", "RMSNorm", "LlamaTokenizer"]


class LlamaConfig:
    """The JAX package's config."""

    def __init__(self, vocab_size=32000, hidden_size=512,
                 intermediate_size=1376, num_hidden_layers=4,
                 num_attention_heads=8, num_key_value_heads=None,
                 max_position_embeddings=2048, rms_norm_eps=1e-5,
                 rope_theta=10000.0, tie_word_embeddings=False,
                 scan_layers=False, remat=False, num_local_experts=0,
                 num_experts_per_tok=2, attention_bias=False, head_dim=None,
                 hidden_act="silu", rms_offset=False,
                 scale_embeddings=False, sliding_window=None,
                 use_sliding_window=True, **unused):
        if num_local_experts and scan_layers:
            raise ValueError(
                "scan_layers cannot thread per-forward MoE aux state; "
                "use scan_layers=False with num_local_experts")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        # the layers as one ScannedStack (lightgrad_tpu_torch/scan.py);
        # remat rematerialises their activations in the backward
        self.scan_layers = scan_layers
        self.remat = remat
        # Mixtral (HF MixtralConfig's names): every block's MLP becomes
        # num_local_experts routed SwiGLU experts, top-num_experts_per_tok
        self.num_local_experts = num_local_experts
        self.num_experts_per_tok = num_experts_per_tok
        # Qwen2: q/k/v Linears carry biases (o_proj never does)
        self.attention_bias = attention_bias
        # Gemma: explicit head_dim, tanh-GELU MLP, (1 + w) RMSNorm deltas,
        # sqrt(hidden) embedding scale
        self.head_dim = head_dim or hidden_size // num_attention_heads
        self.hidden_act = hidden_act
        self.rms_offset = rms_offset
        self.scale_embeddings = scale_embeddings
        # Mistral: position i attends to keys in [i - W + 1, i]; Qwen2
        # checkpoints carry the field with use_sliding_window=False (inert)
        self.sliding_window = (int(sliding_window)
                               if sliding_window and use_sliding_window
                               else None)


class RMSNorm(nn.Module):
    """``offset=1.0`` is the Gemma convention: the checkpoint stores
    zero-initialised deltas and the effective scale is ``1 + w``."""

    def __init__(self, dim: int, eps: float = 1e-5, offset: float = 0.0):
        super().__init__()
        self.weight = Tensor.ones((dim,))
        self.eps = eps
        self.offset = offset

    def forward(self, x):
        var = (x * x).mean(axis=-1, keepdims=True)
        w = self.weight + self.offset if self.offset else self.weight
        return x * (var + self.eps) ** -0.5 * w


def _rope_tables(seq: int, head_dim: int, theta: float):
    """HF-convention RoPE tables: cos/sin of shape (seq, head_dim), the
    half-frequencies tiled twice along the feature axis."""
    freqs = 1.0 / theta ** (np.arange(0, head_dim, 2, np.float32) / head_dim)
    ang = np.outer(np.arange(seq, dtype=np.float32), freqs)  # (s, hd/2)
    emb = np.concatenate([ang, ang], axis=-1)               # (s, hd)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _apply_rope(x, cos_t, sin_t):
    """x: (b, h, s, hd) tape tensor; cos/sin: (1, 1, s, hd) constants."""
    hd = x.shape[-1]
    x1 = x[..., : hd // 2]
    x2 = x[..., hd // 2:]
    rotated = (-x2).concat(x1, axis=-1)
    return x * cos_t + rotated * sin_t


def moe_rows(n_real: int, W: int) -> int:
    """The rows a mixture-of-experts prefill routes for a prompt of
    ``n_real`` tokens: the power of two at or above it, at most the window
    ``W`` (a bucket: one compiled prefill graph for each)."""
    return min(W, 1 << max(int(n_real) - 1, 0).bit_length())


def topk_gates(probs, k: int):
    """The decode functions' routing rule: the ``k`` largest of each row of
    router probabilities ``probs (n, E)`` by k passes of ``argmax`` (the
    first maximum, so an exact tie goes to the lowest index, as
    ``lax.top_k`` and ``nn.MoE`` break it), and their renormalised
    probabilities: (gates (n, k), expert ids (n, k)).  Nothing is read on
    the host."""
    rem, ids = probs, []
    for _ in range(k):
        i = rem.argmax(-1, keepdim=True)
        ids.append(i)
        rem = rem.scatter(-1, i, -1.0)
    ids = torch.cat(ids, -1)
    gates = probs.gather(-1, ids)
    return gates / gates.sum(-1, keepdim=True), ids


def _constant(a: np.ndarray, like):
    """A gradient-free tape constant of ``like``'s dtype (an f32 table
    would widen a bf16 stream)."""
    t = Tensor.from_numpy(a, requires_grad=False)
    return t if t.dtype == like.dtype else t.astype(like.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.n_heads = cfg.num_attention_heads
        self.n_kv = cfg.num_key_value_heads
        self.head_dim = cfg.head_dim
        self.theta = cfg.rope_theta
        h = cfg.hidden_size
        qh, kvh = self.n_heads * self.head_dim, self.n_kv * self.head_dim
        ab = cfg.attention_bias
        self.q_proj = nn.Linear(h, qh, bias=ab)
        self.k_proj = nn.Linear(h, kvh, bias=ab)
        self.v_proj = nn.Linear(h, kvh, bias=ab)
        self.o_proj = nn.Linear(qh, h, bias=False)
        self.sliding_window = cfg.sliding_window

    def forward(self, x):
        b, s, h = x.shape
        hd = self.head_dim
        q = self.q_proj(x).reshape(b, s, self.n_heads, hd).transpose(0, 2, 1, 3)
        k = self.k_proj(x).reshape(b, s, self.n_kv, hd).transpose(0, 2, 1, 3)
        v = self.v_proj(x).reshape(b, s, self.n_kv, hd).transpose(0, 2, 1, 3)

        cos_np, sin_np = _rope_tables(s, hd, self.theta)
        cos_t = _constant(cos_np[None, None], x)
        sin_t = _constant(sin_np[None, None], x)
        q = _apply_rope(q, cos_t, sin_t)
        k = _apply_rope(k, cos_t, sin_t)

        scale = 1.0 / np.sqrt(hd)
        # the band is a no-op when the sequence fits inside it
        win = self.sliding_window
        win = int(win) if win and win < s else 0
        sp = getattr(self, "_sequence_parallel", None)
        if self.n_kv != self.n_heads and sp is not None:
            # grouped-query expand (gather forward, scatter-add backward)
            # for the ring: its blocks take K/V of q's head count
            idx = np.repeat(np.arange(self.n_kv), self.n_heads // self.n_kv)
            k = k[:, idx]
            v = v[:, idx]
        if sp is not None:
            # sequence-parallel ring attention; RoPE was applied on the
            # global sequence above, so the sharded chunks carry their true
            # positions
            if win:
                raise NotImplementedError(
                    "ring attention + sliding window not supported; run "
                    "sliding-window models without sequence parallelism")
            mesh, axis, batch_axis = sp
            ctx = q.ring_attention(k, v, scale=scale, mesh=mesh, axis=axis,
                                   causal=True, batch_axis=batch_axis)
        elif hasattr(q, "attention"):
            # grouped-query inside the flash kernels: no repeated K/V
            ctx = q.attention(k, v, scale=scale, causal=True, window=win)
        else:
            # a backend without a fused attention op: the raw scores, the
            # additive causal / band mask and the softmax
            if self.n_kv != self.n_heads:
                # grouped-query expand (gather forward, scatter-add backward)
                idx = np.repeat(np.arange(self.n_kv),
                                self.n_heads // self.n_kv)
                k = k[:, idx]
                v = v[:, idx]
            scores = (q @ k.transpose(0, 1, 3, 2)) * scale
            mask = np.triu(np.full((s, s), -1e30, np.float32), k=1)
            if win:
                mask = mask + np.tril(
                    np.full((s, s), -1e30, np.float32), k=-win)
            scores = scores + _constant(mask, scores)
            ctx = scores.softmax(axis=-1) @ v
        return self.o_proj(
            ctx.transpose(0, 2, 1, 3).reshape(b, s, self.n_heads * hd))


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)); Gemma's tanh-GELU gate."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.act = ("gelu_tanh" if cfg.hidden_act in ("gelu",
                                                      "gelu_pytorch_tanh")
                    else "silu")
        self.gate_proj = nn.Linear(h, i, bias=False)
        self.up_proj = nn.Linear(h, i, bias=False)
        self.down_proj = nn.Linear(i, h, bias=False)

    def forward(self, x):
        g = self.gate_proj(x)
        act = g.gelu() if self.act == "gelu_tanh" else g.sigmoid() * g
        return self.down_proj(act * self.up_proj(x))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        off = 1.0 if cfg.rms_offset else 0.0
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       offset=off)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, offset=off)
        e = cfg.num_local_experts
        if e:
            # Mixtral's block: routed SwiGLU experts, softmax over all and
            # top-k renormalised gates; capacity_factor E / k makes the
            # capacity every token, so no routing is dropped
            self.block_sparse_moe = nn.MoE(
                cfg.hidden_size, cfg.intermediate_size, e, dispatch="topk",
                k=cfg.num_experts_per_tok,
                capacity_factor=e / cfg.num_experts_per_tok,
                normalize_gates=True, ffn="swiglu")
        else:
            self.mlp = LlamaMLP(cfg)

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        ffn = getattr(self, "block_sparse_moe", None) or self.mlp
        return x + ffn(self.post_attention_layernorm(x))


class Llama(nn.Module):
    """Causal LM with a separate (or tied) LM head.  Initialised as the JAX
    model: Linear weights uniform in +-1/sqrt(fan_in), the embedding
    ``xavier``, RMSNorm weights ones, from ``lightgrad_tpu_torch.random``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        blocks = [LlamaLayer(cfg) for _ in range(cfg.num_hidden_layers)]
        if cfg.scan_layers:
            self.layers = ScannedStack(blocks, remat=cfg.remat)
        else:
            self.layers = nn.ModuleList(*blocks)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                            offset=1.0 if cfg.rms_offset else 0.0)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False)

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        if self.cfg.scale_embeddings:
            x = x * float(self.cfg.hidden_size ** 0.5)
        aux = zl = None
        if not isinstance(self.layers, nn.ModuleList):
            x = self.layers(x)      # ScannedStack: one tape op, all layers
        for layer in self.layers if isinstance(self.layers, nn.ModuleList) \
                else ():
            x = layer(x)
            moe = getattr(layer, "block_sparse_moe", None)
            if moe is not None:
                # router losses, summed over the blocks (plain attributes)
                aux = moe.aux_loss if aux is None else aux + moe.aux_loss
                zl = moe.z_loss if zl is None else zl + moe.z_loss
        object.__setattr__(self, "aux_loss", aux)
        object.__setattr__(self, "z_loss", zl)
        x = self.norm(x)
        if self.cfg.tie_word_embeddings:
            return x @ self.embed_tokens.weight.T(1, 0)
        return self.lm_head(x)

    # --- generation ------------------------------------------------------
    @no_grad()
    def generate(self, ids, max_new_tokens: int = 20, temperature: float = 0.0,
                 rng: np.random.Generator = None, use_cache: bool = True,
                 top_k: int = 0, top_p: float = 0.0, num_beams: int = 1,
                 eos_id: int = None, length_penalty: float = 1.0):
        """Autoregressive decode; greedy when ``temperature=0``.
        ``use_cache=True``: one prefill of the prompt padded to the window,
        then one cached step a token.  ``use_cache=False``: a full forward
        of the right-padded window a token (the causal mask keeps the pad
        from the last real position), compiled once by ``jit``.
        ``num_beams > 1``: beam search over the cached step
        (models/decoding.py)."""
        from .gpt import _sample

        ids = list(ids)
        if num_beams > 1:
            from .decoding import beam_search

            assert temperature == 0.0, "beam search is deterministic"
            return beam_search(self, ids, max_new_tokens, beam_size=num_beams,
                               eos_id=eos_id, length_penalty=length_penalty)
        rng = rng or np.random.default_rng(0)
        if use_cache:
            return self._generate_kv(ids, max_new_tokens, temperature, rng,
                                     top_k=top_k, top_p=top_p)
        if not hasattr(self, "_decode_fn"):
            from ..jit import jit

            def _decode(x):
                with no_grad():
                    return self.forward(x)

            self._decode_fn = jit(_decode)
        window = self.cfg.max_position_embeddings
        for _ in range(max_new_tokens):
            ctx = ids[-window:]
            padded = ctx + [0] * (window - len(ctx))
            x = Tensor.from_numpy(np.array([padded], dtype=np.int32),
                                  requires_grad=False)
            logits = self._decode_fn(x)[0, len(ctx) - 1].numpy()
            ids.append(_sample(logits, temperature, rng, top_k=top_k,
                               top_p=top_p))
        return ids

    def _kv_functions(self):
        """KVFns(init_cache, prefill, step, None, step_batch) over the
        parameters' tensors.  The cache is one tensor ``(L, 2, KV, W, hd)``
        in the parameters' dtype, or under :meth:`quantize_kv` the pair of
        its int8 rows and their f32 row scales ``(L, 2, KV, W, 1)``; the
        functions write new K/V rows into it IN PLACE (the JAX package
        returned a new array) and return it.  Under
        :meth:`quantize_serving` every 2-D projection but the embedding and
        the router is int8 (``name#q``) with a scale a row (``name#s``), a
        tied head its own int8 copy (``head#q``); expert stacks stay float.

        Mixtral's routed FFN: the router's logits get a softmax in f32; the
        top-k are k passes of ``argmax`` (the first maximum, so an exact tie
        goes to the lowest index, as ``lax.top_k``); the k gates are
        renormalised and cast to the compute dtype.  ``step``, ``step_batch``
        and the prefill run every expert over all their rows, the E stacks
        read in place by one batched product each, and weight each expert
        by its gate, zero where it was not chosen (the JAX step gathers the
        k stacks a row: the same sums, where a gather would copy them)."""
        cfg = self.cfg
        H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        L, W = cfg.num_hidden_layers, cfg.max_position_embeddings
        eps = cfg.rms_norm_eps
        off = 1.0 if cfg.rms_offset else 0.0
        gelu_act = cfg.hidden_act in ("gelu", "gelu_pytorch_tanh")
        n_exp, topk = cfg.num_local_experts, cfg.num_experts_per_tok
        p = {name: t.data for name, t in self.named_parameters()}
        if not isinstance(self.layers, nn.ModuleList):
            # scanned stack: per-layer views under the layers.{l}. names
            for l in range(L):
                for n, arr in self.layers.layer_params(l).items():
                    p[f"layers.{l}.{n}"] = arr
        scale = float(1.0 / np.sqrt(hd))
        emb = p["embed_tokens.weight"]
        cdt, dev = emb.dtype, emb.device
        kv_quant = bool(getattr(self, "_kv_quant", False))
        if getattr(self, "_serve_quant", False):
            def int8(w):
                q, s = quantize_rows(w)
                return q, s[:, 0].to(cdt)

            big = [n for n in p if n.endswith(".weight") and p[n].dim() == 2
                   and n != "embed_tokens.weight" and "router" not in n]
            for n in big:
                p[n + "#q"], p[n + "#s"] = int8(p.pop(n))
            if cfg.tie_word_embeddings:
                p["head#q"], p["head#s"] = int8(emb)
        # in the compute dtype, as the JAX package casts it
        emb_scale = (torch.tensor(cfg.hidden_size ** 0.5, dtype=cdt,
                                  device=dev) if cfg.scale_embeddings
                     else None)
        cos_np, sin_np = _rope_tables(W, hd, cfg.rope_theta)
        cos_w = torch.from_numpy(cos_np).to(device=dev, dtype=cdt)
        sin_w = torch.from_numpy(sin_np).to(device=dev, dtype=cdt)
        rep = H // KV
        swin = cfg.sliding_window or 0
        cols = torch.arange(W, device=dev)

        def mm(h, name):
            q = p.get(name + ".weight#q")
            if q is None:
                return F.linear(h, p[name + ".weight"], p.get(name + ".bias"))
            y = F.linear(h, q.to(cdt)) * p[name + ".weight#s"]
            b = p.get(name + ".bias")
            return y if b is None else y + b

        def head(x):
            if "head#q" in p:
                return (x @ p["head#q"].T.to(cdt)) * p["head#s"]
            if cfg.tie_word_embeddings:
                return x @ emb.T
            return mm(x, "lm_head")

        def rms(x, name):
            w = p[name + ".weight"]
            var = (x * x).mean(-1, keepdim=True)
            return x * torch.rsqrt(var + eps) * (w + off if off else w)

        def act(g):
            if gelu_act:
                return 0.5 * g * (1 + torch.tanh(
                    0.7978845608028654 * (g + 0.044715 * g ** 3)))
            return F.silu(g)

        def rope(x, c, s_):
            x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
            return x * c + torch.cat([-x2, x1], dim=-1) * s_

        def embed(toks):
            x = emb[toks]
            return x * emb_scale if emb_scale is not None else x

        def route(h2, pre):
            """(gates (n, k) in the compute dtype, expert ids (n, k)) of
            rows ``h2 (n, d)``."""
            rl = h2 @ p[pre + "block_sparse_moe.router.weight"].T
            gates, ids = topk_gates(torch.softmax(rl.float(), -1), topk)
            return gates.to(cdt), ids

        def experts(h2, pre, keep=None):
            """Rows ``h2 (n, d)``: every expert over every row, the (E, d,
            ff) stacks read in place by batched products, weighted by the
            gates (zero where the row did not choose the expert, and on
            every row ``keep (n,)`` leaves out)."""
            gates, ids = route(h2, pre)
            comb = torch.zeros((h2.shape[0], n_exp), device=dev,
                               dtype=cdt).scatter(-1, ids, gates)
            if keep is not None:
                comb = comb * keep[:, None].to(cdt)
            w1, w3, w2 = (p[pre + "block_sparse_moe." + w]
                          for w in ("w1", "w3", "w2"))
            y = (act(h2 @ w1) * (h2 @ w3)) @ w2                 # (E, n, d)
            return (y * comb.T[:, :, None]).sum(0)

        def mlp(x, pre, keep=None):
            h2 = rms(x, pre + "post_attention_layernorm")
            if n_exp:
                return experts(h2, pre, keep)
            return mm(act(mm(h2, pre + "mlp.gate_proj"))
                      * mm(h2, pre + "mlp.up_proj"), pre + "mlp.down_proj")

        def qkv(x, pre):
            h = rms(x, pre + "input_layernorm")
            return (mm(h, pre + "self_attn.q_proj"),
                    mm(h, pre + "self_attn.k_proj"),
                    mm(h, pre + "self_attn.v_proj"))

        def visible(pos):
            """Keys ``<= pos`` (and inside the band) of each position in
            ``pos`` (a host int or a device tensor (n,)): (n, W) bool."""
            if isinstance(pos, torch.Tensor):
                pos = pos.reshape(-1, 1)
            ok = cols[None] <= pos
            return ok & (cols[None] > pos - swin) if swin else ok

        def attend_int8(q, kq, ks, vq, vs, pos):
            """Decode attention over an int8 cache in plain PyTorch, as the
            JAX package dequantizes inside its products: q (n, KV, rep,
            hd); kq / vq (n, KV, W, hd) int8 rows, ks / vs (n, KV, W, 1)
            their scales; the K scale on the score column, the V scale on
            the probabilities.  Returns (n, H hd) in the compute dtype."""
            s3 = torch.einsum("nkgd,nksd->nkgs", q.float(), kq.float()) \
                * scale * ks[..., 0][:, :, None, :]
            s3 = s3.masked_fill(~visible(pos)[:, None, None, :], -1e30)
            pr = torch.softmax(s3, -1) * vs[..., 0][:, :, None, :]
            att = torch.einsum("nkgs,nksd->nkgd", pr, vq.float())
            return att.to(cdt).reshape(q.shape[0], H * hd)

        def init_cache():
            if kv_quant:
                return (torch.zeros((L, 2, KV, W, hd), device=dev,
                                    dtype=torch.int8),
                        torch.zeros((L, 2, KV, W, 1), device=dev,
                                    dtype=torch.float32))
            return torch.zeros((L, 2, KV, W, hd), device=dev, dtype=cdt)

        def prefill(p, cache, toks, n_real, routed=None):
            """The prompt padded to the window in ONE parallel pass under the
            causal (and banded) mask; writes all W K/V rows (quantized on
            write into an int8 cache, while the pass itself attends them at
            full precision).  Pad rows beyond ``n_real`` hold garbage K/V
            that decode steps overwrite before the ``<= pos`` mask ever
            exposes them.

            With experts, the JAX package scans ``step`` over all W
            positions; here the routed FFN runs once over the first
            ``routed`` rows (every expert over every row, by the step's
            routing rule) with the gates of the pad rows among them
            zeroed, and the rows beyond skip it.  ``routed``, a static int
            >= ``n_real``, is by default :func:`moe_rows` of a host-int
            ``n_real``, the power of two at or above it, so that a
            compiled prefill, whose ``n_real`` is a device scalar, takes
            one graph a bucket of prompt lengths.  The K/V rows at every
            valid position and the last logits are the scan's: over an
            int8 cache the pass attends the rows dequantized in float32,
            as each step of the scan attends the cache it wrote."""
            x = embed(toks)                                    # (W, d)
            if n_exp:
                routed = routed or (W if isinstance(n_real, torch.Tensor)
                                    else moe_rows(n_real, W))
                keep = cols[:routed] < n_real
            for l in range(L):
                pre = f"layers.{l}."
                q, k, v = qkv(x, pre)
                c, s_ = cos_w[None], sin_w[None]
                q = rope(q.reshape(W, H, hd).transpose(0, 1), c, s_)
                k = rope(k.reshape(W, KV, hd).transpose(0, 1), c, s_)
                v = v.reshape(W, KV, hd).transpose(0, 1)
                if kv_quant:
                    rows, scales = quantize_rows(torch.stack([k, v]))
                    cache[0][l], cache[1][l] = rows, scales
                    if n_exp:
                        # the scan of steps attends the int8 rows it wrote
                        k, v = rows.float() * scales
                        q = q.float()
                    k, v = k.contiguous(), v.contiguous()
                else:
                    cache[l, 0], cache[l, 1] = k, v
                    k, v = cache[l, 0], cache[l, 1]
                # GQA inside the kernel: query head h reads KV head h // rep
                att = attention_fwd(q.contiguous(), k, v, scale, causal=True,
                                    window=swin).to(cdt)
                x = x + mm(att.transpose(0, 1).reshape(W, H * hd),
                           pre + "self_attn.o_proj")
                if n_exp and routed < W:
                    x = torch.cat([x[:routed] + mlp(x[:routed], pre, keep),
                                   x[routed:]])
                else:
                    x = x + mlp(x, pre, keep if n_exp else None)
            x = rms(last_row(x, n_real), "norm")
            return cache, head(x)[0]

        def step(p, cache, pos, tok):
            """One token at position ``pos`` (a host int, or an int32 scalar
            on the model's device, never read to the host): returns (cache,
            logits).  A device position and token index as one-element
            tensors (a 0-d tensor index would be read to the host)."""
            if isinstance(tok, torch.Tensor):
                x = embed(tok.reshape(1))                       # (1, d)
            else:
                x = embed(tok)[None]
            if isinstance(pos, torch.Tensor):
                # int64 once: each index_copy_ would convert an int32 index
                at = pos.reshape(1).long()
                c, s_ = (t.index_select(0, at)[None] for t in (cos_w, sin_w))

                def put(t, l, rows):
                    t[l].index_copy_(2, at, rows)
            else:
                c, s_ = cos_w[pos:pos + 1][None], sin_w[pos:pos + 1][None]

                def put(t, l, rows):
                    t[l, :, :, pos:pos + 1] = rows
            for l in range(L):
                pre = f"layers.{l}."
                q, k, v = qkv(x, pre)
                q = rope(q.reshape(H, 1, hd), c, s_)
                kv = torch.stack([rope(k.reshape(KV, 1, hd), c, s_),
                                  v.reshape(KV, 1, hd)])    # (2, KV, 1, hd)
                if kv_quant:
                    for t, r in zip(cache, quantize_rows(kv)):
                        put(t, l, r)
                    cq, cs = cache
                    att = attend_int8(q.reshape(1, KV, rep, hd), cq[l, 0][None],
                                      cs[l, 0][None], cq[l, 1][None],
                                      cs[l, 1][None], pos)
                else:
                    put(cache, l, kv)
                    # grouped-query decode attention: the rep query heads of
                    # each KV head in one block, no repeated K/V
                    att = decode_attention(
                        q.reshape(KV, rep, hd), cache[l, 0], cache[l, 1], pos,
                        scale, window=swin).reshape(1, H * hd)
                x = x + mm(att, pre + "self_attn.o_proj")
                x = x + mlp(x, pre)
            return cache, head(rms(x, "norm"))[0]

        def step_batch(p, caches, poss, toks):
            """B independent slots, one token each: caches (B, L, 2, KV, W,
            hd) (or the pair of int8 rows and (B, L, 2, KV, W, 1) scales),
            poss (B,) int32 and toks (B,) on the model's device.  One pass
            over all slots, as the JAX package's ``jax.vmap`` of ``step``:
            the B rows through each product, RoPE gathered at poss, each
            slot's K/V row written by one device-indexed scatter, and one
            batched decode-attention launch a layer over a float cache.
            Positions past the window clamp for the gathers and the
            scatter, as the JAX package's do; the attention takes them as
            they are, as its kernel does (keys ``<= pos``, clamped to W)."""
            B = toks.shape[0]
            pc = poss.long().clamp(max=W - 1)
            x = embed(toks)                                      # (B, d)
            c, s_ = cos_w[pc][:, None], sin_w[pc][:, None]       # (B, 1, hd)
            slots = torch.arange(B, device=x.device)
            for l in range(L):
                pre = f"layers.{l}."
                q, k, v = qkv(x, pre)
                q = rope(q.reshape(B, H, hd), c, s_)
                kv = torch.stack([rope(k.reshape(B, KV, hd), c, s_),
                                  v.reshape(B, KV, hd)], 1)  # (B, 2, KV, hd)
                if kv_quant:
                    cq, cs = caches
                    cq[:, l][slots, :, :, pc], cs[:, l][slots, :, :, pc] = \
                        quantize_rows(kv)
                    att = attend_int8(q.reshape(B, KV, rep, hd), cq[:, l, 0],
                                      cs[:, l, 0], cq[:, l, 1], cs[:, l, 1],
                                      poss)
                else:
                    caches[:, l][slots, :, :, pc] = kv
                    att = decode_attention_batch(
                        q.reshape(B, KV, rep, hd), caches[:, l, 0],
                        caches[:, l, 1], poss, scale,
                        window=swin).reshape(B, H * hd)
                x = x + mm(att, pre + "self_attn.o_proj")
                x = x + mlp(x, pre)
            return caches, head(rms(x, "norm"))

        # compiled, but over sharded parameters (decided here, once); with
        # experts the prefill's routed rows are a static bucket
        kw = dict(compiled=not any(is_sharded(t) for t in p.values()))
        buckets = (lambda cache, toks, n_real: (moe_rows(n_real, W),)) \
            if n_exp else None
        return KVFns(init_cache, ParamFn(prefill, p, static_of=buckets, **kw),
                     ParamFn(step, p, **kw), None,
                     ParamFn(step_batch, p, **kw))

    @torch.no_grad()
    def _generate_kv(self, ids, max_new_tokens, temperature, rng,
                     top_k: int = 0, top_p: float = 0.0):
        from .gpt import _sample

        W = self.cfg.max_position_embeddings
        assert len(ids) + max_new_tokens <= W, (
            f"KV-cache decode needs prompt+new <= max_position_embeddings "
            f"({len(ids)}+{max_new_tokens} > {W}); use use_cache=False")
        fns = _kv(self)
        _, prefill, step = fns
        # the cache kept for the signature: the compiled functions replay
        # at its address
        cache = cache_slot(_stack(fns, "generate", 1), 0)
        dev = self.embed_tokens.weight.device
        toks = torch.zeros(W, dtype=torch.long)
        toks[:len(ids)] = torch.as_tensor(ids, dtype=torch.long)
        cache, logits = prefill(cache, toks.to(dev), len(ids))
        out = list(ids)
        out.append(_sample(logits.float().cpu().numpy(), temperature, rng,
                           top_k=top_k, top_p=top_p))
        for _ in range(max_new_tokens - 1):
            cache, logits = step(cache, len(out) - 1, out[-1])
            out.append(_sample(logits.float().cpu().numpy(), temperature, rng,
                               top_k=top_k, top_p=top_p))
        return out

    def generate_device(self, ids, max_new_tokens: int = 20,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 0.0, eos_id: int = None,
                        seed: int = 0):
        """Whole-generation decoding on the device (models/decoding.py:
        generate_device): one readback a generation."""
        from .decoding import generate_device

        return generate_device(self, list(ids), max_new_tokens,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p, eos_id=eos_id, seed=seed)

    def generate_batch_device(self, prompts, max_new_tokens: int = 20,
                              temperature: float = 0.0, top_k: int = 0,
                              top_p: float = 0.0, eos_id: int = None,
                              seed: int = 0):
        """Batched whole-generation decoding on the device: one
        ``step_batch`` a round for all prompts."""
        from .decoding import generate_batch_device

        return generate_batch_device(self, prompts, max_new_tokens,
                                     temperature=temperature, top_k=top_k,
                                     top_p=top_p, eos_id=eos_id, seed=seed)

    def generate_batch(self, prompts, max_new_tokens: int = 20,
                       temperature: float = 0.0,
                       rng: np.random.Generator = None, top_k: int = 0,
                       top_p: float = 0.0, eos_id: int = None):
        """B ragged prompts decode together (models/decoding.py): one
        prefill a prompt, then one ``step_batch`` a round."""
        from .decoding import generate_batch

        return generate_batch(self, prompts, max_new_tokens,
                              temperature=temperature, rng=rng, top_k=top_k,
                              top_p=top_p, eos_id=eos_id)

    def quantize_serving(self, enable: bool = True):
        """int8 weight-only decoding: every 2-D projection of the decode
        functions but the embedding and the router becomes int8 with a
        scale an output channel (a tied head its own int8 copy); expert
        stacks stay float.  The weights are quantized when the decode
        functions are next built.  Composes with :meth:`quantize_kv`."""
        self._serve_quant = bool(enable)
        self.__dict__.pop("_kv_fns", None)
        return self

    def quantize_kv(self, enable: bool = True):
        """int8 KV cache: rows quantized on write with an f32 scale a row,
        dequantized inside the score and context products.  The decode
        functions are rebuilt at their next use."""
        self._kv_quant = bool(enable)
        self.__dict__.pop("_kv_fns", None)
        return self

    # --- HF interop --------------------------------------------------------
    @staticmethod
    def remap_hf_state(state: dict) -> dict:
        """An HF LLaMA / Mistral / Mixtral state (numpy arrays or torch
        tensors) under this model's names: the ``model.`` prefix dropped,
        rotary ``inv_freq`` buffers skipped (recomputed), Mixtral's
        per-expert ``(out, in)`` Linears stacked into ``nn.MoE``'s
        ``(E, in, out)`` tensors and its ``gate`` renamed ``router``."""
        out, experts = {}, {}
        for name, arr in state.items():
            name = name.removeprefix("model.")
            if name.endswith(".rotary_emb.inv_freq"):
                continue
            m = re.match(r"(layers\.\d+\.block_sparse_moe)\.experts\.(\d+)"
                         r"\.(w[123])\.weight$", name)
            if m:
                experts.setdefault((m.group(1), m.group(3)), {})[
                    int(m.group(2))] = arr.T
                continue
            name = name.replace(".block_sparse_moe.gate.weight",
                                ".block_sparse_moe.router.weight")
            out[name] = arr
        for (prefix, which), by_idx in experts.items():
            mats = [by_idx[i] for i in range(len(by_idx))]
            out[f"{prefix}.{which}"] = (
                torch.stack(mats) if isinstance(mats[0], torch.Tensor)
                else np.stack(mats))
        return out

    @staticmethod
    def _hf_name(name: str) -> str:
        return name if name.startswith("lm_head.") else "model." + name

    def export_hf_state(self) -> dict:
        """``state_dict()`` under HF's names (numpy arrays)."""
        return {self._hf_name(n): a for n, a in self.state_dict().items()}

    @staticmethod
    def from_pretrained(name: str):
        """(model, config) of an HF repository's ``config.json`` and
        ``pytorch_model.bin``, through :func:`utils.fetch` (which reads a
        file named md5(url) from ``LIGHTGRAD_CACHE`` before the network)."""
        from ..utils import fetch

        url = f"https://huggingface.co/{name}/resolve/main/"
        cfg = LlamaConfig(**json.loads(fetch(url + "config.json")))
        model = Llama(cfg)
        state = torch.load(io.BytesIO(fetch(url + "pytorch_model.bin")),
                           map_location="cpu", weights_only=True)
        model.load_parameters(Llama.remap_hf_state(state))
        return model, cfg

    def save_pretrained(self, directory: str) -> str:
        """Write ``pytorch_model.bin`` (``torch.save`` of the parameters
        under HF's names, in their dtype) and the JAX package's
        ``config.json`` into ``directory``; returns the weights' path."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "pytorch_model.bin")
        torch.save({self._hf_name(n): t.detach().cpu().contiguous()
                    for n, t in layer_tensors(self).items()}, path)
        c = self.cfg
        cfg = {
            "model_type": "llama",
            "vocab_size": c.vocab_size,
            "hidden_size": c.hidden_size,
            "intermediate_size": c.intermediate_size,
            "num_hidden_layers": c.num_hidden_layers,
            "num_attention_heads": c.num_attention_heads,
            "num_key_value_heads": c.num_key_value_heads,
            "max_position_embeddings": c.max_position_embeddings,
            "rms_norm_eps": c.rms_norm_eps,
            "rope_theta": c.rope_theta,
            "tie_word_embeddings": c.tie_word_embeddings,
        }
        if c.sliding_window:
            cfg["model_type"] = "mistral"
            cfg["sliding_window"] = c.sliding_window
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)
        return path


class LlamaTokenizer:
    """LLaMA's tokenizer over a SentencePiece ``tokenizer.model``, read by
    the port's :mod:`utils.sentencepiece` (no ``sentencepiece`` install).
    ``encode`` adds the BOS id as the HF tokenizer does; ``decode`` drops
    the BOS and EOS ids."""

    def __init__(self, sp, bos_id: int = 1, eos_id: int = 2):
        self.sp = sp
        self.bos_id, self.eos_id = bos_id, eos_id

    @property
    def vocab_size(self):
        return len(self.sp)

    @classmethod
    def from_file(cls, path: str):
        from ..utils.sentencepiece import SentencePieceModel

        return cls(SentencePieceModel.from_file(path))

    @classmethod
    def from_pretrained(cls, name: str):
        from ..utils import fetch
        from ..utils.sentencepiece import SentencePieceModel

        url = f"https://huggingface.co/{name}/resolve/main/tokenizer.model"
        return cls(SentencePieceModel.from_bytes(fetch(url)))

    def encode(self, text: str, bos: bool = True):
        ids = self.sp.encode(text)
        return [self.bos_id] + ids if bos else ids

    def decode(self, ids):
        return self.sp.decode([i for i in ids
                               if i not in (self.bos_id, self.eos_id)])
