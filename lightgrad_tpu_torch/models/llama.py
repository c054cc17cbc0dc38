"""The LLaMA family on the lightgrad tape: RoPE, RMSNorm, SwiGLU / GELU,
grouped-query attention and Mistral's sliding window.

Counterpart of ``lightgrad_tpu/models/llama.py``, with its class, function
and parameter names: one config covers LLaMA, Mistral (``sliding_window``),
Qwen2 (``attention_bias``) and Gemma (``head_dim``, ``hidden_act="gelu"``,
``rms_offset``, ``scale_embeddings``, tied embeddings).  Every op of the
training forward runs on the tape's ``CudaTensor``s and so on the port's
kernels: the products through the matmul kernel, RoPE, RMSNorm, SiLU / GELU
and the residual adds through the elementwise and reduce kernels, and
self-attention through the flash kernels -- grouped-query and banded by the
window inside the kernels, in both directions.

Serving (:meth:`Llama._kv_functions`) is plain PyTorch over the parameters'
tensors, as it was plain XLA in the JAX package, except for its two kernels:
prefill's causal (and banded) attention through the flash forward, and each
decode step's attention through the decode-attention kernel -- one launch
for all slots in ``step_batch``, which runs the B slots as one batch (the
JAX package's ``jax.vmap`` of ``step``), positions kept on the device.

Not ported yet (ROADMAP queue 1): Mixtral's mixture of experts, int8
``quantize_serving`` / ``quantize_kv``, ``scan_layers`` / ``remat``, the
sequence-parallel ring branch, the HF interop and the SentencePiece
tokenizer.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..autograd import Tensor, no_grad
from ..ops.attention import attention_fwd
from ..ops.decode_attention import decode_attention, decode_attention_batch
from .decoding import KVFns, ParamFn

__all__ = ["LlamaConfig", "Llama", "RMSNorm"]


class LlamaConfig:
    """The JAX package's config.  Mixtral's experts and the scanned stack
    are accepted as fields but not ported: setting them raises."""

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
        if num_local_experts:
            raise NotImplementedError(
                "LlamaConfig: num_local_experts (Mixtral's MoE) is not "
                "ported yet (ROADMAP.md queue 1 item 3)")
        if scan_layers or remat:
            raise NotImplementedError(
                "LlamaConfig: scan_layers / remat are not ported yet "
                "(ROADMAP.md queue 1 item 5)")
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
        self.num_local_experts = 0
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
        if getattr(self, "_sequence_parallel", None) is not None:
            raise NotImplementedError(
                "LlamaAttention: the sequence-parallel ring branch is not "
                "ported yet (ROADMAP.md queue 1 item 7)")
        if hasattr(q, "attention"):
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
        self.mlp = LlamaMLP(cfg)

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class Llama(nn.Module):
    """Causal LM with a separate (or tied) LM head.  Initialised as the JAX
    model: Linear weights uniform in +-1/sqrt(fan_in), the embedding
    ``xavier``, RMSNorm weights ones, from ``lightgrad_tpu_torch.random``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(*[LlamaLayer(cfg)
                                      for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                            offset=1.0 if cfg.rms_offset else 0.0)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False)

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        if self.cfg.scale_embeddings:
            x = x * float(self.cfg.hidden_size ** 0.5)
        for layer in self.layers:
            x = layer(x)
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
        from the last real position).  ``num_beams > 1``: beam search over
        the cached step (models/decoding.py)."""
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
        window = self.cfg.max_position_embeddings
        for _ in range(max_new_tokens):
            ctx = ids[-window:]
            padded = ctx + [0] * (window - len(ctx))
            x = Tensor.from_numpy(np.array([padded], dtype=np.int32),
                                  requires_grad=False)
            logits = self.forward(x)[0, len(ctx) - 1].numpy()
            ids.append(_sample(logits, temperature, rng, top_k=top_k,
                               top_p=top_p))
        return ids

    def _kv_functions(self):
        """KVFns(init_cache, prefill, step, None, step_batch) over the
        parameters' tensors.  The cache is one tensor ``(L, 2, KV, W, hd)``
        in the parameters' dtype; the functions write new K/V rows into it
        IN PLACE (the JAX package returned a new array) and return it."""
        cfg = self.cfg
        H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        L, W = cfg.num_hidden_layers, cfg.max_position_embeddings
        eps = cfg.rms_norm_eps
        off = 1.0 if cfg.rms_offset else 0.0
        gelu_act = cfg.hidden_act in ("gelu", "gelu_pytorch_tanh")
        p = {name: t.data for name, t in self.named_parameters()}
        scale = float(1.0 / np.sqrt(hd))
        emb = p["embed_tokens.weight"]
        cdt, dev = emb.dtype, emb.device
        # in the compute dtype, as the JAX package casts it
        emb_scale = (torch.tensor(cfg.hidden_size ** 0.5, dtype=cdt,
                                  device=dev) if cfg.scale_embeddings
                     else None)
        cos_np, sin_np = _rope_tables(W, hd, cfg.rope_theta)
        cos_w = torch.from_numpy(cos_np).to(device=dev, dtype=cdt)
        sin_w = torch.from_numpy(sin_np).to(device=dev, dtype=cdt)
        rep = H // KV
        swin = cfg.sliding_window or 0

        def mm(h, name):
            return F.linear(h, p[name + ".weight"], p.get(name + ".bias"))

        def head(x):
            if cfg.tie_word_embeddings:
                return x @ emb.T
            return x @ p["lm_head.weight"].T

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

        def mlp(x, pre):
            h2 = rms(x, pre + "post_attention_layernorm")
            return mm(act(mm(h2, pre + "mlp.gate_proj"))
                      * mm(h2, pre + "mlp.up_proj"), pre + "mlp.down_proj")

        def qkv(x, pre):
            h = rms(x, pre + "input_layernorm")
            return (mm(h, pre + "self_attn.q_proj"),
                    mm(h, pre + "self_attn.k_proj"),
                    mm(h, pre + "self_attn.v_proj"))

        def init_cache():
            return torch.zeros((L, 2, KV, W, hd), device=dev, dtype=cdt)

        def prefill(p, cache, toks, n_real):
            """The prompt padded to the window in ONE parallel pass under the
            causal (and banded) mask; writes all W K/V rows.  Pad rows beyond
            ``n_real`` hold garbage K/V that decode steps overwrite before
            the ``<= pos`` mask ever exposes them."""
            x = embed(toks)                                    # (W, d)
            for l in range(L):
                pre = f"layers.{l}."
                q, k, v = qkv(x, pre)
                c, s_ = cos_w[None], sin_w[None]
                q = rope(q.reshape(W, H, hd).transpose(0, 1), c, s_)
                k = rope(k.reshape(W, KV, hd).transpose(0, 1), c, s_)
                v = v.reshape(W, KV, hd).transpose(0, 1)
                cache[l, 0], cache[l, 1] = k, v
                # GQA inside the kernel: query head h reads KV head h // rep
                att = attention_fwd(q.contiguous(), cache[l, 0], cache[l, 1],
                                    scale, causal=True, window=swin)
                x = x + mm(att.transpose(0, 1).reshape(W, H * hd),
                           pre + "self_attn.o_proj")
                x = x + mlp(x, pre)
            x = rms(x[n_real - 1][None], "norm")
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

                def put(l, j, rows):
                    cache[l, j].index_copy_(1, at, rows)
            else:
                c, s_ = cos_w[pos:pos + 1][None], sin_w[pos:pos + 1][None]

                def put(l, j, rows):
                    cache[l, j, :, pos:pos + 1] = rows
            for l in range(L):
                pre = f"layers.{l}."
                q, k, v = qkv(x, pre)
                q = rope(q.reshape(H, 1, hd), c, s_)
                put(l, 0, rope(k.reshape(KV, 1, hd), c, s_))
                put(l, 1, v.reshape(KV, 1, hd))
                # grouped-query decode attention: the rep query heads of
                # each KV head in one block, no repeated K/V
                att = decode_attention(q.reshape(KV, rep, hd), cache[l, 0],
                                       cache[l, 1], pos, scale, window=swin)
                x = x + mm(att.reshape(1, H * hd), pre + "self_attn.o_proj")
                x = x + mlp(x, pre)
            return cache, head(rms(x, "norm"))[0]

        def step_batch(p, caches, poss, toks):
            """B independent slots, one token each: caches (B, L, 2, KV, W,
            hd), poss (B,) int32 and toks (B,) on the model's device.  One
            pass over all slots, as the JAX package's ``jax.vmap`` of
            ``step``: the B rows through each product, RoPE gathered at
            poss, each slot's K/V row written by one device-indexed scatter,
            and one batched decode-attention launch a layer.  Positions past
            the window clamp for the gathers and the scatter, as the JAX
            package's do; the attention takes them as they are, as its
            kernel does (keys ``<= pos``, clamped to W)."""
            B = toks.shape[0]
            pc = poss.long().clamp(max=W - 1)
            x = embed(toks)                                      # (B, d)
            c, s_ = cos_w[pc][:, None], sin_w[pc][:, None]       # (B, 1, hd)
            slots = torch.arange(B, device=x.device)
            for l in range(L):
                pre = f"layers.{l}."
                q, k, v = qkv(x, pre)
                q = rope(q.reshape(B, H, hd), c, s_)
                k = rope(k.reshape(B, KV, hd), c, s_)
                caches[:, l][slots, :, :, pc] = torch.stack(
                    [k, v.reshape(B, KV, hd)], 1)
                att = decode_attention_batch(
                    q.reshape(B, KV, rep, hd), caches[:, l, 0],
                    caches[:, l, 1], poss, scale, window=swin)
                x = x + mm(att.reshape(B, H * hd), pre + "self_attn.o_proj")
                x = x + mlp(x, pre)
            return caches, head(rms(x, "norm"))

        return KVFns(init_cache, ParamFn(prefill, p), ParamFn(step, p),
                     None, ParamFn(step_batch, p))

    @torch.no_grad()
    def _generate_kv(self, ids, max_new_tokens, temperature, rng,
                     top_k: int = 0, top_p: float = 0.0):
        from .gpt import _sample

        W = self.cfg.max_position_embeddings
        assert len(ids) + max_new_tokens <= W, (
            f"KV-cache decode needs prompt+new <= max_position_embeddings "
            f"({len(ids)}+{max_new_tokens} > {W}); use use_cache=False")
        if not hasattr(self, "_kv_fns"):
            self._kv_fns = self._kv_functions()
        init_cache, prefill, step = self._kv_fns
        cache = init_cache()
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
