"""GPT-2 in PyTorch: the model, its training forward, KV-cache decoding and
generation.

Counterpart of ``lightgrad_tpu/models/gpt.py``: pre-LN GPT-2 (token +
position embeddings, causal self-attention, tanh-GELU MLP, weight-tied LM
head) as ``torch.nn.Module``s whose parameter names equal the JAX model's,
and the ``_kv_functions`` contract the serving engine drives.

The hand-written kernels on the training path (``GPT.forward`` under
``torch.autograd``): the fused LayerNorm forward and backward (ops/
layernorm.py, through models/_torch_layers.py) and the flash-attention
forward and backward (ops/attention.py, through autograd/ops.py).  On the
serving path: prefill's causal attention, the whole-stack decode kernel for
``step``, ``extend`` and ``step_batch`` (ops/decode_stack.py; its int8
instantiations under ``quantize_serving`` / ``quantize_kv``), and, when the
stack is not packed, the per-layer decode attention
(ops/decode_attention.py, float cache).  The serving path's LayerNorm,
GELU, the products outside the kernels (int8 ones included), the int8
cache's attention on the unrolled branch, the embedding gathers, the cache
scatters and sampling are plain PyTorch, as they were plain XLA in the JAX
package.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..autograd.ops import attention
from ._torch_layers import LayerNorm
from ..ops.attention import attention_fwd
from ..ops.decode_attention import decode_attention
from ..ops.decode_stack import (decode_stack, decode_stack_batch,
                                pack_gpt_stack, stack_supported)
from .decoding import KVFns, ParamFn, cache_slot

__all__ = ["GPTConfig", "GPT", "ByteTokenizer", "quantize_rows"]


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
    """The JAX package's config.  The mixture-of-experts and scanned-stack
    fields are accepted but not ported: setting them raises."""

    def __init__(self, vocab_size=50257, n_positions=1024, n_embd=768,
                 n_layer=12, n_head=12, layer_norm_epsilon=1e-5,
                 scan_layers=False, remat=False, n_experts=0, moe_every=1,
                 moe_k=2, moe_dispatch="topk", moe_hidden=None,
                 moe_capacity_factor=1.25, moe_shared=0, **unused):
        if n_experts or scan_layers or remat:
            raise NotImplementedError(
                "GPTConfig: n_experts / scan_layers / remat are not ported")
        self.vocab_size = vocab_size
        self.n_positions = n_positions
        self.n_embd = n_embd
        self.n_layer = n_layer
        self.n_head = n_head
        self.layer_norm_epsilon = layer_norm_epsilon


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.n_head = cfg.n_head
        self.head_dim = cfg.n_embd // cfg.n_head
        kw = {"device": device, "dtype": dtype}
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd, **kw)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd, **kw)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.c_attn(x).reshape(b, s, 3, self.n_head, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous()  # (b, heads, s, hd)
        y = attention(q, k, v, 1.0 / float(np.sqrt(self.head_dim)),
                      causal=True)
        return self.c_proj(y.transpose(1, 2).reshape(b, s, h))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln_1 = LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, **kw)
        self.attn = CausalSelfAttention(cfg, **kw)
        self.ln_2 = LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, **kw)
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, **kw)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.c_proj(_gelu(self.c_fc(self.ln_2(x))))


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
        self.h = nn.ModuleList(GPTBlock(cfg, **kw)
                               for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, **kw)
        self.to_empty(device=device)
        self._init_parameters(generator)

    @torch.no_grad()
    def _init_parameters(self, generator):
        gdev = generator.device if generator is not None else "cpu"
        for name, t in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if ".ln_" in name or name.startswith("ln_"):
                t.fill_(1.0 if leaf == "weight" else 0.0)
                continue
            if name.startswith(("wte.", "wpe.")):
                bound = 1.0 / float(np.sqrt(t.numel()))     # xavier
            else:
                fan_in = self.get_submodule(name.rsplit(".", 1)[0]).in_features
                bound = 1.0 / float(np.sqrt(fan_in))
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
        """Logits (b, s, vocab); differentiable (the training forward)."""
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)
        for block in self.h:
            x = block(x)
        x = self.ln_f(x)
        return x @ self.wte.weight.T        # weight-tied LM head

    @torch.no_grad()
    def generate(self, ids, max_new_tokens: int = 20, temperature: float = 0.0,
                 rng: np.random.Generator = None, use_cache: bool = True,
                 top_k: int = 0, top_p: float = 0.0, num_beams: int = 1,
                 eos_id: int = None, repetition_penalty: float = 1.0,
                 stream=None, length_penalty: float = 1.0):
        """Autoregressive decode; greedy when ``temperature=0``.

        ``use_cache=True``: one prefill of the prompt padded to the window,
        then one cached step per token.  ``use_cache=False``: full recompute
        of the right-padded window per token (under the causal mask the pad
        cannot reach the last real position).  ``num_beams > 1``: beam
        search over the cached step (models/decoding.py)."""
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
        for _ in range(max_new_tokens):
            ctx = ids[-window:]
            padded = torch.tensor([ctx + [0] * (window - len(ctx))],
                                  device=dev)
            logits = self.forward(padded)[0, len(ctx) - 1]
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
        other)."""
        cfg = self.cfg
        H, L, W = cfg.n_head, cfg.n_layer, cfg.n_positions
        d = cfg.n_embd
        hd = d // H
        eps = cfg.layer_norm_epsilon
        p = {name: t.detach() for name, t in self.named_parameters()}
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
            return cache, head(x[n_real - 1][None])[0]

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

        return KVFns(init_cache, ParamFn(prefill, p), ParamFn(step, p),
                     ParamFn(extend, p), ParamFn(step_batch, p))

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
        if not hasattr(self, "_kv_fns"):
            self._kv_fns = self._kv_functions()
        init_cache, prefill, step = self._kv_fns
        cache = init_cache()
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


class ByteTokenizer:
    """Offline fallback: raw UTF-8 bytes (vocab 256)."""

    vocab_size = 256

    def encode(self, text: str):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")
