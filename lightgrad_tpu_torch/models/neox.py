"""GPT-NeoX / Pythia family on the lightgrad tape: parallel-residual decoder
with partial RoPE.

Counterpart of ``lightgrad_tpu/models/neox.py``, with its class, function
and parameter names: biased LayerNorms, a fused per-head-packed QKV
projection, rotary embeddings on only the first ``rotary_pct`` of each
head's dims, exact (erf) GELU MLPs, and the parallel residual
``x + attn(ln1(x)) + mlp(ln2(x))`` (``use_parallel_residual=False`` gives
the serial variant).  Every op of the training forward runs on the tape's
``CudaTensor``s and so on the port's kernels: the products through the
matmul kernel, the LayerNorms through the LayerNorm kernels, RoPE, GELU and
the residual adds through the elementwise and reduce kernels, and causal
multi-head self-attention through the flash kernels -- the fused backward
after ``ops.set_flash_fused(True)``, at any head dim (Pythia-1B's 256,
Pythia-2.8B's 80).

HF checkpoint interop: parameter names mirror ``GPTNeoXForCausalLM`` minus
the ``gpt_neox.`` prefix (``remap_hf_state`` / ``export_hf_state``);
``from_pretrained`` reads an HF repository's ``config.json`` and
``pytorch_model.bin`` through ``utils.fetch``.
"""

import io
import json

import numpy as np
import torch

from .. import nn
from ..autograd import Tensor, no_grad
from .llama import _constant, _rope_tables

__all__ = ["NeoXConfig", "NeoX"]


class NeoXConfig:
    def __init__(self, vocab_size=50304, hidden_size=512,
                 intermediate_size=2048, num_hidden_layers=6,
                 num_attention_heads=8, max_position_embeddings=2048,
                 rotary_pct=0.25, rotary_emb_base=10000.0,
                 layer_norm_eps=1e-5, use_parallel_residual=True, **unused):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rotary_pct = rotary_pct
        self.rotary_emb_base = rotary_emb_base
        self.layer_norm_eps = layer_norm_eps
        self.use_parallel_residual = use_parallel_residual


def _apply_partial_rope(x, cos_t, sin_t, rot: int):
    """RoPE on the first ``rot`` dims of (b, h, s, hd); the rest pass
    through (NeoX convention)."""
    xr = x[..., :rot]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    rotated = (-x2).concat(x1, axis=-1)
    xr = xr * cos_t + rotated * sin_t
    if rot == x.shape[-1]:
        return xr
    return xr.concat(x[..., rot:], axis=-1)


class NeoXAttention(nn.Module):
    def __init__(self, cfg: NeoXConfig):
        super().__init__()
        self.n_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.rot = int(self.head_dim * cfg.rotary_pct)
        self.theta = cfg.rotary_emb_base
        h = cfg.hidden_size
        # fused QKV, PER-HEAD packed: rows are [q_h0, k_h0, v_h0, q_h1, ...]
        # (HF GPTNeoXAttention reshapes to (..., heads, 3*hd) then splits)
        self.query_key_value = nn.Linear(h, 3 * h)
        self.dense = nn.Linear(h, h)

    def forward(self, x):
        b, s, h = x.shape
        hd, H = self.head_dim, self.n_heads
        qkv = self.query_key_value(x).reshape(b, s, H, 3 * hd)
        qkv = qkv.transpose(0, 2, 1, 3)              # (b, H, s, 3hd)
        q = qkv[..., :hd]
        k = qkv[..., hd:2 * hd]
        v = qkv[..., 2 * hd:]

        cos_np, sin_np = _rope_tables(s, self.rot, self.theta)
        cos_t = _constant(cos_np[None, None], x)
        sin_t = _constant(sin_np[None, None], x)
        q = _apply_partial_rope(q, cos_t, sin_t, self.rot)
        k = _apply_partial_rope(k, cos_t, sin_t, self.rot)

        scale = 1.0 / np.sqrt(hd)
        if hasattr(q, "attention"):
            ctx = q.attention(k, v, scale=scale, causal=True)
        else:
            # a backend without a fused attention op: the raw scores, the
            # additive causal mask and the softmax
            scores = (q @ k.transpose(0, 1, 3, 2)) * scale
            mask = np.triu(np.full((s, s), -1e30, np.float32), k=1)
            scores = scores + _constant(mask, scores)
            ctx = scores.softmax(axis=-1) @ v
        return self.dense(ctx.transpose(0, 2, 1, 3).reshape(b, s, h))


class NeoXMLP(nn.Module):
    def __init__(self, cfg: NeoXConfig):
        super().__init__()
        self.dense_h_to_4h = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.dense_4h_to_h = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        # exact erf GELU (HF "gelu"), as Pythia was trained
        return self.dense_4h_to_h(self.dense_h_to_4h(x).gelu_exact())


class NeoXLayer(nn.Module):
    def __init__(self, cfg: NeoXConfig):
        super().__init__()
        self.input_layernorm = nn.LayerNorm(cfg.hidden_size,
                                            eps=cfg.layer_norm_eps)
        self.post_attention_layernorm = nn.LayerNorm(cfg.hidden_size,
                                                     eps=cfg.layer_norm_eps)
        self.attention = NeoXAttention(cfg)
        self.mlp = NeoXMLP(cfg)
        self.parallel = cfg.use_parallel_residual

    def forward(self, x):
        if self.parallel:
            # one residual add for both branches; the MLP reads the
            # post-attention norm of the original x
            return (x + self.attention(self.input_layernorm(x))
                    + self.mlp(self.post_attention_layernorm(x)))
        x = x + self.attention(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class NeoX(nn.Module):
    """GPT-NeoX causal LM (untied LM head, like Pythia).  Initialised as the
    JAX model: Linear weights uniform in +-1/sqrt(fan_in), the embedding
    ``xavier``, LayerNorms ones and zeros, from
    ``lightgrad_tpu_torch.random``."""

    def __init__(self, cfg: NeoXConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_in = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            *[NeoXLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)
        self.embed_out = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                   bias=False)

    def forward(self, input_ids):
        x = self.embed_in(input_ids)
        for layer in self.layers:
            x = layer(x)
        return self.embed_out(self.final_layer_norm(x))

    @no_grad()
    def generate(self, ids, max_new_tokens: int = 20,
                 temperature: float = 0.0, rng: np.random.Generator = None):
        """Fixed-window recompute decoding: a full forward of the
        right-padded window a token (the causal mask keeps the pad from the
        last real position); greedy when ``temperature=0``.  The forward is
        compiled once by ``jit``, as the JAX model's."""
        from .gpt import _sample
        from ..jit import jit

        ids = [int(t) for t in ids]
        rng = rng or np.random.default_rng(0)
        W = self.cfg.max_position_embeddings
        if not hasattr(self, "_decode_fn"):
            def _decode(x):
                with no_grad():
                    return self.forward(x)

            self._decode_fn = jit(_decode)
        for _ in range(max_new_tokens):
            ctx = ids[-W:]
            padded = ctx + [0] * (W - len(ctx))
            x = Tensor.from_numpy(np.array([padded], np.int32),
                                  requires_grad=False)
            logits = self._decode_fn(x)[0, len(ctx) - 1].numpy()
            ids.append(_sample(logits, temperature, rng))
        return ids

    # ---- HF checkpoint interop ------------------------------------------
    @staticmethod
    def remap_hf_state(state: dict) -> dict:
        out = {}
        for name, arr in state.items():
            name = name.removeprefix("gpt_neox.")
            if ("rotary_emb" in name or name.endswith(".attention.bias")
                    or name.endswith(".masked_bias")):
                continue  # recomputed / causal-mask buffers
            out[name] = arr
        return out

    def export_hf_state(self) -> dict:
        out = {}
        for name, arr in self.state_dict().items():
            hf = name if name.startswith("embed_out.") else "gpt_neox." + name
            out[hf] = arr
        return out

    @staticmethod
    def from_pretrained(name: str = "EleutherAI/pythia-70m"):
        """(model, config) of an HF repository's ``config.json`` and
        ``pytorch_model.bin``, through :func:`utils.fetch` (which reads a
        file named md5(url) from ``LIGHTGRAD_CACHE`` before the network),
        the weights by ``torch.load(weights_only=True)``."""
        from ..utils import fetch

        url = f"https://huggingface.co/{name}/resolve/main/"
        cfg = NeoXConfig(**json.loads(fetch(url + "config.json")))
        model = NeoX(cfg)
        state = torch.load(io.BytesIO(fetch(url + "pytorch_model.bin")),
                           map_location="cpu", weights_only=True)
        model.load_parameters(NeoX.remap_hf_state(state))
        return model, cfg
