"""BERT on the lightgrad tape: config, encoder, masked-LM head.

Counterpart of ``lightgrad_tpu/models/bert.py``, with its module and
parameter names (so ``remap_hf_state`` / ``export_hf_state`` carry over).
Every op runs on the tape's ``CudaTensor``s and so on the port's kernels:
each product through the matmul kernel, the elementwise passes (GELU, the
residual adds, the additive mask, the scaling) through the elementwise
kernel, sums through the reduce kernel, LayerNorm through the fused
LayerNorm kernels.  Self-attention has the JAX model's three branches:

* ``attention_mask`` given: the materialised branch, ``softmax(q k^T *
  scale + mask) v`` -- two products and the softmax kernel;
* neither mask nor lengths: the fused flash-attention kernels;
* ``attention_lengths``: the flash kernels with per-example lengths:
  padded keys are masked out of every softmax inside the kernel and padded
  query rows output zeros (no additive mask, no softmax kernel).

Not ported yet: ``scan_layers``/``remat`` (the ``scan`` slice), the
sequence-parallel ring branch (the parallel layer), ``from_pretrained``,
``save_pretrained`` and the WordPiece tokenizer (they need the checkpoint
and vocab files).
"""

import re

import numpy as np

from .. import nn
from ..autograd import Tensor

__all__ = ["BertConfig", "BertModel", "BertForMaskedLM"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12, **unused):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.layer_norm_eps = layer_norm_eps


class BertEmbedding(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids=None):
        b, s = input_ids.shape
        pos = Tensor.from_numpy(np.arange(s, dtype=np.int32),
                                requires_grad=False)
        if token_type_ids is None:
            # segment 0 everywhere (type embeddings always added)
            token_type_ids = Tensor.from_numpy(
                np.zeros((b, s), dtype=np.int32), requires_grad=False)
        e = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(e)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.n_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def _split(self, x, b, s):
        # (b, s, h) -> (b, heads, s, head_dim): a view, no copy
        return x.reshape(b, s, self.n_heads, self.head_dim) \
            .transpose(0, 2, 1, 3)

    def forward(self, x, mask=None, output_attentions: bool = False,
                lengths=None):
        """``output_attentions=True`` takes the materialised branch and also
        returns the softmax probabilities."""
        b, s, h = x.shape
        q = self._split(self.query(x), b, s)
        k = self._split(self.key(x), b, s)
        v = self._split(self.value(x), b, s)
        scale = 1.0 / np.sqrt(self.head_dim)
        if lengths is not None and not output_attentions:
            ctx = q.attention(k, v, scale=scale, lengths=lengths)
        elif mask is None and not output_attentions:
            ctx = q.attention(k, v, scale=scale)
        else:
            scores = (q @ k.transpose(0, 1, 3, 2)) * scale
            if mask is not None:
                # cast: an f32 mask would upcast a bf16 residual stream
                scores = scores + (mask.astype(scores.dtype)
                                   if mask.dtype != scores.dtype else mask)
            probs = scores.softmax(axis=-1)
            ctx = probs @ v
            if output_attentions:
                return ctx.transpose(0, 2, 1, 3).reshape(b, s, h), probs
        return ctx.transpose(0, 2, 1, 3).reshape(b, s, h)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, mask=None, lengths=None):
        return self.LayerNorm(
            self.dense(self.self(x, mask, lengths=lengths)) + x)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, mask=None, lengths=None):
        a = self.attention(x, mask, lengths=lengths)
        return self.LayerNorm(self.output(self.intermediate(a).gelu()) + a)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbedding(cfg)
        self.layer = nn.ModuleList(*[BertLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                attention_lengths=None):
        """``attention_mask`` (b, s) of {0, 1}: an additive -1e9 mask on the
        padded keys, through the materialised branch.
        ``attention_lengths``: right-padded per-example valid lengths,
        through the flash kernels.  Use one or the other."""
        mask = None
        if attention_mask is not None:
            if attention_lengths is not None:
                raise ValueError("pass attention_mask or attention_lengths, "
                                 "not both")
            mask = (1.0 - attention_mask.reshape(
                attention_mask.shape[0], 1, 1, attention_mask.shape[1])) \
                * -1e9
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.layer:
            x = layer(x, mask, lengths=attention_lengths)
        return x


class BertForMaskedLM(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.transform_ln = nn.LayerNorm(cfg.hidden_size,
                                         eps=cfg.layer_norm_eps)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                attention_lengths=None):
        x = self.bert(input_ids, attention_mask, token_type_ids,
                      attention_lengths=attention_lengths)
        x = self.transform_ln(self.transform(x).gelu())
        return self.decoder(x)

    # HF checkpoint name -> our parameter-tree name
    _RENAMES = [
        ("bert.encoder.layer.", "bert.layer."),
        ("cls.predictions.transform.dense.", "transform."),
        ("cls.predictions.transform.LayerNorm.", "transform_ln."),
        ("cls.predictions.decoder.", "decoder."),
    ]

    @staticmethod
    def remap_hf_state(state: dict) -> dict:
        """Translate a HuggingFace BERT state dict to our parameter names."""
        remapped = {}
        for hf_name, arr in state.items():
            name = hf_name
            for src, dst in BertForMaskedLM._RENAMES:
                if name.startswith(src):
                    name = dst + name[len(src):]
                    break
            name = name.replace(".attention.output.dense.",
                                ".attention.dense.")
            name = name.replace(".attention.output.LayerNorm.",
                                ".attention.LayerNorm.")
            name = name.replace(".intermediate.dense.", ".intermediate.")
            name = name.replace(".output.dense.", ".output.")
            name = name.replace(".output.LayerNorm.", ".LayerNorm.")
            remapped[name] = arr
        if "cls.predictions.bias" in state:
            remapped["decoder.bias"] = state["cls.predictions.bias"]
        # drop HF extras we don't model (pooler, NSP head, buffer tensors)
        return {k: v for k, v in remapped.items()
                if not k.startswith(("bert.pooler.", "cls."))
                and not k.endswith(".position_ids")}

    def export_hf_state(self) -> dict:
        """Our parameter tree -> HuggingFace BERT names (inverse of
        :meth:`remap_hf_state`)."""
        out = {}
        for name, arr in self.state_dict().items():
            hf = name
            hf = hf.replace(".attention.dense.", ".attention.output.dense.")
            hf = hf.replace(".attention.LayerNorm.",
                            ".attention.output.LayerNorm.")
            hf = hf.replace(".intermediate.", ".intermediate.dense.")
            hf = re.sub(r"(\.layer\.\d+)\.LayerNorm\.",
                        r"\1.output.LayerNorm.", hf)
            hf = re.sub(r"(\.layer\.\d+)\.output\.(weight|bias)$",
                        r"\1.output.dense.\2", hf)
            for src, dst in self._RENAMES:
                if hf.startswith(dst):
                    hf = src + hf[len(dst):]
                    break
            hf = hf.replace("bert.layer.", "bert.encoder.layer.")
            out[hf] = arr
        if "cls.predictions.decoder.bias" in out:
            out["cls.predictions.bias"] = out["cls.predictions.decoder.bias"]
        return out
