"""T5 on the lightgrad tape: the encoder-decoder, its decoding and HF interop.

Counterpart of ``lightgrad_tpu/models/t5.py``, with its module and
parameter names, which are HuggingFace ``T5ForConditionalGeneration``'s
(``encoder.block.0.layer.0.SelfAttention.q.weight`` ...):

* ``T5LayerNorm`` is an RMS norm (no mean subtraction, no bias);
* attention scores are not scaled by 1/sqrt(d_kv) (T5 folds the scale into
  its initialisation);
* only the first self-attention layer of each stack owns a learned
  relative-position-bucket bias table; the later layers reuse its bias;
* cross-attention carries no position bias;
* a tied head rescales the decoder's output by d_model**-0.5.

Every op runs on the tape's ``CudaTensor``s and so on the port's kernels:
the products (``q k^T`` and ``p v`` batched) through the matmul kernel, the
residuals, the RMS scale, the bias and mask adds and the activations
through the elementwise kernel, the norm's mean and the bias's batch
gradient through the reduce kernel, and every attention's probabilities
through the softmax kernel: the relative-position bias is an additive score
term, which the flash kernels do not take.  The bias table's gradient is
the tape's gather backward, an accumulating scatter of the (q, k) bucket
rows into the table.

``_kv_functions`` / ``generate_compiled`` are plain PyTorch, as the JAX
package's are plain XLA: the decoder's self-attention cache is one stacked
``(L, 2, H, W, d_kv)`` tensor written at a device position, and each step
reads its bucket row from a device table; the host reads one logits row a
token, for :func:`~lightgrad_tpu_torch.models.gpt._sample`.

As in the JAX package, HF's dropout on the attention probabilities is left
out (the embedding, residual, FFN-inner and final dropouts are kept).
"""

import functools
import io
import json

import numpy as np
import torch

from .. import nn
from ..autograd import Tensor, no_grad
from ..ops.runtime import is_sharded
from .decoding import ParamFn, _same_weights, _weights
from .gpt import _sample

__all__ = ["T5Config", "T5ForConditionalGeneration"]

_NEG = -1e9  # the additive mask value, the JAX package's


class T5Config:
    def __init__(self, vocab_size=32128, d_model=512, d_kv=64, d_ff=2048,
                 num_layers=6, num_decoder_layers=None, num_heads=8,
                 relative_attention_num_buckets=32,
                 relative_attention_max_distance=128,
                 dropout_rate=0.1, layer_norm_epsilon=1e-6,
                 feed_forward_proj="relu", pad_token_id=0,
                 decoder_start_token_id=0, eos_token_id=1,
                 tie_word_embeddings=True, **unused):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.d_kv = d_kv
        self.d_ff = d_ff
        self.num_layers = num_layers
        self.num_decoder_layers = (num_decoder_layers if num_decoder_layers
                                   is not None else num_layers)
        self.num_heads = num_heads
        self.relative_attention_num_buckets = relative_attention_num_buckets
        self.relative_attention_max_distance = relative_attention_max_distance
        self.dropout_rate = dropout_rate
        self.layer_norm_epsilon = layer_norm_epsilon
        # "relu" (T5 v1.0: wi -> relu -> wo) or "gated-gelu" (v1.1 / flan:
        # gelu(wi_0) * wi_1 -> wo)
        self.feed_forward_proj = feed_forward_proj
        self.pad_token_id = pad_token_id
        self.decoder_start_token_id = decoder_start_token_id
        self.eos_token_id = eos_token_id
        self.tie_word_embeddings = tie_word_embeddings

    @property
    def is_gated_act(self):
        return "gated" in self.feed_forward_proj


class T5LayerNorm(nn.Module):
    """RMS norm: no mean subtraction, no bias (HF T5LayerNorm)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = Tensor.ones((dim,))
        self.eps = eps

    def forward(self, x):
        var = (x * x).mean(axis=-1, keepdims=True)
        return x * (var + self.eps) ** -0.5 * self.weight


def _relative_position_bucket(rel, bidirectional, num_buckets, max_distance):
    """HF T5Attention._relative_position_bucket on a numpy grid of relative
    positions (memory - query): exact buckets for small distances, then
    logarithmic ones (the log in float64) up to ``max_distance``."""
    rel = rel.astype(np.int64)
    buckets = np.zeros_like(rel)
    n = num_buckets
    if bidirectional:
        n //= 2
        buckets += (rel > 0).astype(np.int64) * n
        rel = np.abs(rel)
    else:
        rel = -np.minimum(rel, 0)
    max_exact = n // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
        / np.log(max_distance / max_exact) * (n - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, n - 1)
    buckets += np.where(is_small, rel, large)
    return buckets.astype(np.int32)


@functools.lru_cache(maxsize=256)
def _bucket_ids(q0, qlen, klen, causal, num_buckets, max_distance, device):
    """The (qlen, klen) bucket ids of query positions ``q0 ..
    q0 + qlen - 1`` against keys ``0 .. klen - 1``, as an int64 tensor on
    ``device``: one upload a shape, not one a forward."""
    rel = np.arange(klen)[None, :] - np.arange(q0, q0 + qlen)[:, None]
    b = _relative_position_bucket(rel, bidirectional=not causal,
                                  num_buckets=num_buckets,
                                  max_distance=max_distance)
    return torch.from_numpy(b.astype(np.int64)).to(device)


@functools.lru_cache(maxsize=64)
def _causal_mask(sq, sk, device):
    """(sq, sk) additive causal mask aligned to the last ``sq`` rows of the
    (sk, sk) triangle, float32 on ``device``."""
    cm = np.triu(np.full((sq, sk), _NEG, np.float32), k=1 + sk - sq)
    return torch.from_numpy(cm).to(device)


def _cast(t, like):
    return t.astype(like.dtype) if t.dtype != like.dtype else t


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool, causal: bool):
        super().__init__()
        self.n_heads = cfg.num_heads
        self.d_kv = cfg.d_kv
        self.causal = causal
        self.num_buckets = cfg.relative_attention_num_buckets
        self.max_distance = cfg.relative_attention_max_distance
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def _bias(self, q0: int, qlen: int, klen: int):
        """(1, heads, qlen, klen) bias of queries ``q0 ..``: the bucket ids
        gathered from the table through the tape's Embedding, so the table
        gets a gradient."""
        w = self.relative_attention_bias.weight
        ids = Tensor(_bucket_ids(q0, qlen, klen, self.causal,
                                 self.num_buckets, self.max_distance,
                                 w.data.device), requires_grad=False)
        emb = self.relative_attention_bias(ids)          # (q, k, heads)
        return emb.transpose(2, 0, 1).reshape(1, self.n_heads, qlen, klen)

    def compute_bias(self, qlen: int, klen: int):
        """(1, heads, qlen, klen) learned relative-position bias."""
        return self._bias(0, qlen, klen)

    def step_bias(self, klen: int):
        """(1, heads, 1, klen) bias for the newest query position (KV-cached
        decode: query index klen-1, keys 0..klen-1)."""
        return self._bias(klen - 1, 1, klen)

    def _split(self, x, b, s):
        return x.reshape(b, s, self.n_heads, self.d_kv).transpose(0, 2, 1, 3)

    def _attend(self, scores, v, b, sq):
        ctx = scores.softmax(axis=-1) @ v                # (b, h, sq, d_kv)
        return self.o(ctx.transpose(0, 2, 1, 3).reshape(
            b, sq, self.n_heads * self.d_kv))

    def decode_self(self, x, past, position_bias):
        """One-token causal self-attention against the (k, v) cache.
        ``x`` (b, 1, d); ``past`` None or (k, v), each (b, heads, t, d_kv).
        Returns (out, (k, v)) with the new token's rows appended."""
        b = x.shape[0]
        q = self._split(self.q(x), b, 1)
        k_new = self._split(self.k(x), b, 1)
        v_new = self._split(self.v(x), b, 1)
        k = k_new if past is None else past[0].concat(k_new, axis=2)
        v = v_new if past is None else past[1].concat(v_new, axis=2)
        scores = q @ k.transpose(0, 1, 3, 2)         # (b, h, 1, t+1)
        if position_bias is not None:
            scores = scores + _cast(position_bias, scores)
        return self._attend(scores, v, b, 1), (k, v)

    def cross_kv(self, enc):
        """The encoder-side (k, v), computed once a generation."""
        b, sk, _ = enc.shape
        return self._split(self.k(enc), b, sk), self._split(self.v(enc), b, sk)

    def decode_cross(self, x, kv, mask=None):
        """One-token cross-attention against the encoder's (k, v)."""
        b = x.shape[0]
        q = self._split(self.q(x), b, 1)
        k, v = kv
        scores = q @ k.transpose(0, 1, 3, 2)
        if mask is not None:
            scores = scores + _cast(mask, scores)
        return self._attend(scores, v, b, 1)

    def forward(self, x, kv=None, position_bias=None, mask=None):
        """Returns (context, position_bias): the bias is computed by the
        stack's first layer and threaded through the rest (HF's
        contract)."""
        b, sq, _ = x.shape
        kv = x if kv is None else kv
        sk = kv.shape[1]
        q = self._split(self.q(x), b, sq)
        k = self._split(self.k(kv), b, sk)
        v = self._split(self.v(kv), b, sk)
        scores = q @ k.transpose(0, 1, 3, 2)             # (b, h, sq, sk)
        if position_bias is None and hasattr(self, "relative_attention_bias"):
            position_bias = self.compute_bias(sq, sk)
        if position_bias is not None:
            scores = scores + _cast(position_bias, scores)
        if self.causal:
            cm = Tensor(_causal_mask(sq, sk, scores.data.device),
                        requires_grad=False)
            scores = scores + _cast(cm, scores)
        if mask is not None:
            scores = scores + _cast(mask, scores)
        return self._attend(scores, v, b, sq), position_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg, has_relative_bias, causal):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias, causal)
        self.layer_norm = T5LayerNorm(cfg.d_model, eps=cfg.layer_norm_epsilon)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x, position_bias=None, mask=None):
        att, pb = self.SelfAttention(self.layer_norm(x),
                                     position_bias=position_bias, mask=mask)
        return x + self.dropout(att), pb


class T5LayerCrossAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.EncDecAttention = T5Attention(cfg, has_relative_bias=False,
                                           causal=False)
        self.layer_norm = T5LayerNorm(cfg.d_model, eps=cfg.layer_norm_epsilon)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x, enc, mask=None):
        att, _ = self.EncDecAttention(self.layer_norm(x), kv=enc, mask=mask)
        return x + self.dropout(att)


class T5DenseFF(nn.Module):
    """wi -> relu -> wo (v1.0) or gelu(wi_0) * wi_1 -> wo (gated v1.1)."""

    def __init__(self, cfg):
        super().__init__()
        self.gated = cfg.is_gated_act
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x):
        h = (self.wi_0(x).gelu() * self.wi_1(x)) if self.gated \
            else self.wi(x).relu()
        return self.wo(self.dropout(h))


class T5LayerFF(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.DenseReluDense = T5DenseFF(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, eps=cfg.layer_norm_epsilon)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x):
        return x + self.dropout(self.DenseReluDense(self.layer_norm(x)))


class T5Block(nn.Module):
    def __init__(self, cfg, is_decoder: bool, has_relative_bias: bool):
        super().__init__()
        layers = [T5LayerSelfAttention(cfg, has_relative_bias,
                                       causal=is_decoder)]
        if is_decoder:
            layers.append(T5LayerCrossAttention(cfg))
        layers.append(T5LayerFF(cfg))
        self.layer = nn.ModuleList(*layers)
        self.is_decoder = is_decoder

    def forward(self, x, position_bias=None, mask=None, enc=None,
                enc_mask=None):
        x, pb = self.layer[0](x, position_bias=position_bias, mask=mask)
        if self.is_decoder:
            x = self.layer[1](x, enc, mask=enc_mask)
        return self.layer[-1](x), pb

    def decode(self, x, past, cross_kv, position_bias, enc_mask=None):
        """One-token decoder step against this block's caches."""
        sa = self.layer[0]
        att, present = sa.SelfAttention.decode_self(
            sa.layer_norm(x), past, position_bias)
        x = x + sa.dropout(att)
        ca = self.layer[1]
        x = x + ca.dropout(ca.EncDecAttention.decode_cross(
            ca.layer_norm(x), cross_kv, mask=enc_mask))
        return self.layer[-1](x), present


class T5Stack(nn.Module):
    def __init__(self, cfg, shared, is_decoder: bool):
        super().__init__()
        n = cfg.num_decoder_layers if is_decoder else cfg.num_layers
        self.block = nn.ModuleList(*[
            T5Block(cfg, is_decoder, has_relative_bias=(i == 0))
            for i in range(n)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model,
                                            eps=cfg.layer_norm_epsilon)
        self.dropout = nn.Dropout(cfg.dropout_rate)
        self.is_decoder = is_decoder
        # the shared embedding: referenced, not registered (it is the
        # parent's ``shared``; registering it here would list it twice in
        # named_parameters / state_dict)
        object.__setattr__(self, "embed_tokens", shared)

    def forward(self, ids, mask=None, enc=None, enc_mask=None):
        x = self.dropout(self.embed_tokens(ids))
        pb = None
        for block in self.block:
            x, pb = block(x, position_bias=pb, mask=mask, enc=enc,
                          enc_mask=enc_mask)
        return self.dropout(self.final_layer_norm(x))


class T5ForConditionalGeneration(nn.Module):
    """T5 text-to-text model: encoder + causal decoder + LM head."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg, self.shared, is_decoder=False)
        self.decoder = T5Stack(cfg, self.shared, is_decoder=True)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)

    @staticmethod
    def _pad_mask(attention_mask):
        """0/1 (b, sk) mask -> additive (b, 1, 1, sk) score term."""
        b, sk = attention_mask.shape
        return (attention_mask.astype("float32") * -_NEG + _NEG) \
            .reshape(b, 1, 1, sk)

    def encode(self, input_ids, attention_mask=None):
        mask = (self._pad_mask(attention_mask)
                if attention_mask is not None else None)
        return self.encoder(input_ids, mask=mask)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                encoder_outputs=None):
        enc_mask = (self._pad_mask(attention_mask)
                    if attention_mask is not None else None)
        enc = (encoder_outputs if encoder_outputs is not None
               else self.encoder(input_ids, mask=enc_mask))
        dec = self.decoder(decoder_input_ids, enc=enc, enc_mask=enc_mask)
        return self._lm_logits(dec)

    def shift_right(self, labels: np.ndarray) -> np.ndarray:
        """Teacher-forcing decoder inputs: labels shifted right, the start
        token prepended, -100 (ignored) positions replaced by pad."""
        out = np.full_like(labels, self.cfg.decoder_start_token_id)
        out[:, 1:] = labels[:, :-1]
        return np.where(out == -100, self.cfg.pad_token_id, out)

    def _lm_logits(self, dec):
        if self.cfg.tie_word_embeddings:
            dec = dec * (self.cfg.d_model ** -0.5)
            return dec @ self.shared.weight.T(1, 0)
        return self.lm_head(dec)

    def _decode_step(self, tok, pasts, cross_kvs, enc_mask):
        """One cached decoder step: (b, 1) token ids -> ((b, 1, vocab)
        logits, the updated self-attention caches)."""
        x = self.decoder.dropout(self.decoder.embed_tokens(tok))
        klen = 1 if pasts[0] is None else pasts[0][0].shape[2] + 1
        pb = self.decoder.block[0].layer[0].SelfAttention.step_bias(klen)
        presents = []
        for block, past, cross in zip(self.decoder.block, pasts, cross_kvs):
            x, present = block.decode(x, past, cross, pb, enc_mask=enc_mask)
            presents.append(present)
        x = self.decoder.dropout(self.decoder.final_layer_norm(x))
        return self._lm_logits(x), presents

    @staticmethod
    def _source(input_ids):
        """(tensor class, the ids as a tape tensor, the ids as numpy)."""
        if isinstance(input_ids, np.ndarray):
            return Tensor, Tensor.from_numpy(input_ids.astype(np.int32),
                                             requires_grad=False), input_ids
        return type(input_ids), input_ids, input_ids.numpy()

    def _encoded(self, x_ids, attention_mask):
        """(encoder states, additive mask or None, per-layer cross (k, v))."""
        enc = self.encode(x_ids, attention_mask=attention_mask)
        enc_mask = (self._pad_mask(attention_mask)
                    if attention_mask is not None else None)
        cross_kvs = [blk.layer[1].EncDecAttention.cross_kv(enc)
                     for blk in self.decoder.block]
        return enc, enc_mask, cross_kvs

    def beam_generate(self, input_ids, max_new_tokens: int = 20,
                      beam_size: int = 4, attention_mask=None,
                      length_penalty: float = 1.0):
        """Length-normalised beam search for ONE source sequence over the
        cached decode step; ``beam_size=1`` is greedy.  A beam's caches are
        tape tensors no op writes in place, so a beam copy is a reference
        copy.  The candidates of a beam are taken in the JAX package's
        order, ``np.argsort(lp)[::-1]``, so beams match it token for
        token."""
        T, x_ids, ids_np = self._source(input_ids)
        assert ids_np.shape[0] == 1, "beam_generate decodes one sequence"

        def lsm(x):
            x = np.asarray(x, np.float64)
            m = x.max()
            e = np.exp(x - m)
            return x - m - np.log(e.sum())

        def norm(score, n):
            return score / max(1, n) ** length_penalty

        with no_grad():
            _, enc_mask, cross_kvs = self._encoded(x_ids, attention_mask)
            # beam: (generated tokens, cumulative log-probability, pasts)
            beams = [([], 0.0, [None] * len(self.decoder.block))]
            done = []
            for _ in range(max_new_tokens):
                cands = []
                for toks, score, pasts in beams:
                    prev = toks[-1] if toks else self.cfg.decoder_start_token_id
                    tok = T.from_numpy(np.array([[prev]], np.int32),
                                       requires_grad=False)
                    logits, new_pasts = self._decode_step(
                        tok, pasts, cross_kvs, enc_mask)
                    lp = lsm(logits.numpy()[0, -1])
                    for t in np.argsort(lp)[::-1][:beam_size]:
                        cands.append((toks + [int(t)], score + float(lp[t]),
                                      new_pasts))
                cands.sort(key=lambda c: norm(c[1], len(c[0])), reverse=True)
                beams = []
                for toks, score, pasts in cands:
                    if toks[-1] == self.cfg.eos_token_id:
                        done.append((toks, score))
                    else:
                        beams.append((toks, score, pasts))
                    if len(beams) == beam_size:
                        break
                if not beams:
                    break
            done.extend((toks, score) for toks, score, _ in beams)
            best = max(done, key=lambda d: norm(d[1], len(d[0])))
        return np.array(best[0], np.int32)

    def generate(self, input_ids, max_new_tokens: int = 20,
                 attention_mask=None, temperature: float = 0.0,
                 rng: np.random.Generator = None, use_cache: bool = True):
        """Greedy (or temperature-sampled, from ``rng``) decoding; the
        encoder runs once.  ``use_cache=True`` decodes one token a step
        against per-block self-attention caches that grow by one row, the
        cross-attention (k, v) projected once; ``use_cache=False`` reruns
        the decoder over the grown prefix each step (the oracle).  Returns
        the (b, n) generated ids (the start token left out)."""
        T, x_ids, ids_np = self._source(input_ids)
        b = ids_np.shape[0]

        def pick(last):
            if temperature > 0.0:
                r = rng or np.random.default_rng()
                p = np.exp((last - last.max(-1, keepdims=True)) / temperature)
                p /= p.sum(-1, keepdims=True)
                return np.array([r.choice(len(q), p=q) for q in p])
            return last.argmax(-1)

        with no_grad():
            enc, enc_mask, cross_kvs = self._encoded(x_ids, attention_mask)
            out = np.full((b, 1), self.cfg.decoder_start_token_id, np.int32)
            finished = np.zeros((b,), bool)
            pasts = [None] * len(self.decoder.block)
            for _ in range(max_new_tokens):
                if use_cache:
                    tok = T.from_numpy(out[:, -1:], requires_grad=False)
                    logits, pasts = self._decode_step(tok, pasts, cross_kvs,
                                                      enc_mask)
                else:
                    logits = self.forward(
                        None, T.from_numpy(out, requires_grad=False),
                        attention_mask=attention_mask, encoder_outputs=enc)
                nxt = pick(logits.numpy()[:, -1])
                nxt = np.where(finished, self.cfg.pad_token_id, nxt)
                out = np.concatenate([out, nxt[:, None].astype(np.int32)], 1)
                finished |= nxt == self.cfg.eos_token_id
                if finished.all():
                    break
        return out[:, 1:]

    # ---- fixed-shape KV-cache decoding ----------------------------------
    def _kv_functions(self, max_len: int):
        """``(encode_fn, cross_fn, step)`` as :class:`ParamFn` over the
        parameters' tensors, in plain PyTorch (the JAX package's are plain
        XLA).  ``encode_fn(toks (S,), add_mask (S,))`` gives the encoder's
        (S, D) states; ``cross_fn(enc)`` the decoder layers' cross (k, v),
        ``(Ld, 2, H, S, dk)``; ``step(cache, pos, tok, cross, add_mask)``
        decodes one token at the device position ``pos`` (an int64 (1,)
        tensor): it writes the token's (k, v) rows into the stacked cache
        ``(Ld, 2, H, max_len, dk)`` IN PLACE at ``pos``, takes its bucket
        row from a device table, attends over the window under a ``<= pos``
        mask, and returns (cache, (vocab,) logits)."""
        cfg = self.cfg
        H, dk, D = cfg.num_heads, cfg.d_kv, cfg.d_model
        Le, Ld = cfg.num_layers, cfg.num_decoder_layers
        eps = cfg.layer_norm_epsilon
        gated = cfg.is_gated_act
        nb = cfg.relative_attention_num_buckets
        md = cfg.relative_attention_max_distance
        p = {name: t.data for name, t in self.named_parameters()}
        dev = p["shared.weight"].device
        rel_bias = ".layer.0.SelfAttention.relative_attention_bias.weight"

        def rms(x, w):
            var = (x * x).mean(-1, keepdim=True)
            return x * torch.rsqrt(var + eps) * w

        def gelu(x):
            return 0.5 * x * (1 + torch.tanh(
                0.7978845608028654 * (x + 0.044715 * x ** 3)))

        def ff(p, x, pre):
            if gated:
                h = gelu(x @ p[pre + "wi_0.weight"].T) \
                    * (x @ p[pre + "wi_1.weight"].T)
            else:
                h = torch.relu(x @ p[pre + "wi.weight"].T)
            return h @ p[pre + "wo.weight"].T

        def heads(x, w):                      # (S, D) -> (H, S, dk)
            return (x @ w.T).reshape(-1, H, dk).transpose(0, 1)

        def attend(q, k, v, bias):
            scores = torch.einsum("hqd,hkd->hqk", q, k) + bias
            att = torch.softmax(scores, dim=-1) @ v       # (H, n, dk)
            return att.transpose(0, 1).reshape(-1, H * dk)

        # the decoder's bucket ids of the whole window, on the device: a
        # step takes its row at the device position
        dec_buckets = _bucket_ids(0, max_len, max_len, True, nb, md, dev)
        cols = torch.arange(max_len, device=dev)

        def encode_fn(p, toks, add_mask):
            x = p["shared.weight"][toks]
            S = toks.shape[0]
            ids = _bucket_ids(0, S, S, False, nb, md, dev)
            bias = p["encoder.block.0" + rel_bias][ids].permute(2, 0, 1) \
                + add_mask[None, None, :]
            for l in range(Le):
                pre = f"encoder.block.{l}.layer."
                a = pre + "0.SelfAttention."
                h = rms(x, p[pre + "0.layer_norm.weight"])
                q, k, v = (heads(h, p[a + n + ".weight"]) for n in "qkv")
                x = x + attend(q, k, v, bias) @ p[a + "o.weight"].T
                h = rms(x, p[pre + "1.layer_norm.weight"])
                x = x + ff(p, h, pre + "1.DenseReluDense.")
            return rms(x, p["encoder.final_layer_norm.weight"])

        def cross_fn(p, enc):
            return torch.stack([torch.stack([
                heads(enc, p[f"decoder.block.{l}.layer.1.EncDecAttention."
                             f"{n}.weight"]) for n in "kv"])
                for l in range(Ld)])

        def step(p, cache, pos, tok, cross, enc_add_mask):
            x = p["shared.weight"][tok]                       # (1, D)
            hidden = cols > pos                               # (max_len,)
            bias = p["decoder.block.0" + rel_bias][dec_buckets[pos][0]] \
                .T[:, None, :]                                # (H, 1, W)
            bias = bias.masked_fill(hidden, _NEG)
            for l in range(Ld):
                pre = f"decoder.block.{l}.layer."
                a = pre + "0.SelfAttention."
                h = rms(x, p[pre + "0.layer_norm.weight"])
                q, k, v = (heads(h, p[a + n + ".weight"]) for n in "qkv")
                cache[l].index_copy_(2, pos, torch.stack([k, v]))
                x = x + attend(q, cache[l, 0], cache[l, 1], bias) \
                    @ p[a + "o.weight"].T
                c = pre + "1.EncDecAttention."
                h = rms(x, p[pre + "1.layer_norm.weight"])
                q = heads(h, p[c + "q.weight"])
                x = x + attend(q, cross[l, 0], cross[l, 1],
                               enc_add_mask[None, None, :]) \
                    @ p[c + "o.weight"].T
                h = rms(x, p[pre + "2.layer_norm.weight"])
                x = x + ff(p, h, pre + "2.DenseReluDense.")
            x = rms(x, p["decoder.final_layer_norm.weight"])
            if cfg.tie_word_embeddings:
                return cache, ((x * D ** -0.5) @ p["shared.weight"].T)[0]
            return cache, (x @ p["lm_head.weight"].T)[0]

        # compiled, but over sharded parameters (decided here, once); the
        # step reads and writes all its arguments in place: the loop keeps
        # them (cache, position, token, cross k/v, mask) for the signature
        kw = dict(compiled=not any(is_sharded(t) for t in p.values()))
        return (ParamFn(encode_fn, p, by_address=(), **kw),
                ParamFn(cross_fn, p, by_address=(), **kw),
                ParamFn(step, p, by_address=range(5), **kw))

    def _compiled_functions(self, max_len: int):
        """:meth:`_kv_functions` at ``max_len``, built once per weight set
        (again when a parameter's buffer is rebound, as ``load_parameters``
        does), with the buffers its loop keeps for each signature."""
        bufs = _weights(self)
        kept = self.__dict__.setdefault("_t5_kv_fns", {})
        fns = kept.get(max_len)
        if fns is None or not _same_weights(fns[0], bufs):
            fns = kept[max_len] = (bufs, self._kv_functions(max_len), {})
        return fns[1], fns[2]

    @torch.no_grad()
    def generate_compiled(self, src_ids, max_new_tokens: int = 20,
                          attention_mask=None, temperature: float = 0.0,
                          rng: np.random.Generator = None):
        """Fixed-shape decoding of ONE source sequence through
        :meth:`_kv_functions`, compiled (each function a CUDA graph on the
        card, built once a weight set): the encoder and the cross (k, v)
        once, then one ``step`` a token over a window of ``max_new_tokens +
        1`` rows.  The position lives on the device and is advanced there;
        the host reads each step's logits row, samples the token with
        ``_sample`` and writes it back into the step's token tensor.
        Returns the generated ids (eos included)."""
        src = np.asarray(src_ids if isinstance(src_ids, np.ndarray)
                         else src_ids.numpy(), np.int32)
        assert src.ndim == 1 or src.shape[0] == 1, "one sequence at a time"
        src = src.reshape(-1)
        am = (np.asarray(attention_mask).reshape(-1).astype(np.float32)
              if attention_mask is not None else np.ones(len(src), np.float32))
        W = max_new_tokens + 1
        # built once per weight set; the loop's buffers kept per source
        # length, so the compiled step replays at their addresses
        (encode_fn, cross_fn, step), bufs = self._compiled_functions(W)
        emb = self.shared.weight.data
        dev, cdt = emb.device, emb.dtype
        add_mask = torch.from_numpy((1.0 - am) * _NEG).to(dev, cdt)
        enc = encode_fn(torch.from_numpy(src.astype(np.int64)).to(dev),
                        add_mask)
        cross = cross_fn(enc)
        cfg = self.cfg
        kept = bufs.get(len(src))
        if kept is None:
            kept = bufs[len(src)] = dict(
                cache=torch.zeros((cfg.num_decoder_layers, 2, cfg.num_heads,
                                   W, cfg.d_kv), dtype=enc.dtype, device=dev),
                pos=torch.zeros(1, dtype=torch.long, device=dev),
                tok=torch.zeros(1, dtype=torch.long, device=dev),
                cross=torch.empty_like(cross),
                mask=torch.empty_like(add_mask))
        cache, pos, tok = kept["cache"].zero_(), kept["pos"].zero_(), \
            kept["tok"].fill_(cfg.decoder_start_token_id)
        cross, add_mask = kept["cross"].copy_(cross), \
            kept["mask"].copy_(add_mask)
        rng = rng or np.random.default_rng(0)
        out = []
        for _ in range(max_new_tokens):
            cache, logits = step(cache, pos, tok, cross, add_mask)
            nxt = _sample(logits.float().cpu().numpy(), temperature, rng)
            out.append(nxt)
            if nxt == cfg.eos_token_id:
                break
            pos += 1
            tok.fill_(nxt)
        return np.array(out, np.int32)

    # ---- HF checkpoint interop ------------------------------------------
    @staticmethod
    def remap_hf_state(state: dict) -> dict:
        """An HF T5 state under this model's names: the same tree, with the
        per-stack views of the shared embedding and buffer extras
        dropped."""
        return {k: v for k, v in state.items()
                if not k.endswith("embed_tokens.weight")
                and ".relative_attention_bias_cache" not in k}

    def export_hf_state(self) -> dict:
        """``state_dict()`` under HF's names: the shared table also as each
        stack's ``embed_tokens.weight``, as HF checkpoints carry it."""
        out = dict(self.state_dict())
        out["encoder.embed_tokens.weight"] = out["shared.weight"]
        out["decoder.embed_tokens.weight"] = out["shared.weight"]
        return out

    @staticmethod
    def from_pretrained(name: str = "t5-small"):
        """(model, config) of an HF repository's ``config.json`` and
        ``pytorch_model.bin`` through :func:`utils.fetch` (which reads a
        file named md5(url) from ``LIGHTGRAD_CACHE`` before the network)."""
        from ..utils import fetch

        url = f"https://huggingface.co/{name}/resolve/main/"
        cfg = T5Config(**json.loads(fetch(url + "config.json")))
        model = T5ForConditionalGeneration(cfg)
        state = torch.load(io.BytesIO(fetch(url + "pytorch_model.bin")),
                           map_location="cpu", weights_only=True)
        model.load_parameters(
            T5ForConditionalGeneration.remap_hf_state(state))
        return model, cfg
