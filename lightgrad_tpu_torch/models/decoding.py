"""KV-cache decoding helpers over the ``_kv_functions`` contract.

Counterpart of part of ``lightgrad_tpu/models/decoding.py``: :class:`KVFns`,
:class:`ParamFn`, ``_window``, ``_device_sample`` and :func:`generate_batch`.
PyTorch runs eagerly, so nothing is traced or compiled here: a ``ParamFn``
only holds a function and the parameters it is called with.

A cache is one tensor or a tuple of tensors (``quantize_kv``'s int8 rows
and their scales); :func:`cache_map`, :func:`stacked_zeros` and
:func:`cache_slot` treat both alike, as ``jax.tree_util.tree_map`` does in
the JAX package.
"""

import numpy as np
import torch

__all__ = ["KVFns", "ParamFn", "generate_batch", "cache_map",
           "stacked_zeros", "cache_slot"]


def cache_map(fn, cache):
    """``fn`` applied to each tensor of a cache (one tensor, or a tuple)."""
    if isinstance(cache, tuple):
        return tuple(fn(c) for c in cache)
    return fn(cache)


def stacked_zeros(cache, n: int):
    """A zeroed cache of ``n`` slots: each tensor with a leading slot dim."""
    return cache_map(lambda c: c.new_zeros((n,) + tuple(c.shape)), cache)


def cache_slot(caches, i: int):
    """Slot ``i`` of a stacked cache, as views (writes go to the stack)."""
    return cache_map(lambda c: c[i], caches)


def _device(cache):
    return (cache[0] if isinstance(cache, tuple) else cache).device


class ParamFn:
    """``fn(params, *args)`` bound to ``params``: calling it passes them.
    ``.fn`` and ``.params`` stay reachable for callers that compose."""

    def __init__(self, fn, params):
        self.fn = fn
        self.params = params

    def __call__(self, *args):
        return self.fn(self.params, *args)


class KVFns:
    """The (init_cache, prefill, step) triple every ``_kv_functions``
    returns, iterable for the 3-way unpack, plus ``extend`` (K tokens at
    positions pos0..pos0+K-1 in one pass) and ``step_batch`` (B slots in one
    weight stream)."""

    def __init__(self, init_cache, prefill, step, extend=None,
                 step_batch=None):
        self.init_cache = init_cache
        self.prefill = prefill
        self.step = step
        self.extend = extend
        self.step_batch = step_batch

    def __iter__(self):
        return iter((self.init_cache, self.prefill, self.step))


def _window(model):
    cfg = model.cfg
    return getattr(cfg, "n_positions", None) or cfg.max_position_embeddings


def _device_sample(logits, generator, temperature: float, top_k: int,
                   top_p: float):
    """On-device sampling of (..., V) logits: greedy (temperature <= 0),
    temperature, top-k and top-p truncation.  ``generator`` is a
    ``torch.Generator`` on the logits' device.  Mirrors the host sampler
    (gpt._sample) minus repetition_penalty.  Returns int64 ids (...)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    lg = logits.float()
    if top_k and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    z = (lg - lg.max(-1, keepdim=True).values) / temperature
    if 0.0 < top_p < 1.0:
        prob = torch.softmax(z, -1)
        psort, order = torch.sort(prob, dim=-1, descending=True)
        keep_sorted = torch.cumsum(psort, -1) - psort < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        z = z.masked_fill(~keep, float("-inf"))
    prob = torch.softmax(z, -1)
    flat = prob.reshape(-1, prob.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)
    return ids.reshape(prob.shape[:-1])


def generate_batch(model, prompts, max_new_tokens: int,
                   temperature: float = 0.0, rng=None, top_k: int = 0,
                   top_p: float = 0.0, eos_id: int = None):
    """B ragged prompts decode together: one prefill per prompt into its
    slot of a stacked cache, then one ``step_batch`` call per generated
    round for the whole batch, sampled on the host.  Finished rows re-write
    their last cache slot harmlessly until every row hits ``eos_id``.

    Returns a list of B token lists (prompt + generated, eos included)."""
    from .gpt import _sample

    W = _window(model)
    B = len(prompts)
    lens = [len(p) for p in prompts]
    assert max(lens) + max_new_tokens <= W, (
        f"prompt+new must fit the window ({max(lens)}+{max_new_tokens} > {W})")
    if not hasattr(model, "_kv_fns"):
        model._kv_fns = model._kv_functions()
    init_cache, prefill, _ = model._kv_fns
    caches = stacked_zeros(init_cache(), B)
    dev = _device(caches)
    rows = []
    for i, pr in enumerate(prompts):
        toks = torch.zeros(W, dtype=torch.long)
        toks[:len(pr)] = torch.as_tensor(pr, dtype=torch.long)
        _, lg = prefill(cache_slot(caches, i), toks.to(dev), len(pr))
        rows.append(lg)
    logits = torch.stack(rows)
    rng = rng or np.random.default_rng(0)
    outs = [list(p) for p in prompts]
    finished = [False] * B
    for t in range(max_new_tokens):
        if t > 0:
            pos = torch.tensor([len(o) - 1 for o in outs], dtype=torch.int32)
            tok = torch.tensor([o[-1] for o in outs], dtype=torch.long)
            caches, logits = model._kv_fns.step_batch(caches, pos.to(dev),
                                                      tok.to(dev))
        lg = logits.float().cpu().numpy()
        for i in range(B):
            if finished[i]:
                continue
            outs[i].append(int(_sample(lg[i], temperature, rng, top_k=top_k,
                                       top_p=top_p)))
            if eos_id is not None and outs[i][-1] == eos_id:
                finished[i] = True
        if all(finished):
            break
    return outs
