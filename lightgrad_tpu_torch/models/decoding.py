"""KV-cache decoding over the ``_kv_functions`` contract (GPT, LLaMA).

Counterpart of ``lightgrad_tpu/models/decoding.py``: :class:`KVFns`,
:class:`ParamFn`, host-loop :func:`generate_batch`, whole-generation
decoding on the device (:func:`generate_device`,
:func:`generate_batch_device`), :func:`beam_search`, and speculative
decoding (:func:`generate_speculative`, :func:`speculative_accept`,
:func:`generate_speculative_device`).  PyTorch runs eagerly, so nothing is
traced or compiled here: a ``ParamFn`` only holds a function and the
parameters it is called with, and a JAX ``lax.scan`` / ``while_loop``
becomes a Python loop that enqueues device work without reading it back.

A cache is one tensor or a tuple of tensors (``quantize_kv``'s int8 rows
and their scales); :func:`cache_map`, :func:`stacked_zeros` and
:func:`cache_slot` treat both alike, as ``jax.tree_util.tree_map`` does in
the JAX package.  The functions write the cache IN PLACE (the JAX package
returned a new array), so beam search clones a cache that more than one
surviving beam continues from.

The device loops move data between host and device only inside
:func:`_host_io`, which counts each transfer in :data:`host_transfers` and
runs it with torch's sync debug mode off: a caller may run a whole
generation under ``torch.cuda.set_sync_debug_mode("error")``, and any
other host read of a device value raises (build the model's decode
functions first, e.g. by one ``generate``: building them uploads their
constants).  The functions cache nothing on the model beyond its
``_kv_fns``.
"""

import contextlib
from collections import Counter

import numpy as np
import torch

__all__ = ["KVFns", "ParamFn", "generate_batch", "generate_device",
           "generate_batch_device", "beam_search", "generate_speculative",
           "generate_speculative_device", "speculative_accept", "cache_map",
           "stacked_zeros", "cache_slot", "host_transfers"]

# host <-> device transfers of the device loops, by function: an upload of
# the prompts, a readback of the tokens, and the speculative loop's read of
# (n, done) once a round
host_transfers = Counter()


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


def _log_softmax(x):
    x = np.asarray(x, np.float64)
    m = x.max()
    e = np.exp(x - m)
    return x - m - np.log(e.sum())


def _kv(model):
    if not hasattr(model, "_kv_fns"):
        model._kv_fns = model._kv_functions()
    return model._kv_fns


def _categorical(prob, generator):
    """One draw from each row of ``prob (..., V)`` as ``torch.multinomial
    (prob, 1)`` makes it after its checks (the exponential race: argmax of
    p / q with q ~ Exp(1)), minus those checks' host read: the same ids
    from the same generator state.  Returns int64 ids (...)."""
    q = torch.empty_like(prob).exponential_(1, generator=generator)
    return torch.argmax(prob / q, dim=-1)


def _device_sample(logits, generator, temperature: float, top_k: int,
                   top_p: float):
    """On-device sampling of (..., V) logits: greedy (temperature <= 0),
    temperature, top-k and top-p truncation.  ``generator`` is a
    ``torch.Generator`` on the logits' device.  Mirrors the host sampler
    (gpt._sample) minus repetition_penalty.  Nothing is read to the host.
    Returns int64 ids (...)."""
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
    return _categorical(torch.softmax(z, -1), generator)


@contextlib.contextmanager
def _host_io(fn: str, dev):
    """A host <-> device transfer of ``fn``'s device loop: counted in
    :data:`host_transfers`, and run with torch's sync debug mode off."""
    host_transfers[fn] += 1
    if dev.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _trim_eos(seq, eos_id):
    out = []
    for t in seq:
        out.append(int(t))
        if eos_id is not None and int(t) == eos_id:
            break
    return out


def _padded(prompts, W):
    """(B, W) int64 host tensor of the prompts, right-padded with 0."""
    toks = torch.zeros((len(prompts), W), dtype=torch.long)
    for i, pr in enumerate(prompts):
        toks[i, :len(pr)] = torch.as_tensor(pr, dtype=torch.long)
    return toks


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
    init_cache, prefill, _ = _kv(model)
    caches = stacked_zeros(init_cache(), B)
    toks = _padded(prompts, W).to(_device(caches))
    rows = [prefill(cache_slot(caches, i), toks[i], len(pr))[1]
            for i, pr in enumerate(prompts)]
    logits = torch.stack(rows)
    rng = rng or np.random.default_rng(0)
    outs = [list(p) for p in prompts]
    finished = [False] * B
    for t in range(max_new_tokens):
        if t > 0:
            pos = torch.tensor([len(o) - 1 for o in outs], dtype=torch.int32)
            tok = torch.tensor([o[-1] for o in outs], dtype=torch.long)
            caches, logits = model._kv_fns.step_batch(
                caches, pos.to(toks.device), tok.to(toks.device))
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


def _first_tokens(model, prompts, fn):
    """Upload the prompts (one transfer of ``fn``), prefill each into its
    slot of a stacked cache: (caches, (B, V) logits, (B,) int32 device
    positions of the next token)."""
    W = _window(model)
    init_cache, prefill, _ = _kv(model)
    caches = stacked_zeros(init_cache(), len(prompts))
    dev = _device(caches)
    toks = _padded(prompts, W)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    with _host_io(fn, dev):
        toks, poss = toks.to(dev), lens.to(dev)
    rows = [prefill(cache_slot(caches, i), toks[i], len(pr))[1]
            for i, pr in enumerate(prompts)]
    return caches, torch.stack(rows), poss


def _device_loop(step, caches, logits, poss, max_new_tokens, generator,
                 temperature, top_k, top_p, eos_id):
    """The decode loop of :func:`generate_device` / ``_batch_device`` on
    the device: ``step(caches, poss, toks) -> (caches, (B, V) logits)``
    advances all B rows; after ``eos_id`` a row keeps feeding (and holding)
    eos, as the JAX package's scan carry does, for the fixed cost of
    ``max_new_tokens`` steps.  Returns the (B, max_new_tokens) int64 token
    buffer on the device, not read back."""
    B = logits.shape[0]
    dev = logits.device
    out = torch.empty((B, max_new_tokens), dtype=torch.long, device=dev)
    eos = torch.full((B,), -1 if eos_id is None else eos_id,
                     dtype=torch.long, device=dev)
    tok = _device_sample(logits, generator, temperature, top_k, top_p)
    done = tok == eos
    out[:, 0] = tok
    for i in range(1, max_new_tokens):
        caches, logits = step(caches, poss, tok)
        nxt = _device_sample(logits, generator, temperature, top_k, top_p)
        tok = torch.where(done, eos, nxt)
        done = done | (tok == eos)
        out[:, i] = tok
        poss = poss + 1
    return out


@torch.no_grad()
def generate_device(model, ids, max_new_tokens: int, temperature: float = 0.0,
                    top_k: int = 0, top_p: float = 0.0, eos_id: int = None,
                    seed: int = 0):
    """Whole-generation decoding on the device: one prefill, then
    ``max_new_tokens - 1`` steps whose position, token and eos flag are
    device tensors, sampled on the device (``_device_sample`` with a
    ``torch.Generator`` on the model's device seeded by ``seed``).  The
    host uploads the prompt once and reads the tokens back once; inside
    the loop nothing reads the device, so the host enqueues steps ahead of
    the card instead of waiting for every token's logits as ``generate``
    does.

    No streaming callback and no repetition_penalty (it needs the emitted
    history on the host); post-eos steps still run.  Returns prompt +
    generated ids (eos included, post-eos slots trimmed)."""
    W = _window(model)
    assert len(ids) + max_new_tokens <= W, (
        f"prompt+new must fit the window ({len(ids)}+{max_new_tokens} > {W})")
    _, _, step = _kv(model)
    caches, logits, poss = _first_tokens(model, [list(ids)],
                                         "generate_device")
    gen = torch.Generator(device=logits.device).manual_seed(seed)
    out = _device_loop(
        lambda c, p, t: (c, step(cache_slot(c, 0), p, t)[1][None]),
        caches, logits, poss, max_new_tokens, gen, temperature, top_k,
        top_p, eos_id)
    with _host_io("generate_device", out.device):
        new = out[0].tolist()
    return list(ids) + _trim_eos(new, eos_id)


@torch.no_grad()
def generate_batch_device(model, prompts, max_new_tokens: int,
                          temperature: float = 0.0, top_k: int = 0,
                          top_p: float = 0.0, eos_id: int = None,
                          seed: int = 0):
    """Batched whole-generation decoding on the device: B ragged prompts,
    one prefill each into a stacked cache, then one ``step_batch`` a
    round for all B rows (one weight stream; a model without it steps each
    slot in turn).  Sampled rows draw from one generator seeded by
    ``seed``.  One upload and one readback.

    Returns a list of B token lists (prompt + generated, trimmed at eos)."""
    W = _window(model)
    lens = [len(p) for p in prompts]
    assert max(lens) + max_new_tokens <= W, (
        f"prompt+new must fit the window ({max(lens)}+{max_new_tokens} > {W})")
    fns = _kv(model)
    step_batch = fns.step_batch
    if step_batch is None:
        def step_batch(caches, poss, toks):
            return caches, torch.stack([
                fns.step(cache_slot(caches, b), poss[b:b + 1],
                         toks[b:b + 1])[1] for b in range(len(prompts))])
    caches, logits, poss = _first_tokens(model, prompts,
                                         "generate_batch_device")
    gen = torch.Generator(device=logits.device).manual_seed(seed)
    out = _device_loop(step_batch, caches, logits, poss, max_new_tokens, gen,
                       temperature, top_k, top_p, eos_id)
    with _host_io("generate_batch_device", out.device):
        new = out.tolist()
    return [list(pr) + _trim_eos(row, eos_id)
            for pr, row in zip(prompts, new)]


def _best(lp, n):
    """Indices of the ``n`` largest of ``lp``, ties in index order (so
    ``n = 1`` is ``np.argmax``)."""
    return np.argsort(-lp, kind="stable")[:n]


@torch.no_grad()
def beam_search(model, ids, max_new_tokens: int, beam_size: int = 4,
                eos_id: int = None, length_penalty: float = 1.0):
    """Length-normalized beam search; returns the best token sequence
    (prompt + generated).  ``length_penalty`` > 1 favors longer outputs;
    hypotheses are scored ``logprob / n_generated**length_penalty``.
    The beam bookkeeping is host-side float64 numpy over the step's logits.

    The step writes its cache in place, so a cache that more than one
    surviving beam continues from is cloned before the next step (the JAX
    package shares one immutable cache between them); any other cache is
    reused.  ``beam_size=1`` is exactly greedy decoding."""
    ids = list(ids)
    W = _window(model)
    assert len(ids) + max_new_tokens <= W, (
        f"beam search needs prompt+new <= window ({len(ids)}+{max_new_tokens}"
        f" > {W})")
    init_cache, prefill, step = _kv(model)
    cache = init_cache()
    toks = _padded([ids], W)[0].to(_device(cache))
    cache, logits = prefill(cache, toks, len(ids))
    lp = _log_softmax(logits.float().cpu().numpy())
    # beam: (token list, cumulative logprob, cache)
    beams = [(ids + [int(t)], float(lp[t]), cache)
             for t in _best(lp, beam_size)]
    done = []

    def finalize(seq, score):
        n_gen = len(seq) - len(ids)
        done.append((seq, score / n_gen ** length_penalty))

    def live(seq):
        return eos_id is None or seq[-1] != eos_id

    def own_caches(beams):
        """Each live beam with a cache of its own: the first beam on a
        cache keeps it, the others step on clones."""
        taken, out = set(), []
        for seq, score, c in beams:
            if live(seq) and id(c) in taken:
                c = cache_map(torch.clone, c)
            taken.add(id(c))
            out.append((seq, score, c))
        return out

    for _ in range(max_new_tokens - 1):
        candidates = []
        for seq, score, c in own_caches(beams):
            if not live(seq):
                finalize(seq, score)
                continue
            c2, logits = step(c, len(seq) - 1, seq[-1])
            lp = _log_softmax(logits.float().cpu().numpy())
            for t in _best(lp, beam_size):
                candidates.append((seq + [int(t)], score + float(lp[t]), c2))
        if not candidates:
            break
        candidates.sort(key=lambda b: b[1], reverse=True)
        beams = candidates[:beam_size]
        if len(done) >= beam_size:
            break
    for seq, score, _ in beams:
        if live(seq):  # eos'd beams already final
            finalize(seq, score)
    return max(done, key=lambda d: d[1])[0]


def speculative_accept(p_draft, p_target, proposed, rng):
    """One speculative rejection-sampling decision (Leviathan et al. 2023,
    arXiv:2211.17192 App. A).  ``proposed`` was sampled from ``p_draft``;
    accept it with probability ``min(1, p_t[x] / p_d[x])``, otherwise
    resample from the residual ``normalize(max(p_t - p_d, 0))``.  The
    marginal law of the returned token is exactly ``p_target``.

    Returns ``(token, accepted)``."""
    x = int(proposed)
    if rng.random() < min(1.0, float(p_target[x])
                          / max(float(p_draft[x]), 1e-20)):
        return x, True
    resid = np.maximum(np.asarray(p_target, np.float64)
                       - np.asarray(p_draft, np.float64), 0.0)
    s = resid.sum()
    if s <= 0.0:  # distributions identical: rejection cannot occur, but
        return x, True  # guard the degenerate float case anyway
    return int(rng.choice(len(resid), p=resid / s)), False


def _verify(fns, cache, pos0, toks):
    """The target's logits at positions pos0..pos0+K-1 for ``toks (K,)``:
    one ``extend`` pass where the model has one (one weight read for the K
    rows), else K ``step``s.  ``pos0`` a host int or an int32 (1,) device
    tensor.  Returns (cache, (K, V) logits)."""
    if fns.extend is not None:
        return fns.extend(cache, pos0, toks)
    rows = []
    for i in range(toks.shape[0]):
        cache, lg = fns.step(cache, pos0 + i, toks[i:i + 1])
        rows.append(lg)
    return cache, torch.stack(rows)


@torch.no_grad()
def generate_speculative(model, draft, ids, max_new_tokens: int, k: int = 4,
                         eos_id: int = None, temperature: float = 0.0,
                         rng=None):
    """Draft-accelerated decoding (speculative decoding,
    https://arxiv.org/abs/2211.17192), driven from the host.

    Each round the cheap ``draft`` proposes ``k`` tokens autoregressively,
    then ``model`` scores all k+1 positions (one ``extend`` pass where the
    model has one, else k+1 steps).

    * ``temperature<=0`` (greedy): the longest draft prefix matching the
      target's own argmax choices is accepted, plus the target's
      correction/bonus token -- the output is plain greedy decoding of
      ``model``.
    * ``temperature>0`` (sampled): each proposal goes through
      :func:`speculative_accept` against the target's tempered softmax, so
      every emitted token's marginal law is the target distribution.

    Rejected proposals leave stale K/V rows beyond the accepted position;
    the ``<= pos`` attention mask hides them and the next round's writes
    overwrite them.  Both models must share a vocabulary.  Returns prompt
    + generated."""
    W = min(_window(model), _window(draft))
    ids = [int(t) for t in ids]
    # + k: a verify pass can write up to k rows past the final accepted
    # position; they must stay inside the window
    assert len(ids) + max_new_tokens + k <= W, (len(ids), max_new_tokens, k, W)
    t_fns, d_fns = _kv(model), _kv(draft)
    rng = rng or np.random.default_rng(0)
    sampled = temperature > 0.0

    def probs(logits):
        z = logits.float().cpu().numpy().astype(np.float64) / temperature
        z -= z.max(-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(-1, keepdims=True)

    t_cache, d_cache = t_fns.init_cache(), d_fns.init_cache()
    dev = _device(t_cache)
    t_cache, t_logits = t_fns.prefill(
        t_cache, _padded([ids], _window(model))[0].to(dev), len(ids))
    d_cache, _ = d_fns.prefill(
        d_cache, _padded([ids], _window(draft))[0].to(_device(d_cache)),
        len(ids))

    out = list(ids)
    if sampled:
        first = probs(t_logits)
        out.append(int(rng.choice(len(first), p=first)))
    else:
        out.append(int(torch.argmax(t_logits)))
    if eos_id is not None and out[-1] == eos_id:
        return out
    while len(out) - len(ids) < max_new_tokens:
        # budget-capped proposal length (never decode past max_new_tokens)
        kk = min(k, max_new_tokens - (len(out) - len(ids)))
        proposals, d_probs, tok, pos = [], [], out[-1], len(out) - 1
        for j in range(kk):
            d_cache, dl = d_fns.step(d_cache, pos + j, tok)
            if sampled:
                pd = probs(dl)
                tok = int(rng.choice(len(pd), p=pd))
                d_probs.append(pd)
            else:
                tok = int(torch.argmax(dl))
            proposals.append(tok)
        vt = torch.tensor([out[-1]] + proposals + [0] * (k - kk),
                          dtype=torch.long)
        t_cache, t_rows = _verify(t_fns, t_cache, len(out) - 1, vt.to(dev))
        if sampled:
            pt = probs(t_rows)
            accepted = []
            for m in range(kk):
                tok, ok = speculative_accept(d_probs[m], pt[m], proposals[m],
                                             rng)
                accepted.append(int(tok))
                if not ok:
                    break
            else:
                # every proposal accepted: free bonus token from the target
                accepted.append(int(rng.choice(pt.shape[1], p=pt[kk])))
        else:
            preds = t_rows.argmax(-1).tolist()
            m = 0
            while m < kk and proposals[m] == preds[m]:
                m += 1
            # preds[m] is the correction on mismatch, the free bonus token
            # when every proposal was accepted -- valid either way
            accepted = proposals[:m] + [preds[m]]
        new = accepted[: max_new_tokens - (len(out) - len(ids))]
        out.extend(new)
        if eos_id is not None and eos_id in new:
            return out[: out.index(eos_id, len(ids)) + 1]
    return out


def _accept_device(props, dlogits, trows, generator, temperature):
    """The accept rule of :func:`generate_speculative_device` on the
    device.  props (k,) the draft's proposals, dlogits (k, V) its logits,
    trows (k+1, V) the target's.  Returns (m, emit): m (1,) the number of
    accepted proposals, emit (k+1,) with emit[:m] = props[:m] and emit[m]
    the target's correction (or bonus token when m = k)."""
    k = props.shape[0]
    tail = torch.zeros(1, dtype=props.dtype, device=props.device)
    if temperature <= 0.0:
        preds = torch.argmax(trows, dim=-1)
        m = (props == preds[:k]).int().cumprod(0).sum().reshape(1)
        corr = preds.gather(0, m)
    else:
        tp = torch.softmax(trows.float() / temperature, -1)
        dp = torch.softmax(dlogits.float() / temperature, -1)
        us = torch.rand(k, generator=generator, device=props.device)
        px_t = tp[:k].gather(1, props[:, None])[:, 0]
        px_d = dp.gather(1, props[:, None])[:, 0]
        accept = us < torch.clamp(px_t / px_d.clamp_min(1e-20), max=1.0)
        m = accept.int().cumprod(0).sum().reshape(1)
        # rejection at m < k: resample the residual max(p_t - p_d, 0); a
        # degenerate all-zero residual keeps the proposal (identical
        # distributions cannot truly reject -- an f32 guard only)
        mr = m.clamp(max=k - 1)
        resid = (tp.index_select(0, mr) - dp.index_select(0, mr)).clamp_min(
            0.0)[0]
        rtok = torch.where(resid.sum() > 0,
                           _categorical(resid, generator).reshape(1),
                           props.gather(0, mr))
        # all k accepted: free bonus token from the target's k-th row
        btok = _categorical(tp[k], generator).reshape(1)
        corr = torch.where(m == k, btok, rtok)
    emit = torch.cat([props, tail]).scatter(0, m, corr)
    return m, emit


@torch.no_grad()
def generate_speculative_device(model, draft, ids, max_new_tokens: int,
                                k: int = 4, temperature: float = 0.0,
                                eos_id: int = None, seed: int = 0):
    """Speculative decoding with every round on the device: the draft's k
    proposals, the target's verify pass and the accept rule (greedy
    longest-prefix; sampled Leviathan rejection, residual resample and
    bonus token, in f32) run on device tensors into a buffer of
    ``max_new_tokens + k`` slots.

    The JAX package's ``while_loop`` tests (n, done) once a round on the
    device.  Here the host reads those two values once a round -- the one
    host read inside the loop, counted in :data:`host_transfers` -- and
    nothing else; the tokens come back once at the end.  Greedy output is
    plain greedy decoding of ``model``, as :func:`generate_device`'s;
    sampled output is marginally exact.

    Both models must share a vocabulary.  Returns prompt + generated ids.
    """
    assert k >= 1, "need at least one draft proposal per round"
    fn = "generate_speculative_device"
    ids = [int(t) for t in ids]
    # + k: a verify pass can write up to k rows past the final accepted
    # position; they must stay inside both windows
    assert len(ids) + max_new_tokens + k <= min(_window(model),
                                                 _window(draft)), (
        len(ids), max_new_tokens, k, _window(model), _window(draft))
    t_fns, d_fns = _kv(model), _kv(draft)
    t_cache, t_logits, base = _first_tokens(model, [ids], fn)
    d_cache, _, _ = _first_tokens(draft, [ids], fn)
    t_cache, d_cache = cache_slot(t_cache, 0), cache_slot(d_cache, 0)
    dev = t_logits.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    eos = torch.full((1,), -1 if eos_id is None else eos_id,
                     dtype=torch.long, device=dev)
    steps = torch.arange(k + 1, device=dev)
    last = _device_sample(t_logits, gen, temperature, 0, 0.0)    # (1,)
    buf = torch.zeros(max_new_tokens + k, dtype=torch.long, device=dev)
    buf[:1] = last
    state = torch.stack([torch.ones_like(last),          # (n, done)
                         (last == eos).long()])
    base = base - 1                     # the position of `last` is base + n
    while True:
        with _host_io(fn, dev):
            n, done = state.tolist()
        if n[0] >= max_new_tokens or done[0]:
            break
        pos = base + state[0].int()
        tok, props, dlogits = last, [], []
        for i in range(k):
            d_cache, dl = d_fns.step(d_cache, pos + i, tok)
            tok = _device_sample(dl[None], gen, temperature, 0, 0.0)
            props.append(tok)
            dlogits.append(dl)
        props = torch.cat(props)
        t_cache, trows = _verify(t_fns, t_cache, pos,
                                 torch.cat([last, props]))
        m, emit = _accept_device(props, torch.stack(dlogits), trows, gen,
                                 temperature)
        # emit[:m+1] are real; the tail is overwritten by the next round's
        # write (from n+m+1) or trimmed on the host
        buf.index_copy_(0, state[0] + steps, emit)
        hit = ((emit == eos) & (steps <= m)).any().reshape(1)
        state = torch.stack([state[0] + m + 1, state[1] | hit])
        last = emit.gather(0, m)
    with _host_io(fn, dev):
        new = buf[:min(n[0], max_new_tokens)].tolist()
    return ids + _trim_eos(new, eos_id)
