"""Continuous-batching inference engine over KV-cache decoding.

Counterpart of ``lightgrad_tpu/serving.py``.  A fixed number of decode slots
shares one stacked cache ``(slots, L, 2, H, W, hd)`` (under ``quantize_kv``
the pair of its int8 rows and row scales); between ticks the host
admits queued requests into free slots (one prefill each) and retires
finished ones, so short requests never wait for long ones and nobody is
padded to the longest request of a batch.

Every tick advances ALL slots with the model's ``step_batch`` (one weight
stream for all slots through the whole-stack decode kernel); finished or
empty slots harmlessly rewrite their last cache row.  When every in-flight
request shares one (temperature, top_k, top_p) signature, sampling runs on
the device and a tick runs ``steps_per_tick`` batched steps back to back:
the tokens stay on the device within the tick and the host reads them back
once per tick.  Mixed signatures sample on the host, one step per tick.
Every host <-> device transfer of a tick goes through the decoding
module's ``_host_io`` (counted under "engine"), so a tick runs under
``torch.cuda.set_sync_debug_mode("error")``.
"""

import numpy as np
import torch

from .models.decoding import (_device, _device_sample, _host_io, _window,
                              cache_slot, stacked_zeros)
from .models.gpt import _sample

__all__ = ["Request", "InferenceEngine"]


class Request:
    """One generation request and its (growing) result."""

    _next_id = 0

    def __init__(self, prompt, max_new_tokens: int, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, eos_id: int = None):
        self.id = Request._next_id
        Request._next_id += 1
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = temperature
        self.top_k, self.top_p = top_k, top_p
        self.eos_id = eos_id
        self.tokens = list(self.prompt)   # prompt + generated
        self.done = False

    @property
    def n_generated(self):
        return len(self.tokens) - len(self.prompt)


class InferenceEngine:
    """Slot-based continuous batching over a ``_kv_functions`` model.

    ``slots`` is the max number of concurrently decoding requests.
    ``submit()`` any number of requests, then ``run()``.  ``rng`` (numpy)
    drives host-side sampling; ``generator`` (a ``torch.Generator`` on the
    model's device) drives device-side sampling."""

    def __init__(self, model, slots: int = 8, rng=None,
                 steps_per_tick: int = 1,
                 generator: torch.Generator = None):
        self.model = model
        self.slots = slots
        # steps_per_tick > 1: each tick runs S batched steps with on-device
        # sampling before the host looks again -- S-fold fewer host round
        # trips, at the cost of admitting new requests every S tokens.
        # Slots that finish mid-tick keep decoding garbage rows; the host
        # trims at eos/max_new and admission re-prefills the slot's cache.
        self.steps_per_tick = max(1, int(steps_per_tick))
        self.rng = rng or np.random.default_rng(0)
        self.window = _window(model)
        if not hasattr(model, "_kv_fns"):
            model._kv_fns = model._kv_functions()
        init_cache, self._prefill, _ = model._kv_fns
        self._step_batch = model._kv_fns.step_batch
        self._caches = stacked_zeros(init_cache(), slots)
        self._device = _device(self._caches)
        if generator is None:
            generator = torch.Generator(device=self._device).manual_seed(0)
        self.generator = generator

        self._active = [None] * slots     # slot -> Request | None
        self._queue = []
        self._finished = []
        # instrumentation: continuous batching's win is fewer step ticks
        self.stats = {"step_dispatches": 0, "prefills": 0,
                      "tokens_generated": 0, "slot_tokens": 0}

    # ------------------------------------------------------------------ API
    def submit(self, prompt, max_new_tokens: int, **kw) -> Request:
        req = Request(prompt, max_new_tokens, **kw)
        assert len(req.prompt) + req.max_new_tokens <= self.window, (
            f"prompt+new must fit the window "
            f"({len(req.prompt)}+{req.max_new_tokens} > {self.window})")
        self._queue.append(req)
        return req

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self._active)

    def run(self):
        """Drive until every submitted request is finished; returns the
        finished requests in completion order."""
        while self.pending:
            self.tick()
        out, self._finished = self._finished, []
        return out

    # ------------------------------------------------------------ engine
    @torch.no_grad()
    def tick(self):
        """One engine iteration: admit into free slots, then one tick of
        batched decode steps across all slots."""
        for slot in range(self.slots):
            if self._active[slot] is not None or not self._queue:
                continue
            req = self._queue.pop(0)
            toks = torch.zeros(self.window, dtype=torch.long)
            toks[:len(req.prompt)] = torch.as_tensor(req.prompt)
            # prefill writes the slot's rows of the stacked cache in place
            # (the JAX engine rebuilt the stacked array around a fresh cache)
            with _host_io("engine", self._device):
                toks = toks.to(self._device)
            _, logits = self._prefill(cache_slot(self._caches, slot), toks,
                                      len(req.prompt))
            self.stats["prefills"] += 1
            with _host_io("engine", self._device):
                lg = logits.float().cpu().numpy()
            req.tokens.append(_sample(lg, req.temperature, self.rng,
                                      top_k=req.top_k, top_p=req.top_p))
            self.stats["tokens_generated"] += 1
            if self._is_finished(req):
                req.done = True
                self._finished.append(req)
            else:
                self._active[slot] = req

        if not any(r is not None for r in self._active):
            return

        pos = np.zeros(self.slots, np.int32)
        tok = np.zeros(self.slots, np.int64)
        for slot, req in enumerate(self._active):
            if req is not None:
                pos[slot] = len(req.tokens) - 1
                tok[slot] = req.tokens[-1]
        with _host_io("engine", self._device):
            poss = torch.from_numpy(pos).to(self._device)
            toks = torch.from_numpy(tok).to(self._device)

        sigs = {(r.temperature, r.top_k, r.top_p)
                for r in self._active if r is not None}
        if len(sigs) == 1:
            # homogeneous sampling: sample on the device, read back one
            # (steps, slots) block per tick.  Steps beyond a request's
            # eos/max_new decode garbage rows that the host never appends.
            steps = self.steps_per_tick
            temp, tk, tp = next(iter(sigs))
            block = torch.empty((steps, self.slots), dtype=torch.long,
                                device=self._device)
            for i in range(steps):
                self._caches, logits = self._step_batch(self._caches, poss,
                                                        toks)
                toks = _device_sample(logits, self.generator, temp, tk, tp)
                block[i] = toks
                poss = poss + 1
            with _host_io("engine", self._device):
                tokmat = block.T.cpu().numpy()
        else:
            steps = 1
            self._caches, logits = self._step_batch(self._caches, poss, toks)
            with _host_io("engine", self._device):
                lg = logits.float().cpu().numpy()
            tokmat = np.array([[
                _sample(lg[s], r.temperature, self.rng, top_k=r.top_k,
                        top_p=r.top_p) if r is not None else 0]
                for s, r in enumerate(self._active)], np.int64)
        self.stats["step_dispatches"] += 1
        self.stats["slot_tokens"] += self.slots * steps
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            for i in range(steps):
                req.tokens.append(int(tokmat[slot, i]))
                self.stats["tokens_generated"] += 1
                if self._is_finished(req):
                    req.done = True
                    self._finished.append(req)
                    self._active[slot] = None   # slot frees for next tick
                    break

    @staticmethod
    def _is_finished(req) -> bool:
        if req.eos_id is not None and req.tokens[-1] == req.eos_id:
            return True
        return req.n_generated >= req.max_new_tokens
