"""``torch.nn`` layers of the GPT-2 model that call the port's fused ops.

Counterpart of the ``LayerNorm`` and ``MoE`` of ``lightgrad_tpu/nn.py`` for
the ``torch.nn.Module`` GPT-2 (``models/gpt.py``), with :func:`moe_reference`,
the JAX package's one-hot formulation of the routed FFN in plain PyTorch.
The lightgrad layers are in ``lightgrad_tpu_torch/nn.py``.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

from ..autograd.ops import layernorm, matmul
from ..ops.matmul import matmul_reference
from ..ops.runtime import is_sharded

__all__ = ["LayerNorm", "MoE", "moe_capacity", "moe_reference", "moe_route",
           "moe_slots"]


class LayerNorm(torch.nn.Module):
    """Layer normalization over the trailing ``shape``, through the fused
    LayerNorm kernels.  Parameters ``weight`` (ones) and ``bias`` (zeros)."""

    def __init__(self, shape, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.shape = tuple(shape) if isinstance(shape, (tuple, list)) \
            else (shape,)
        self.eps = eps
        kw = {"device": device, "dtype": dtype}
        self.weight = torch.nn.Parameter(torch.ones(self.shape, **kw))
        self.bias = torch.nn.Parameter(torch.zeros(self.shape, **kw))

    def forward(self, x):
        if tuple(x.shape[-len(self.shape):]) != self.shape:
            raise ValueError(f"LayerNorm shape mismatch: {tuple(x.shape)} vs "
                             f"{self.shape}")
        return layernorm(x.contiguous(), self.weight, self.bias, self.eps)

    def extra_repr(self):
        return f"{self.shape}, eps={self.eps}"


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def moe_capacity(k: int, n_tok: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots an expert: ``ceil(k T / E * capacity_factor)``, at least 1."""
    return max(1, math.ceil(k * n_tok / n_experts * capacity_factor))


def moe_route(probs, k: int, normalize: bool = True):
    """Top-k routing of router probabilities ``probs (T, E)``: k argmax
    passes, each zeroing the experts already chosen (``argmax`` takes the
    first maximum, so an exact tie goes to the lowest expert index).
    Returns (expert ids (k, T) int64, gates (k, T) differentiable in
    ``probs``), the gates renormalised over the k choices when
    ``normalize`` and k > 1."""
    ids, gates = [], []
    remaining = probs
    for c in range(k):
        e = remaining.argmax(-1)
        ids.append(e)
        gates.append(probs.gather(-1, e[:, None])[:, 0])
        if c + 1 < k:
            remaining = remaining.scatter(-1, e[:, None], 0.0)
    if normalize and k > 1:
        denom = sum(gates)
        gates = [g / (denom + 1e-9) for g in gates]
    return torch.stack(ids), torch.stack(gates)


def moe_slots(ids, n_experts: int, cap: int):
    """Capacity slots of routings ``ids (k, T)``, choice-major: every first
    choice claims its slot before any second choice, and within a choice
    tokens go in order.  Returns (slot positions (k, T), kept (k, T)
    bool), counted in int64: a routing is kept while its position is under
    ``cap``."""
    filled = ids.new_zeros(n_experts)
    poss, keeps = [], []
    for e in ids:
        oh = F.one_hot(e, n_experts)
        pos = (oh.cumsum(0) - oh + filled).gather(1, e[:, None])[:, 0]
        keep = pos < cap
        filled = filled + (oh * keep[:, None]).sum(0)
        poss.append(pos)
        keeps.append(keep)
    return torch.stack(poss), torch.stack(keeps)


class MoE(torch.nn.Module):
    """Mixture-of-experts FFN of the ``torch.nn`` GPT, the JAX package's
    ``nn.MoE`` with GELU experts: stacked expert weights ``w1 (E, d, h)``,
    ``w2 (E, h, d)``, a bias-free ``router``, optional always-on shared
    experts ``ws1`` / ``ws2``.

    * ``dispatch="dense"``: every expert processes every token; the router
      softmax weights the mixture.
    * ``dispatch="top1"`` / ``"topk"``: each token routes to its top-k
      experts (:func:`moe_route`), subject to a per-expert capacity
      ``ceil(k T / E * capacity_factor)`` (:func:`moe_slots`); a routing
      past it is dropped (its output is zero; the residual carries the
      token).  Dispatch and combine go by index: each kept routing's row
      is gathered into an ``(E, C, d)`` buffer (empty slots zero), the
      experts run as batched products ``(E, C, d) @ (E, d, h)`` and
      ``(E, C, h) @ (E, h, d)`` through the matmul kernel
      (``autograd.ops.matmul``), and the gate-weighted rows are
      scatter-added back to their tokens.  Nothing is read on the host.
      The JAX package's one-hot products (:func:`moe_reference`) would be
      a (T, E C) matrix a layer.

    The router's softmax, the gates, ``aux_loss`` (Switch load balancing
    on the first choice) and ``z_loss`` (the router's logsumexp squared)
    are float32 whatever the compute dtype; the two losses are plain
    attributes after a routed forward (None after a dense one), and
    ``routes`` holds the forward's (expert ids (k, T), kept (k, T)) and
    ``router_probs`` its (T, E) probabilities, detached."""

    def __init__(self, dim: int, hidden: int, n_experts: int,
                 dispatch: str = "dense", capacity_factor: float = 1.25,
                 k: int = 2, normalize_gates: bool = True,
                 n_shared: int = 0, device=None, dtype=None):
        super().__init__()
        assert dispatch in ("dense", "top1", "topk"), dispatch
        self.n_experts = n_experts
        self.dispatch = dispatch
        self.capacity_factor = capacity_factor
        self.k = 1 if dispatch == "top1" else k
        assert 1 <= self.k <= n_experts, (self.k, n_experts)
        self.normalize_gates = normalize_gates
        self.n_shared = n_shared
        kw = {"device": device, "dtype": dtype}
        self.router = torch.nn.Linear(dim, n_experts, bias=False, **kw)
        self.w1 = torch.nn.Parameter(torch.empty((n_experts, dim, hidden),
                                                 **kw))
        self.w2 = torch.nn.Parameter(torch.empty((n_experts, hidden, dim),
                                                 **kw))
        if n_shared:
            self.ws1 = torch.nn.Parameter(torch.empty((n_shared, dim, hidden),
                                                      **kw))
            self.ws2 = torch.nn.Parameter(torch.empty((n_shared, hidden, dim),
                                                      **kw))
        self.aux_loss = self.z_loss = self.routes = self.router_probs = None

    @staticmethod
    def _ffn(x, w1, w2):
        """GELU experts on stacked rows ``x (E or 1, n, d)``."""
        return matmul(_gelu(matmul(x, w1)), w2)

    def _dense(self, t):
        gates = torch.softmax(self.router(t).float(), -1).to(t.dtype)
        h = self._ffn(t[None], self.w1, self.w2)          # (E, T, d)
        return (h * gates.T[:, :, None]).sum(0)

    def _routed(self, t):
        n_tok, d = t.shape
        n_exp, k = self.n_experts, self.k
        cap = moe_capacity(k, n_tok, n_exp, self.capacity_factor)
        logits = self.router(t).float()
        probs = torch.softmax(logits, -1)
        lse = torch.logsumexp(logits, -1)
        self.z_loss = (lse * lse).mean()
        ids, gates = moe_route(probs, k, self.normalize_gates)
        frac = F.one_hot(ids[0], n_exp).float().mean(0)
        self.aux_loss = (frac * probs.mean(0)).sum() * n_exp
        pos, keep = moe_slots(ids, n_exp, cap)
        self.routes, self.router_probs = (ids, keep), probs.detach()
        # slot of each routing in the (E * C) buffer; a dropped one goes to
        # the spare slot n, cut off below
        n = n_exp * cap
        slot = (ids * cap + pos).masked_fill(~keep, n).reshape(-1)
        tok = torch.arange(n_tok, device=t.device).repeat(k)
        # the token in each slot, n_tok (a zero row) where a slot is empty
        slot_tok = torch.full((n + 1,), n_tok, dtype=torch.long,
                              device=t.device).scatter(0, slot, tok)[:n]
        slot_gate = gates.new_zeros(n + 1).scatter(
            0, slot, gates.reshape(-1))[:n]
        # index_select: its backward is an index_add (at most k rows a
        # token), not the sorting scatter of advanced indexing
        xd = torch.cat([t, t.new_zeros(1, d)]).index_select(0, slot_tok)
        h = self._ffn(xd.reshape(n_exp, cap, d), self.w1, self.w2)
        h = h.reshape(n, d) * slot_gate[:, None].to(h.dtype)
        return t.new_zeros(n_tok + 1, d).index_add(0, slot_tok, h)[:n_tok]

    def forward(self, x):
        lead, d = x.shape[:-1], x.shape[-1]
        t = x.reshape(-1, d)
        mixing = contextlib.nullcontext()
        if is_sharded(t):
            # sharded tokens or experts (parallel.shard_module, MOE rules):
            # the tokens are routed whole on every rank, the routing's index
            # tensors count as replicated, and the experts' products run on
            # their ep shards (ops/matmul.py's placement rules)
            from torch.distributed.tensor import Replicate
            from torch.distributed.tensor.experimental import \
                implicit_replication
            t = t.redistribute(t.device_mesh,
                               [Replicate()] * t.device_mesh.ndim)
            mixing = implicit_replication()
        with mixing:
            y = self._dense(t) if self.dispatch == "dense" \
                else self._routed(t)
        if self.n_shared:
            y = y + self._ffn(t[None], self.ws1, self.ws2).sum(0)
        return y.reshape(*lead, d)


def moe_reference(x, w, n_experts: int, dispatch: str = "topk", k: int = 2,
                  capacity_factor: float = 1.25,
                  normalize_gates: bool = True, ids=None):
    """:class:`MoE`'s function as the JAX package computes it, in plain
    PyTorch: argmax one-hots (the first maximum), slot positions by a float
    ``cumsum`` of them, and dispatch and combine as one-hot products with a
    (T, E C) matrix.  ``w`` holds the parameters by name (``router.weight``,
    ``w1``, ``w2``, and ``ws1`` / ``ws2`` for shared experts); ``ids (k,
    T)`` replaces its own expert choices (the gates are still its own
    probabilities at them).  Returns (y, aux_loss, z_loss, (its own expert
    ids (k, T), kept (k, T) bool)); the routed outputs are None in dense
    mode."""
    lead, d = x.shape[:-1], x.shape[-1]
    t = x.reshape(-1, d)
    n_tok, n_exp = t.shape[0], n_experts
    k = 1 if dispatch == "top1" else k

    def ffn(xe, w1, w2):
        return matmul_reference(_gelu(matmul_reference(xe, w1)), w2)

    logits = matmul_reference(t, w["router.weight"].T).float()
    probs = torch.softmax(logits, -1)
    aux = z = routes = None
    if dispatch == "dense":
        h = ffn(t[None], w["w1"], w["w2"])
        y = (h * probs.to(t.dtype).T[:, :, None]).sum(0)
    else:
        cap = moe_capacity(k, n_tok, n_exp, capacity_factor)
        m = logits.max(-1, keepdim=True).values
        lse = (logits - m).exp().sum(-1, keepdim=True).log() + m
        z = (lse * lse).mean()
        own, remaining = [], probs
        for _ in range(k):
            is_max = (remaining == remaining.max(-1, keepdim=True).values)
            first = is_max & (is_max.cumsum(-1) == 1)
            own.append(first.float().argmax(-1))
            remaining = remaining * (~first)
        own = torch.stack(own)
        use = own if ids is None else ids
        onehots = [F.one_hot(e, n_exp).float() for e in use]
        gates = [(probs * oh).sum(-1, keepdim=True) for oh in onehots]
        if normalize_gates and k > 1:
            denom = sum(gates)
            gates = [g / (denom + 1e-9) for g in gates]
        aux = (onehots[0].mean(0) * probs.mean(0)).sum() * float(n_exp)
        slots = torch.arange(cap, dtype=torch.float32, device=t.device)
        disp = comb = filled = None
        kept = []
        for oh, gate in zip(onehots, gates):
            pos = oh.cumsum(0) - oh
            if filled is not None:
                pos = pos + filled
            keep = oh * (pos < cap)
            filled = keep.sum(0, keepdim=True) if filled is None \
                else filled + keep.sum(0, keepdim=True)
            kept.append(keep.sum(-1) > 0)
            poh = ((pos * keep).sum(-1, keepdim=True) == slots).float()
            dd = (keep[:, :, None] * poh[:, None, :]).reshape(
                n_tok, n_exp * cap).to(t.dtype)
            disp = dd if disp is None else disp + dd
            dg = dd * gate.to(t.dtype)
            comb = dg if comb is None else comb + dg
        xd = matmul_reference(disp.T, t)                     # (E C, d)
        h = ffn(xd.reshape(n_exp, cap, d), w["w1"], w["w2"])
        y = matmul_reference(comb, h.reshape(n_exp * cap, d))
        routes = (own, torch.stack(kept))
    if "ws1" in w:
        y = y + ffn(t[None], w["ws1"], w["ws2"]).sum(0)
    return y.reshape(*lead, d), aux, z, routes
