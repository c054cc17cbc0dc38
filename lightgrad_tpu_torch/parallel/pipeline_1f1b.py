"""1F1B pipeline-parallel training step (memory-bounded schedule).

Counterpart of ``lightgrad_tpu/parallel/pipeline_1f1b.py``.  The classic
1F1B schedule (PipeDream-flush / Megatron-LM) interleaves each
microbatch's backward as early as its forward chain allows, bounding the
activations a rank keeps to at most ``P`` (pipeline depth) whatever the
number of microbatches.

The schedule is simulated on the host (``_schedule``, the JAX package's
tables, copied): a (ticks, P) table of per-rank actions {idle, fwd, bwd}
and microbatch ids, honouring the transfer latency (an activation sent at
tick t is usable at t+1) and the 1F1B policy (``min(P-d, M)`` warmup
forwards, then prefer backward).  Every rank walks the same table:

* at a forward tick it runs its stage on the stashed (or, on stage 0,
  fresh) input and sends the output to the next rank;
* at a backward tick it recomputes the stage from the stashed *input*
  (stage-granularity activation checkpointing, as the JAX package's
  ``jax.vjp`` remat) and differentiates it with ``torch.autograd.grad`` --
  against the loss's gradient on the last stage, the cotangent that
  arrived from the next rank elsewhere -- and sends the input's cotangent
  to the previous rank;
* the tick's sends and the next tick's receives (``_arrival_tables``) go
  out as one ``batch_isend_irecv``, so every pairing is posted together.

The stash holds the inputs awaiting their backward; its size never exceeds
``peak_in_flight`` (asserted).
"""

import functools

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .pipeline import _Axis, _plain

__all__ = ["pipeline_train_1f1b", "onef_oneb_ticks", "peak_in_flight",
           "module_stages", "load_module_grads"]

_IDLE, _FWD, _BWD = 0, 1, 2


@functools.lru_cache(maxsize=None)
def _schedule(n_micro: int, n_stages: int):
    """Static 1F1B schedule -> (action, mb) int arrays of shape (ticks, P).

    Greedy simulation under the 1F1B policy: device d runs ``min(P-d, M)``
    warmup forwards, then takes a backward whenever one is ready, else a
    forward (capped at P in flight).  Dependencies model the ring latency:
    a block's upstream product must exist at a strictly earlier tick."""
    M, Pn = n_micro, n_stages
    next_f, next_b = [0] * Pn, [0] * Pn
    f_done = [[-1] * M for _ in range(Pn)]   # tick fwd(d, m) ran
    b_done = [[-1] * M for _ in range(Pn)]   # tick bwd(d, m) ran
    actions, mbs = [], []
    t = 0
    while any(b < M for b in next_b):
        assert t <= 4 * (M + Pn), "1F1B schedule failed to converge"
        row_a, row_m = [], []
        for d in range(Pn):
            mf, mb = next_f[d], next_b[d]
            can_f = mf < M and (d == 0 or 0 <= f_done[d - 1][mf] < t)
            can_b = mb < M and (
                (d == Pn - 1 and 0 <= f_done[d][mb] < t)
                or (d < Pn - 1 and 0 <= b_done[d + 1][mb] < t)
            )
            in_flight = mf - mb
            warmup = min(Pn - d, M)
            if mf < warmup and can_f:
                a, m = _FWD, mf
            elif can_b:
                a, m = _BWD, mb
            elif can_f and in_flight < Pn:
                a, m = _FWD, mf
            else:
                a, m = _IDLE, 0
            row_a.append(a)
            row_m.append(m)
        # commit the whole tick at once (same-tick products are not visible)
        for d, (a, m) in enumerate(zip(row_a, row_m)):
            if a == _FWD:
                f_done[d][m] = t
                next_f[d] += 1
            elif a == _BWD:
                b_done[d][m] = t
                next_b[d] += 1
        actions.append(row_a)
        mbs.append(row_m)
        t += 1
    return np.asarray(actions, np.int32), np.asarray(mbs, np.int32)


@functools.lru_cache(maxsize=None)
def _arrival_tables(n_micro: int, n_stages: int):
    """Per-tick ring arrivals -> (f_arr, b_arr), shape (ticks, P), entry m
    if an activation (resp. cotangent) for microbatch m lands on device d at
    tick t (sent by the neighbor at t-1), else -1.

    A device may consume an arrival ticks later (1F1B delays forwards past
    backwards), and the ring register is overwritten every tick -- so the
    runtime loop banks arrivals into the stash the tick they land, keyed by
    these tables."""
    action, mb = _schedule(n_micro, n_stages)
    ticks = action.shape[0]
    f_arr = -np.ones((ticks, n_stages), np.int32)
    b_arr = -np.ones((ticks, n_stages), np.int32)
    for t in range(1, ticks):
        for d in range(n_stages):
            if d > 0 and action[t - 1, d - 1] == _FWD:
                f_arr[t, d] = mb[t - 1, d - 1]
            if d < n_stages - 1 and action[t - 1, d + 1] == _BWD:
                b_arr[t, d] = mb[t - 1, d + 1]
    # slot-reuse safety: between an arrival and its consuming block, no other
    # microbatch may map to the same (stash, slot)
    n_slots = min(n_stages, n_micro)
    for arr, consume_act in ((f_arr, _FWD), (b_arr, _BWD)):
        for d in range(n_stages):
            live = {}  # slot -> m
            for t in range(ticks):
                m = arr[t, d]
                if m >= 0:
                    s = m % n_slots
                    assert live.get(s, m) == m, (
                        f"stash slot collision d={d} t={t}")
                    live[s] = m
                if action[t, d] == consume_act:
                    live.pop(mb[t, d] % n_slots, None)
    return f_arr, b_arr


def onef_oneb_ticks(n_micro: int, n_stages: int) -> int:
    """Schedule length in block-ticks (~ 2*(M + P - 1) + interleave slack)."""
    return _schedule(n_micro, n_stages)[0].shape[0]


def peak_in_flight(n_micro: int, n_stages: int) -> int:
    """Max simultaneously-stashed activations on any device (<= P)."""
    action, mb = _schedule(n_micro, n_stages)
    peak, cur = 0, [0] * n_stages
    for t in range(action.shape[0]):
        for d in range(n_stages):
            if action[t, d] == _FWD:
                cur[d] += 1
            elif action[t, d] == _BWD:
                cur[d] -= 1
        peak = max(peak, max(cur))
    return peak



def _walk(stage_fn, loss_fn, chunks, xs, ys, ax, V, ticks, act, arr_f, arr_b,
          peak):
    """Walk this rank's row of a 1F1B table.

    ``chunks`` [param tree of chunk c] (leaves requiring grad); ``act(t)``
    -> (action, chunk, microbatch); ``arr_f(t)`` / ``arr_b(t)`` -> (chunk,
    microbatch) of the activation / cotangent landing at tick t, or None.
    Returns (this rank's summed loss share, [grads of chunk c's leaves])."""
    d, last = ax.d, ax.n - 1
    inv_m = 1.0 / xs.shape[0]
    leaves = [pytree.tree_flatten(p)[0] for p in chunks]
    grads = [[torch.zeros_like(t) for t in ls] for ls in leaves]
    stash, cots = {}, {}
    loss = torch.zeros((), dtype=torch.float32, device=xs.device)
    in_flight = 0
    for t in range(ticks):
        a, c, m = act(t)
        first, end = d == 0 and c == 0, d == last and c == V - 1
        sends = []
        if a == _FWD:
            x = xs[m] if first else stash[c, m]
            with torch.no_grad():
                y = stage_fn(chunks[c], x)
            stash[c, m] = x            # kept for the backward's recompute
            in_flight += 1
            assert in_flight <= peak, (in_flight, peak)
            if not end:
                sends.append((y, d + 1))
        elif a == _BWD:
            x = stash.pop((c, m)).detach().requires_grad_(True)
            in_flight -= 1
            with torch.enable_grad():
                y = stage_fn(chunks[c], x)
                if end:
                    out = loss_fn(y, ys[m]) * inv_m
                    loss = loss + out.detach().float()
                    got = torch.autograd.grad(out, [x, *leaves[c]],
                                              allow_unused=True)
                else:
                    got = torch.autograd.grad(y, [x, *leaves[c]],
                                              cots.pop((c, m)),
                                              allow_unused=True)
            for g, dg in zip(grads[c], got[1:]):
                if dg is not None:
                    g += dg
            if not first:
                sends.append((got[0], d - 1))
        recvs = []
        if t + 1 < ticks:
            for arr, into, src in ((arr_f, stash, d - 1), (arr_b, cots, d + 1)):
                key = arr(t + 1)
                if key is not None:
                    into[key] = torch.empty_like(xs[0])
                    recvs.append((into[key], src))
        ax.exchange(sends, recvs)
    return loss, grads


def _stage_params(stacked_params, ax, V):
    """This rank's chunks of a stacked tree: leaves ``(P, ...)`` (V == 1)
    or ``(P, V, ...)``, ``DTensor``s sharded over the axis or whole;
    detached leaves that require grad."""
    leaves, treedef = pytree.tree_flatten(stacked_params)
    mine = [(t.to_local()[0] if hasattr(t, "to_local") else t[ax.d])
            .detach().requires_grad_(True) for t in leaves]
    if V == 1:
        return [pytree.tree_unflatten(mine, treedef)], leaves, treedef
    return [pytree.tree_unflatten([t[c] for t in mine], treedef)
            for c in range(V)], leaves, treedef


def _grads_out(grads, leaves, treedef, ax, V):
    """The gradient tree in the stacked layout, each leaf a ``DTensor``
    sharded over the pipeline axis (this rank's stage slot)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = ax.mesh
    pl = [Shard(0) if n == ax.name else Replicate()
          for n in mesh.mesh_dim_names]
    out = []
    for i, leaf in enumerate(leaves):
        g = grads[0][i] if V == 1 else torch.stack([grads[c][i]
                                                    for c in range(V)])
        out.append(DTensor.from_local(g[None].to(leaf.dtype), mesh, pl,
                                      run_check=False))
    return pytree.tree_unflatten(out, treedef)


def pipeline_train_1f1b(stage_fn, loss_fn, stacked_params, x_micro, y_micro,
                        mesh, axis: str = "pp"):
    """One pipeline-parallel training step under the 1F1B schedule.

    stage_fn        -- ``(params, x) -> y``, ``y.shape == x.shape``
    loss_fn         -- ``(y_last, target) -> scalar`` (per-microbatch)
    stacked_params  -- tree, leaves ``(P, ...)``: ``DTensor``s sharded over
                       ``axis``, or whole on every rank
    x_micro         -- ``(n_micro, mb, ...)`` inputs, the same on every rank
    y_micro         -- ``(n_micro, ...)`` per-microbatch targets, likewise
    returns         -- ``(loss, grads)``: the mean microbatch loss (every
                       rank) and d(loss)/d(stacked_params) in the stacked
                       layout, ``DTensor``s sharded over ``axis``.
    """
    ax = _Axis(mesh, axis)
    xs, ys = _plain(x_micro), _plain(y_micro)
    M, P = xs.shape[0], ax.n
    action, mb = _schedule(M, P)
    f_arr, b_arr = _arrival_tables(M, P)
    d = ax.d
    chunks, leaves, treedef = _stage_params(stacked_params, ax, 1)

    def arrival(tab):
        return lambda t: (0, int(tab[t, d])) if tab[t, d] >= 0 else None

    loss, grads = _walk(
        stage_fn, loss_fn, chunks, xs, ys, ax, 1, action.shape[0],
        lambda t: (int(action[t, d]), 0, int(mb[t, d])),
        arrival(f_arr), arrival(b_arr), peak_in_flight(M, P))
    ax.all_reduce(loss)
    return loss, _grads_out(grads, leaves, treedef, ax, 1)


# ---------------------------------------------------------------------------
# nn.Module blocks as stages
# ---------------------------------------------------------------------------
class _TapeStage(torch.autograd.Function):
    """A lightgrad tape block as a ``torch.autograd`` function of its input
    and parameters: the forward runs the block's tape ops with its
    parameters' buffers swapped for the given ones; the backward runs them
    again with the tape recording and backpropagates the cotangent through
    the tape (so the block's kernels, not torch autograd, differentiate
    it).  The block's own parameter gradients are scratch here:
    ``load_module_grads`` writes the final ones."""

    @staticmethod
    def forward(ctx, proto, names, x, *ps):
        ctx.proto, ctx.names = proto, names
        ctx.save_for_backward(x, *ps)
        return _tape_run(proto, names, x, ps, None)[0]

    @staticmethod
    def backward(ctx, g):
        x, *ps = ctx.saved_tensors
        _, gx, gps = _tape_run(ctx.proto, ctx.names, x, ps, g)
        return (None, None, gx, *gps)


def _tape_run(proto, names, x, ps, g):
    """Run tape block ``proto`` on ``x`` with parameters ``ps``; with a
    cotangent ``g``, also backpropagate it: (out, dx, [dp])."""
    from ..autograd import Gradients, Tensor

    params = dict(proto.named_parameters())
    old = [(p, p.data) for p in params.values()]
    try:
        for n, p in zip(names, ps):
            params[n]._set_data(p.detach())
        if g is None:
            with Gradients.no_grad():
                out = proto(Tensor(x.detach(), requires_grad=False))
            return out.data, None, None
        for p in params.values():
            p.zero_grad()
        xt = Tensor(x.detach(), requires_grad=True)
        out = proto(xt)
        Gradients.backward(out.ctx, Tensor(g, requires_grad=False))
        return (out.data, xt.grad.data,
                [params[n].grad.data for n in names])
    finally:
        for p, data in old:
            p._set_data(data)


def _block_fn(proto):
    """``(params {name: tensor}, x) -> y`` of block ``proto``: a
    ``torch.nn.Module`` through ``functional_call``, a tape module through
    :class:`_TapeStage`."""
    names = [n for n, _ in proto.named_parameters()]
    if isinstance(proto, torch.nn.Module):
        return lambda params, x: torch.func.functional_call(
            proto, params, (x,))
    return lambda params, x: _TapeStage.apply(
        proto, names, x, *[params[n] for n in names])


def _stack_blocks(blocks):
    names = [n for n, _ in blocks[0].named_parameters()]
    per_block = []
    for b in blocks:
        d = dict(b.named_parameters())
        assert list(d) == names, \
            "pipeline blocks must be structurally identical"
        per_block.append({n: (t if isinstance(t, torch.Tensor) else t.data)
                          .detach() for n, t in d.items()})
    return names, per_block


def module_stages(blocks):
    """Bridge a list of P structurally identical blocks -- ``torch.nn``
    modules or lightgrad tape modules -- to the ``(stage_fn,
    stacked_params)`` contract of :func:`pipeline_train_1f1b`: the stage
    function runs ``blocks[0]`` with the given parameters, the stacked
    tree is ``{name: (P, ...)}``.  Blocks must be dropout-free (eval)."""
    names, per_block = _stack_blocks(blocks)
    stacked = {n: torch.stack([pb[n] for pb in per_block]) for n in names}
    return _block_fn(blocks[0]), stacked


def _set_grad(p, g):
    if isinstance(p, torch.Tensor):
        p.grad = g.to(p.dtype).clone()
    else:
        from ..autograd import Tensor

        p.zero_grad()
        p.add_grad(Tensor(g.to(p.dtype), requires_grad=False))


def load_module_grads(blocks, grads):
    """Write stacked 1F1B grads {name: (P, ...)} (``DTensor``s or whole)
    back onto each block's parameter gradients, so existing optimizers
    drive the update."""
    whole = {n: _plain(g) for n, g in grads.items()}
    for i, b in enumerate(blocks):
        for n, p in b.named_parameters():
            _set_grad(p, whole[n][i])
