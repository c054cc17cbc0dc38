"""Interleaved-1F1B: virtual-stage chunking under the 1F1B memory schedule.

Counterpart of ``lightgrad_tpu/parallel/pipeline_1f1b_interleaved.py``.
Virtual stage ``s = c*P + d`` lives on rank ``d = s % P`` as chunk
``c = s // P`` (Megatron round-robin), so every s -> s+1 activation hop
and s -> s-1 cotangent hop goes to the physical neighbour on the ring
(the last rank's chunk c feeds rank 0's chunk c+1).

The schedule is the JAX package's, simulated on the host and copied here:
greedy, prefer a ready backward (deepest virtual stage first), else the
lowest-pending ready forward, with per-virtual-stage in-flight capped at
the stash depth.  Each rank walks the tables as in
``pipeline_1f1b.pipeline_train_1f1b``, its stash keyed by (chunk,
microbatch).
"""

import functools

import numpy as np
import torch

from .pipeline import _Axis, _plain
from .pipeline_1f1b import _grads_out, _walk

__all__ = ["pipeline_train_1f1b_interleaved", "interleaved_ticks",
           "interleaved_peak_in_flight", "module_stages_interleaved",
           "load_module_grads_interleaved"]

_IDLE, _FWD, _BWD = 0, 1, 2


@functools.lru_cache(maxsize=None)
def _schedule_v(n_micro: int, n_stages: int, n_chunks: int):
    """Static interleaved-1F1B tables, each (ticks, P): action, microbatch,
    chunk.  One block per device per tick; dependencies honor the ring
    latency (a product sent at t is usable at t+1, i.e. strictly-earlier
    completion)."""
    M, Pn, V = n_micro, n_stages, n_chunks
    S = Pn * V
    n_slots = min(Pn, M)
    next_f, next_b = [0] * S, [0] * S
    f_done = [[-1] * M for _ in range(S)]
    b_done = [[-1] * M for _ in range(S)]
    actions, mbs, chunks = [], [], []
    t = 0
    while any(b < M for b in next_b):
        assert t <= 6 * (M * V + S) + 16, "interleaved-1F1B failed to converge"
        row_a, row_m, row_c = [], [], []
        for d in range(Pn):
            stages = list(range(d, S, Pn))  # this device's virtual stages
            pick = (_IDLE, 0, 0)
            # ready backward, deepest virtual stage first (drains memory)
            for s in sorted(stages, reverse=True):
                mb = next_b[s]
                if mb >= M:
                    continue
                ready = (
                    (s == S - 1 and 0 <= f_done[s][mb] < t)
                    or (s < S - 1 and 0 <= b_done[s + 1][mb] < t)
                )
                if ready:
                    pick = (_BWD, mb, s // Pn)
                    break
            if pick[0] == _IDLE:
                # ready forward: smallest pending microbatch, then shallowest
                # stage (keeps chunk-0 streaming while later chunks fill)
                best = None
                for s in stages:
                    mf = next_f[s]
                    if mf >= M or next_f[s] - next_b[s] >= n_slots:
                        continue
                    if s > 0 and not (0 <= f_done[s - 1][mf] < t):
                        continue
                    key = (mf, s)
                    if best is None or key < best[0]:
                        best = (key, s, mf)
                if best is not None:
                    _, s, mf = best
                    pick = (_FWD, mf, s // Pn)
            row_a.append(pick[0])
            row_m.append(pick[1])
            row_c.append(pick[2])
        for d, (a, m, c) in enumerate(zip(row_a, row_m, row_c)):
            s = c * Pn + d
            if a == _FWD:
                f_done[s][m] = t
                next_f[s] += 1
            elif a == _BWD:
                b_done[s][m] = t
                next_b[s] += 1
        actions.append(row_a)
        mbs.append(row_m)
        chunks.append(row_c)
        t += 1
    return (np.asarray(actions, np.int32), np.asarray(mbs, np.int32),
            np.asarray(chunks, np.int32))


@functools.lru_cache(maxsize=None)
def _arrival_tables_v(n_micro: int, n_stages: int, n_chunks: int):
    """Ring arrivals -> (f_m, f_c, b_m, b_c), each (ticks, P): microbatch and
    chunk landing on device d at tick t (-1 = nothing).  Asserts stash-slot
    safety per (device, chunk)."""
    action, mb, ch = _schedule_v(n_micro, n_stages, n_chunks)
    Pn, V = n_stages, n_chunks
    ticks = action.shape[0]
    f_m = -np.ones((ticks, Pn), np.int32)
    f_c = np.zeros((ticks, Pn), np.int32)
    b_m = -np.ones((ticks, Pn), np.int32)
    b_c = np.zeros((ticks, Pn), np.int32)
    for t in range(1, ticks):
        for d in range(Pn):
            src = (d - 1) % Pn
            if action[t - 1, src] == _FWD:
                c = ch[t - 1, src]
                # (c, P-1) -> (c+1, 0); the last virtual stage's output is
                # not consumed by anyone
                cc = c + 1 if src == Pn - 1 else c
                if d != 0 or src == Pn - 1:
                    if not (src == Pn - 1 and c == V - 1):
                        f_m[t, d] = mb[t - 1, src]
                        f_c[t, d] = cc
            srcb = (d + 1) % Pn
            if action[t - 1, srcb] == _BWD:
                c = ch[t - 1, srcb]
                cc = c - 1 if srcb == 0 else c
                if not (srcb == 0 and c == 0):  # stage 0's dx is discarded
                    b_m[t, d] = mb[t - 1, srcb]
                    b_c[t, d] = cc
    # slot-reuse safety per (device, chunk)
    n_slots = min(Pn, n_micro)
    for (arr_m, arr_c), consume in (((f_m, f_c), _FWD), ((b_m, b_c), _BWD)):
        for d in range(Pn):
            live = {}  # (chunk, slot) -> m
            for t in range(ticks):
                m = arr_m[t, d]
                if m >= 0:
                    key = (arr_c[t, d], m % n_slots)
                    assert live.get(key, m) == m, (
                        f"stash collision d={d} t={t} {key}")
                    live[key] = m
                if action[t, d] == consume:
                    live.pop((ch[t, d], mb[t, d] % n_slots), None)
    return f_m, f_c, b_m, b_c


def interleaved_ticks(n_micro: int, n_stages: int, n_chunks: int) -> int:
    return _schedule_v(n_micro, n_stages, n_chunks)[0].shape[0]


def interleaved_peak_in_flight(n_micro: int, n_stages: int, n_chunks: int) -> int:
    """Max simultaneously-stashed activations on any device (all chunks)."""
    action, mb, ch = _schedule_v(n_micro, n_stages, n_chunks)
    peak, cur = 0, [0] * n_stages
    for t in range(action.shape[0]):
        for d in range(n_stages):
            if action[t, d] == _FWD:
                cur[d] += 1
            elif action[t, d] == _BWD:
                cur[d] -= 1
        peak = max(peak, max(cur))
    return peak



def pipeline_train_1f1b_interleaved(stage_fn, loss_fn, stacked_params,
                                    x_micro, y_micro, mesh, axis: str = "pp",
                                    n_chunks: int = 2):
    """One interleaved-1F1B pipeline training step.

    stage_fn        -- ``(params, x) -> y``, ``y.shape == x.shape``
    loss_fn         -- ``(y_last, target) -> scalar`` (per-microbatch)
    stacked_params  -- tree, leaves ``(P, V, ...)`` sharded over ``axis``
                       on dim 0 (or whole); virtual stage ``c*P + d`` uses
                       ``leaf[d, c]``
    x_micro         -- ``(n_micro, mb, ...)`` inputs, the same on every rank
    y_micro         -- ``(n_micro, ...)`` per-microbatch targets, likewise
    returns         -- ``(loss, grads)`` with grads in the same (P, V, ...)
                       layout, ``DTensor``s sharded over ``axis``.
    """
    from .pipeline_1f1b import _stage_params

    ax = _Axis(mesh, axis)
    xs, ys = _plain(x_micro), _plain(y_micro)
    M, P, V = xs.shape[0], ax.n, n_chunks
    action, mb, ch = _schedule_v(M, P, V)
    f_m, f_c, b_m, b_c = _arrival_tables_v(M, P, V)
    d = ax.d
    chunks, leaves, treedef = _stage_params(stacked_params, ax, V)

    def arrival(tm, tc):
        return lambda t: ((int(tc[t, d]), int(tm[t, d])) if tm[t, d] >= 0
                          else None)

    loss, grads = _walk(
        stage_fn, loss_fn, chunks, xs, ys, ax, V, action.shape[0],
        lambda t: (int(action[t, d]), int(ch[t, d]), int(mb[t, d])),
        arrival(f_m, f_c), arrival(b_m, b_c),
        interleaved_peak_in_flight(M, P, V))
    ax.all_reduce(loss)
    return loss, _grads_out(grads, leaves, treedef, ax, V)


def module_stages_interleaved(blocks, n_stages: int, n_chunks: int):
    """Bridge P*V structurally identical blocks to the ``(stage_fn,
    stacked_params)`` contract of :func:`pipeline_train_1f1b_interleaved`:
    ``blocks[s]`` is virtual stage s (model order), on rank ``s % P`` as
    chunk ``s // P``, so the stacked leaves are (P, V, ...) with
    ``leaf[d, c] = blocks[c*P + d]``."""
    from .pipeline_1f1b import _block_fn, _stack_blocks

    Pn, V = n_stages, n_chunks
    assert len(blocks) == Pn * V, (len(blocks), Pn, V)
    names, per_block = _stack_blocks(blocks)
    stacked = {n: torch.stack([torch.stack([per_block[c * Pn + d][n]
                                            for c in range(V)])
                               for d in range(Pn)]) for n in names}
    return _block_fn(blocks[0]), stacked


def load_module_grads_interleaved(blocks, grads, n_stages: int,
                                  n_chunks: int):
    """Write stacked (P, V, ...) grads back onto each block's gradients."""
    from .pipeline_1f1b import _set_grad

    whole = {n: _plain(g) for n, g in grads.items()}
    for s, b in enumerate(blocks):
        d, c = s % n_stages, s // n_stages
        for n, p in b.named_parameters():
            _set_grad(p, whole[n][d, c])
