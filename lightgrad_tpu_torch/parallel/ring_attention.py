"""Ring attention: exact attention over a sequence-sharded mesh axis.

Counterpart of ``lightgrad_tpu/parallel/ring_attention.py``.  K/V chunks
stay sharded and *rotate* around the ``sp`` ring (one neighbour hop a
round, ``dist.batch_isend_irecv``, the JAX package's ``ppermute``), while
each rank's resident Q attends to every chunk; the rounds' normalised
partials merge by their log-sum-exp in float32 (the blockwise / ring
attention scheme, Liu et al., 2023).

Each round is one ``flash_block`` (ops/attention.py, the JAX package's
kernel 10): a (Q, K/V chunk) flash pass returning (out, lse).  Causal
masking uses the ring's structure: round 0 holds the rank's own chunk
(the causal diagonal); a later round holds a chunk strictly before the
resident rows (full attention) or strictly after (skipped: it launches
nothing and contributes nothing, the JAX package's ``lax.cond``), so a
causal ring does about half the work of a full one.  The next hop is
posted before a round's block runs, so the transfer overlaps it.

The backward is written by hand (JAX takes it as the VJP of ``ppermute``,
which PyTorch does not transpose).  The merge's cotangent gives each round
its block's cotangents: ``w_r g`` for its output and ``w_r (g . out_r -
g . out)`` for its lse (``w_r = exp(lse_r - lse)``), and
``flash_block_bwd`` takes both.  dq accumulates on the rank; the visiting
chunk's dk / dv (f32) travel with K/V and reach their owner after exactly
``ring_size`` hops.  Skipped causal rounds still pass K/V and the buffers
along.  The JAX package's ``block=`` switch ("pallas" / "xla") has no
counterpart: dispatch is by device, so the block is always ``flash_block``
(its kernel on the card, its plain version on the CPU).

:func:`ring_attention` works on local ``(B, s_local, D)`` shards inside a
process group; :func:`ring_attention_sharded` takes ``DTensor``s sharded
on S over a mesh axis and returns one.  The tape op ``ring_attention``
(autograd/cuda/ops.py) calls the same two halves, and
:func:`ring_local` runs every rank's rounds on one device (the ring's call
pattern where there is one card).
"""

from math import prod

import torch
import torch.distributed as dist

from ..ops.attention import flash_block_bwd, flash_block_fwd
from .mesh import axis_group, axis_size

__all__ = ["ring_attention", "ring_attention_sharded", "ring_local"]


class _Ring:
    """A ring's shape: the group, its size and this rank's place."""

    def __init__(self, group, ring_size):
        self.group = group if group is not None else dist.group.WORLD
        self.n = int(ring_size if ring_size is not None
                     else dist.get_world_size(group))
        self.me = dist.get_rank(group) if self.n > 1 else 0
        if self.n > 1:
            self.next = dist.get_global_rank(group, (self.me + 1) % self.n)
            self.prev = dist.get_global_rank(group, (self.me - 1) % self.n)

    def hop(self, *ts):
        """Post sends of ``ts`` to the next rank and receives of as many
        from the previous one; returns (received buffers, requests)."""
        bufs = [torch.empty_like(t) for t in ts]
        ops = [dist.P2POp(dist.isend, t.contiguous(), self.next, self.group)
               for t in ts]
        ops += [dist.P2POp(dist.irecv, b, self.prev, self.group)
                for b in bufs]
        return bufs, dist.batch_isend_irecv(ops)

    def src(self, r):
        return (self.me - r) % self.n

    def runs(self, r, causal):
        """Whether round ``r``'s chunk contributes (not strictly later)."""
        return not causal or r == 0 or self.src(r) < self.me


def _wait(reqs):
    for q in reqs:
        q.wait()


def _merge(acc, lse, out_r, lse_r):
    """Online-softmax combine of two normalised (out, lse) partials, f32."""
    if acc is None:
        return out_r.float(), lse_r
    new = torch.logaddexp(lse, lse_r)
    return (acc * torch.exp(lse - new) + out_r.float() * torch.exp(lse_r - new),
            new)


def _cotangents(parts, lse, g):
    """The merge's cotangent split over the rounds: each kept round's
    weight ``w_r = exp(lse_r - lse)`` and ``rowsum(g . out_r)``, and their
    weighted sum ``rowsum(g . out)``."""
    g32 = g.float()
    w = [None if p is None else torch.exp(p[1] - lse) for p in parts]
    dots = [None if p is None else (g32 * p[0].float()).sum(-1, keepdim=True)
            for p in parts]
    total = sum(wr * d for wr, d in zip(w, dots) if wr is not None)
    return g32, w, dots, total


def _round_bwd(g, g32, w, dot, total, q, kr, vr, part, scale, diag):
    """(dq, dk, dv) of one kept round: its block's backward for the output
    cotangent ``w g`` and the lse cotangent ``w (g . out_r - g . out)``."""
    out_r, lse_r = part
    gr = (w * g32).to(g.dtype).contiguous()
    glse = (w * (dot - total)).contiguous()
    return flash_block_bwd(gr, glse, q, kr, vr, out_r, lse_r, scale, diag)


def _ring_fwd(ring, q, k, v, scale, causal):
    """(out, residuals): the merged output of every round and what the
    backward needs -- each round's (out_r, lse_r), or None where skipped."""
    parts = []
    acc = lse = None
    kr, vr = k, v
    for r in range(ring.n):
        pending = ring.hop(kr, vr) if r < ring.n - 1 else None
        part = None
        if ring.runs(r, causal):
            part = flash_block_fwd(q, kr, vr, scale, causal and r == 0)
            acc, lse = _merge(acc, lse, *part)
        parts.append(part)
        if pending is not None:
            (kr, vr), reqs = pending
            _wait(reqs)
    return acc.to(q.dtype), (parts, lse)


def _ring_bwd(ring, g, q, k, v, res, scale, causal):
    """(dq, dk, dv) from the output cotangent ``g``."""
    parts, lse = res
    g32, w, dots, total = _cotangents(parts, lse, g)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kr, vr = k, v
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for r in range(ring.n):
        pending = ring.hop(kr, vr) if r < ring.n - 1 else None
        if parts[r] is not None:
            dq_r, dk_r, dv_r = _round_bwd(g, g32, w[r], dots[r], total, q,
                                          kr, vr, parts[r], scale,
                                          causal and r == 0)
            dq += dq_r.float()
            dk += dk_r.float()
            dv += dv_r.float()
        if ring.n > 1:
            # the visiting chunk's gradients travel with it: after the
            # last round's hop they are home
            (dk, dv), reqs = ring.hop(dk, dv)
            _wait(reqs)
        if pending is not None:
            (kr, vr), reqs = pending
            _wait(reqs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ring_local(q, k, v, g, scale: float, n: int, causal: bool = False):
    """Every rank's rounds of an ``n``-rank ring on one device: the sequence
    of ``(B, S, D)`` q, k, v cut into n chunks, rank i's resident chunk
    meeting chunk ``(i - r) mod n`` at round r -- the causal diagonal,
    full earlier chunks, skipped later ones, the lse merge -- through the
    same per-round code as :func:`ring_attention`, without the hops.
    Returns the output and (dq, dk, dv) for its cotangent ``g``, each of
    the whole sequence."""
    s = q.shape[-2] // n

    def cut(t):
        return [t[..., i * s:(i + 1) * s, :].contiguous() for i in range(n)]

    qs, ks, vs, gs = cut(q), cut(k), cut(v), cut(g)
    outs, dqs = [], []
    dks = [torch.zeros(c.shape, dtype=torch.float32, device=c.device)
           for c in ks]
    dvs = [torch.zeros_like(d) for d in dks]
    for me in range(n):
        src = [(me - r) % n for r in range(n)]
        keep = [not causal or r == 0 or src[r] < me for r in range(n)]
        parts, acc, lse = [], None, None
        for r in range(n):
            part = flash_block_fwd(qs[me], ks[src[r]], vs[src[r]], scale,
                                   causal and r == 0) if keep[r] else None
            if part is not None:
                acc, lse = _merge(acc, lse, *part)
            parts.append(part)
        outs.append(acc.to(q.dtype))
        g32, w, dots, total = _cotangents(parts, lse, gs[me])
        dq = torch.zeros(qs[me].shape, dtype=torch.float32, device=q.device)
        for r in range(n):
            if parts[r] is not None:
                dq_r, dk_r, dv_r = _round_bwd(
                    gs[me], g32, w[r], dots[r], total, qs[me], ks[src[r]],
                    vs[src[r]], parts[r], scale, causal and r == 0)
                dq += dq_r.float()
                dks[src[r]] += dk_r.float()
                dvs[src[r]] += dv_r.float()
        dqs.append(dq.to(q.dtype))
    cat = lambda ts: torch.cat(ts, -2)      # noqa: E731
    return (cat(outs), cat(dqs), cat(dks).to(k.dtype),
            cat(dvs).to(v.dtype))


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, ring, causal):
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, res = _ring_fwd(ring, q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v)
        ctx.res, ctx.scale, ctx.ring, ctx.causal = res, scale, ring, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        grads = _ring_bwd(ctx.ring, g.contiguous(), q, k, v, ctx.res,
                          ctx.scale, ctx.causal)
        return (*grads, None, None, None)


def ring_attention(q, k, v, scale: float, group=None, causal: bool = False,
                   ring_size: int = None):
    """Exact softmax attention with q/k/v sharded on the sequence axis.

    Args (this rank's shards): q, k, v ``(B, s_local, D)`` -- B folds
    batch * heads; ``group`` the process group of the ring (default: the
    world), its ranks holding the sequence's chunks in order;
    ``ring_size`` its size (default: the group's).  Differentiable in q,
    k and v by ``torch.autograd``.  Returns ``(B, s_local, D)``."""
    ring = _Ring(group, ring_size)
    return _RingAttention.apply(q, k, v, float(scale), ring, bool(causal))


# ---------------------------------------------------------------------------
# over DTensors
# ---------------------------------------------------------------------------
def _ring_placements(x, mesh, axis, batch_axis):
    """S (dim -2) sharded over ``axis``, the batch over ``batch_axis``; a
    leading dim another mesh dim already shards (heads over tp) stays so;
    everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    nd = x.ndim
    have = getattr(x, "placements", None) or [Replicate()] * mesh.ndim
    out = []
    for m, name in enumerate(mesh.mesh_dim_names):
        p = have[m]
        if name == axis:
            out.append(Shard(nd - 2))
        elif name == batch_axis:
            out.append(Shard(0))
        elif p.is_shard() and p.dim < nd - 2:
            out.append(p)
        else:
            out.append(Replicate())
    return out


def _locals(q, k, v, mesh, axis, batch_axis):
    """q, k, v as DTensors placed for the ring, and their local shards
    folded to (B, s_local, D)."""
    from torch.distributed.tensor import DTensor, Replicate

    out = []
    for t in (q, k, v):
        want = _ring_placements(t, mesh, axis, batch_axis)
        if not isinstance(t, DTensor):      # a whole array on every rank
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(t.placements) != tuple(want):
            t = t.redistribute(mesh, want)
        out.append(t)
    return out


def _fold(t):
    return t.reshape(prod(t.shape[:-2]), t.shape[-2], t.shape[-1])


def ring_attention_sharded(q, k, v, scale: float, mesh, axis: str = "sp",
                           causal: bool = False, batch_axis: str = None):
    """Ring attention over ``mesh[axis]`` for ``(..., S, D)`` ``DTensor``s
    whose S axis is (or is redistributed to be) sharded on ``axis``.
    Leading axes fold into one batch dim, optionally sharded on
    ``batch_axis`` (e.g. 'dp').  Differentiable by ``torch.autograd``.
    Returns a ``DTensor`` placed as q."""
    from torch.distributed.tensor import DTensor

    q, k, v = _locals(q, k, v, mesh, axis, batch_axis)
    lq, lk, lv = (t.to_local() for t in (q, k, v))
    ring = _Ring(axis_group(mesh, axis), axis_size(mesh, axis))
    out = _RingAttention.apply(_fold(lq), _fold(lk), _fold(lv), float(scale),
                               ring, bool(causal))
    return DTensor.from_local(out.reshape(lq.shape), mesh, q.placements,
                              run_check=False)


def ring_sharded_fwd(q, k, v, scale, mesh, axis="sp", causal=False,
                     batch_axis=None):
    """The tape op's forward (no torch autograd): (out DTensor, state)."""
    from torch.distributed.tensor import DTensor

    q, k, v = _locals(q, k, v, mesh, axis, batch_axis)
    lq, lk, lv = (_fold(t.to_local()).contiguous() for t in (q, k, v))
    ring = _Ring(axis_group(mesh, axis), axis_size(mesh, axis))
    out, res = _ring_fwd(ring, lq, lk, lv, float(scale), bool(causal))
    shape = q.to_local().shape
    state = (ring, (lq, lk, lv), res, (q, k, v), float(scale), bool(causal))
    return DTensor.from_local(out.reshape(shape), mesh, q.placements,
                              run_check=False), state


def ring_sharded_bwd(g, state):
    """The tape op's backward: (dq, dk, dv) DTensors placed as the
    forward's q, k and v."""
    from torch.distributed.tensor import DTensor

    ring, (lq, lk, lv), res, (q, k, v), scale, causal = state
    mesh = q.device_mesh
    if not isinstance(g, DTensor):
        g = DTensor.from_local(g, mesh, q.placements, run_check=False)
    if tuple(g.placements) != tuple(q.placements):
        g = g.redistribute(mesh, q.placements)
    lg = _fold(g.to_local()).contiguous()
    grads = _ring_bwd(ring, lg, lq, lk, lv, res, scale, causal)
    return tuple(DTensor.from_local(d.reshape(t.to_local().shape), mesh,
                                    t.placements, run_check=False)
                 for d, t in zip(grads, (q, k, v)))
