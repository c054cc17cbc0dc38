"""Pipeline parallelism: GPipe-style microbatch schedule over a mesh axis.

Counterpart of ``lightgrad_tpu/parallel/pipeline.py``.  Each rank of the
``pp`` axis owns one stage's parameters (the leading axis of the stacked
parameter tree, sharded over ``pp``).  Microbatches enter at stage 0 and
activations hop stage to stage by point-to-point sends on the axis's
process group; the last stage's outputs are broadcast back to every rank
(the JAX package's ``psum``).  Every stage maps activations of one shape
to the same shape -- the transformer-block case.

The JAX package differentiates the schedule with ``jax.grad`` (the
transpose of ``ppermute`` is the reverse hop).  Here the schedule is a
``torch.autograd.Function``: its backward walks the stages in reverse,
recomputing each stage from its stashed input and sending the input's
cotangent to the previous stage, so ``torch.autograd`` differentiates a
loss of the outputs with respect to the stacked parameters.  Each rank's
gradient fills its own stage's slot: a stacked tree given as ``DTensor``s
sharded over ``pp`` gets a gradient sharded the same way; one given whole
on every rank gets its slots summed over the axis.
"""

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .mesh import axis_group, axis_rank, axis_size

__all__ = ["pipeline_apply", "pipeline_apply_interleaved", "interleaved_ticks",
           "gpipe_ticks"]


class _Axis:
    """The pipeline axis of a mesh: its group, size and this rank's place,
    and the global ranks of the neighbours."""

    def __init__(self, mesh, axis):
        self.mesh, self.name = mesh, axis
        self.group = axis_group(mesh, axis)
        self.n = axis_size(mesh, axis)
        self.d = axis_rank(mesh, axis)
        self.ranks = ([dist.get_global_rank(self.group, i)
                       for i in range(self.n)] if self.n > 1
                      else [dist.get_rank()])

    def rank(self, d):
        return self.ranks[d % self.n]

    def exchange(self, sends=(), recvs=()):
        """Post ``sends`` [(tensor, stage)] and ``recvs`` [(buffer, stage)]
        together and wait for all of them."""
        ops = [dist.P2POp(dist.isend, t.contiguous(), self.rank(d), self.group)
               for t, d in sends]
        ops += [dist.P2POp(dist.irecv, b, self.rank(d), self.group)
                for b, d in recvs]
        if ops:
            for q in dist.batch_isend_irecv(ops):
                q.wait()

    def all_reduce(self, t):
        if self.n > 1:
            dist.all_reduce(t, group=self.group)


def _plain(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


class _Schedule(torch.autograd.Function):
    """The forward schedule ``order`` [(chunk, microbatch)] of this rank,
    differentiable in its parameters: forward runs it (stashing each
    block's input), backward runs it in reverse."""

    @staticmethod
    def forward(ctx, run, *leaves):
        ctx.run = run
        ctx.save_for_backward(*leaves)
        return run.forward(leaves)

    @staticmethod
    def backward(ctx, g):
        return (None, *ctx.run.backward(ctx.saved_tensors, g))


class _Run:
    """One rank's part of a (possibly interleaved) GPipe schedule, tick by
    tick as the JAX package's: at tick t rank d runs block (microbatch,
    chunk) of :meth:`block_at` when active, then every rank exchanges with
    its neighbours at once (the ``ppermute``), so no send waits on a
    receive that waits on it."""

    def __init__(self, stage_fn, treedef, ax, xs, n_virtual, chunk_params):
        self.stage_fn, self.treedef, self.ax = stage_fn, treedef, ax
        self.xs, self.V = xs, n_virtual
        self.chunk_params = chunk_params    # leaves -> [chunk c's leaves]
        self.ticks = interleaved_ticks(xs.shape[0], ax.n, n_virtual)
        self.stash = {}

    def block_at(self, t, d):
        """(chunk, microbatch) rank d runs at tick t, or None: wave w's
        block (m, c) runs on rank d at t = w*P*V + (m % P) + c*P + d."""
        P, V, M = self.ax.n, self.V, self.xs.shape[0]
        rel = t - d
        w, within = divmod(rel, P * V)
        c, m = within // P, w * P + within % P
        if rel < 0 or m >= M:
            return None
        return c, m

    def _sends(self, t, d):
        """Whether rank d's block at tick t feeds another block."""
        blk = self.block_at(t, d % self.ax.n)
        return blk is not None and not (blk[0] == self.V - 1
                                        and d % self.ax.n == self.ax.n - 1)

    def _gets_cot(self, t, d):
        """Whether rank d's block at tick t returns a cotangent upstream."""
        blk = self.block_at(t, d % self.ax.n)
        return blk is not None and not (blk[0] == 0 and d % self.ax.n == 0)

    def _block(self, params, c, x):
        return self.stage_fn(pytree.tree_unflatten(params[c], self.treedef),
                             x)

    def forward(self, leaves):
        ax, d, last = self.ax, self.ax.d, self.ax.n - 1
        params = self.chunk_params(leaves)
        xs = self.xs
        outs = torch.zeros_like(xs)
        recv = None
        for t in range(self.ticks):
            blk, y = self.block_at(t, d), None
            if blk is not None:
                c, m = blk
                x = xs[m] if c == 0 and d == 0 else recv
                self.stash[c, m] = x
                y = self._block(params, c, x)
                if c == self.V - 1 and d == last:
                    outs[m] = y
            sends = [(y, d + 1)] if self._sends(t, d) else []
            recv = torch.empty_like(xs[0]) if self._sends(t, d - 1) else None
            ax.exchange(sends, [(recv, d - 1)] if recv is not None else [])
        # the last stage's outputs to every rank
        if ax.n > 1:
            dist.broadcast(outs, ax.rank(last), group=ax.group)
        return outs

    def backward(self, leaves, g):
        ax, d, last = self.ax, self.ax.d, self.ax.n - 1
        # every rank holds the same cotangent; the last stage's counts
        g = _plain(g)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        grads = [torch.zeros_like(t) for t in leaves]
        recv = None
        with torch.enable_grad():
            params = self.chunk_params(leaves)
            for t in reversed(range(self.ticks)):
                blk, dx = self.block_at(t, d), None
                if blk is not None:
                    c, m = blk
                    dy = g[m] if c == self.V - 1 and d == last else recv
                    x = self.stash.pop((c, m)).detach().requires_grad_(True)
                    y = self._block(params, c, x)
                    got = torch.autograd.grad(y, [x, *leaves], dy,
                                              allow_unused=True)
                    dx = got[0]
                    for i, gi in enumerate(got[1:]):
                        if gi is not None:
                            grads[i] += gi
                # tick t-1's blocks take the cotangents of tick t's
                sends = [(dx, d - 1)] if self._gets_cot(t, d) else []
                recv = (torch.empty_like(self.xs[0])
                        if self._gets_cot(t, d + 1) else None)
                ax.exchange(sends, [(recv, d + 1)] if recv is not None
                            else [])
        for gr, sharded in zip(grads, self.sharded):
            if not sharded:     # whole on every rank: sum the ranks' slots
                ax.all_reduce(gr)
        return grads


def _apply(stage_fn, stacked_params, x_micro, mesh, axis, n_virtual,
           chunk_params):
    """Run the schedule; a ``DTensor`` leaf enters as its local shard
    (differentiably: its gradient comes back sharded as it is)."""
    ax = _Axis(mesh, axis)
    leaves, treedef = pytree.tree_flatten(stacked_params)
    sharded = [hasattr(t, "to_local") for t in leaves]
    locals_ = [t.to_local() if sh else t for t, sh in zip(leaves, sharded)]
    run = _Run(stage_fn, treedef, ax, _plain(x_micro), n_virtual,
               lambda ls: chunk_params(ls, sharded))
    run.sharded = sharded
    if any(t.requires_grad for t in locals_) and torch.is_grad_enabled():
        return _Schedule.apply(run, *locals_)
    return run.forward(locals_)


def pipeline_apply(stage_fn, stacked_params, x_micro, mesh, axis: str = "pp"):
    """Run microbatches through a P-stage pipeline.

    stage_fn        -- ``(params, x) -> y`` with ``y.shape == x.shape``
    stacked_params  -- tree (tensor, tuple, list or dict) whose leaves have
                       a leading axis of size P (the stage dimension):
                       ``DTensor``s sharded over ``axis``, or whole tensors
    x_micro         -- ``(n_micro, mb, ...)`` microbatched input, the same on
                       every rank
    returns         -- ``(n_micro, mb, ...)`` outputs, on every rank;
                       differentiable in the stacked parameters
    """
    d = axis_rank(mesh, axis)

    def chunks(leaves, sharded):
        # a sharded leaf's local part is this rank's (1, ...) slice
        return [[t[0] if sh else t[d] for t, sh in zip(leaves, sharded)]]

    return _apply(stage_fn, stacked_params, x_micro, mesh, axis, 1, chunks)


def gpipe_ticks(n_micro: int, n_stages: int, n_virtual: int = 1) -> int:
    """GPipe drain latency in block-units for a model of n_stages*n_virtual
    blocks run as n_stages one-per-device stages of depth n_virtual."""
    return n_virtual * (n_micro + n_stages - 1)


def interleaved_ticks(n_micro: int, n_stages: int, n_virtual: int) -> int:
    """Interleaved drain latency in block-units, waves packed back-to-back.

    A full wave of P microbatches keeps every device busy for exactly
    ``P*V`` consecutive ticks, so wave ``w`` starts at tick ``w*P*V`` and
    only the last (possibly partial) wave pays the ``P*V - 1`` drain."""
    n_waves = -(-n_micro // n_stages)
    last = n_micro - (n_waves - 1) * n_stages
    return (n_waves - 1) * n_stages * n_virtual + last + n_stages * n_virtual - 1


def pipeline_apply_interleaved(stage_fn, stacked_params, x_micro, mesh,
                               axis: str = "pp", n_virtual: int = 2):
    """Interleaved virtual-stage pipeline (Megatron-LM style model
    chunking): the model's ``P * V`` blocks are dealt round-robin, device
    ``d`` owning chunks ``{c*P + d : c < V}``, so a microbatch hops the ring
    V times, wave by wave of P microbatches (``interleaved_ticks``).

    stage_fn        -- ``(params, x) -> y`` with ``y.shape == x.shape``
    stacked_params  -- tree, leaves ``(P*V, ...)`` whole on every rank:
                       block ``s = c*P + d`` at leaf index ``s``
    x_micro         -- ``(n_micro, mb, ...)``, the same on every rank
    """
    n, d = axis_size(mesh, axis), axis_rank(mesh, axis)
    stacked_params = pytree.tree_map(_plain, stacked_params)

    def chunks(leaves, sharded):
        return [[t[c * n + d] for t in leaves] for c in range(n_virtual)]

    return _apply(stage_fn, stacked_params, x_micro, mesh, axis, n_virtual,
                  chunks)
