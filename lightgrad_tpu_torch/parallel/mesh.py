"""Device-mesh construction.

Counterpart of ``lightgrad_tpu/parallel/mesh.py``.  The JAX package builds
a ``jax.sharding.Mesh`` over the devices of one controller; here each
process drives one device (SPMD, launched as ``torchrun`` launches it), and
the mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
default process group, its dims named as the JAX mesh's axes.  Each dim
has its own process group (``mesh.get_group(name)``), which the explicit
collectives of ring attention and the pipelines run on.

An axis of size 1 shards nothing, and DTensor's placement search on the
host grows with every mesh dim (on a three-dim mesh its rules for a plain
product cost seconds a call), so the ``DeviceMesh`` holds only the axes
larger than 1 (the first axis where all are 1).  :func:`axis_size`,
:func:`axis_rank` and :func:`axis_group` answer for any axis named in
:func:`make_mesh`, present or not; a partition spec naming a left-out axis
replicates over it (``distributed.placements``).
"""

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "axis_size", "axis_rank", "axis_group"]


def make_mesh(dp: int = 1, tp: int = 1, devices=None, **extra_axes):
    """A ``DeviceMesh`` of shape ``(dp, tp, *extra)``, dims named in that
    order (extra named axes, e.g. ``sp=2`` or ``pp=2``, append in kwarg
    order), over ranks ``0 .. prod(sizes) - 1`` of the default group.

    ``devices`` is the device type: ``"cuda"`` (the default; NCCL) or
    ``"cpu"`` (gloo).  The default process group must exist
    (``parallel.distributed.initialize``) and its world size must cover
    the mesh.  Every rank calls this, those outside the mesh too."""
    sizes = {"dp": dp, "tp": tp, **extra_axes}
    need = math.prod(sizes.values())
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "lightgrad_tpu_torch.parallel.distributed."
                           "initialize() first")
    have = dist.get_world_size()
    assert need <= have, f"need {need} devices, have {have}"
    kept = {n: k for n, k in sizes.items() if k > 1} or \
        dict([next(iter(sizes.items()))])
    ranks = torch.arange(need).reshape(tuple(kept.values()))
    return DeviceMesh(devices or "cuda", ranks, mesh_dim_names=tuple(kept))


def axis_size(mesh, axis: str) -> int:
    """The size of mesh axis ``axis`` (1 for an axis the mesh left out)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on mesh axis ``axis`` (0 on a left-out
    axis)."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def axis_group(mesh, axis: str):
    """The process group of mesh axis ``axis`` (None on a left-out axis:
    a group of one rank, which no collective needs)."""
    return mesh.get_group(axis) if axis in mesh.mesh_dim_names else None
