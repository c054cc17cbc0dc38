"""Process groups via ``torch.distributed``.

Counterpart of ``lightgrad_tpu/parallel/distributed.py``.  The JAX package
joins one controller process per host into a runtime that sees every
device; here every device has its own process (SPMD), launched as
``torchrun`` launches it, and :func:`initialize` joins the default process
group.  It reads the JAX package's variables (``COORDINATOR_ADDRESS`` as
``host:port``, ``NUM_PROCESSES``, ``PROCESS_ID``) and torchrun's
(``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``); explicit arguments win.

The backend follows the device the caller names -- NCCL for ``"cuda"``,
the default, gloo for ``"cpu"`` -- and is never chosen by the hardware
found: a missing GPU raises, nothing moves to the CPU.  Every group gets a
timeout, so a rank that fails while the others wait in a collective ends
the job instead of hanging it.

:func:`distribute_batch` turns each process's local shard of a batch into
one global sharded ``DTensor``; on a single process it is the batch placed
on the mesh with the same sharding, so data code runs anywhere.
:func:`spawn` starts a function on N local ranks joined into one group (a
small ``torchrun`` for tests and the dry run), each under a time limit.
"""

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "process_count", "process_index",
           "distribute_batch", "placements", "P", "spawn"]

_TIMEOUT = datetime.timedelta(seconds=300)


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry a
    tensor dim, a mesh axis name (or a tuple of names) or None; absent
    trailing dims are replicated.  Kept as data, so the rule tables are the
    JAX package's, entry for entry."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def placements(mesh, spec) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: mesh dim ``m``
    is ``Shard(i)`` where ``spec[i]`` names it, else ``Replicate()``.  An
    axis of size 1, which ``make_mesh`` leaves out, shards nothing."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for i, axis in enumerate(spec):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None and a in names:
                out[names.index(a)] = Shard(i)
    return out


def initialize(coordinator_address: str = None, num_processes: int = None,
               process_id: int = None, local_device_ids=None,
               device: str = "cuda", timeout: datetime.timedelta = _TIMEOUT
               ) -> bool:
    """Join the default process group.  Returns True when a group was
    joined (or already was), False for the single-process no-op path (no
    coordinator given or set in the environment).  ``local_device_ids``
    picks this process's card (default ``LOCAL_RANK``)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("COORDINATOR_ADDRESS")
        if coordinator_address is None and env.get("MASTER_ADDR"):
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        n = env.get("NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(n) if n else None
    if process_id is None:
        r = env.get("PROCESS_ID") or env.get("RANK")
        process_id = int(r) if r else None
    if coordinator_address is None:
        return False            # single process: nothing to join
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator needs the number of "
                         "processes and this process's id")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: device 'cuda' asked for, but no "
                               "GPU is visible")
        local = (local_device_ids if local_device_ids is not None
                 else int(env.get("LOCAL_RANK", process_id)))
        local = local[0] if isinstance(local, (list, tuple)) else local
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize: device {device!r} is not 'cuda' or "
                         f"'cpu'")
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=timeout)
    return True


def is_initialized() -> bool:
    return dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def distribute_batch(mesh, local_batch, spec):
    """One global ``DTensor`` from each process's LOCAL shard of a batch,
    sharded as ``spec`` says (the JAX package's
    ``make_array_from_process_local_data``).  On a single process the
    local batch is the whole batch, placed on the mesh as ``spec`` says."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    t = torch.as_tensor(local_batch, device=mesh.device_type)
    if process_count() == 1:
        return distribute_tensor(t, mesh, placements(mesh, spec))
    return DTensor.from_local(t, mesh, placements(mesh, spec),
                              run_check=False)


# ---------------------------------------------------------------------------
# a local launcher
# ---------------------------------------------------------------------------
def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, port, device, args, group_timeout, results):
    import traceback

    try:
        if device == "cpu":
            from ..autograd.cuda import device as tape_device

            torch.set_num_threads(1)
            tape_device.set_default_device("cpu")
        initialize(f"localhost:{port}", n, rank, device=device,
                   timeout=datetime.timedelta(seconds=group_timeout))
        results.put((rank, True, fn(rank, n, *args)))
    except BaseException:       # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, n_processes: int, *args, device: str = "cuda",
          timeout: float = 600.0, group_timeout: float = 120.0) -> list:
    """Run ``fn(rank, n_processes, *args)`` in ``n_processes`` fresh
    processes joined into one process group on ``device`` (NCCL for
    "cuda", one card a rank; gloo for "cpu"), as ``torchrun`` would on one
    host; returns their results in rank order.  ``fn`` must be importable
    (a module-level function) and its results picklable.  A rank that
    raises, dies, or outlives ``timeout`` seconds ends every rank, and the
    call raises with the first failure; each group's collectives time out
    after ``group_timeout`` seconds, so no rank waits for ever."""
    import multiprocessing as mp
    import queue
    import time

    if device == "cuda" and torch.cuda.device_count() < n_processes:
        raise RuntimeError(f"spawn: {n_processes} ranks on 'cuda' need as "
                           f"many GPUs; {torch.cuda.device_count()} visible")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n_processes, port, device, args,
                               group_timeout, results))
             for r in range(n_processes)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < n_processes:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: ranks still running after "
                                       f"{timeout} s") from None
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"spawn: rank {dead[0]} died with "
                                       f"exit code {procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(n_processes)]
