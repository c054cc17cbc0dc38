"""What ``lightgrad_tpu_torch.jit`` does with a step that holds a DTensor or
a collective, at world size 1: NCCL on the card, gloo on the CPU.

Two steps, each run four times eagerly and four times compiled from the
same start, losses and the trained parameter compared bit for bit:

* ``dtensor``: a tape parameter whose buffer is a ``DTensor`` sharded over
  a one-rank mesh (the matmul's sharded strategies, SGD rebinding the
  update into the parameter's placement);
* ``allreduce``: a plain parameter all-reduced over the default group after
  each update (``dist.all_reduce`` inside the step, so inside the graph).

    python3 scripts/jit_dtensor_capture.py [cuda|cpu]

Prints one line a step kind and exits 1 if a compiled run differs from its
eager run or fails.
"""

import os
import socket
import subprocess
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (DeviceMesh, Shard,  # noqa: E402
                                      distribute_tensor)

import lightgrad_tpu_torch as lt  # noqa: E402
from lightgrad_tpu_torch.autograd.cuda import device as tdev  # noqa: E402

STEPS = 4


def run(kind, use_jit, dev, mesh):
    lt.random.seed(0)
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(64, 32, generator=g, device=dev)
    x = lt.Tensor(torch.randn(8, 32, generator=g, device=dev),
                  requires_grad=False)
    p = lt.Tensor(distribute_tensor(w, mesh, [Shard(0)])
                  if kind == "dtensor" else w)
    opt = lt.optim.SGD([p], lr=1e-3)

    def step(a):
        y = a @ p.T(1, 0)
        loss = (y * y).sum()
        opt.zero_grad()
        loss.backward()
        opt.step()
        if kind == "allreduce":
            d = p.data.clone()
            dist.all_reduce(d)
            p._set_data(d)
        return loss

    fn = lt.jit(step) if use_jit else step
    losses = [float(fn(x).numpy()) for _ in range(STEPS)]
    return losses, p.numpy()


def main(dev):
    if dev == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    tdev.set_default_device(dev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    mesh = DeviceMesh(dev, [0])
    ok = True
    try:
        for kind in ("dtensor", "allreduce"):
            try:
                (le, pe), (lc, pc) = (run(kind, False, dev, mesh),
                                      run(kind, True, dev, mesh))
            except Exception as e:  # noqa: BLE001 - reported, exit 1
                ok = False
                print(f"{kind} FAILED: {type(e).__name__}: {str(e)[:600]}",
                      flush=True)
                traceback.print_exc(limit=3)
                continue
            same = le == lc and np.array_equal(pe, pc)
            ok = ok and same
            print(f"{kind}: eager losses {le}, compiled {lc}; parameter "
                  f"{'bit for bit' if same else 'DIFFERS'}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "cuda"))
