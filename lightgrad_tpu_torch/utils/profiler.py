"""Per-op wall-clock profiler of the lightgrad tape.

Counterpart of ``lightgrad_tpu/utils/profiler.py``: a stack of active
``Profiler`` context managers receives ``(op name, elapsed, fwd/bwd)``
samples from ``Tracker``s wrapped around every Function application and
every backward step; nested trackers are suppressed so a composite op
(softmax, mean, ...) shows up as a single entry.

Kernel launches are asynchronous, so ``Tracker`` calls the backend's sync
hook on exit while a profiler is active (the CUDA backend registers
``torch.cuda.synchronize`` through :func:`set_sync_fn`): recorded times are
device wall-clock, not launch latency.  With no profiler active a tracker
costs two integer updates.
"""

import time
from collections import defaultdict

__all__ = ["Profiler", "Tracker", "set_sync_fn"]

# backends register a "wait for the device" hook here (see autograd/cuda)
_sync_fn = None


def set_sync_fn(fn):
    global _sync_fn
    _sync_fn = fn


class Profiler:
    """Collects cumulative forward/backward time and call counts per op."""

    _active = []

    def __init__(self):
        self.fwd_time = defaultdict(float)
        self.fwd_count = defaultdict(int)
        self.bwd_time = defaultdict(float)
        self.bwd_count = defaultdict(int)

    def update(self, name, dt, backward=False):
        if backward:
            self.bwd_time[name] += dt
            self.bwd_count[name] += 1
        else:
            self.fwd_time[name] += dt
            self.fwd_count[name] += 1

    def __enter__(self):
        Profiler._active.append(self)
        return self

    def __exit__(self, *exc):
        Profiler._active.remove(self)
        return False

    def print(self, topn: int = -1):
        names = sorted(set(self.fwd_time) | set(self.bwd_time),
                       key=lambda n: -self.fwd_time[n])
        if topn > 0:
            names = names[:topn]
        print(" Function       |   forward      \t|   backward   \n" + "-" * 70)
        for n in names:
            print(" %-15s| %8.4fs (%i)\t| %8.4fs (%i) "
                  % (n, self.fwd_time[n], self.fwd_count[n],
                     self.bwd_time[n], self.bwd_count[n]))
        print()


class Tracker:
    """Wall-clock context around one op application; outermost-only."""

    _depth = 0

    def __init__(self, name: str, backward: bool = False):
        self.name = name
        self.backward = backward
        # record only at top level and only when someone is listening
        self.active = Tracker._depth == 0 and bool(Profiler._active)

    def __enter__(self):
        Tracker._depth += 1
        if self.active:
            if _sync_fn is not None:
                _sync_fn()          # start from an idle device
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        Tracker._depth = max(0, Tracker._depth - 1)
        if self.active:
            if _sync_fn is not None:
                _sync_fn()
            dt = time.perf_counter() - self.t0
            for p in Profiler._active:
                p.update(self.name, dt, backward=self.backward)
        return False
