"""Seconds each ``lightgrad_tpu_torch/csrc/*.cu`` takes to compile when all
are started together, as the library's build starts them (one ``nvcc`` a
source, the build's flags); the last to finish sets the build's time.

    python3 scripts/nvcc_times.py
"""

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lightgrad_tpu_torch.ops import _build  # noqa: E402


def main():
    with tempfile.TemporaryDirectory() as out:
        _compile_all(out)


def _compile_all(out):
    cus = [s for s in _build._sources() if s.endswith(".cu")]
    t0 = time.perf_counter()
    pending = {cu: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
         os.path.join(out, os.path.basename(cu) + ".o"), cu],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL) for cu in cus}
    while pending:
        for cu, proc in list(pending.items()):
            if proc.poll() is not None:
                print(f"{os.path.basename(cu)}: {time.perf_counter() - t0:.1f}"
                      f" s, exit {proc.returncode}", flush=True)
                del pending[cu]
        time.sleep(0.2)
    print(f"{len(cus)} sources on {os.cpu_count()} CPUs")


if __name__ == "__main__":
    main()
