"""Some phases of ``chip_smoke.py`` alone, after the kernels' build: the
quickest way to check the step compiler on the card without the whole run.

    python3 scripts/smoke_phases.py [p16] [p15] [neox]

``p16``: phase 16, the step compiler (compiled steps against eager steps);
``p15``: phase 15, the examples, with each path's kernels checked launched;
``neox``: phase 10b, Pythia-1B's generate with its compiled decode.  With no
argument, ``p16``.  Each phase raises on a failure, as in the whole run.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lightgrad_tpu_torch.ops import _build  # noqa: E402


def main(which):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}",
          flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if "p16" in which:
        t0 = time.perf_counter()
        for path, counts in cs.phase_step_compiler(card).items():
            print(path, {k: v for k, v in counts.items() if v}, flush=True)
        print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
    if "p15" in which:
        t0 = time.perf_counter()
        for path, (counts, kernels) in cs.phase_examples(card).items():
            missing = [k for k in kernels if counts[k] == 0]
            print(path, f"missing {missing}" if missing else "ok",
                  flush=True)
            if missing:
                raise AssertionError(f"{path}: kernels not launched "
                                     f"{missing}")
        print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)
    if "neox" in which:
        t0 = time.perf_counter()
        cs.phase_neox_generate(card)
        print(f"phase 10b: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["p16"])
