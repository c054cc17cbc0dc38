"""Registers, spills and shared memory of each kernel in the port's CUDA
sources, as ``nvcc -Xptxas -v`` reports them for sm_90a, and the
tensor-core instructions in each kernel's SASS.

    python3 scripts/ptxas_report.py [lightgrad_tpu_torch/csrc/flash_fwd.cu ...]

With no arguments every ``lightgrad_tpu_torch/csrc/*.cu`` is compiled, one
``nvcc`` process per source, all started together (the flags of
``ops/_build.py`` plus ``-Xptxas -v``).  Prints one line per kernel
instantiation (demangled where ``c++filt`` exists): registers, spills,
static shared memory, and the counts of ``HMMA`` (mma.sync), ``HGMMA``
(wgmma) and ``FFMA`` instructions in its SASS (``cuobjdump -sass``); and
each source's compile seconds.  Needs ``nvcc``: run it on the machine with
the card.
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from lightgrad_tpu_torch.ops import _build  # noqa: E402


def _demangle(names):
    if not shutil.which("c++filt"):
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True).stdout
    return out.splitlines() if out else names


SASS_OPS = ("HMMA", "HGMMA", "FFMA")


def _sass_counts(obj):
    """{mangled kernel name: {op: count}} of the SASS in an object file."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                         text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
        if m and name:
            op = m.group(1)
            if op in counts[name]:
                counts[name][op] += 1
    return counts


def main(srcs):
    srcs = srcs or sorted(os.path.join(_build._CSRC, f)
                          for f in os.listdir(_build._CSRC)
                          if f.endswith(".cu"))
    tmp = tempfile.mkdtemp()
    procs = {}
    t0 = time.perf_counter()
    for src in srcs:
        obj = os.path.join(tmp, os.path.basename(src) + ".o")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
               "-o", obj, src]
        procs[src] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    failed = False
    for src, proc in procs.items():
        log = proc.communicate()[0]
        secs = time.perf_counter() - t0
        print(f"{os.path.basename(src)}: exit {proc.returncode}, "
              f"{secs:.1f} s")
        if proc.returncode:
            failed = True
            print(log[-6000:])
            continue
        names, stats = [], []
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry, spill = m.group(1), (0, 0)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and entry:
                spill = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                smem = re.search(r"(\d+) bytes smem", line)
                names.append(entry)
                stats.append((int(m.group(1)), spill,
                              int(smem.group(1)) if smem else 0))
                entry = None
        sass = _sass_counts(os.path.join(tmp, os.path.basename(src) + ".o"))
        for mangled, name, (regs, spill, smem) in zip(names, _demangle(names),
                                                      stats):
            ops = ", ".join(f"{op} {n}" for op, n in
                            sass.get(mangled, {}).items())
            print(f"  {regs:3d} registers, spill stores/loads "
                  f"{spill[0]}/{spill[1]} B, static smem {smem} B, SASS "
                  f"{ops or 'not found'}: {name}")
    shutil.rmtree(tmp, ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
