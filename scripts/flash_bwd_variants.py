"""Time design variants of the float32 flash backward passes against the
design as it stands, on one card, with their float64 errors.

    python3 scripts/flash_bwd_variants.py

Each variant is ``lightgrad_tpu_torch/csrc/flash_bwd.cu`` with a few lines
of it or of the headers it includes (``flash_tf32.cuh``) replaced (the
script refuses a variant whose lines are gone), built alone with the
package's nvcc flags into its own library, whose two f32 pass entry points
stand in for the package's while it is timed.  Variants:

- ``in_place``: each tile's dq / dk / dv share added to the running sum
  inside the tensor cores, not summed from zero and added in f32;
- ``interleaved``: a chain's three products in one accumulator, not its
  small products (lo hi, hi lo) in one of their own;
- ``dq64_bk64``: 64-key tiles in the D 64 dq pass (not 32);
- ``d80_on_d128``: no D 96 instantiation, so d 80 runs on D 128;
- ``d32_on_d64``: no D 32 instantiation, so d 32 runs on D 64.

Prints the card's name and power limit, then one JSON line: for every row
of ``scripts/ab_flash_bwd.py``'s BWD_ROWS, float32, each variant's dq and
dk/dv CUDA-graph ms (10 replayed calls) and its (dq, dk, dv) errors
against the float64 backward of the first KV group (the largest over
max(1, the largest |element|), and over the reference's rms), beside
SDPA's f32 backward and the same errors of the plain f32 backward
(``attention_bwd_reference``).
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import ab_flash_bwd as ab  # noqa: E402
from lightgrad_tpu_torch.ops import _build  # noqa: E402
from lightgrad_tpu_torch.ops import attention as att  # noqa: E402

PASSES = ("lg_flash_bwd_dq", "lg_flash_bwd_dkv")
# variant -> (replacements (source file, old, new), rows it is timed at or
# None)
TC = "flash_tf32.cuh"
VARIANTS = {
    "change": ([], None),
    "in_place": ([(TC, "mma_small(small, fh[kb], fl[kb], bh0, bh1, bl0, "
                   "bl1);", "mma_small(acc[nb], fh[kb], fl[kb], bh0, bh1, "
                   "bl0, bl1);"),
                  (TC, "mma_tf32(part, fh[kb], bh0, bh1);",
                   "mma_tf32(acc[nb], fh[kb], bh0, bh1);"),
                  (TC, "acc[nb][e] += part[e] + small[e];",
                   "(void)(part[e] + small[e]);")],
                 None),
    "interleaved": ([(TC, "mma_small(ts[nb],", "mma_small(t[nb],"),
                     (TC, "mma_small(small,", "mma_small(part,")],
                    None),
    "dq64_bk64": ([(TC, "static constexpr int BK = D == 256 ? 16 : 32;",
                    "static constexpr int BK = D == 256 ? 16 : D == 64 ? 64 "
                    ": 32;")],
                  ("8_9_gpt2", "8D_d32", "8_lengths")),
    "d80_on_d128": ([("flash_bwd.cu", "  if (a.d <= 96)\n    return dkv ? "
                      "launch_dkv_tf32<96>(a, st) : launch_dq_tf32<96>(a, "
                      "st);\n", "")],
                    ("9D_pythia2p8b",)),
    "d32_on_d64": ([("flash_bwd.cu", "  if (a.d <= 32)\n    return dkv ? "
                     "launch_dkv_tf32<32>(a, st) : launch_dq_tf32<32>(a, "
                     "st);\n", "")],
                   ("8D_d32",)),
}


class Passes:
    """The package's library with the two f32 passes from ``lib``."""

    def __init__(self, main, lib):
        self.main, self.lib = main, lib

    def __getattr__(self, name):
        return getattr(self.lib if name in PASSES else self.main, name)


def patched_build(src_dir, subs, where):
    """A copy of ``src_dir`` in directory ``where`` with ``subs`` ((file,
    old, new), each ``old`` required) applied, and the nvcc process that
    builds its flash_bwd.cu alone into ``where``/lib.so: (path, Popen)."""
    shutil.copytree(src_dir, where)
    for name, old, new in subs:
        path = os.path.join(where, name)
        text = open(path).read()
        if old not in text:
            sys.exit(f"flash_bwd_variants: {old!r} not in {name}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    so = os.path.join(where, "lib.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
           os.path.join(where, "flash_bwd.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def load(so, proc, entries):
    """The library ``so`` once ``proc`` has built it, with ``entries``'
    signatures set."""
    out = proc.communicate()[0]
    if proc.returncode:
        sys.exit(f"flash_bwd_variants: {so} failed to build:\n{out}")
    lib = ctypes.CDLL(so)
    for fn in entries:
        f = getattr(lib, fn)
        f.argtypes, f.restype = _build._SIGNATURES[fn]
    return lib


def build(tmp):
    """{variant: library}, each variant's flash_bwd.cu built alone."""
    src_dir = os.path.join(ROOT, "lightgrad_tpu_torch", "csrc")
    procs = {name: patched_build(src_dir, subs, os.path.join(tmp, name))
             for name, (subs, _) in VARIANTS.items()}
    return {name: load(so, proc, PASSES)
            for name, (so, proc) in procs.items()}


def main():
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    main_lib = _build.library()
    tmp = tempfile.mkdtemp()
    try:
        libs = build(tmp)
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(10)
        res = {}
        for row, h, kvh, s, hd, window, causal, bert in ab.BWD_ROWS:
            lens = ab.bert_lengths(h, s, dev) if bert else None
            sc = hd ** -0.5
            q, do = (torch.randn(h, s, hd, generator=g, device=dev)
                     for _ in range(2))
            k, v = (torch.randn(kvh, s, hd, generator=g, device=dev)
                    for _ in range(2))
            _build._lib = main_lib
            out, lse = att.attention_fwd_res(q, k, v, sc, causal,
                                             lengths=lens, window=window)
            dcap = (do * out).sum(-1).contiguous()
            r = {"sdpa_bwd_ms": ab.sdpa_backward_ms(q, k, v, do, window,
                                                    causal, lens)[0]}
            plain = att.attention_bwd_reference(do, q, k, v, sc, causal,
                                                lengths=lens, window=window)
            r["plain_f32"] = {
                f"f64_err{key}_dq_dk_dv": ab.f64_errors(
                    q, k, v, do, sc, causal, window, lens, plain, over)
                for key, over in (("", "max"), ("_rms", "rms"))}
            del plain
            for name, lib in libs.items():
                rows = VARIANTS[name][1]
                if rows is not None and row not in rows:
                    continue
                _build._lib = Passes(main_lib, lib)
                try:
                    dq = ab.graph_ms(lambda: att.attention_bwd_dq(
                        do, q, k, v, lse, dcap, sc, causal, lens,
                        window=window))
                    dkv = ab.graph_ms(lambda: att.attention_bwd_dkv(
                        do, q, k, v, lse, dcap, sc, causal, lens,
                        window=window))
                    got = att.attention_bwd(do, q, k, v, sc, causal,
                                            out=out, lse=lse, lengths=lens,
                                            window=window)
                    errs = [ab.f64_errors(q, k, v, do, sc, causal, window,
                                          lens, got, over)
                            for over in ("max", "rms")]
                    r[name] = {"dq_ms": dq, "dkv_ms": dkv,
                               "f64_err_dq_dk_dv": errs[0],
                               "f64_err_rms_dq_dk_dv": errs[1]}
                    del got
                finally:
                    _build._lib = main_lib
            res[row] = r
            del q, k, v, do, out, lse, dcap
            torch.cuda.empty_cache()
        print(json.dumps(res))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
