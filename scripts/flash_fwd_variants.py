"""Time design variants of the float32 flash forward against the design as
it stands, on one card.

    python3 scripts/flash_fwd_variants.py

Each variant is ``lightgrad_tpu_torch/csrc/flash_fwd.cu`` with a few lines
replaced (the script refuses a variant whose lines are gone), built alone
with the package's nvcc flags into its own library, whose ``lg_flash_fwd``
stands in for the package's while it is timed.  Variants:

- ``bk64_d64``: 64-key K / V tiles at D 32 and 64 (not 32);
- ``bk64_d128``: 64-key tiles at D 32 to 128.

Prints the card's name and power limit, then one JSON line: for every row
of ``scripts/ab_flash_fwd.py``'s FWD_ROWS, each variant's CUDA-graph ms (10
replayed calls) and its largest error against the float64 forward of the
first KV group (over max(1, the largest |element|)).
"""

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

import ab_flash_fwd as ab  # noqa: E402
from flash_bwd_variants import load  # noqa: E402
from lightgrad_tpu_torch.ops import _build  # noqa: E402
from lightgrad_tpu_torch.ops import attention as att  # noqa: E402

F = "flash_fwd.cu"
SMEM = "(C::BR * C::P + 4 * BKF * C::P + C::kXFwd) * 4"


def _bk(limit):
    """The forward's K / V tiles at 64 keys up to D ``limit``."""
    bkf = f"constexpr int BKF = D <= {limit} ? 64 : F32Tc<D>::BK;\n"
    return [(F, "  constexpr int BR = C::BR, BK = C::BK, NT = C::kThreads, "
             "P = C::P;\n  constexpr int NB = BK / 8, NN = C::DW / 8;\n  "
             "extern __shared__ float4 smem_f4[];\n  float* const sQ",
             "  " + bkf + "  constexpr int BR = C::BR, BK = BKF, NT = "
             "C::kThreads, P = C::P;\n  constexpr int NB = BK / 8, NN = "
             "C::DW / 8;\n  extern __shared__ float4 smem_f4[];\n  float* "
             "const sQ"),
            (F, "  using C = F32Tc<D>;\n  static bool sized = false;\n  if "
             "(int e = smem_limit(flash_fwd_tf32_kernel<D>, C::kSmemFwd, "
             "sized))", "  using C = F32Tc<D>;\n  " + bkf + "  static bool "
             "sized = false;\n  if (int e = smem_limit(flash_fwd_tf32_kernel"
             f"<D>, {SMEM}, sized))"),
            (F, "C::kThreads, C::kSmemFwd, stream>>>",
             f"C::kThreads, {SMEM}, stream>>>")]


VARIANTS = {"change": [], "bk64_d64": _bk(64), "bk64_d128": _bk(128)}


class Fwd:
    """The package's library with ``lg_flash_fwd`` from ``lib``."""

    def __init__(self, main, lib):
        self.main, self.lib = main, lib

    def __getattr__(self, name):
        return getattr(self.lib if name == "lg_flash_fwd" else self.main,
                       name)


def build(tmp):
    """{variant: library}, each variant's flash_fwd.cu built alone."""
    src_dir = os.path.join(ROOT, "lightgrad_tpu_torch", "csrc")
    procs = {}
    for name, subs in VARIANTS.items():
        where = os.path.join(tmp, name)
        shutil.copytree(src_dir, where)
        for fname, old, new in subs:
            path = os.path.join(where, fname)
            text = open(path).read()
            if old not in text:
                sys.exit(f"flash_fwd_variants: {name}: {old!r} not found")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        so = os.path.join(where, "lib.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
             os.path.join(where, F)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return {name: load(so, proc, ("lg_flash_fwd",))
            for name, (so, proc) in procs.items()}


def main():
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    main_lib = _build.library()
    tmp = tempfile.mkdtemp()
    try:
        libs = build(tmp)
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(12)
        res = {}
        for row, h, kvh, s, hd, window, causal, bert in ab.FWD_ROWS:
            lens = ab.bert_lengths(h, s, dev) if bert else None
            sc = hd ** -0.5
            q = torch.randn(h, s, hd, generator=g, device=dev)
            k, v = (torch.randn(kvh, s, hd, generator=g, device=dev)
                    for _ in range(2))
            r = {}
            for name, lib in libs.items():
                _build._lib = Fwd(main_lib, lib)
                try:
                    fn = lambda: att.attention_fwd_res(  # noqa: E731
                        q, k, v, sc, causal, lengths=lens, window=window)
                    ms = ab.graph_ms(fn)
                    err = ab.f64_errors(att, q, k, v, sc, causal, window,
                                        lens, fn()[0])["kernel"]["f64_err"]
                    r[name] = {"ms": ms, "f64_err": err}
                finally:
                    _build._lib = main_lib
            res[row] = r
            del q, k, v
            torch.cuda.empty_cache()
        print(json.dumps(res))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
