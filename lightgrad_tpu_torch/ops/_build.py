"""Build and load the port's CUDA kernels.

At first use, every ``lightgrad_tpu_torch/csrc/*.cu`` is compiled by ``nvcc``
for ``sm_90a`` -- one ``nvcc`` process per source, all started together --
and linked into ONE shared library with a plain C interface, which is
loaded with ``ctypes``.  The library lands in ``lightgrad_tpu_torch/build/``
(ignored by git) beside a hash of the sources; a later process reuses it
until a source changes.  A failed build raises: there is no fallback.

Every entry point takes its pointers and the CUDA stream as ``c_void_p``
and returns ``cudaGetLastError()`` after its launch; :func:`check` turns a
non-zero code into an exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["library", "check", "build_seconds"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL, _S = ctypes.c_longlong, ctypes.c_char_p
_GEOM = ctypes.POINTER(ctypes.c_int)
# entry point -> (argtypes, restype).  The launchers return the launch's
# cudaError_t as an int.
_SIGNATURES = {
    # q, k, v, out, lse, lens (null or BH int32), BH, G, S, D, scale, causal,
    # window, is_bf16, stream
    "lg_flash_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                      _P], _I),
    # q, k, v, do, lse, dcap, dlse, dq, dcap_out, lens, BH, G, S, D, scale,
    # causal, window, is_bf16, stream
    "lg_flash_bwd_dq": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _F, _I, _I, _I, _P], _I),
    # q, k, v, do, lse, dcap, dk, dv, partials (null with gsplit 1), lens,
    # BH, G, S, D, scale, causal, window, gsplit, is_bf16, stream
    "lg_flash_bwd_dkv": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _F, _I, _I, _I, _I, _P], _I),
    # q, k, v, do, lse, dcap, dq (f32), turns (int32 zeros), dk, dv, BH, S,
    # D, scale, causal, is_bf16, stream
    "lg_flash_bwd_fused": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _F, _I, _I, _P], _I),
    # q, kc, vc, out, partials (null with n_split 1), KV, G, W, hd, pos,
    # window, scale, n_split, is_bf16, stream
    "lg_decode_attention": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                             _I, _I, _P], _I),
    # partials, out, KV, G, hd, n_split, is_bf16, stream
    "lg_decode_merge": ([_P, _P, _I, _I, _I, _I, _I, _P], _I),
    # x, cache, slot_stride, poss, pos0, slabs, vecs, scales, kv_scales,
    # x_out, kv_out, ws, n, L, d, H, W, R, eps, scale, is_bf16, w_int8,
    # kv_int8, stream
    "lg_decode_stack": ([_P, _P, _LL, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                         _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _P], _I),
    # n, d, R -> f32 workspace elements the stack kernel needs
    "lg_decode_stack_workspace": ([_I, _I, _I], _LL),
    # is_bf16, w_int8, kv_int8 -> blocks of that instantiation's cooperative
    # grid (0: refused)
    "lg_decode_stack_grid": ([_I, _I, _I], _I),
    # A, B, C, M, N, K, batch, B2, sAb1, sAb2, sAm, sAk, sBb1, sBb2, sBk,
    # sBn, is_bf16, stream
    "lg_matmul": ([_P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL,
                   _LL, _LL, _LL, _I, _P], _I),
    # x, w, y, geom (19 ints: B, Cin, Cout, G, D, H, W, OD, OH, OW, KD, KH,
    # KW, strides, dilations), is_bf16, stream
    "lg_conv_fwd": ([_P, _P, _P, _GEOM, _I, _P], _I),
    # gy, w, gx, geom, is_bf16, stream
    "lg_conv_bwd_dx": ([_P, _P, _P, _GEOM, _I, _P], _I),
    # gy, x, gw, f32 partials, geom, splits, chunk, is_bf16, stream
    "lg_conv_bwd_dw": ([_P, _P, _P, _P, _GEOM, _I, _LL, _I, _P], _I),
    "lg_error_string": ([_I], _S),
}

_lib = None
_build_seconds = 0.0


def _sources():
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _run(procs):
    """Wait for every (cmd, Popen); raise with the first failure's output."""
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, err)
    if failed:
        raise RuntimeError("nvcc failed (%d):\n%s\n%s" % (
            failed[0], " ".join(failed[1]), failed[2][-8000:]))


def _compile(srcs, so_path):
    cus = [s for s in srcs if s.endswith(".cu")]
    tmp = so_path + f".tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(cu)}.o" for cu in cus]
    procs = []
    for cu, obj in zip(cus, objs):
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, cu]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
    try:
        _run(procs)
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so_path)


def library():
    """The loaded kernel library; builds it first when the sources changed."""
    global _lib, _build_seconds
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    digest = h.hexdigest()[:16]
    os.makedirs(_BUILD, exist_ok=True)
    so_path = os.path.join(_BUILD, f"liblightgrad_kernels_{digest}.so")
    if not os.path.exists(so_path):
        t0 = time.perf_counter()
        _compile(srcs, so_path)
        _build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so_path)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def build_seconds() -> float:
    """Seconds the last :func:`library` call spent in nvcc (0 when reused)."""
    return _build_seconds


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({library().lg_error_string(err).decode()})")
