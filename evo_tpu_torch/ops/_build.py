"""Build the package's CUDA sources with ``nvcc`` and bind them with ctypes.

No counterpart in evo_tpu (Pallas kernels are compiled by JAX).  All
``csrc/*.cu`` files, with the ``csrc/*.cuh`` headers they include, go into
one shared library with a plain C interface, in one ``nvcc`` call with a
time limit, at the first kernel launch in a process: no PyTorch headers, no
``torch.utils.cpp_extension``, no ``ninja`` and no lock file to go stale.
The library's file name carries a hash of the sources, the headers and the
flags, and is written under a temporary name and then renamed, so a build
that was cut off is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 300

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of the extern "C" entry points
SIGNATURES = {
    # ss, wty, y2, G, scal, lpj, keys, B, K, H, stream
    "evo_bsc_lpj": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "evo_bsc_lpj_packed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # B, S, H -> the number of chunks G of the two calls below
    "evo_bsc_suffstat_chunks": [_I, _I, _I],
    # ss, rs, rho, sabs, wq, partial [G, H(H+1)/2], rows [2] or null, B, S, H, G, stream
    "evo_bsc_suffstat": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "evo_bsc_suffstat_packed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # ss, wty, y2, G, Psi, mus, pil_bar, s2inv, lpj, bad, B, K, H, cap, stream
    "evo_sssc_lpj": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # B, S, H, cap -> the number of blocks G of the call below
    "evo_sssc_suffstat_blocks": [_I, _I, _I, _I],
    # ss, rs, wty, G, Psi, mus, s2inv, xpt_sz, xpt_s, out, partial [G, 3 H(H+1)/2 + H^2],
    # B, S, H, cap, G, stream
    "evo_sssc_suffstat": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P],
    # ss, wty, y2, G [B, H, H], Psi, mus, pil_bar, s2inv, lpj, bad, B, K, H, stream
    "evo_sssc_lpj_masked": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # B, S, H -> the number of blocks G of the call below
    "evo_sssc_suffstat_masked_blocks": [_I, _I, _I],
    # ss, rs, wty, G [B, H, H], Psi, mus, s2inv, xpt_sz, xpt_s, out, partial, B, S,
    # H, G, stream
    "evo_sssc_suffstat_masked": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _P],
    # ss, lpj, children, child_lpj, ss_new, vals, n_sub, idx, B, S, T, W, Mprime, stream
    "evo_varykn_merge": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@functools.cache
def build() -> dict:
    """Compile csrc/*.cu into one library unless it is built already.
    Returns {"lib": ctypes.CDLL, "seconds": float, "log": nvcc's output};
    raises if nvcc fails or overruns its time limit."""
    t0 = time.perf_counter()
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode() + src.read_bytes())
    out = BUILD_DIR / f"evo_kernels-{h.hexdigest()[:16]}.so"
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s") from None
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        f = getattr(lib, name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return {"lib": lib, "seconds": time.perf_counter() - t0, "log": log}


def entry(name: str):
    """The ctypes function of an extern "C" kernel entry point."""
    return getattr(build()["lib"], name)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
