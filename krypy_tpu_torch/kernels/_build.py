"""Build the CUDA sources at first use and load them with ctypes.

The sources in ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/krypy_tpu_torch/`` at the root of the checkout.  The library's
name carries a hash of the sources and flags, so a stale build is never
loaded.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "krypy_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: argtypes of every C entry point (pointers and the stream as void*)
SIGNATURES = {
    "krypy_stencil5_affine": [_P, _P, _P] + [_I] * 4 + [_F] * 7 + [_P],
    "krypy_stencil5_jacobi2": [_P, _P, _P] + [_I] * 4 + [_F] * 13 + [_P],
    "krypy_stencil5_resrestrict_rows": [_P, _P, _P] + [_I] * 4 + [_F] * 5
    + [_P],
}

_lib = None
#: what the last build reported: seconds, library path, ptxas output
build_info = {}


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "krypy_tpu_torch are built from source at first use"
        )
    return found


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load():
    """Return the loaded kernel library, building it if needed."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    so = BUILD_DIR / f"libkrypy_stencil5_{_digest()}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename, so a concurrent or
        # interrupted build never leaves a partial library behind
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            log = proc.stdout + proc.stderr
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                      ptxas=log)
    _lib = lib
    return lib
