"""Build the CUDA sources at first use and load them with ctypes.

All sources in ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into ONE shared library with a plain C interface, under
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: per-source compile flags (each source to an object file)
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]
#: link flags (the objects into the shared library)
LINK_FLAGS = ARCH + ["-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: argtypes of every C entry point (pointers and the stream as void*)
SIGNATURES = {
    "krypy_stencil5_affine": [_P, _P, _P] + [_I] * 4 + [_F] * 7 + [_P],
    "krypy_stencil5_jacobi2": [_P, _P, _P] + [_I] * 4 + [_F] * 13 + [_P],
    "krypy_stencil5_resrestrict_rows": [_P, _P, _P] + [_I] * 4 + [_F] * 5
    + [_P],
}
for _sfx in ("f32", "f64"):
    SIGNATURES.update({
        # V, w, mask, partial, c, N, rows, m, blocks, threads, stream
        f"krypy_project_prefix_{_sfx}": [_P] * 5 + [_L] + [_I] * 4 + [_P],
        # V, w, c, mask, w1, partial, c2, N, rows, m, blocks, threads,
        # stream
        f"krypy_apply_project_{_sfx}": [_P] * 7 + [_L] + [_I] * 4 + [_P],
        # V, w, c, out, N, rows, blocks, threads, stream
        f"krypy_update_prefix_{_sfx}": [_P] * 4 + [_L] + [_I] * 3 + [_P],
        # V, B, w, mask, partial, w_out, coeffs, N, rows, m, blocks,
        # threads, stream
        f"krypy_cgs_project_{_sfx}": [_P] * 7 + [_L] + [_I] * 4 + [_P],
    })

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands together; wait for all of them, then raise if any
    failed.  Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}\n{err}")
    return "".join(o + e for o, e in outs)


def _compile(sources, so):
    """Compile every source in parallel, link, and move the library into
    place under its final name (so an interrupted build never leaves a
    partial library behind)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(sources, objs)])
        lib = str(Path(tmp) / so.name)
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, so)
    return log


def load():
    """Return the loaded kernel library, building it if needed."""
    global _lib
    if _lib is not None:
        return _lib
    so = BUILD_DIR / f"libkrypy_kernels_{_digest()}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        log = _compile(sorted(CSRC.glob("*.cu")), so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                      ptxas=log)
    _lib = lib
    return lib
