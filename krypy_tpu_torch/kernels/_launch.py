"""Launch counters and the one place that calls into the kernel library.

Every wrapper launches its CUDA kernel through :func:`launch`, which adds
one to the wrapper's count after a launch the runtime accepted; a wrapper
that takes its plain version (CPU tensors) never gets here.  A run can
then show that it went through the kernels: zero the counts just before
it and read them just after.
"""

import torch

#: kernel launches per wrapper
LAUNCHES = {
    "stencil5_affine": 0,
    "stencil5_jacobi2": 0,
    "stencil5_resrestrict_rows": 0,
    "project_prefix": 0,
    "apply_project": 0,
    "update_prefix": 0,
    "cgs_project": 0,
    # K1's coarse form: one per launch, which also counts as a
    # stencil5_affine launch
    "stencil5_coarse": 0,
    # the sharded entries: one per call that launched its kernels
    "stencil5_sharded": 0,
    "cgs2_fused_sharded": 0,
}


#: the launches among ``LAUNCHES`` that computed a forward-mode tangent
#: (K1's rule under ``torch.func.jvp``); each is also its kernel's launch
TANGENT_LAUNCHES = {"stencil5_affine": 0}


def launch_counts():
    """Copy of the per-kernel launch counters."""
    return dict(LAUNCHES)


def tangent_counts():
    """Copy of the tangent-launch counters (a subset of the launches)."""
    return dict(TANGENT_LAUNCHES)


def reset_launch_counts():
    for counts in (LAUNCHES, TANGENT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _call(fn_name, args, device):
    """Call the C entry point ``fn_name`` of the kernel library on the
    current stream of ``device``; its CUDA error code."""
    from . import _build

    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return getattr(lib, fn_name)(*args, stream)


def launch(name, fn_name, args, device):
    """Call the C entry point ``fn_name`` on the current stream of
    ``device``; raise if the launch was refused."""
    err = _call(fn_name, args, device)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1


def copy_rows(dst, dpitch, src, spitch, width, height, device):
    """One asynchronous copy (``cudaMemcpy2DAsync``) of ``height`` rows of
    ``width`` bytes from address ``src`` (rows ``spitch`` bytes apart) to
    ``dst`` (``dpitch`` apart), between device and pinned host memory, on
    the current stream of ``device``; raises if it was refused.  Not a
    kernel launch: counted nowhere."""
    err = _call("krypy_copy_rows", (dst, dpitch, src, spitch, width, height),
                device)
    if err != 0:
        raise RuntimeError(f"copy_rows: cudaMemcpy2DAsync failed with CUDA "
                           f"error {err}")
