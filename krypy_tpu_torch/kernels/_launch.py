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
}


def launch_counts():
    """Copy of the per-kernel launch counters."""
    return dict(LAUNCHES)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch(name, fn_name, args, device):
    """Call the C entry point ``fn_name`` of the kernel library on the
    current stream of ``device``; raise if the launch was refused."""
    from . import _build

    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
