"""Witness of float32 CA-CG with the padded V-cycle in both packages.

``ca_cg(s=4)`` and ``cg`` with bench.py's inner budget (tol 1e-4, 12
iterations, stagnation window 4) on bench.py's padded Poisson with its
padded V-cycle (coarsest 31, 60 coarse sweeps) as ``M``, float32, b the
padded ones: in the JAX package (``jax.jit``) and in the port, both on
the CPU.  Prints one JSON line per solve: the per-block (CA-CG) or
per-iteration (CG) relative M-norm residuals, ``niter`` and ``status``.
In exact arithmetic CA-CG's k-th block equals CG's (k s)-th iterate.

    JAX_PLATFORMS=cpu python tests/torch_witness_ca_cg.py [NX] [--port]

``NX`` (default 1023) is 2^k - 1; ``--port`` also runs the port's side.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

INNER = dict(tol=1e-4, maxiter=12, stagnation_window=4)
VCYCLE = dict(coarsest=31, coarse_sweeps=60, pad_cols=True)


def _line(package, solver, nx, res, wall):
    hist = np.asarray(res.resnorms, dtype=np.float64)
    print(json.dumps({"package": package, "solver": solver, "nx": nx,
                      "resnorms": [None if h != h else float(h)
                                   for h in hist],
                      "niter": int(res.niter), "status": int(res.status),
                      "wall_s": wall}), flush=True)


def jax_side(nx):
    import jax
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, ops as jops

    lap = jops.poisson_2d(nx, pad_cols=True)
    Mg = jops.multigrid_poisson_preconditioner(nx, **VCYCLE)
    b = jops.pad_grid_vec(jnp.ones(nx * nx, jnp.float32), nx, nx)
    for name, solve in (
            ("ca_cg", lambda v: JF.ca_cg(lap, v, s=4, M=Mg, **INNER)),
            ("cg", lambda v: JF.cg(lap, v, M=Mg, **INNER))):
        t = time.perf_counter()
        res = jax.block_until_ready(jax.jit(solve)(b))
        _line("krypy_tpu", name, nx, res, time.perf_counter() - t)


def port_side(nx):
    import torch
    from krypy_tpu_torch import functional as F, ops

    A = ops.poisson_2d(nx, pad_cols=True, device="cpu")
    M = ops.multigrid_poisson_preconditioner(nx, device="cpu", **VCYCLE)
    b = ops.pad_grid_vec(torch.ones(nx * nx), nx, nx)
    for name, solve in (
            ("ca_cg", lambda v: F.ca_cg(A, v, s=4, M=M, **INNER)),
            ("cg", lambda v: F.cg(A, v, M=M, **INNER))):
        t = time.perf_counter()
        res = solve(b)
        _line("krypy_tpu_torch", name, nx, res, time.perf_counter() - t)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(args[0]) if args else 1023
    jax_side(n)
    if "--port" in sys.argv:
        port_side(n)
