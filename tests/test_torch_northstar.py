"""The north-star slice end to end: benchmarks/northstar.py's padded-lane
solve (``_tpu_compiled`` with ``NORTHSTAR_PAD=1``) through both packages.

The float64 refinement to 1e-8 wraps up to 3 float32 GMRES(25) cycles on
the h^2-equilibrated convection-diffusion system, left-preconditioned by
the padded multigrid V-cycle.  The port's side is
:func:`krypy_tpu_torch.northstar.make_northstar`, the pipeline the card
runs (``chip_smoke.py``); the JAX side is the same
pipeline written as northstar.py writes it, compiled, with its Pallas
kernels in interpret mode.

Float32 reductions are summed in another order in the two frameworks, so
the inner iteration counts may move: matvecs (northstar.py's count,
inner iterations + cycles + 1) within 2; the refinement cycle count may
not move, and both solves must reach the float64 target.  The same holds
for the one-reduce forms: ``cgs2_1r`` with the V-cycle on the left, and
with a bfloat16 basis and the V-cycle on the right.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu.functional.common import MAXITER, SolveResult
from krypy_tpu_torch import functional as F
from krypy_tpu_torch.northstar import make_northstar

torch.set_num_threads(1)


def _jax_northstar(nx, impl, ortho, basis="f32", precond="left"):
    h = 1.0 / (nx + 1)
    h2 = h * h
    h2_f32 = jnp.float32(h2)
    cd32 = jops.convection_diffusion_2d(nx, wind=(h2, 0.5 * h2), eps=h2,
                                        pad_cols=True, impl=impl)
    cd64 = jops.convection_diffusion_2d(nx, wind=(1.0, 0.5), eps=1.0)
    Ml = jops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
        scale=1.0 / h2)

    def inner_solve(r32):
        rs = jops.pad_grid_vec(r32 * h2_f32, nx, nx)
        rs_norm = jnp.maximum(jnp.linalg.norm(rs), 1e-30)
        xz = jnp.zeros_like(rs)

        def cond(c):
            return (c[0] < 3) & ~c[4]

        def body(c):
            i, x, bx, best, done, nit = c
            pk = {"Mr": Ml} if precond == "right" else {"Ml": Ml}
            res = JF.gmres(cd32, rs, x0=x, tol=1e-3, maxiter=25,
                           ortho=ortho,
                           basis_dtype=jnp.bfloat16 if basis == "bf16"
                           else None, **pk)
            rel = jnp.linalg.norm(rs - cd32(res.x)) / rs_norm
            better = rel < best
            return (i + 1, res.x, jnp.where(better, res.x, bx),
                    jnp.minimum(best, rel),
                    (~better) | (res.status == 0) | (res.status == 2),
                    nit + res.niter + 2)

        *_, bx, _, _, nit = lax.while_loop(
            cond, body, (jnp.asarray(0), xz, xz,
                         jnp.asarray(jnp.inf, jnp.float32),
                         jnp.asarray(False), jnp.asarray(0)))
        return SolveResult(x=jops.unpad_grid_vec(bx, nx, nx),
                           resnorms=jnp.zeros(1), niter=nit,
                           status=jnp.asarray(MAXITER))

    b = jnp.ones(nx * nx, jnp.float32)
    res, info = JF.refine_to(cd64, b, inner_solve, tol=1e-8, compiled=True)
    rel = float(jnp.linalg.norm(b - cd64(res.x)) / jnp.linalg.norm(b))
    return res, info, info["inner_iters"] + info["cycles"] + 1, rel


@pytest.mark.parametrize("nx,jax_impl,impl,ortho,basis,precond", [
    # the kernel lane: K1-K3 in the V-cycle and the matvec, K4-K6 in the
    # orthogonalization (plain versions on the CPU; JAX interpreted)
    (255, "pallas", "cuda", "cgs2_fused", "f32", "left"),
    # the plain lane the card compares the kernel lane with
    (63, "jnp", "torch", "cgs2", "f32", "left"),
    # the one-reduce forms (northstar.py's NORTHSTAR_ORTHO=cgs2_1r, and
    # with NORTHSTAR_BASIS=bf16 NORTHSTAR_PRECOND=right)
    (255, "pallas", "cuda", "cgs2_1r", "f32", "left"),
    (63, "pallas", "cuda", "cgs2_1r", "f32", "left"),
    (63, "pallas", "cuda", "cgs2_1r", "bf16", "right"),
])
def test_northstar_matches_jax(nx, jax_impl, impl, ortho, basis, precond):
    rj, ij, mv_j, rel_j = _jax_northstar(nx, jax_impl, ortho, basis,
                                         precond)
    solve, cd64 = make_northstar(nx, impl, ortho, "cpu", basis=basis,
                                 precond=precond)
    b = torch.ones(nx * nx, dtype=torch.float64)
    rt, it = solve(b)
    rel_t = float(torch.linalg.vector_norm(b - cd64(rt.x))
                  / torch.linalg.vector_norm(b))
    assert rt.x.dtype == torch.float64 and rt.x.shape == (nx * nx,)
    assert rel_j <= 1e-8 and rel_t <= 1e-8
    assert int(rt.status) == F.CONVERGED == int(rj.status)
    assert it["cycles"] == ij["cycles"]
    assert abs(it["matvecs"] - mv_j) <= 2
    assert it["matvecs"] == it["inner_iters"] + it["cycles"] + 1

