"""The multigrid-CG slice end to end: bench.py's padded-lane solve
(float32 multigrid-preconditioned CG inside float64 iterative refinement)
through both packages.

The JAX side runs its Pallas lane in interpret mode; the port runs its
cuda lane, whose kernel wrappers take their plain versions on the CPU.
Float32 reductions are summed in another order in the two frameworks, so
the inner iteration counts may move by one or two under the
``stagnation_window=4`` stop rule; the refinement cycle count may not
move, and both solves must reach the float64 target.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu_torch import functional as F, interop, ops

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_solve(nx, impl, compiled=True):
    lap = jops.poisson_2d(nx)
    lap32 = jops.poisson_2d(nx, pad_cols=True, impl=impl)
    M = jops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl)

    @jax.jit
    def inner(r32):
        r32 = jops.pad_grid_vec(r32, nx, nx)
        res = JF.cg(lap32, r32, M=M, tol=1e-4, maxiter=12,
                    stagnation_window=4)
        return res._replace(x=jops.unpad_grid_vec(res.x, nx, nx))

    b = jnp.ones(nx * nx, jnp.float64)
    return JF.refine_to(lap, b, inner, tol=1e-8, compiled=compiled)


def _torch_solve(nx, impl, compiled=True):
    lap = ops.poisson_2d(nx, device="cpu")
    lap32 = ops.poisson_2d(nx, pad_cols=True, impl=impl, device="cpu")
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
        device="cpu")

    def inner(r32):
        r32 = ops.pad_grid_vec(r32, nx, nx)
        res = F.cg(lap32, r32, M=M, tol=1e-4, maxiter=12,
                   stagnation_window=4)
        return res._replace(x=ops.unpad_grid_vec(res.x, nx, nx))

    b = torch.ones(nx * nx, dtype=torch.float64)
    return F.refine_to(lap, b, inner, tol=1e-8, compiled=compiled)


def _check_pair(jax_out, torch_out, x_rtol):
    (rj, ij), (rt, it) = jax_out, torch_out
    assert set(it) == set(ij)
    assert it["cycles"] == ij["cycles"]
    assert abs(it["inner_iters"] - ij["inner_iters"]) <= 2
    hist_j = np.asarray(rj.resnorms)
    hist_t = interop.to_numpy(rt.resnorms)
    assert hist_t.dtype == np.float64 and rt.x.dtype == torch.float64
    assert np.nanmin(hist_j) <= 1e-8 and hist_t.min() <= 1e-8
    assert int(rt.status) == F.CONVERGED == int(rj.status)
    xj, xt = np.asarray(rj.x), interop.to_numpy(rt.x)
    assert np.all(np.isfinite(xt))
    assert np.linalg.norm(xt - xj) <= x_rtol * np.linalg.norm(xj)


def test_bench_padded_solve_matches_jax_pallas_lane():
    """nx=511, the smallest grid whose fine levels reach the kernels
    (n >= 256): 3 cycles and ~17 inner iterations on both sides.  The
    solutions agree to 1e-6 relative: each solve's error is at most
    kappa(A) * rel, kappa ~ 1.1e5 at 511^2 and both residuals end below
    1e-11, so the two may differ by no more than ~2e-6, and in practice
    agree far closer."""
    nx = 511
    out_t = _torch_solve(nx, "cuda")
    assert out_t[1]["cycles"] == 3
    assert 15 <= out_t[1]["inner_iters"] <= 19
    _check_pair(_jax_solve(nx, "pallas"), out_t, x_rtol=1e-6)


def test_host_refine_matches_jax():
    """refine_to's host form (compiled=False) on the plain lanes."""
    nx = 63
    out_j = _jax_solve(nx, "jnp", compiled=False)
    out_t = _torch_solve(nx, "torch", compiled=False)
    assert "warm_s" not in out_t[1]
    _check_pair(out_j, out_t, x_rtol=1e-6)


def test_compiled_refine_warms_once():
    """compiled=True runs one hidden warm-up solve on the first call for
    an operator/solver pair and reports it as warm_s; later calls are
    not warmed again."""
    nx = 31
    lap = ops.poisson_2d(nx, device="cpu")
    calls = []

    def inner(r32):
        calls.append(1)
        return F.cg(lap, r32, tol=1e-4, maxiter=80)

    b = torch.ones(nx * nx, dtype=torch.float64)
    res, info = F.refine_to(lap, b, inner, tol=1e-8, compiled=True)
    first = len(calls)
    assert info["warm_s"] > 0.0 and first == 2 * info["cycles"]
    res2, info2 = F.refine_to(lap, b, inner, tol=1e-8, compiled=True)
    assert info2["warm_s"] == 0.0 and len(calls) == first + info2["cycles"]
    assert torch.equal(res.x, res2.x)


def test_import_leaves_jax_out():
    code = ("import sys, krypy_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('krypy_tpu.') or m == 'krypy_tpu' "
            "for m in sys.modules), 'krypy_tpu imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", ["krypy_tpu_torch", "chip_smoke.py"])
def test_port_sources_import_no_jax(name):
    """No source of the port, nor the chip smoke script, imports jax or
    the JAX package."""
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|krypy_tpu)(?:[.\s]|$)")
    root = os.path.join(REPO, name)
    paths = ([os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
              if f.endswith(".py")] if os.path.isdir(root) else [root])
    assert paths
    for p in paths:
        with open(p) as fh:
            bad = [ln.strip() for ln in fh if pattern.match(ln)]
        assert not bad, f"{p}: {bad}"
