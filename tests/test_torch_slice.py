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

import ast
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


def _jax_imports(tree):
    """The imports of ``jax`` or the JAX package in a module's AST: import
    statements at any depth, and ``__import__``/``import_module`` calls
    with a literal name."""
    def banned(name):
        return name == "jax" or name.startswith("jax.") or \
            name == "krypy_tpu" or name.startswith("krypy_tpu.")

    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if banned(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and banned(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in ("__import__", "import_module") and banned(
                    node.args[0].value):
                found.append(node.args[0].value)
    return found


@pytest.mark.parametrize("name", ["krypy_tpu_torch", "chip_smoke.py"])
def test_port_sources_import_no_jax_by_ast(name):
    """Walking the AST of every module of the port (the reference-
    compatible lane's ``linsys``, ``deflation``, ``arnoldi``, ``utils``,
    ``_convenience``, ``core.projections``, ``pseudospectra``,
    ``checkpoint`` and the ``recycling`` package, and the functional
    lane's ``lsq``, ``randomized``, ``svd``, ``arnoldi``, ``shifted``,
    ``chebyshev``, ``funm``, ``block`` and ``sketch`` among them) and of
    the
    chip smoke script finds no import of jax or the JAX package."""
    root = os.path.join(REPO, name)
    paths = ([os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
              if f.endswith(".py")] if os.path.isdir(root) else [root])
    names = {os.path.relpath(p, REPO) for p in paths}
    if name == "krypy_tpu_torch":
        assert {f"krypy_tpu_torch/{m}.py" for m in (
            "linsys", "deflation", "arnoldi", "_convenience",
            "utils/__init__", "core/projections", "pseudospectra",
            "checkpoint", "recycling/__init__", "recycling/generators",
            "recycling/factories", "recycling/evaluators",
            "recycling/linsys", "functional/lsq", "functional/randomized",
            "functional/svd", "functional/arnoldi",
            "functional/shifted", "functional/chebyshev", "functional/funm",
            "functional/block", "functional/sketch")} <= names
    for p in paths:
        with open(p) as fh:
            tree = ast.parse(fh.read(), p)
        assert not _jax_imports(tree), (p, _jax_imports(tree))


def _public_surface(path, names=None):
    """The public surface of a module by its AST: for each name of its
    ``__all__`` (or of ``names``), a function's positional and
    keyword-only parameters with their defaults as source (``jnp.``/
    ``torch.`` dtypes read alike), or a NamedTuple's fields with their
    defaults."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    defs = {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    if names is None:
        names = next(ast.literal_eval(n.value) for n in tree.body
                     if isinstance(n, ast.Assign) and any(
                         getattr(t, "id", None) == "__all__"
                         for t in n.targets))

    def src(node):
        return None if node is None else re.sub(
            r"^(jnp|torch|np)\.", "", ast.unparse(node))

    out = {}
    for name in names:
        node = defs[name]
        if isinstance(node, ast.FunctionDef):
            a = node.args
            pos = a.posonlyargs + a.args
            dflt = [None] * (len(pos) - len(a.defaults)) + a.defaults
            out[name] = ([(p.arg, src(d)) for p, d in zip(pos, dflt)],
                         [(p.arg, src(d)) for p, d in zip(
                             a.kwonlyargs, a.kw_defaults)],
                         a.vararg is not None, a.kwarg is not None)
        else:
            out[name] = [(f.target.id, src(f.value)) for f in node.body
                         if isinstance(f, ast.AnnAssign)]
    return list(names), out


@pytest.mark.parametrize("module,extra", [
    ("functional/chebyshev", ()),
    ("functional/funm", ("FunmResult",)),
    ("functional/block", ()),
    ("functional/sketch", ("padded_kron_sketch",)),
    ("ops", ("chebyshev_preconditioner",)),
])
def test_funm_lane_names_and_signatures_match_jax_by_ast(module, extra):
    """The public names of the Chebyshev, matrix-function, block and
    sketched modules (and ``ops.chebyshev_preconditioner``), their
    parameters, defaults and result fields, as the JAX modules declare
    them, read from both sources' ASTs."""
    jpath = os.path.join(REPO, "krypy_tpu", f"{module}.py")
    tpath = os.path.join(REPO, "krypy_tpu_torch", f"{module}.py")
    if module == "ops":
        jnames, jsurf = _public_surface(jpath, extra)
        tnames, tsurf = _public_surface(tpath, extra)
        assert "chebyshev_preconditioner" in _public_surface(tpath)[0]
    else:
        jnames, jsurf = _public_surface(jpath)
        tnames, tsurf = _public_surface(tpath)
        assert jnames == tnames
        for name in extra:
            jsurf.update(_public_surface(jpath, [name])[1])
            tsurf.update(_public_surface(tpath, [name])[1])
    assert jsurf == tsurf


def _imports_of(tree, banned):
    """Every import in a module's AST (at any depth, and by a literal
    ``__import__``/``import_module`` call) of a package in ``banned``."""
    def hit(name):
        return name.split(".")[0] in banned

    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if hit(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and hit(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in ("__import__", "import_module") and hit(
                    node.args[0].value):
                found.append(node.args[0].value)
    return found


@pytest.mark.parametrize("name", ["krypy_tpu_torch", "chip_smoke.py"])
def test_port_sources_import_no_contourpy_or_orbax(name):
    """The card's machine has neither contourpy (nor matplotlib, which
    brings it here) nor orbax: the port extracts level sets itself and
    checkpoints to ``.npz``, and no source imports them."""
    root = os.path.join(REPO, name)
    paths = ([os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
              if f.endswith(".py")] if os.path.isdir(root) else [root])
    assert paths
    for p in paths:
        with open(p) as fh:
            tree = ast.parse(fh.read(), p)
        bad = _imports_of(tree, {"contourpy", "matplotlib", "orbax"})
        assert not bad, (p, bad)
