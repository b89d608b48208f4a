#!/usr/bin/env python3
"""Run krypy_tpu_torch's two solves on one NVIDIA GPU: bench.py's
multigrid-CG Poisson solve and benchmarks/northstar.py's restarted-GMRES
convection-diffusion solve.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which raises on failure (the script then exits non-zero
before printing its last line):

1. device check: exits non-zero without a CUDA device; prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from ``krypy_tpu_torch/kernels/csrc``
   (first use; one nvcc per source, all started together) and prints the
   build time and ptxas report;
3. stencil parity: K1-K3 against their plain PyTorch versions on the
   card, float32 ``rtol=2e-6`` and the FMA-aware ``atol`` of
   ``krypy_tpu_torch.kernels.parity.fma_atol``: the V-cycle's Laplacian constants at the solves'
   buffers (4096^2, 1024^2, 512^2) and an edge shape, and K1's four uses
   with the north star's nonsymmetric convection-diffusion constants at
   4096^2 and 9x120; at 4096^2 and 1024^2 each kernel's device time
   (torch.profiler, mean of 10 calls), its plain version's, and, for the
   K1 matvec, ``F.conv2d``'s (TF32 off), beside the bound;
4. prefix-sweep parity: K4-K6 (float32 and float64) on the north star's
   basis (26 x 4096^2), each output held to its float64 value by
   ``krypy_tpu_torch.kernels.parity.PrefixCheck`` (a tolerance tied to
   one rounding of the sum's magnitude and to the plain version's own
   error), which must also reject each planted fault; device times at
   rows 13 and 26 beside the bound and the cuBLAS calls ``torch.mv``
   (K4), ``torch.addmv`` (K6) and the pair of them (K5);
5. the Poisson solve: bench.py's grid-padded lane at its own size,
   nx = 1023 (float32 CG with a multigrid V-cycle inside float64
   refinement to 1e-8); launch counters are zeroed just before it and
   read just after; the result is checked for convergence, the reference
   cycle and iteration counts, and against the same solve on the plain
   torch lane of the card; then both lanes timed, interleaved in
   alternating order, ``ROUNDS`` solves each;
6. the north-star solve (``krypy_tpu_torch.northstar.make_northstar``)
   at its own size, nx = 4095 (16,769,025 unknowns):
   up to 3 float32 GMRES(25) cycles (``ortho="cgs2_fused"``) per float64
   refinement cycle, left-preconditioned by the padded V-cycle; launch
   counters zeroed just before one warm solve and read just after (all
   six kernels must run); checked for the true float64 residual, against
   the plain lane (``impl="torch"``, ``ortho="cgs2"``) on refinement
   cycles, matvecs and the iterate; then both lanes timed alike,
   ``NS_ROUNDS`` solves each;
7. output: a JSON line of per-kernel results (``timed_by`` says, for
   each time, whether it is a profiled device time, ``"profiler"``, or
   the wall of back-to-back calls, ``"events"``, taken only where the
   profiler recorded no device events), then, as the last line,
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` also profiles one solve of each slice: device busy
share, device time by kernel (written to DIR) and the host time of the
V-cycle's parts.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

#: bench.py's grid: 1023^2 = 1,046,529 unknowns
NX = 1023
#: benchmarks/northstar.py's grid: 4095^2 = 16,769,025 unknowns
NS_NX = 4095
#: timed solves per lane in the Poisson timing phase
ROUNDS = 10
#: timed solves per lane in the north-star timing phase
NS_ROUNDS = 5
#: GMRES(25) keeps 26 basis rows; a cycle's mean active prefix is 13
NS_ROWS = (13, 26)
#: the card's published peaks (H100 SXM data sheet, 700 W): device memory
#: bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def bound(nbytes, flops):
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the float32 operations over the peak rate;
    returns ``(ms, "bytes" | "operations")``."""
    t_b, t_o = nbytes / PEAK_BYTES, flops / PEAK_F32
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def _padded_input(rng, nrows, ncols, device):
    """float32 buffer: normal values on the logical region, noise in the
    pads."""
    from krypy_tpu_torch import interop, ops

    R, P = ops.pad_rows_width(nrows), ops.pad_cols_width(ncols)
    buf = rng.standard_normal((R, P), dtype=np.float32)
    buf[:nrows, :ncols] = rng.standard_normal((nrows, ncols),
                                              dtype=np.float32)
    return interop.from_numpy(buf.reshape(-1), device), R, P


def _time_ms(fn, samples=20, per_sample=10):
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_sample)
    return statistics.median(times)


def _device_events(prof):
    """The device-side events (kernels, copies) of a profile."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _device_ms(fn, floor_ms, reps=10, tries=3):
    """``(ms, source)``: the device time of one call.  With ``source =
    "profiler"`` it is the summed duration of the kernels and copies the
    call runs, from torch.profiler, averaged over ``reps`` calls.  The
    profiler now and then drops device events, all of a profile's or
    some: a profile with none, or whose time is below ``floor_ms`` (the
    call's bound, which no complete profile can beat), is taken again.
    After ``tries`` such profiles the time comes from CUDA events around
    back-to-back calls instead (``source = "events"``), which also counts
    the gaps between launches and so is not a device time to read
    against a bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.time_range.elapsed_us()
                 for e in _device_events(prof)) / reps / 1e3
        if ms > 0 and ms >= floor_ms:
            return ms, "profiler"
    print(f"device time from CUDA events: {tries} profiles recorded no "
          f"device events or less than the bound", flush=True)
    return _time_ms(fn, samples=5, per_sample=reps), "events"


def _operator(n, kind):
    """Stencil coefficients ``(cc, cu, cd, cl, cr)``: the V-cycle's
    Laplacian on an n-grid (``"lap"``) or the north star's
    convection-diffusion (``"cd"``)."""
    if kind == "cd":
        from krypy_tpu_torch.northstar import cd_coeffs

        return cd_coeffs(n)
    h2 = (1.0 / (n + 1)) ** 2
    return (4.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2)


def _stencil_cases(nrows, ncols, kind):
    """(kernel, use, wrapper call, plain call, bytes, flops) for one
    logical grid: ``kind="lap"`` the V-cycle's own Laplacian constants
    (K1's four uses, K2, K3), ``kind="cd"`` K1's four uses with the north
    star's convection-diffusion coefficients."""
    from krypy_tpu_torch import ops
    from krypy_tpu_torch.kernels import stencil as kst

    R, P = ops.pad_rows_width(nrows), ops.pad_cols_width(ncols)
    A = _operator(nrows, kind)
    w = 0.8 / A[0]
    buf = 4 * R * P
    affine = {
        "matvec": (A, False, 0.0, 0.0),
        "step": (tuple(-w * c for c in A), True, 1.0, w),
        "residual": (tuple(-c for c in A), True, 0.0, 1.0),
        "presmooth": (tuple(-w * w * c for c in A), False, 2.0 * w, 0.0),
    }
    cases = []
    for use, (co, has_g, al, be) in affine.items():
        cases.append((
            "stencil5_affine", f"{kind} {use}",
            lambda u, g, co=co, has_g=has_g, al=al, be=be:
                kst.stencil5_affine(u, g if has_g else None, nx=R, ny=P,
                                    coeffs=co, ncols=ncols, nrows=nrows,
                                    alpha=al, beta=be),
            lambda u, g, co=co, has_g=has_g, al=al, be=be:
                kst.stencil5_affine_torch(
                    u.view(R, P), g.view(R, P) if has_g else None, co,
                    nrows, ncols, al, be).view(-1),
            # u (and g) read, out written; ~13 operations per element
            # (+2 per alpha/beta term)
            buf * (3 if has_g else 2), 15 * R * P,
        ))
    if kind == "cd":
        return cases
    for s in (1.0, 3.25):
        cases.append((
            "stencil5_jacobi2", f"lap s={s}",
            lambda u, g, s=s: kst.stencil5_jacobi2(
                u, g, nx=R, ny=P, coeffs=A, w=w, s=s, ncols=ncols,
                nrows=nrows),
            lambda u, g, s=s: kst.stencil5_jacobi2_torch(
                u.view(R, P), g.view(R, P), A, w, s, nrows, ncols).view(-1),
            3 * buf, 30 * R * P,
        ))
    rc = tuple(-c for c in A)
    cases.append((
        "stencil5_resrestrict_rows", "lap residual+rows",
        lambda u, g: kst.stencil5_resrestrict_rows(
            u, g, nx=R, ny=P, coeffs=rc, ncols=ncols, nrows=nrows),
        lambda u, g: kst.stencil5_resrestrict_rows_torch(
            u.view(R, P), g.view(R, P), rc, nrows, ncols).view(-1),
        # u and g read, the half-height output written; the three fine
        # residual rows and their weights per coarse output
        buf * 5 // 2, 25 * R * P,
    ))
    return cases


def _conv2d_matvec(u, R, P, A):
    """The library yardstick of K1's matvec use: one cuDNN convolution
    (TF32 off) with the 5-point weights on the zero-padded buffer.  On
    the logical region it computes the matvec (the main path's pads are
    zero); it writes garbage into the first pad row and column."""
    import torch

    cc, cu, cd, cl, cr = A
    wt = torch.tensor([[0.0, cu, 0.0], [cl, cc, cr], [0.0, cd, 0.0]],
                      dtype=u.dtype, device=u.device).view(1, 1, 3, 3)
    return torch.nn.functional.conv2d(u.view(1, 1, R, P), wt,
                                      padding=1).view(-1)


def stencil_phase(device):
    """Parity of K1-K3 with their plain versions at the solves' shapes and
    edge shapes; timings at 4096^2 and 1024^2."""
    import torch
    from krypy_tpu_torch import ops
    from krypy_tpu_torch.kernels.parity import fma_atol

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    report = {}
    for nrows, ncols, kind in ((NS_NX, NS_NX, "cd"), (9, 120, "cd"),
                               (NS_NX, NS_NX, "lap"), (NX, NX, "lap"),
                               (511, 511, "lap"), (9, 9, "lap")):
        u, R, P = _padded_input(rng, nrows, ncols, device)
        g, _, _ = _padded_input(rng, nrows, ncols, device)
        u64, g64 = u.double(), g.double()
        for name, use, kern, plain, nbytes, flops in _stencil_cases(
                nrows, ncols, kind):
            got = kern(u, g)
            want = plain(u, g)
            want64 = plain(u64, g64)
            torch.cuda.synchronize()
            err = (got - want).abs()
            atol = fma_atol(want, want64)
            max_err = float(err.max())
            if not bool(torch.all(err <= atol + 2e-6 * want.abs())) or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError(
                    f"{name} [{use}] at {nrows}x{ncols}: max abs err "
                    f"{max_err:.3e} exceeds rtol=2e-6, atol={atol:.3e}")
            entry = report.setdefault(name, {"max_abs_err": 0.0,
                                             "times": {}})
            entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            line = (f"parity {name:26s} {use:18s} {nrows}x{ncols} "
                    f"({R}x{P}) max_abs_err={max_err:.3e}")
            if nrows in (NS_NX, NX) and ncols == nrows:
                b_ms, b_by = bound(nbytes, flops)
                ms, ms_src = _device_ms(lambda: kern(u, g), b_ms)
                plain_ms, plain_src = _device_ms(lambda: plain(u, g), b_ms)
                call = _time_ms(lambda: kern(u, g))
                plain_call = _time_ms(lambda: plain(u, g))
                lib_ms = lib_src = None
                if use.endswith("matvec"):
                    # the library call on the zero-padded input of the
                    # main path
                    uz = ops.pad_grid_vec(
                        ops.unpad_grid_vec(u, nrows, ncols), nrows, ncols)
                    co = _operator(nrows, kind)
                    lib = _conv2d_matvec(uz, R, P, co)
                    ref = kern(uz, None)
                    lib_err = float((lib.view(R, P)[:nrows, :ncols]
                                     - ref.view(R, P)[:nrows, :ncols]
                                     ).abs().max())
                    lib_ms, lib_src = _device_ms(
                        lambda: _conv2d_matvec(uz, R, P, co), b_ms)
                    line += f" conv2d_ms={lib_ms:.5f} conv2d_err={lib_err:.2e}"
                entry["times"][(R, use)] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by,
                    timed_by=dict(ms=ms_src, plain_ms=plain_src,
                                  library_ms=lib_src))
                line += (f" device_ms kernel={ms:.5f} ({ms_src}) "
                         f"plain={plain_ms:.5f} ({plain_src})"
                         f" bound={b_ms:.5f} ({b_by})"
                         f" | per_call_ms kernel={call:.5f} "
                         f"plain={plain_call:.5f}")
            print(line, flush=True)
    return report


def ortho_phase(device):
    """K4-K6 on the north star's basis (26 rows of 4096^2), float32 at
    rows 13 and 26 and float64 at rows 13: each output held to its
    float64 value within the tolerance of
    :class:`krypy_tpu_torch.kernels.parity.PrefixCheck`, and each planted
    fault (a zeroed or dropped coefficient or update, a float32 sum of
    float64 inputs) shown to fail that check; device times (float32)
    beside the bound and the cuBLAS calls."""
    import torch
    from krypy_tpu_torch.kernels import orthogonalize as korth
    from krypy_tpu_torch.kernels.parity import PrefixCheck

    m, N = NS_ROWS[1], (NS_NX + 1) ** 2
    gen = torch.Generator(device=device).manual_seed(0)
    report = {k: {"max_abs_err": 0.0, "times": {}}
              for k in ("project_prefix", "apply_project", "update_prefix")}
    for dtype in (torch.float32, torch.float64):
        # a GMRES-like basis: rows of norm ~1, nearly orthogonal
        V = torch.randn(m, N, generator=gen, device=device, dtype=dtype)
        V /= math.sqrt(N)
        w = torch.randn(N, generator=gen, device=device, dtype=dtype)
        c = torch.randn(m, generator=gen, device=device, dtype=dtype)
        for rows in (NS_ROWS if dtype == torch.float32 else NS_ROWS[:1]):
            mask = (torch.arange(m, device=device) < rows - 2).to(dtype)
            got = {
                "project_prefix": (korth.project_prefix(V, w, mask,
                                                        rows=rows),),
                "apply_project": korth.apply_project(V, w, c, mask,
                                                     rows=rows),
                "update_prefix": (korth.update_prefix(V, w, c, rows=rows),),
            }
            plain = {
                "project_prefix": (korth.project_prefix_torch(
                    V, w, mask, rows),),
                "apply_project": korth.apply_project_torch(V, w, c, mask,
                                                           rows),
                "update_prefix": (korth.update_prefix_torch(V, w, c,
                                                            rows),),
            }
            check = PrefixCheck(V, w, c, mask, rows, plain)
            bad = check.failures(got)
            if bad:
                raise AssertionError(f"{dtype} rows={rows}: {bad} miss "
                                     "their float64 values")
            planted = check.assert_faults_caught(got)
            for name in got:
                err = max(float((g - p).abs().max())
                          for g, p in zip(got[name], plain[name]))
                print(f"parity {name:14s} {str(dtype):13s} rows={rows:2d} "
                      f"N={N} max_abs_err={err:.3e} (vs plain)", flush=True)
                if dtype == torch.float32:
                    report[name]["max_abs_err"] = max(
                        report[name]["max_abs_err"], err)
            print(f"parity prefix sweeps {dtype} rows={rows}: all {planted} "
                  "planted faults fail the check", flush=True)
            del check, got, plain
            if dtype != torch.float32:
                continue
            calls = {
                "project_prefix": (
                    lambda: korth.project_prefix(V, w, mask, rows=rows),
                    lambda: korth.project_prefix_torch(V, w, mask, rows),
                    lambda: torch.mv(V[:rows], w),
                    (rows + 1) * N * 4, 2 * rows * N),
                "apply_project": (
                    lambda: korth.apply_project(V, w, c, mask, rows=rows),
                    lambda: korth.apply_project_torch(V, w, c, mask, rows),
                    # no one call computes K5: the pair of calls
                    lambda: torch.mv(V[:rows], torch.addmv(
                        w, V[:rows].T, c[:rows], alpha=-1)),
                    (rows + 2) * N * 4, 4 * rows * N),
                "update_prefix": (
                    lambda: korth.update_prefix(V, w, c, rows=rows),
                    lambda: korth.update_prefix_torch(V, w, c, rows),
                    lambda: torch.addmv(w, V[:rows].T, c[:rows], alpha=-1),
                    (rows + 2) * N * 4, 2 * rows * N),
            }
            for name, (kern, pl, lib, nbytes, flops) in calls.items():
                b_ms, b_by = bound(nbytes, flops)
                ms, ms_src = _device_ms(kern, b_ms)
                plain_ms, plain_src = _device_ms(pl, b_ms)
                lib_ms, lib_src = _device_ms(lib, b_ms)
                pair = name == "apply_project"
                report[name]["times"][rows] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None if pair else lib_ms,
                    timed_by=dict(ms=ms_src, plain_ms=plain_src,
                                  library_ms=None if pair else lib_src))
                lib_label = ("mv+addmv pair" if pair
                             else "mv" if name == "project_prefix"
                             else "addmv")
                print(f"timing {name:14s} rows={rows:2d} N={N} device_ms "
                      f"kernel={ms:.5f} ({ms_src}) plain={plain_ms:.5f} "
                      f"({plain_src}) {lib_label}={lib_ms:.5f} ({lib_src}) "
                      f"bound={b_ms:.5f} ({b_by}) "
                      f"rate={nbytes / ms / 1e9:.3f} TB/s", flush=True)
        del V, w, c
        torch.cuda.empty_cache()
    return report


def make_solve(impl, device):
    """bench.py's padded-lane solve: returns ``solve(b) -> (result,
    info)``."""
    from krypy_tpu_torch import functional as F, ops

    nx = NX
    lap = ops.poisson_2d(nx, device=device)
    lap32 = ops.poisson_2d(nx, pad_cols=True, impl=impl, device=device)
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
        device=device)

    def inner(r32):
        r32 = ops.pad_grid_vec(r32, nx, nx)
        res = F.cg(lap32, r32, M=M, tol=1e-4, maxiter=12,
                   stagnation_window=4)
        return res._replace(x=ops.unpad_grid_vec(res.x, nx, nx))

    def solve(b):
        return F.refine_to(lap, b, inner, tol=1e-8, compiled=True)

    return solve, lap


def _check_solution(x, n, rel, hist, tol=1e-8):
    import torch

    if x.shape != (n,) or x.dtype != torch.float64 or not bool(
            torch.isfinite(x).all()):
        raise AssertionError(f"bad solution: {x.shape} {x.dtype}")
    if not rel <= tol or not float(np.min(hist)) <= tol:
        raise AssertionError(f"not converged: rel={rel:.3e}")


def solve_phase(device):
    """One Poisson solve through the kernels, with its launches counted
    and its result checked; returns the counts and both lanes' solve
    callables."""
    import torch
    from krypy_tpu_torch import kernels

    nx = NX
    solve, lap = make_solve("cuda", device)
    b = torch.ones(nx * nx, dtype=torch.float64, device=device)

    kernels.reset_launch_counts()
    res, info = solve(b)
    counts = kernels.launch_counts()

    hist = res.resnorms.cpu().numpy()
    x = res.x
    rel = float(torch.linalg.vector_norm(b - lap(x))
                / torch.linalg.vector_norm(b))
    print(f"solve nx={nx} N={nx * nx} wall_s={info['wall_s']:.6f} "
          f"warm_s={info['warm_s']:.3f} cycles={info['cycles']} "
          f"inner_iters={info['inner_iters']} rel={rel:.3e}", flush=True)
    print(f"solve outer residuals {hist.tolist()}", flush=True)
    print(f"solve launches (warm-up and timed solve) {counts}", flush=True)
    _check_solution(x, nx * nx, rel, hist)
    if info["cycles"] != 3 or not 17 <= info["inner_iters"] <= 21:
        raise AssertionError(
            f"cycles={info['cycles']} inner_iters={info['inner_iters']}, "
            "expected 3 and 17..21 (the JAX reference)")
    for name in ("stencil5_affine", "stencil5_jacobi2",
                 "stencil5_resrestrict_rows"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the solve")

    # reference: the same solve on the plain torch lane of the card
    solve_ref, _ = make_solve("torch", device)
    ref, ref_info = solve_ref(b)
    dx = float(torch.linalg.vector_norm(ref.x - x)
               / torch.linalg.vector_norm(ref.x))
    print(f"reference torch lane: wall_s={ref_info['wall_s']:.6f} "
          f"cycles={ref_info['cycles']} "
          f"inner_iters={ref_info['inner_iters']} rel_diff_x={dx:.3e}",
          flush=True)
    if not dx <= 1e-6:
        raise AssertionError(f"cuda lane differs from torch lane: {dx:.3e}")
    return counts, {"cuda": solve, "torch": solve_ref}, b


def northstar_phase(device):
    """The north-star solve on the kernel lane (warm, then one solve with
    its launches counted) and on the plain lane; checks; returns the
    counts and both lanes' solve callables."""
    import torch
    from krypy_tpu_torch import kernels
    from krypy_tpu_torch.northstar import kappa_bound, make_northstar

    nx = NS_NX
    b = torch.ones(nx * nx, dtype=torch.float64, device=device)
    out = {}
    for lane, impl, ortho in (("cuda", "cuda", "cgs2_fused"),
                              ("torch", "torch", "cgs2")):
        solve, cd64 = make_northstar(nx, impl, ortho, device)
        _, warm = solve(b)  # kernel build, first launches, warm-up solve
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        res, info = solve(b)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        hist = res.resnorms.cpu().numpy()
        rel = float(torch.linalg.vector_norm(b - cd64(res.x))
                    / torch.linalg.vector_norm(b))
        print(f"northstar lane={lane} ortho={ortho} nx={nx} N={nx * nx} "
              f"wall_s={info['wall_s']:.6f} warm_s={warm['warm_s']:.3f} "
              f"cycles={info['cycles']} inner_iters={info['inner_iters']} "
              f"matvecs={info['matvecs']} rel={rel:.3e} "
              f"peak_mem_GiB={peak:.3f}", flush=True)
        print(f"northstar lane={lane} outer residuals {hist.tolist()}",
              flush=True)
        print(f"northstar lane={lane} launches (one solve) {counts}",
              flush=True)
        _check_solution(res.x, nx * nx, rel, hist)
        out[lane] = (solve, res, info, counts, rel)

    (_, xc, ic, counts, rel_c), (_, xt, it, tcounts, rel_t) = (
        out["cuda"], out["torch"])
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} never launched in the "
                                 "north-star solve")
    if any(c != 0 for c in tcounts.values()):
        raise AssertionError(f"the plain lane launched kernels: {tcounts}")
    if ic["cycles"] != it["cycles"] or abs(ic["matvecs"]
                                           - it["matvecs"]) > 3:
        raise AssertionError(
            f"kernel lane {ic['cycles']} cycles / {ic['matvecs']} matvecs "
            f"against plain lane {it['cycles']} / {it['matvecs']}")
    # each iterate's relative error is at most kappa * its relative
    # residual, so the two differ by at most kappa * (rel_c + rel_t)
    kappa = kappa_bound(nx)
    tol = kappa * (rel_c + rel_t)
    dx = float(torch.linalg.vector_norm(xc.x - xt.x)
               / torch.linalg.vector_norm(xt.x))
    print(f"northstar kernel vs plain lane: rel_diff_x={dx:.3e} "
          f"tolerance kappa*(rel_c+rel_t)={kappa:.4e}*({rel_c:.3e}+"
          f"{rel_t:.3e})={tol:.3e}", flush=True)
    if not dx <= tol:
        raise AssertionError(f"iterates differ by {dx:.3e} > {tol:.3e}")
    return counts, {"cuda": out["cuda"][0], "torch": out["torch"][0]}, b


def timing_phase(label, solves, b, rounds):
    """Both lanes timed alike: ``rounds`` warm solves each, interleaved,
    the order alternating each round so that drift of the host's speed
    falls on both lanes."""
    walls = {lane: [] for lane in solves}
    for k in range(rounds):
        lanes = list(solves) if k % 2 == 0 else list(reversed(solves))
        for lane in lanes:
            walls[lane].append(solves[lane](b)[1]["wall_s"])
    for lane, ts in walls.items():
        print(f"timing {label} lane={lane} solves={len(ts)} wall_s "
              f"median={statistics.median(ts):.6f} min={min(ts):.6f} "
              f"max={max(ts):.6f} all={[round(t, 6) for t in ts]}",
              flush=True)
    diffs = [t - c for c, t in zip(walls["cuda"], walls["torch"])]
    print(f"timing {label} torch-minus-cuda per round: median="
          f"{statistics.median(diffs):.6f} min={min(diffs):.6f} "
          f"max={max(diffs):.6f}; cuda faster in "
          f"{sum(d > 0 for d in diffs)}/{rounds} rounds", flush=True)


def _profile_solve(label, solve, b, out_dir):
    """Host wall of one solve against its device busy time, and device
    time by kernel (all rows written to DIR, the top 20 printed)."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve(b)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = _device_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
    print(f"profile {label}: one solve, {wall:.6f} s under the profiler, "
          f"device busy {busy:.6f} s ({100 * busy / wall:.1f}%), "
          f"{len(events)} device kernels/copies", flush=True)
    by_name = {}
    for e in events:
        us, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), c + 1)
    rows = sorted(((us, c, k) for k, (us, c) in by_name.items()),
                  reverse=True)
    with open(os.path.join(out_dir, f"{label}_device_kernels.txt"),
              "w") as fh:
        for us, c, k in rows:
            fh.write(f"{us / 1e3:10.3f} ms {c:7d} x {us / c:9.2f} us  {k}\n")
    for us, c, k in rows[:20]:
        print(f"profile {label} {us / 1e3:9.3f} ms {c:7d} x {us / c:8.2f} us"
              f"  {k[:80]}", flush=True)
    with open(os.path.join(out_dir, f"{label}_ops.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="cpu_time_total",
                                           row_limit=60))


def _profile_vcycle(device):
    """Host time of the V-cycle's parts, synchronised: 20 samples of
    each, taken round-robin so that drift of the host's speed falls on
    all."""
    import torch
    from krypy_tpu_torch import ops

    kw = dict(coarse_sweeps=60, pad_cols=True, device=device)
    parts = {}
    for label, n in (("V-cycle from n=4095", NS_NX),
                     ("V-cycle from n=1023", NX),
                     ("levels 255..31", 255),
                     ("n=31 coarse solve (59 sweeps)", 31)):
        M = ops.multigrid_poisson_preconditioner(n, coarsest=31,
                                                 impl="cuda", **kw)
        r = torch.ones(M.shape[0], dtype=torch.float32, device=device)
        parts[label] = lambda M=M, r=r: M(r)
    A = ops.convection_diffusion_2d(NS_NX, pad_cols=True, impl="cuda",
                                    device=device)
    x = torch.ones(A.shape[0], dtype=torch.float32, device=device)
    parts["padded K1 matvec at 4096^2"] = lambda: A(x)
    samples = {label: [] for label in parts}
    for k in range(21):
        for label, fn in parts.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if k:  # the first round warms up
                samples[label].append((time.perf_counter() - t) * 1e3)
    for label, ts in samples.items():
        print(f"profile host ms: {label}: median "
              f"{statistics.median(ts):.3f} min {min(ts):.3f} "
              f"max {max(ts):.3f} (20 samples)", flush=True)


#: the TPU kernel each CUDA kernel replaces, and its row's timed use
KERNELS = {
    "stencil5_affine": ("krypy_tpu/kernels/stencil.py:137", "stencil5.cu",
                        (NS_NX + 1, "cd matvec")),
    "stencil5_jacobi2": ("krypy_tpu/kernels/stencil.py:344", "stencil5.cu",
                         (NS_NX + 1, "lap s=1.0")),
    "stencil5_resrestrict_rows": ("krypy_tpu/kernels/stencil.py:502",
                                  "stencil5.cu",
                                  (NS_NX + 1, "lap residual+rows")),
    "project_prefix": ("krypy_tpu/kernels/orthogonalize.py:279",
                       "orthogonalize.cu", NS_ROWS[0]),
    "apply_project": ("krypy_tpu/kernels/orthogonalize.py:306",
                      "orthogonalize.cu", NS_ROWS[0]),
    "update_prefix": ("krypy_tpu/kernels/orthogonalize.py:338",
                      "orthogonalize.cu", NS_ROWS[0]),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one solve of each slice, writing "
                         "tables to DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device visible to torch")
    smi = _smi()
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from krypy_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{_build.build_info['path']}", flush=True)
    for ln in _build.build_info["ptxas"].splitlines():
        if "registers" in ln or "Compiling" in ln or "spill" in ln:
            print(f"ptxas: {ln.strip()}", flush=True)

    device = torch.device("cuda", 0)
    report = stencil_phase(device)
    report.update(ortho_phase(device))
    _, solves, b = solve_phase(device)
    timing_phase("poisson", solves, b, ROUNDS)
    ns_counts, ns_solves, ns_b = northstar_phase(device)
    timing_phase("northstar", ns_solves, ns_b, NS_ROUNDS)
    if args.profile:
        _profile_solve("poisson", solves["cuda"], b, args.profile)
        _profile_solve("northstar", ns_solves["cuda"], ns_b, args.profile)
        _profile_vcycle(device)

    rows = []
    for name, (src, cu, key) in KERNELS.items():
        t = report[name]["times"][key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"krypy_tpu_torch/kernels/csrc/{cu}",
            "replaces": src, "launches": ns_counts[name],
            "max_abs_err": report[name]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            # "profiler": device time; "events": wall time of back-to-back
            # calls, taken where the profiler recorded no device events
            "timed_by": t["timed_by"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
