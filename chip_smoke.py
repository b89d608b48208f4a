#!/usr/bin/env python3
"""Run krypy_tpu_torch's multigrid-CG solve on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which raises on failure (the script then exits non-zero
before printing its last line):

1. device check: exits non-zero without a CUDA device; prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from ``krypy_tpu_torch/kernels/csrc``
   (first use) and prints the build time and ptxas report;
3. kernel parity: every kernel of the solve against its plain PyTorch
   version on the card, at the solve's buffers (1024x1024 and 512x512
   for logical 1023 and 511) and at an edge shape, float32
   ``rtol=2e-6`` and the FMA-aware ``atol`` of :func:`fma_atol`; then
   each kernel's time against
   its plain version: device time from torch.profiler (mean of 10 calls)
   and time per call with the host's dispatch (CUDA events, median of 20
   samples of 10 calls);
4. the solve: bench.py's grid-padded lane at its own size, nx = 1023
   (float32 CG with a multigrid V-cycle inside float64 refinement to
   1e-8); launch counters are zeroed just before it and read just after;
   the result is checked for convergence, the reference cycle and
   iteration counts, and against the same solve on the plain torch lane
   of the card;
5. timing: the solve on the kernel lane and on the plain torch lane,
   interleaved in alternating order, ``ROUNDS`` timed solves each, with
   the median, the range and the paired difference;
6. output: a JSON line of per-kernel results, then, as the last line,
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` also profiles one solve: device busy share, device
time by kernel (written to DIR) and the host time of the V-cycle's parts.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: bench.py's grid: 1023^2 = 1,046,529 unknowns
NX = 1023
#: timed solves per lane in the timing phase
ROUNDS = 10


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


def _padded_input(rng, n, device):
    """float32 buffer: normal values on the n x n logical region, noise
    in the pads."""
    from krypy_tpu_torch import interop, ops

    R, P = ops.pad_rows_width(n), ops.pad_cols_width(n)
    buf = rng.standard_normal((R, P))
    buf[:n, :n] = rng.standard_normal((n, n))
    return interop.from_numpy(buf.astype(np.float32).reshape(-1),
                              device), R, P


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


def _device_ms(fn, reps=10):
    """Device time of one call: the summed duration of the kernels and
    copies it runs, from torch.profiler, averaged over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    if not events:
        raise AssertionError("the profiler recorded no device time")
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


def fma_atol(want, want64):
    """Absolute tolerance of a kernel against its plain float32 version:
    the larger of ``2e-7 * max|want|`` and four times the plain version's
    own float32 rounding error (its distance from the same plain version
    in float64).  nvcc contracts multiply-adds to FMA, which skips
    roundings the plain version makes, so the two differ by a few ulps of
    the stencil's INTERMEDIATE terms; where those terms cancel, that is
    more than a few ulps of the output."""
    own = float((want.double() - want64).abs().max())
    return max(2e-7 * float(want.abs().max()), 4.0 * own)


def _kernel_cases(n):
    """(kernel, label, wrapper call, plain call) for one level size n,
    with the V-cycle's own constants for that level."""
    from krypy_tpu_torch.kernels import stencil as kst

    h2 = (1.0 / (n + 1)) ** 2
    lapc = (4.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2)
    w = 0.8 / (4.0 / h2)
    affine = {
        "matvec": (lapc, False, 0.0, 0.0),
        "step": (tuple(-w * c for c in lapc), True, 1.0, w),
        "residual": (tuple(-c for c in lapc), True, 0.0, 1.0),
        "presmooth": (tuple(-w * w * c for c in lapc), False, 2.0 * w, 0.0),
    }
    cases = []
    for label, (co, has_g, al, be) in affine.items():
        cases.append((
            "stencil5_affine", label,
            lambda u, g, R, P, co=co, has_g=has_g, al=al, be=be:
                kst.stencil5_affine(u, g if has_g else None, nx=R, ny=P,
                                    coeffs=co, ncols=n, nrows=n, alpha=al,
                                    beta=be),
            lambda u, g, R, P, co=co, has_g=has_g, al=al, be=be:
                kst.stencil5_affine_torch(
                    u.view(R, P), g.view(R, P) if has_g else None, co, n, n,
                    al, be).view(-1),
        ))
    for s in (1.0, 3.25):
        cases.append((
            "stencil5_jacobi2", f"s={s}",
            lambda u, g, R, P, s=s: kst.stencil5_jacobi2(
                u, g, nx=R, ny=P, coeffs=lapc, w=w, s=s, ncols=n, nrows=n),
            lambda u, g, R, P, s=s: kst.stencil5_jacobi2_torch(
                u.view(R, P), g.view(R, P), lapc, w, s, n, n).view(-1),
        ))
    rc = tuple(-c for c in lapc)
    cases.append((
        "stencil5_resrestrict_rows", "residual+rows",
        lambda u, g, R, P: kst.stencil5_resrestrict_rows(
            u, g, nx=R, ny=P, coeffs=rc, ncols=n, nrows=n),
        lambda u, g, R, P: kst.stencil5_resrestrict_rows_torch(
            u.view(R, P), g.view(R, P), rc, n, n).view(-1),
    ))
    return cases


def kernel_phase(device):
    """Parity of every kernel with its plain version at the solve's
    shapes and an edge shape; timings at 1024^2 and 512^2."""
    import torch

    rng = np.random.default_rng(0)
    report = {}
    for n in (1023, 511, 9):
        u, R, P = _padded_input(rng, n, device)
        g, _, _ = _padded_input(rng, n, device)
        u64, g64 = u.double(), g.double()
        for name, label, kern, plain in _kernel_cases(n):
            got = kern(u, g, R, P)
            want = plain(u, g, R, P)
            want64 = plain(u64, g64, R, P)
            torch.cuda.synchronize()
            err = (got - want).abs()
            atol = fma_atol(want, want64)
            max_err = float(err.max())
            if not bool(torch.all(err <= atol + 2e-6 * want.abs())) or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError(
                    f"{name} [{label}] at n={n}: max abs err {max_err:.3e} "
                    f"exceeds rtol=2e-6, atol={atol:.3e}")
            entry = report.setdefault(name, {"max_abs_err": 0.0,
                                             "times": []})
            entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            line = (f"parity {name:26s} {label:13s} n={n:4d} "
                    f"({R}x{P}) max_abs_err={max_err:.3e}")
            if n in (1023, 511):
                ms = _device_ms(lambda: kern(u, g, R, P))
                plain_ms = _device_ms(lambda: plain(u, g, R, P))
                call = _time_ms(lambda: kern(u, g, R, P))
                plain_call = _time_ms(lambda: plain(u, g, R, P))
                entry["times"].append((n, label, ms, plain_ms))
                line += (f" device_ms kernel={ms:.5f} plain={plain_ms:.5f}"
                         f" | per_call_ms kernel={call:.5f} "
                         f"plain={plain_call:.5f}")
            print(line, flush=True)
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


def solve_phase(device):
    """One solve through the kernels, with its launches counted and its
    result checked; returns the counts and both lanes' solve callables."""
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
    print(f"solve launches {counts}", flush=True)
    if x.shape != (nx * nx,) or x.dtype != torch.float64 or not bool(
            torch.isfinite(x).all()):
        raise AssertionError(f"bad solution: {x.shape} {x.dtype}")
    if not rel <= 1e-8 or not float(np.min(hist)) <= 1e-8:
        raise AssertionError(f"not converged: rel={rel:.3e}")
    if info["cycles"] != 3 or not 17 <= info["inner_iters"] <= 21:
        raise AssertionError(
            f"cycles={info['cycles']} inner_iters={info['inner_iters']}, "
            "expected 3 and 17..21 (the JAX reference)")
    for name, c in counts.items():
        if c <= 0:
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


def timing_phase(solves, b):
    """Both lanes timed alike: ``ROUNDS`` warm solves each, interleaved,
    the order alternating each round so that drift of the host's speed
    falls on both lanes."""
    walls = {lane: [] for lane in solves}
    for k in range(ROUNDS):
        lanes = list(solves) if k % 2 == 0 else list(reversed(solves))
        for lane in lanes:
            walls[lane].append(solves[lane](b)[1]["wall_s"])
    for lane, ts in walls.items():
        print(f"timing lane={lane} solves={len(ts)} wall_s "
              f"median={statistics.median(ts):.6f} min={min(ts):.6f} "
              f"max={max(ts):.6f} all={[round(t, 6) for t in ts]}",
              flush=True)
    diffs = [t - c for c, t in zip(walls["cuda"], walls["torch"])]
    print(f"timing torch-minus-cuda per round: median="
          f"{statistics.median(diffs):.6f} min={min(diffs):.6f} "
          f"max={max(diffs):.6f}; cuda faster in "
          f"{sum(d > 0 for d in diffs)}/{ROUNDS} rounds", flush=True)


def _profile(solve, b, out_dir, device):
    """Where one solve's time goes: host wall against device busy time,
    device time by kernel, and the host time of the V-cycle's parts."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    from krypy_tpu_torch import ops

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
    print(f"profile: one solve, {wall:.6f} s under the profiler, "
          f"device busy {busy:.6f} s ({100 * busy / wall:.1f}%), "
          f"{len(events)} device kernels/copies", flush=True)
    by_name = {}
    for e in events:
        us, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), c + 1)
    rows = sorted(((us, c, k) for k, (us, c) in by_name.items()),
                  reverse=True)
    with open(os.path.join(out_dir, "solve_device_kernels.txt"), "w") as fh:
        for us, c, k in rows:
            fh.write(f"{us / 1e3:10.3f} ms {c:7d} x {us / c:9.2f} us  {k}\n")
    for us, c, k in rows[:20]:
        print(f"profile {us / 1e3:9.3f} ms {c:7d} x {us / c:8.2f} us  "
              f"{k[:80]}", flush=True)
    with open(os.path.join(out_dir, "solve_ops.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="cpu_time_total",
                                           row_limit=60))

    # host time of the V-cycle's parts, synchronised: 20 samples of each,
    # taken round-robin so that drift of the host's speed falls on all
    kw = dict(coarse_sweeps=60, pad_cols=True, device=device)
    parts = {}
    for label, n in (("V-cycle from n=1023", NX),
                     ("levels 255..31", 255),
                     ("n=31 coarse solve (59 sweeps)", 31)):
        M = ops.multigrid_poisson_preconditioner(n, coarsest=31,
                                                 impl="cuda", **kw)
        r = torch.ones(M.shape[0], dtype=torch.float32, device=device)
        parts[label] = lambda M=M, r=r: M(r)
    A = ops.poisson_2d(NX, pad_cols=True, impl="cuda", device=device)
    x = torch.ones(A.shape[0], dtype=torch.float32, device=device)
    parts["padded matvec"] = lambda: A(x)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one solve, writing tables to DIR")
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
    report = kernel_phase(device)
    counts, solves, b = solve_phase(device)
    timing_phase(solves, b)
    if args.profile:
        _profile(solves["cuda"], b, args.profile, device)

    replaces = {
        "stencil5_affine": "krypy_tpu/kernels/stencil.py:137",
        "stencil5_jacobi2": "krypy_tpu/kernels/stencil.py:344",
        "stencil5_resrestrict_rows": "krypy_tpu/kernels/stencil.py:502",
    }
    timed_use = {"stencil5_affine": "step", "stencil5_jacobi2": "s=1.0",
                 "stencil5_resrestrict_rows": "residual+rows"}
    rows = []
    for name, src in replaces.items():
        n, _, ms, plain_ms = next(
            t for t in report[name]["times"]
            if t[0] == 1023 and t[1] == timed_use[name])
        rows.append({
            "name": name, "route": "cuda",
            "source": "krypy_tpu_torch/kernels/csrc/stencil5.cu",
            "replaces": src, "launches": counts[name],
            "max_abs_err": report[name]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
