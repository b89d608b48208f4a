#!/usr/bin/env python3
"""Run krypy_tpu_torch's solves on one NVIDIA GPU: bench.py's
multigrid-CG Poisson solve, benchmarks/northstar.py's restarted-GMRES
convection-diffusion solve, the Ritz-deflated and recycling GMRES of
benchmarks/suite.py's config 4 (shifted Laplacian) at the north star's
size, its configs 1-3 (GMRES on the README diagonal; CG and MINRES with
a weighted inner product and the unpadded V-cycle; restarted GMRES with
``Ml``, ``M`` and ``Mr``), its config 5 (Newton-Krylov on a nonlinear
Schrödinger residual, recycled Jacobian solves, K1 under
``torch.func.jvp``), and the multi-device path on rank processes that
share the card.

    python3 chip_smoke.py [--profile DIR | --witness | --mesh-faults |
                           --only {stencil,ortho,baseline,kernels,config5,
                                  mesh,onereduce}]

Phases, each of which raises on failure (the script then exits non-zero
before printing its last line):

1. device check: exits non-zero without a CUDA device; prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from ``krypy_tpu_torch/kernels/csrc``
   (first use; one nvcc per source, all started together) and prints the
   build time and ptxas report;
3. stencil parity: K1-K3 against their plain PyTorch versions on the
   card, float32 ``rtol=2e-6`` and the FMA-aware ``atol`` of
   ``krypy_tpu_torch.kernels.parity.fma_atol``: the V-cycle's Laplacian
   constants at the solves' kernel levels (buffers 4096^2, 2048^2,
   1024^2, 512^2) and at edge shapes (one strip and one step of K2, a
   region one row and one column short of them), and K1's four uses
   with the north star's nonsymmetric convection-diffusion constants at
   4096^2 and 9x120; at the four kernel levels each kernel's device time
   (torch.profiler, mean of 10 calls), its plain version's, and, for the
   K1 matvec and collapsed presmooth, ``F.conv2d``'s (TF32 off), beside
   the bound; then K1's coarse form (``stencil5_coarse``: the coarsest
   level's 60 damped-Jacobi sweeps in one launch) at 31^2 unpadded, 31^2
   in 32x128 and 127^2, 1, 2 and 60 sweeps, against its plain version,
   timed beside the 60 per-sweep K1 launches it replaces; then K8's
   kernel alone (``stencil5_halo``: K1's tiles reading the halo rows) at
   4096^2, at the 4-rank block 1024x4096 and at 4095^2, with random halo
   rows on the card and in pinned host memory, against its plain version,
   with null halos bit for bit K1's matvec, split into the interior rows
   and the two edge rows bit for bit one launch, timed at 1024x4096
   beside K1 on the block; then K10, the
   ``laplacian_2d_kernel`` entry over K1, against
   ``ops.poisson_2d(impl="torch")`` at 1024^2 and at 1021x1000;
4. prefix-sweep parity: K4-K6 (float32 and float64) on the north star's
   basis (26 x 4096^2), each output held to its float64 value by
   ``krypy_tpu_torch.kernels.parity.PrefixCheck`` (a tolerance tied to
   one rounding of the sum's magnitude and to the plain version's own
   error), which must also reject each planted fault; device times at
   rows 13 and 26 beside the bound and the cuBLAS calls ``torch.mv``
   (K4), ``torch.addmv`` (K6) and the pair of them (K5);
5. projection parity: K7 (``cgs_project``), float32 and float64, rows 13
   and 26 of 26 x 4096^2, subtracting along ``V`` itself and along a
   second basis, and at ragged N (4097, 600001, 600002, 600003: every
   residue mod 4, rows off 16-byte alignment): held to float64 by
   ``parity.ProjectCheck`` (coefficients as K4's; ``w'`` elementwise
   against the coefficients that came with it), planted faults rejected
   (coefficients zeroed, a row dropped, ``V`` in place of the second
   basis, a float32 sum of float64 inputs), a repeated call bit-identical;
   float32 device times beside the bound and the pair of cuBLAS calls;
6. the Poisson solve: bench.py's grid-padded lane at its own size,
   nx = 1023 (float32 CG with a multigrid V-cycle inside float64
   refinement to 1e-8); launch counters are zeroed just before it and
   read just after; the result is checked for convergence, the reference
   cycle and iteration counts, and against the same solve on the plain
   torch lane of the card; then both lanes timed, interleaved in
   alternating order, ``ROUNDS`` solves each;
7. the north-star solve (``krypy_tpu_torch.northstar.make_northstar``)
   at its own size, nx = 4095 (16,769,025 unknowns):
   up to 3 float32 GMRES(25) cycles (``ortho="cgs2_fused"``) per float64
   refinement cycle, left-preconditioned by the padded V-cycle; launch
   counters zeroed just before one warm solve and read just after (K1-K6
   must run); checked for the true float64 residual, against
   the plain lane (``impl="torch"``, ``ortho="cgs2"``) on refinement
   cycles, matvecs and the iterate; then both lanes timed alike,
   ``NS_ROUNDS`` solves each; then the stencil and prefix-sweep kernels
   ranked by launches x (time - bound) per V-cycle level of that solve
   (one JSON line); then the host ms of one V-cycle application (padded
   4095^2 and 1023^2, unpadded 4095^2) with the coarse form and with it
   switched off, and the launches of each (one JSON line);
8. config 4 (``krypy_tpu_torch.suite.make_config4``) on the kernel lane
   (``impl="cuda"``, ``ortho="cgs2_pallas"``: K1-K3 and K7) and on the
   plain lane (``impl="torch"``, ``ortho="cgs2"``): one GMRES cycle with
   ``return_internal``, six Ritz vectors, then the refined solve with
   ``deflated_gmres`` and, for comparison, with plain ``gmres``.  At the
   north star's size, nx = 4095: the harvest and the UNdeflated solve,
   gated (true float64 residual 1e-8, the lanes against each other);
   the deflated solve does not converge there (its first float32 cycle
   raises the float64 residual above 1 and refinement stops: ROADMAP.md
   queue C), which is asserted, with four cycles run by hand that must
   end below 1e-8, so that any change of that behaviour fails the run.
   At nx = 1023 (``"reduced_from": 4095``), both solves, every gate: the
   lanes agree in refinement cycles, in inner iterations within 3 and in
   the iterate; the deflated solves of both lanes timed alike,
   ``C4_ROUNDS`` each.  At both sizes K7 must have been launched twice
   per GMRES iteration and K4-K6 not at all; one JSON line per size;
9. the recycling sequence (``suite.recycling_sequence``) at nx = 4095:
   four shifted systems through ``RecyclingGmres``, and the same four by
   plain GMRES, on both lanes, the lanes' iteration counts within 3 of
   each other; the recycled solves' true residuals are recorded beside
   the unrecycled ones' (``recycled_iterates_usable``); one JSON line;
10. the baseline phase (benchmarks/suite.py's configs 1-3,
   ``krypy_tpu_torch.suite``): K1 through the ``stencil5_pipelined``
   entry on every odd-width level of configs 2 and 3's unpadded V-cycle
   (4095^2 down to the coarsest, 31^2), on a ragged 1021x1000 grid and
   on small ones, with the Laplacian and config 3's convection-diffusion
   constants (and the ragged grid with its operand 1, 2, 3 floats off
   16-byte alignment), against its plain version (the stencil phase's
   tolerance), timed at every level beside the bound and ``F.conv2d``;
   the unpadded level Laplacian as K1 and as the plain stencil, per call,
   at every level size (the crossover behind K1 at every level); K7 at
   config 3's shape (along a second basis, 31 x 4095^2, rows 16, 30 and
   31, and with N one and two columns larger), held as in phase 5 and
   timed; config 1
   against the JAX package's recorded count (``C1_JAX``); config 2 (CG
   and MINRES, float32 inside float64 refinement to 1e-8) at 4095^2 on
   the kernel lane (``impl="cuda"``: K1 in the matvec and at every
   V-cycle level) and the plain lane, each warm, then once with its
   launches counted: true float64 residual at most 1e-8, equal
   refinement cycles, K1 the only kernel of the kernel lane and none on
   the plain lane; the lanes' inner iterations within 3 at 1023^2
   (``C2_GATE_NX``, ``"reduced_from": 4095``; above it the totals depend
   on the rounding, ROADMAP.md queue C, and each cycle is bounded
   instead: first cycles within 1, none past the plain lane's longest
   plus 1); config 3 (restarted GMRES(30) with
   ``Ml``, ``M``, ``Mr``, ``compiled=True``) at 4095^2, the kernel lane
   with ``ortho="cgs2_pallas"`` (K1, and K7 twice per iteration along the
   dual basis P), the plain lane with ``cgs2``, gated as config 2 with
   the inner iterations; then both configs' lanes timed, ``BL_ROUNDS``
   interleaved solves each, with the device busy share of one profiled
   solve; one JSON line per config;
11. config 5 (``suite.config5_nls_newton_recycling``): K1's forward-mode
   rule first, ``torch.func.jvp`` of K1 (matvec and affine form) at
   96^2, 1023^2 and 1021x1000 and of config 5's ``F`` at 96^2 and 1023^2
   against the plain versions' (the stencil phase's tolerance; two K1
   launches per jvp, one counted as a tangent, ``kernels.tangent_counts``),
   timed
   beside the forward call, the plain jvp and ``F.conv2d`` on the pair;
   then config 5 and 5a (``AutoRecyclingGmres``; the plain lane replays
   the kernel lane's clock so that both choose from one) at 96^2 on the
   kernel lane (``impl="cuda"``: K1 in ``F`` and in each Jacobian
   action's tangent) and the plain lane, warm, then counted: both
   converged in the JAX package's 5 Newton steps (``C5_JAX``), inner
   iterations within 3 of the plain lane's, K1 launched ``1 + f_calls +
   jvp_calls`` times (once per call of ``F``, once per tangent, once for
   the manufactured source) and no other kernel, none on the plain lane,
   5a's widths in ``C5_WIDTHS`` and equal; then config 5 at 1023^2 and
   511^2 with the same gates (Newton steps within 1 of the plain lane's
   and the JAX package's, inner iterations within 3 where neither solve
   reaches the cap of 250), ``C5_ROUNDS`` interleaved sequences per lane
   timed on ``serve_s`` (the first, counted, round gated), and at 1023^2
   the device busy share of one profiled sequence of the kernel lane;
   one JSON line per grid and config;
   ``--only config5`` runs just it;
11b. the one-reduce phase (``--only onereduce``): the ``"cuda"`` row of
   ``functional.policy`` measured (a 1 GiB float32 device copy; an NCCL
   all-reduce of one element on a one-rank world with its host read);
   the north star at 4095^2 in its ``cgs2_1r`` LEFT and bfloat16 x
   ``cgs2_1r`` RIGHT forms (benchmarks/northstar.py's
   ``NORTHSTAR_ORTHO``/``BASIS``/``PRECOND``) on both lanes, warm, then
   counted: converged to 1e-8, the cycles of the ``cgs2_fused`` kernel
   lane run here and inner iterations per cycle within 3 of it (bf16:
   between its own lanes), K1-K3 launched as the matvec identity of
   ``_ns_launch_identity`` says (one more matvec per GMRES call for the
   lag), then 3 interleaved solves per lane and the busy share; every
   classic / one-reduce pair of benchmarks/onereduce_bench.py that the
   port has (``OR_PAIRS``) solved to 1e-6 at 1023^2 (V-cycle
   preconditioned; the bfloat16 pair to 1e-2) within 3 iterations of its
   classic lane (+1 for the lag) and an explicit residual within 10 x
   tol, then slope-timed at tol 0, K = 20 and 40, median of 3, at 1023^2
   and 4095^2 on both lanes, and the H100's extra-sweep ratios beside
   the JAX package's; one JSON line;
12. the mesh phase: single-device references in this process (K1's
   matvec and K4 -> K5 -> K6 at 4096^2, and the main path below), then
   worlds of rank processes (``--mesh-rank``), all on ``cuda:0`` (NCCL
   takes no two ranks on one card): NCCL of 1 rank, gloo of 2 and 4.
   Each rank holds K8 (``stencil5_sharded``) and K9
   (``cgs2_fused_sharded``), gathered, against their plain versions in
   float64 and against the single-device kernels (K8 also bit for bit
   against K1's matvec, in each order against the exchange and each
   route of the rows gloo receives; with the planted halo fault of
   ``--mesh-faults`` its rows next to a neighbour must move and no
   other), and K4-K6 on its own columns through ``PrefixCheck``; times
   K8 and K9 per shard, K8 in each order and route and as the earlier
   composition it replaced (device ms per shard and host ms per call),
   and the collectives on the host; then runs the main path on the mesh,
   convection-diffusion and Poisson at 4096^2 with Jacobi: restarted
   GMRES(25) x 3 cycles (``cgs2_fused``), CG x 100 (on a seeded random
   right-hand side: with b = ones the Poisson system is symmetric about
   its middle row, and a rank-local inner
   product would not change CG's ratios on 2 ranks), two
   ``RecyclingGmres(6, "sm")`` solves, the restarted GMRES with
   ``cgs2_1r`` and the CG with ``variant="1r"`` (ONE all-reduce per
   iteration plus the fixed per-solve ones of ``MESH_1R_FIXED``), and a
   GMRES(25) cycle with ``ortho="auto"`` (its pick, read off its
   all-reduces, against ``policy.fused_sharded_wins`` for the shard),
   launch and collective counts zeroed just before each and read just
   after.  Gated against
   one device: iteration and matvec counts equal, residual histories
   within ``MESH_RTOL`` and the same bits on every rank, K8 once per
   matvec, K9 once per GMRES iteration, three all-reduces per GMRES
   iteration, one halo exchange per matvec, the second recycled solve
   deflated.  Any rank's failure or the world's deadline fails the run.
   The times are per shard on ONE card: no multi-GPU speed-up;
13. output: a JSON line of configs 2 and 3's walls, a JSON line of
   per-kernel results (K1's forward-mode tangent as a row of its own,
   ``stencil5_affine_jvp``, with config 5's launches; ``timed_by`` says,
   for
   each time, whether it is a profiled device time, ``"profiler"``, or
   the wall of back-to-back calls, ``"events"``, taken only where the
   profiler recorded no device events), then, as the last line,
   ``{"ok": true, "device": {...}}``.

``--witness`` runs only the witnesses of config 4's and config 2's
float32 findings (float64 inner arithmetic at three sizes, the six
pairings of ``impl`` and two-pass ``ortho`` at 4095^2; config 2 at
4095^2 cycle by cycle on both lanes, with the right-hand side times 3
and in float64) and prints no result line.
``--mesh-faults`` runs only the mesh phase's main path, on one device and
on a gloo world of 2 ranks, sound and with each planted fault (a zeroed
halo, an unreduced inner product), and fails unless ``MESH_RTOL`` lies
between the sound readings and the faults' (the unreduced inner product
reaches the one-reduce solves through their initial norms and must be
caught there); it prints no result line.
``--only stencil`` (``ortho``, ``baseline``, ``mesh``) runs only the
stencil phase (the prefix-sweep phase, the baseline phase, the mesh
phase) and prints no result line;
a copy of the script in a checkout of an earlier commit times that
commit's K1-K3 (K4-K6) at the same shapes, in the same way.  ``--only
kernels`` times K1's matvec at every V-cycle buffer, K4, and K7 split by
phase on aligned, offset and config-3 bases (one JSON line), for such
comparisons.
``--profile DIR`` also profiles one solve of each slice: device busy
share, device time by kernel (written to DIR), and the host time of the
deflated solve's parts (the oblique projection, the deflation's set-up,
the Ritz hand-off); the V-cycle's host time is the default run's
``vcycle_host_ms``.
"""

import argparse
import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

#: bench.py's grid: 1023^2 = 1,046,529 unknowns
NX = 1023
#: benchmarks/northstar.py's grid: 4095^2 = 16,769,025 unknowns
NS_NX = 4095
#: timed solves per lane in the Poisson timing phase
ROUNDS = 5
#: timed solves per lane in the north-star timing phase
NS_ROUNDS = 3
#: timed deflated solves per lane in the config-4 timing phase
C4_ROUNDS = 3
#: config 4's sizes: the north star's, at which the undeflated pair is
#: gated and the deflated solve's known failure is asserted, and the cut
#: at which the deflated pair is gated (ROADMAP.md queue C)
C4_FULL = NS_NX
C4_NX = 1023
#: the lanes' allowed difference in the undeflated solve at ``C4_FULL``,
#: (refinement cycles, inner iterations): one cycle of GMRES(25) and 3.
#: At this size the late float32 cycles run out their 25 iterations short
#: of the inner tolerance, and what such a cycle gains depends on the
#: rounding: the six pairings of ``impl`` and two-pass ``ortho`` (one
#: algorithm) need 4 or 5 cycles (``--witness``; ROADMAP.md queue C), so
#: equal cycles and 3 iterations, the rule at ``C4_NX``, cannot hold here
C4_FULL_SLACK = (1, 28)
#: GMRES(25) keeps 26 basis rows; a cycle's mean active prefix is 13
NS_ROWS = (13, 26)
#: the north star's V-cycle levels that run the stencil kernels (n >=
#: 256), finest first; Poisson's are the last two
KERNEL_LEVELS = (NS_NX, 2047, NX, 511)
#: the mesh phase's grid: 4096^2 (its rows divide over 1, 2 and 4 ranks;
#: the north star's 4095 does not); the stencil phase checks K8's kernel
#: on it too
MESH_NX = 4096
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
    """The library yardstick of K1's matvec and collapsed-presmooth uses:
    one cuDNN convolution (TF32 off) with the 5-point weights ``A`` on the
    zero-padded buffer.  On the logical region it computes the use (the
    main path's pads are zero); it writes garbage into the first pad row
    and column."""
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
                               *((n, n, "lap") for n in KERNEL_LEVELS),
                               (9, 9, "lap"), (8, 128, "lap"),
                               (7, 127, "lap")):
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
            if nrows in KERNEL_LEVELS and ncols == nrows and (
                    kind == "lap" or nrows == NS_NX):
                b_ms, b_by = bound(nbytes, flops)
                ms, ms_src = _device_ms(lambda: kern(u, g), b_ms)
                plain_ms, plain_src = _device_ms(lambda: plain(u, g), b_ms)
                call = _time_ms(lambda: kern(u, g))
                plain_call = _time_ms(lambda: plain(u, g))
                lib_ms = lib_src = None
                if use.endswith(("matvec", "presmooth")):
                    # the library call on the zero-padded input of the
                    # main path; the collapsed presmooth alpha*u + S(u)
                    # is one convolution too, alpha on the centre weight
                    uz = ops.pad_grid_vec(
                        ops.unpad_grid_vec(u, nrows, ncols), nrows, ncols)
                    co = _operator(nrows, kind)
                    if use.endswith("presmooth"):
                        w = 0.8 / co[0]
                        co = (-w * w * co[0] + 2.0 * w,
                              *(-w * w * c for c in co[1:]))
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
    report["stencil5_halo"] = halo_check(device, rng)
    return report


#: K8's kernel alone: (rows, width) of a row block, the mesh phase's
#: 4096^2 grid and its block on 4 ranks, and an odd width
HALO_CHECK_SHAPES = ((MESH_NX, MESH_NX), (MESH_NX // 4, MESH_NX),
                     (NS_NX, NS_NX))


def halo_check(device, rng):
    """K8's kernel (``stencil5_halo``) in one process: with random halo
    rows on the card and in pinned host memory (read in place), at every
    shape of ``HALO_CHECK_SHAPES``, against its plain version (the
    stencil tolerance), and with null halo rows bit for bit K1's matvec
    of the block; the split K8 takes with its exchange in flight (the
    interior rows, then rows 0 and nx-1) the same bits as one launch.
    Times the kernel on the 4-rank block with rows of each kind beside
    K1 (null halos) on it.  Returns the report."""
    import torch
    from krypy_tpu_torch import interop
    from krypy_tpu_torch.kernels import stencil as kst
    from krypy_tpu_torch.kernels.parity import fma_atol

    out = {"max_abs_err": 0.0, "times": {}}
    for nx, ny in HALO_CHECK_SHAPES:
        co = _cd_raw(ny)
        x = interop.from_numpy(rng.standard_normal(nx * ny,
                                                   dtype=np.float32), device)
        vals = torch.from_numpy(rng.standard_normal((2, ny),
                                                    dtype=np.float32))
        rows = {"device": tuple(vals.to(device)),
                "pinned": tuple(vals.pin_memory())}
        k1 = kst.stencil5_affine(x, nx=nx, ny=ny, coeffs=co)
        if not torch.equal(kst.stencil5_halo(x, nx=nx, ny=ny, coeffs=co),
                           k1):
            raise AssertionError(f"stencil5_halo at {nx}x{ny} with null "
                                 "halo rows is not K1's matvec bit for bit")
        for where, (top, bot) in rows.items():
            got = kst.stencil5_halo(x, top, bot, nx=nx, ny=ny, coeffs=co)
            split = torch.empty_like(x)
            for k, segments in enumerate(kst.halo_segments(nx, True)):
                kst._halo_launch(x, *((None, None) if k == 0 else
                                      (top, bot)), split, nx, ny, co,
                                 segments)

            def plain(dtype, top=top, bot=bot):
                return kst.stencil5_halo_torch(
                    x.view(nx, ny).to(dtype), top.to(device, dtype),
                    bot.to(device, dtype), co).reshape(-1)

            want, want64 = plain(torch.float32), plain(torch.float64)
            torch.cuda.synchronize()
            err = (got - want).abs()
            atol = fma_atol(want, want64)
            max_err = float(err.max())
            out["max_abs_err"] = max(out["max_abs_err"], max_err)
            if not bool(torch.all(err <= atol + 2e-6 * want.abs())) or \
                    not torch.equal(split, got):
                raise AssertionError(
                    f"stencil5_halo at {nx}x{ny}, {where} halo rows: max "
                    f"abs err {max_err:.3e} (atol={atol:.3e}); split "
                    f"launches equal: {torch.equal(split, got)}")
            line = (f"parity stencil5_halo {nx}x{ny} {where} halo rows: "
                    f"max_abs_err={max_err:.3e} (atol={atol:.3e}); null "
                    "halos == K1, split == one launch")
            if nx == MESH_NX // 4:
                # x read, out written, the two halo rows read
                b_ms, b_by = bound((2 * nx + 2) * ny * 4, 15 * nx * ny)
                ms, src = _device_ms(lambda: kst.stencil5_halo(
                    x, top, bot, nx=nx, ny=ny, coeffs=co), b_ms)
                k1_ms, k1_src = _device_ms(lambda: kst.stencil5_affine(
                    x, nx=nx, ny=ny, coeffs=co), b_ms)
                out["times"][where] = dict(
                    ms=ms, k1_ms=k1_ms, bound_ms=b_ms, bound_by=b_by,
                    timed_by=dict(ms=src, k1_ms=k1_src))
                line += (f" device_ms kernel={ms:.5f} ({src}) K1 on the "
                         f"block={k1_ms:.5f} ({k1_src}) bound={b_ms:.5f}")
            print(line, flush=True)
        if nx == MESH_NX // 4:
            out["staging"] = _staging_ms(x, nx, ny)
            print(f"staging of K8's two halo rows ({nx}x{ny} block), device "
                  f"ms: {out['staging']}", flush=True)
        del x, k1, got, split, want, want64
    return out


def _staging_ms(x, nx, ny):
    """Device ms of K8's staging copies under gloo on an ``(nx, ny)``
    block: both edge rows to pinned host memory in one ``copy_rows``
    (``cudaMemcpy2DAsync``, the port's) and in two, and the two received
    rows back to the card in one copy (route (a); route (b) reads them in
    place)."""
    import torch
    from krypy_tpu_torch.kernels._launch import copy_rows

    u, w = x.view(nx, ny), 4 * ny
    pinned = torch.zeros((2, ny), pin_memory=True)
    dev = torch.zeros((2, ny), device=x.device)

    def rows_2d():
        copy_rows(pinned.data_ptr(), w, u[0].data_ptr(),
                  u[-1].data_ptr() - u[0].data_ptr(), w, 2, x.device)

    def rows_1d():
        for k in (0, -1):
            copy_rows(pinned[k].data_ptr(), w, u[k].data_ptr(), w, w, 1,
                      x.device)

    times = {}
    for name, fn in (("D2H one copy of both rows", rows_2d),
                     ("D2H one copy per row", rows_1d),
                     ("H2D one copy of both rows",
                      lambda: dev.copy_(pinned, non_blocking=True))):
        ms, src = _device_ms(fn, 0.0)
        times[name] = dict(ms=ms, timed_by=src)
    torch.cuda.synchronize()
    if not torch.equal(pinned, u[[0, -1]].cpu()):
        raise AssertionError("copy_rows did not stage K8's edge rows")
    return times


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


def laplacian_entry_phase(device):
    """K10: ``laplacian_2d_kernel`` (an entry over K1) against
    ``ops.poisson_2d(impl="torch")`` at 1024^2 and at a size whose row
    count is no multiple of 8, within the stencil tolerance; and the
    operator constructor's ``.shape`` and ``.diag``."""
    import torch
    from krypy_tpu_torch import kernels, ops
    from krypy_tpu_torch.kernels.parity import fma_atol

    gen = torch.Generator(device=device).manual_seed(10)
    for nx, ny in ((1024, 1024), (1021, 1000)):
        x = torch.randn(nx * ny, generator=gen, device=device)
        plain = ops.poisson_2d(nx, ny, impl="torch", device=device)
        before = kernels.launch_counts()["stencil5_affine"]
        got = kernels.laplacian_2d_kernel(x, nx=nx, ny=ny)
        torch.cuda.synchronize()
        if kernels.launch_counts()["stencil5_affine"] != before + 1:
            raise AssertionError("laplacian_2d_kernel did not launch K1")
        want, want64 = plain(x), plain(x.double())
        err = (got - want).abs()
        atol = fma_atol(want, want64)
        if not bool(torch.all(err <= atol + 2e-6 * want.abs())):
            raise AssertionError(
                f"laplacian_2d_kernel at {nx}x{ny}: max abs err "
                f"{float(err.max()):.3e} exceeds rtol=2e-6, atol={atol:.3e}")
        op = kernels.laplacian_2d(nx, ny, device=device)
        if op.shape != (nx * ny, nx * ny) or not torch.equal(
                op(x), got) or not torch.equal(op.diag, plain.diag):
            raise AssertionError("laplacian_2d: wrong shape, diag or matvec")
        print(f"parity laplacian_2d_kernel (K10, entry over K1) {nx}x{ny} "
              f"max_abs_err={float(err.max()):.3e} atol={atol:.3e}",
              flush=True)


def _project_parity(V, w, mask, rows, bases, report):
    """K7 along each basis of ``bases`` (``None``: ``V`` itself) against
    its plain version: both outputs held to float64 by
    :class:`krypy_tpu_torch.kernels.parity.ProjectCheck`, each planted
    fault shown to fail it, a repeated call bit-identical; float32 errors
    go into ``report["max_abs_err"]``."""
    import torch
    from krypy_tpu_torch.kernels import orthogonalize as korth
    from krypy_tpu_torch.kernels.parity import ProjectCheck

    for basis in bases:
        got = korth.cgs_project(V, w, mask, basis, rows=rows)
        again = korth.cgs_project(V, w, mask, basis, rows=rows)
        plain = korth.cgs_project_torch(
            V, w, mask, V if basis is None else basis, rows)
        label = (f"{str(V.dtype):13s} rows={rows:2d} of {V.shape[0]} "
                 f"N={V.shape[1]} basis={'V' if basis is None else 'B'}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"cgs_project {label}: a repeated call "
                                 "gave other bits")
        ck = ProjectCheck(V, w, mask, rows, plain, basis)
        bad = ck.failures(got)
        if bad:
            raise AssertionError(f"cgs_project {label}: {bad} miss "
                                 "their float64 values")
        planted = ck.assert_faults_caught(got)
        err = max(float((g - p).abs().max()) for g, p in zip(got, plain))
        if V.dtype == torch.float32:
            report["max_abs_err"] = max(report["max_abs_err"], err)
        print(f"parity cgs_project    {label} max_abs_err={err:.3e} "
              f"(vs plain); repeat bit-identical; all {planted} planted "
              "faults fail the check", flush=True)
        del ck, got, again, plain


def _project_timing(V, w, mask, rows, basis):
    """K7's float32 device time at ``rows`` along ``basis`` (``None``:
    ``V``), its plain version's and the pair of cuBLAS calls, beside the
    bound and the floor of two sweeps; prints one line and returns the
    record."""
    import torch
    from krypy_tpu_torch.kernels import orthogonalize as korth

    N = V.shape[1]
    Bb = V if basis is None else basis
    # the function's own traffic: each input once (one basis or two), w'
    # written once
    nb = (rows if basis is None else 2 * rows) + 2
    b_ms, b_by = bound(nb * N * 4, 4 * rows * N)
    # what two sweeps must move: both prefixes, w twice
    sweep_ms = 1e3 * (2 * rows + 3) * N * 4 / PEAK_BYTES
    ms, ms_src = _device_ms(
        lambda: korth.cgs_project(V, w, mask, basis, rows=rows), b_ms)
    plain_ms, plain_src = _device_ms(
        lambda: korth.cgs_project_torch(V, w, mask, Bb, rows), b_ms)
    lib_ms, lib_src = _device_ms(
        lambda: torch.addmv(w, Bb[:rows].T, torch.mv(V[:rows], w)
                            * mask[:rows], alpha=-1), b_ms)
    print(f"timing cgs_project    rows={rows:2d} of {V.shape[0]} N={N} "
          f"basis={'V' if basis is None else 'B'} device_ms "
          f"kernel={ms:.5f} ({ms_src}) plain={plain_ms:.5f} ({plain_src}) "
          f"mv+addmv={lib_ms:.5f} ({lib_src}) bound={b_ms:.5f} ({b_by}) "
          f"two_sweeps={sweep_ms:.5f} "
          f"rate={(2 * rows + 3) * N * 4 / ms / 1e9:.3f} "
          "TB/s over two sweeps", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, two_sweep_floor_ms=sweep_ms,
                timed_by=dict(ms=ms_src, plain_ms=plain_src,
                              library_ms=lib_src))


def project_phase(device):
    """K7 on the config-4 basis (26 rows of 4096^2), float32 and float64
    at rows 13 and 26, along ``V`` itself and along a second basis, and
    at two ragged N (:func:`_project_parity`); float32 device times at
    4096^2 (:func:`_project_timing`)."""
    import torch

    m = NS_ROWS[1]
    gen = torch.Generator(device=device).manual_seed(7)
    report = {"max_abs_err": 0.0, "times": {}}
    for dtype in (torch.float32, torch.float64):
        # N of every residue mod 4 (rows off 16-byte alignment) and the
        # config-4 basis
        for N in (4097, 600001, 600002, 600003, (NS_NX + 1) ** 2):
            V, B = (torch.randn(m, N, generator=gen, device=device,
                                dtype=dtype) / math.sqrt(N)
                    for _ in range(2))
            w = torch.randn(N, generator=gen, device=device, dtype=dtype)
            for rows in NS_ROWS:
                mask = (torch.arange(m, device=device) < rows - 2).to(dtype)
                _project_parity(V, w, mask, rows, (None, B), report)
                if dtype != torch.float32 or N != (NS_NX + 1) ** 2:
                    continue
                for basis in (None, B):
                    report["times"][rows, "V" if basis is None else "B"] = \
                        _project_timing(V, w, mask, rows, basis)
            del V, B, w
            torch.cuda.empty_cache()
    return {"cgs_project": report}


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
    # K7 belongs to the cgs*_pallas schemes, K8 and K9 to the mesh phase
    idle = ("cgs_project",) + tuple(MESH_KERNELS)
    for name, c in counts.items():
        if (c <= 0) != (name in idle):
            raise AssertionError(f"north-star solve: kernel {name} "
                                 f"launched {c} times")
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


def _cycles(inner, A64, b, n, dtype, stop_at=0.0):
    """Up to ``n`` refinement cycles by hand, WITHOUT ``refine_to``'s stop
    rule (which ends a solve at the first cycle that does not improve);
    ends early once the float64 relative residual is at most ``stop_at``.
    Returns the iterate, the residual before each cycle and after the
    last, and each cycle's inner iterations."""
    import torch

    x, rels, niters = torch.zeros_like(b), [], []
    bnorm = torch.linalg.vector_norm(b)
    for _ in range(n):
        r = b - A64(x)
        rels.append(float(torch.linalg.vector_norm(r) / bnorm))
        if rels[-1] <= stop_at:
            return x, rels, niters
        res = inner(r.to(dtype))
        niters.append(int(res.niter))
        x = x + res.x.double()
    rels.append(float(torch.linalg.vector_norm(b - A64(x)) / bnorm))
    return x, rels, niters


#: config 4's two lanes: (name, impl, ortho)
C4_LANES = (("cuda", "cuda", "cgs2_pallas"), ("torch", "torch", "cgs2"))
_PREFIX_SWEEPS = ("project_prefix", "apply_project", "update_prefix")


def _check_c4_launches(what, lane, counts, gmres_iters):
    """K7 twice per GMRES iteration on the kernel lane, K4-K6 never; no
    kernel at all on the plain lane."""
    want = 2 * gmres_iters if lane == "cuda" else 0
    if counts["cgs_project"] != want or any(counts[k]
                                            for k in _PREFIX_SWEEPS):
        raise AssertionError(
            f"{what} lane={lane}: launches {counts}, expected {want} "
            f"cgs_project (2 per GMRES iteration, {gmres_iters}) and no "
            "prefix sweep")
    if lane == "torch" and any(counts.values()):
        raise AssertionError(f"the plain lane launched kernels: {counts}")


def _c4_harvest(device, nx, lane, impl, ortho, record):
    """Step 1 on one lane: the harvest cycle (once to build and warm, once
    with its launches counted), its checks, and how rough the Ritz
    vectors are beside the iterate that the same Krylov basis gives
    (``|A v| / |v|`` in the float32 system).  Returns ``(make_solve, A64,
    U, counts)`` and fills ``record[lane]``."""
    import torch
    from krypy_tpu_torch import kernels, suite

    harvest, make_solve, A64 = suite.make_config4(nx, impl, ortho, device)
    harvest()  # kernel build and first launches
    kernels.reset_launch_counts()
    res0, U, theta = harvest()
    counts = kernels.launch_counts()
    niter0 = int(res0.niter)
    n_defl = 0 if U is None else U.shape[1]
    ritz = [[float(np.real(t)), float(np.imag(t))] for t in theta[:6]]
    print(f"config4 lane={lane} ortho={ortho} nx={nx} harvest: "
          f"plain_niter={niter0} status={int(res0.status)} "
          f"n_deflation={n_defl} ritz_smallest(re,im)={ritz} "
          f"launches={counts}", flush=True)
    if n_defl != suite.N_VECTORS or int(res0.status) != 0:
        raise AssertionError(
            f"harvest: {n_defl} Ritz vectors after {niter0} iterations "
            f"(status {int(res0.status)}), expected {suite.N_VECTORS}")
    _check_c4_launches("harvest", lane, counts, niter0)
    A32 = suite._system(nx, suite.SIGMA, impl, device)[0]

    def rough(v):
        return float(torch.linalg.vector_norm(A32(v.contiguous()))
                     / torch.linalg.vector_norm(v))

    rough_x, rough_U = rough(res0.x), [rough(u) for u in U.T]
    print(f"config4 lane={lane} nx={nx} roughness |A v|/|v|: harvest "
          f"iterate {rough_x:.3e}, Ritz vectors "
          f"{[f'{r:.3e}' for r in rough_U]}", flush=True)
    record[lane] = {"plain_niter": niter0, "n_deflation": n_defl,
                    "ritz_smallest": ritz, "roughness_iterate": rough_x,
                    "roughness_ritz": rough_U}
    return make_solve, A64, U, counts


def _c4_solve(device, nx, lane, kind, solve, A64, b, record):
    """One refined solve of config 4 (warm, then once with its launches
    counted): prints and records it, checks its launches, returns
    ``((result, info, true float64 relative residual), counts)``."""
    import torch
    from krypy_tpu_torch import kernels

    _, warm = solve(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    res, info = solve(b)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    hist = res.resnorms.cpu().numpy()
    rel = float(torch.linalg.vector_norm(b - A64(res.x))
                / torch.linalg.vector_norm(b))
    print(f"config4 lane={lane} nx={nx} {kind} "
          f"wall_s={info['wall_s']:.6f} warm_s={warm['warm_s']:.3f} "
          f"cycles={info['cycles']} inner_iters={info['inner_iters']} "
          f"rel={rel:.3e} peak_mem_GiB={peak:.3f} outer residuals "
          f"{hist.tolist()} launches={counts}", flush=True)
    _check_c4_launches(kind, lane, counts, info["inner_iters"])
    _check_solution(res.x, nx * nx, rel, hist)
    record[lane][kind] = {
        "cycles": info["cycles"], "inner_iters": info["inner_iters"],
        "rel": rel, "outer_residuals": hist.tolist(),
        "wall_s": info["wall_s"], "peak_mem_GiB": peak}
    return (res, info, rel), counts


def _c4_lanes_agree(nx, kind, run_c, run_t, record, cycles_slack=0,
                    inner_slack=3):
    """The kernel lane against the plain lane: refinement cycles and inner
    iterations within the slacks, iterates within the kappa-scaled
    tolerance."""
    import torch
    from krypy_tpu_torch import suite

    (rc, ic, rel_c), (rt, it, rel_t) = run_c, run_t
    if abs(ic["cycles"] - it["cycles"]) > cycles_slack or abs(
            ic["inner_iters"] - it["inner_iters"]) > inner_slack:
        raise AssertionError(
            f"nx={nx} {kind}: kernel lane {ic['cycles']} cycles / "
            f"{ic['inner_iters']} inner iterations against plain lane "
            f"{it['cycles']} / {it['inner_iters']} (allowed: cycles "
            f"within {cycles_slack}, inner iterations within "
            f"{inner_slack})")
    # each iterate's relative error is at most kappa * its relative
    # residual, so the two differ by at most kappa * (rel_c + rel_t)
    kappa = suite.kappa_bound(nx)
    tol = kappa * (rel_c + rel_t)
    dx = float(torch.linalg.vector_norm(rc.x - rt.x)
               / torch.linalg.vector_norm(rt.x))
    print(f"config4 nx={nx} {kind} kernel vs plain lane: "
          f"rel_diff_x={dx:.3e} tolerance kappa*(rel_c+rel_t)="
          f"{kappa:.4e}*({rel_c:.3e}+{rel_t:.3e})={tol:.3e}", flush=True)
    if not dx <= tol:
        raise AssertionError(f"nx={nx} {kind} iterates differ by {dx:.3e} "
                             f"> {tol:.3e}")
    record[kind + "_rel_diff_x"] = dx


def config4_full_phase(device):
    """Config 4 at the north star's size, ``C4_FULL``, both lanes: the
    harvest; the UNdeflated refined solve, gated (true residual, launch
    counts, the lanes against each other); and the deflated solve's known
    failure there, asserted so that a change of behaviour is loud: four
    cycles by hand, of which the first must raise the float64 residual
    above 1 (``refine_to`` would stop there) and the last must be below
    the target (ROADMAP.md queue C).  Returns the kernel lane's launch
    counts."""
    import torch
    from krypy_tpu_torch import kernels, suite

    nx = C4_FULL
    b = torch.ones(nx * nx, dtype=torch.float64, device=device)
    record = {"phase": "config4", "nx": nx, "N": nx * nx,
              "gated": ["undeflated"]}
    runs, by_hand, total = {}, {}, None
    for lane, impl, ortho in C4_LANES:
        make_solve, A64, U, counts = _c4_harvest(device, nx, lane, impl,
                                                 ortho, record)
        runs[lane], c = _c4_solve(device, nx, lane, "undeflated",
                                  make_solve(None), A64, b, record)
        counts = {k: counts[k] + c[k] for k in counts}
        kernels.reset_launch_counts()
        x, left, niters = _cycles(make_solve(U).inner, A64, b, 4,
                                  torch.float32)
        c = kernels.launch_counts()
        print(f"config4 lane={lane} nx={nx} deflated, 4 cycles without "
              f"the stop rule: outer residuals {left} inner iterations "
              f"{niters} launches={c}", flush=True)
        _check_c4_launches("deflated by hand", lane, c, sum(niters))
        if not (left[1] > 1.0 and left[-1] <= suite.TOL):
            raise AssertionError(
                f"nx={nx} lane={lane}: the deflated solve no longer shows "
                f"its known behaviour (first cycle above 1, four cycles "
                f"below {suite.TOL}): {left}; move the deflated gate of "
                "config4_phase to this size")
        record[lane]["deflated_left_running"] = {
            "outer_residuals": left, "inner_iters": niters}
        by_hand[lane] = (SimpleNamespace(x=x),
                         {"cycles": 4, "inner_iters": sum(niters)},
                         left[-1])
        counts = {k: counts[k] + c[k] for k in counts}
        if lane == "cuda":
            total = counts
        torch.cuda.empty_cache()
    _c4_lanes_agree(nx, "undeflated", runs["cuda"], runs["torch"], record,
                    *C4_FULL_SLACK)
    _c4_lanes_agree(nx, "deflated_left_running", by_hand["cuda"],
                    by_hand["torch"], record)
    print(json.dumps(record), flush=True)
    return total


def config4_phase(device):
    """Config 4 at ``C4_NX``, the size to which the deflated solve is cut
    (``"reduced_from": C4_FULL``): both lanes, deflated and undeflated,
    every gate.  Returns the kernel lane's launch counts over harvest and
    deflated solve, both lanes' deflated solves, the rhs and the phase's
    record."""
    import torch

    nx = C4_NX
    b = torch.ones(nx * nx, dtype=torch.float64, device=device)
    record = {"phase": "config4", "nx": nx, "N": nx * nx,
              "reduced_from": C4_FULL, "gated": ["deflated", "undeflated"]}
    runs, solves, total = {}, {}, None
    for lane, impl, ortho in C4_LANES:
        make_solve, A64, U, counts = _c4_harvest(device, nx, lane, impl,
                                                 ortho, record)
        for kind, basis in (("deflated", U), ("undeflated", None)):
            solve = make_solve(basis)
            runs[lane, kind], c = _c4_solve(device, nx, lane, kind, solve,
                                            A64, b, record)
            if kind == "deflated":
                solves[lane] = solve
                counts = {k: counts[k] + c[k] for k in counts}
        if lane == "cuda":
            total = counts
    for kind in ("deflated", "undeflated"):
        _c4_lanes_agree(nx, kind, runs["cuda", kind], runs["torch", kind],
                        record)
    return total, solves, b, record


def recycling_phase(device, nx):
    """The four-system recycling sequence on both lanes, with and without
    recycling.  Gated: every solve ends converged in the residual it
    stops on, the PRECONDITIONED one (status 0 and ``|Ml (b - A x)| / |Ml
    b|``, recomputed, within 1% of the inner tolerance), recycling saves
    iterations on each lane, the lanes' iteration counts of the systems
    solved alone agree within 3, and K7 ran twice per iteration.  Recorded and not gated:
    whether each recycled solve's UNpreconditioned residual ``|b - A x| /
    |b|`` is at most that of the same system solved alone
    (``recycled_iterates_usable``; at this size it is not, in float64
    arithmetic neither: ROADMAP.md queue C), so the sequence counts as
    iterations saved, not as usable iterates.  Returns the kernel lane's
    recycled sequence's launch counts."""
    from krypy_tpu_torch import kernels, suite

    record = {"phase": "recycling", "nx": nx, "sigmas": list(suite.SIGMAS)}
    for lane, impl, ortho in C4_LANES:
        rec = record[lane] = {"ortho": ortho}
        for label, recycle in (("recycled", True), ("plain", False)):
            kernels.reset_launch_counts()
            runs = suite.recycling_sequence(nx, impl, ortho, device,
                                            recycle=recycle)
            counts = kernels.launch_counts()
            total = sum(r["niter"] for r in runs)
            if any(r["status"] != 0 or not math.isfinite(r["rel"])
                   or not r["rel_prec"] <= 1.01 * suite.INNER_TOL
                   for r in runs):
                raise AssertionError(f"recycling {lane} {label}: a solve "
                                     f"did not converge: {runs}")
            _check_c4_launches(f"recycling {label}", lane, counts, total)
            rec[label] = runs
            if recycle and lane == "cuda":
                recycled_counts = counts
        saved = (sum(r["niter"] for r in rec["plain"])
                 - sum(r["niter"] for r in rec["recycled"]))
        if saved <= 0:
            raise AssertionError(f"recycling saved no iterations: {rec}")
        rec["iterations_saved"] = saved
        # the first solve has nothing to recycle; the others are deflated
        rec["recycled_iterates_usable"] = all(
            r["rel"] <= p["rel"]
            for r, p in zip(rec["recycled"][1:], rec["plain"][1:]))
    print(json.dumps(record), flush=True)
    # solved alone, the systems are the lanes' to agree on; a recycled
    # solve also depends on the basis its lane harvested before it, so
    # only its saving is gated, per lane, above
    for rc, rt in zip(record["cuda"]["plain"], record["torch"]["plain"]):
        if abs(rc["niter"] - rt["niter"]) > 3:
            raise AssertionError(
                f"recycling, solved alone, sigma={rc['sigma']}: kernel "
                f"lane {rc['niter']} iterations, plain lane {rt['niter']}")
    return recycled_counts


def witness_phase(device):
    """Witnesses of config 4's float32 findings (``--witness``; gates
    nothing, ROADMAP.md queue C reads it).  (1) The plain lane with
    FLOAT64 inner arithmetic at 1023^2, 2047^2 and 4095^2: harvest, Ritz
    roughness, and four cycles by hand deflated and undeflated: if the
    deflated first cycle is sound there, float32 is what spoils it.  (2)
    The undeflated float32 solve at 4095^2 on all six pairings of
    ``impl`` and two-pass ``ortho`` (one algorithm, six roundings), cycle by
    cycle, then the kernel lane with its sums taken in four other orders
    and both lanes with the right-hand side times 3: how far
    refinement's cycle count depends on rounding alone.  (3) The
    recycling sequence at 4095^2 on the plain lane in float64."""
    import torch
    from krypy_tpu_torch import suite

    f64 = torch.float64
    for nx in (1023, 2047, 4095):
        b = torch.ones(nx * nx, dtype=f64, device=device)
        harvest, make_solve, A64 = suite.make_config4(nx, "torch", "cgs2",
                                                      device, dtype=f64)
        res0, U, theta = harvest()
        A = suite._system(nx, suite.SIGMA, "torch", device, f64)[0]

        def rough(v):
            return float(torch.linalg.vector_norm(A(v.contiguous()))
                         / torch.linalg.vector_norm(v))

        print(f"witness float64 nx={nx} harvest niter={int(res0.niter)} "
              f"ritz_smallest={[complex(t) for t in theta[:6]]} roughness "
              f"iterate {rough(res0.x):.3e} Ritz vectors "
              f"{[f'{rough(u):.3e}' for u in U.T]}", flush=True)
        for kind, basis in (("deflated", U), ("undeflated", None)):
            _, rels, niters = _cycles(make_solve(basis).inner, A64, b, 4,
                                      f64, stop_at=suite.TOL)
            print(f"witness float64 nx={nx} {kind}: outer residuals {rels} "
                  f"inner iterations {niters}", flush=True)
        del harvest, make_solve, U, res0
        torch.cuda.empty_cache()
    nx = C4_FULL
    b = torch.ones(nx * nx, dtype=f64, device=device)
    for impl in ("cuda", "torch"):
        for ortho in ("cgs2_pallas", "cgs2_fused", "cgs2"):
            _, make_solve, A64 = suite.make_config4(nx, impl, ortho, device)
            _, rels, niters = _cycles(make_solve(None).inner, A64, b, 8,
                                      torch.float32, stop_at=suite.TOL)
            print(f"witness float32 nx={nx} undeflated impl={impl} "
                  f"ortho={ortho}: cycles={len(niters)} "
                  f"inner_iters={sum(niters)} outer residuals {rels} inner "
                  f"iterations {niters}", flush=True)
    # other roundings of the same two lanes: the kernel sums in another
    # order (the column range of K7's phase 0, the K4 sweep), and the
    # right-hand side times 3 (the relative residuals are the same in
    # exact arithmetic)
    from krypy_tpu_torch.kernels import orthogonalize as korth

    per_thread = korth.GROUPS_PER_THREAD
    for groups in (2, 4, 16, 32):
        korth.GROUPS_PER_THREAD = groups
        _, make_solve, A64 = suite.make_config4(nx, "cuda", "cgs2_pallas",
                                                device)
        _, rels, niters = _cycles(make_solve(None).inner, A64, b, 8,
                                  torch.float32, stop_at=suite.TOL)
        print(f"witness float32 nx={nx} undeflated impl=cuda "
              f"ortho=cgs2_pallas GROUPS_PER_THREAD={groups}: "
              f"cycles={len(niters)} inner_iters={sum(niters)} outer "
              f"residuals {rels} inner iterations {niters}", flush=True)
    korth.GROUPS_PER_THREAD = per_thread
    for impl, ortho in (("cuda", "cgs2_pallas"), ("torch", "cgs2")):
        _, make_solve, A64 = suite.make_config4(nx, impl, ortho, device)
        _, rels, niters = _cycles(make_solve(None).inner, A64, 3.0 * b, 8,
                                  torch.float32, stop_at=suite.TOL)
        print(f"witness float32 nx={nx} undeflated impl={impl} "
              f"ortho={ortho} rhs times 3: cycles={len(niters)} "
              f"inner_iters={sum(niters)} outer residuals {rels} inner "
              f"iterations {niters}", flush=True)
    for recycle in (True, False):
        runs = suite.recycling_sequence(nx, "torch", "cgs2", device,
                                        recycle=recycle, dtype=f64)
        print(f"witness float64 nx={nx} recycling recycle={recycle}: "
              f"{runs}", flush=True)


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
    return walls


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
    syncs = sum(e.count for e in prof.key_averages()
                if "Synchronize" in e.key)
    print(f"profile {label}: one solve, {wall:.6f} s under the profiler, "
          f"device busy {busy:.6f} s ({100 * busy / wall:.1f}%), "
          f"{len(events)} device kernels/copies, {syncs} host "
          f"synchronisations", flush=True)
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


def _profile_deflation(device, nx):
    """Host time, synchronised, of the deflated solve's own parts on the
    kernel lane: the harvest's Ritz hand-off (one fetch of the small
    matrices, the host eigenproblem, the vector assembly), the set-up of
    the deflation (``build_deflation``: two QRs of six vectors and six
    operator applications), one application of the oblique projection
    and one of the correction."""
    import torch
    from krypy_tpu_torch import functional as F, kernels, suite
    from krypy_tpu_torch.functional import deflation as defl_mod
    from krypy_tpu_torch.functional.common import make_inner

    A32, b32, _ = suite._system(nx, suite.SIGMA, "cuda", device)
    Ml = suite._multigrid(nx, "cuda", device)
    kw = dict(Ml=Ml, tol=suite.INNER_TOL, maxiter=suite.RESTART,
              ortho="cgs2_pallas")
    res0, internals = F.gmres(A32, b32, return_internal=True, **kw)
    internals["niter"] = int(res0.niter)
    U = F.ritz_deflation_vectors(internals, n_vectors=suite.N_VECTORS,
                                 which="sm", hermitian=False)
    defl = defl_mod.build_deflation(A32, U, Ml=Ml)
    _, rows = make_inner(None)
    proj = defl_mod._proj_complement(defl, rows)
    correct = defl_mod._correction(defl, rows, A32, Ml, b32)
    z = torch.randn_like(b32)
    parts = {
        "Ritz hand-off (fetch, eig, assembly)":
            lambda: F.ritz_deflation_vectors(
                internals, n_vectors=suite.N_VECTORS, which="sm",
                hermitian=False),
        "build_deflation (d=6)":
            lambda: defl_mod.build_deflation(A32, U, Ml=Ml),
        "proj_complement (twice-applied projection)": lambda: proj(z),
        "correct_xk (A, V-cycle, two 6-row products)": lambda: correct(z),
        "cgs_project at rows 13": lambda: kernels.cgs_project(
            internals["V"], z, torch.ones(suite.RESTART + 1, device=device),
            rows=13),
    }
    samples = {label: [] for label in parts}
    for k in range(11):
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
              f"max {max(ts):.3f} (10 samples)", flush=True)


#: the mesh phase's worlds, every rank on the one card, ``MESH_DEVICE``:
#: NCCL refuses two ranks on one device, so the wider worlds are gloo
MESH_WORLDS = (("nccl", 1), ("gloo", 2), ("gloo", 4))
MESH_DEVICE = "cuda:0"
#: seconds: each collective, and each world from its start to its end
MESH_DIST_TIMEOUT, MESH_WORLD_TIMEOUT = 120, 300
#: seconds: each world of ``--mesh-faults`` (a planted fault may leave the
#: ranks waiting on different collectives)
MESH_FAULT_TIMEOUT = 150
#: the main path on the mesh: GMRES(25) for 3 cycles, CG for 100
#: iterations, two recycled GMRES(25) solves; none reaches its tolerance,
#: so each runs all its iterations
MESH_RESTART, MESH_CYCLES, MESH_CG_ITERS, MESH_TOL = 25, 3, 100, 1e-12
#: numpy seed of CG's float32 right-hand side on the mesh (a random b: with
#: b = ones the Poisson system is symmetric about its middle row, and each
#: of 2 ranks' partial inner products is half the sum)
MESH_CG_SEED = 12
#: float32 residual histories, sharded against one device, relative: the
#: same algorithm with its sums in another order (per-rank partials plus
#: the all-reduce).  About 10x above the largest sound reading (GMRES
#: 3.0e-7, CG 1.1e-5, recycling 2.0e-5 on the H100); the faults that
#: ``--mesh-faults`` plants (a zeroed halo, an unreduced inner product)
#: must land above them
MESH_RTOL = {"gmres": 3e-6, "cg": 2e-4, "recycling": 2e-4,
             "gmres_1r": 3e-6, "cg_1r": 2e-4, "gmres_auto": 3e-6}
#: all-reduces of the one-reduce solves on the mesh beyond one per
#: iteration: per GMRES cycle the global N, the two initial norms, the
#: peeled first product and the final explicit residual; per CG solve the
#: two initial norms, the initial delta and the final explicit residual
MESH_1R_FIXED = {"gmres_1r": 5, "cg_1r": 4}
#: the faults ``--mesh-faults`` plants, one world each
MESH_FAULTS = ("halo", "reduce")


def _cd_raw(nx):
    """The convection-diffusion stencil of ``ops.convection_diffusion_2d``
    (wind (1, 0.5), eps 1) on an nx-grid."""
    h = 1.0 / (nx + 1)
    return (4.0 / h ** 2 + 1.5 / h, -1.0 / h ** 2 - 1.0 / h, -1.0 / h ** 2,
            -1.0 / h ** 2 - 0.5 / h, -1.0 / h ** 2)


def _mesh_inputs(device):
    """K8's input ``x`` and K9's ``V`` (26 rows), ``w`` and ``c``, drawn
    from fixed seeds on the card: every process draws the same bits."""
    import torch

    N = MESH_NX ** 2
    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn(N, generator=gen, device=device)
    V = torch.randn(NS_ROWS[1], N, generator=gen, device=device)
    V /= math.sqrt(N)
    w = torch.randn(N, generator=gen, device=device)
    c = torch.randn(NS_ROWS[1], generator=gen, device=device)
    return x, V, w, c


def _mesh_mask(device):
    import torch

    m, rows = NS_ROWS[1], NS_ROWS[0]
    return (torch.arange(m, device=device) < rows - 2).float()


def _mesh_solves(device, mesh=None):
    """The mesh phase's main path on one device (``mesh=None``) or, on the
    rank's blocks, sharded: restarted GMRES(25) (Jacobi ``Ml``,
    ``ortho="cgs2_fused"``: K8 and K9 on the mesh) for 3 cycles, Jacobi
    CG on ``poisson_2d(impl="cuda")`` for 100 iterations on a float32
    right-hand side drawn from ``MESH_CG_SEED``, and two
    ``RecyclingGmres(6, "sm")`` solves (``ortho="cgs2"``), the second
    deflated; then the one-reduce lane: the restarted GMRES with
    ``ortho="cgs2_1r"``, the CG with ``variant="1r"``, and one GMRES(25)
    cycle with ``ortho="auto"``.  The launch and collective counts are set
    to 0 just before each solve and read just after.  Returns one record
    per solve."""
    import torch
    from krypy_tpu_torch import functional as F, kernels, ops, parallel, suite

    nx, N = MESH_NX, MESH_NX ** 2
    kw = dict(impl="cuda", device=device, mesh=mesh)
    cd = ops.convection_diffusion_2d(nx, **kw)
    lap = ops.poisson_2d(nx, **kw)
    blk = slice(None) if mesh is None else parallel.block_of(N, mesh)
    n = len(range(N)[blk])
    b = torch.ones(n, device=device)
    rhs = np.random.default_rng(MESH_CG_SEED).standard_normal(
        N, dtype=np.float32)
    b_cg = torch.from_numpy(rhs[blk]).to(device)
    Ml = ops.jacobi_preconditioner(cd)
    rec = F.RecyclingGmres(n_vectors=suite.N_VECTORS, which="sm")
    gm = dict(Ml=Ml, tol=MESH_TOL, maxiter=MESH_RESTART)
    runs = {
        "gmres": lambda: [F.restarted_gmres(
            cd, b, max_restarts=MESH_CYCLES - 1, ortho="cgs2_fused", **gm)],
        "cg": lambda: [F.cg(lap, b_cg, M=ops.jacobi_preconditioner(lap),
                            tol=MESH_TOL, maxiter=MESH_CG_ITERS)],
        "recycling": lambda: [rec.solve(cd, b, ortho="cgs2", **gm)
                              for _ in range(2)],
        "gmres_1r": lambda: [F.restarted_gmres(
            cd, b, max_restarts=MESH_CYCLES - 1, ortho="cgs2_1r", **gm)],
        "cg_1r": lambda: [F.cg(lap, b_cg, M=ops.jacobi_preconditioner(lap),
                               tol=MESH_TOL, maxiter=MESH_CG_ITERS,
                               variant="1r")],
        "gmres_auto": lambda: [F.gmres(cd, b, ortho="auto", **gm)],
    }
    out = {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        parallel.reset_collective_counts()
        results = run()
        torch.cuda.synchronize()
        out[name] = {
            "launches": kernels.launch_counts(),
            "collectives": parallel.collective_counts(),
            "resnorms": [r.resnorms[: len(r.resnorms)
                                    if name in ("gmres", "gmres_1r")
                                    else int(r.niter) + 1].tolist()
                         for r in results],
            "status": [int(r.status) for r in results],
        }
    out["recycling"]["deflated_width"] = (
        None if rec._U is None else int(rec._U.shape[1]))
    return out


def _mesh_device_ms(fn, floor_ms, reps=10):
    """``(ms, source)``: one call's device time on a rank, as
    :func:`_device_ms` takes it but without retakes, so that every rank
    makes the same calls (each call communicates): one profile of
    ``reps`` calls, and CUDA events around back-to-back calls where the
    profile recorded no device events or less than the bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = sum(e.time_range.elapsed_us()
             for e in _device_events(prof)) / reps / 1e3
    events = _time_ms(fn, samples=5, per_sample=reps)
    return (ms, "profiler") if ms > 0 and ms >= floor_ms else (events,
                                                               "events")


def _host_ms(fn, calls=50):
    """Median host milliseconds of one synchronised call."""
    import torch

    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _k8_variants(backend):
    """K8's forms on a world of ``backend``, by name: each order against
    the exchange (``overlap``) and, under gloo, each route of the
    received rows (``mapped``)."""
    routes = (False, True) if backend == "gloo" else (None,)
    return {f"overlap={o}" + ("" if m is None else f" mapped={m}"):
            dict(overlap=o, **({} if m is None else dict(mapped=m)))
            for o in (False, True) for m in routes}


def _k8_kept():
    """The keywords of K8's defaults, as :func:`_k8_variants` names
    them: what a call without them runs."""
    from krypy_tpu_torch.kernels import stencil as kst

    return dict(overlap=kst.K8_OVERLAP, mapped=kst.K8_MAPPED)


def _k8_composition(x_loc, nx, co, mesh):
    """K8 as the earlier composition it replaced, kept to time that
    design in the same run: K1 on the block (Dirichlet zeros at its edge
    rows) while the edge rows cross (under gloo staged into fresh pinned
    memory by one copy each, brought back by one ``.to`` each), then ``cu
    * top`` and ``cd * bottom`` added to the edge rows."""
    import torch
    import torch.distributed as dist
    from krypy_tpu_torch.kernels import stencil as kst

    u = x_loc.view(-1, nx)
    first, last = u[0], u[-1]
    if mesh.backend != "nccl" and u.is_cuda:
        rows = torch.empty((2, nx), dtype=u.dtype, pin_memory=True)
        rows[0].copy_(first)
        rows[1].copy_(last)
        first, last = rows[0], rows[1]
    top, bot = torch.zeros_like(first), torch.zeros_like(last)
    ops = [op for peer, send, recv in ((mesh.rank - 1, first, top),
                                       (mesh.rank + 1, last, bot))
           if 0 <= peer < mesh.size
           for op in (dist.P2POp(dist.isend, send, peer, mesh.group),
                      dist.P2POp(dist.irecv, recv, peer, mesh.group))]
    works = dist.batch_isend_irecv(ops) if ops else []
    out = kst.stencil5_pipelined(x_loc, nx=u.shape[0], ny=nx,
                                 coeffs=co).view(-1, nx)
    for w in works:
        w.wait()
    out[0] += co[1] * top.to(u.device)
    out[-1] += co[2] * bot.to(u.device)
    return out.view(-1)


def _plant(fault):
    """Plant one fault in this rank's mesh path (``--mesh-faults``):
    ``halo`` zeroes the rows K8 receives from its neighbours; ``reduce``
    leaves the inner product of two vectors (``pair``, a 0-dim partial)
    rank-local, while the row products and K9's sums stay reduced;
    ``none`` plants nothing."""
    import torch
    from krypy_tpu_torch.functional import common
    from krypy_tpu_torch.kernels import stencil as kst

    if fault == "halo":
        exchange = kst.halo_exchange

        class Zeroed:
            """Zeroes the received rows where K8's kernel reads them (the
            exchange's buffers, on the card or pinned)."""

            def __init__(self, handle):
                self.handle = handle

            def wait(self):
                rows = self.handle.wait()
                for t in rows:
                    t.zero_()
                return rows

        def zeroed(first, last, mesh=None, async_op=False, **kw):
            handle = Zeroed(exchange(first, last, mesh=mesh, async_op=True,
                                     **kw))
            return handle if async_op else handle.wait()

        kst.halo_exchange = zeroed
    elif fault == "reduce":
        mesh_sum = common.mesh_sum
        common.mesh_sum = lambda t: t if t.dim() == 0 else mesh_sum(t)


def mesh_rank(backend, P, rank, workdir, plant=None):
    """One rank of a mesh-phase world (``--mesh-rank``): K8 and K9
    against the parent's single-device results, K4-K6 on the rank's
    columns through ``PrefixCheck``, per-shard device times and host
    times of the collectives, then the main path on the mesh; writes its
    record to ``rank{rank}.json``.  With ``plant`` (a fault of
    :func:`_plant`) only the main path runs, with that fault."""
    from pathlib import Path

    import torch
    import torch.distributed as dist
    from krypy_tpu_torch import kernels, parallel
    from krypy_tpu_torch.kernels import orthogonalize as korth
    from krypy_tpu_torch.kernels import stencil as kst
    from krypy_tpu_torch.kernels.parity import (
        PrefixCheck,
        cgs2_tolerances,
        fma_atol,
    )

    workdir, P, rank = Path(workdir), int(P), int(rank)
    device = torch.device(MESH_DEVICE)
    parallel.init_distributed(parallel.file_rendezvous(workdir), P, rank,
                              backend, timeout=MESH_DIST_TIMEOUT)
    try:
        mesh = parallel.make_mesh(P, device=device)
        if plant:
            _plant(plant)
            with mesh:
                solves = _mesh_solves(device, mesh)
            (workdir / f"rank{rank}.json").write_text(json.dumps(
                {"rank": rank, "P": P, "backend": backend, "plant": plant,
                 "solves": solves}))
            return
        tag = f"mesh {backend} P={P} rank={rank}"
        nx, N = MESH_NX, MESH_NX ** 2
        blk = parallel.block_of(N, mesh)
        n_loc = blk.stop - blk.start
        co = _cd_raw(nx)
        ref = torch.load(workdir / "ref.pt")
        x, V, w, c_in = _mesh_inputs(device)
        x_loc = x[blk].contiguous()
        rec = {"rank": rank, "P": P, "backend": backend}

        # K8 against the single-device K1 matvec, gathered on every rank
        kernels.reset_launch_counts()
        parallel.reset_collective_counts()
        y = parallel.gather_vector(
            kst.stencil5_sharded(x_loc, nx=nx, ny=nx, coeffs=co, mesh=mesh),
            mesh)
        if kernels.launch_counts()["stencil5_sharded"] != 1 or \
                parallel.collective_counts()["halo_exchange"] != 1:
            raise AssertionError(f"{tag}: K8 did not launch once with one "
                                 "halo exchange")
        # directly against the plain stencil in float64 on the same x, at
        # the bound the plain float32 stencil's own error sets; then
        # against the single-device K1 matvec
        want64 = kst.stencil5_affine_torch(x.double().view(nx, nx), None,
                                           co, nx, nx).view(-1)
        plain32 = kst.stencil5_affine_torch(x.view(nx, nx), None, co, nx,
                                            nx).view(-1)
        atol = fma_atol(plain32, want64)
        err64 = (y.double() - want64).abs()
        rec["k8_max_abs_err"] = float(err64.max())
        want = ref["k1"].to(device)
        err = (y - want).abs()
        for label, e, y_ref in (("the plain stencil in float64", err64,
                                 want64),
                                ("the single-device K1 matvec", err, want)):
            if not bool(torch.all(e <= atol + 2e-6 * y_ref.abs())):
                raise AssertionError(
                    f"{tag}: K8 against {label}: max abs err "
                    f"{float(e.max()):.3e} exceeds rtol=2e-6, "
                    f"atol={atol:.3e}")
        # bit for bit against the single-device K1 matvec: every row in
        # K1's per-point arithmetic, in each order and each route of the
        # received rows (the kept one above; any other within the atol)
        rec["k8_bitwise"] = {}
        for name, kw in _k8_variants(backend).items():
            yv = y if kw.items() <= _k8_kept().items() else \
                parallel.gather_vector(
                    kst.stencil5_sharded(x_loc, nx=nx, ny=nx, coeffs=co,
                                         mesh=mesh, **kw), mesh)
            rec["k8_bitwise"][name] = bool(torch.equal(yv, want))
            ev = (yv - want).abs()
            if not bool(torch.all(ev <= atol + 2e-6 * want.abs())):
                raise AssertionError(f"{tag}: K8 ({name}) against the "
                                     f"single-device K1 matvec: max abs err "
                                     f"{float(ev.max()):.3e}")
        print(f"{tag}: K8 ({nx // P}x{nx} rows per rank): max_abs_err "
              f"against the plain stencil in float64 "
              f"{rec['k8_max_abs_err']:.3e}, against the single-device K1 "
              f"matvec {float(err.max()):.3e} (atol={atol:.3e}); bit for "
              f"bit K1's: {rec['k8_bitwise']}", flush=True)
        if P > 1:
            # the planted halo fault of --mesh-faults reaches the rows K8's
            # kernel reads: the rows next to a neighbour change, no other
            exchange = kst.halo_exchange
            _plant("halo")
            try:
                yz = parallel.gather_vector(kst.stencil5_sharded(
                    x_loc, nx=nx, ny=nx, coeffs=co, mesh=mesh), mesh)
            finally:
                kst.halo_exchange = exchange
            moved = torch.nonzero((yz != want).view(nx, nx).any(1))
            edges = sorted(r * (nx // P) + d for r in range(1, P)
                           for d in (-1, 0))
            if moved.flatten().tolist() != edges:
                raise AssertionError(f"{tag}: the planted halo fault moved "
                                     f"K8's rows {moved.flatten().tolist()}"
                                     f", not the block edges {edges}")
            print(f"{tag}: the planted halo fault moves K8's rows {edges} "
                  "and no other", flush=True)
            del yz
        del y, want, want64, plain32, err, err64

        # K4-K6 on the rank's columns, held to float64; K9 against the
        # single-device K4 -> K5 -> K6
        rows, mask = NS_ROWS[0], _mesh_mask(device)
        V_loc, w_loc = V[:, blk].contiguous(), w[blk].contiguous()
        got = {"project_prefix": (korth.project_prefix(V_loc, w_loc, mask,
                                                       rows=rows),),
               "apply_project": korth.apply_project(V_loc, w_loc, c_in, mask,
                                                    rows=rows),
               "update_prefix": (korth.update_prefix(V_loc, w_loc, c_in,
                                                     rows=rows),)}
        plain = {"project_prefix": (korth.project_prefix_torch(
                     V_loc, w_loc, mask, rows),),
                 "apply_project": korth.apply_project_torch(
                     V_loc, w_loc, c_in, mask, rows),
                 "update_prefix": (korth.update_prefix_torch(
                     V_loc, w_loc, c_in, rows),)}
        bad = PrefixCheck(V_loc, w_loc, c_in, mask, rows, plain).failures(got)
        if bad:
            raise AssertionError(f"{tag}: {bad} miss their float64 values "
                                 "on the rank's columns")
        del got, plain
        w2_loc, c = korth.cgs2_fused_sharded(V_loc, w_loc, mask, mesh=mesh,
                                             rows=rows, n=N)
        w2 = parallel.gather_vector(w2_loc, mesh)
        rec["k9_coefficients"] = c.tolist()
        if not bool(torch.all(c[rows:] == 0)):
            raise AssertionError(f"{tag}: K9's masked coefficients are not 0")
        # directly against the plain K4 -> K5 -> K6 in float64, then
        # against the single-device kernels
        errs = {}
        for label, key in (("the plain K4->K5->K6 in float64", "64"),
                           ("the single-device K4->K5->K6", "")):
            ref_w2 = ref[f"w2{key}"].to(device).double()
            ref_c = ref[f"c{key}"].to(device).double()
            t_c, t_w = cgs2_tolerances(V, w, ref_c, mask, rows)
            err_c = (c[:rows].double() - ref_c[:rows]).abs()
            err_w = (w2.double() - ref_w2).abs()
            errs[label] = (float(err_c.max()), float(err_w.max()))
            if not (bool(torch.all(err_c <= t_c))
                    and bool(torch.all(err_w <= t_w))):
                raise AssertionError(
                    f"{tag}: K9 against {label}: coefficients off by "
                    f"{errs[label][0]:.3e} (tolerance {float(t_c.min()):.3e}"
                    f" and up), w2 by {errs[label][1]:.3e}")
            del ref_w2, err_w, t_w
        rec["k9_max_abs_err"] = max(errs["the plain K4->K5->K6 in float64"])
        print(f"{tag}: K4-K6 on the rank's {n_loc} columns held to float64; "
              f"K9 max_abs_err (coefficients, w2): " + "; ".join(
                  f"against {label} {ec:.3e}, {ew:.3e}"
                  for label, (ec, ew) in errs.items()), flush=True)
        del V, w, x, w2, ref
        torch.cuda.empty_cache()

        # per-shard device times (every rank makes the same calls)
        b8_ms, b8_by = bound((2 * n_loc + 2 * nx) * 4, 15 * n_loc)
        b9_ms, b9_by = bound((rows * n_loc + 2 * n_loc + 2 * mask.numel())
                             * 4, 8 * rows * n_loc)

        def k9_plain():
            c1 = parallel.all_reduce_sum(korth.project_prefix_torch(
                V_loc, w_loc, mask, rows), mesh)
            w1, c2 = korth.apply_project_torch(V_loc, w_loc, c1, mask, rows)
            return korth.update_prefix_torch(
                V_loc, w1, parallel.all_reduce_sum(c2, mesh), rows)

        timings = {
            "stencil5_sharded": (
                lambda: kst.stencil5_sharded(x_loc, nx=nx, ny=nx, coeffs=co,
                                             mesh=mesh),
                lambda: kst.stencil5_sharded_torch(x_loc, nx=nx, ny=nx,
                                                   coeffs=co, mesh=mesh),
                b8_ms, b8_by),
            "cgs2_fused_sharded": (
                lambda: korth.cgs2_fused_sharded(V_loc, w_loc, mask,
                                                 mesh=mesh, rows=rows, n=N),
                k9_plain, b9_ms, b9_by),
        }
        rec["times"] = {}
        # K8 in each order and route, and as the earlier composition:
        # device ms per shard and host ms per call
        rec["k8_variants"] = {}
        comps = {name: (lambda kw=kw: kst.stencil5_sharded(
            x_loc, nx=nx, ny=nx, coeffs=co, mesh=mesh, **kw))
            for name, kw in _k8_variants(backend).items()}
        comps["earlier composition"] = lambda: _k8_composition(
            x_loc, nx, co, mesh)
        for name, fn in comps.items():
            ms, src = _mesh_device_ms(fn, b8_ms)
            v = rec["k8_variants"][name] = dict(
                ms=ms, host_ms=_host_ms(fn), timed_by=src,
                device_ms_by_event=_device_split(fn))
            print(f"{tag}: timing K8 {name} per shard device_ms={ms:.5f} "
                  f"({src}) host_ms={v['host_ms']:.4f} bound={b8_ms:.5f}; "
                  f"by event {v['device_ms_by_event']}", flush=True)
        for name, (kern, pl, b_ms, b_by) in timings.items():
            ms, src = _mesh_device_ms(kern, b_ms)
            plain_ms, plain_src = _mesh_device_ms(pl, b_ms)
            rec["times"][name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by,
                                      timed_by=dict(ms=src,
                                                    plain_ms=plain_src))
            print(f"{tag}: timing {name} per shard device_ms kernel={ms:.5f} "
                  f"({src}) plain={plain_ms:.5f} ({plain_src}) "
                  f"bound={b_ms:.5f} ({b_by})", flush=True)
        # K9's floor as the composition it is: the bounds of its three
        # sweeps, K4 (V, w read), K5 and K6 (V, w read, w' written)
        rec["times"]["cgs2_fused_sharded"]["three_sweep_floor_ms"] = bound(
            (3 * rows * n_loc + 5 * n_loc) * 4, 8 * rows * n_loc)[0]
        u = x_loc.view(-1, nx)
        rec["host_ms"] = {
            "stencil5_sharded (kept)": rec["k8_variants"][next(
                name for name, kw in _k8_variants(backend).items()
                if kw.items() <= _k8_kept().items())]["host_ms"],
            "all_reduce_sum (26 float32)": _host_ms(
                lambda: parallel.all_reduce_sum(c_in, mesh)),
            f"halo_exchange (2 rows of {nx} float32)": _host_ms(
                lambda: parallel.halo_exchange(u[0], u[-1], mesh)),
        }
        if backend == "gloo":
            # the same on CPU tensors: gloo alone, without the staging
            c_cpu, u_cpu = c_in.cpu(), u[[0, -1]].cpu()
            rec["host_ms"].update({
                "all_reduce_sum, CPU tensor": _host_ms(
                    lambda: parallel.all_reduce_sum(c_cpu, mesh)),
                "halo_exchange, CPU rows": _host_ms(
                    lambda: parallel.halo_exchange(u_cpu[0], u_cpu[1],
                                                   mesh)),
            })
        print(f"{tag}: host ms per collective {rec['host_ms']}", flush=True)
        del V_loc, w_loc, x_loc, u
        torch.cuda.empty_cache()

        # the main path on the mesh
        with mesh:
            rec["solves"] = _mesh_solves(device, mesh)
        (workdir / f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def _run_world(backend, P, workdir, timeout, plant=None):
    """Run the P rank processes of one world
    (:func:`krypy_tpu_torch.parallel.launch_ranks`: it raises, after
    killing every rank still running, as soon as one fails or the deadline
    passes).  Prints the ranks' logs and returns their records."""
    from pathlib import Path

    from krypy_tpu_torch import parallel

    extra = ["--plant", plant] if plant else []
    logs = parallel.launch_ranks(
        lambda r: [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                   backend, str(P), str(r), str(workdir)] + extra,
        P, workdir, timeout)
    print("\n".join(f"[{backend} P={P} rank {r}] {ln}"
                    for r, text in enumerate(logs)
                    for ln in text.splitlines()), flush=True)
    return [json.loads((Path(workdir) / f"rank{r}.json").read_text())
            for r in range(P)]


def _history_rel(got, want):
    """The largest relative difference between two runs' residual
    histories (one list per solve); inf where their iteration counts
    differ or a value is not finite."""
    if [len(h) for h in got] != [len(h) for h in want]:
        return math.inf
    rel = [abs(a - b) / abs(b) for g, h in zip(got, want)
           for a, b in zip(g, h)]
    return max(rel) if all(math.isfinite(r) for r in rel) else math.inf


def _check_mesh_world(backend, P, ranks, ref):
    """The gates of one world against the single-device run: equal
    iteration and matvec counts, residual histories within ``MESH_RTOL``
    and bitwise equal on every rank, K8 once per matvec, K9 once per
    GMRES iteration, three all-reduces per GMRES iteration and one halo
    exchange per matvec, and a deflated second recycled solve."""
    from krypy_tpu_torch import suite

    from krypy_tpu_torch.functional import policy

    tag = f"mesh {backend} P={P}"
    r0 = ranks[0]["solves"]
    # ortho="auto": the scheme it picked, read off its all-reduces (one per
    # iteration for cgs2_1r, three for cgs2_fused), against the price
    # model's answer for this shard (one rank: the one-device rule)
    auto = r0["gmres_auto"]
    n_auto = len(auto["resnorms"][0]) - 1
    picked = {n_auto + MESH_1R_FIXED["gmres_1r"]: "cgs2_1r",
              3 * n_auto + 4: "cgs2_fused"}.get(
        auto["collectives"]["all_reduce_sum"])
    want = "cgs2_fused" if P == 1 or policy.fused_sharded_wins(
        MESH_RESTART + 1, MESH_NX ** 2 // P, 4, 2, MESH_DEVICE) \
        else "cgs2_1r"
    print(f"{tag} gmres_auto: ortho='auto' picked {picked} "
          f"({auto['collectives']['all_reduce_sum']} all-reduces in "
          f"{n_auto} iterations); policy.fused_sharded_wins for "
          f"{MESH_RESTART + 1} rows of {MESH_NX ** 2 // P} float32 per shard "
          f"(sync {policy.sync_s(MESH_DEVICE):.3e} s, "
          f"{policy.hbm_bytes_per_s(MESH_DEVICE):.3e} B/s) -> {want}",
          flush=True)
    if picked != want:
        raise AssertionError(f"{tag} gmres_auto: picked {picked}, the "
                             f"price model says {want}")
    for name, one in ref.items():
        if name == "gmres_auto" and picked == "cgs2_1r":
            # held to one device's first cycle of the same scheme
            one = dict(one, resnorms=[ref["gmres_1r"]["resnorms"][0][
                : MESH_RESTART + 1]], launches=dict(
                    one["launches"], stencil5_affine=one["launches"][
                        "stencil5_affine"] + 1))
        if name == "recycling" and r0[name]["deflated_width"] != \
                suite.N_VECTORS:
            raise AssertionError(f"{tag}: the second recycled solve did not "
                                 f"run deflated: {r0[name]}")
        for r in ranks[1:]:
            if r["solves"][name]["resnorms"] != r0[name]["resnorms"]:
                raise AssertionError(f"{tag} {name}: rank {r['rank']}'s "
                                     "residual history differs from rank "
                                     "0's (replicated state must be the "
                                     "same bits)")
        got, want = r0[name]["resnorms"], one["resnorms"]
        if [len(h) for h in got] != [len(h) for h in want] or \
                r0[name]["status"] != one["status"]:
            raise AssertionError(f"{tag} {name}: iterations/status "
                                 f"{[len(h) - 1 for h in got]} "
                                 f"{r0[name]['status']} against one device "
                                 f"{[len(h) - 1 for h in want]} "
                                 f"{one['status']}")
        rel = _history_rel(got, want)
        launches, coll = r0[name]["launches"], r0[name]["collectives"]
        matvecs = one["launches"]["stencil5_affine"]
        iters = sum(len(h) - 1 for h in got)
        print(f"{tag} {name}: {iters} iterations, {matvecs} matvecs as on "
              f"one device; residual history max rel diff {rel:.3e} "
              f"(tolerance {MESH_RTOL[name]}); launches {launches}; "
              f"collectives {coll}", flush=True)
        if not rel <= MESH_RTOL[name]:
            raise AssertionError(f"{tag} {name}: residual histories differ "
                                 f"by {rel:.3e} > {MESH_RTOL[name]}")
        if launches["stencil5_sharded"] != matvecs or \
                coll["halo_exchange"] != matvecs:
            raise AssertionError(f"{tag} {name}: {matvecs} matvecs on one "
                                 f"device, K8 {launches['stencil5_sharded']}"
                                 f" and {coll['halo_exchange']} exchanges")
        if name == "gmres":
            per_cycle = 4  # the global N, two initial norms, the final one
            if launches["cgs2_fused_sharded"] != iters or \
                    coll["all_reduce_sum"] != 3 * iters + per_cycle * \
                    MESH_CYCLES:
                raise AssertionError(
                    f"{tag} gmres: K9 {launches['cgs2_fused_sharded']} "
                    f"launches and {coll['all_reduce_sum']} all-reduces in "
                    f"{iters} iterations of {MESH_CYCLES} cycles: expected "
                    f"one K9 and three all-reduces per iteration plus "
                    f"{per_cycle} per cycle")
        if name in MESH_1R_FIXED:
            fixed = MESH_1R_FIXED[name] * (MESH_CYCLES if name == "gmres_1r"
                                           else 1)
            if coll["all_reduce_sum"] != iters + fixed or \
                    launches.get("cgs2_fused_sharded", 0):
                raise AssertionError(
                    f"{tag} {name}: {coll['all_reduce_sum']} all-reduces in "
                    f"{iters} iterations: expected ONE per iteration plus "
                    f"{fixed} per solve")


def mesh_phase(device):
    """The multi-device path on one card: single-device references (K1's
    matvec, K4 -> K5 -> K6, the main path) computed here, then each world
    of ``MESH_WORLDS`` started as rank processes sharing ``cuda:0`` and
    gated.  The times are per-shard device times and host times of the
    collectives on ONE card: no multi-GPU speed-up is measured.  Returns
    ``{(backend, P): rank records}``."""
    import tempfile

    import torch
    from krypy_tpu_torch import kernels
    from krypy_tpu_torch.kernels import orthogonalize as korth
    from krypy_tpu_torch.kernels import stencil as kst

    torch.cuda.empty_cache()
    nx, rows, mask = MESH_NX, NS_ROWS[0], _mesh_mask(device)
    x, V, w, _ = _mesh_inputs(device)
    k1 = kst.stencil5_pipelined(x, nx=nx, ny=nx, coeffs=_cd_raw(nx))
    w2, c = korth.cgs2_fused(V, w, mask, rows=rows)
    refs = {"k1": k1.cpu(), "w2": w2.cpu(), "c": c.cpu()}
    del x, k1, w2, c
    # the plain K4 -> K5 -> K6 in float64
    V64, w64, mask64 = V[:rows].double(), w.double(), mask[:rows].double()
    del V, w
    c1 = korth.project_prefix_torch(V64, w64, mask64, rows)
    w1, c2 = korth.apply_project_torch(V64, w64, c1, mask64, rows)
    refs["w264"] = korth.update_prefix_torch(V64, w1, c2, rows).cpu()
    refs["c64"] = (c1 + c2).cpu()
    del V64, w64, c1, w1, c2
    torch.cuda.empty_cache()
    one = _mesh_solves(device)
    for name, r in one.items():
        print(f"mesh one device {name}: iterations "
              f"{[len(h) - 1 for h in r['resnorms']]} launches "
              f"{r['launches']}", flush=True)
    torch.cuda.empty_cache()
    worlds = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        for backend, P in MESH_WORLDS:
            workdir = f"{tmp}/{backend}{P}"
            os.makedirs(workdir)
            torch.save(refs, f"{workdir}/ref.pt")
            t0 = time.perf_counter()
            ranks = _run_world(backend, P, workdir, MESH_WORLD_TIMEOUT)
            _check_mesh_world(backend, P, ranks, one)
            coeffs = {json.dumps(r["k9_coefficients"]) for r in ranks}
            if len(coeffs) != 1:
                raise AssertionError(f"mesh {backend} P={P}: K9's "
                                     "coefficients differ between ranks")
            worlds[backend, P] = ranks
            t = ranks[0]["times"]
            print(f"mesh {backend} P={P}: world done in "
                  f"{time.perf_counter() - t0:.1f} s; rank 0 per-shard "
                  f"device ms K8 {t['stencil5_sharded']['ms']:.5f} (bound "
                  f"{t['stencil5_sharded']['bound_ms']:.5f}), K9 "
                  f"{t['cgs2_fused_sharded']['ms']:.5f} (bound "
                  f"{t['cgs2_fused_sharded']['bound_ms']:.5f}, three "
                  "sweeps "
                  f"{t['cgs2_fused_sharded']['three_sweep_floor_ms']:.5f});"
                  f" host ms "
                  f"{ranks[0]['host_ms']} (P ranks share ONE card: per-shard "
                  "kernels and the transport's host cost, no multi-GPU "
                  "speed-up)", flush=True)
    kernels.reset_launch_counts()
    return worlds


def mesh_fault_phase(device):
    """``--mesh-faults``: the readings that ``MESH_RTOL`` lies between.
    The mesh phase's main path on one device, then on a gloo world of 2
    ranks on the card: sound, and with each fault of ``MESH_FAULTS``
    planted (:func:`_plant`).  Prints each solve's residual-history
    reading against one device beside its limit; fails unless the sound
    world is within every limit, each fault lands above the limit in at
    least one solve, and each solve's limit catches at least one fault
    (a world that fails or passes its deadline counts as caught in every
    solve)."""
    import tempfile

    one = _mesh_solves(device)
    readings = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_faults_") as tmp:
        for plant in ("none",) + MESH_FAULTS:
            workdir = f"{tmp}/{plant}"
            os.makedirs(workdir)
            try:
                ranks = _run_world("gloo", 2, workdir, MESH_FAULT_TIMEOUT,
                                   plant)
            except RuntimeError as e:
                if plant == "none":
                    raise
                print(f"mesh fault {plant}: the world failed "
                      f"({str(e).splitlines()[0]}): caught", flush=True)
                readings[plant] = dict.fromkeys(one, math.inf)
                continue
            r0 = ranks[0]["solves"]
            readings[plant] = {
                name: _history_rel(r0[name]["resnorms"], w["resnorms"])
                for name, w in one.items()}
            print(f"mesh fault {plant}: residual history max rel diff "
                  "against one device: " + ", ".join(
                      f"{name} {rel:.3e} (limit {MESH_RTOL[name]})"
                      for name, rel in readings[plant].items()), flush=True)
    caught = {plant: [name for name, rel in r.items()
                      if rel > MESH_RTOL[name]]
              for plant, r in readings.items()}
    blind = [name for name in one
             if not any(name in caught[p] for p in MESH_FAULTS)]
    # the rank-local inner product reaches the one-reduce solves through
    # their initial norms (their per-iteration product is a row product):
    # it must be caught there too
    blind += [name for name in MESH_1R_FIXED if name not in caught["reduce"]]
    print(f"mesh faults caught by solve: {caught}", flush=True)
    if caught["none"] or not all(caught[p] for p in MESH_FAULTS) or blind:
        raise AssertionError(
            f"mesh faults: sound world above its limits in "
            f"{caught['none']}; faults caught nowhere: "
            f"{[p for p in MESH_FAULTS if not caught[p]]}; solves that "
            f"catch no fault: {blind}")


# ---------------------------------------------------------------------------
# BASELINE configs 1-3 (the baseline phase)
# ---------------------------------------------------------------------------

#: configs 2 and 3: the north star's grid, 4095^2 = 16,769,025 unknowns
BL_NX = NS_NX
#: timed solves per lane and solver of configs 2 and 3 (after the gated
#: one, which follows a warm-up solve)
BL_ROUNDS = 3
#: config 1 in the JAX package, ``JAX_PLATFORMS=cpu python
#: benchmarks/suite.py --configs 1`` on the CPU (float64)
C1_JAX = {"niter": 65, "converged": True}
#: the unpadded V-cycle's levels of configs 2 and 3, finest first: K1
#: runs at every one of them (31 the coarsest, whose 60 sweeps are one
#: launch of K1's coarse form); each is timed; and a ragged grid (rows and
#: columns of no common width)
UNPADDED_LEVELS = (BL_NX, 2047, NX, 511, 255, 127, 63, 31)
UNPADDED_TIMED = UNPADDED_LEVELS
UNPADDED_RAGGED = (1021, 1000)
#: config 2's lane gate on inner iterations (within 3) holds at this size,
#: benchmarks/suite.py's own full size for config 2: from 2047^2 up the
#: float32 inner solves stop on their stagnation window at the float32
#: floor, and whether a late cycle takes ~6 iterations or ~26 depends on
#: the rounding alone (``--witness``; ROADMAP.md queue C).  Above it each
#: cycle is bounded instead (``_bl_lanes_agree``)
C2_GATE_NX = 1023
#: small unpadded grids of K1's parity (no timing): levels below the
#: V-cycle's coarsest and a ragged one
UNPADDED_SMALL = ((1, 1), (3, 3), (7, 7), (33, 17))
#: operands that start 1, 2 and 3 floats past a 16-byte boundary (a view
#: into a larger buffer): K1's row-ring tiles stage every row as its
#: aligned superset and store aligned groups across lanes
UNPADDED_OFFSETS = (1, 2, 3)
#: K1's coarse form: (nrows, ncols, R, P) of the unpadded and the padded
#: coarsest level of the V-cycles (31^2 with 60 sweeps), and the largest
#: V-cycle level that fits it
COARSE_SHAPES = ((31, 31, 31, 31), (31, 31, 32, 128), (127, 127, 127, 127))
COARSE_SWEEPS = 60
#: K7 as config 3 runs it: restarted GMRES(30) builds a 31-row basis of
#: 4095^2 and projects along the dual basis P at rows 1..30 (16 the
#: middle launch, 30 the largest); 31 the basis's full height; and the
#: same basis one and two columns wider, so that N takes every residue
#: mod 4 but 0 (4095^2 is 1 mod 4)
C3_PROJECT_M = 31
C3_PROJECT_ROWS = (16, 30, 31)
C3_PROJECT_EXTRA = (0, 1, 2)
#: the grids at which the unpadded Laplacian is timed as K1 and as the
#: plain stencil: the crossover behind K1 at every level of the unpadded
#: V-cycle (``ops._multigrid_unpadded``)
CROSSOVER_LEVELS = (1, 3, 7, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095)
#: the lanes of configs 2 and 3: (name, impl, config 3's ortho)
BL_LANES = (("cuda", "cuda", "cgs2_pallas"), ("torch", "torch", "cgs2"))


def _lap_coeffs(n, m):
    """``ops.poisson_2d``'s stencil on an n x m grid."""
    hx2, hy2 = (1.0 / (n + 1)) ** 2, (1.0 / (m + 1)) ** 2
    return (2.0 / hx2 + 2.0 / hy2, -1.0 / hx2, -1.0 / hx2, -1.0 / hy2,
            -1.0 / hy2)


def _cd3_coeffs(n, m):
    """Config 3's convection-diffusion stencil (eps 1, wind (1, 0.5),
    upwind) on an n x m grid, as ``ops.convection_diffusion_2d``."""
    hx, hy = 1.0 / (n + 1), 1.0 / (m + 1)
    return (2.0 / hx ** 2 + 2.0 / hy ** 2 + 1.0 / hx + 0.5 / hy,
            -1.0 / hx ** 2 - 1.0 / hx, -1.0 / hx ** 2,
            -1.0 / hy ** 2 - 0.5 / hy, -1.0 / hy ** 2)


def unpadded_stencil_phase(device):
    """K1 on the unpadded odd-width grids of the unpadded V-cycle and on a
    ragged grid (also with the operand 1, 2, 3 floats off 16-byte
    alignment), through the ``stencil5_pipelined`` entry, against its
    plain version: float32 ``rtol=2e-6`` and the FMA-aware ``atol``, with
    the Laplacian constants and config 3's convection-diffusion
    constants; on ``UNPADDED_TIMED`` its device time, its plain
    version's and ``F.conv2d``'s (zero padding is the Dirichlet ghost)
    beside the bound.  Returns ``{"max_abs_err", "times"}``."""
    import torch
    from krypy_tpu_torch.kernels import stencil as kst
    from krypy_tpu_torch.kernels.parity import fma_atol

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(11)
    out = {"max_abs_err": 0.0, "times": {}}
    cases = [(n, n, 0) for n in UNPADDED_LEVELS]
    cases += [(*UNPADDED_RAGGED, 0), *((n, m, 0) for n, m in UNPADDED_SMALL),
              *((*UNPADDED_RAGGED, off) for off in UNPADDED_OFFSETS)]
    for n, m, off in cases:
        x = torch.randn(n * m + off, generator=gen, device=device)[off:]
        for kind, co in (("lap", _lap_coeffs(n, m)),
                         ("cd3", _cd3_coeffs(n, m))):
            def kern(co=co):
                return kst.stencil5_pipelined(x, nx=n, ny=m, coeffs=co)

            def plain(v, co=co):
                return kst.stencil5_affine_torch(v.view(n, m), None, co, n,
                                                 m).view(-1)

            got, want, want64 = kern(), plain(x), plain(x.double())
            torch.cuda.synchronize()
            err = (got - want).abs()
            atol = fma_atol(want, want64)
            max_err = float(err.max())
            if not bool(torch.all(err <= atol + 2e-6 * want.abs())) or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError(
                    f"stencil5_affine unpadded {kind} at {n}x{m}: max abs "
                    f"err {max_err:.3e} exceeds rtol=2e-6, atol={atol:.3e}")
            out["max_abs_err"] = max(out["max_abs_err"], max_err)
            line = (f"parity stencil5_affine unpadded {kind} matvec {n}x{m} "
                    f"offset={off} max_abs_err={max_err:.3e} "
                    f"atol={atol:.3e}")
            if n == m and n in UNPADDED_TIMED:
                # x read, out written; ~13 operations per element
                b_ms, b_by = bound(8 * n * m, 15 * n * m)
                ms, ms_src = _device_ms(kern, b_ms)
                plain_ms, plain_src = _device_ms(lambda: plain(x), b_ms)
                lib = _conv2d_matvec(x, n, m, co)
                lib_err = float((lib - got).abs().max())
                lib_ms, lib_src = _device_ms(
                    lambda co=co: _conv2d_matvec(x, n, m, co), b_ms)
                out["times"][(n, kind)] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by,
                    timed_by=dict(ms=ms_src, plain_ms=plain_src,
                                  library_ms=lib_src))
                line += (f" conv2d_ms={lib_ms:.5f} conv2d_err={lib_err:.2e}"
                         f" device_ms kernel={ms:.5f} ({ms_src}) "
                         f"plain={plain_ms:.5f} ({plain_src}) "
                         f"bound={b_ms:.5f} ({b_by})")
            print(line, flush=True)
        del x
    return out


def k1_crossover(device):
    """The unpadded level Laplacian as one K1 launch and as the plain
    stencil (``ops._lap2d_grid``: K1's plain version with the Laplacian's
    coefficients), per call over back-to-back calls (CUDA events: the
    launch gaps count, which is what a host-bound V-cycle pays), at every
    level size of ``CROSSOVER_LEVELS``.  Prints one JSON line."""
    import torch
    from krypy_tpu_torch import kernels, ops

    gen = torch.Generator(device=device).manual_seed(12)
    rows = []
    for n in CROSSOVER_LEVELS:
        h2 = (1.0 / (n + 1)) ** 2
        u = torch.randn((n, n), generator=gen, device=device)
        co = ops._lap_coeffs(h2)
        rows.append({
            "n": n,
            "plain_ms": _time_ms(lambda: ops._lap2d_grid(u, h2)),
            "k1_ms": _time_ms(lambda: kernels.stencil5_pipelined(
                u.reshape(-1), nx=n, ny=n, coeffs=co))})
    print(json.dumps({"k1_unpadded_crossover": rows,
                      "k1_faster_at": [r["n"] for r in rows
                                       if r["k1_ms"] < r["plain_ms"]]}),
          flush=True)
    return rows


def _device_split(fn, reps=10):
    """Device ms of one call of ``fn`` by kernel, summed per name class
    (torch.profiler, mean of ``reps`` calls): a K7 call's phase 0
    (``project_partial*``), its second pass (``reduce*``) and phase 1
    (``update*``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in _device_events(prof):
        key = ("phase0" if "project_partial" in e.name else
               "reduce" if "reduce" in e.name else
               "phase1" if "update" in e.name else e.name[:40])
        out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return out


def kernels_phase(device):
    """The slice-7 kernels' device times in one place, for comparing
    commits (``--only kernels``; a copy of this script in a checkout of an
    earlier commit times that commit's kernels the same way): K1's matvec
    on the V-cycles' padded and unpadded buffers; K4 at ``NS_ROWS`` of
    4096^2; K7 along ``V`` and along a second basis there, on the same
    basis shifted by one element (every row and ``w`` off 16-byte
    alignment), and at config 3's shape (``C3_PROJECT_M`` x ``BL_NX``^2
    along a second basis, rows 16 and 30), each K7 time split by phase.
    Prints one JSON line and returns it."""
    import torch
    from krypy_tpu_torch import ops
    from krypy_tpu_torch.kernels import orthogonalize as korth
    from krypy_tpu_torch.kernels import stencil as kst

    gen = torch.Generator(device=device).manual_seed(15)
    rec = {"k1_matvec_ms": {}, "k4_ms": {}, "k7": {}}
    for n in (*KERNEL_LEVELS, 255):
        for R in (n + 1, n):
            u = torch.randn(R * R, generator=gen, device=device)
            co = ops._lap_coeffs((1.0 / (n + 1)) ** 2)
            b_ms, _ = bound(8 * R * R, 15 * R * R)
            ms, src = _device_ms(lambda: kst.stencil5_affine(
                u, nx=R, ny=R, coeffs=co, ncols=n, nrows=n), b_ms)
            rec["k1_matvec_ms"][f"{n}^2 in {R}^2"] = dict(
                ms=ms, bound_ms=b_ms, timed_by=src)
    cases = [(NS_ROWS[1], (NS_NX + 1) ** 2, NS_ROWS, off)
             for off in (0, 1)]
    cases.append((C3_PROJECT_M, BL_NX * BL_NX, (16, 30), 0))
    for m, N, rows_list, off in cases:
        flat = torch.randn(2 * m * N + off, generator=gen, device=device)
        V = flat[off:off + m * N].view(m, N) / math.sqrt(N)
        B = flat[off + m * N:].view(m, N) / math.sqrt(N)
        w = torch.randn(N + off, generator=gen, device=device)[off:]
        for rows in rows_list:
            mask = (torch.arange(m, device=device) < rows).float()
            floor = 1e3 * (2 * rows + 3) * N * 4 / PEAK_BYTES
            for basis in ((None, B) if m == NS_ROWS[1] else (B,)):
                split = _device_split(
                    lambda: korth.cgs_project(V, w, mask, basis, rows=rows))
                key = (f"{m}x{N} offset {off} rows {rows} along "
                       f"{'V' if basis is None else 'B'}")
                rec["k7"][key] = dict(ms=sum(split.values()), split=split,
                                      two_sweep_floor_ms=floor)
            if m == NS_ROWS[1] and off == 0:
                b4 = 1e3 * (rows + 1) * N * 4 / PEAK_BYTES
                rec["k4_ms"][f"{rows} rows of {N}"] = _device_ms(
                    lambda: korth.project_prefix(V, w, mask, rows=rows),
                    b4)[0]
        del flat, V, B, w
        torch.cuda.empty_cache()
    print(json.dumps({"kernels_phase": rec}), flush=True)
    return rec


def config1_phase(device):
    """Config 1 on the card against the JAX package's recorded counts."""
    from krypy_tpu_torch import suite

    rec = suite.config1_readme_gmres(device)
    print(json.dumps({"phase": "config1", **rec, "jax": C1_JAX}), flush=True)
    if rec["niter"] != C1_JAX["niter"] or \
            rec["converged"] != C1_JAX["converged"]:
        raise AssertionError(f"config 1: {rec}, the JAX package {C1_JAX}")
    return rec


def _bl_solve(what, lane, solve, A64, b, nx, record):
    """A refined solve of config 2 or 3: warm (kernel build, first
    launches, the hidden warm-up), then once with its launches counted,
    through ``refine_to`` around the pipeline's inner solve (as ``solve``
    runs it) counting each cycle's inner iterations
    (``info["inner_niters"]``); checks the true float64 residual.
    Returns ``(result, info, rel, counts)``."""
    import torch
    from krypy_tpu_torch import functional as F, kernels, suite

    niters = []

    def inner(rr):
        r = solve.inner(rr)
        niters.append(int(r.niter))
        return r

    solve(b)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res, info = F.refine_to(A64, b, inner, tol=suite.TOL, compiled=True,
                            warm=False)
    counts = kernels.launch_counts()
    info["inner_niters"] = niters
    hist = res.resnorms.cpu().numpy()
    rel = float(torch.linalg.vector_norm(b - A64(res.x))
                / torch.linalg.vector_norm(b))
    used = {k: c for k, c in counts.items() if c}
    print(f"{what} lane={lane} nx={nx} wall_s={info['wall_s']:.6f} "
          f"cycles={info['cycles']} inner_iters={info['inner_iters']} "
          f"{info['inner_niters']} rel={rel:.3e} outer residuals "
          f"{hist.tolist()} launches={used}", flush=True)
    _check_solution(res.x, nx * nx, rel, hist)
    record[what, lane] = {"cycles": info["cycles"],
                          "inner_iters": info["inner_iters"],
                          "inner_niters": info["inner_niters"], "rel": rel,
                          "outer_residuals": hist.tolist(),
                          "launches": used}
    return res, info, rel, counts


def _bl_lanes_agree(what, runs, want_kernels, inner=True):
    """Equal refinement cycles and, with ``inner``, inner iterations
    within 3; without it, each cycle bounded: the first cycles within 1
    and no cycle of the kernel lane longer than the plain lane's longest
    plus 1 (at the float32 floor a cycle ends 20 iterations after its
    best, and rounding moves a late cycle between ~5 and the first
    cycle's ~26 (``--witness``), but not past it; a weaker V-cycle delays
    every cycle's best).  On the kernel lane each kernel of
    ``want_kernels`` launched (``cgs_project`` twice per GMRES iteration,
    the coarse form once per V-cycle: as often as the V-cycle's finest
    level residual) and no other, on the plain lane none."""
    (_, ic, _, cc), (_, it, _, ct) = runs["cuda"], runs["torch"]
    if ic["cycles"] != it["cycles"] or inner and abs(
            ic["inner_iters"] - it["inner_iters"]) > 3:
        raise AssertionError(
            f"{what}: kernel lane {ic['cycles']} cycles / "
            f"{ic['inner_iters']} inner iterations against plain lane "
            f"{it['cycles']} / {it['inner_iters']} (allowed: equal cycles"
            + (", inner iterations within 3)" if inner else ")"))
    kn, pn = ic["inner_niters"], it["inner_niters"]
    if not inner and (abs(kn[0] - pn[0]) > 1 or max(kn) > max(pn) + 1):
        raise AssertionError(
            f"{what}: kernel lane's inner iterations per cycle {kn} "
            f"against the plain lane's {pn} (allowed: first cycles within "
            "1, no cycle past the plain lane's longest plus 1)")
    if any(ct.values()):
        raise AssertionError(f"{what}: the plain lane launched kernels: {ct}")
    for name, c in cc.items():
        if (c > 0) != (name in want_kernels):
            raise AssertionError(f"{what}: kernel lane launched {name} {c} "
                                 f"times (expected: {want_kernels} only)")
    if "cgs_project" in want_kernels and \
            cc["cgs_project"] != 2 * ic["inner_iters"]:
        raise AssertionError(
            f"{what}: {cc['cgs_project']} K7 launches in "
            f"{ic['inner_iters']} GMRES iterations (2 per iteration)")


def _busy_share(label, solve, b, median_wall):
    """One profiled solve: its device time (kernels and copies,
    torch.profiler) over the unprofiled median wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve(b)
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in _device_events(prof)) / 1e6
    print(f"busy {label}: device {busy:.6f} s per solve, "
          f"{100 * busy / median_wall:.1f}% of the median wall "
          f"{median_wall:.6f} s", flush=True)
    return busy


def _bl_timing(label, solves, b, record):
    """``BL_ROUNDS`` interleaved solves per lane and the busy share of
    each; the summary goes into ``record[label]``."""
    walls = timing_phase(label, solves, b, BL_ROUNDS)
    record[label] = {}
    for lane, ts in walls.items():
        med = statistics.median(ts)
        record[label][lane] = dict(
            median=med, min=min(ts), max=max(ts),
            busy_s=_busy_share(f"{label} lane={lane}", solves[lane], b, med))
        record[label][lane]["busy_share"] = \
            record[label][lane]["busy_s"] / med


def config2_phase(device, nx=BL_NX, timed=True):
    """Config 2 (``suite.make_config2``) on both lanes: CG and MINRES in
    float64 refinement to 1e-8, gated on the true residual, on each other
    (equal cycles; inner iterations within 3 at ``C2_GATE_NX`` and below,
    each cycle bounded above it)
    and on K1 (the only kernel of the kernel lane; none on the plain
    lane); then, with ``timed``, timed.  Returns the kernel lane's
    launches and the record."""
    import torch
    from krypy_tpu_torch import suite

    gate_inner = nx <= C2_GATE_NX
    record = {"phase": "config2", "nx": nx, "N": nx * nx}
    if gate_inner and nx < BL_NX:
        record["reduced_from"] = BL_NX
    elif not gate_inner:
        record["inner_iters_gated_at"] = C2_GATE_NX
    runs, solves, total = {}, {}, {}
    for lane, impl, _ in BL_LANES:
        _, A64, _, _, b, s = suite.make_config2(nx, impl, device)
        for name, solve in s.items():
            runs[name, lane] = _bl_solve(f"config2 {name}", lane, solve, A64,
                                         b, nx, record)
            solves.setdefault(name, {})[lane] = solve
        torch.cuda.empty_cache()
    for name in solves:
        _bl_lanes_agree(f"config2 {name} nx={nx}",
                        {lane: runs[name, lane] for lane in ("cuda", "torch")},
                        ("stencil5_affine", "stencil5_coarse"),
                        inner=gate_inner)
        for k, c in runs[name, "cuda"][3].items():
            total[k] = total.get(k, 0) + c
    if timed:
        for name, lanes in solves.items():
            _bl_timing(f"config2 {name}", lanes, b, record)
    return total, record


def config3_phase(device, nx=BL_NX):
    """Config 3 (``suite.make_config3``) on both lanes (K1 and K7 along
    the dual basis P with ``ortho="cgs2_pallas"``; the plain versions and
    ``cgs2``), gated as config 2 with K7 twice per GMRES iteration; then
    timed.  Returns the kernel lane's launches and the record."""
    import torch
    from krypy_tpu_torch import suite

    record = {"phase": "config3", "nx": nx, "N": nx * nx}
    b = torch.ones(nx * nx, dtype=torch.float64, device=device)
    runs, solves = {}, {}
    for lane, impl, ortho in BL_LANES:
        solve, A64 = suite.make_config3(nx, impl, ortho, device)
        runs[lane] = _bl_solve("config3", lane, solve, A64, b, nx, record)
        solves[lane] = solve
    _bl_lanes_agree("config3", runs,
                    ("stencil5_affine", "stencil5_coarse", "cgs_project"))
    _bl_timing("config3", solves, b, record)
    return runs["cuda"][3], record


def config3_project_phase(device, nx=BL_NX):
    """K7 at the shape config 3 gives it: a float32 ``C3_PROJECT_M``-row
    basis of ``nx^2`` (odd) columns projected along a second basis (the
    dual basis P), with GMRES's mask (every row below ``rows``), at
    ``C3_PROJECT_ROWS``, and the same with N one and two columns larger
    (``C3_PROJECT_EXTRA``: every residue of N mod 4 but 0, which the
    project phase's 4096^2 has): held to float64 with the planted faults
    (:func:`_project_parity`) and timed (:func:`_project_timing`).
    Returns ``{"max_abs_err", "times"}``, times keyed by ``(extra,
    rows)``."""
    import torch

    m = C3_PROJECT_M
    gen = torch.Generator(device=device).manual_seed(13)
    report = {"max_abs_err": 0.0, "times": {}}
    for extra in C3_PROJECT_EXTRA:
        N = nx * nx + extra
        V, P = (torch.randn(m, N, generator=gen, device=device)
                / math.sqrt(N) for _ in range(2))
        w = torch.randn(N, generator=gen, device=device)
        for rows in C3_PROJECT_ROWS:
            mask = (torch.arange(m, device=device) < rows).float()
            _project_parity(V, w, mask, rows, (P,), report)
            report["times"][extra, rows] = _project_timing(V, w, mask, rows,
                                                           P)
        del V, P, w
        torch.cuda.empty_cache()
    return report


def coarse_phase(device):
    """K1's coarse form (``kernels.stencil.stencil5_coarse``) on
    ``COARSE_SHAPES`` at 1, 2 and ``COARSE_SWEEPS`` sweeps against its
    plain version (the stencil phase's tolerance; noise in the pads of
    ``r``, exact zeros off the region); at ``COARSE_SWEEPS`` its device
    time and per-call host time beside the bound, its plain version's
    and the ``COARSE_SWEEPS`` per-sweep K1 launches it replaces (K1's
    damped-Jacobi step from zero, as the unpadded V-cycle launched it
    before, without its elementwise legs).  Returns ``{"max_abs_err",
    "times"}``, times keyed by ``(R, P)``."""
    import torch
    from krypy_tpu_torch import kernels
    from krypy_tpu_torch.kernels import stencil as kst
    from krypy_tpu_torch.kernels.parity import fma_atol

    gen = torch.Generator(device=device).manual_seed(14)
    out = {"max_abs_err": 0.0, "times": {}}
    for nrows, ncols, R, P in COARSE_SHAPES:
        r = torch.randn(R * P, generator=gen, device=device)
        A = _lap_coeffs(nrows, ncols)
        w = 0.8 / A[0]
        for sweeps in (1, 2, COARSE_SWEEPS):
            kw = dict(nx=R, ny=P, coeffs=A, w=w, sweeps=sweeps, ncols=ncols,
                      nrows=nrows)

            def kern(kw=kw):
                return kst.stencil5_coarse(r, **kw)

            def plain(v, sweeps=sweeps):
                return kst.stencil5_coarse_torch(v.view(R, P), A, w, sweeps,
                                                 nrows, ncols).view(-1)

            got, want, want64 = kern(), plain(r), plain(r.double())
            torch.cuda.synchronize()
            err = (got - want).abs()
            atol = fma_atol(want, want64)
            o = got.view(R, P)
            if not bool(torch.all(err <= atol + 2e-6 * want.abs())) or \
                    not bool(torch.all(o[nrows:] == 0)) or \
                    not bool(torch.all(o[:, ncols:] == 0)):
                raise AssertionError(
                    f"stencil5_coarse {nrows}x{ncols} in {R}x{P}, {sweeps} "
                    f"sweeps: max abs err {float(err.max()):.3e} exceeds "
                    f"rtol=2e-6, atol={atol:.3e}, or pads not zero")
            out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
            line = (f"parity stencil5_coarse {nrows}x{ncols} ({R}x{P}) "
                    f"sweeps={sweeps} max_abs_err={float(err.max()):.3e} "
                    f"atol={atol:.3e}")
            if sweeps == COARSE_SWEEPS:
                sc = tuple(-w * c for c in A)

                def per_sweep():
                    u = torch.zeros_like(r)
                    for _ in range(sweeps):
                        u = kst.stencil5_affine(u, r, nx=R, ny=P, coeffs=sc,
                                                ncols=ncols, nrows=nrows,
                                                alpha=1.0, beta=w)
                    return u

                # r read and the buffer written once; ~15 operations per
                # point and sweep
                b_ms, b_by = bound(4 * (nrows * ncols + R * P),
                                   15 * sweeps * nrows * ncols)
                ms, ms_src = _device_ms(kern, b_ms)
                plain_ms, plain_src = _device_ms(lambda: plain(r), b_ms)
                per_ms, per_src = _device_ms(per_sweep, b_ms)
                before = kernels.launch_counts()["stencil5_affine"]
                kern()
                launches = kernels.launch_counts()["stencil5_affine"] - before
                call = _time_ms(kern)
                per_call = _time_ms(per_sweep, samples=5)
                out["times"][R, P] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    per_sweep_k1_ms=per_ms, call_ms=call,
                    per_sweep_k1_call_ms=per_call, sweeps=sweeps,
                    timed_by=dict(ms=ms_src, plain_ms=plain_src,
                                  per_sweep_k1_ms=per_src))
                line += (f" device_ms coarse={ms:.5f} ({ms_src}) "
                         f"plain={plain_ms:.5f} ({plain_src}) "
                         f"{sweeps}_K1_launches={per_ms:.5f} ({per_src}) "
                         f"bound={b_ms:.6f} ({b_by}) | per_call_ms "
                         f"coarse={call:.5f} ({launches} launch per call) "
                         f"{sweeps}_K1_launches={per_call:.5f}")
                if launches != 1:
                    raise AssertionError(f"stencil5_coarse made {launches} "
                                         "launches in one call")
            print(line, flush=True)
        del r
    return out


#: the V-cycles whose host time per application the default run takes:
#: (label, nx, pad_cols) with coarsest 31 and 60 coarse sweeps, as the
#: north star (padded 4095), bench.py's Poisson (padded 1023) and configs
#: 2 and 3 (unpadded 4095) build them
VCYCLES = (("padded 4095", NS_NX, True), ("padded 1023", NX, True),
           ("unpadded 4095", NS_NX, False))


def vcycle_host_phase(device):
    """Host ms per V-cycle application on the kernel lane, synchronised
    (20 samples each after a warm-up round, taken round-robin so that
    drift of the host's speed falls on all), with K1's coarse form and
    with it switched off (``coarse_fits`` forced false: the coarsest
    level's 60 sweeps as before it, plain torch on the padded lane and a
    K1 launch per sweep on the unpadded one), and each application's
    kernel launches.  Prints one JSON line and returns it."""
    import torch
    from krypy_tpu_torch import kernels, ops
    from krypy_tpu_torch.kernels import stencil as kst

    parts = {}
    for label, nx, pad in VCYCLES:
        M = ops.multigrid_poisson_preconditioner(
            nx, coarsest=31, coarse_sweeps=60, pad_cols=pad, impl="cuda",
            device=device)
        r = torch.ones(M.shape[0], dtype=torch.float32, device=device)
        for coarse in (True, False):
            parts[label, coarse] = (M, r)
    fits = kst.coarse_fits
    samples = {key: [] for key in parts}
    launches = {}
    try:
        for k in range(21):
            for (label, coarse), (M, r) in parts.items():
                kst.coarse_fits = fits if coarse else (lambda *a: False)
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t = time.perf_counter()
                M(r)
                torch.cuda.synchronize()
                if k:  # the first round warms up
                    samples[label, coarse].append(
                        (time.perf_counter() - t) * 1e3)
                launches[label, coarse] = {
                    n: c for n, c in kernels.launch_counts().items() if c}
    finally:
        kst.coarse_fits = fits
    rec = {}
    for (label, coarse), ts in samples.items():
        key = f"{label} {'coarse form' if coarse else 'per-sweep coarse'}"
        rec[key] = dict(median_ms=statistics.median(ts), min_ms=min(ts),
                        max_ms=max(ts), launches=launches[label, coarse])
        print(f"vcycle host ms: {key}: median "
              f"{statistics.median(ts):.3f} min {min(ts):.3f} max "
              f"{max(ts):.3f} (20 samples) launches "
              f"{launches[label, coarse]}", flush=True)
        if coarse and launches[label, coarse].get("stencil5_coarse") != 1:
            raise AssertionError(f"V-cycle {label}: coarse form launched "
                                 f"{launches[label, coarse]}, not once")
    print(json.dumps({"vcycle_host_ms": rec}), flush=True)
    return rec


def baseline_witness(device, nx=BL_NX):
    """Witnesses of config 2's float32 finding (``--witness``; gates
    nothing, ROADMAP.md queue C reads it): at ``nx``, CG and MINRES on
    both lanes cycle by cycle, with the right-hand side and with it times
    3 (the same relative residuals in exact arithmetic, other roundings),
    and on the plain lane with float64 inner arithmetic: how far the inner
    iteration counts depend on rounding alone."""
    import torch
    from krypy_tpu_torch import suite

    for lane, impl, _ in BL_LANES:
        for dtype in ((torch.float32, torch.float64) if impl == "torch"
                      else (torch.float32,)):
            _, A64, _, _, b, s = suite.make_config2(nx, impl, device,
                                                    dtype=dtype)
            for name, solve in s.items():
                for scale in ((1.0, 3.0) if dtype == torch.float32
                              else (1.0,)):
                    _, rels, niters = _cycles(solve.inner, A64, scale * b, 8,
                                              dtype, stop_at=suite.TOL)
                    print(f"witness config2 nx={nx} lane={lane} {name} "
                          f"{str(dtype)[6:]} rhs times {scale:g}: "
                          f"cycles={len(niters)} "
                          f"inner_iters={sum(niters)} inner iterations "
                          f"{niters} outer residuals {rels}", flush=True)
            torch.cuda.empty_cache()


def baseline_phase(device):
    """Unpadded K1 parity and the crossover, K7 at config 3's shape,
    then configs 1, 2 (at ``BL_NX``, and its inner-iteration gate at
    ``C2_GATE_NX``) and 3.  Returns the unpadded K1 report (K7's under
    ``"cgs_project"``), each config's kernel-lane launches and the
    records."""
    report = unpadded_stencil_phase(device)
    report["crossover"] = k1_crossover(device)
    report["cgs_project"] = config3_project_phase(device)
    config1_phase(device)
    c2_counts, c2_record = config2_phase(device)
    _, c2_cut = config2_phase(device, C2_GATE_NX, timed=False)
    for rec in (c2_record, c2_cut):
        print(json.dumps({k if isinstance(k, str) else " ".join(k): v
                          for k, v in rec.items()}), flush=True)
    c3_counts, c3_record = config3_phase(device)
    print(json.dumps({k if isinstance(k, str) else " ".join(k): v
                      for k, v in c3_record.items()}), flush=True)
    return report, c2_counts, c3_counts, c2_record, c3_record


# ---------------------------------------------------------------------------
# config 5: Newton-Krylov over recycled GMRES, K1 under torch.func.jvp
# ---------------------------------------------------------------------------

#: config 5's grids: benchmarks/suite.py's own (96^2), the full width
#: (bench.py's 1023^2, a 1M-unknown Gross-Pitaevskii grid) and 511^2,
#: where recycling still changes the counts
C5_NX, C5_FULL, C5_MID = 96, NX, 511
#: the JAX package's counts: benchmarks/suite.py's
#: config5_nls_newton_recycling on the CPU (XLA:CPU, float32); ``"auto"``
#: is its config 6, whose widths follow that run's own clock
C5_JAX = {
    96: {"newton_steps": 5, "inner_iters": [34, 86, 33, 30, 18]},
    "96 auto": {"newton_steps": 5, "selected_widths": [0, 5, 5, 4, 5],
                "inner_iters": [34, 85, 16, 24, 10]},
    511: {"newton_steps": 5, "inner_iters": [188, 250, 250, 96, 122]},
    1023: {"newton_steps": 7, "inner_iters": [250] * 7},
}
#: config 5's inner iteration cap (suite.py's ``inner_maxiter``) and the
#: widths its auto variant may choose (``max_vectors = recycle + 2 = 5``)
C5_CAP = 250
C5_WIDTHS = tuple(range(6))
#: timed Newton sequences per lane at each full-width grid
C5_ROUNDS = 3
#: K1's forward-mode rule is held and timed on these grids: config 5's
#: two and one ragged odd one
C5_JVP_GRIDS = ((C5_NX, C5_NX), (C5_FULL, C5_FULL), (1021, 1000))


def config5_jvp_phase(device):
    """K1's forward-mode rule on the card: ``torch.func.jvp`` of ``v ->
    stencil5_affine(v, g, alpha, beta)`` (the matvec, which config 5's
    Laplacian is, and the affine form with ``g``) and of the nls residual
    ``F`` of config 5 on the kernel lane, against ``torch.func.jvp`` of
    the plain versions, float32, the stencil phase's tolerance; each jvp
    launches K1 twice (the primal and the tangent, the second counted as
    a tangent, ``kernels.tangent_counts()``).  At each grid the matvec's jvp is timed
    (device ms, and host ms of one synchronised call) beside the forward
    call, the plain version's jvp and ``F.conv2d`` on the pair ``(x,
    v)``, and on square grids the host ms of one Jacobian action of
    config 5 on either lane.  Returns ``{"max_abs_err", "times": {(nx, ny): {...}}}``."""
    import torch
    from krypy_tpu_torch import interop, kernels, ops
    from krypy_tpu_torch.kernels import stencil as kst
    from krypy_tpu_torch.kernels.parity import fma_atol

    report = {"max_abs_err": 0.0, "times": {}}

    def hold(what, got, want, want64):
        err = float((got - want).abs().max())
        atol = fma_atol(want, want64)
        report["max_abs_err"] = max(report["max_abs_err"], err)
        np.testing.assert_allclose(interop.to_numpy(got),
                                   interop.to_numpy(want), rtol=2e-6,
                                   atol=atol, err_msg=what)

    for nx, ny in C5_JVP_GRIDS:
        gen = torch.Generator(device=device).manual_seed(nx + ny)
        x, v, g, gt = (torch.randn(nx * ny, generator=gen, device=device)
                       for _ in range(4))
        co = _lap_coeffs(nx, ny)
        for use, al, be in (("matvec", 0.0, 0.0), ("affine", 0.5, -1.5)):
            def k1(u, gg=None, al=al, be=be):
                return kst.stencil5_affine(u, gg, nx=nx, ny=ny, coeffs=co,
                                           alpha=al, beta=be)

            def plain(u, gg=None, al=al, be=be):
                return kst.stencil5_affine_torch(
                    u.reshape(nx, ny),
                    None if gg is None else gg.reshape(nx, ny), co, nx, ny,
                    al, be).reshape(-1)

            args, tans = ((x,), (v,)) if use == "matvec" else ((x, g),
                                                              (v, gt))
            before = (kernels.launch_counts()["stencil5_affine"],
                      kernels.tangent_counts()["stencil5_affine"])
            pk, tk = torch.func.jvp(k1, args, tans)
            torch.cuda.synchronize()
            after = (kernels.launch_counts()["stencil5_affine"],
                     kernels.tangent_counts()["stencil5_affine"])
            if (after[0] - before[0], after[1] - before[1]) != (2, 1):
                raise AssertionError(f"K1 jvp {nx}x{ny} {use}: (launches, "
                                     f"tangents) {before} -> {after}")
            pp, tp = torch.func.jvp(plain, args, tans)
            pp64, tp64 = torch.func.jvp(
                plain, tuple(a.double() for a in args),
                tuple(t.double() for t in tans))
            hold(f"K1 jvp {nx}x{ny} {use} primal", pk, pp, pp64)
            hold(f"K1 jvp {nx}x{ny} {use} tangent", tk, tp, tp64)
        if nx == ny:
            Fk, uk = ops.nls_residual_2d(nx, amplitude=3.0, impl="cuda",
                                         device=device)
            Fp, _ = ops.nls_residual_2d(nx, amplitude=3.0, device=device)
            Fp64, _ = ops.nls_residual_2d(nx, amplitude=3.0,
                                          dtype=torch.float64, device=device)
            u = uk + 0.1 * x
            before = kernels.tangent_counts()["stencil5_affine"]
            pk, tk = torch.func.jvp(Fk, (u,), (v,))
            torch.cuda.synchronize()
            if kernels.tangent_counts()["stencil5_affine"] != before + 1:
                raise AssertionError(f"nls F jvp {nx}^2: no tangent launch")
            pp, tp = torch.func.jvp(Fp, (u,), (v,))
            _, tp64 = torch.func.jvp(Fp64, (u.double(),), (v.double(),))
            hold(f"nls F jvp {nx}^2 tangent", tk, tp, tp64)
            # the primal's float64 value with the float32 lane's own
            # source g (F(0) = -g exactly)
            z = torch.zeros_like(u)
            pp64 = Fp64(u.double()) - Fp64(z.double()) + Fp(z).double()
            hold(f"nls F jvp {nx}^2 primal", pk, pp, pp64)

        def mv(u):
            return kst.stencil5_affine(u, nx=nx, ny=ny, coeffs=co)

        def mv_plain(u):
            return kst.stencil5_affine_torch(u.reshape(nx, ny), None, co,
                                             nx, ny).reshape(-1)

        xv = torch.stack([x, v]).view(2, 1, nx, ny)
        wt = torch.tensor([[0.0, co[1], 0.0], [co[3], co[0], co[4]],
                           [0.0, co[2], 0.0]], device=device).view(1, 1, 3, 3)
        # x and v read, the primal and the tangent written; ~15 operations
        # per output
        bms, by = bound(16 * nx * ny, 30 * nx * ny)
        t = {"bound_ms": bms, "bound_by": by}
        t["ms"], t["timed_by"] = _device_ms(
            lambda: torch.func.jvp(mv, (x,), (v,)), bms)
        t["forward_ms"], _ = _device_ms(lambda: mv(x), bms / 2)
        t["plain_ms"], _ = _device_ms(
            lambda: torch.func.jvp(mv_plain, (x,), (v,)), bms)
        t["library_ms"], _ = _device_ms(
            lambda: torch.nn.functional.conv2d(xv, wt, padding=1), bms)
        t["host_ms"] = _host_ms(lambda: torch.func.jvp(mv, (x,), (v,)))
        t["forward_host_ms"] = _host_ms(lambda: mv(x))
        t["plain_host_ms"] = _host_ms(
            lambda: torch.func.jvp(mv_plain, (x,), (v,)))
        if nx == ny:
            # config 5's Jacobian action, one call, on either lane
            t["F_jvp_host_ms"] = _host_ms(
                lambda: torch.func.jvp(Fk, (u,), (v,)))
            t["F_jvp_plain_host_ms"] = _host_ms(
                lambda: torch.func.jvp(Fp, (u,), (v,)))
        report["times"][nx, ny] = t
        print(f"K1 jvp {nx}x{ny}: device {t['ms']:.5f} ms ({t['timed_by']})"
              f" forward {t['forward_ms']:.5f} plain jvp "
              f"{t['plain_ms']:.5f} conv2d pair {t['library_ms']:.5f} bound "
              f"{bms:.5f} ({by}); host per call {t['host_ms']:.4f} ms "
              f"against forward {t['forward_host_ms']:.4f} and plain jvp "
              f"{t['plain_host_ms']:.4f}"
              + (f"; config 5's Jacobian action {t['F_jvp_host_ms']:.4f} "
                 f"(plain lane {t['F_jvp_plain_host_ms']:.4f})"
                 if nx == ny else ""), flush=True)
    return report


@contextlib.contextmanager
def _replayed_clock(record=None, replay=None):
    """A context in which ``AutoRecyclingGmres._observe`` appends each
    solve's ``wall / niter`` to ``record``, or takes the i-th entry of
    ``replay`` as its wall per iteration in place of the measured one:
    the plain lane of config 5a then chooses its widths from the kernel
    lane's clock, so that the two lanes' counts can be compared."""
    from krypy_tpu_torch.functional import deflation as defl

    orig = defl.AutoRecyclingGmres._observe
    replayed = []

    def observe(self, width, niter, wall_s):
        if niter > 0 and record is not None:
            record.append(wall_s / niter)
        if niter > 0 and replay is not None:
            wall_s = replay[len(replayed)] * niter
            replayed.append(width)
        return orig(self, width, niter, wall_s)

    defl.AutoRecyclingGmres._observe = observe
    try:
        yield
    finally:
        defl.AutoRecyclingGmres._observe = orig


def _c5_run(nx, impl, auto, device, record=None, replay=None):
    """One config-5 Newton sequence (``suite.config5_nls_newton_recycling``)
    with the launch counters zeroed just before it and read just after."""
    import torch
    from krypy_tpu_torch import kernels, suite

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with _replayed_clock(record, replay):
        out = suite.config5_nls_newton_recycling(nx, auto=auto, impl=impl,
                                                 device=device)
    torch.cuda.synchronize()
    out["launches"] = {k: c for k, c in kernels.launch_counts().items() if c}
    out["tangent_launches"] = kernels.tangent_counts()["stencil5_affine"]
    return out


def _c5_check(tag, nx, runs, jax_ref, exact_steps):
    """Config 5's gates on the kernel lane (``runs["cuda"]``, K1 in ``F``
    and its tangent) and the plain lane (``runs["torch"]``)."""
    k, p = runs["cuda"], runs["torch"]
    for lane, r in runs.items():
        if not r["converged"] or \
                r["fnorm_final"] > r["tol"] * max(r["f0"], 1.0):
            raise AssertionError(f"config {tag} {nx}^2 lane={lane}: not "
                                 f"converged: {r['resnorms']}, tol "
                                 f"{r['tol']}")
    js = jax_ref["newton_steps"]
    ks, ps = k["newton_steps"], p["newton_steps"]
    if exact_steps and not ks == ps == js or \
            max(abs(ks - ps), abs(ks - js), abs(ps - js)) > 1:
        raise AssertionError(f"config {tag} {nx}^2: Newton steps {ks} "
                             f"(kernel lane), {ps} (plain), JAX package "
                             f"{js}")
    for i, (a, b) in enumerate(zip(k["inner_iters"], p["inner_iters"])):
        if a < C5_CAP and b < C5_CAP and abs(a - b) > 3:
            raise AssertionError(
                f"config {tag} {nx}^2: solve {i}: {a} inner iterations on "
                f"the kernel lane against {b} on the plain lane "
                f"({k['inner_iters']} / {p['inner_iters']})")
    if p["launches"]:
        raise AssertionError(f"config {tag} {nx}^2: the plain lane launched "
                             f"{p['launches']}")
    # every call of F launches K1 once, every Jacobian action once more
    # for its tangent, building F once (the manufactured source)
    want = {"stencil5_affine": 1 + k["f_calls"] + k["jvp_calls"]}
    if k["launches"] != want or k["tangent_launches"] != k["jvp_calls"]:
        raise AssertionError(
            f"config {tag} {nx}^2: kernel lane launched {k['launches']} "
            f"with {k['tangent_launches']} tangents, expected {want} with "
            f"{k['jvp_calls']}")
    if p["tangent_launches"]:
        raise AssertionError(f"config {tag} {nx}^2: the plain lane "
                             f"launched {p['tangent_launches']} tangents")
    # one Jacobian action per GMRES iteration and at least one more per
    # solve (A x0)
    if k["jvp_calls"] < sum(k["inner_iters"]) + len(k["inner_iters"]):
        raise AssertionError(f"config {tag} {nx}^2: {k['jvp_calls']} "
                             f"Jacobian actions in {k['inner_iters']}")
    if k["selected_widths"] is not None:
        for lane, r in runs.items():
            if not all(w in C5_WIDTHS for w in r["selected_widths"]):
                raise AssertionError(f"config {tag} {nx}^2 lane={lane}: "
                                     f"widths {r['selected_widths']}")
        if k["selected_widths"] != p["selected_widths"]:
            raise AssertionError(
                f"config {tag} {nx}^2: widths {k['selected_widths']} "
                f"(kernel lane) against {p['selected_widths']} (plain lane, "
                "on the kernel lane's clock)")


_C5_KEYS = ("newton_steps", "inner_iters", "resnorms", "fnorm_final", "tol",
            "f0", "eval_floor", "converged", "selected_widths",
            "predicted_steps", "walls_s", "total_s", "warmup_s", "serve_s",
            "f_calls", "jvp_calls", "launches", "tangent_launches")


def _c5_line(tag, nx, runs, jax_ref, smi, **extra):
    rec = {"phase": "config5", "config": tag, "nx": nx, "N": nx * nx,
           "device": smi, "jax": jax_ref,
           "lanes": {lane: {key: r[key] for key in _C5_KEYS}
                     for lane, r in runs.items()}}
    k = runs["cuda"]
    # K1 launches per GMRES iteration, everything included (primal and
    # tangent of each Jacobian action, the per-solve and per-step calls)
    rec["k1_launches_per_inner_iteration"] = (
        k["launches"]["stencil5_affine"] / sum(k["inner_iters"]))
    rec.update(extra)
    print(json.dumps(rec), flush=True)
    return rec


def config5_phase(device, smi):
    """BASELINE config 5 (``suite.config5_nls_newton_recycling``) on the
    kernel lane (``impl="cuda"``: K1 in ``F`` and in every Jacobian
    action's tangent) and the plain lane (``impl="torch"``).  K1's
    forward-mode rule first (:func:`config5_jvp_phase`).  At 96^2 config
    5 and 5a (``AutoRecyclingGmres``, the plain lane on the kernel lane's
    clock), each lane warm, then once counted: both converged in the JAX
    package's 5 Newton steps, inner iterations within 3 of the plain
    lane's, the launch identity (``1 + f_calls + jvp_calls`` K1
    launches, ``jvp_calls`` of them tangents, no other kernel; none on
    the plain lane), 5a's widths in ``C5_WIDTHS`` and equal on both
    lanes.  At ``C5_FULL`` and ``C5_MID``, fixed width 3: the same gates
    with Newton steps within 1 of the plain lane's and of the JAX
    package's, inner iterations within 3 where neither solve reaches the
    cap of 250; then ``C5_ROUNDS`` interleaved sequences per lane timed
    on ``serve_s`` and, at ``C5_FULL``, the device busy share of one
    profiled sequence per lane.  One JSON line per grid and config.
    Returns ``(jvp report, counted kernel-lane run at C5_FULL, lines)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    jvp = config5_jvp_phase(device)
    lines = []
    for tag, auto in (("5", False), ("5a", True)):
        jax_ref = C5_JAX["96 auto" if auto else 96]
        for lane in ("cuda", "torch"):
            _c5_run(C5_NX, lane, auto, device)  # warm
        clock = []
        runs = {"cuda": _c5_run(C5_NX, "cuda", auto, device, record=clock)}
        runs["torch"] = _c5_run(C5_NX, "torch", auto, device,
                                replay=clock if auto else None)
        _c5_check(tag, C5_NX, runs, jax_ref, exact_steps=True)
        lines.append(_c5_line(tag, C5_NX, runs, jax_ref, smi))
    full = None
    for nx in (C5_FULL, C5_MID):
        t0 = time.perf_counter()
        # the counted sequences are the first round of the timing
        serve = {"cuda": [], "torch": []}
        total = {"cuda": [], "torch": []}
        runs = {}
        for r in range(C5_ROUNDS):
            for lane in (("cuda", "torch") if r % 2 == 0
                         else ("torch", "cuda")):
                out = _c5_run(nx, lane, False, device)
                runs.setdefault(lane, out)
                serve[lane].append(out["serve_s"])
                total[lane].append(out["total_s"])
            if r == 0:
                _c5_check("5", nx, runs, C5_JAX[nx], exact_steps=False)
        timing = {lane: dict(serve_s=serve[lane], total_s=total[lane],
                             serve_median=statistics.median(serve[lane]),
                             total_median=statistics.median(total[lane]))
                  for lane in runs}
        if nx == C5_FULL:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _c5_run(nx, "cuda", False, device)
            busy = sum(e.time_range.elapsed_us()
                       for e in _device_events(prof)) / 1e6
            timing["cuda"]["busy_s"] = busy
            timing["cuda"]["busy_share_of_total"] = \
                busy / timing["cuda"]["total_median"]
            full = runs["cuda"]
        for lane, t in timing.items():
            print(f"timing config5 {nx}^2 lane={lane} serve_s median="
                  f"{t['serve_median']:.6f} all={t['serve_s']} total_s "
                  f"median={t['total_median']:.6f}"
                  + (f" busy {t['busy_s']:.6f} s = "
                     f"{100 * t['busy_share_of_total']:.1f}% of the total"
                     if "busy_s" in t else ""), flush=True)
        lines.append(_c5_line("5", nx, runs, C5_JAX[nx], smi, timing=timing,
                              phase_s=time.perf_counter() - t0))
    return jvp, full, lines


def level_ranking(report, ns_counts):
    """The stencil and prefix-sweep kernels of one north-star solve
    ranked by launches x (device time - bound), each stencil kernel at
    each V-cycle level with its own time: every kernel level runs the
    collapsed presmooth (K1), K2 and K3 once per V-cycle, the coarsest
    level K1's coarse form once, and K1's other launches are the
    operator's matvec at the finest level; K4-K6 at 13 rows.  Prints one
    JSON line and returns the entries."""
    nlev = len(KERNEL_LEVELS)
    vcycles = ns_counts["stencil5_jacobi2"] // nlev
    coarse = ns_counts["stencil5_coarse"]
    matvecs = ns_counts["stencil5_affine"] - nlev * vcycles - coarse
    if ns_counts["stencil5_resrestrict_rows"] != nlev * vcycles or \
            ns_counts["stencil5_jacobi2"] % nlev or matvecs < 0 or \
            coarse != vcycles:
        raise AssertionError(f"north-star launches {ns_counts} do not "
                             f"split over the {nlev} kernel levels and "
                             "one coarse form per V-cycle")
    uses = [("stencil5_affine", (NS_NX + 1, "cd matvec"), matvecs),
            ("stencil5_affine", "coarse", coarse)]
    for n in KERNEL_LEVELS:
        uses += [("stencil5_affine", (n + 1, "lap presmooth"), vcycles),
                 ("stencil5_jacobi2", (n + 1, "lap s=1.0"), vcycles),
                 ("stencil5_resrestrict_rows", (n + 1, "lap residual+rows"),
                  vcycles)]
    uses += [(k, NS_ROWS[0], ns_counts[k]) for k in _PREFIX_SWEEPS]
    out = []
    for name, key, launches in uses:
        if key == "coarse":
            t, at = report["coarse"]["times"][32, 128], "31^2 in 32x128 coarse"
        else:
            t = report[name]["times"][key]
            at = key if isinstance(key, int) else f"{key[0]}^2 {key[1]}"
        out.append({"name": name, "at": at, "launches": launches,
                    "ms": t["ms"], "bound_ms": t["bound_ms"],
                    "gap_ms": launches * (t["ms"] - t["bound_ms"])})
    out.sort(key=lambda e: -e["gap_ms"])
    print(json.dumps({"ranking_northstar_launches_x_gap": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# the one-reduce lane (the onereduce phase)
# ---------------------------------------------------------------------------

#: the north star's two one-reduce forms: (label, ortho, basis, precond)
OR_NORTHSTAR = (("cgs2_1r left", "cgs2_1r", "f32", "left"),
                ("bf16 x cgs2_1r right", "cgs2_1r", "bf16", "right"))
#: slope timing: the two fixed iteration counts and the repeats of each
OR_KS, OR_REPS = (20, 40), 3
#: the slope grids: onereduce_bench.py's 1023^2 (a float32 vector is 4.2
#: MB, inside the 50 MB L2: launches are timed) and the north star's
#: 4095^2 (67 MB: traffic shows)
OR_GRIDS = (NX, NS_NX)
#: deflation width of the deflated pairs
OR_DEFL = 4
#: the pairs onereduce_bench.py has and the port has: (name, solver,
#: classic scheme, one-reduce scheme, options); all on the unpadded
#: Poisson operator of onereduce_bench.py, Jacobi ``M`` where named
OR_PAIRS = (
    ("cg M", "cg", "classic", "1r", {"M": "jacobi"}),
    ("minres M", "minres", "classic", "1r", {"M": "jacobi"}),
    ("gmres", "gmres", "cgs2", "cgs2_1r", {}),
    ("gmres M", "gmres", "cgs2", "cgs2_1r", {"M": "jacobi"}),
    ("gmres bf16", "gmres", "cgs2", "cgs2_1r", {"basis_dtype": "bf16"}),
    ("deflated_gmres d=4", "deflated_gmres", "cgs2", "cgs2_1r", {}),
    ("deflated_cg d=4", "deflated_cg", "classic", "1r", {}),
)
#: the convergence check of each one-reduce lane at 1023^2: tolerance,
#: and the iterations it may take beyond its classic lane (cgs2_1r's lag
#: adds one)
OR_CHECK_TOL, OR_CHECK_SLACK = 1e-6, 3
#: the bfloat16 basis cannot reach 1e-6: its floor is eps(bf16) kappa
#: (bf16 rounding of the basis rows, whatever the system's dtype), so its
#: pair is checked at 1e-2
OR_CHECK_TOL_BF16 = 1e-2
#: the convergence check's preconditioner: the unpadded V-cycle (K1 at
#: every level) in place of none or Jacobi, so that each check runs tens
#: of iterations, not thousands
OR_CHECK_VCYCLE = dict(coarsest=31, coarse_sweeps=60)
#: the policy constants' measurements: the copy's size (1 GiB of float32)
#: and repeats, the all-reduces timed
OR_COPY_ELEMS, OR_COPY_REPS, OR_SYNC_CALLS = 2 ** 28, 20, 200


def policy_constants(device):
    """The ``"cuda"`` row of ``functional.policy``'s table, measured:
    ``HBM_BYTES_PER_S`` as a device copy of a 1 GiB float32 tensor (bytes
    read plus written over the median of 20 copies timed by CUDA events),
    ``SYNC_S`` as one NCCL all-reduce of a one-element tensor on a
    one-rank world plus the host read a solver loop makes per iteration
    (median of 200 synchronised calls, host clock): a one-card floor."""
    import socket

    import torch
    import torch.distributed as dist
    from krypy_tpu_torch import parallel

    x = torch.empty(OR_COPY_ELEMS, dtype=torch.float32, device=device)
    x.normal_()
    y = torch.empty_like(x)
    ms = _time_ms(lambda: y.copy_(x), samples=OR_COPY_REPS, per_sample=1)
    hbm = 2 * x.numel() * 4 / (ms / 1e3)
    del x, y
    torch.cuda.empty_cache()

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    parallel.init_distributed(f"tcp://localhost:{port}", 1, 0, "nccl",
                              timeout=MESH_DIST_TIMEOUT)
    try:
        mesh = parallel.make_mesh(device=device)
        t = torch.ones(1, device=device)
        times = []
        for _ in range(OR_SYNC_CALLS + 10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parallel.all_reduce_sum(t, mesh).item()
            times.append(time.perf_counter() - t0)
        sync = statistics.median(times[10:])
    finally:
        dist.destroy_process_group()
    parallel.reset_collective_counts()
    print(f"onereduce policy constants: HBM_BYTES_PER_S={hbm:.6e} "
          f"(copy of 1 GiB float32, median {ms:.6f} ms) SYNC_S={sync:.6e} "
          f"(NCCL all-reduce of one element on one rank + host read, "
          f"median of {OR_SYNC_CALLS}; a one-card floor)", flush=True)
    return {"HBM_BYTES_PER_S": hbm, "SYNC_S": sync, "copy_ms": ms}


def _ns_launch_identity(label, counts, info, lag):
    """The north star's launches against its GMRES iterations, LEFT
    preconditioned: every f32 operator application of a GMRES call (the
    initial residual, one per iteration and, for ``cgs2_1r``, the lag's
    one more, the explicit residual of its last iteration) comes with one
    V-cycle, its restart control (the true float32 residual) with none,
    and the call adds one V-cycle (``Ml b``).  So per call ``niter + 3 +
    lag`` K1 matvecs and as many V-cycles, each V-cycle one K2 and one K3
    per kernel level and one K1 per kernel level plus the coarse form."""
    nlev = len(KERNEL_LEVELS)
    calls = [n for cyc in info["gmres_niters"] for n in cyc]
    mv = sum(n + 3 + lag for n in calls)
    want = {"stencil5_affine": mv + (nlev + 1) * mv,
            "stencil5_jacobi2": nlev * mv,
            "stencil5_resrestrict_rows": nlev * mv,
            "stencil5_coarse": mv}
    got = {k: counts[k] for k in want}
    print(f"northstar {label}: GMRES calls {info['gmres_niters']} -> "
          f"{mv} float32 matvecs and V-cycles ({len(calls)} calls x (niter "
          f"+ 3 + {lag})); launches {got} against {want}", flush=True)
    if got != want:
        raise AssertionError(f"northstar {label}: launches {got} do not "
                             f"match the matvec identity {want}")


def _or_northstar(device):
    """(a) and (b): the north star at 4095^2 in its two one-reduce forms
    on the kernel and plain lanes, against the cgs2_fused kernel lane of
    the same run.  Every solve here runs without the refinement's hidden
    warm-up solve (the kernels are built).  Each lane's first solve is
    gated and timed; a
    kernel lane's second solve is counted, launch counts zeroed just
    before it and read just after (for bf16 x cgs2_1r under the profiler,
    which gives its busy share over the first solve's wall); the
    ``cgs2_fused`` and ``cgs2_1r`` kernel lanes are then timed over
    ``NS_ROUNDS`` interleaved solves, and cgs2_1r's busy share taken (its
    device seconds read both ways, raw events and event tree, as a check
    of ``_device_seconds``).
    The plain lanes (1.1 and 9 s a solve) are timed by their gated solve
    alone.  Returns ``(records, counts)``."""
    import torch
    from krypy_tpu_torch import kernels
    from krypy_tpu_torch.northstar import make_northstar

    nx = NS_NX
    b = torch.ones(nx * nx, dtype=torch.float64, device=device)
    lanes = {"cgs2_fused cuda": ("cuda", "cgs2_fused", "f32", "left")}
    for label, ortho, basis, precond in OR_NORTHSTAR:
        for impl in ("cuda", "torch"):
            lanes[f"{label} {impl}"] = (impl, ortho, basis, precond)
    runs, counts = {}, {}
    for lane, (impl, ortho, basis, precond) in lanes.items():
        t0 = time.perf_counter()
        solve, cd64 = make_northstar(nx, impl, ortho, device, basis=basis,
                                     precond=precond)
        # no hidden warm-up solve in this phase, on any call
        solve = functools.partial(solve, warm=False)
        t_made = time.perf_counter()
        kernels.reset_launch_counts()
        res, info = solve(b)
        first_wall, busy = info["wall_s"], None
        if impl == "cuda":
            # the counted solve follows the first launches
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            if basis == "bf16":
                res, info, busy = _profiled_solve(solve, b)
            else:
                res, info = solve(b)
        counts[lane] = kernels.launch_counts()
        rel = float(torch.linalg.vector_norm(b - cd64(res.x))
                    / torch.linalg.vector_norm(b))
        runs[lane] = dict(solve=solve, info=info, rel=rel, wall=first_wall,
                          busy=busy)
        print(f"northstar {lane}: cycles={info['cycles']} inner_iters="
              f"{info['inner_iters']} matvecs={info['matvecs']} gmres "
              f"{info['gmres_niters']} rel={rel:.3e} first solve's wall_s="
              f"{first_wall:.6f} (set-up {t_made - t0:.1f} s, lane "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        _check_solution(res.x, nx * nx, rel, res.resnorms.cpu().numpy())
        if impl == "torch" and any(counts[lane].values()):
            raise AssertionError(f"northstar {lane}: the plain lane "
                                 f"launched kernels {counts[lane]}")

    def per_cycle(lane):
        return [sum(n + 2 for n in cyc)
                for cyc in runs[lane]["info"]["gmres_niters"]]

    fused = per_cycle("cgs2_fused cuda")
    for label, ortho, basis, precond in OR_NORTHSTAR:
        c, t = per_cycle(f"{label} cuda"), per_cycle(f"{label} torch")
        # (a) both lanes against the cgs2_fused lane, (b) its lanes against
        # each other: equal cycles, inner iterations per cycle within 3
        for got, ref in ([(c, fused), (t, fused)] if basis == "f32"
                         else [(c, t)]):
            if len(got) != len(ref) or any(abs(p - q) > 3
                                           for p, q in zip(got, ref)):
                raise AssertionError(f"northstar {label}: inner iterations "
                                     f"per cycle {got} against {ref}")
        if precond == "left":
            _ns_launch_identity(label, counts[f"{label} cuda"],
                                runs[f"{label} cuda"]["info"],
                                lag=int(ortho == "cgs2_1r"))
        print(f"northstar {label}: inner iterations per cycle kernel lane "
              f"{c}, plain lane {t}, cgs2_fused kernel lane {fused}",
              flush=True)

    timed = ("cgs2_fused cuda", f"{OR_NORTHSTAR[0][0]} cuda")
    walls = {lane: [] for lane in timed}
    for k in range(NS_ROUNDS):
        for lane in (timed if k % 2 == 0 else timed[::-1]):
            walls[lane].append(runs[lane]["solve"](b)[1]["wall_s"])
    records = {}
    for lane, run in runs.items():
        info = run["info"]
        ts = walls.get(lane, [run["wall"]])
        med = statistics.median(ts)
        records[lane] = dict(
            median=med, min=min(ts), max=max(ts), solves=len(ts),
            cycles=info["cycles"], inner_iters=info["inner_iters"],
            matvecs=info["matvecs"], rel=run["rel"])
        busy = run["busy"]
        if lane == timed[1]:
            busy = _profiled_solve(run["solve"], b, check=True)[2]
        if busy is not None:
            print(f"busy northstar {lane}: device {busy:.6f} s per solve, "
                  f"{100 * busy / med:.1f}% of the median wall {med:.6f} s",
                  flush=True)
        if busy is not None:
            records[lane].update(busy_s=busy, busy_share=busy / med)
        print(f"timing northstar {lane}: wall_s median={med:.6f} "
              f"min={min(ts):.6f} max={max(ts):.6f} all={ts}", flush=True)
    return records, counts


def _device_seconds(prof):
    """The summed duration of a profile's device events (kernels and
    copies), read off the profiler's raw events: what ``_device_events``
    sums, without building the event tree, which takes tens of seconds
    for a solve of ~10^4 launches."""
    from torch.autograd import DeviceType

    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e9


def _profiled_solve(solve, b, check=False):
    """One solve under torch.profiler: ``(result, info, device seconds of
    its kernels and copies)``; with ``check`` also the same sum over
    ``_device_events``, printed beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res, info = solve(b)
        torch.cuda.synchronize()
    busy = _device_seconds(prof)
    if check:
        tree = sum(e.time_range.elapsed_us()
                   for e in _device_events(prof)) / 1e6
        print(f"device seconds of one solve: raw events {busy:.6f}, event "
              f"tree {tree:.6f}", flush=True)
    return res, info, busy


def _or_problem(nx, impl, device, seed=3):
    """onereduce_bench.py's problem: the unpadded Poisson operator (K1 on
    the kernel lane), its Jacobi preconditioner, a float32 right-hand side
    and a float32 ``(N, OR_DEFL)`` deflation basis, both drawn on the card
    from ``seed``."""
    import torch
    from krypy_tpu_torch import ops

    A = ops.poisson_2d(nx, impl=impl, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    b = torch.randn(nx * nx, generator=gen, device=device)
    U = torch.randn(OR_DEFL, nx * nx, generator=gen, device=device).T
    return A, ops.jacobi_preconditioner(A), b, U


def _or_solver(pair, scheme, A, Mj, U):
    """``solve(b, maxiter, tol, **extra) -> SolveResult`` of one lane of a
    pair (``scheme`` its classic or one-reduce scheme)."""
    import torch
    from krypy_tpu_torch import functional as F

    _, solver, _, _, opts = pair
    kw = {"ortho" if "gmres" in solver else "variant": scheme}
    if opts.get("M") == "jacobi":
        kw["M"] = Mj
    if opts.get("basis_dtype") == "bf16":
        kw["basis_dtype"] = torch.bfloat16
    fn = getattr(F, solver)
    if solver.startswith("deflated"):
        return lambda b, maxiter, tol, **extra: fn(
            A, b, U, maxiter=maxiter, tol=tol, **kw, **extra)
    return lambda b, maxiter, tol, **extra: fn(
        A, b, maxiter=maxiter, tol=tol, **kw, **extra)


def _or_slopes(device):
    """(c): every pair, both schemes, both lanes, both grids: the median
    of ``OR_REPS`` solves at tol 0 of each of ``OR_KS`` iterations, and
    the slope in us per iteration.  Returns ``{(grid, lane, pair,
    scheme): us}``."""
    import torch

    slopes = {}
    for nx in OR_GRIDS:
        for impl in ("cuda", "torch"):
            A, Mj, b, U = _or_problem(nx, impl, device)
            for pair in OR_PAIRS:
                for scheme in pair[2:4]:
                    solve = _or_solver(pair, scheme, A, Mj, U)
                    solve(b, OR_KS[0], 0.0)  # first launches
                    t = {}
                    for K in OR_KS:
                        ts = []
                        for _ in range(OR_REPS):
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            res = solve(b, K, 0.0)
                            torch.cuda.synchronize()
                            ts.append(time.perf_counter() - t0)
                            if int(res.niter) != K:
                                raise AssertionError(
                                    f"onereduce {pair[0]} {scheme}: "
                                    f"{int(res.niter)} iterations at tol 0,"
                                    f" maxiter {K}")
                        t[K] = statistics.median(ts)
                    us = 1e6 * (t[OR_KS[1]] - t[OR_KS[0]]) / (
                        OR_KS[1] - OR_KS[0])
                    slopes[nx, impl, pair[0], scheme] = us
                    print(f"onereduce slope {nx}^2 lane={impl} {pair[0]} "
                          f"{scheme}: {us:.2f} us/iteration (median s "
                          f"{t[OR_KS[0]]:.6f} at K={OR_KS[0]}, "
                          f"{t[OR_KS[1]]:.6f} at K={OR_KS[1]})", flush=True)
            del A, Mj, b, U
            torch.cuda.empty_cache()
    return slopes


def _or_checks(device):
    """(c)'s convergence gates at 1023^2, in float64 (the float32 floor of
    this operator is ~2e-5: the first float32 check, CG with the V-cycle,
    stalled there): each pair's one-reduce lane solves to
    ``OR_CHECK_TOL`` within ``OR_CHECK_SLACK`` iterations of its classic
    lane (one more for cgs2_1r's lag), and its final explicit relative
    residual, in the solver's own norm, is at most 10 x tol.  The
    operators are the kernel lane's, whose float64 legs run the plain
    versions.  Preconditioned
    by the unpadded V-cycle (``OR_CHECK_VCYCLE``): as ``M`` where the pair
    takes Jacobi ``M`` and for CG and MINRES, on the right for the
    bfloat16 pair (at ``OR_CHECK_TOL_BF16``), on the left otherwise;
    deflated CG orthonormalizes its basis in the Euclidean product, the
    V-cycle's inverse being out of reach."""
    import torch
    from krypy_tpu_torch import ops

    nx = NX
    A, Mj, b, U = _or_problem(nx, "cuda", device, seed=5)
    b, U = b.double(), U.double()
    A64 = ops.poisson_2d(nx, device=device)
    V = ops.multigrid_poisson_preconditioner(nx, impl="cuda", device=device,
                                             **OR_CHECK_VCYCLE)
    b64 = b
    out = {}
    for pair in OR_PAIRS:
        name, solver, classic, one, opts = pair
        tol = OR_CHECK_TOL_BF16 if "basis_dtype" in opts else OR_CHECK_TOL
        if "basis_dtype" in opts:
            extra = dict(Mr=V)
        elif solver == "deflated_cg":
            extra = dict(M=V, ip_defl=lambda x, y: torch.vdot(x, y))
        elif solver in ("cg", "minres") or "M" in opts:
            extra = dict(M=V)
        else:
            extra = dict(Ml=V)

        def norm(r):
            """The solver's norm of a residual: ``||Ml r||``, ``<r, M
            r>^(1/2)`` or ``||r||``."""
            if "Ml" in extra:
                return torch.linalg.vector_norm(V(r))
            if "M" in extra:
                return torch.sqrt(torch.dot(r, V(r)))
            return torch.linalg.vector_norm(r)

        runs = {}
        for scheme in (classic, one):
            solve = _or_solver(
                (name, solver, classic, one,
                 {k: v for k, v in opts.items() if k != "M"}),
                scheme, A, Mj, U)
            res = solve(b, 1000, tol, **extra)
            rel = float(norm(b64 - A64(res.x)) / norm(b64))
            runs[scheme] = (int(res.niter), int(res.status), rel)
        (n_c, s_c, rel_c), (n_1, s_1, rel_1) = runs[classic], runs[one]
        slack = OR_CHECK_SLACK + int(one == "cgs2_1r")
        print(f"onereduce check {name} at {nx}^2, tol {tol:g}, "
              f"{sorted(extra)}: {classic} {n_c} iterations status {s_c} "
              f"explicit {rel_c:.3e}; {one} {n_1} iterations status {s_1} "
              f"explicit {rel_1:.3e}", flush=True)
        if s_1 != 0 or abs(n_1 - n_c) > slack or not rel_1 <= 10 * tol:
            raise AssertionError(
                f"onereduce check {name}: {one} {n_1} iterations, status "
                f"{s_1}, explicit {rel_1:.3e}, against {classic} {n_c} "
                f"(slack {slack}, explicit limit {10 * tol:g})")
        out[name] = runs
    return out


def _extra_sweeps(slopes, hbm):
    """The H100's extra-sweep ratios of the one-reduce rearrangements:
    (one-reduce - classic us per iteration) over one vector sweep's time
    at 4095^2 on the kernel lane, for the entries of
    ``policy.ONE_REDUCE_EXTRA_SWEEPS`` that a pair measures."""
    from krypy_tpu_torch.functional import policy

    sweep_us = 1e6 * NS_NX ** 2 * 4 / hbm
    out = {}
    for key, pair in (("cg", "cg M"), ("minres", "minres M"),
                      ("deflated_cg", "deflated_cg d=4")):
        one = slopes[NS_NX, "cuda", pair, "1r"]
        classic = slopes[NS_NX, "cuda", pair, "classic"]
        out[key] = dict(h100=(one - classic) / sweep_us,
                        jax=policy.ONE_REDUCE_EXTRA_SWEEPS[key])
    print(f"onereduce extra sweeps at {NS_NX}^2 (one sweep "
          f"{sweep_us:.2f} us): {out}", flush=True)
    return out


def onereduce_phase(device):
    """The one-reduce lane (``--only onereduce``): the policy constants,
    (a) and (b) the north star in its cgs2_1r and bfloat16 x cgs2_1r
    forms, (c) the slope timing of the pairs and their convergence
    gates.  (d), the one-reduce solves on the mesh, runs in the mesh
    phase.  Prints one JSON line and returns it."""
    t0 = time.perf_counter()
    parts = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        print(f"onereduce {name}: {parts[name]:.1f} s", flush=True)
        return out

    const = part("policy", policy_constants, device)
    ns, ns_counts = part("northstar", _or_northstar, device)
    checks = part("checks", _or_checks, device)
    slopes = part("slopes", _or_slopes, device)
    ratios = _extra_sweeps(slopes, const["HBM_BYTES_PER_S"])
    record = {"onereduce": {
        "policy": const, "northstar": ns, "northstar_launches": ns_counts,
        "checks": {k: {s: list(v) for s, v in r.items()}
                   for k, r in checks.items()},
        "slopes_us": {f"{g}^2 {lane} {p} {s}": us
                      for (g, lane, p, s), us in slopes.items()},
        "extra_sweeps": ratios, "part_s": parts,
        "phase_s": time.perf_counter() - t0}}
    print(json.dumps(record), flush=True)
    return record["onereduce"]


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
    # along V itself, as config 4 runs it (no M)
    "cgs_project": ("krypy_tpu/kernels/orthogonalize.py:429",
                    "orthogonalize.cu", (NS_ROWS[0], "V")),
}


#: the PyTorch call(s) timed as each kernel's ``library_ms``
LIBRARY = {
    "stencil5_affine": "torch.nn.functional.conv2d",
    "project_prefix": "torch.mv",
    "update_prefix": "torch.addmv",
    "cgs_project": "torch.mv then torch.addmv (two calls)",
}


#: the sharded kernels: the TPU function each replaces, the wrapper (K9's
#: composes K4-K6) and the CUDA source of the kernels it launches per shard
MESH_KERNELS = {
    "stencil5_sharded": ("krypy_tpu/kernels/stencil.py:561", "stencil.py",
                         "stencil5.cu", "k8"),
    "cgs2_fused_sharded": ("krypy_tpu/kernels/orthogonalize.py:355",
                           "orthogonalize.py", "orthogonalize.cu", "k9"),
}


def _mesh_rows(worlds, halo):
    """The K8 and K9 rows of the ``kernels`` line: launches summed over
    the main path of rank 0 of every world, the largest error of any
    rank, and rank 0's per-shard times in the widest world (the other
    worlds' beside them); K8's with its kernel alone (``halo``, the
    stencil phase's :func:`halo_check`)."""
    widest = worlds[MESH_WORLDS[-1]][0]
    rows = []
    for name, (src, py, cu, key) in MESH_KERNELS.items():
        t = widest["times"][name]
        k8 = key == "k8"
        rows.append({
            "name": name, "route": "cuda",
            # K8 is a kernel of its own (K1's tiles reading halo rows), K9
            # a composition in its wrapper
            "source": f"krypy_tpu_torch/kernels/{'csrc/' + cu if k8 else py}",
            "wrapper" if k8 else "kernel_source":
                f"krypy_tpu_torch/kernels/{py if k8 else 'csrc/' + cu}",
            "replaces": src,
            "launches": sum(s["launches"][name]
                            for ranks in worlds.values()
                            for s in ranks[0]["solves"].values()),
            "launches_of": "mesh phase main path, rank 0 of "
                           + ", ".join(f"{b} P={P}" for b, P in worlds),
            "max_abs_err": max(r[f"{key}_max_abs_err"]
                               for ranks in worlds.values() for r in ranks),
            "max_abs_err_of": "gathered, against the plain version in "
                              "float64, every rank of every world",
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "library": None, "timed_by": t["timed_by"],
            "per_shard_of": f"{MESH_WORLDS[-1][0]} P={MESH_WORLDS[-1][1]} "
                            "rank 0, all ranks on one card",
            "ms_by_world": {f"{b} P={P}": ranks[0]["times"][name]["ms"]
                            for (b, P), ranks in worlds.items()},
        })
        if k8:
            # every order and route, and the earlier composition timed in the
            # same run (the earlier design), on rank 0 of each world; the
            # gathered output against the single-device K1, bit for bit
            rows[-1]["kept"] = _k8_kept()
            rows[-1]["variants_by_world"] = {
                f"{b} P={P}": ranks[0]["k8_variants"]
                for (b, P), ranks in worlds.items()}
            rows[-1]["max_abs_err_kernel_alone"] = halo["max_abs_err"]
            rows[-1][f"kernel_alone_ms_{MESH_NX // 4}x{MESH_NX}"] = \
                halo["times"]
            rows[-1]["staging_ms"] = halo["staging"]
            rows[-1]["bitwise_k1_by_world"] = {
                f"{b} P={P}": {v: all(r["k8_bitwise"][v] for r in ranks)
                               for v in ranks[0]["k8_bitwise"]}
                for (b, P), ranks in worlds.items()}
        if key == "k9":
            # K4 + K5 + K6: the floor of the composition's three sweeps
            rows[-1]["three_sweep_floor_ms_by_world"] = {
                f"{b} P={P}": ranks[0]["times"][name]["three_sweep_floor_ms"]
                for (b, P), ranks in worlds.items()}
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one solve of each slice, writing "
                         "tables to DIR")
    ap.add_argument("--witness", action="store_true",
                    help="run ONLY the witnesses of config 4's float32 "
                         "findings (float64 inner arithmetic, the six "
                         "lane pairings); prints no result line")
    ap.add_argument("--mesh-faults", action="store_true",
                    help="run ONLY the mesh phase's solves with planted "
                         "faults, against its residual-history limits; "
                         "prints no result line")
    ap.add_argument("--only",
                    choices=("stencil", "ortho", "baseline", "kernels",
                             "config5", "mesh", "onereduce"),
                    help="run ONLY this phase (K1-K3 or K4-K6 against "
                         "their plain versions, and their times; the "
                         "baseline phase, unpadded K1 and configs 1-3; "
                         "the device times of K1's matvec, K4 and K7 by "
                         "phase; config 5 with K1's forward-mode "
                         "rule; the mesh phase; or the one-reduce lane: "
                         "the policy constants, the north star's "
                         "cgs2_1r forms, the pairs' slopes and checks); "
                         "a copy of this script in a checkout of another "
                         "commit times that commit's kernels the same "
                         "way; prints no result line")
    ap.add_argument("--mesh-rank", nargs=4,
                    metavar=("BACKEND", "P", "RANK", "DIR"),
                    help="run one rank of the mesh phase (the script starts "
                         "these processes itself)")
    ap.add_argument("--plant", choices=("none",) + MESH_FAULTS,
                    help="with --mesh-rank: the fault to plant")
    args = ap.parse_args(argv)
    if args.mesh_rank:
        mesh_rank(*args.mesh_rank, plant=args.plant)
        return

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
    if args.witness:
        witness_phase(device)
        baseline_witness(device)
        return
    if args.mesh_faults:
        mesh_fault_phase(device)
        return
    if args.only == "config5":
        config5_phase(device, smi)
        return
    if args.only:
        {"stencil": stencil_phase, "ortho": ortho_phase,
         "baseline": baseline_phase, "kernels": kernels_phase,
         "mesh": mesh_phase, "onereduce": onereduce_phase}[args.only](device)
        return
    report = stencil_phase(device)
    report["coarse"] = coarse_phase(device)
    laplacian_entry_phase(device)
    report.update(ortho_phase(device))
    report.update(project_phase(device))
    _, solves, b = solve_phase(device)
    timing_phase("poisson", solves, b, ROUNDS)
    ns_counts, ns_solves, ns_b = northstar_phase(device)
    timing_phase("northstar", ns_solves, ns_b, NS_ROUNDS)
    level_ranking(report, ns_counts)
    vcycle_host_phase(device)
    full_counts = config4_full_phase(device)
    c4_counts, c4_solves, c4_b, c4_record = config4_phase(device)
    walls = timing_phase("config4 deflated", c4_solves, c4_b, C4_ROUNDS)
    for lane, ts in walls.items():
        c4_record[lane]["deflated"][f"wall_s_of_{C4_ROUNDS}"] = dict(
            median=statistics.median(ts), min=min(ts), max=max(ts))
    print(json.dumps(c4_record), flush=True)
    rec_counts = recycling_phase(device, C4_FULL)
    # this slice's path on the kernel lane: config 4 at full size (the
    # harvest, the undeflated solve, four deflated cycles), its harvest
    # and deflated solve at the cut size, and the recycled sequence
    s3_counts = {k: full_counts[k] + c + rec_counts[k]
                 for k, c in c4_counts.items()}
    s3_path = f"config4@{C4_FULL}+config4@{C4_NX}+recycling@{C4_FULL}"
    bl_report, c2_counts, c3_counts, c2_rec, c3_rec = baseline_phase(device)
    c5_jvp, c5_full, _ = config5_phase(device, smi)
    onered = onereduce_phase(device)
    worlds = mesh_phase(device)
    if args.profile:
        _profile_solve("poisson", solves["cuda"], b, args.profile)
        _profile_solve("northstar", ns_solves["cuda"], ns_b, args.profile)
        _profile_solve("config4_deflated", c4_solves["cuda"], c4_b,
                       args.profile)
        _profile_deflation(device, C4_NX)

    rows = []
    for name, (src, cu, key) in KERNELS.items():
        t = report[name]["times"][key]
        own = name == "cgs_project"
        rows.append({
            "name": name, "route": "cuda",
            "source": f"krypy_tpu_torch/kernels/csrc/{cu}",
            "replaces": src,
            # the count of the path that runs the kernel: K1-K6 one
            # north-star solve, K7 this slice's path
            "launches": (s3_counts if own else ns_counts)[name],
            "launches_of": s3_path if own else f"northstar@{NS_NX}",
            "launches_" + s3_path: s3_counts[name],
            "max_abs_err": report[name]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": LIBRARY.get(name),
            # "profiler": device time; "events": wall time of back-to-back
            # calls, taken where the profiler recorded no device events
            "timed_by": t["timed_by"],
        })
        keep = ("ms", "plain_ms", "bound_ms", "library_ms")
        if cu == "stencil5.cu":
            # the same use at every kernel level of the V-cycle
            rows[-1]["ms_by_buffer"] = {
                f"{R}^2": {k: v[k] for k in keep}
                for (R, use), v in report[name]["times"].items()
                if use == key[1]}
        elif own:
            # both prefixes, along V and along a second basis, beside
            # what a design that sweeps twice must move
            rows[-1]["two_sweep_floor_ms"] = t["two_sweep_floor_ms"]
            rows[-1]["ms_by_rows_and_basis"] = {
                f"{r} rows along {b}": {
                    k: v[k] for k in keep + ("two_sweep_floor_ms",)}
                for (r, b), v in report[name]["times"].items()}
        else:
            rows[-1]["ms_by_rows"] = {
                f"{r} rows": {k: v[k] for k in keep}
                for r, v in report[name]["times"].items()}
        if name == "stencil5_affine":
            # the unpadded odd-width grids of configs 2 and 3's V-cycle
            rows[-1]["max_abs_err_unpadded"] = bl_report["max_abs_err"]
            rows[-1]["ms_by_unpadded_grid"] = {
                f"{n}^2 {kind}": {k: v[k] for k in keep}
                for (n, kind), v in bl_report["times"].items()}
            # the coarse form: the coarsest level's 60 sweeps in one
            # launch, beside the per-sweep K1 launches it replaces
            co = report["coarse"]
            rows[-1]["max_abs_err_coarse"] = co["max_abs_err"]
            rows[-1]["coarse_form"] = {
                f"{R}x{P}": {k: v[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "per_sweep_k1_ms", "call_ms", "per_sweep_k1_call_ms",
                    "sweeps", "timed_by")}
                for (R, P), v in co["times"].items()}
            rows[-1]["coarse_launches"] = {
                f"northstar@{NS_NX}": ns_counts["stencil5_coarse"],
                f"config2@{BL_NX}": c2_counts.get("stencil5_coarse", 0),
                f"config3@{BL_NX}": c3_counts["stencil5_coarse"]}
        elif own:
            # config 3's use: along the dual basis P of a 31-row basis of
            # 4095^2
            c3 = bl_report["cgs_project"]
            rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"],
                                          c3["max_abs_err"])
            rows[-1][f"ms_by_rows_config3@{BL_NX}"] = {
                f"{r} of {C3_PROJECT_M} rows along P, N = {BL_NX}^2 + "
                f"{extra}": {k: v[k] for k in keep + ("two_sweep_floor_ms",)}
                for (extra, r), v in c3["times"].items()}
        if name in ("stencil5_affine", "cgs_project"):
            rows[-1][f"launches_config2@{BL_NX}"] = c2_counts.get(name, 0)
            rows[-1][f"launches_config3@{BL_NX}"] = c3_counts[name]
        if name == "stencil5_affine":
            rows[-1][f"launches_config5@{C5_FULL}"] = \
                c5_full["launches"]["stencil5_affine"]
        # the north star's one-reduce forms on the kernel lane
        for label, *_ in OR_NORTHSTAR:
            rows[-1][f"launches_northstar {label}@{NS_NX}"] = \
                onered["northstar_launches"][f"{label} cuda"][name]
    # K1's forward-mode rule: the tangent's launch of config 5's
    # Jacobian actions, timed as the jvp of the matvec at config 5's grid
    t = c5_jvp["times"][C5_FULL, C5_FULL]
    rows.append({
        "name": "stencil5_affine_jvp", "route": "cuda",
        "source": "krypy_tpu_torch/kernels/csrc/stencil5.cu",
        "wrapper": "krypy_tpu_torch/kernels/stencil.py (_Affine.jvp)",
        "replaces": "krypy_tpu/kernels/stencil.py:137 (its forward-mode "
                    "derivative, jax.jvp of the nls residual)",
        "launches": c5_full["tangent_launches"],
        "launches_of": f"config5@{C5_FULL}",
        "max_abs_err": c5_jvp["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": "torch.nn.functional.conv2d on the pair (x, v)",
        "timed_by": t["timed_by"], "forward_ms": t["forward_ms"],
        "host_ms": t["host_ms"], "forward_host_ms": t["forward_host_ms"],
        "ms_by_grid": {f"{nx}x{ny}": v
                       for (nx, ny), v in c5_jvp["times"].items()},
    })
    rows += _mesh_rows(worlds, report["stencil5_halo"])
    print(json.dumps({"walls_s": {
        label: record[label] for record in (c2_rec, c3_rec)
        for label in record if str(label).startswith("config")}}),
        flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
