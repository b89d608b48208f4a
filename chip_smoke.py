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
                           --funm-faults | --sstep-faults |
                           --only {stencil,ortho,baseline,kernels,config5,
                                  mesh,onereduce,compat,recycle,
                                  nonsym,eigen,lsq,shifted,funm,sstep}]

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
11c. the compat phase (``--only compat``), KryPy's own API
   (``linsys``, ``deflation``, the one-call functions) on the card: (a)
   ``cg``/``minres``/``gmres`` on the README system from numpy, plain
   and deflated with ``U = e_1``, against BASELINE.md rows 3-6 to 1e-11,
   the solution a CUDA tensor of ``b``'s shape; (b) config 2 at 4095^2
   in float32, ``linsys.Cg`` and ``linsys.Minres`` on ``LinearSystem(A,
   b, M=M, ip_B=W)`` (``W`` the weights as a DiagonalLinearOperator,
   tol 1e-4, maxiter 200): iterations within 3 of the functional inner
   solve, the residual recomputed in float64 in the solve's own norm
   within 10 x tol, a CG run with ``explicit_residual=True`` whose
   history agrees with the updated one (1e-3 relative on the entries at
   or above 10 x tol), and the operation-count identity: the
   applications of A and M equal ``operations(k)``'s and K1's launches
   are the float32 applications of A plus those of M times one
   V-cycle's (measured alone; the iterate and the explicit residual are
   float64 as in the JAX lane and take the plain stencil); (c) config 3 at
   4095^2, ``RestartedGmres(GMRES(30), 10 restarts, tol 1e-4)`` with
   ``Ml``, ``M``, ``Mr``: iterations within 3 and the cycles of the
   functional ``restarted_gmres`` (``cgs2_pallas``), the recomputed
   residual, the applications of A and Ml against the model summed over
   the cycles (A once more per restart, for its initial residual), K1's
   launches from them, and the first cycle with ``store_arnoldi``
   (``dmgs``; ``mgs`` recorded) within 1e-4 in Arnoldi residual over
   ``||H||`` and orthonormality; bench.py's padded Poisson at 1023^2
   through ``linsys.Cg`` (tol 1e-4, bench.py's inner tolerance):
   iterations within 1 of the functional ``cg``, K1-K3 and the coarse
   form launched (at tol 1e-5 both counts recorded); (d)
   convection-diffusion at 1023^2 with the V-cycle as ``Ml``:
   ``DeflatedGmres`` (``dmgs``, ``store_arnoldi``), ``Ritz(mode=
   "harmonic")``'s four values smallest in magnitude with their Gram
   residual norms against ``get_explicit_resnorms`` (1e-3 relative), the
   deflated solve with their vectors taking no more iterations; each
   timed beside the functional lane (3 interleaved solves, host wall,
   the busy share of one profiled solve); one JSON line;
11d. the recycle phase (``--only recycle``), KryPy's recycling lane
   (``recycling``, ``deflation.Arnoldifyer`` and ``bound_pseudo``,
   ``pseudospectra``, ``checkpoint``) on the card: (a)
   tests/test_recycling.py's battery from numpy (``RecyclingCg``,
   ``RecyclingMinres``, ``RecyclingGmres`` with each of
   ``RitzFactorySimple``'s seven criteria, three solves each on the
   planted-outlier diagonal, N = 100; the two string shortcuts; a
   ``UnionFactory``): every recomputed final residual finite and at most
   tol, no later solve longer than the first, the iterations per solve
   within 1 of the port's CPU run of the same sequence (which prices on
   the card's clock); tests/test_aux.py:228's non-normal ``bound_pseudo``
   (``NonnormalAuto``'s batched SVD on the card) within 1e-6 relative of
   the CPU's; (b) config 5 (``suite.config5_problem``, K1 in F and its
   tangent) driven by ``functional.newton_krylov`` through an adapter
   (``_CompatNewtonSolver``) whose every Jacobian solve is
   ``LinearSystem(J, b, self_adjoint=True)`` solved by one
   ``recycling.RecyclingGmres(RitzFactorySimple(3, "sm"))``, at 511^2
   and 1023^2 (the default run: 127^2 alone, ``RC_C5_WHOLE_GRIDS``, the
   room the eigen, lsq and shifted phases take, so the ``kernels`` line
   has the keys ``launches_recycle config5 compat@127`` and
   ``launches_recycle config5 compat recycle_capped@127``), each
   sequence run to the functional
   kernel lane's Newton
   steps + 1 (``suite.config5_nls_newton_recycling``; at 1023^2 the
   config-5 phase's counted sequence in the default run), under the
   reference's capped-solve rule (a solve that raises
   ``ConvergenceError`` at its cap of 250 gives newton its iterate and
   does not become ``last_solver``) and under the functional lane's
   (``recycle_capped``: it does): every residual finite, each solve
   recycling from the last solve the rule kept, inner iterations within
   3 where neither solve reaches the cap (under the functional lane's
   rule while both lanes' ``||F||`` entering the solve agree within 1%),
   K1 launched ``1 +`` float32
   calls of F ``+`` float32 Jacobian actions (float64 ones, the deflated
   solves' float64 Krylov vectors among them, take the plain stencil),
   Newton converged within 1 of the functional lane's steps (a sequence
   under the reference's rule that a capped solve held back is recorded
   as ``held_back``: ROADMAP.md queue C), and the first deflated solve
   against the functional lane on the same float64 J, b and U
   (``functional.deflated_gmres``: residual histories within 1e-6; the
   basis's Rayleigh quotients nearest to the Ritz values that
   ``functional.ritz_pairs`` selects from the same Arnoldi relation);
   at the first grid ``RC_C5_ROUNDS`` interleaved sequences per lane
   timed (``serve_s``, also per Newton step and per inner iteration), at
   the last grid the busy share of a profiled compat sequence of 2 Newton
   steps; at the first grid also
   ``RecyclingGmres("RitzApproxKrylov")`` and
   ``RecyclingMinres("RitzAprioriMinres")`` (its first deflated solve
   against ``functional.deflated_minres``) under the same gates but the
   inner one and the Ritz values', widths and
   ``timings["vector_factory"]`` recorded (host LAPACK on one thread:
   ``OPENBLAS_NUM_THREADS=1``, set before numpy loads);
   (c) ``checkpoint.CheckpointedRecycling`` over config 4's four shifted
   Laplacians at 1023^2 on the kernel lane (K1-K3, K7), saved after the
   second solve and finished by a fresh object from the directory
   (under ``build/``, removed after): the reloaded basis bit for bit the
   saved one and on the card, the iterations those of the uninterrupted
   ``suite.recycling_sequence``; one JSON line;
11e. the nonsym phase (``--only nonsym``): the north star's system at
   4095^2 through the nonsymmetric short recurrences
   (``northstar.make_nonsym``: bicgstab, tfqmr, idrs(4) classic and
   "1r", fgmres(30) with cgs2, qmr classic and "1r" with ``AT=`` K1 on
   the swapped coefficients and ``MT = M``; float32 inner solves to
   1e-3, up to 2 per cycle, the padded V-cycle on the right, float64
   refinement to 1e-8) on both lanes: the residual, equal refinement
   cycles, inner iterations within 3 in every cycle whose float32 solve
   converged on both lanes (and each "1r" form against its classic form),
   K1-K3's launches against the applications of A, AT and M that each
   solver call's counts predict; AT against the plain operator's
   reverse-mode transpose at 1023^2; a flexible fgmres whose M alternates
   between the V-cycle and a 2-sweep Jacobi; ``NONSYM_ROUNDS`` (1)
   interleaved solve per lane and the kernel lane's busy share of the
   gated solve (the plain lane unprofiled); one JSON line;
11f. the eigen phase (``--only eigen``): the eigensolver lane, float64
   outer work over the float32 kernel lane (``krypy_tpu_torch.eigen``'s
   pipelines): (a) ``eigsh``, the 6 smallest pairs of bench.py's Poisson
   operator at 4095^2 by shift-invert block Lanczos (``sigma=0``,
   ``block_size=2``; ``inv`` float64 refinement to 1e-9 around the float32
   multigrid-CG: K1-K3 and the coarse form), gated on status, the closed
   form (both members of each degenerate pair; 1e-6 relative) and
   ``pair_resnorms``, then ``ortho="cgs2_1r"`` for the 2 smallest held to
   the classic form; (b) ``lobpcg`` with the V-cycle on ``x.float()``,
   held to the closed form and to (a) within 1e-8; (c) ``eigs``, the 4
   eigenvalues nearest 0 of the north star's operator (``inv`` the north
   star's refined GMRES, K1-K6, on the real and imaginary parts) against
   its closed form; each kernel-lane run's K1-K6 launches equal to the
   applications it counted; every run also at 1023^2 on both lanes
   (theta within 1e-8, counts within 1, LOBPCG's within its lanes' own
   spread under another float32 rounding of the V-cycle), (a)'s first sweep there profiled
   once for its busy share; (d) the filtered lane (``eigsh_window`` on
   the window holding lambda_22 and lambda_13 = lambda_31, ``window_count``
   and ``kpm_dos``) once at ``EIGEN_WINDOW_NX``^2 (float64: the plain
   stencil, no kernel; ``"reduced_from": 4095``); one JSON line;
11g. the lsq phase (``--only lsq``): the least-squares and randomized
   lane, float32 through K1 on the kernel lane and the plain stencil on
   the plain lane: ``lsqr`` and ``lsmr`` on the north star's operator at
   4095^2 with ``Ah = northstar.cd_transpose`` and damp 0.1, gated on
   the normal-equations residual recomputed in float64, LSMR's estimated
   ||A^T r|| never rising (read where the solver hands it to its stop
   tests) and the lanes' counts within 3; ``rsvd`` (k = 6) on bench.py's
   Poisson at 4095^2 by interlacing, its certified residuals recomputed
   in float64, and its lanes' values and left subspaces against each
   other; ``svds`` (k = 6) at 31^2 (``reduced_from``:
   LOBPCG's count grows ~3x per grid doubling on Poisson's clustered top)
   against the closed form of the largest eigenvalues; ``hutchpp`` within
   5 standard errors of the exact trace; ``nystrom_preconditioner`` held
   to its float64 build from the same sketch and as ``M`` of ``cg`` on
   Poisson + mu I beside plain CG; one JSON line;
11h. the shifted phase (``--only shifted``): ``arnoldi`` (20 steps) on the
   north star's operator with ``cgs2`` and ``cgs2_1r`` and ``lanczos`` on
   Poisson at 4095^2, gated on ||AV - VH|| / ||A|| and ||V^H V - I|| in
   float64; ``shifted_cg`` (classic, 1r) on Poisson with 8 shifts, and
   ``shifted_gmres``/``restarted_shifted_gmres`` on the north star's
   operator with real shifts, each member's true residual recomputed in
   float64; K1's launches counted per run on both phases' kernel lanes
   and listed on the ``kernels`` line; one JSON line;
11i. the funm phase (``--only funm``): float32 at 4095^2 on both lanes
   (the plain stencil on the plain lane), each run's applications of A
   and M counted and K1-K3's launches held to them: ``chebyshev`` with
   bench.py's padded V-cycle and ``spectral_bounds``; the Chebyshev
   preconditioner (degree 8) as CG's M at 1023^2 against plain CG;
   ``expm_multiply``, ``inv_sqrt_multiply`` and ``slq_logdet`` of
   Poisson against their DST closed forms; the Arnoldi
   ``expm_multiply`` on the north star's operator against its float64
   run; ``block_cg`` (four columns, backward errors, steps at or below
   the worst single column's) and ``block_gmres``; ``sketched_gmres``
   and its restarted driver on one shared sketch, ``sketched_eigs``
   (reported residuals against float64, values inside the closed-form
   spectrum); the lanes against each other; one JSON line.
   ``--funm-faults`` runs its kernel lane with each gate also read on a
   planted fault, which must fail it;
11j. the sstep phase (``--only sstep``): at 4095^2 on both lanes, float32
   inner solves and float64 refinement to 1e-8: ``ca_cg`` (s = 4, the
   padded V-cycle, one block a cycle) beside ``cg`` on bench.py's
   Poisson, their inner iterations in blocks apart, and ``ca_cg`` with
   bench.py's 12-iteration budget recorded; ``ca_gmres`` (monomial s = 4, Newton and
   Chebyshev s = 8) and ``restarted_ca_gmres`` on the north star's system,
   each basis' orthogonality; the GMRES-polynomial preconditioner (degree
   8) of the V-cycle-preconditioned north-star operator as Mr of GMRES
   and CA-GMRES beside the same solves without it, its roots against the
   float64 build; K1-K3 (and K4-K6) held to the counted applications;
   then the gallery: DIA at 4095^2 against K1 and scipy, CSR CG with block
   Jacobi and SPAI-preconditioned GMRES at 1023^2; one JSON line.
   ``--sstep-faults`` runs its kernel lane with each gate also read on a
   planted fault (the block solves by their diagonals, a Gram-Schmidt
   pass dropped, one refinement cycle short, the seed or degree not
   passed through, a diagonal's offset moved by one, blocks of one,
   Jacobi in SPAI's place), which must fail it;
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
   LSQR on the Poisson operator for 60 iterations and multi-shift CG with
   ``variant="auto"`` (8 shifts, 20 iterations; its pick against
   ``policy.prefer_one_reduce``) and with ``variant="1r"``, Chebyshev
   with Jacobi (ONE all-reduce per check block), block CG, a Lanczos
   ``expm_multiply`` (its correction tail the history) and sketched
   GMRES on a sketch every rank draws alike, ``ca_cg`` (3 all-reduces a
   block) and the Newton ``ca_gmres`` (5 + s a block), and CG on the
   DIA form (one periodic halo exchange an application) and the CSR form
   (one all-gather an application, block Jacobi) of scipy's Poisson at
   1024^2,
   launch and collective counts zeroed just before each and read just
   after.  Gated against
   one device: iteration and matvec counts equal, residual histories
   within ``MESH_RTOL`` and the same bits on every rank, K8 once per
   matvec, K9 once per GMRES iteration, three all-reduces per GMRES
   iteration, one halo exchange per matvec, the second recycled solve
   deflated.  Any rank's failure or the world's deadline fails the run.
   The times are per shard on ONE card: no multi-GPU speed-up;
13. output: a JSON line of configs 2 and 3's walls (and the compat
   phase's), a JSON line of
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

if __name__ == "__main__":
    # host LAPACK on one thread: the recycle phase's dense work (Ritz
    # values, the Arnoldifyer and bound_pseudo of every priced candidate)
    # is matrices of a few hundred rows, which OpenBLAS's thread pool runs
    # many times slower; OpenBLAS reads this when numpy loads
    os.environ["OPENBLAS_NUM_THREADS"] = "1"

import numpy as np

#: bench.py's grid: 1023^2 = 1,046,529 unknowns
NX = 1023
#: benchmarks/northstar.py's grid: 4095^2 = 16,769,025 unknowns
NS_NX = 4095
#: timed solves per lane in the Poisson timing phase
ROUNDS = 5
#: timed solves per lane in the north-star timing phase
NS_ROUNDS = 3
#: timed deflated solves per lane in the config-4 timing phase (one: the
#: whole script's time limit on a slow host; 3 until the nonsym phase
#: came)
C4_ROUNDS = 1
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
                    library_ms=lib_ms,
                    timed_by=dict(ms=ms_src, plain_ms=plain_src,
                                  library_ms=lib_src))
                lib_label = ("addmv+mv pair" if pair
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
#: 3.0e-7, CG 1.1e-5, recycling 2.0e-5, LSQR 5.1e-7 on the H100); the
#: faults that ``--mesh-faults`` plants (a zeroed halo, an unreduced inner
#: product) must land above them (LSQR 5.6e-4 and 2.0e-3).  The
#: multi-shift CG's final per-shift residuals: 4x above its largest sound
#: reading (1.2e-4, 4 ranks, both variants within it), 2x below its
#: halo fault's (1.04e-3; its unreduced product reads 0.79 and 2e5).
#: Chebyshev: 3e-6, 18x above its largest sound reading (1.7e-7 on 2
#: gloo ranks, 8.5e-8 on 4), 10x below its halo fault (3.2e-5; reduce
#: 1.4e-4); the Lanczos expm_multiply and sketched GMRES: 3e-5, 5x above
#: the expm's 4-rank reading (5.8e-6; 2 ranks 1.4e-7, sketched GMRES
#: 3.8e-7), 24x below their smallest fault reading (7.3e-4); block CG:
#: its float32 tail reads 1.3e-4 / 3.6e-4 sound on 2 / 4 ranks, its halo
#: fault 0.20 (its products are (k,)-vectors: the reduce fault, which
#: leaves 0-dim partials unreduced, does not reach it)
#: The s-step and gallery entries, on the H100 (sound on 2 / 4 gloo
#: ranks; halo and reduce faults on 2): the Newton ca_gmres 1.9e-4 /
#: 3.0e-5, 4.5e-3, inf; ca_cg at s = 2 3.3e-5 / 5.2e-5, 5.1e-3, 7.2e-4;
#: DIA CG 1.4e-6 / 8.8e-7, 6.2e-2, 9.0e-2 and CSR CG 2.2e-6 / 5.8e-7,
#: (no halo), 9.6e-2, CG's limit
MESH_RTOL = {"gmres": 3e-6, "cg": 2e-4, "recycling": 2e-4,
             "gmres_1r": 3e-6, "cg_1r": 2e-4, "gmres_auto": 3e-6,
             "lsqr": 5e-6, "shifted_cg_auto": 5e-4, "shifted_cg_1r": 5e-4,
             "chebyshev": 3e-6, "block_cg": 3e-3, "funm_krylov": 3e-5,
             "sketched_gmres": 3e-5, "ca_cg": 1e-3, "ca_gmres_newton": 1.5e-3,
             "dia_cg": 2e-4, "csr_cg": 2e-4}
#: the least-squares and multi-shift lane on the mesh: LSQR on the Poisson
#: operator (its own adjoint) for MESH_LSQ_ITERS iterations (tol below
#: reach, the stagnation window past them), and multi-shift CG with
#: ``variant="auto"`` for MESH_SHIFTED_ITERS iterations (no stagnation
#: window, short of the float32 floor, past which the members' residuals
#: are rounding: 100 iterations put them 1.0e-2 apart on 2 gloo ranks)
#: with 8 shifts lambda_max x 1e-2 ... 1e-1; their per-shift final
#: residuals are its "history".  All-reduces per solve of the multi-shift
#: CG beyond its per-iteration ones (classic 2, 1r 1): the global N, the
#: initial norm and rho, the final residuals, and 1r's initial delta
MESH_LSQ_ITERS, MESH_SHIFTED_ITERS = 60, 20
MESH_SHIFTS = tuple(8.0 * (MESH_NX + 1) ** 2 * np.geomspace(1e-2, 1e-1, 8))
MESH_SHIFTED_FIXED = {"classic": 4, "1r": 5}
#: all-reduces of the one-reduce solves on the mesh beyond one per
#: iteration: per GMRES cycle the global N, the two initial norms, the
#: peeled first product and the final explicit residual; per CG solve the
#: two initial norms, the initial delta and the final explicit residual
MESH_1R_FIXED = {"gmres_1r": 5, "cg_1r": 4,
                 "shifted_cg_1r": MESH_SHIFTED_FIXED["1r"]}
#: the Chebyshev, matrix-function, block and sketched lane on the mesh,
#: none reaching its tolerance: Chebyshev with Jacobi on Poisson (its
#: bounds the Jacobi-scaled spectrum's closed form) for MESH_CHEB_ITERS
#: steps, checking every MESH_CHEB_EVERY (the stagnation guard off), ONE
#: all-reduce per check plus the two initial norms; block CG (Jacobi,
#: B = [CG's b, ones]) for MESH_BLOCK_ITERS steps; exp(-t A) b of Poisson
#: by Lanczos (maxdim MESH_FUNM_DIM, t lambda_max = MESH_FUNM_TLAM: its
#: correction tail, the "history", sits near 1e-2, far above float32's
#: rounding); sketched GMRES (Jacobi as M) on the convection-diffusion
#: operator for MESH_SGM_ITERS iterations with a sketch every process
#: draws alike on cuda:0 from MESH_SKETCH_SEED
MESH_CHEB_ITERS, MESH_CHEB_EVERY = 128, 16
MESH_CHEB_FIXED = 2
MESH_BLOCK_ITERS = 30
MESH_FUNM_DIM, MESH_FUNM_TLAM = 20, 100.0
MESH_SGM_ITERS, MESH_SKETCH_SEED = 25, 17
#: the s-step lane and the unstructured gallery on the mesh: ca_cg (s = 2,
#: Jacobi) on Poisson for MESH_SS_CG_ITERS steps and ca_gmres (Newton,
#: s = 4, Jacobi on the left, its 8-step warm-up) on the
#: convection-diffusion operator for MESH_SS_GM_ITERS steps, none reaching
#: its tolerance (no stagnation window); CG for MESH_CG_ITERS iterations
#: on the float32 five-point Poisson at MESH_GAL_NX^2 from scipy, as a DIA
#: operator with Jacobi (one periodic halo exchange per application) and
#: as a CSR operator with block Jacobi (block MESH_GAL_BLOCK, rank-local:
#: one all-gather per application).  All-reduces per block (MESH_SS_BLOCK)
#: and per solve (MESH_SS_FIXED: the two initial norms and ca_cg's ten
#: power-iteration norms, ca_gmres's 24 in its warm-up).  ca_cg at s = 4
#: is no mesh check: its float32 monomial blocks are steered by rounding
#: (ROADMAP.md C), so that on 2 gloo ranks on the H100 the sound history
#: read 1.24e-2 against one device and the planted faults 1.07e-2 (halo)
#: and 1.17e-2 (reduce); at s = 2 sound 3.3e-5 and halo 5.1e-3
MESH_SS_S = {"ca_cg": 2, "ca_gmres_newton": 4}
MESH_SS_CG_ITERS, MESH_SS_GM_ITERS = 40, 24
MESH_SS_BLOCK = {"ca_cg": 3,
                 "ca_gmres_newton": 5 + MESH_SS_S["ca_gmres_newton"]}
MESH_SS_FIXED = {"ca_cg": 12, "ca_gmres_newton": 26}
MESH_GAL_NX, MESH_GAL_BLOCK = 1024, 32
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
        "lsqr": lambda: [F.lsqr(lap, b_cg, Ah=lap, tol=MESH_TOL,
                                maxiter=MESH_LSQ_ITERS,
                                stagnation_window=MESH_LSQ_ITERS + 1)],
        "shifted_cg_auto": lambda: [F.shifted_cg(
            lap, b_cg, MESH_SHIFTS, tol=MESH_TOL,
            maxiter=MESH_SHIFTED_ITERS, stagnation_window=0,
            variant="auto")],
        "shifted_cg_1r": lambda: [F.shifted_cg(
            lap, b_cg, MESH_SHIFTS, tol=MESH_TOL,
            maxiter=MESH_SHIFTED_ITERS, stagnation_window=0,
            variant="1r")],
    }
    # the Chebyshev, matrix-function, block and sketched lane
    h = 1.0 / (nx + 1)
    lam_max = 8.0 / h ** 2 * math.cos(math.pi * h / 2) ** 2
    cheb_bounds = (2 * math.sin(math.pi * h / 2) ** 2,
                   2 * math.cos(math.pi * h / 2) ** 2)
    sketch = F.kron_sketch(N, 8 * (MESH_SGM_ITERS + 1), seed=torch.Generator(
        device=device).manual_seed(MESH_SKETCH_SEED))
    # the s-step lane, and the gallery from scipy (its operators' mesh forms)
    gal = _ss_scipy("poisson", MESH_GAL_NX).astype(np.float32)
    gal_blk = slice(None) if mesh is None else parallel.block_of(
        MESH_GAL_NX ** 2, mesh)
    b_gal = torch.from_numpy(rhs[: MESH_GAL_NX ** 2][gal_blk]).to(device)
    applied = {"dia_cg": 0, "csr_cg": 0}

    def counted(op, key):
        def mv(x):
            applied[key] += 1
            return op(x)

        mv.shape, mv.diag = op.shape, op.diag
        return mv

    dia = ops.dia_from_scipy(gal, device=device, mesh=mesh)
    csr = ops.sparse_from_scipy(gal, device=device, mesh=mesh)
    runs.update({
        "ca_cg": lambda: [F.ca_cg(
            lap, b_cg, s=MESH_SS_S["ca_cg"],
            M=ops.jacobi_preconditioner(lap), tol=MESH_TOL,
            maxiter=MESH_SS_CG_ITERS, stagnation_window=0)],
        "ca_gmres_newton": lambda: [F.ca_gmres(
            cd, b, s=MESH_SS_S["ca_gmres_newton"], basis="newton", Ml=Ml,
            tol=MESH_TOL, maxiter=MESH_SS_GM_ITERS, stagnation_window=0)],
        "dia_cg": lambda: [F.cg(
            counted(dia, "dia_cg"), b_gal, M=ops.jacobi_preconditioner(dia),
            tol=MESH_TOL, maxiter=MESH_CG_ITERS)],
        "csr_cg": lambda: [F.cg(
            counted(csr, "csr_cg"), b_gal,
            M=ops.block_jacobi_preconditioner(csr, MESH_GAL_BLOCK,
                                              mesh=mesh),
            tol=MESH_TOL, maxiter=MESH_CG_ITERS)],
    })
    runs.update({
        "chebyshev": lambda: [F.chebyshev(
            lap, b_cg, M=ops.jacobi_preconditioner(lap),
            lmin=cheb_bounds[0], lmax=cheb_bounds[1], tol=MESH_TOL,
            maxiter=MESH_CHEB_ITERS, check_every=MESH_CHEB_EVERY,
            stagnation_window=0)],
        "block_cg": lambda: [F.block_cg(
            lap, torch.stack([b_cg, b], 1), M=ops.jacobi_preconditioner(lap),
            tol=MESH_TOL, maxiter=MESH_BLOCK_ITERS)],
        "funm_krylov": lambda: [F.expm_multiply(
            lap, b_cg, -MESH_FUNM_TLAM / lam_max, maxdim=MESH_FUNM_DIM)],
        "sketched_gmres": lambda: [F.sketched_gmres(
            cd, b, M=Ml, tol=MESH_TOL, maxiter=MESH_SGM_ITERS,
            sketch=sketch)],
    })
    out = {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        parallel.reset_collective_counts()
        results = run()
        torch.cuda.synchronize()
        hist = [_mesh_history(name, r) for r in results]
        out[name] = {
            "launches": kernels.launch_counts(),
            "collectives": parallel.collective_counts(),
            "resnorms": [h for h, _, _ in hist],
            "status": [st for _, st, _ in hist],
            "niter": [n for _, _, n in hist],
        }
    out["recycling"]["deflated_width"] = (
        None if rec._U is None else int(rec._U.shape[1]))
    for key, n in applied.items():
        out[key]["applications"] = n
    return out


def _mesh_history(name, r):
    """``(history, status, niter)`` of one mesh-phase result: the residual
    history (GMRES's whole buffer; Chebyshev's one entry per check block;
    block CG's columns, step after step; the matrix function's finite
    correction tail, its status 0 and its Krylov dimension)."""
    if name == "funm_krylov":
        c = r.corrections.tolist()
        return [v for v in c if math.isfinite(v)], 0, int(r.m)
    if name == "chebyshev":
        n = int(r.niter) // MESH_CHEB_EVERY + 1
    elif name in MESH_SS_S:
        n = int(r.niter) // MESH_SS_S[name] + 1
    elif name in ("gmres", "gmres_1r"):
        n = len(r.resnorms)
    else:
        n = int(r.niter) + 1
    return (r.resnorms[:n].reshape(-1).tolist(), r.status.tolist(),
            int(r.niter))


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
    leaves every 0-dim partial handed to ``mesh_sum`` (the inner product
    of two vectors, a norm) rank-local, while the row products and K9's
    sums stay reduced;
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
        # the DIA operator's periodic exchange (bound when it is built)
        from krypy_tpu_torch import parallel

        periodic = parallel.halo_exchange

        def zeroed_periodic(first, last, mesh=None, *args, **kw):
            rows = periodic(first, last, mesh, *args, **kw)
            if kw.get("periodic"):
                for t in rows:
                    t.zero_()
            return rows

        parallel.halo_exchange = zeroed_periodic
    elif fault == "reduce":
        mesh_sum = common.mesh_sum

        def local(t):
            return t if t.dim() == 0 else mesh_sum(t)

        # common's own helpers and every solver module that bound the name
        # at import (LSQR through _short, the multi-shift CG, ...)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith(
                    "krypy_tpu_torch.functional") and \
                    getattr(mod, "mesh_sum", None) is mesh_sum:
                mod.mesh_sum = local


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
            exchange, periodic = kst.halo_exchange, parallel.halo_exchange
            _plant("halo")
            try:
                yz = parallel.gather_vector(kst.stencil5_sharded(
                    x_loc, nx=nx, ny=nx, coeffs=co, mesh=mesh), mesh)
            finally:
                kst.halo_exchange = exchange
                parallel.halo_exchange = periodic
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
        # K8's library yardstick: one cuDNN convolution (TF32 off) of the
        # rank's block with its two halo rows, zero-padded in the columns
        torch.backends.cudnn.allow_tf32 = False
        halo_blk = torch.zeros(n_loc // nx + 2, nx, device=device)
        halo_blk[1:-1] = x_loc.view(-1, nx)
        cc, cu, cd, cl, cr = co
        wt = torch.tensor([[0.0, cu, 0.0], [cl, cc, cr], [0.0, cd, 0.0]],
                          device=device).view(1, 1, 3, 3)
        library = {"stencil5_sharded": lambda: torch.nn.functional.conv2d(
            halo_blk.view(1, 1, -1, nx), wt, padding=(0, 1))}
        for name, (kern, pl, b_ms, b_by) in timings.items():
            ms, src = _mesh_device_ms(kern, b_ms)
            plain_ms, plain_src = _mesh_device_ms(pl, b_ms)
            lib_ms, lib_src = (_mesh_device_ms(library[name], b_ms)
                               if name in library else (None, None))
            rec["times"][name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by, library_ms=lib_ms,
                                      timed_by=dict(ms=src,
                                                    plain_ms=plain_src,
                                                    library_ms=lib_src))
            print(f"{tag}: timing {name} per shard device_ms kernel={ms:.5f} "
                  f"({src}) plain={plain_ms:.5f} ({plain_src}) "
                  + ("" if lib_ms is None else
                     f"conv2d={lib_ms:.5f} ({lib_src}) ")
                  + f"bound={b_ms:.5f} ({b_by})", flush=True)
        del halo_blk
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
    # shifted_cg(variant="auto"): its pick read off its all-reduces, against
    # the price model (one rank: the classic recurrence)
    sh = r0["shifted_cg_auto"]
    n_sh = sh["niter"][0]
    picked_sh = {v: k for k, v in {
        "classic": 2 * n_sh + MESH_SHIFTED_FIXED["classic"],
        "1r": n_sh + MESH_SHIFTED_FIXED["1r"]}.items()}.get(
        sh["collectives"]["all_reduce_sum"])
    want_sh = "1r" if P > 1 and policy.prefer_one_reduce(
        "shifted_cg", MESH_NX ** 2 // P, 4, device=MESH_DEVICE) \
        else "classic"
    print(f"{tag} shifted_cg_auto: variant='auto' picked {picked_sh} "
          f"({sh['collectives']['all_reduce_sum']} all-reduces in {n_sh} "
          f"iterations); policy.prefer_one_reduce -> {want_sh}", flush=True)
    if picked_sh != want_sh:
        raise AssertionError(f"{tag} shifted_cg_auto: picked {picked_sh}, "
                             f"the price model says {want_sh}")
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
        if r0[name]["niter"] != one["niter"]:
            raise AssertionError(f"{tag} {name}: iterations "
                                 f"{r0[name]['niter']} against one device "
                                 f"{one['niter']}")
        rel = _history_rel(got, want)
        launches, coll = r0[name]["launches"], r0[name]["collectives"]
        matvecs = one["launches"]["stencil5_affine"]
        # (the recorded count where a history is not one entry per
        # iteration: per shift, per check block, per column, corrections)
        iters = sum(r0[name]["niter"]) if name.startswith("shifted") or \
            name in ("chebyshev", "block_cg", "funm_krylov") + tuple(
                MESH_SS_BLOCK) else \
            sum(len(h) - 1 for h in got)
        print(f"{tag} {name}: {iters} iterations, {matvecs} matvecs as on "
              f"one device; residual history max rel diff {rel:.3e} "
              f"(tolerance {MESH_RTOL[name]}); launches {launches}; "
              f"collectives {coll}", flush=True)
        if not rel <= MESH_RTOL[name]:
            raise AssertionError(f"{tag} {name}: residual histories differ "
                                 f"by {rel:.3e} > {MESH_RTOL[name]}")
        if name in ("dia_cg", "csr_cg"):
            # no stencil: the DIA operator's one periodic exchange, the CSR
            # operator's one all-gather per application, no other
            n_app = r0[name]["applications"]
            want = {"dia_cg": {"halo_exchange": n_app, "all_gather": 0},
                    "csr_cg": {"halo_exchange": 0, "all_gather": n_app}}[name]
            if n_app != one["applications"] or launches.get(
                    "stencil5_sharded", 0) or any(
                    coll[k] != v for k, v in want.items()):
                raise AssertionError(
                    f"{tag} {name}: {n_app} applications (one device "
                    f"{one['applications']}), collectives {coll}, K8 "
                    f"{launches.get('stencil5_sharded', 0)}: expected "
                    f"{want} and no K8")
        elif launches["stencil5_sharded"] != matvecs or \
                coll["halo_exchange"] != matvecs:
            raise AssertionError(f"{tag} {name}: {matvecs} matvecs on one "
                                 f"device, K8 {launches['stencil5_sharded']}"
                                 f" and {coll['halo_exchange']} exchanges")
        if name in MESH_SS_BLOCK:
            blocks = len(got[0]) - 1
            want_ar = MESH_SS_FIXED[name] + MESH_SS_BLOCK[name] * blocks
            if coll["all_reduce_sum"] != want_ar:
                raise AssertionError(
                    f"{tag} {name}: {coll['all_reduce_sum']} all-reduces in "
                    f"{blocks} blocks: expected {MESH_SS_BLOCK[name]} per "
                    f"block plus {MESH_SS_FIXED[name]}")
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
        if name == "chebyshev":
            blocks = len(got[0]) - 1
            if coll["all_reduce_sum"] != blocks + MESH_CHEB_FIXED:
                raise AssertionError(
                    f"{tag} chebyshev: {coll['all_reduce_sum']} all-reduces "
                    f"in {blocks} check blocks: expected ONE per block plus "
                    f"{MESH_CHEB_FIXED}")
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
        print(f"mesh one device {name}: iterations {r['niter']} launches "
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
#: one, which follows a warm-up solve; one, as ``C4_ROUNDS``)
BL_ROUNDS = 1
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
    busy = _device_seconds(prof)
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
#: timed Newton sequences per lane at each full-width grid (the counted
#: one: one round keeps the whole script within its time limit on a slow
#: host; 3 until the nonsym phase came)
C5_ROUNDS = 1
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
            busy = _device_seconds(prof)
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
#: the whole script's solves per slope point (``--only onereduce`` takes
#: ``OR_REPS``): ~27 s of the room the eigen phase takes
OR_WHOLE_REPS = 1
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


def _or_slopes(device, reps=OR_REPS):
    """(c): every pair, both schemes, both lanes, both grids: the median
    of ``reps`` solves at tol 0 of each of ``OR_KS`` iterations, and the
    slope in us per iteration.  Returns ``{(grid, lane, pair, scheme):
    us}``."""
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
                        for _ in range(reps):
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


def onereduce_phase(device, reps=OR_REPS):
    """The one-reduce lane (``--only onereduce``): the policy constants,
    (a) and (b) the north star in its cgs2_1r and bfloat16 x cgs2_1r
    forms, (c) the slope timing of the pairs (``reps`` solves per point;
    the whole script ``OR_WHOLE_REPS``) and their convergence gates.
    (d), the one-reduce solves on the mesh, runs in the mesh phase.
    Prints one JSON line and returns it."""
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
    slopes = part("slopes", _or_slopes, device, reps)
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


# ---------------------------------------------------------------------------
# the reference-compatible lane (linsys, deflation, the one-call functions)
# ---------------------------------------------------------------------------

#: BASELINE.md rows 3-5: Σ|x|, ||x||_2, max|x| of cg/gmres/minres on the
#: README system with a custom inner product (tests/test_convenience.py)
COMPAT_GOLDEN = {
    "cg": (1004.1873775173957, 1000.0003174916551, 999.9999999997555),
    "gmres": (1004.1873724888546, 1000.0003124630923, 999.999994971191),
    "minres": (1004.187372488912, 1000.0003124632159, 999.9999949713145),
}
#: BASELINE.md row 6: the same, deflated with U = e_1
COMPAT_GOLDEN_DEFLATED = {
    "cg": (1004.1873775173271, 1000.0003174918709, 1000.0),
    "minres": (1004.1873774950692, 1000.0003174918709, 1000.0),
    "gmres": (1004.1873774950692, 1000.0003174918709, 1000.0),
}
COMPAT_GOLDEN_RTOL = 1e-11
#: the float32 solves of configs 2 and 3: tolerance, budget, and how far
#: the compatibility lane's iterations may lie from the functional lane's
COMPAT_TOL = 1e-4
COMPAT_MAXITER = 200
COMPAT_ITER_SLACK = 3
#: the recomputed (float64) residual, in the solve's own norm, within
#: this many times the tolerance
COMPAT_TRUE_FACTOR = 10.0
#: explicit against updated residual norms: relative, on the entries at
#: or above ``COMPAT_EXPLICIT_FROM`` (ten times the tolerance); below it
#: the float32 recurrence meets the float32 floor of W^{-1} Lap at 4095^2
#: (ROADMAP.md queue C, config 2), and the gap is recorded
COMPAT_EXPLICIT_RTOL = 1e-3
COMPAT_EXPLICIT_FROM = 10 * COMPAT_TOL
#: config 3's first cycle with store_arnoldi: the Arnoldi residual over
#: ||H|| and ||I - <V, P>||
COMPAT_ARNOLDI_TOL = 1e-4
#: config 3's restart length and restarts
COMPAT_RESTART = 30
COMPAT_RESTARTS = 10
#: bench.py's padded Poisson through linsys.Cg: the gated tolerance
#: (bench.py's inner one), the iteration slack, and a tighter tolerance
#: recorded ungated: below the float32 floor the functional lane stops on
#: its float32 updated residual, which has left the true one, while the
#: compatibility lane re-seats its recurrence on the float64 explicit
#: residual and diverges to NaN, as the JAX package's lane does (ROADMAP.md
#: queue C)
COMPAT_POISSON_TOL = 1e-4
COMPAT_POISSON_SLACK = 1
COMPAT_POISSON_RECORDED_TOL = 1e-5
#: (d): the deflated GMRES and its Ritz vectors at 1023^2
COMPAT_DEFL_NX = NX
COMPAT_DEFL_TOL = 1e-5
COMPAT_DEFL_MAXITER = 60
COMPAT_DEFL_VECTORS = 4
COMPAT_RITZ_RTOL = 1e-3
#: interleaved timed solves per lane
COMPAT_ROUNDS = 3


def _counted(fn, counts, key):
    """``fn`` adding one to ``counts[key]`` per call (per vector), and to
    ``counts[key + "32"]`` where the vector is float32 (the Krylov
    vectors; the JAX lane's iterate and explicit residual are float64,
    whose applications take the plain stencil)."""
    import torch

    def call(x):
        counts[key] += 1
        counts[key + "32"] += x.dtype == torch.float32
        return fn(x)
    return call


def _synced_wall(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _compat_timing(label, lanes, record):
    """``COMPAT_ROUNDS`` solves per lane (host wall, synchronised),
    interleaved with the order alternating, then one profiled solve per
    lane for its device busy share; into ``record[label]``."""
    walls = {lane: [] for lane in lanes}
    for k in range(COMPAT_ROUNDS):
        for lane in (list(lanes) if k % 2 == 0 else list(reversed(lanes))):
            walls[lane].append(_synced_wall(lanes[lane])[1])
    rec = {}
    for lane, ts in walls.items():
        med = statistics.median(ts)
        busy = _busy_share(f"compat {label} lane={lane}",
                           lambda _b, f=lanes[lane]: f(), None, med)
        rec[lane] = {"median": med, "min": min(ts), "max": max(ts),
                     "all": ts, "busy_s": busy, "busy_share": busy / med}
        print(f"timing compat {label} lane={lane} wall_s median={med:.6f} "
              f"min={min(ts):.6f} max={max(ts):.6f} busy_share="
              f"{busy / med:.3f}", flush=True)
    record[label] = rec


def _functionals(x):
    x = x.detach().cpu().double().numpy().reshape(-1)
    return (float(np.sum(np.abs(x))), float(np.sqrt(np.dot(x, x))),
            float(np.max(np.abs(x))))


def _compat_goldens(device):
    """(a) the one-call functions on the README system, numpy in, on the
    card: the goldens of BASELINE.md rows 3-6 to ``COMPAT_GOLDEN_RTOL``."""
    import torch
    import krypy_tpu_torch as kt

    A = np.diag([1.0e-3] + list(range(2, 101)))
    b = np.ones(100)
    U = np.zeros(100)
    U[0] = 1.0
    out = {}
    for table, kw in ((COMPAT_GOLDEN, {"inner_product": torch.dot}),
                      (COMPAT_GOLDEN_DEFLATED, {"U": U})):
        for name, ref in table.items():
            sol, solver = getattr(kt, name)(A, b, **kw)
            if sol is None or not sol.is_cuda or tuple(sol.shape) != b.shape:
                raise AssertionError(f"compat golden {name}: solution "
                                     f"{None if sol is None else sol.shape}"
                                     f" on {getattr(sol, 'device', None)}")
            got = _functionals(sol)
            rel = max(abs(g - r) / r for g, r in zip(got, ref))
            tag = f"{name}{' deflated' if 'U' in kw else ''}"
            out[tag] = {"functionals": got, "max_rel": rel,
                        "iterations": len(solver.resnorms) - 1}
            print(f"compat golden {tag}: {got} max rel {rel:.3e}",
                  flush=True)
            if not rel <= COMPAT_GOLDEN_RTOL:
                raise AssertionError(f"compat golden {tag}: {got} against "
                                     f"{ref}, rel {rel:.3e}")
    return out


def _explicit_agrees(updated, explicit):
    """The relative gaps of the explicit history from the updated one;
    raises unless those of the entries at or above
    ``COMPAT_EXPLICIT_FROM`` are within ``COMPAT_EXPLICIT_RTOL`` and the
    lengths within one."""
    u, e = np.asarray(updated), np.asarray(explicit)
    n = min(len(u), len(e))
    rel = np.abs(u[:n] - e[:n]) / np.abs(e[:n])
    gated = u[:n] >= COMPAT_EXPLICIT_FROM
    worst = float(np.max(rel[gated])) if gated.any() else 0.0
    print(f"compat explicit residual: {len(e) - 1} iterations against "
          f"{len(u) - 1}, relative gaps {rel.tolist()}", flush=True)
    if abs(len(u) - len(e)) > 1 or worst > COMPAT_EXPLICIT_RTOL:
        raise AssertionError(
            f"compat explicit residual: {len(e) - 1} iterations against "
            f"{len(u) - 1}, relative gap {worst:.3e} at or above "
            f"{COMPAT_EXPLICIT_FROM} (gaps {rel.tolist()})")
    return {"rel_gaps": rel.tolist(), "max_rel_gated": worst,
            "iterations": [len(u) - 1, len(e) - 1]}


def _converged(what, resnorms, tol):
    """The last relative residual of a compatibility-lane solve is finite
    and at most ``tol`` (the lane's loop takes a NaN residual for
    convergence, ``nan > tol`` being False, in both packages)."""
    last = resnorms[-1]
    if not (math.isfinite(last) and last <= tol):
        raise AssertionError(f"compat {what}: final relative residual "
                             f"{last} against tol {tol}")


def _functional_iterations(res):
    """The iterations a functional solve took to the tolerance: the first
    step whose relative residual met it, else the step of the smallest
    residual (the best iterate, which CG's stagnation window returns
    after ``stagnation_window`` more steps; config 2's float32 inner
    solve at 4095^2 sits at its float32 floor above the tolerance)."""
    hist = res.resnorms[: int(res.niter) + 1].double().cpu().numpy()
    met = np.flatnonzero(hist <= COMPAT_TOL)
    return int(met[0]) if met.size else int(np.argmin(hist))


def _check_launch_identity(what, launches, counts, per_apply):
    """K1's launches: one per float32 application of the operator and
    ``per_apply[key]`` per float32 application of each preconditioner
    key."""
    want = counts["A32"] + sum(counts[k + "32"] * per
                               for k, per in per_apply.items())
    if launches["stencil5_affine"] != want:
        raise AssertionError(
            f"compat {what}: {launches['stencil5_affine']} K1 launches, "
            f"{counts} applications x {per_apply} per application give "
            f"{want}")


def _compat_config2(device, record):
    """(b) BASELINE config 2 through KryPy's API at 4095^2 in float32: CG
    and MINRES on ``LinearSystem(A, b, M=M, ip_B=W)`` with ``W`` the
    weights as a DiagonalLinearOperator; gated on the functional lane's
    inner solve, the true residual, the explicit residual (CG), and the
    operation-count identity with K1's launches."""
    import torch
    from krypy_tpu_torch import interop, kernels, linsys, suite, utils

    nx = BL_NX
    A, A64, M, _, b, solves = suite.make_config2(nx, "cuda", device)
    w = interop.from_numpy(suite.config2_weights(nx), device)
    W = utils.DiagonalLinearOperator(w)
    w64 = w.double()
    b32 = b.float()
    counts = dict.fromkeys(("A", "A32", "M", "M32"), 0)
    cA, cM = _counted(A, counts, "A"), _counted(M, counts, "M")

    def system(a=A, m=M):
        return linsys.LinearSystem(a, b32, M=m, ip_B=W, self_adjoint=True,
                                   positive_definite=True)

    # K1's launches per application of M (the V-cycle of w r), alone
    M(b32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    M(b32)
    torch.cuda.synchronize()
    per_vcycle = kernels.launch_counts()["stencil5_affine"]

    def prec_norm(r):
        return float(torch.sqrt(torch.vdot(r, w64 * M(r))))

    out, launches, lanes = {"per_vcycle": per_vcycle}, {}, {}
    for name, cls in (("cg", linsys.Cg), ("minres", linsys.Minres)):
        cls(system(), tol=COMPAT_TOL, maxiter=COMPAT_MAXITER)  # warm
        torch.cuda.synchronize()
        counts.update(dict.fromkeys(counts, 0))
        kernels.reset_launch_counts()
        sol = cls(system(cA, cM), tol=COMPAT_TOL, maxiter=COMPAT_MAXITER)
        torch.cuda.synchronize()
        used = kernels.launch_counts()
        k = len(sol.resnorms) - 1
        model = cls.operations(k)
        ref = solves[name].inner(b32)
        ref_k = _functional_iterations(ref)
        x = sol.xk[:, 0].double()
        r = b - A64(x)
        rel = prec_norm(r) / prec_norm(b)
        rel_w = float(torch.sqrt(torch.vdot(r, w64 * r))
                      / torch.sqrt(torch.vdot(b, w64 * b)))
        out[name] = {"iterations": k, "functional": ref_k,
                     "functional_niter": int(ref.niter),
                     "rel_M_W": rel, "rel_W": rel_w,
                     "resnorms": sol.resnorms, "applications": dict(counts),
                     "model": {key: model[key] for key in ("A", "M")},
                     "launches": {n: c for n, c in used.items() if c}}
        print(f"compat config2 {name}: {k} iterations (functional "
              f"{ref_k}; {int(ref.niter)} with its stagnation window), "
              f"rel {rel:.3e} in the M-norm of ip_B, "
              f"{rel_w:.3e} in ip_B, applications {counts}, model "
              f"{out[name]['model']}, launches {out[name]['launches']}",
              flush=True)
        _converged(f"config2 {name}", sol.resnorms, COMPAT_TOL)
        if abs(k - ref_k) > COMPAT_ITER_SLACK:
            raise AssertionError(f"compat config2 {name}: {k} iterations "
                                 f"against the functional {ref_k}")
        if not rel <= COMPAT_TRUE_FACTOR * COMPAT_TOL:
            raise AssertionError(f"compat config2 {name}: true residual "
                                 f"{rel:.3e}")
        if (counts["A"], counts["M"]) != (model["A"], model["M"]):
            raise AssertionError(f"compat config2 {name}: applications "
                                 f"{counts} against the model {model}")
        _check_launch_identity(f"config2 {name}", used, counts,
                               {"M": per_vcycle})
        launches[f"config2 {name}"] = used
        lanes[name] = {
            "compat": lambda cls=cls: cls(system(), tol=COMPAT_TOL,
                                          maxiter=COMPAT_MAXITER),
            "functional": lambda s=solves[name]: s.inner(b32)}
        if name == "cg":
            sole = cls(system(), tol=COMPAT_TOL, maxiter=COMPAT_MAXITER,
                       explicit_residual=True)
            out[name]["explicit"] = _explicit_agrees(sol.resnorms,
                                                     sole.resnorms)
    for name, lane in lanes.items():
        _compat_timing(f"config2 {name}@{nx}", lane, record["walls_s"])
    return out, launches


def _compat_config3(device, record):
    """(c) BASELINE config 3 through KryPy's API at 4095^2 in float32:
    ``RestartedGmres(GMRES(30), 10 restarts)`` on ``LinearSystem(cd, b,
    M=M, Ml=Ml, Mr=Mr)``, gated on the functional lane's restarted GMRES
    (its ``cgs2_pallas`` lane), the true residual, the first cycle's
    Arnoldi relation and the operation counts with K1's launches; then
    bench.py's padded Poisson at 1023^2 through ``linsys.Cg``."""
    import torch
    from krypy_tpu_torch import (functional as F, kernels, linsys, suite,
                                 utils)
    from krypy_tpu_torch.errors import ConvergenceError

    nx = BL_NX
    cd, Ml, M, Mr = suite.config3_pieces(nx, "cuda", device)
    b = torch.ones(nx * nx, dtype=torch.float64, device=device)
    b32 = b.float()
    counts = dict.fromkeys(("A", "A32", "Ml", "Ml32"), 0)
    cA, cMl = _counted(cd, counts, "A"), _counted(Ml, counts, "Ml")

    def system(a=cd, ml=Ml):
        return linsys.LinearSystem(a, b32, M=M, Ml=ml, Mr=Mr)

    def compat():
        return linsys.RestartedGmres(system(), maxiter=COMPAT_RESTART,
                                     max_restarts=COMPAT_RESTARTS,
                                     tol=COMPAT_TOL)

    def functional():
        return F.restarted_gmres(cd, b32, Ml=Ml, M=M, Mr=Mr, tol=COMPAT_TOL,
                                 maxiter=COMPAT_RESTART,
                                 max_restarts=COMPAT_RESTARTS, compiled=True,
                                 ortho="cgs2_pallas")

    Ml(b32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    Ml(b32)
    torch.cuda.synchronize()
    per_vcycle = kernels.launch_counts()["stencil5_affine"]

    compat()  # warm
    torch.cuda.synchronize()
    counts.update(dict.fromkeys(counts, 0))
    kernels.reset_launch_counts()
    sol = linsys.RestartedGmres(system(cA, cMl), maxiter=COMPAT_RESTART,
                                max_restarts=COMPAT_RESTARTS,
                                tol=COMPAT_TOL)
    torch.cuda.synchronize()
    used = kernels.launch_counts()
    K = len(sol.resnorms) - 1
    cycles = -(-K // COMPAT_RESTART)
    ref = functional()
    ref_cycles = -(-int(ref.niter) // COMPAT_RESTART)
    # the model per cycle, summed; each restart's initial residual b - A x0
    # is one application of A beyond it (the model counts one per solve)
    per_cycle = [COMPAT_RESTART] * (cycles - 1) + [K - COMPAT_RESTART
                                                   * (cycles - 1)]
    model = {key: sum(linsys.Gmres.operations(k)[key] for k in per_cycle)
             for key in ("A", "Ml")}
    want = {"A": model["A"] + cycles - 1, "Ml": model["Ml"]}
    x64 = sol.xk[:, 0].double()

    def prec_norm(r):
        Mlr = Ml(r)
        return float(torch.sqrt(torch.vdot(Mlr, M(Mlr))))

    rel = prec_norm(b - cd(x64)) / prec_norm(b)
    rel_raw = float(torch.linalg.vector_norm(b - cd(x64))
                    / torch.linalg.vector_norm(b))
    out = {"iterations": K, "cycles": cycles,
           "functional": int(ref.niter), "functional_cycles": ref_cycles,
           "rel_M": rel, "rel_unpreconditioned": rel_raw,
           "per_vcycle": per_vcycle, "applications": dict(counts),
           "model": model, "launches": {n: c for n, c in used.items() if c}}
    print(f"compat config3: {K} iterations in {cycles} cycles (functional "
          f"{int(ref.niter)} in {ref_cycles}), rel {rel:.3e} in the "
          f"M-norm of Ml r ({rel_raw:.3e} unpreconditioned), applications "
          f"{counts}, model {model}, launches {out['launches']}", flush=True)
    _converged("config3", sol.resnorms, COMPAT_TOL)
    if abs(K - int(ref.niter)) > COMPAT_ITER_SLACK or cycles != ref_cycles:
        raise AssertionError(f"compat config3: {K} iterations / {cycles} "
                             f"cycles against {int(ref.niter)} / "
                             f"{ref_cycles}")
    if not rel <= COMPAT_TRUE_FACTOR * COMPAT_TOL:
        raise AssertionError(f"compat config3: true residual {rel:.3e}")
    if (counts["A"], counts["Ml"]) != (want["A"], want["Ml"]):
        raise AssertionError(f"compat config3: applications {counts}, the "
                             f"model and restarts give {want}")
    _check_launch_identity("config3", used, counts, {"Ml": per_vcycle})

    # the first cycle with store_arnoldi: dmgs (in float32 single-pass MGS
    # loses orthogonality with the Krylov basis's condition), mgs recorded
    for ortho in ("dmgs", "mgs"):
        try:
            g = linsys.Gmres(system(), maxiter=COMPAT_RESTART,
                             tol=COMPAT_TOL, store_arnoldi=True, ortho=ortho)
        except ConvergenceError as exc:
            g = exc.solver
        ls = g.linear_system
        hnorm = float(np.linalg.norm(g.H, 2))
        res = float(utils.arnoldi_res(ls.M * ls.MlAMr, g.V, g.H)) / hnorm
        eye = torch.eye(g.V.shape[1], dtype=g.V.dtype, device=device)
        orth = float(utils.norm(eye - utils.inner(g.V, g.P)))
        out[f"arnoldi_{ortho}"] = {"rel_residual": res, "orthonormality":
                                   orth, "steps": g.H.shape[1]}
        print(f"compat config3 first cycle ortho={ortho}: ||M MlAMr V - V "
              f"H|| / ||H|| = {res:.3e}, ||I - <V, P>|| = {orth:.3e}",
              flush=True)
        if ortho == "dmgs" and not (res <= COMPAT_ARNOLDI_TOL
                                    and orth <= COMPAT_ARNOLDI_TOL):
            raise AssertionError(f"compat config3 Arnoldi relation: "
                                 f"{out[f'arnoldi_{ortho}']}")
    lanes = {"compat": compat, "functional": functional}
    _compat_timing(f"config3@{nx}", lanes, record["walls_s"])
    return out, used


def _compat_poisson(device):
    """bench.py's padded Poisson at 1023^2 (padded operator and V-cycle,
    float32) through ``linsys.Cg`` to ``COMPAT_POISSON_TOL``: the
    functional ``cg``'s iterations within ``COMPAT_POISSON_SLACK``, and
    K1 (with its coarse form), K2 and K3 launched; the same pair at
    ``COMPAT_POISSON_RECORDED_TOL``, recorded."""
    import torch
    from krypy_tpu_torch import functional as F, kernels, linsys, ops

    nx = NX
    lap32 = ops.poisson_2d(nx, pad_cols=True, impl="cuda", device=device)
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl="cuda",
        device=device)
    b = ops.pad_grid_vec(torch.ones(nx * nx, dtype=torch.float32,
                                    device=device), nx, nx)

    def compat(tol=COMPAT_POISSON_TOL):
        ls = linsys.LinearSystem(lap32, b, M=M, self_adjoint=True,
                                 positive_definite=True)
        return linsys.Cg(ls, tol=tol, maxiter=COMPAT_MAXITER)

    def functional(tol=COMPAT_POISSON_TOL):
        return F.cg(lap32, b, M=M, tol=tol, maxiter=COMPAT_MAXITER)

    compat()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    sol = compat()
    torch.cuda.synchronize()
    used = kernels.launch_counts()
    ref = functional()
    k = len(sol.resnorms) - 1
    tight = compat(COMPAT_POISSON_RECORDED_TOL)
    tight_ref = functional(COMPAT_POISSON_RECORDED_TOL)
    out = {"iterations": k, "functional": int(ref.niter),
           "launches": {n: c for n, c in used.items() if c},
           f"at tol {COMPAT_POISSON_RECORDED_TOL}": {
               "iterations": len(tight.resnorms) - 1,
               "functional": int(tight_ref.niter),
               "final": tight.resnorms[-1]}}
    print(f"compat poisson@{nx}: {k} iterations (functional "
          f"{int(ref.niter)}), launches {out['launches']}; at tol "
          f"{COMPAT_POISSON_RECORDED_TOL} {len(tight.resnorms) - 1} "
          f"(functional {int(tight_ref.niter)}), final relative residual "
          f"{tight.resnorms[-1]}", flush=True)
    _converged("poisson", sol.resnorms, COMPAT_POISSON_TOL)
    if abs(k - int(ref.niter)) > COMPAT_POISSON_SLACK:
        raise AssertionError(f"compat poisson: {k} iterations against "
                             f"{int(ref.niter)}")
    for name in ("stencil5_affine", "stencil5_jacobi2",
                 "stencil5_resrestrict_rows", "stencil5_coarse"):
        if used[name] <= 0:
            raise AssertionError(f"compat poisson: {name} never launched")
    return out, used, {"compat": compat, "functional": functional}


def _compat_deflation(device, record):
    """(d) convection-diffusion at ``COMPAT_DEFL_NX``^2, float32, ``Ml``
    the V-cycle: ``DeflatedGmres`` (``store_arnoldi``; ``dmgs``, since the
    Ritz data need an orthonormal float32 basis) with no U, the harmonic
    Ritz pairs of the ``COMPAT_DEFL_VECTORS`` values smallest in
    magnitude, their Gram residual norms against the explicit ones, then
    the deflated solve with their vectors: no more iterations."""
    import torch
    from krypy_tpu_torch import (deflation, functional as F, linsys,
                                 suite)
    from krypy_tpu_torch.errors import ConvergenceError

    nx = COMPAT_DEFL_NX
    cd, Ml, _, _ = suite.config3_pieces(nx, "cuda", device)
    b32 = torch.ones(nx * nx, dtype=torch.float32, device=device)
    ls = linsys.LinearSystem(cd, b32, Ml=Ml)

    def solve(U):
        try:
            return deflation.DeflatedGmres(
                ls, U=U, store_arnoldi=True, tol=COMPAT_DEFL_TOL,
                maxiter=COMPAT_DEFL_MAXITER, ortho="dmgs")
        except ConvergenceError as exc:
            return exc.solver

    first = solve(None)
    ritz = deflation.Ritz(first, mode="harmonic")
    idx = np.argsort(np.abs(ritz.values))[:COMPAT_DEFL_VECTORS]
    explicit = ritz.get_explicit_resnorms(idx)
    gram = ritz.resnorms[idx]
    rel = np.abs(gram - explicit) / explicit
    vecs = ritz.get_vectors(idx)
    imag = float(vecs.imag.abs().max() / vecs.real.abs().max()) \
        if vecs.is_complex() else 0.0
    U = vecs.real if vecs.is_complex() else vecs
    if imag > 1e-6:
        # a complex pair: its real and imaginary parts span it
        U = torch.cat([vecs.real, vecs.imag], dim=1)
    U = U.to(torch.float32).contiguous()
    second = solve(U)
    n1, n2 = len(first.resnorms) - 1, len(second.resnorms) - 1
    out = {"iterations": [n1, n2], "resnorms_final": [first.resnorms[-1],
                                                       second.resnorms[-1]],
           "ritz_values": [complex(v) for v in ritz.values[idx]],
           "ritz_resnorms": gram.tolist(), "explicit": explicit.tolist(),
           "rel": rel.tolist(), "imag_over_real": imag,
           "deflation_vectors": U.shape[1]}
    out["ritz_values"] = [[v.real, v.imag] for v in out["ritz_values"]]
    print(f"compat deflation@{nx}: {n1} then {n2} iterations with "
          f"{U.shape[1]} harmonic Ritz vectors; Ritz residual norms {gram} "
          f"against explicit {explicit} (rel {rel})", flush=True)
    for what, solver in (("first", first), ("deflated", second)):
        _converged(f"deflation {what}", solver.resnorms, COMPAT_DEFL_TOL)
    if n2 > n1:
        raise AssertionError(f"compat deflation: the deflated solve took "
                             f"{n2} iterations, the first {n1}")
    if not np.all(rel <= COMPAT_RITZ_RTOL):
        raise AssertionError(f"compat Ritz residual norms: rel {rel}")
    lanes = {
        "compat": lambda: solve(U),
        "functional": lambda: F.deflated_gmres(
            cd, b32, U, Ml=Ml, tol=COMPAT_DEFL_TOL,
            maxiter=COMPAT_DEFL_MAXITER, ortho="dmgs")}
    _compat_timing(f"deflation@{nx}", lanes, record["walls_s"])
    return out


def compat_phase(device):
    """The reference-compatible lane (``--only compat``): (a) the goldens,
    (b) config 2 and (c) config 3 through ``linsys`` at 4095^2 with the
    operation-count identity, bench.py's Poisson through ``linsys.Cg``,
    (d) deflation and Ritz at 1023^2; each timed beside the functional
    lane on the same pieces.  Prints one JSON line and returns it."""
    t0 = time.perf_counter()
    record = {"walls_s": {}}
    parts, failed = {}, []

    def part(name, fn, *args):
        """Run one part; a failed gate is recorded and raised after the
        other parts have run, with every part's failure."""
        t = time.perf_counter()
        try:
            res = fn(*args)
        except AssertionError as exc:
            failed.append(f"{name}: {exc}")
            res = None
        parts[name] = time.perf_counter() - t
        print(f"compat {name}: {parts[name]:.1f} s", flush=True)
        return res

    record["goldens"] = part("goldens", _compat_goldens, device)
    c2 = part("config2", _compat_config2, device, record)
    c3 = part("config3", _compat_config3, device, record)
    poisson = part("poisson", _compat_poisson, device)
    if poisson is not None:
        _compat_timing(f"poisson@{NX}", poisson[2], record["walls_s"])
    record["deflation"] = part("deflation", _compat_deflation, device,
                               record)
    record["part_s"] = parts
    record["phase_s"] = time.perf_counter() - t0
    record["failed"] = failed
    if not failed:
        record["config2"], record["config3"], record["poisson"] = \
            c2[0], c3[0], poisson[0]
        record["launches"] = {
            f"config2 cg@{BL_NX}": c2[1]["config2 cg"],
            f"config2 minres@{BL_NX}": c2[1]["config2 minres"],
            f"config3@{BL_NX}": c3[1], f"poisson@{NX}": poisson[1]}
    print(json.dumps({"compat": record}, default=str), flush=True)
    if failed:
        raise AssertionError("compat phase: " + "; ".join(failed))
    return record


# ---------------------------------------------------------------------------
# the recycle phase: KryPy's recycling lane (recycling, Arnoldifyer,
# bound_pseudo, pseudospectra, checkpoint) on the card
# ---------------------------------------------------------------------------

#: tests/test_recycling.py's battery: the planted-outlier diagonal, its
#: seven RitzFactorySimple criteria, three solves each
RC_N = 100
RC_OUTLIERS = (1e-8, 1e-4, 1e-2, 2e-2, 3e-2)
RC_WHICH = ("lm", "sm", "lr", "sr", "li", "si", "smallest_res")
RC_SOLVERS = ("RecyclingCg", "RecyclingMinres", "RecyclingGmres")
RC_PARAMS = {"maxiter": 50, "tol": 1e-5}
RC_SOLVES = 3
#: the card's iterations per solve against the port's CPU run of the same
#: sequence
RC_ITER_SLACK = 1
#: tests/test_aux.py:228's non-normal bound_pseudo case, card against CPU
RC_BOUND_RTOL = 1e-6
#: config 5 through recycling.RecyclingGmres: the grids, and the gates
#: against the functional kernel lane of the same run (Newton steps, and
#: inner iterations where neither solve reaches the cap).  Every sequence
#: runs at most the functional lane's Newton steps + RC_C5_NEWTON_SLACK,
#: the depth at which the Newton gate decides
RC_C5_GRIDS = (C5_MID, C5_FULL)
#: the whole script's grid (``--only recycle`` runs RC_C5_GRIDS; the
#: phase's JSON line says ``reduced_from``): at 511^2 the sequences' capped
#: solves of 250 iterations, each iteration reading every inner product,
#: took 177 s of a slow host's script, and at 255^2 RitzApproxKrylov
#: priced a 222-step Krylov space for 83 s on the card's host (PERF.md);
#: at 127^2 no solve reaches the cap (46-113 inner iterations per Newton
#: step), so every solve is compared
RC_C5_WHOLE_GRIDS = (127,)
RC_C5_NEWTON_SLACK = 1
RC_C5_INNER_SLACK = 3
#: under the functional lane's rule, inner iterations are compared where
#: the Newton residuals entering the solve agree this closely (relative):
#: the lanes then solve one system
RC_C5_SAME_SYSTEM_RTOL = 1e-2
#: interleaved sequences per lane timed at the first grid (one, as
#: ``C5_ROUNDS``: the whole script's time limit; 3 until the nonsym
#: phase came)
RC_C5_ROUNDS = 1
#: Newton steps of the profiled compatibility sequence at 1023^2
RC_C5_PROFILE_STEPS = 2
#: the first deflated solve of a sequence against the functional lane on
#: the same float64 J, b and U: the relative gap of the residual
#: histories (each unnormalised by its own right-hand side norm)
RC_C5_HISTORY_RTOL = 1e-6
#: checkpoint: config 4's four-system sequence on the kernel lane at this
#: size, saved after this many solves and finished by a fresh object
RC_CK_NX = NX
RC_CK_SAVED_AFTER = 2
RC_CK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_checkpoint")


def _rc_system(N, small, device):
    """``diag(small..., linspace(1, 2))`` from numpy, self-adjoint and
    positive definite, ``b = ones``; ``device=None`` puts it on the card
    as numpy inputs go."""
    from krypy_tpu_torch import linsys

    d = np.linspace(1, 2, N)
    d[:len(small)] = small
    return linsys.LinearSystem(np.diag(d), np.ones((N, 1)), normal=True,
                               self_adjoint=True, positive_definite=True,
                               device=device)


def _rc_sequence(solver, spec, N, small, params, n_solves, device,
                 clock=None, replay=None):
    """``n_solves`` solves of one system by ``recycling.<solver>`` with
    the vector factory ``spec()``; the card's run records each solve's
    timings in ``clock``, the CPU run reads them (``replay``) in place of
    its own before pricing, so that a factory that prices by the clock
    chooses on the same one.  Returns per-solve lists."""
    from krypy_tpu_torch import recycling, utils

    ls = _rc_system(N, small, device)
    rs = getattr(recycling, solver)(vector_factory=spec())
    out = {"iters": [], "final": [], "recomputed": [], "widths": [],
           "xk_device": []}
    for i in range(n_solves):
        if replay is not None and i > 0:
            timings = utils.Timings()
            for key, vals in replay[i - 1].items():
                timings[key].extend(vals)
            rs.last_solver.linear_system.timings = timings
        sol = rs.solve(ls, **params)
        if clock is not None:
            clock.append({k: list(v) for k, v in
                          sol.linear_system.timings.items()})
        _, _, rkn = ls.get_residual(sol.xk, compute_norm=True)
        out["iters"].append(len(sol.resnorms) - 1)
        out["final"].append(float(sol.resnorms[-1]))
        out["recomputed"].append(float(rkn) / float(ls.MMlb_norm))
        out["widths"].append(int(sol.projection.U.shape[1]))
        out["xk_device"].append(sol.xk.device.type)
    out["vector_factory_s"] = list(rs.timings["vector_factory"])
    out["solve_s"] = list(rs.timings["solve"])
    return out


def _rc_battery_cases():
    """``(label, solver, spec, N, outliers, params, solves)`` of the
    battery: the 21 RitzFactorySimple sequences, the two string
    shortcuts, the union of two factories."""
    from krypy_tpu_torch import recycling

    fac = recycling.factories
    cases = [(f"{s} {w}", s,
              functools.partial(fac.RitzFactorySimple, n_vectors=3, which=w),
              RC_N, RC_OUTLIERS, RC_PARAMS, RC_SOLVES)
             for s in RC_SOLVERS for w in RC_WHICH]
    for short in ("RitzApproxKrylov", "RitzAprioriCg"):
        cases.append((f"RecyclingCg {short}", "RecyclingCg",
                      lambda short=short: short, 50, (1e-4, 1e-2, 3e-2),
                      RC_PARAMS, 2))
    cases.append(("RecyclingMinres union(sm, lm)", "RecyclingMinres",
                  lambda: fac.UnionFactory([
                      fac.RitzFactorySimple(n_vectors=1, which="sm"),
                      fac.RitzFactorySimple(n_vectors=1, which="lm")]),
                  40, (1e-3,), {"tol": 1e-6}, 2))
    return cases


def _rc_bound_nonnormal(device):
    """tests/test_aux.py:228's non-normal ``bound_pseudo`` case: its
    ``NonnormalAuto`` grid's batched SVD runs on ``device``."""
    from krypy_tpu_torch import deflation, errors, linsys

    A = np.diag(np.linspace(1, 2, 16))
    A[0, -1] = 0.5
    ls = linsys.LinearSystem(A, np.ones((16, 1)), device=device)
    try:
        sol = deflation.DeflatedGmres(ls, tol=1e-10, maxiter=8,
                                      store_arnoldi=True)
    except errors.ConvergenceError as e:
        sol = e.solver
    arn = deflation.Arnoldifyer(sol)
    Wt = np.zeros((arn.n + arn.d, 0))
    return np.asarray(deflation.bound_pseudo(arn, Wt, tol=1e-10,
                                             pseudo_type="nonnormal"))


def _rc_battery_case(case, device):
    """One sequence of the battery (a case of :func:`_rc_battery_cases`)
    on ``device`` (``None``: the card, as numpy inputs go) against the
    port's CPU run of it, which prices on the card's clock: every
    recomputed final residual finite and at most tol, no later solve
    longer than the first, the iterations per solve within
    ``RC_ITER_SLACK`` of the CPU's, the iterates on the card.  Returns
    the record."""
    label, solver, spec, N, small, params, n = case
    clock = []
    card = _rc_sequence(solver, spec, N, small, params, n, device,
                        clock=clock)
    cpu = _rc_sequence(solver, spec, N, small, params, n, "cpu",
                       replay=clock)
    tol = params["tol"]
    if not all(math.isfinite(f) for f in card["final"]) or \
            max(card["recomputed"]) > tol:
        raise AssertionError(f"recycle {label}: final residuals "
                             f"{card['final']}, recomputed "
                             f"{card['recomputed']}, tol {tol}")
    if max(card["iters"][1:]) > card["iters"][0]:
        raise AssertionError(f"recycle {label}: a later solve is longer "
                             f"than the first: {card['iters']}")
    if any(abs(a - b) > RC_ITER_SLACK
           for a, b in zip(card["iters"], cpu["iters"])):
        raise AssertionError(f"recycle {label}: card {card['iters']} "
                             f"against the CPU {cpu['iters']}")
    if set(card["xk_device"]) != {"cuda"}:
        raise AssertionError(f"recycle {label}: iterates on "
                             f"{card['xk_device']}")
    return {"card": card, "cpu_iters": cpu["iters"],
            "cpu_widths": cpu["widths"]}


def _rc_battery(device):
    """(a): the battery on the card from numpy, each sequence against the
    port's CPU run of it; the non-normal bound on the card against the
    CPU's."""
    import warnings

    record = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for case in _rc_battery_cases():
            record[case[0]] = _rc_battery_case(case, None)
        got, want = _rc_bound_nonnormal(None), _rc_bound_nonnormal("cpu")
    if got.shape != want.shape or not np.isfinite(got).all() or np.max(
            np.abs(got - want) / np.abs(want)) > RC_BOUND_RTOL:
        raise AssertionError(f"recycle bound_pseudo nonnormal: card {got}, "
                             f"CPU {want}")
    record["bound_pseudo nonnormal"] = {
        "card": got.tolist(), "cpu": want.tolist(),
        "max_rel": float(np.max(np.abs(got - want) / np.abs(want)))}
    return record


class _CompatNewtonSolver:
    """``functional.newton_krylov``'s ``recycling_solver=`` over KryPy's
    API: each Jacobian solve is ``LinearSystem(J, b, M=M,
    self_adjoint=True)`` solved by one ``recycling.<solver>`` kept across
    the sequence.  ``J`` applies the Jacobian action newton hands over
    (``torch.func.jvp`` of F at the float32 iterate: K1 and its tangent)
    to float32 vectors, and to float64 ones (the lane's iterate and
    explicit residual) the jvp at the iterate in float64, which takes the
    plain stencil.  A solve that raises ``ConvergenceError`` at
    ``maxiter`` gives its iterate (``e.solver``) to newton and, as the
    reference has it, does not become ``last_solver``; with
    ``recycle_capped`` it does (the functional lane's rule, a diagnostic
    beside the reference's).  Each solve records which solve it recycled
    from; the first deflated one is kept (``first_deflated``: its float64
    operator, right-hand side, tolerance, solver and the solver it
    recycled from) for :func:`_rc_first_deflated`."""

    def __init__(self, vector_factory, solver="RecyclingGmres",
                 recycle_capped=False):
        from krypy_tpu_torch import recycling

        self.rec = getattr(recycling, solver)(vector_factory=vector_factory)
        self.recycle_capped = recycle_capped
        self.jvp32 = self.jvp64 = 0
        self.solves = []
        self.first_deflated = None
        self._number, self._op64 = {}, {}

    def _system(self, op, b, M):
        import torch
        from krypy_tpu_torch import linsys

        op64 = op.rebuild(op.params.to(torch.float64))

        def J(v):
            if v.dtype == torch.float32:
                self.jvp32 += 1
                return op(v)
            self.jvp64 += 1
            return op64(v)

        J.shape = (b.numel(), b.numel())
        return linsys.LinearSystem(J, b, M=M, self_adjoint=True), op64

    def warmup(self, op, b, M=None, maxiter=None):
        """One plain and one deflated solve (a placeholder basis of three
        unit vectors) on newton's zero right-hand side, then no
        ``last_solver``."""
        import torch
        from krypy_tpu_torch import deflation

        ls, _ = self._system(op, b, M)
        self.rec.solve(ls, maxiter=maxiter)
        U = torch.eye(b.numel(), 3, dtype=b.dtype, device=b.device)
        deflation.DeflatedGmres(ls, U=U, maxiter=maxiter, store_arnoldi=True)
        self.rec.last_solver = None
        return self

    def solve(self, op, b, tol=None, M=None, maxiter=None):
        from krypy_tpu_torch import errors

        ls, op64 = self._system(op, b, M)
        before = self.rec.last_solver
        k = len(self.solves)
        t0 = time.perf_counter()
        try:
            sol, capped = self.rec.solve(ls, tol=tol, maxiter=maxiter), False
        except errors.ConvergenceError as e:
            sol, capped = e.solver, True
            if self.recycle_capped:
                self.rec.last_solver = sol
        wall = time.perf_counter() - t0
        self._number[id(sol)] = k
        self._op64[k] = op64
        src = None if before is None else self._number[id(before)]
        width = int(sol.projection.U.shape[1])
        if width and self.first_deflated is None:
            self.first_deflated = dict(
                index=k, op64=op64, b=b, M=M, tol=tol, maxiter=maxiter,
                solver=sol, source=before, source_op64=self._op64[src])
        self.solves.append({
            "niter": len(sol.resnorms) - 1, "capped": capped,
            "recycled_from": src,
            "from_previous": None if src is None else src == k - 1,
            "width": width, "final_resnorm": float(sol.resnorms[-1]),
            "wall_s": wall})
        return SimpleNamespace(x=sol.xk.reshape(b.shape).to(b.dtype),
                               niter=len(sol.resnorms) - 1)


def _rc_c5_compat(nx, device, maxiter, vector_factory=None,
                  solver="RecyclingGmres", recycle_capped=False):
    """Config 5 (``suite.config5_problem``, K1 in F and its tangent)
    driven by ``functional.newton_krylov`` (at most ``maxiter`` Newton
    steps) through the adapter, launch counts zeroed just before and read
    just after.  The adapter is returned under ``"adapter"``."""
    import torch
    from krypy_tpu_torch import functional as F, kernels, recycling, suite

    if vector_factory is None:
        vector_factory = recycling.factories.RitzFactorySimple(
            n_vectors=3, which="sm")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prob = suite.config5_problem(nx, "cuda", device)
    adapter = _CompatNewtonSolver(vector_factory, solver, recycle_capped)
    t0 = time.perf_counter()
    res = F.newton_krylov(prob["F"], prob["x0"], tol=prob["tol"],
                          maxiter=maxiter, inner_maxiter=C5_CAP,
                          recycling_solver=adapter, warmup=True)
    total = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {
        "solver": solver, "recycle_capped": recycle_capped,
        "newton_steps": int(res.niter), "newton_maxiter": maxiter,
        "converged": bool(res.converged), "resnorms": res.resnorms.tolist(),
        "fnorm_final": float(res.resnorms[-1]), "tol": prob["tol"],
        "f0": prob["f0"], "inner_iters": res.inner_history.tolist(),
        "solves": adapter.solves, "total_s": total,
        "warmup_s": float(res.warmup_s),
        "serve_s": total - float(res.warmup_s),
        "f_calls": prob["calls"]["F"], "f32_calls": prob["calls"]["F32"],
        "jvp32": adapter.jvp32, "jvp64": adapter.jvp64,
        "launches": {k: c for k, c in kernels.launch_counts().items() if c},
        "tangent_launches": kernels.tangent_counts()["stencil5_affine"],
        "vector_factory_s": list(adapter.rec.timings["vector_factory"]),
        "adapter": adapter,
    }


def _rc_first_deflated(tag, c, ritz=None):
    """The first deflated solve of a compatibility sequence (if any)
    against the functional lane on the same float64 J, b and U:
    ``functional.deflated_gmres`` (``deflated_minres`` for MINRES) to the
    same tolerance and cap, its residual history within
    ``RC_C5_HISTORY_RTOL`` of the solve's (each times its own norm of b,
    entry by entry, the lengths within one).  With ``ritz = (n_vectors,
    which)`` (RitzFactorySimple) also the basis: its Rayleigh quotients
    under the float64 Jacobian of the undeflated solve it was taken from,
    against the Ritz values that ``functional.ritz_pairs`` gives for that
    solve's Arnoldi relation: each quotient nearest to one of the values
    ``which`` selects, and within half that value's distance to the
    next (the float32 Krylov vectors move the quotients by far less than
    the spacing of the smallest values).  A wrong projection,
    a wrong correction of the iterate, a wrong Arnoldi recurrence or a
    wrong Ritz basis moves one of them.  Returns the record, or None
    where no solve deflated."""
    import torch
    from krypy_tpu_torch.functional import deflation as fdefl

    first = c["adapter"].first_deflated
    if first is None:
        return None
    sol = first["solver"]
    U = sol.projection.U
    solve = (fdefl.deflated_minres if c["solver"] == "RecyclingMinres"
             else fdefl.deflated_gmres)
    b64 = first["b"].to(torch.float64)
    res = solve(first["op64"], b64, U, M=first["M"], tol=first["tol"],
                maxiter=first["maxiter"])
    want = res.resnorms[: int(res.niter) + 1].double().cpu().numpy() * \
        float(torch.linalg.vector_norm(b64))
    got = np.asarray(sol.resnorms, dtype=np.float64) * float(
        sol.linear_system.MMlb_norm)
    n = min(len(got), len(want))
    gap = np.abs(got[:n] - want[:n]) / np.abs(want[:n])
    out = {"solve": first["index"], "width": int(U.shape[1]),
           "iterations": [len(got) - 1, len(want) - 1],
           "max_rel_gap": float(np.max(gap))}
    if abs(len(got) - len(want)) > 1 or not out["max_rel_gap"] <= \
            RC_C5_HISTORY_RTOL:
        raise AssertionError(
            f"{tag}: solve {first['index']} against the functional lane on "
            f"the same J, b and U: {len(got) - 1} / {len(want) - 1} "
            f"iterations, residual histories {out['max_rel_gap']:.3e} apart "
            f"(bound {RC_C5_HISTORY_RTOL})")
    src = first["source"]
    if ritz is not None and src.projection.U.shape[1] == 0:
        internals = {"V": src.V.to(torch.float64).T,
                     "H": torch.as_tensor(src.H, device=src.V.device),
                     "niter": src.H.shape[1]}
        theta = np.real(fdefl.ritz_pairs(internals, hermitian=True)[0])
        order = {"sm": np.argsort(np.abs(theta)),
                 "lm": np.argsort(np.abs(theta))[::-1]}[ritz[1]]
        Q = torch.linalg.qr(U.to(torch.float64))[0]
        JQ = torch.stack([first["source_op64"](q) for q in Q.T], dim=1)
        got = torch.linalg.eigvalsh((Q.T @ JQ + JQ.T @ Q) / 2).cpu().numpy()
        nearest = [int(np.argmin(np.abs(theta - g))) for g in got]
        share = [abs(g - theta[j]) / np.min(np.abs(np.delete(theta, j)
                                                    - theta[j]))
                 for g, j in zip(got, nearest)]
        out["ritz"] = {"rayleigh": got.tolist(),
                       "nearest": theta[nearest].tolist(),
                       "selected": theta[order[:ritz[0]]].tolist(),
                       "gap_over_spacing": float(max(share))}
        if sorted(nearest) != sorted(order[:ritz[0]].tolist()) or \
                not max(share) < 0.5:
            raise AssertionError(
                f"{tag}: the basis of solve {first['index']}: Rayleigh "
                f"quotients {got.tolist()}, nearest to the Ritz values "
                f"{out['ritz']['nearest']} ({max(share):.3e} of their "
                f"spacing), functional.ritz_pairs selects "
                f"{out['ritz']['selected']}")
    return out


def _rc_c5_check(label, nx, c, f, inner=True, ritz=None):
    """Config 5's gates on a compatibility sequence ``c`` against the
    functional kernel lane's ``f`` of the same run, and its first
    deflated solve against the functional lane
    (:func:`_rc_first_deflated`).  ``inner``: the inner iterations of
    each solve that neither lane capped, within ``RC_C5_INNER_SLACK``,
    where the factory is the functional lane's; under the functional
    lane's rule (``recycle_capped``) only while the two Newton sequences
    still solve the same system (``||F||`` entering the solve within
    ``RC_C5_SAME_SYSTEM_RTOL``: past that the lanes' float32 and float64
    Krylov arithmetic have led them to other iterates).  Held back is a
    sequence under the reference's rule that did not converge with a
    solve that could not recycle from the capped solve before it
    (ROADMAP.md queue C); every other sequence must converge within
    ``RC_C5_NEWTON_SLACK`` of the functional lane's Newton steps.
    Returns a record: ``held_back``, ``first_deflated``,
    ``inner_compared`` (the solves whose counts were held) and
    ``failed`` (every gate's failure)."""
    tag = f"recycle config5 {label} {nx}^2"
    solves, failed = c["solves"], []
    if not all(math.isfinite(v) for v in c["resnorms"]) or not all(
            math.isfinite(s["final_resnorm"]) for s in solves):
        failed.append(f"{tag}: a residual is not finite: {c['resnorms']}, "
                      f"{solves}")
    # each solve recycles from the last solve that became last_solver:
    # under the reference's rule the last that returned (a capped solve
    # raised), under the functional lane's every solve
    last = None
    for k, s in enumerate(solves):
        if s["recycled_from"] != last:
            failed.append(f"{tag}: solve {k} recycled from "
                          f"{s['recycled_from']}, the rule gives {last}")
        if not s["capped"] or c["recycle_capped"]:
            last = k
    compared = [i for i, (a, b) in enumerate(zip(c["inner_iters"],
                                                  f["inner_iters"]))
                if inner and a < C5_CAP and b < C5_CAP and (
                    not c["recycle_capped"] or abs(
                        c["resnorms"][i] - f["resnorms"][i]) <=
                    RC_C5_SAME_SYSTEM_RTOL * f["resnorms"][i])]
    for i in compared:
        a, b = c["inner_iters"][i], f["inner_iters"][i]
        if abs(a - b) > RC_C5_INNER_SLACK:
            failed.append(f"{tag}: solve {i}: {a} inner iterations, the "
                          f"functional lane {b} ({c['inner_iters']} / "
                          f"{f['inner_iters']})")
    held_back = not c["recycle_capped"] and not c["converged"] and any(
        solves[k - 1]["capped"] for k in range(1, len(solves)))
    if c["newton_maxiter"] < f["newton_steps"] + RC_C5_NEWTON_SLACK:
        failed.append(f"{tag}: run to {c['newton_maxiter']} Newton steps, "
                      "short of the gate's depth")
    if c["converged"]:
        if abs(c["newton_steps"] - f["newton_steps"]) > RC_C5_NEWTON_SLACK:
            failed.append(f"{tag}: {c['newton_steps']} Newton steps, the "
                          f"functional lane {f['newton_steps']}")
    elif not held_back:
        failed.append(f"{tag}: not converged in {c['newton_steps']} steps "
                      f"({c['resnorms']}) with no capped solve to explain "
                      "it")
    # K1 once to build F, once per float32 call of F, once more per
    # float32 Jacobian action (its tangent); float64 takes the plain
    # stencil, and nothing else launches
    want = {"stencil5_affine": 1 + c["f32_calls"] + c["jvp32"]}
    if c["launches"] != want or c["tangent_launches"] != c["jvp32"]:
        failed.append(f"{tag}: launched {c['launches']} with "
                      f"{c['tangent_launches']} tangents, expected {want} "
                      f"with {c['jvp32']}")
    try:
        first = _rc_first_deflated(tag, c, ritz)
    except AssertionError as exc:
        first = None
        failed.append(str(exc))
    return {"held_back": held_back, "first_deflated": first,
            "inner_compared": compared, "failed": failed}


def _per_step(serve_s, newton_steps, inner_iters):
    """``serve_s`` per Newton step and per inner iteration: sequences of
    different depths compare on these."""
    return {"serve_s_per_newton_step": serve_s / max(newton_steps, 1),
            "serve_s_per_inner_iteration": serve_s / max(sum(inner_iters),
                                                         1)}


def _rc_summary(c, smi, **extra):
    out = {"device": smi, "solver": c["solver"],
           "recycle_capped": c["recycle_capped"],
           "newton_steps": c["newton_steps"],
           "newton_maxiter": c["newton_maxiter"],
           "converged": c["converged"], "resnorms": c["resnorms"],
           "tol_abs": c["tol"] * max(c["f0"], 1.0),
           "inner_iters": c["inner_iters"],
           "capped": [s["capped"] for s in c["solves"]],
           "recycled_from": [s["recycled_from"] for s in c["solves"]],
           "widths": [s["width"] for s in c["solves"]],
           "final_resnorms": [s["final_resnorm"] for s in c["solves"]],
           "solve_walls_s": [s["wall_s"] for s in c["solves"]],
           "serve_s": c["serve_s"], "total_s": c["total_s"],
           "warmup_s": c["warmup_s"], "f32_calls": c["f32_calls"],
           "jvp32": c["jvp32"], "jvp64": c["jvp64"],
           "launches": c["launches"],
           "tangent_launches": c["tangent_launches"],
           "vector_factory_s": c["vector_factory_s"]}
    out.update(_per_step(c["serve_s"], c["newton_steps"], c["inner_iters"]))
    out.update(extra)
    return out


def _rc_print(nx, label, rec):
    print(f"recycle config5 {nx}^2 {label}: Newton {rec['newton_steps']} "
          f"(converged {rec['converged']}, held back {rec['held_back']}), "
          f"||F|| {rec['resnorms']}, "
          f"inner {rec['inner_iters']}, capped {rec['capped']}, recycled "
          f"from {rec['recycled_from']}, widths {rec['widths']}, serve_s "
          f"{rec['serve_s']:.6f} ({rec['serve_s_per_newton_step']:.6f} per "
          f"step, {rec['serve_s_per_inner_iteration']:.6f} per inner "
          f"iteration), vector_factory_s {rec['vector_factory_s']}, first "
          f"deflated solve {rec['first_deflated']}, inner iterations "
          f"compared in solves {rec['inner_compared']}, failed "
          f"{rec['failed']}", flush=True)


def _rc_config5(device, smi, grids=RC_C5_GRIDS):
    """(b): config 5 through ``recycling.RecyclingGmres`` on ``grids``
    (511^2 and 1023^2) beside the functional kernel lane's sequence, run
    here, each sequence at the Newton gate's depth: under the reference's
    rule and under the functional lane's (``recycle_capped``); at the
    first grid ``RC_C5_ROUNDS`` interleaved sequences per lane timed (the
    first, counted, round gated), at the others one; at the last grid the busy share of a compatibility sequence
    (``RC_C5_PROFILE_STEPS`` Newton steps, profiled); at the first also
    the two automatic factories.  Every
    sequence runs whatever an earlier one failed: the gates' failures are
    listed under ``"failed"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    record, fs = {}, {}
    simple = ("RitzFactorySimple(3, sm)", (3, "sm"))
    for nx in grids:
        serve = {"compat": [], "functional": []}
        rounds = RC_C5_ROUNDS if nx == grids[0] else 1
        c = f = None
        for r in range(rounds):
            for lane in (("functional", "compat") if r % 2 == 0
                         else ("compat", "functional")):
                if lane == "functional":
                    out = _c5_run(nx, "cuda", False, device)
                    f = f or out
                    serve[lane].append(out["serve_s"])
                    continue
                out = _rc_c5_compat(nx, device, f["newton_steps"]
                                    + RC_C5_NEWTON_SLACK)
                serve[lane].append(out["serve_s"])
                c = c or out
        fs[nx] = f
        rec = record[f"{nx}"] = _rc_summary(
            c, smi, **_rc_c5_check(simple[0], nx, c, f, ritz=simple[1]))
        rec["functional"] = {k: f[k] for k in (
            "newton_steps", "inner_iters", "resnorms", "serve_s", "total_s",
            "launches", "tangent_launches", "jvp_calls", "f_calls")}
        rec["functional"].update(_per_step(f["serve_s"], f["newton_steps"],
                                           f["inner_iters"]))
        rec["serve_s_rounds"] = {
            lane: dict(all=v, median=statistics.median(v), min=min(v),
                       max=max(v)) for lane, v in serve.items()}
        _rc_print(nx, simple[0], rec)
        for lane, v in rec["serve_s_rounds"].items():
            print(f"timing recycle config5 {nx}^2 {lane} serve_s median="
                  f"{statistics.median(v['all']):.6f} min={v['min']:.6f} "
                  f"max={v['max']:.6f} all={v['all']}", flush=True)
        # the functional lane's rule: a capped solve becomes last_solver
        v = _rc_c5_compat(nx, device, f["newton_steps"] + RC_C5_NEWTON_SLACK,
                          recycle_capped=True)
        rec = record[f"{nx} recycle_capped"] = _rc_summary(
            v, smi, **_rc_c5_check(simple[0] + " recycle_capped", nx, v, f,
                                   ritz=simple[1]))
        _rc_print(nx, simple[0] + " recycle_capped", rec)
        if nx == grids[-1]:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                prof_run = _rc_c5_compat(nx, device, RC_C5_PROFILE_STEPS)
            busy = _device_seconds(prof)
            record[f"{nx}"]["profiled"] = {
                "newton_steps": prof_run["newton_steps"],
                "total_s": prof_run["total_s"], "busy_s": busy,
                "busy_share": busy / prof_run["total_s"]}
            print(f"timing recycle config5 {nx}^2 compat busy {busy:.6f} s "
                  f"= {100 * busy / prof_run['total_s']:.1f}% of a profiled "
                  f"sequence of {prof_run['newton_steps']} Newton steps "
                  f"({prof_run['total_s']:.3f} s)", flush=True)
    # the automatic factories at the first grid, at the gate's depth (the
    # Jacobian is symmetric indefinite: MINRES, not CG)
    nx = grids[0]
    f = fs[nx]
    for label, solver, spec in (
            ("RecyclingGmres RitzApproxKrylov", "RecyclingGmres",
             "RitzApproxKrylov"),
            ("RecyclingMinres RitzAprioriMinres", "RecyclingMinres",
             "RitzAprioriMinres")):
        c = _rc_c5_compat(nx, device, f["newton_steps"] + RC_C5_NEWTON_SLACK,
                          spec, solver)
        rec = record[f"{nx} {label}"] = _rc_summary(
            c, smi, **_rc_c5_check(label, nx, c, f, inner=False))
        _rc_print(nx, label, rec)
    record["failed"] = [m for rec in record.values() for m in rec["failed"]]
    return record


def _rc_checkpoint(device):
    """(c): ``CheckpointedRecycling`` over config 4's four shifted
    Laplacians at ``RC_CK_NX`` on the kernel lane (K1-K3 in the V-cycle,
    K7 in ``cgs2_pallas``), saved after the second solve and finished by
    a fresh object from the directory, against the uninterrupted
    ``suite.recycling_sequence``."""
    import shutil

    import torch
    from krypy_tpu_torch import checkpoint, kernels, suite

    impl, ortho = "cuda", "cgs2_pallas"
    whole = [r["niter"] for r in suite.recycling_sequence(
        RC_CK_NX, impl, ortho, device)]
    Ml = suite._multigrid(RC_CK_NX, impl, device)
    kw = dict(Ml=Ml, tol=suite.INNER_TOL, maxiter=suite.RESTART, ortho=ortho)
    shutil.rmtree(RC_CK_DIR, ignore_errors=True)
    ck = dict(n_vectors=suite.N_VECTORS, which="sm", hermitian=False,
              device=device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        first = checkpoint.CheckpointedRecycling(RC_CK_DIR, **ck)
        got = []
        for sigma in suite.SIGMAS[:RC_CK_SAVED_AFTER]:
            A, b, _ = suite._system(RC_CK_NX, sigma, impl, device)
            got.append(int(first.solve(A, b, **kw).niter))
        saved = checkpoint.load(RC_CK_DIR, device=False)["U"]
        second = checkpoint.CheckpointedRecycling(RC_CK_DIR, **ck)
        U = second._rec._U
        if not U.is_cuda or not np.array_equal(U.cpu().numpy(), saved):
            raise AssertionError("recycle checkpoint: the reloaded basis is "
                                 "not the saved one on the card")
        for sigma in suite.SIGMAS[RC_CK_SAVED_AFTER:]:
            A, b, _ = suite._system(RC_CK_NX, sigma, impl, device)
            got.append(int(second.solve(A, b, **kw).niter))
        torch.cuda.synchronize()
        launches = {k: c for k, c in kernels.launch_counts().items() if c}
    finally:
        shutil.rmtree(RC_CK_DIR, ignore_errors=True)
    if got != whole:
        raise AssertionError(f"recycle checkpoint: iterations {got} after "
                             f"the reload, {whole} uninterrupted")
    for name in ("stencil5_affine", "stencil5_jacobi2",
                 "stencil5_resrestrict_rows", "cgs_project"):
        if not launches.get(name):
            raise AssertionError(f"recycle checkpoint: {name} not launched "
                                 f"({launches})")
    return {"nx": RC_CK_NX, "iterations": got, "uninterrupted": whole,
            "basis_shape": list(saved.shape), "basis_dtype": str(saved.dtype),
            "launches": launches}


def recycle_phase(device, smi, grids=RC_C5_GRIDS):
    """KryPy's recycling lane on the card (``--only recycle``): (a) the
    battery from numpy against the port's CPU run and the non-normal
    bound, (b) config 5 through ``recycling.RecyclingGmres`` on ``grids``
    (511^2 and 1023^2; the whole script ``RC_C5_WHOLE_GRIDS``) beside
    the functional lane, (c) ``checkpoint`` over config 4's sequence.
    Every part runs; a failed gate is raised after all of them, with every
    part's failure.  Prints one JSON line and returns it."""
    import warnings

    t0 = time.perf_counter()
    record, parts, failed = {}, {}, []
    for name, fn, args in (("battery", _rc_battery, (device,)),
                           ("config5", _rc_config5, (device, smi, grids)),
                           ("checkpoint", _rc_checkpoint, (device,))):
        t = time.perf_counter()
        try:
            # the lane warns where an updated residual reached tol and the
            # explicit one did not; the records hold the outcome
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                record[name] = fn(*args)
            failed += [f"{name}: {m}" for m in record[name].get("failed",
                                                                 ())]
        except AssertionError as exc:
            failed.append(f"{name}: {exc}")
            record[name] = None
        parts[name] = time.perf_counter() - t
        print(f"recycle {name}: {parts[name]:.1f} s", flush=True)
    if tuple(grids) != RC_C5_GRIDS:
        record["reduced_from"] = {"config5": list(RC_C5_GRIDS)}
    record["part_s"] = parts
    record["phase_s"] = time.perf_counter() - t0
    record["failed"] = failed
    record["device"] = smi
    print(json.dumps({"recycle": record}, default=str), flush=True)
    if failed:
        raise AssertionError("recycle phase: " + "; ".join(failed))
    return record


# ---------------------------------------------------------------------------
# the nonsym phase: the north star's system through the nonsymmetric short
# recurrences (bicgstab, tfqmr, idrs, fgmres, qmr)
# ---------------------------------------------------------------------------

#: the north star's grid, and its logical grid for the transpose check
NONSYM_NX = NS_NX
NONSYM_AT_NX = NX
#: interleaved timed solves per lane (after the gated, counted one; 3
#: until the eigen phase came)
NONSYM_ROUNDS = 1
#: inner iterations per converged refinement cycle that the kernel lane
#: may differ by from the plain lane, and a "1r" form from its classic form
#: (for IDR(s), cycles of s + 1 matvecs; a cycle that ends at its float32
#: floor is not compared: northstar.make_nonsym, ROADMAP.md C)
NONSYM_INNER_SLACK = 3
NONSYM_1R_SLACK = 3
#: AT (K1 with the swapped coefficients, float32) against the float64
#: transpose of the plain operator, relative to its largest entry
NONSYM_AT_RTOL = 1e-5
#: the flexible solve: omega of its 2-sweep Jacobi from zero
NONSYM_JACOBI_OMEGA = 0.8


def _nonsym_applications(name, call):
    """What one solver call's counts predict for its applications of A,
    AT and M (``MT = M`` counts as M): ``k`` its ``niter``, ``m`` TFQMR's
    half-steps (``entries - 1``) and ``e`` the explicit residuals it took
    (read off its A applications; a converged call takes at least one,
    and no call more than one per step):

    * bicgstab: A ``1 + 2k + e`` (r0, two per iteration), M ``2k``;
    * tfqmr: A ``2 + m + e`` (r0, the first ``A M u``, one per
      half-step), M ``2 + m + e`` (and the final ``x0 + M y``);
    * idrs: A ``1 + k + e`` (``k`` the matvecs, ``s + 1`` per cycle),
      M ``k``;
    * fgmres: A ``1 + k + e``, M ``k``;
    * qmr: A ``1 + k + e``, AT ``k``, M ``2k + 1 + e`` (``A M p`` and
      ``M^T A^T q`` per iteration, one per explicit residual and the
      final iterate).

    Returns ``(want, e)``; raises where ``e`` is out of its range."""
    k, m = call["niter"], call["entries"] - 1
    a0, at, m0, e_in_m = {
        "bicgstab": (1 + 2 * k, 0, 2 * k, 0),
        "tfqmr": (2 + m, 0, 2 + m, 1),
        "idrs": (1 + k, 0, k, 0),
        "fgmres": (1 + k, 0, k, 0),
        "qmr": (1 + k, k, 2 * k + 1, 1),
    }[name]
    e = call["A"] - a0
    if not int(call["status"] == 0) <= e <= max(m, 1):
        raise AssertionError(f"nonsym {name}: {e} explicit residuals in a "
                             f"solver call {call}")
    return {"A": a0 + e, "AT": at, "M": m0 + e_in_m * e}, e


def _nonsym_launch_identity(label, name, counts, calls, vcycles=None):
    """The kernel lane's K1-K3 launches against the applications: each
    application of A or AT one K1, and one K1 per solver call (the
    restart control's true residual); each V-cycle one K2 and one K3 per
    kernel level (``KERNEL_LEVELS``), ``len(KERNEL_LEVELS) + 1`` K1 and
    one coarse form (as the north star's, :func:`_ns_launch_identity`);
    ``vcycles`` (default: every M application) and one K1 per other M
    application (the flexible solve's 2-sweep Jacobi).  Each call's
    applications must be what its counts predict
    (:func:`_nonsym_applications`)."""
    nlev = len(KERNEL_LEVELS)
    for call in calls:
        want, _ = _nonsym_applications(name, call)
        got = {key: call[key] for key in want}
        if got != want:
            raise AssertionError(f"nonsym {label}: applications {got} of "
                                 f"{call} against {want}")
    tot = {key: sum(c[key] for c in calls) for key in ("A", "AT", "M")}
    nv = tot["M"] if vcycles is None else vcycles
    want = {"stencil5_affine": tot["A"] + tot["AT"] + len(calls)
            + (nlev + 1) * nv + (tot["M"] - nv),
            "stencil5_jacobi2": nlev * nv,
            "stencil5_resrestrict_rows": nlev * nv,
            "stencil5_coarse": nv}
    got = {key: counts[key] for key in want}
    print(f"nonsym {label}: applications {tot} in {len(calls)} solver calls "
          f"({nv} V-cycles) -> launches {got} against {want}", flush=True)
    if got != want:
        raise AssertionError(f"nonsym {label}: launches {got} do not match "
                             f"the applications {want}")
    return got


def _nonsym_solve(label, solve, b, cd64, counted):
    """One gated solve (no warm-up: the kernels are built): float64
    residual <= 1e-8; the launch counts zeroed just before and read just
    after; with ``counted`` (the kernel lane) the solve profiled for its
    device time (the plain lane is not profiled: ~60 s of profiler time
    that made room for the eigen phase).  Returns ``(info, rel, launches,
    device seconds or None)``."""
    import torch
    from krypy_tpu_torch import kernels
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with (profile(activities=[ProfilerActivity.CUDA]) if counted
          else contextlib.nullcontext()) as prof:
        res, info = solve(b, warm=False)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    busy = _device_seconds(prof) if counted else None
    rel = float(torch.linalg.vector_norm(b - cd64(res.x))
                / torch.linalg.vector_norm(b))
    info["outer"] = res.resnorms.cpu().tolist()
    calls = [(c["cycle"], c["niter"], c["status"], round(c["rel32"], 6))
             for c in info["calls"]]
    print(f"nonsym {label}: cycles={info['cycles']} inner {info['inner']} "
          f"calls (cycle, niter, status, float32 rel) {calls} outer "
          f"{[f'{v:.2e}' for v in info['outer']]} rel={rel:.3e}", flush=True)
    _check_solution(res.x, b.shape[0], rel, res.resnorms.cpu().numpy())
    if not counted and any(launches.values()):
        raise AssertionError(f"nonsym {label}: the plain lane launched "
                             f"kernels {launches}")
    return info, rel, launches, busy


def _nonsym_gated_cycles(info):
    """``(iterations, converged)`` per refinement cycle: a cycle counts as
    converged where its last solver call reached ``tol`` (status 0); the
    first cycle from 511^2 up ends at its float32 floor instead
    (``northstar.make_nonsym``), where the counts follow the rounding."""
    last = {}
    for c in info["calls"]:
        last[c["cycle"]] = c["status"] == 0
    return info["inner"], [last[j] for j in range(info["cycles"])]


def _nonsym_agree(what, got, want, slack):
    """Equal refinement cycles, and the inner iterations of every cycle
    converged in both runs within ``slack``."""
    (gi, gc), (wi, wc) = _nonsym_gated_cycles(got), _nonsym_gated_cycles(want)
    if len(gi) != len(wi) or any(
            p and q and abs(a - c) > slack
            for a, c, p, q in zip(gi, wi, gc, wc)):
        raise AssertionError(f"nonsym {what}: inner iterations per cycle "
                             f"{gi} (converged {gc}) against {wi} "
                             f"(converged {wc}), slack {slack}")


def _nonsym_slack(label, limit):
    """``limit`` iterations in the units of the solver's ``niter``: an
    IDR(s) iteration is a cycle of ``s + 1`` matvecs."""
    from krypy_tpu_torch.northstar import NONSYM_SOLVERS

    name, kw = NONSYM_SOLVERS.get(label) or NONSYM_SOLVERS[label.split()[0]]
    return limit * (kw["s"] + 1) if name == "idrs" else limit


def _nonsym_lanes_agree(label, runs):
    """The kernel lane against the plain lane: equal cycles, inner
    iterations per converged cycle within ``NONSYM_INNER_SLACK``."""
    _nonsym_agree(f"{label} kernel lane against plain lane",
                  runs["cuda"]["info"], runs["torch"]["info"],
                  _nonsym_slack(label, NONSYM_INNER_SLACK))


def _nonsym_timing(label, lanes, b, rec):
    """``NONSYM_ROUNDS`` interleaved solves per lane, the order
    alternating; host walls, synchronised; the busy share from the gated
    solve's device seconds over the median."""
    walls = {lane: [] for lane in lanes}
    for k in range(NONSYM_ROUNDS):
        for lane in (list(lanes) if k % 2 == 0 else list(lanes)[::-1]):
            walls[lane].append(_synced_wall(
                lambda f=lanes[lane]: f(b, warm=False))[1])
    for lane, ts in walls.items():
        med = statistics.median(ts)
        r = rec[lane]
        busy = None if r["busy_s"] is None else r["busy_s"] / med
        r.update(median=med, min=min(ts), max=max(ts), all=ts,
                 busy_share=busy)
        print(f"timing nonsym {label} lane={lane} wall_s median={med:.6f} "
              f"min={min(ts):.6f} max={max(ts):.6f} busy_share="
              f"{'not measured' if busy is None else f'{busy:.3f}'}",
              flush=True)


def _nonsym_transpose_check(device):
    """AT (K1 with the swapped coefficients, float32) against the
    float64 reverse-mode transpose of the plain padded operator
    (``functional.transpose_matvec``) on a seeded random vector at
    ``NONSYM_AT_NX``^2, on the logical grid; the launch of AT is outside
    any counted run."""
    import torch
    from krypy_tpu_torch import functional as F, ops
    from krypy_tpu_torch.northstar import cd_transpose

    nx = NONSYM_AT_NX
    h2 = (1.0 / (nx + 1)) ** 2
    cd = ops.convection_diffusion_2d(nx, wind=(h2, 0.5 * h2), eps=h2,
                                     pad_cols=True, impl="torch",
                                     device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    x = ops.pad_grid_vec(torch.randn(nx * nx, generator=gen,
                                     dtype=torch.float64, device=device),
                         nx, nx)
    want = F.transpose_matvec(cd, x.shape[0], torch.float64,
                              device=device)(x)
    got = cd_transpose(nx, "cuda")(x.float()).double()
    err = float(torch.max(torch.abs(ops.unpad_grid_vec(got - want, nx, nx))))
    scale = float(torch.max(torch.abs(want)))
    pads = float(torch.max(torch.abs(want - ops.pad_grid_vec(
        ops.unpad_grid_vec(want, nx, nx), nx, nx))))
    print(f"nonsym AT@{nx}: K1 (swapped coefficients, float32) against "
          f"transpose_matvec of the plain operator (float64) on the logical "
          f"grid: max abs err {err:.3e} of max {scale:.3e} (limit "
          f"{NONSYM_AT_RTOL} relative); the reverse-mode transpose's pad "
          f"entries up to {pads:.3e}, AT's zero", flush=True)
    if not err <= NONSYM_AT_RTOL * scale:
        raise AssertionError(f"nonsym AT@{nx}: {err:.3e} against "
                             f"{NONSYM_AT_RTOL * scale:.3e}")
    return {"max_abs_err": err, "max_abs": scale, "pad_entries": pads}


def _nonsym_flexible(device, b):
    """One flexible ``fgmres`` solve per lane whose ``M`` alternates
    between the V-cycle and a 2-sweep damped Jacobi from zero (one matvec
    each; the alternation runs on across the inner solves): residual,
    lanes and launches gated."""
    import torch
    from krypy_tpu_torch import ops
    from krypy_tpu_torch.northstar import cd_coeffs, make_nonsym

    nx = NONSYM_NX
    h2 = (1.0 / (nx + 1)) ** 2
    w = NONSYM_JACOBI_OMEGA / cd_coeffs(nx)[0]
    runs = {}
    for impl in ("cuda", "torch"):
        cd32 = ops.convection_diffusion_2d(
            nx, wind=(h2, 0.5 * h2), eps=h2, pad_cols=True, impl=impl,
            device=device)
        vcycle = ops.multigrid_poisson_preconditioner(
            nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
            scale=1.0 / h2, device=device)
        used = {"vcycle": 0, "jacobi": 0}

        def M(v, cd32=cd32, vcycle=vcycle, used=used):
            if (used["vcycle"] + used["jacobi"]) % 2 == 0:
                used["vcycle"] += 1
                return vcycle(v)
            used["jacobi"] += 1
            z = w * v
            return z + w * (v - cd32(z))

        solve, cd64 = make_nonsym(nx, impl, "fgmres", device, M=M)
        used.update(vcycle=0, jacobi=0)
        info, rel, launches, busy = _nonsym_solve(
            f"fgmres flexible {impl}", solve, b, cd64, impl == "cuda")
        runs[impl] = dict(info=info, rel=rel, launches=launches,
                          used=dict(used), busy_s=busy)
    _nonsym_lanes_agree("fgmres flexible", runs)
    k = runs["cuda"]
    _nonsym_launch_identity("fgmres flexible cuda", "fgmres",
                            k["launches"], k["info"]["calls"],
                            vcycles=k["used"]["vcycle"])
    return {lane: {"cycles": r["info"]["cycles"], "inner": r["info"]["inner"],
                   "rel": r["rel"], "applications": r["used"]}
            for lane, r in runs.items()}


def nonsym_phase(device):
    """The nonsymmetric short recurrences on the north star's system
    (``--only nonsym``): for each of ``northstar.NONSYM_SOLVERS``
    (bicgstab, tfqmr, idrs(4) classic and "1r", fgmres(30) with cgs2, qmr
    classic and "1r" with ``AT=`` K1 on the swapped coefficients and ``MT
    = M``) at ``NONSYM_NX``^2 on the kernel lane (K1-K3, the coarse form)
    and the plain lane: float32 inner solves to 1e-3 (up to 2 calls per
    cycle, ``make_nonsym``'s restart control), the padded V-cycle the
    right preconditioner, float64 refinement to 1e-8.  Gates per solver:
    the float64 residual; equal refinement cycles on both lanes and, in
    every cycle whose float32 solve converged on both, inner iterations
    within ``NONSYM_INNER_SLACK`` (the first cycle ends at its float32
    floor, where the counts follow the rounding); each "1r" form against
    its classic form likewise within ``NONSYM_1R_SLACK``; the applications
    each solver call's counts predict and the K1-K3 launches those
    applications predict (:func:`_nonsym_launch_identity`).  Then AT
    against the plain operator's transpose at ``NONSYM_AT_NX``^2, and one
    flexible fgmres solve per lane.  Timed: ``NONSYM_ROUNDS`` interleaved
    solves per lane, the kernel lane's busy share of its gated, profiled
    solve.  Prints one JSON line and returns it."""
    import torch
    from krypy_tpu_torch.northstar import NONSYM_SOLVERS, make_nonsym

    t0 = time.perf_counter()
    nx = NONSYM_NX
    b = torch.ones(nx * nx, dtype=torch.float64, device=device)
    record = {"nx": nx, "device": _smi(), "solvers": {}, "launches": {}}
    failed, infos = [], {}
    for label, (name, _) in NONSYM_SOLVERS.items():
        t = time.perf_counter()
        try:
            lanes, runs = {}, {}
            for impl in ("cuda", "torch"):
                solve, cd64 = make_nonsym(nx, impl, label, device)
                lanes[impl] = solve
                info, rel, launches, busy = _nonsym_solve(
                    f"{label} {impl}", solve, b, cd64, impl == "cuda")
                runs[impl] = dict(info=info, rel=rel, busy_s=busy,
                                  launches=launches, outer=info["outer"])
            _nonsym_lanes_agree(label, runs)
            record["launches"][label] = _nonsym_launch_identity(
                f"{label} cuda", name, runs["cuda"]["launches"],
                runs["cuda"]["info"]["calls"])
            rec = {lane: {"cycles": r["info"]["cycles"],
                          "inner": r["info"]["inner"],
                          "calls": [{k: c[k] for k in (
                              "cycle", "niter", "status", "rel32", "A",
                              "AT", "M")} for c in r["info"]["calls"]],
                          "outer": r["outer"], "rel": r["rel"],
                          "busy_s": r["busy_s"]}
                   for lane, r in runs.items()}
            infos[label] = {lane: r["info"] for lane, r in runs.items()}
            _nonsym_timing(label, lanes, b, rec)
            record["solvers"][label] = rec
        except AssertionError as exc:
            failed.append(f"{label}: {exc}")
        print(f"nonsym {label}: {time.perf_counter() - t:.1f} s", flush=True)
    for label in NONSYM_SOLVERS:
        base = label[:-3]
        if label.endswith(" 1r") and label in infos and base in infos:
            for lane in ("cuda", "torch"):
                try:
                    _nonsym_agree(f"{label} against {base}, lane {lane}",
                                  infos[label][lane], infos[base][lane],
                                  _nonsym_slack(label, NONSYM_1R_SLACK))
                except AssertionError as exc:
                    failed.append(str(exc))
    for name, fn, args in (("transpose", _nonsym_transpose_check, (device,)),
                           ("flexible", _nonsym_flexible, (device, b))):
        try:
            record[name] = fn(*args)
        except AssertionError as exc:
            failed.append(f"{name}: {exc}")
    record["phase_s"] = time.perf_counter() - t0
    record["failed"] = failed
    print(json.dumps({"nonsym": record}, default=str), flush=True)
    if failed:
        raise AssertionError("nonsym phase: " + "; ".join(failed))
    return record


#: the eigen phase's grids: the slice's full width (bench.py's Poisson and
#: the north star at 4095^2), the lanes' grid, and the filtered lane's
#: (its filter degree grows like sqrt(spectral range / window width), x2
#: per grid doubling: 12800 at 4095^2; at 1023^2 eigsh_window alone took
#: ~25 s a lane on the H100, window_count as much again: PERF.md
#: section 6)
EIGEN_NX = NS_NX
EIGEN_LANE_NX = NX
EIGEN_WINDOW_NX = 255
#: the default run's grid of the block-Lanczos and Krylov-Schur lane pairs
#: (their plain lanes at 1023^2 took 48.2 and 33.7 s on the H100; ``--only
#: eigen`` keeps them at ``EIGEN_LANE_NX``): their kernel lanes still run
#: at ``EIGEN_LANE_NX`` for the gates across runs there
EIGEN_PAIR_NX = 511
#: eigsh's tolerance, and its inverse's: float64 refinement to 1e-9 (the
#: float64 residual floor of a smooth right-hand side at 4095^2 is ~8e-10)
EIGEN_TOL = 1e-8
EIGEN_INNER_TOL = 1e-9
#: lobpcg's tolerance (a residual of 1e-7 puts theta within ~1e-14 of the
#: eigenvalue, the floor of its relative residual being ~eps ||A|| /
#: lambda_11 ~ 1.5e-9 at 4095^2)
EIGEN_LOBPCG_TOL = 1e-7
#: the closed-form limit of every eigenvalue (relative), and the lanes'
#: and lobpcg-against-eigsh limit
EIGEN_CLOSED_RTOL = 1e-6
EIGEN_LANE_RTOL = 1e-8
#: restart cycles or iterations the lanes may differ by
EIGEN_COUNT_SLACK = 1
#: LOBPCG's rounding witnesses, M(s x) / s for each s: 1 -+ 2^-21, 1 -+
#: 2^-20, 1 + 2^-22 (bench.py's Poisson at 1023^2 on the H100: 23-24 on
#: the kernel lane, 22-27 on the plain lane, PERF.md PR 15)
EIGEN_M_SCALES = tuple(1 + sg * 2.0 ** -e for sg, e in
                       ((-1, 21), (-1, 20), (1, 20), (1, 21), (1, 22)))
#: the filtered lane: block (a seeded Gaussian start: the deterministic
#: default block's components on the smooth even modes fall below SVQB's
#: rank threshold at these degrees, ROADMAP.md C), filter degree (200 at
#: 63^2, x2 per grid doubling: the CPU's outer iterations stay ~5-10),
#: outer iterations, tolerance (backward: ||r|| <= tol ||A||), the
#: window_count probes and the kpm_dos moments and probes
EIGEN_WINDOW_BLOCK = 8
EIGEN_WINDOW_DEGREE = 800
EIGEN_WINDOW_MAXITER = 40
EIGEN_WINDOW_TOL = 1e-9
EIGEN_COUNT_PROBES = 16
EIGEN_DOS = dict(degree=180, n_probes=16)
EIGEN_SEED = 15


def _eigen_vcycle_levels(nx, device):
    """The padded V-cycle's kernel levels at ``nx`` (those of 511^2 and
    up: 4 at 4095^2, 2 at 1023^2), checked against one V-cycle's
    launches."""
    import torch
    from krypy_tpu_torch import kernels, ops

    nlev, n = 0, nx
    while n >= 511:
        nlev, n = nlev + 1, (n - 1) // 2
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl="cuda",
        device=device)
    r = torch.ones(M.shape[0], dtype=torch.float32, device=device)
    kernels.reset_launch_counts()
    M(r)
    got = {k: c for k, c in kernels.launch_counts().items() if c}
    want = {"stencil5_affine": nlev + 1, "stencil5_jacobi2": nlev,
            "stencil5_resrestrict_rows": nlev, "stencil5_coarse": 1}
    if got != want:
        raise AssertionError(f"eigen: one V-cycle at {nx}^2 launched {got}, "
                             f"not {want}")
    return nlev


def _eigen_identity(label, launches, nlev, k1=0, vcycles=0, prefix=0,
                    phase="eigen"):
    """The kernel lane's launches against the counted applications: ``k1``
    float32 operator applications (one K1 each), ``vcycles`` V-cycles
    (``nlev + 1`` K1, ``nlev`` K2, ``nlev`` K3 and one coarse form each)
    and ``prefix`` GMRES iterations with ``cgs2_fused`` (one K4, K5 and K6
    each); nothing else."""
    want = {"stencil5_affine": k1 + (nlev + 1) * vcycles,
            "stencil5_jacobi2": nlev * vcycles,
            "stencil5_resrestrict_rows": nlev * vcycles,
            "stencil5_coarse": vcycles, "project_prefix": prefix,
            "apply_project": prefix, "update_prefix": prefix}
    got = {k: launches.get(k, 0) for k in want}
    other = {k: c for k, c in launches.items() if c and k not in want}
    print(f"{phase} {label}: launches {got} against the applications "
          f"{want}", flush=True)
    if got != want or other:
        raise AssertionError(f"{phase} {label}: launches {got} {other} do "
                             f"not match the applications {want}")
    return got


def _eigen_closed(label, theta, want, rtol=EIGEN_CLOSED_RTOL):
    """Sorted eigenvalues against the closed form, relative."""
    got = np.sort(np.real(np.asarray(theta)))
    ref = np.sort(np.asarray(want, dtype=float))
    err = float(np.max(np.abs(got - ref) / np.abs(ref)))
    print(f"eigen {label}: theta {got.tolist()} closed form {ref.tolist()} "
          f"max rel err {err:.3e} (limit {rtol})", flush=True)
    if not err <= rtol:
        raise AssertionError(f"eigen {label}: theta off the closed form by "
                             f"{err:.3e}")
    return err


def _eigen_run(label, fn, profile=False):
    """One eigensolve ``fn() -> (result, extra)`` with the launch counts
    zeroed just before it and read just after; its wall (synchronised) and,
    with ``profile``, its device seconds."""
    import torch
    from krypy_tpu_torch import kernels
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    if profile:
        with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
    else:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: c for k, c in kernels.launch_counts().items() if c}
    busy = _device_seconds(prof) if profile else None
    print(f"eigen {label}: wall {wall:.3f} s" + (
        f", device {busy:.3f} s under the profiler" if profile else ""),
        flush=True)
    return out, launches, wall, busy


def _eigen_eigsh(nx, impl, device, nlev, ortho="cgs2"):
    """(a): the 6 smallest pairs of bench.py's Poisson operator by
    shift-invert block Lanczos (``sigma=0``, ``block_size=2``; with
    ``ortho="cgs2_1r"`` the 2 smallest by the single-vector one-reduce
    sweep, maxdim 12), ``inv`` the refined float32 multigrid-CG."""
    import torch
    from krypy_tpu_torch import eigen, functional as F

    inv, A, counts = eigen.poisson_inverse(nx, impl, device,
                                           tol=EIGEN_INNER_TOL)
    if ortho == "cgs2":
        kw, k = dict(block_size=2), 6
        want = [v for v, _, _ in eigen.poisson_eigenvalues(nx, 6)]
    else:
        kw, k = dict(maxdim=12, ortho="cgs2_1r"), 2
        # single-vector Lanczos sees one vector of each eigenspace
        want = [v for v, j, kk in eigen.poisson_eigenvalues(nx, 3)
                if j <= kk][:2]
    label = f"eigsh {ortho} {impl}@{nx}"
    r, launches, wall, _ = _eigen_run(label, lambda: F.eigsh(
        A, k, sigma=0.0, inv=inv, tol=EIGEN_TOL, **kw))
    theta = r.theta.cpu().numpy()
    pair = r.pair_resnorms.cpu().numpy()
    cycles = int((~torch.isnan(r.resnorms)).sum()) - 1
    print(f"eigen {label}: status {int(r.status)} niter {int(r.niter)} "
          f"restart cycles {cycles} pair_resnorms {pair.tolist()} inverse "
          f"{counts}", flush=True)
    if int(r.status) != 0 or not float(pair.max()) <= EIGEN_TOL:
        raise AssertionError(f"eigen {label}: status {int(r.status)}, "
                             f"pair_resnorms {pair.tolist()}")
    err = _eigen_closed(label, theta, want)
    rec = dict(theta=theta.tolist(), status=int(r.status),
               niter=int(r.niter), cycles=cycles,
               pair_resnorms=pair.tolist(), closed_rel_err=err, wall_s=wall,
               inverse=dict(counts), launches=launches)
    if impl == "cuda":
        _eigen_identity(label, launches, nlev, k1=counts["A"],
                        vcycles=counts["M"])
    elif launches:
        raise AssertionError(f"eigen {label}: the plain lane launched "
                             f"{launches}")
    return rec


def _eigen_lobpcg(nx, impl, device, nlev, m_scale=None, maxiter=500):
    """(b): the 6 smallest pairs by LOBPCG preconditioned by the padded
    V-cycle on ``x.float()``, from the deterministic default block, or (a
    rounding witness) with ``M(x)`` taken as ``M(s x) / s`` for ``s =
    m_scale``: the same preconditioner in exact arithmetic, another
    float32 rounding in every V-cycle, which is how the lanes differ; at
    most ``maxiter`` iterations.  A witness is recorded and its status
    returned, not gated (it may stall: ROADMAP.md C)."""
    from krypy_tpu_torch import eigen, functional as F, ops

    A = ops.poisson_2d(nx, device=device)
    M, counts = eigen.poisson_vcycle(nx, impl, device)
    if m_scale is not None:
        V = M

        def M(x):
            return V(x * m_scale) / m_scale
    label = f"lobpcg {impl}@{nx}" + ("" if m_scale is None else
                                     f" M(s x) / s, s = 1 + "
                                     f"{m_scale - 1:.3e}")
    r, launches, wall, _ = _eigen_run(label, lambda: F.lobpcg(
        A, 6, M=M, which="sa", tol=EIGEN_LOBPCG_TOL, maxiter=maxiter))
    theta = r.theta.cpu().numpy()
    pair = r.pair_resnorms.cpu().numpy()
    hist = r.resnorms.cpu().numpy()
    print(f"eigen {label}: status {int(r.status)} iterations "
          f"{int(r.niter)} pair_resnorms {pair.tolist()} V-cycles "
          f"{counts['M']} max relative residual per iteration "
          f"{hist[~np.isnan(hist)].tolist()}", flush=True)
    if m_scale is not None:
        return dict(lane=impl, m_scale=m_scale, niter=int(r.niter),
                    status=int(r.status),
                    resnorms=hist[~np.isnan(hist)].tolist(), wall_s=wall)
    if int(r.status) != 0:
        raise AssertionError(f"eigen {label}: status {int(r.status)}")
    err = _eigen_closed(label, theta, [v for v, _, _ in
                                       eigen.poisson_eigenvalues(nx, 6)])
    if impl == "cuda":
        _eigen_identity(label, launches, nlev, vcycles=counts["M"])
    elif launches:
        raise AssertionError(f"eigen {label}: the plain lane launched "
                             f"{launches}")
    return dict(theta=theta.tolist(), status=int(r.status),
                niter=int(r.niter), pair_resnorms=pair.tolist(),
                resnorms=hist[~np.isnan(hist)].tolist(), closed_rel_err=err,
                wall_s=wall, vcycles=counts["M"], launches=launches)


def _eigen_eigs(nx, impl, device, nlev):
    """(c): the 4 eigenvalues nearest 0 of the north star's operator by
    Krylov-Schur on the inverse, the north star's refined GMRES on the
    real and imaginary parts."""
    from krypy_tpu_torch import eigen, functional as F

    inv, A, counts = eigen.northstar_inverse(nx, impl, device)
    label = f"eigs {impl}@{nx}"
    r, launches, wall, _ = _eigen_run(label, lambda: F.eigs(
        A, 4, sigma=0.0, inv=inv, tol=EIGEN_TOL))
    theta = r.theta.cpu().numpy()
    pair = r.pair_resnorms.cpu().numpy()
    iters = sum(n for cyc in counts["gmres_niters"] for n in cyc)
    print(f"eigen {label}: status {r.status} niter {r.niter} restart "
          f"cycles {len(r.resnorms)} pair_resnorms {pair.tolist()} solves "
          f"{counts['solves']} refinement cycles {counts['cycles']} GMRES "
          f"iterations {iters}", flush=True)
    if r.status != 0 or not float(pair.max()) <= EIGEN_CLOSED_RTOL:
        raise AssertionError(f"eigen {label}: status {r.status}, "
                             f"pair_resnorms {pair.tolist()}")
    imag = float(np.max(np.abs(theta.imag) / np.abs(theta)))
    if not imag <= EIGEN_CLOSED_RTOL:
        raise AssertionError(f"eigen {label}: imaginary parts {imag:.3e}")
    err = _eigen_closed(label, theta, [v for v, _, _ in
                                       eigen.cd_eigenvalues(nx, 4)])
    if impl == "cuda":
        # per GMRES call of niter iterations: niter + 3 float32 matvecs and
        # as many V-cycles (the north star's identity, _ns_launch_identity)
        calls = [n for cyc in counts["gmres_niters"] for n in cyc]
        mv = sum(n + 3 for n in calls)
        _eigen_identity(label, launches, nlev, k1=mv, vcycles=mv,
                        prefix=iters)
    elif launches:
        raise AssertionError(f"eigen {label}: the plain lane launched "
                             f"{launches}")
    return dict(theta=[[float(z.real), float(z.imag)] for z in theta],
                status=r.status, niter=r.niter, cycles=len(r.resnorms),
                pair_resnorms=pair.tolist(), closed_rel_err=err,
                imag_rel=imag, wall_s=wall, solves=counts["solves"],
                refinement_cycles=counts["cycles"], gmres_iterations=iters,
                launches=launches)


def _eigen_window(nx, impl, device):
    """(d): the filtered lane on bench.py's Poisson operator: eigsh_window
    from a seeded Gaussian block on the window holding lambda_22 and the
    pair lambda_13 = lambda_31, window_count on it and kpm_dos, with the
    outer bounds (0, 8/h^2)."""
    import torch
    from krypy_tpu_torch import eigen, functional as F, ops

    A = ops.poisson_2d(nx, impl=impl, device=device)
    window, inside, bounds = eigen.poisson_window(nx)
    gen = torch.Generator(device=device).manual_seed(EIGEN_SEED)
    X0 = torch.randn((nx * nx, EIGEN_WINDOW_BLOCK), generator=gen,
                     dtype=torch.float64, device=device)
    label = f"window {impl}@{nx}"
    r, launches, wall, _ = _eigen_run(label, lambda: F.eigsh_window(
        A, window, X0=X0, degree=EIGEN_WINDOW_DEGREE, bounds=bounds,
        tol=EIGEN_WINDOW_TOL, maxiter=EIGEN_WINDOW_MAXITER))
    n_in = int(r.n_inside)
    theta = r.theta.cpu().numpy()
    print(f"eigen {label}: window {window} status {int(r.status)} outer "
          f"iterations {int(r.niter)} inside {n_in} theta "
          f"{theta.tolist()}", flush=True)
    if int(r.status) != 0 or n_in != 3:
        raise AssertionError(f"eigen {label}: status {int(r.status)}, "
                             f"{n_in} inside")
    err = _eigen_closed(label, theta[:3], inside)
    gen = torch.Generator(device=device).manual_seed(EIGEN_SEED)
    t = time.perf_counter()
    cnt, se = F.window_count(A, window, gen, bounds=bounds,
                             degree=EIGEN_WINDOW_DEGREE,
                             n_probes=EIGEN_COUNT_PROBES)
    t_count = time.perf_counter() - t
    # tests/test_filtered.py's tolerance of the count
    lim = max(4 * se, 0.12 * 3)
    print(f"eigen {label}: window_count {cnt:.4f} +- {se:.4f} of 3 (limit "
          f"{lim:.4f}) in {t_count:.3f} s", flush=True)
    if not abs(cnt - 3) <= lim:
        raise AssertionError(f"eigen {label}: window_count {cnt}")
    t = time.perf_counter()
    grid, dens = F.kpm_dos(A, EIGEN_SEED, bounds=bounds, **EIGEN_DOS)
    t_dos = time.perf_counter() - t
    total = float(np.trapezoid(dens, grid)) / (nx * nx)
    print(f"eigen {label}: kpm_dos integrates to {total:.6f} of 1 (limit "
          f"0.05) in {t_dos:.3f} s", flush=True)
    if not abs(total - 1) <= 0.05:
        raise AssertionError(f"eigen {label}: kpm_dos integral {total}")
    if launches:
        # float64 takes the plain stencil on both lanes (the JAX dispatch
        # rule): no kernel runs in the filtered lane
        raise AssertionError(f"eigen {label}: launches {launches}")
    return dict(window=list(window), theta=theta.tolist(),
                status=int(r.status), niter=int(r.niter), n_inside=n_in,
                closed_rel_err=err, wall_s=wall, count=cnt, count_se=se,
                count_s=t_count, dos_integral=total, dos_s=t_dos,
                degree=EIGEN_WINDOW_DEGREE, block=EIGEN_WINDOW_BLOCK)


def _eigen_busy(nx, device, nlev):
    """The device busy share of (a)'s ``cgs2_1r`` kernel lane at ``nx``,
    on its first Lanczos sweep (``max_restarts=0``: 12 inverse solves, not
    gated; the profiler's cost grows with the launches, ~6x the wall of
    the whole run): the sweep once unprofiled for its wall,
    once under the profiler for its device seconds, each run's launches
    held to its applications."""
    from krypy_tpu_torch import eigen, functional as F

    out = {}
    for profile in (False, True):
        inv, A, counts = eigen.poisson_inverse(nx, "cuda", device,
                                               tol=EIGEN_INNER_TOL)
        label = f"eigsh cgs2_1r first sweep cuda@{nx}" + (
            " profiled" if profile else "")
        r, launches, wall, busy = _eigen_run(label, lambda: F.eigsh(
            A, 2, sigma=0.0, inv=inv, tol=EIGEN_TOL, maxdim=12,
            ortho="cgs2_1r", max_restarts=0), profile=profile)
        _eigen_identity(label, launches, nlev, k1=counts["A"],
                        vcycles=counts["M"])
        out["profiled_wall_s" if profile else "wall_s"] = wall
        if profile:
            out["busy_s"] = busy
        out["solves"] = counts["solves"]
    out.update(nx=nx, busy_share=out["busy_s"] / out["wall_s"])
    print(f"busy eigen eigsh cgs2_1r cuda@{nx}: device {out['busy_s']:.3f} "
          f"s of the unprofiled wall {out['wall_s']:.3f} s = "
          f"{100 * out['busy_share']:.1f}% ({out['solves']} inverse solves)",
          flush=True)
    return out


def _eigen_lanes_agree(what, runs, count_key, witness=None):
    """The kernel lane against the plain lane at the lanes' grid: theta
    within ``EIGEN_LANE_RTOL``, the counts within ``EIGEN_COUNT_SLACK``,
    or, where ``witness()`` is given, within the spread of each lane's own
    count under another float32 rounding: ``witness()`` returns the
    witness runs (``lane``, ``status``, ``niter``), and only those that
    converged count, each against its own lane's count.  Where none
    moves, the limit stays ``EIGEN_COUNT_SLACK``."""
    c, t = runs["cuda"], runs["torch"]
    tc = np.sort(np.asarray(c["theta"], dtype=float).reshape(len(c["theta"]),
                                                             -1)[:, 0])
    tt = np.sort(np.asarray(t["theta"], dtype=float).reshape(len(t["theta"]),
                                                             -1)[:, 0])
    dev = float(np.max(np.abs(tc - tt) / np.abs(tt)))
    slack = abs(c[count_key] - t[count_key])
    print(f"eigen {what}: lanes theta within {dev:.3e} (limit "
          f"{EIGEN_LANE_RTOL}), {count_key} {c[count_key]} against "
          f"{t[count_key]}", flush=True)
    limit = EIGEN_COUNT_SLACK
    if slack > limit and witness is not None:
        moved = [abs(w[count_key] - runs[w["lane"]][count_key])
                 for w in witness() if w["status"] == 0]
        spread = max(moved, default=0)
        print(f"eigen {what}: the lanes' {count_key} under another float32 "
              f"rounding, converged witnesses only: moved by {moved}, spread "
              f"{spread}", flush=True)
        limit = max(limit, spread)
    if not dev <= EIGEN_LANE_RTOL or slack > limit:
        raise AssertionError(f"eigen {what}: lanes differ: theta {dev:.3e}, "
                             f"{count_key} {c[count_key]} / {t[count_key]}")
    return dev


def eigen_phase(device, pair_nx=EIGEN_LANE_NX):
    """The eigensolver lane (``--only eigen``), float64 outer work over the
    float32 kernel lane: (a) eigsh, the 6 smallest pairs of bench.py's
    Poisson operator at ``EIGEN_NX``^2 by shift-invert block Lanczos
    (``inv`` the refined multigrid-CG: K1-K3 and the coarse form), then
    ``cgs2_1r`` for the 2 smallest; (b) lobpcg with the V-cycle; (c)
    eigs, the 4 nearest 0 of the north star's operator (``inv`` its
    refined GMRES: K1-K6); each gated on the closed forms and its launches
    held to its counted applications.  Every run also at
    ``EIGEN_LANE_NX``^2 on both lanes (eigsh's and eigs' lane pairs at
    ``pair_nx``^2, their kernel lanes also at ``EIGEN_LANE_NX``; theta
    equal, counts within 1;
    LOBPCG's within its lanes' own spread under another float32 rounding
    of M, converged witnesses only), the first Lanczos sweep of (a)'s
    ``cgs2_1r`` kernel lane there under the profiler for its busy share;
    (d) the filtered lane (eigsh_window, window_count, kpm_dos) once at
    ``EIGEN_WINDOW_NX``^2 (float64: the plain stencil on either lane).
    Prints one JSON line and returns it."""
    t0 = time.perf_counter()
    record = {"device": _smi(), "nx": EIGEN_NX, "lane_nx": EIGEN_LANE_NX,
              "pair_nx": pair_nx, "window_nx": EIGEN_WINDOW_NX,
              "reduced_from": {}, "runs": {}, "launches": {}, "lanes": {}}
    if pair_nx != EIGEN_LANE_NX:
        record["reduced_from"]["eigsh, eigs lane pairs"] = EIGEN_LANE_NX
    failed = []
    levels = {nx: _eigen_vcycle_levels(nx, device)
              for nx in {EIGEN_NX, EIGEN_LANE_NX, pair_nx}}

    def attempt(key, fn, *args, **kw):
        t = time.perf_counter()
        try:
            rec = fn(*args, **kw)
            record["runs"][key] = rec
            if rec.get("launches"):
                record["launches"][key] = rec["launches"]
            return rec
        except AssertionError as exc:
            failed.append(f"{key}: {exc}")
        finally:
            print(f"eigen {key}: {time.perf_counter() - t:.1f} s",
                  flush=True)

    runs = {}
    moved = pair_nx != EIGEN_LANE_NX
    for nx, lanes in ((EIGEN_NX, ("cuda",)),
                      (EIGEN_LANE_NX, ("cuda", "torch"))):
        nlev = levels[nx]
        for impl in lanes:
            # (the lane pairs moved to pair_nx: their plain lanes run there)
            paired = not (moved and nx == EIGEN_LANE_NX and impl == "torch")
            if paired:
                runs["eigsh", impl, nx] = attempt(
                    f"eigsh {impl}@{nx}", _eigen_eigsh, nx, impl, device,
                    nlev)
            runs["eigsh_1r", impl, nx] = attempt(
                f"eigsh cgs2_1r {impl}@{nx}", _eigen_eigsh, nx, impl,
                device, nlev, ortho="cgs2_1r")
            runs["lobpcg", impl, nx] = attempt(
                f"lobpcg {impl}@{nx}", _eigen_lobpcg, nx, impl, device, nlev)
            if paired:
                runs["eigs", impl, nx] = attempt(
                    f"eigs {impl}@{nx}", _eigen_eigs, nx, impl, device,
                    nlev)
    for impl in ("cuda", "torch") if moved else ():
        runs["eigsh", impl, pair_nx] = attempt(
            f"eigsh {impl}@{pair_nx}", _eigen_eigsh, pair_nx, impl, device,
            levels[pair_nx])
        runs["eigs", impl, pair_nx] = attempt(
            f"eigs {impl}@{pair_nx}", _eigen_eigs, pair_nx, impl, device,
            levels[pair_nx])
    # once: in float64 both lanes take the plain stencil (no kernel)
    attempt(f"window cuda@{EIGEN_WINDOW_NX}", _eigen_window,
            EIGEN_WINDOW_NX, "cuda", device)
    if EIGEN_WINDOW_NX != EIGEN_NX:
        record["reduced_from"]["window"] = EIGEN_NX
    # the busy share of (a)'s kernel lane at the lanes' grid
    try:
        record["busy_share_eigsh_1r_cuda"] = _eigen_busy(
            EIGEN_LANE_NX, device, levels[EIGEN_LANE_NX])
    except AssertionError as exc:
        failed.append(f"busy: {exc}")

    # gates across runs: the 1r form against the classic block form, lobpcg
    # against eigsh, the lanes at the lanes' grid
    for nx in (EIGEN_NX, EIGEN_LANE_NX):
        a, one, lo = (runs.get((w, "cuda", nx))
                      for w in ("eigsh", "eigsh_1r", "lobpcg"))
        try:
            if a and one:
                ref = np.sort(a["theta"])[[0, 1]]
                dev = float(np.max(np.abs(np.sort(one["theta"]) - ref)
                                   / ref))
                print(f"eigen cgs2_1r@{nx} against the classic form: "
                      f"{dev:.3e} (limit {EIGEN_LANE_RTOL})", flush=True)
                if not dev <= EIGEN_LANE_RTOL:
                    raise AssertionError(f"cgs2_1r@{nx} off the classic "
                                         f"form by {dev:.3e}")
            if a and lo:
                dev = float(np.max(np.abs(np.sort(lo["theta"])
                                          - np.sort(a["theta"]))
                                   / np.sort(a["theta"])))
                print(f"eigen lobpcg@{nx} against eigsh: {dev:.3e} (limit "
                      f"{EIGEN_LANE_RTOL})", flush=True)
                if not dev <= EIGEN_LANE_RTOL:
                    raise AssertionError(f"lobpcg@{nx} off eigsh by "
                                         f"{dev:.3e}")
        except AssertionError as exc:
            failed.append(str(exc))
    def lobpcg_witness():
        # LOBPCG's count follows the float32 V-cycle's rounding, in which
        # the lanes differ: each lane with M(s x) / s for each of
        # EIGEN_M_SCALES, capped 10 past its own count (a witness that
        # does not converge sets no spread)
        nx = EIGEN_LANE_NX
        out = [_eigen_lobpcg(nx, impl, device, levels[nx], m_scale=sc,
                             maxiter=runs["lobpcg", impl, nx]["niter"] + 10)
               for impl in ("cuda", "torch") for sc in EIGEN_M_SCALES]
        record["lobpcg_witness"] = out
        return out

    for what, key in (("eigsh", "cycles"), ("eigsh_1r", "cycles"),
                      ("lobpcg", "niter"), ("eigs", "cycles")):
        nx = pair_nx if what in ("eigsh", "eigs") else EIGEN_LANE_NX
        pair = {impl: runs.get((what, impl, nx)) for impl in ("cuda",
                                                              "torch")}
        if all(pair.values()):
            try:
                record["lanes"][what] = _eigen_lanes_agree(
                    f"{what}@{nx}", pair, key,
                    lobpcg_witness if what == "lobpcg" else None)
            except AssertionError as exc:
                failed.append(str(exc))
    record["phase_s"] = time.perf_counter() - t0
    record["failed"] = failed
    print(json.dumps({"eigen": record}, default=str), flush=True)
    if failed:
        raise AssertionError("eigen phase: " + "; ".join(failed))
    return record


#: the lsq phase: the north star's grid for lsqr/lsmr, rsvd, hutchpp and
#: the Nystrom preconditioner; svds at 31^2 ("reduced_from": 4095): the top
#: of Poisson's spectrum is a cluster whose relative gaps shrink as h^2, so
#: LOBPCG on its Gram operator takes ~700 iterations to tol 1e-4 at 31^2,
#: ~2200 at 63^2 and more than 3000 at 127^2 (the port's CPU run), and no
#: bounded count reaches it at 4095^2
LSQ_NX = NS_NX
LSQ_SVDS_NX = 31
#: Tikhonov damp of lsqr/lsmr on the north star's h^2-scaled operator
#: (sigma_max <= 8 + 1.5 h by Gershgorin): ~290 and ~230 float32
#: iterations to tol 1e-5 at every grid (the CPU at 63^2 and 255^2),
#: where damp 0.05 takes ~500 and LSQR's ||A^T r|| estimate, oscillating,
#: trips its stagnation window below damp ~0.02
LSQ_DAMP, LSQ_TOL, LSQ_MAXITER = 0.1, 1e-5, 2000
LSQ_SIGMA_MAX = 8.0 + 1.5 / (NS_NX + 1)
#: the triplets of rsvd and svds, rsvd's oversampling and power steps,
#: svds's float32 tolerance and iteration cap, Hutch++'s head and probes,
#: the Nystrom rank and the shift of Poisson + mu I relative to
#: lambda_max (kappa ~ 100: float32 CG reaches 1e-4 there; at 1e-3
#: lambda_max it stalls above 1e-4 on the CPU at 255^2), and CG's tol
LSQ_K, LSQ_P, LSQ_Q = 6, 10, 2
LSQ_SVDS_TOL, LSQ_SVDS_MAXITER = 1e-4, 3000
LSQ_HUTCH_K, LSQ_HUTCH_PROBES, LSQ_HUTCH_SIGMAS = 16, 32, 5.0
LSQ_NYS_RANK, LSQ_NYS_MU, LSQ_NYS_TOL = 20, 1e-2, 1e-4
LSQ_SEED = 16
#: rsvd's lanes (the same sketch, float32 through K1 and through the plain
#: stencil): values within LSQ_RSVD_S_RTOL relative, their left subspaces
#: within LSQ_RSVD_U_SIN (sine of the largest principal angle); each
#: lane's certified residuals recomputed in float64 with the plain stencil
#: within LSQ_RSVD_RES_ATOL (in units of s_1: float32's residuals round
#: at ~1e-7 s_1)
LSQ_RSVD_S_RTOL, LSQ_RSVD_U_SIN, LSQ_RSVD_RES_ATOL = 1e-5, 1e-2, 1e-4
#: the Nystrom preconditioner against its float64 build from the same
#: sketch on the plain stencil: the values (relative) and P^-1's action
#: on the float64 build's range, relative to that action's own part
#: beyond the identity (the CPU in float32 at 1023^2: 5.5e-7 and 2.6e-4;
#: an identity preconditioner reads 1)
LSQ_NYS_LAM_RTOL, LSQ_NYS_APPLY_RTOL = 1e-5, 1e-2
#: iterations the lanes' lsqr/lsmr counts may differ by (ROADMAP.md C,
#: float32 reductions)
LSQ_LANE_SLACK = 3


#: the runs profiled for the phases' busy shares (device time under the
#: profiler over the wall of the same run)
LSQ_PROFILED = ("lsq lsqr cuda", "shifted shifted_cg classic cuda")


def _lsq_run(label, fn, busy=None):
    """``fn()`` with the launch counts zeroed just before it and read just
    after, and its synchronised wall; where ``label`` starts with one of
    ``LSQ_PROFILED``, the busy share of a rerun under the profiler stored
    in ``busy`` (a dict)."""
    import torch
    from krypy_tpu_torch import kernels
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: c for k, c in kernels.launch_counts().items() if c}
    extra = ""
    if busy is not None and label.startswith(LSQ_PROFILED):
        # the same run again under the profiler, once the profiler has
        # started on a trivial op (its first start takes seconds), its
        # device time over the unprofiled run's wall
        for warm in (True, False):
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                if warm:
                    torch.ones(1, device="cuda").add_(1)
                else:
                    fn()
                torch.cuda.synchronize()
        dev = _device_seconds(p)
        busy.update(device_s=dev, wall_s=wall, busy_share=dev / wall)
        extra = f", device {dev:.3f} s under the profiler in a rerun " \
                f"(busy {100 * dev / wall:.1f}%)"
    print(f"{label}: wall {wall:.3f} s{extra}, launches {launches}",
          flush=True)
    return out, launches, wall


def _lsq_solve(solver, nx, impl, device):
    """(a): ``lsqr``/``lsmr`` on the north star's padded float32 operator
    with ``Ah = northstar.cd_transpose``, ``b`` the padded ones, damp
    ``LSQ_DAMP``; gated on status, LSMR's estimated ||A^T r|| never rising,
    K1 twice per iteration and start (and per explicit check), and the
    normal-equations residual ``||A^T (b - A x) - damp^2 x||`` recomputed
    in float64 with the plain stencil within ``2 tol sqrt((2k + 1)
    (sigma_max^2 + damp^2)) ||rbar||`` (the solver's own stop rule with its
    Frobenius-norm estimate bounded, ``rbar`` the damped residual)."""
    import torch
    from krypy_tpu_torch import functional as F, northstar, ops
    from krypy_tpu_torch.functional import lsq

    h2 = 1.0 / (nx + 1) ** 2
    kw = dict(wind=(h2, 0.5 * h2), eps=h2, pad_cols=True, device=device)
    A = ops.convection_diffusion_2d(nx, impl=impl, **kw)
    At = northstar.cd_transpose(nx, impl)
    b = ops.pad_grid_vec(torch.ones(nx * nx, device=device), nx, nx)
    # each iteration's estimated ||A^T r||, read where the solver hands it
    # to its stop tests
    seen, stop_tests = [], lsq._Problem.stop_tests

    def observed(pb, normar, *rest):
        seen.append(float(normar))
        return stop_tests(pb, normar, *rest)

    lsq._Problem.stop_tests = observed
    busy = {}
    try:
        r, launches, wall = _lsq_run(
            f"lsq {solver} {impl}@{nx}",
            lambda: getattr(F, solver)(A, b, Ah=At, damp=LSQ_DAMP,
                                       tol=LSQ_TOL, maxiter=LSQ_MAXITER),
            busy)
    finally:
        lsq._Problem.stop_tests = stop_tests
    k = int(r.niter)
    A64 = ops.convection_diffusion_2d(nx, impl="torch", **kw)
    At64 = northstar.cd_transpose(nx, "torch")
    x, b64 = r.x.double(), b.double()
    res = b64 - A64(x)
    g = float(torch.linalg.vector_norm(At64(res) - LSQ_DAMP ** 2 * x))
    rbar = math.hypot(float(torch.linalg.vector_norm(res)),
                      LSQ_DAMP * float(torch.linalg.vector_norm(x)))
    limit = 2 * LSQ_TOL * math.sqrt(
        (2 * k + 1) * (LSQ_SIGMA_MAX ** 2 + LSQ_DAMP ** 2)) * rbar
    ar = np.array(seen)
    rises = int(np.sum(np.diff(ar) > 0))
    rec = {"niter": k, "status": int(r.status), "wall_s": wall,
           "launches": launches, "normal_residual": g,
           "normal_residual_limit": limit,
           "normal_residual_over_sigma_rbar": g / (LSQ_SIGMA_MAX * rbar),
           "ar_first_last": [float(ar[0]), float(ar[-1])] if len(ar) else [],
           "ar_rises": rises, "busy": busy or None}
    print(f"lsq {solver} {impl}@{nx}: {k} iterations, status {r.status}, "
          f"||A^T r - d^2 x|| {g:.3e} (limit {limit:.3e}), estimated "
          f"||A^T r|| rises {rises} times", flush=True)
    if int(r.status) != 0:
        raise AssertionError(f"{solver} {impl}: status {int(r.status)}")
    if not g <= limit:
        raise AssertionError(f"{solver} {impl}: normal-equations residual "
                             f"{g:.3e} > {limit:.3e}")
    if solver == "lsmr" and rises:
        raise AssertionError(f"lsmr {impl}: its estimated ||A^T r|| rose "
                             f"{rises} times")
    if impl == "cuda" and launches.get("stencil5_affine", 0) < 2 * k + 2:
        raise AssertionError(f"{solver}: {launches} K1 launches for {k} "
                             "iterations (two each, and two to start)")
    return rec


def _lsq_rsvd(nx, impl, device, keep):
    """(b) rsvd, float32 on Poisson through K1 (its own adjoint): each value
    at most the closed form's largest (interlacing), and the certified
    residuals ``max(||A v_i - s_i u_i||, ||A u_i - s_i v_i||) / s_1``
    recomputed in float64 with the plain stencil within
    ``LSQ_RSVD_RES_ATOL`` of the reported ones; ``keep[impl]`` takes the
    triplets for the lanes' comparison (:func:`_lsq_rsvd_lanes`).  (At
    4095^2 no closed-form gate is sharper: the 16.7M eigenvalues lie 4-35
    apart, far inside the certified residual of ~0.17 s_1.)"""
    import torch
    from krypy_tpu_torch import eigen, functional as F, ops

    A = ops.poisson_2d(nx, impl=impl, device=device)
    r, launches, wall = _lsq_run(
        f"lsq rsvd {impl}@{nx}", lambda: F.rsvd(
            A, LSQ_K, Ah=A, n=nx * nx, p=LSQ_P, q=LSQ_Q, seed=LSQ_SEED))
    s = r.s.double().cpu().numpy()
    res = r.resnorms.double().cpu().numpy()
    want = np.array([v for v, _, _ in eigen.poisson_eigenvalues(
        nx, LSQ_K, largest=True)])
    A64 = ops.poisson_2d(nx, device=device)
    again = []
    for i in range(LSQ_K):
        u, v = r.U[:, i].double(), r.Vh[i].double()
        again.append(max(float(torch.linalg.vector_norm(A64(v) - s[i] * u)),
                         float(torch.linalg.vector_norm(A64(u) - s[i] * v)))
                     / s[0])
    again = np.array(again)
    off = float(np.max(np.abs(again - res)))
    keep[impl] = (r.U, r.s)
    rec = {"s": s.tolist(), "closed": want.tolist(),
           "resnorms": res.tolist(), "resnorms_float64": again.tolist(),
           "resnorms_off": off, "wall_s": wall, "launches": launches}
    print(f"lsq rsvd {impl}@{nx}: s/lambda_max {(s / want[0]).tolist()}, "
          f"certified residuals {res.tolist()}, recomputed in float64 "
          f"{again.tolist()} (off by {off:.3e}, limit {LSQ_RSVD_RES_ATOL})",
          flush=True)
    if not np.all(s <= want[0] * (1 + 1e-5)):
        raise AssertionError(f"rsvd {impl}: above the closed form")
    if not off <= LSQ_RSVD_RES_ATOL:
        raise AssertionError(f"rsvd {impl}: certified residuals {res} "
                             f"against {again} in float64")
    return rec


def _lsq_rsvd_lanes(keep):
    """rsvd's kernel lane against its plain lane on the same sketch: the
    values within ``LSQ_RSVD_S_RTOL`` (relative) and the sine of the
    largest principal angle between their left subspaces, in float64,
    within ``LSQ_RSVD_U_SIN``."""
    import torch

    (Uc, sc), (Ut, st) = keep["cuda"], keep["torch"]
    ds = float(torch.max(torch.abs(sc.double() - st.double()) / st.double()))
    Uc, Ut = Uc.double(), Ut.double()
    Rm = Ut - Uc @ (Uc.T @ Ut)
    sin = float(torch.sqrt(torch.clamp(torch.linalg.eigvalsh(Rm.T @ Rm)[-1],
                                       min=0.0)))
    print(f"lsq rsvd lanes: values within {ds:.3e} (limit "
          f"{LSQ_RSVD_S_RTOL}), left subspaces {sin:.3e} apart (limit "
          f"{LSQ_RSVD_U_SIN})", flush=True)
    if not (ds <= LSQ_RSVD_S_RTOL and sin <= LSQ_RSVD_U_SIN):
        raise AssertionError(f"rsvd lanes: values {ds:.3e}, subspaces "
                             f"{sin:.3e} apart")
    return {"s_rel": ds, "u_sin": sin}


def _lsq_svds(nx, impl, device):
    """(b) svds, k = LSQ_K, on Poisson at ``LSQ_SVDS_NX``^2: LOBPCG in
    float64 on the Gram operator of the float32 operator (K1 on the
    kernel lane; each application ``A(v.float()).double()``), from a seeded
    float64 Gaussian start, against the closed form of the largest
    eigenvalues (1e-5 relative) and certified.  (LOBPCG in float32 on this
    Gram operator diverges from most starts at 31^2, in both packages:
    ROADMAP.md C.)"""
    import torch
    from krypy_tpu_torch import eigen, functional as F, ops

    A = ops.poisson_2d(nx, impl=impl, device=device)

    def op(v):
        return A(v.float()).double()

    op.device = device
    gen = torch.Generator(device=device).manual_seed(LSQ_SEED)
    X0 = torch.randn(nx * nx, LSQ_K, generator=gen, device=device,
                     dtype=torch.float64)
    r, launches, wall = _lsq_run(
        f"lsq svds {impl}@{nx}", lambda: F.svds(
            op, Ah=op, X0=X0, tol=LSQ_SVDS_TOL, maxiter=LSQ_SVDS_MAXITER))
    want = np.array([v for v, _, _ in eigen.poisson_eigenvalues(
        nx, LSQ_K, largest=True)])
    s = r.s.double().cpu().numpy()
    err = float(np.max(np.abs(s - want) / want))
    rec = {"niter": int(r.niter), "status": int(r.status), "err": err,
           "pair_resnorms": r.pair_resnorms.cpu().tolist(), "wall_s": wall,
           "launches": launches}
    print(f"lsq svds {impl}@{nx}: {int(r.niter)} iterations, status "
          f"{int(r.status)}, closed form within {err:.3e}", flush=True)
    if int(r.status) != 0 or not err <= 1e-5:
        raise AssertionError(f"svds {impl}: status {int(r.status)}, "
                             f"closed-form error {err:.3e}")
    if impl == "cuda" and not launches.get("stencil5_affine"):
        raise AssertionError("svds: K1 never launched")
    return rec


def _lsq_hutchpp(nx, impl, device):
    """(c) Hutch++ of Poisson, float32 through K1: its trace is N 4/h^2,
    gated within ``LSQ_HUTCH_SIGMAS`` standard errors."""
    from krypy_tpu_torch import functional as F, ops

    A = ops.poisson_2d(nx, impl=impl, device=device)
    N = nx * nx
    (est, se), launches, wall = _lsq_run(
        f"lsq hutchpp {impl}@{nx}", lambda: F.hutchpp(
            A, LSQ_SEED, n=N, k=LSQ_HUTCH_K, n_probes=LSQ_HUTCH_PROBES))
    true = N * 4.0 * (nx + 1) ** 2
    z = (float(est) - true) / float(se)
    rec = {"estimate": float(est), "trace": true, "stderr": float(se),
           "z": z, "wall_s": wall, "launches": launches}
    print(f"lsq hutchpp {impl}@{nx}: {float(est):.10e} against {true:.10e}, "
          f"{z:+.2f} standard errors ({float(se):.3e})", flush=True)
    if not abs(z) <= LSQ_HUTCH_SIGMAS:
        raise AssertionError(f"hutchpp {impl}: {z:+.2f} standard errors")
    return rec


def _lsq_nystrom(nx, impl, device):
    """(d) the Nystrom preconditioner of Poisson (rank ``LSQ_NYS_RANK``,
    float32 through K1) as ``M`` of ``cg`` on Poisson + mu I, beside plain
    CG: both converged, their true residuals recomputed in float64 within
    10 tol, the counts recorded.  On Poisson the preconditioner is the
    identity but for the spread of its top values (a few 1e-3 of its
    action at 1023^2: Poisson's top spectrum is flat), so no count can
    fall (ROADMAP.md C); its build is held instead to its float64 build
    from the same sketch on the plain stencil: the values within
    ``LSQ_NYS_LAM_RTOL`` and P^-1 on the float64 build's range within
    ``LSQ_NYS_APPLY_RTOL`` of the part of its action beyond the
    identity."""
    import torch
    from krypy_tpu_torch import functional as F, ops
    from krypy_tpu_torch.functional import randomized

    A = ops.poisson_2d(nx, impl=impl, device=device)
    A64 = ops.poisson_2d(nx, device=device)
    N = nx * nx
    mu = LSQ_NYS_MU * 8.0 * (nx + 1) ** 2
    b = torch.ones(N, device=device)
    (P, (_, lam)), launches, wall = _lsq_run(
        f"lsq nystrom build {impl}@{nx}", lambda: F.nystrom_preconditioner(
            A, LSQ_NYS_RANK, N, mu=mu, seed=LSQ_SEED, return_factors=True))
    # the float64 build from the same draw (nystrom_preconditioner's p=10)
    Om = randomized._gaussian(
        torch.Generator(device=device).manual_seed(LSQ_SEED),
        (N, LSQ_NYS_RANK + 10), torch.float32, device)
    P64, (U64, lam64) = randomized._nystrom_core(
        A64, LSQ_NYS_RANK, Om.double(), mu, return_factors=True)
    del Om
    dlam = float(torch.max(torch.abs(lam.double() - lam64) / lam64))
    x = U64 @ torch.randn(LSQ_NYS_RANK, generator=torch.Generator(
        device=device).manual_seed(LSQ_SEED + 1), dtype=torch.float64,
        device=device)
    y64 = P64(x)
    beyond = float(torch.linalg.vector_norm(y64 - x))
    apply = float(torch.linalg.vector_norm(P(x.float()).double() - y64)) \
        / beyond
    del U64, x, y64
    rec = {"mu": mu, "build_s": wall, "build_launches": launches,
           "launches": dict(launches), "lam_rel": dlam,
           "apply_rel": apply, "beyond_identity": beyond}
    print(f"lsq nystrom {impl}@{nx}: values within {dlam:.3e} of the "
          f"float64 build (limit {LSQ_NYS_LAM_RTOL}), P^-1 on its range "
          f"within {apply:.3e} of its action beyond the identity (limit "
          f"{LSQ_NYS_APPLY_RTOL}; that action {beyond:.3e} of a unit "
          f"vector)", flush=True)
    if not (dlam <= LSQ_NYS_LAM_RTOL and apply <= LSQ_NYS_APPLY_RTOL):
        raise AssertionError(f"nystrom {impl}: values {dlam:.3e}, action "
                             f"{apply:.3e} off the float64 build")
    for name, M in (("plain", None), ("nystrom", P)):
        r, used, t = _lsq_run(
            f"lsq cg {name} {impl}@{nx}", lambda: F.cg(
                lambda v: A(v) + mu * v, b, M=M, tol=LSQ_NYS_TOL,
                maxiter=5000))
        x = r.x.double()
        rel = float(torch.linalg.vector_norm(b.double() - A64(x) - mu * x)
                    / math.sqrt(N))
        rec[name] = {"niter": int(r.niter), "status": int(r.status),
                     "true_rel": rel, "wall_s": t, "launches": used}
        for k, c in used.items():
            rec["launches"][k] = rec["launches"].get(k, 0) + c
        print(f"lsq cg {name} {impl}@{nx}: {int(r.niter)} iterations, "
              f"status {int(r.status)}, true residual {rel:.3e}", flush=True)
        if int(r.status) != 0 or not rel <= 10 * LSQ_NYS_TOL:
            raise AssertionError(f"cg {name} {impl}: status "
                                 f"{int(r.status)}, true residual {rel:.3e}")
    return rec


def lsq_phase(device):
    """The least-squares and randomized lane (``--only lsq``), float32
    through K1 on the kernel lane (``impl="cuda"``) and the plain stencil
    on the plain lane: (a) ``lsqr`` and ``lsmr`` on the north star's
    operator at ``LSQ_NX``^2 with ``Ah = northstar.cd_transpose`` (the
    lanes' counts within ``LSQ_LANE_SLACK``); (b) ``rsvd`` (k = 6) on
    bench.py's Poisson operator at ``LSQ_NX``^2 (the lanes against each
    other, :func:`_lsq_rsvd_lanes`), ``svds`` (k = 6) at
    ``LSQ_SVDS_NX``^2 (``reduced_from``); (c) ``hutchpp`` of Poisson at
    ``LSQ_NX``^2; (d) ``nystrom_preconditioner`` as ``M`` of ``cg`` on
    Poisson + mu I at ``LSQ_NX``^2.  Each run's K1 launches are counted
    (zeroed just before, read just after).  Prints one JSON line and
    returns it."""
    import torch

    t0 = time.perf_counter()
    record = {"device": _smi(), "nx": LSQ_NX,
              "reduced_from": {"svds": {"nx": LSQ_SVDS_NX, "from": LSQ_NX}},
              "runs": {}, "launches": {}}
    failed = []
    kept = {}

    def attempt(key, fn, *args):
        t = time.perf_counter()
        try:
            rec = fn(*args)
            record["runs"][key] = rec
            if " cuda@" in key:
                record["launches"][key] = rec["launches"]
            return rec
        except AssertionError as exc:
            failed.append(f"{key}: {exc}")
        finally:
            torch.cuda.empty_cache()
            print(f"lsq {key}: {time.perf_counter() - t:.1f} s", flush=True)

    runs = {}
    for impl in ("cuda", "torch"):
        for solver in ("lsqr", "lsmr"):
            runs[solver, impl] = attempt(f"{solver} {impl}@{LSQ_NX}",
                                         _lsq_solve, solver, LSQ_NX, impl,
                                         device)
        attempt(f"rsvd {impl}@{LSQ_NX}", _lsq_rsvd, LSQ_NX, impl, device,
                kept)
        attempt(f"svds {impl}@{LSQ_SVDS_NX}", _lsq_svds, LSQ_SVDS_NX, impl,
                device)
        attempt(f"hutchpp {impl}@{LSQ_NX}", _lsq_hutchpp, LSQ_NX, impl,
                device)
        attempt(f"nystrom {impl}@{LSQ_NX}", _lsq_nystrom, LSQ_NX, impl,
                device)
    if len(kept) == 2:
        try:
            record["rsvd_lanes"] = _lsq_rsvd_lanes(kept)
        except AssertionError as exc:
            failed.append(str(exc))
    del kept
    for solver in ("lsqr", "lsmr"):
        k, t = runs.get((solver, "cuda")), runs.get((solver, "torch"))
        if k and t:
            gap = abs(k["niter"] - t["niter"])
            print(f"lsq {solver}: lanes {k['niter']} / {t['niter']} "
                  f"iterations (limit {LSQ_LANE_SLACK} apart)", flush=True)
            if gap > LSQ_LANE_SLACK:
                failed.append(f"{solver}: the lanes' counts {k['niter']} "
                              f"and {t['niter']} differ by {gap}")
    record["phase_s"] = time.perf_counter() - t0
    record["failed"] = failed
    print(json.dumps({"lsq": record}, default=str), flush=True)
    if failed:
        raise AssertionError("lsq phase: " + "; ".join(failed))
    return record


#: the shifted phase: the Arnoldi relations (20 steps) on the north star's
#: operator (cgs2, cgs2_1r) and bench.py's Poisson (lanczos) at 4095^2,
#: float32 through K1, gated in float64 on ||AV_k - V_{k+1} H|| / ||A||
#: and ||V^H V - I||_2.  Orthogonality of the two-pass schemes: m sqrt(N)
#: u (u = 2^-24), the float32 inner products' rounding over N terms, 4.9e-3
#: at 4095^2 (read on the H100: cgs2 3.5e-5, cgs2_1r 3.2e-4, whose
#: Pythagorean norm loses most); Lanczos never reorthogonalizes: 1e-2
#: (read 3.8e-4-4.2e-4); relations: two-pass 1e-5 (read 1.3e-7-1.7e-7),
#: Lanczos on Poisson's lambda_max ~1.3e8, 1e-3 (read 6.4e-5-7.5e-5)
SH_NX = NS_NX
SH_ARNOLDI_STEPS = 20
SH_RELATION_LIMIT = {"cgs2": 1e-5, "cgs2_1r": 1e-5, "lanczos": 1e-3}
SH_ORTHO_LIMIT = {"cgs2": 5e-3, "cgs2_1r": 5e-3, "lanczos": 1e-2}
#: multi-shift CG on Poisson: 8 shifts lambda_max x 1e-2 ... 1e-1 (each
#: member's kappa <= ~100, whose float32 floor lies below tol), tol 1e-4;
#: shifted_gmres (one cycle of SH_GMRES_M) and restarted_shifted_gmres
#: (GMRES(SH_RESTART_M)) on the north star's operator, real shifts 0.1 ..
#: 1 (and 0.01 for the restarted seed), tol 1e-5; each member's true
#: relative residual recomputed in float64 within 2 tol
SH_CG_SHIFTS = tuple(np.geomspace(1e-2, 1e-1, 8))
SH_CG_TOL, SH_GMRES_TOL = 1e-4, 1e-5
SH_GMRES_SHIFTS = tuple(np.geomspace(0.1, 1.0, 8))
SH_RESTART_SHIFTS = (0.01,) + SH_GMRES_SHIFTS[1:]
SH_GMRES_M, SH_RESTART_M, SH_RESTARTS = 60, 20, 20
SH_TRUE_FACTOR = 2.0


def _sh_operators(kind, nx, impl, device):
    """``(A, A64, norm, b)``: the float32 operator on the lane, its float64
    plain twin, ``||A||_2`` (Poisson's closed form; the north star's
    Gershgorin bound) and the right-hand side (ones; padded for the north
    star)."""
    import torch
    from krypy_tpu_torch import ops

    if kind == "poisson":
        return (ops.poisson_2d(nx, impl=impl, device=device),
                ops.poisson_2d(nx, impl="torch", device=device),
                8.0 * (nx + 1) ** 2, torch.ones(nx * nx, device=device))
    h2 = 1.0 / (nx + 1) ** 2
    kw = dict(wind=(h2, 0.5 * h2), eps=h2, pad_cols=True, device=device)
    return (ops.convection_diffusion_2d(nx, impl=impl, **kw),
            ops.convection_diffusion_2d(nx, impl="torch", **kw),
            8.0 + 1.5 / (nx + 1),
            ops.pad_grid_vec(torch.ones(nx * nx, device=device), nx, nx))


def _sh_arnoldi(ortho, nx, impl, device):
    """The Arnoldi relation of ``SH_ARNOLDI_STEPS`` steps, its residual and
    the basis's orthogonality computed in float64."""
    import torch
    from krypy_tpu_torch import functional as F

    kind = "poisson" if ortho == "lanczos" else "northstar"
    A, A64, norm, b = _sh_operators(kind, nx, impl, device)
    rel, launches, wall = _lsq_run(
        f"shifted arnoldi {ortho} {impl}@{nx}", lambda: F.arnoldi(
            A, b, maxiter=SH_ARNOLDI_STEPS, ortho=ortho))
    n = int(rel.niter)
    V = rel.V[: n + 1].double()
    H = rel.H[: n + 1, :n].double()
    AV = torch.stack([A64(v) for v in V[:n]])
    relation = float(torch.linalg.matrix_norm(AV - H.T @ V)) / norm
    ortho_err = float(torch.linalg.matrix_norm(
        V @ V.T - torch.eye(n + 1, dtype=torch.float64, device=device), 2))
    del V, AV
    rec = {"niter": n, "relation": relation, "orthogonality": ortho_err,
           "H_diag": torch.diagonal(H).cpu().tolist(), "wall_s": wall,
           "launches": launches}
    print(f"shifted arnoldi {ortho} {impl}@{nx}: {n} steps, ||AV - VH|| / "
          f"||A|| {relation:.3e} (limit {SH_RELATION_LIMIT[ortho]}), "
          f"||V^H V - I|| {ortho_err:.3e} (limit {SH_ORTHO_LIMIT[ortho]})",
          flush=True)
    if not relation <= SH_RELATION_LIMIT[ortho]:
        raise AssertionError(f"arnoldi {ortho} {impl}: relation "
                             f"{relation:.3e}")
    if not ortho_err <= SH_ORTHO_LIMIT[ortho]:
        raise AssertionError(f"arnoldi {ortho} {impl}: orthogonality "
                             f"{ortho_err:.3e}")
    if impl == "cuda" and launches.get("stencil5_affine", 0) < n:
        raise AssertionError(f"arnoldi {ortho}: {launches} for {n} steps")
    return rec


def _sh_members(label, r, A64, b, shifts, tol):
    """Every member's true relative residual, recomputed in float64, within
    ``SH_TRUE_FACTOR`` tol, and every status CONVERGED."""
    import torch

    b64 = b.double()
    bn = float(torch.linalg.vector_norm(b64))
    rel = []
    for x, s in zip(r.X, shifts):
        x = x.double()
        rel.append(float(torch.linalg.vector_norm(b64 - A64(x) - s * x)) / bn)
    status = r.status.cpu().tolist()
    print(f"{label}: {int(r.niter)} iterations, statuses {status}, true "
          f"residuals max {max(rel):.3e} (limit {SH_TRUE_FACTOR * tol:.1e})",
          flush=True)
    if any(status) or not max(rel) <= SH_TRUE_FACTOR * tol:
        raise AssertionError(f"{label}: statuses {status}, true residuals "
                             f"{rel}")
    return {"niter": int(r.niter), "status": status, "true_rel": rel}


def _sh_cg(variant, nx, impl, device):
    """Multi-shift CG on Poisson through K1, 8 shifts > 0."""
    from krypy_tpu_torch import functional as F

    A, A64, norm, b = _sh_operators("poisson", nx, impl, device)
    shifts = [norm * s for s in SH_CG_SHIFTS]
    busy = {}
    r, launches, wall = _lsq_run(
        f"shifted shifted_cg {variant} {impl}@{nx}", lambda: F.shifted_cg(
            A, b, shifts, tol=SH_CG_TOL, maxiter=3000, variant=variant), busy)
    rec = _sh_members(f"shifted cg {variant} {impl}@{nx}", r, A64, b,
                      shifts, SH_CG_TOL)
    # one K1 per iteration, one per member's final residual (and 1r's s_0)
    want = int(r.niter) + len(shifts) + (variant == "1r")
    if impl == "cuda" and launches.get("stencil5_affine") != want:
        raise AssertionError(f"shifted cg {variant}: {launches}, expected "
                             f"{want} K1 launches")
    return dict(rec, wall_s=wall, launches=launches, shifts=shifts,
                busy=busy or None)


def _sh_gmres(restarted, nx, impl, device):
    """shifted_gmres (one cycle) or restarted_shifted_gmres on the north
    star's operator through K1, real shifts."""
    from krypy_tpu_torch import functional as F

    import torch

    A, A64, _, b = _sh_operators("northstar", nx, impl, device)
    # float32 shifts: a float64 one would promote the family (and the
    # restarted basis build, off K1) to float64
    if restarted:
        shifts = torch.tensor(SH_RESTART_SHIFTS, dtype=torch.float32,
                              device=device)
        run = lambda: F.restarted_shifted_gmres(
            A, b, shifts, maxiter=SH_RESTART_M, max_restarts=SH_RESTARTS,
            tol=SH_GMRES_TOL)
    else:
        shifts = torch.tensor(SH_GMRES_SHIFTS, dtype=torch.float32,
                              device=device)
        run = lambda: F.shifted_gmres(A, b, shifts, maxiter=SH_GMRES_M,
                                      tol=SH_GMRES_TOL)
    name = "restarted_shifted_gmres" if restarted else "shifted_gmres"
    r, launches, wall = _lsq_run(f"shifted {name} {impl}@{nx}", run)
    rec = _sh_members(f"shifted {name} {impl}@{nx}", r, A64, b,
                      shifts.tolist(), SH_GMRES_TOL)
    return dict(rec, wall_s=wall, launches=launches, shifts=shifts.tolist())


def shifted_phase(device):
    """The Arnoldi and multi-shift lane (``--only shifted``), float32
    through K1 on the kernel lane and the plain stencil on the plain lane,
    at ``SH_NX``^2: (a) ``arnoldi`` on the north star's operator with
    ``cgs2`` and ``cgs2_1r`` and ``lanczos`` on bench.py's Poisson, gated
    on the relation and the orthogonality in float64; (b) ``shifted_cg``
    (``classic`` and ``1r``) on Poisson with 8 shifts; (c)
    ``shifted_gmres`` and ``restarted_shifted_gmres`` on the north star's
    operator with real shifts; (b) and (c) gated on each member's true
    relative residual, recomputed.  Launches counted per run.  Prints one
    JSON line and returns it."""
    import torch

    t0 = time.perf_counter()
    nx = SH_NX
    record = {"device": _smi(), "nx": nx, "runs": {}, "launches": {}}
    failed = []

    def attempt(key, fn, *args):
        t = time.perf_counter()
        try:
            rec = fn(*args)
            record["runs"][key] = rec
            if " cuda@" in key:
                record["launches"][key] = rec["launches"]
        except AssertionError as exc:
            failed.append(f"{key}: {exc}")
        finally:
            torch.cuda.empty_cache()
            print(f"shifted {key}: {time.perf_counter() - t:.1f} s",
                  flush=True)

    for impl in ("cuda", "torch"):
        for ortho in ("cgs2", "cgs2_1r", "lanczos"):
            attempt(f"arnoldi {ortho} {impl}@{nx}", _sh_arnoldi, ortho, nx,
                    impl, device)
        for variant in ("classic", "1r"):
            attempt(f"cg {variant} {impl}@{nx}", _sh_cg, variant, nx, impl,
                    device)
        attempt(f"shifted_gmres {impl}@{nx}", _sh_gmres, False, nx, impl,
                device)
        attempt(f"restarted_shifted_gmres {impl}@{nx}", _sh_gmres, True, nx,
                impl, device)
    record["phase_s"] = time.perf_counter() - t0
    record["failed"] = failed
    print(json.dumps({"shifted": record}, default=str), flush=True)
    if failed:
        raise AssertionError("shifted phase: " + "; ".join(failed))
    return record


#: the funm phase (``--only funm``): the Chebyshev, matrix-function, block
#: and sketched lanes at the north star's grid, float32 through K1-K3 on
#: the kernel lane and the plain stencil on the plain lane.  Operators:
#: bench.py's padded Poisson with its padded V-cycle (Chebyshev, block CG),
#: the unpadded Poisson through K1 (the Hermitian matrix functions: a
#: padded probe would add the pad columns' null space to SLQ's quadrature),
#: the north star's padded h^2-scaled operator with its scaled V-cycle
#: (Arnoldi expm, block GMRES, the sketched lane).  Solves gated on a
#: residual use a right-hand side b = A x* of a seeded random x*: with a
#: smooth b the float32 iterate's own rounding, amplified by the
#: operator's lambda_max, puts the float64 residual near 0.1 at 4095^2
#: (ROADMAP.md C); block CG's columns (ones, random, a sine mode,
#: linspace) are gated on the normwise backward error ||b - A x|| /
#: (||A|| ||x|| + ||b||) instead, block GMRES's (ones, random) too
FUNM_NX = NS_NX
#: (b) runs at bench.py's grid: plain float32 CG at 4095^2 (kappa ~7e6)
#: is no useful yardstick
FUNM_PREC_NX = NX
FUNM_SEED = 17
FUNM_CHEB = dict(tol=1e-5, check_every=8, maxiter=400)
FUNM_BOUND_STEPS = 24
FUNM_PREC_DEGREE, FUNM_PREC_TOL, FUNM_PREC_MAXITER = 8, 1e-3, 6000
#: exp(-t A) b with t lambda_max = FUNM_EXPM_TLAM; Lanczos dimension of
#: the Hermitian matrix functions and SLQ; inv_sqrt's tolerance (its
#: shifted CG runs to tol/10) and iteration cap: the members of the
#: smallest shifts (kappa ~6.5e6) converge at ~1.2e-3 per float32
#: iteration, and their float32 floor leaves the closed form 6.7e-3 away
#: after 8354 iterations (51.7 s a lane; 0.138 at 1500, 2.4e-2 at 3000:
#: on the H100, ROADMAP.md C); SLQ's probes and gate
FUNM_EXPM_TLAM, FUNM_MAXDIM = 20.0, 30
FUNM_ISQRT_TOL, FUNM_ISQRT_MAXITER = 1e-4, 3000
FUNM_SLQ_PROBES, FUNM_SLQ_SE = 16, 5.0
#: Arnoldi exp(t A) b on the north star's scaled operator (lambda_max ~8)
FUNM_ARN_T = -1.0
#: block CG's rank floor: float32's Gram noise (~sqrt(eps) of lambda_max
#: for directions the V-cycle makes nearly dependent) kept at the default
#: 1e-12 costs 2 steps at 4095^2 (11 against the single columns' worst 9;
#: 1e-6: 10; 1e-4: 9 on the H100, ROADMAP.md C)
FUNM_BLOCK_TOL, FUNM_BLOCK_MAXITER, FUNM_BLOCK_FLOOR = 1e-5, 100, 1e-4
FUNM_BGM_TOL, FUNM_BGM_MAXITER = 1e-5, 40
FUNM_SGM = dict(tol=1e-4, maxiter=40, k_ortho=2)
FUNM_SGM_RESTARTS, FUNM_SGM_CYCLE = 8, 2
FUNM_SEIG = dict(k=4, maxiter=80, which="lm")
#: gate limits, each above the sound reading and below the planted
#: fault's (``--funm-faults``; PERF.md lists both): the closed forms
#: (relative 2-norm), the Arnoldi expm against its float64 run and the
#: lanes against each other, the lanes' iteration counts, sketched_eigs'
#: reported residual against the recomputed one (relative), its lanes'
#: values (relative) and the slack of the spectrum's range (relative)
FUNM_EXPM_RTOL, FUNM_ISQRT_RTOL = 1e-4, 5e-2
FUNM_ARN_F64_RTOL, FUNM_ARN_LANE_RTOL = 1e-4, 1e-4
FUNM_LANE_SLACK = 1
FUNM_SEIG_RES_RTOL, FUNM_SEIG_THETA_RTOL, FUNM_SEIG_RANGE = 1e-2, 1e-4, 1e-4


def _funm_gate(gates, name, reading, limit, fault=None, above=False,
               phase="funm"):
    """Record one gate: ``reading`` must be at or below ``limit`` (at or
    above it, ``above``); ``fault`` is the reading of the planted fault
    (``--funm-faults``), which must fail the gate; ``phase`` labels the
    printed line.  Returns the failure message or None."""
    ok = reading >= limit if above else reading <= limit
    caught = None if fault is None else not (
        fault >= limit if above else fault <= limit)
    gates[name] = dict(reading=reading, limit=limit, fault=fault,
                       fault_caught=caught)
    print(f"{phase} gate {name}: {reading!r} ({'>=' if above else '<='} "
          f"{limit!r}: {'ok' if ok else 'FAILED'})"
          + ("" if fault is None else
             f"; planted fault {fault!r} ({'caught' if caught else 'MISSED'})"),
          flush=True)
    if not ok:
        return f"{name}: {reading!r} against {limit!r}"
    if caught is False:
        return f"{name}: the planted fault {fault!r} passes {limit!r}"
    return None


def _funm_poisson(nx, impl, device, padded=True):
    """bench.py's Poisson (padded, with its padded V-cycle) or the
    unpadded one through K1, float32, and its float64 plain twin
    (unpadded)."""
    from krypy_tpu_torch import ops

    A64 = ops.poisson_2d(nx, device=device)
    if not padded:
        return ops.poisson_2d(nx, impl=impl, device=device), None, A64
    A = ops.poisson_2d(nx, pad_cols=True, impl=impl, device=device)
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
        device=device)
    return A, M, A64


def _funm_northstar(nx, impl, device):
    """The north star's padded h^2-scaled float32 operator, its scaled
    padded V-cycle, and the operator's float64 plain twin (padded)."""
    from krypy_tpu_torch import ops

    h2 = 1.0 / (nx + 1) ** 2
    kw = dict(wind=(h2, 0.5 * h2), eps=h2, pad_cols=True, device=device)
    A = ops.convection_diffusion_2d(nx, impl=impl, **kw)
    A64 = ops.convection_diffusion_2d(nx, impl="torch", **kw)
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
        scale=1.0 / h2, device=device)
    return A, M, A64


def _funm_rough_rhs(nx, A64, device, padded, seed=FUNM_SEED):
    """``b = A x*`` in float64 for a seeded random ``x*`` (padded with
    zeros where the operator is), as float32."""
    import torch
    from krypy_tpu_torch import ops

    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        nx * nx)).to(device)
    if padded:
        x = ops.pad_grid_vec(x, nx, nx)
    return A64(x).float()


def _funm_counted(A, M=None):
    """``A`` and ``M`` wrapped to count their applications."""
    from krypy_tpu_torch import eigen

    counts = {"A": 0, "M": 0}
    out = eigen._counted(A, counts, "A")
    for attr in ("shape", "diag"):
        if hasattr(A, attr):
            setattr(out, attr, getattr(A, attr))
    return out, None if M is None else eigen._counted(M, counts, "M"), \
        counts


def _funm_identity(label, launches, impl, nlev, counts, phase="funm"):
    """The kernel lane's K1-K3 launches against the counted applications
    (one K1 per operator application, a V-cycle's per application of
    ``M``); the plain lane launches nothing."""
    if impl != "cuda":
        if launches:
            raise AssertionError(f"{phase} {label}: the plain lane launched "
                                 f"{launches}")
        return
    _eigen_identity(label, launches, nlev, k1=counts["A"],
                    vcycles=counts["M"], phase=phase)


def _funm_eta(A64, b, x, norm_a):
    """Per column: the float64 relative residual and the normwise
    backward error ``||b - A x|| / (||A|| ||x|| + ||b||)``."""
    import torch

    rel, eta = [], []
    for j in range(b.shape[1]):
        bj, xj = b[:, j].double(), x[:, j].double()
        r = float(torch.linalg.vector_norm(bj - A64(xj)))
        nb = float(torch.linalg.vector_norm(bj))
        rel.append(r / nb)
        eta.append(r / (norm_a * float(torch.linalg.vector_norm(xj)) + nb))
    return rel, eta


def _funm_true_rel(A64, b, x):
    import torch

    b64 = b.double()
    return float(torch.linalg.vector_norm(b64 - A64(x.double()))
                 / torch.linalg.vector_norm(b64))


def _funm_cheb(nx, impl, device, faults):
    """(a) Chebyshev on bench.py's Poisson with the padded V-cycle,
    bounds from ``spectral_bounds`` (24 steps on M A)."""
    from krypy_tpu_torch import functional as F, ops

    A, M, A64 = _funm_poisson(nx, impl, device)
    nlev = _eigen_vcycle_levels(nx, device)
    b = _funm_rough_rhs(nx, lambda v: ops.pad_grid_vec(A64(
        ops.unpad_grid_vec(v, nx, nx)), nx, nx), device, True)
    Ac, Mc, counts = _funm_counted(A, M)

    def run():
        lo, hi = F.spectral_bounds(Ac, b, M=Mc, steps=FUNM_BOUND_STEPS)
        return lo, hi, F.chebyshev(Ac, b, M=Mc, lmin=lo, lmax=hi,
                                   **FUNM_CHEB)

    (lo, hi, r), launches, wall = _lsq_run(f"funm chebyshev {impl}@{nx}",
                                           run)
    _funm_identity("chebyshev", launches, impl, nlev, counts)
    ce = FUNM_CHEB["check_every"]
    blocks = int(r.niter) // ce
    want = {"A": FUNM_BOUND_STEPS + 1 + blocks * (ce + 1),
            "M": FUNM_BOUND_STEPS + 1 + blocks * ce}
    if counts != want:
        raise AssertionError(f"funm chebyshev: applications {counts}, the "
                             f"recurrence makes {want}")
    unpad = lambda v: ops.unpad_grid_vec(v, nx, nx)  # noqa: E731
    rel = _funm_true_rel(A64, unpad(b), unpad(r.x))
    gates, fail = {}, []
    fault = None
    if faults:
        # the iterate one check block short of the solve's
        short = F.chebyshev(A, b, M=M, lmin=lo, lmax=hi, **dict(
            FUNM_CHEB, maxiter=int(r.niter) - ce))
        fault = _funm_true_rel(A64, unpad(b), unpad(short.x))
    fail.append(_funm_gate(gates, f"chebyshev true residual {impl}", rel,
                           FUNM_CHEB["tol"], fault))
    if int(r.status) != 0:
        fail.append(f"chebyshev status {int(r.status)}")
    rec = dict(lmin=lo, lmax=hi, niter=int(r.niter), status=int(r.status),
               true_rel=rel, resnorms=r.resnorms[: blocks + 1].tolist(),
               applications=counts, launches=launches, wall_s=wall,
               gates=gates)
    if faults:
        # a wrong bound (lmin ten times too small): its count, for the
        # lanes' count gate
        slow = F.chebyshev(A, b, M=M, lmin=lo / 10, lmax=hi, **FUNM_CHEB)
        rec["fault_niter_lmin_over_10"] = int(slow.niter)
    return rec, [f for f in fail if f]


def _funm_prec(nx, impl, device, faults):
    """(b) ``ops.chebyshev_preconditioner`` (degree 8, ``lmin`` the closed
    form's, ``lmax`` from ``.diag``) as ``M`` of CG on bench.py's Poisson
    at 1023^2, seeded random b, against plain CG."""
    import torch
    from krypy_tpu_torch import eigen, functional as F, ops

    A = ops.poisson_2d(nx, pad_cols=True, impl=impl, device=device)
    lmin = eigen.poisson_eigenvalues(nx, 1)[0][0]
    b = ops.pad_grid_vec(torch.from_numpy(np.random.default_rng(
        FUNM_SEED).standard_normal(nx * nx, dtype=np.float32)).to(device),
        nx, nx)
    Ac, _, counts = _funm_counted(A)
    M = ops.chebyshev_preconditioner(Ac, degree=FUNM_PREC_DEGREE, lmin=lmin)
    kw = dict(tol=FUNM_PREC_TOL, maxiter=FUNM_PREC_MAXITER)
    plain, l_plain, w_plain = _lsq_run(f"funm cg {impl}@{nx}",
                                       lambda: F.cg(Ac, b, **kw))
    a_plain = dict(counts)
    counts.update(A=0)
    pre, l_pre, w_pre = _lsq_run(f"funm cg+chebyshev {impl}@{nx}",
                                 lambda: F.cg(Ac, b, M=M, **kw))
    _funm_identity("cg", l_plain, impl, 0, a_plain)
    _funm_identity("cg+chebyshev", l_pre, impl, 0, counts)
    gates, fail = {}, []
    fault = None
    if faults:
        # degree 1: the preconditioner r / theta, a scaled identity
        M1 = ops.chebyshev_preconditioner(A, degree=1, lmin=lmin)
        fault = int(F.cg(A, b, M=M1, **kw).niter) - int(plain.niter)
    fail.append(_funm_gate(gates, f"cg+chebyshev minus plain cg "
                           f"iterations {impl}", int(pre.niter)
                           - int(plain.niter), -1, fault))
    # (plain float32 CG on this kappa ~4e5 system with a random b stalls
    # short of tol: it is the yardstick, its count the cap)
    if int(pre.status) != 0:
        fail.append(f"cg+chebyshev status {int(pre.status)}")
    return dict(lmin=lmin, lmax=float(2.0 * torch.max(A.diag)),
                degree=FUNM_PREC_DEGREE, niter_plain=int(plain.niter),
                status_plain=int(plain.status),
                niter=int(pre.niter), applications=dict(
                    plain=a_plain["A"], preconditioned=counts["A"]),
                launches=l_pre, launches_plain_cg=l_plain, wall_s=w_pre,
                wall_plain_s=w_plain, gates=gates), [f for f in fail if f]


def _funm_dst(nx, b):
    """The orthonormal 2-D DST-I of ``b`` (Poisson's eigenbasis), float64
    on the host, and the eigenvalues in the same layout."""
    import scipy.fft

    h = 1.0 / (nx + 1)
    lam1 = 4.0 / h ** 2 * np.sin(np.arange(1, nx + 1) * np.pi * h / 2) ** 2
    B = scipy.fft.dstn(b.reshape(nx, nx), type=1, norm="ortho")
    return B, lam1[:, None] + lam1[None, :]


def _funm_closed(nx, x, want_hat):
    """``x`` (a tensor) against the closed form given by its DST
    coefficients, relative 2-norm, float64."""
    import scipy.fft

    want = scipy.fft.idstn(want_hat, type=1, norm="ortho").reshape(-1)
    got = x.double().cpu().numpy()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _funm_hermitian(nx, impl, device, faults):
    """(c) on the unpadded Poisson through K1, seeded random b:
    ``expm_multiply`` and ``inv_sqrt_multiply`` against their DST closed
    forms, ``slq_logdet`` against the exact sum."""
    import torch
    from krypy_tpu_torch import eigen, functional as F

    A, _, _ = _funm_poisson(nx, impl, device, padded=False)
    bh = np.random.default_rng(FUNM_SEED).standard_normal(
        nx * nx, dtype=np.float32)
    b = torch.from_numpy(bh).to(device)
    B, lam = _funm_dst(nx, bh.astype(np.float64))
    lmin = eigen.poisson_eigenvalues(nx, 1)[0][0]
    lmax = eigen.poisson_eigenvalues(nx, 1, largest=True)[0][0]
    t = FUNM_EXPM_TLAM / lmax
    recs, fail = {}, []

    Ac, _, counts = _funm_counted(A)
    gates = {}
    r, launches, wall = _lsq_run(f"funm expm_multiply {impl}@{nx}",
                                 lambda: F.expm_multiply(Ac, b, -t,
                                                         maxdim=FUNM_MAXDIM))
    _funm_identity("expm_multiply", launches, impl, 0, counts)
    err = _funm_closed(nx, r.x, np.exp(-t * lam) * B)
    fault = None
    if faults:
        # a Krylov space too small for the semigroup
        fault = _funm_closed(nx, F.expm_multiply(A, b, -t, maxdim=8).x,
                             np.exp(-t * lam) * B)
    fail.append(_funm_gate(gates, f"expm_multiply closed form {impl}", err,
                           FUNM_EXPM_RTOL, fault))
    recs["expm_multiply"] = dict(
        t=t, t_lambda_max=FUNM_EXPM_TLAM, m=r.m, rel_err=err,
        corrections=[c for c in r.corrections.tolist() if math.isfinite(c)],
        applications=dict(counts),
        launches=launches, wall_s=wall, gates=gates)

    counts.update(A=0)
    gates = {}
    (x, info), launches, wall = _lsq_run(
        f"funm inv_sqrt_multiply {impl}@{nx}", lambda: F.inv_sqrt_multiply(
            Ac, b, lmin=lmin, lmax=lmax, tol=FUNM_ISQRT_TOL,
            maxiter=FUNM_ISQRT_MAXITER))
    _funm_identity("inv_sqrt_multiply", launches, impl, 0, counts)
    want = B / np.sqrt(lam)
    err = _funm_closed(nx, x, want)
    fault = None
    if faults:
        # Lanczos with 30 steps instead of the quadrature: it cannot
        # resolve lambda^-1/2 over kappa ~7e6
        fault = _funm_closed(nx, F.funm_krylov(
            A, b, lambda w: 1.0 / torch.sqrt(w), maxdim=FUNM_MAXDIM).x, want)
    fail.append(_funm_gate(gates, f"inv_sqrt_multiply closed form {impl}",
                           err, FUNM_ISQRT_RTOL, fault))
    recs["inv_sqrt_multiply"] = dict(
        rel_err=err, inner_iters=int(info["inner_iters"]),
        shift_status=info["shift_status"].tolist(), lmin=lmin, lmax=lmax,
        applications=dict(counts), launches=launches, wall_s=wall,
        gates=gates)
    del x, info

    counts.update(A=0)
    gates = {}
    (est, se), launches, wall = _lsq_run(
        f"funm slq_logdet {impl}@{nx}", lambda: F.slq_logdet(
            Ac, FUNM_SEED, n_probes=FUNM_SLQ_PROBES, maxdim=FUNM_MAXDIM))
    _funm_identity("slq_logdet", launches, impl, 0, counts)
    exact = float(np.sum(np.log(lam)))
    est, se = float(est), float(se)
    dev = abs(est - exact) / se
    fault = None
    if faults:
        # the estimate of log det(1.01 A): N log 1.01 off
        fault = abs(est + lam.size * math.log(1.01) - exact) / se
    fail.append(_funm_gate(gates, f"slq_logdet standard errors {impl}", dev,
                           FUNM_SLQ_SE, fault))
    recs["slq_logdet"] = dict(estimate=est, stderr=se, exact=exact,
                              deviation_in_stderr=dev,
                              applications=dict(counts), launches=launches,
                              wall_s=wall, gates=gates)
    return recs, [f for f in fail if f]


def _funm_arnoldi(nx, impl, device, ref, faults):
    """(c) ``expm_multiply(hermitian=False)`` on the north star's operator
    (seeded random padded b), against its float64 run on the plain
    stencil (``ref``, computed once and shared by the lanes)."""
    import torch
    from krypy_tpu_torch import functional as F, ops

    A, _, A64 = _funm_northstar(nx, impl, device)
    b = ops.pad_grid_vec(torch.from_numpy(np.random.default_rng(
        FUNM_SEED + 1).standard_normal(nx * nx, dtype=np.float32)).to(
        device), nx, nx)
    if "x64" not in ref:
        ref["x64"] = F.expm_multiply(A64, b.double(), FUNM_ARN_T,
                                     hermitian=False, maxdim=FUNM_MAXDIM).x
    Ac, _, counts = _funm_counted(A)
    r, launches, wall = _lsq_run(
        f"funm expm_multiply arnoldi {impl}@{nx}", lambda: F.expm_multiply(
            Ac, b, FUNM_ARN_T, hermitian=False, maxdim=FUNM_MAXDIM))
    _funm_identity("expm_multiply arnoldi", launches, impl, 0, counts)
    x64 = ref["x64"]
    err = float(torch.linalg.vector_norm(r.x.double() - x64)
                / torch.linalg.vector_norm(x64))
    gates, fail = {}, []
    fault = None
    if faults:
        small = F.expm_multiply(A, b, FUNM_ARN_T, hermitian=False, maxdim=8)
        fault = float(torch.linalg.vector_norm(small.x.double() - x64)
                      / torch.linalg.vector_norm(x64))
    fail.append(_funm_gate(gates, f"expm arnoldi against float64 {impl}",
                           err, FUNM_ARN_F64_RTOL, fault))
    ref[impl] = r.x.double()
    return dict(t=FUNM_ARN_T, m=r.m, rel_err_float64=err,
                corrections=[c for c in r.corrections.tolist()
                             if math.isfinite(c)], applications=counts,
                launches=launches, wall_s=wall, gates=gates), \
        [f for f in fail if f]


def _funm_block_cg(nx, impl, device, faults):
    """(d) ``block_cg`` on bench.py's Poisson with the padded V-cycle,
    four right-hand sides (ones, seeded random, the (1, 2) sine mode,
    linspace), against ``block_cg`` on each column alone (single-vector
    CG with the same stopping rule)."""
    import torch
    from krypy_tpu_torch import functional as F, ops

    A, M, A64 = _funm_poisson(nx, impl, device)
    nlev = _eigen_vcycle_levels(nx, device)
    N = nx * nx
    g = np.arange(1, nx + 1) / (nx + 1)
    cols = [np.ones(N), np.random.default_rng(FUNM_SEED).standard_normal(N),
            np.outer(np.sin(np.pi * g), np.sin(2 * np.pi * g)).reshape(-1),
            np.linspace(0.0, 1.0, N)]
    B = torch.stack([ops.pad_grid_vec(torch.from_numpy(c.astype(np.float32))
                                      .to(device), nx, nx) for c in cols], 1)
    Ac, Mc, counts = _funm_counted(A, M)
    kw = dict(tol=FUNM_BLOCK_TOL, maxiter=FUNM_BLOCK_MAXITER,
              floor_ratio=FUNM_BLOCK_FLOOR)
    r, launches, wall = _lsq_run(f"funm block_cg {impl}@{nx}",
                                 lambda: F.block_cg(Ac, B, M=Mc, **kw))
    _funm_identity("block_cg", launches, impl, nlev, counts)
    k, it = B.shape[1], int(r.niter)
    if counts != {"A": k * (it + 1), "M": k * (it + 1)}:
        raise AssertionError(f"funm block_cg: applications {counts} for "
                             f"{it} steps of {k} columns")
    singles = [int(F.block_cg(A, B[:, j:j + 1], M=M, **kw).niter)
               for j in range(k)]
    unpad = lambda X: torch.stack([ops.unpad_grid_vec(X[:, j], nx, nx)  # noqa
                                   for j in range(X.shape[1])], 1)
    norm_a = 8.0 * (nx + 1) ** 2
    rel, eta = _funm_eta(A64, unpad(B), unpad(r.x), norm_a)
    gates, fail = {}, []
    fault_eta = fault_count = None
    if faults:
        # the columns' solutions swapped (0 <-> 1); a rank guard that
        # drops every direction (floor_ratio 1), capped past the singles
        swapped = r.x[:, [1, 0, 2, 3]]
        fault_eta = max(_funm_eta(A64, unpad(B), unpad(swapped), norm_a)[1])
        fault_count = int(F.block_cg(
            A, B, M=M, tol=FUNM_BLOCK_TOL, maxiter=max(singles) + 3,
            floor_ratio=1.0).niter) - max(singles)
    fail.append(_funm_gate(gates, f"block_cg backward error {impl}",
                           max(eta), FUNM_BLOCK_TOL, fault_eta))
    fail.append(_funm_gate(gates, f"block_cg steps minus worst single "
                           f"column {impl}", it - max(singles), 0,
                           fault_count))
    if int(r.status) != 0:
        fail.append(f"block_cg status {int(r.status)}")
    return dict(niter=it, status=int(r.status), singles=singles,
                true_rel=rel, backward_error=eta,
                resnorms_last=r.resnorms[it].tolist(), applications=counts,
                launches=launches, wall_s=wall, gates=gates), \
        [f for f in fail if f]


def _funm_block_gmres(nx, impl, device, faults):
    """(d) ``block_gmres`` on the north star's operator, k = 2 (ones and
    seeded random), ``Ml`` the scaled V-cycle."""
    import torch
    from krypy_tpu_torch import functional as F, ops

    A, M, A64 = _funm_northstar(nx, impl, device)
    nlev = _eigen_vcycle_levels(nx, device)
    N = nx * nx
    B = torch.stack([ops.pad_grid_vec(torch.from_numpy(c).to(device), nx, nx)
                     for c in (np.ones(N, np.float32),
                               np.random.default_rng(FUNM_SEED).standard_normal(
                                   N, dtype=np.float32))], 1)
    Ac, Mc, counts = _funm_counted(A, M)
    r, launches, wall = _lsq_run(
        f"funm block_gmres {impl}@{nx}", lambda: F.block_gmres(
            Ac, B, Ml=Mc, tol=FUNM_BGM_TOL, maxiter=FUNM_BGM_MAXITER))
    _funm_identity("block_gmres", launches, impl, nlev, counts)
    k, it = B.shape[1], int(r.niter)
    # Ml B, then Ml A per column of each step's panel
    if counts != {"A": k * it, "M": k * (it + 1)}:
        raise AssertionError(f"funm block_gmres: applications {counts} for "
                             f"{it} steps of {k} columns")
    norm_a = 8.0 + 1.5 / (nx + 1)
    rel, eta = _funm_eta(A64, B, r.x, norm_a)
    gates, fail = {}, []
    fault = None
    if faults:
        fault = max(_funm_eta(A64, B, r.x[:, [1, 0]], norm_a)[1])
    fail.append(_funm_gate(gates, f"block_gmres backward error {impl}",
                           max(eta), FUNM_BGM_TOL, fault))
    if int(r.status) != 0:
        fail.append(f"block_gmres status {int(r.status)}")
    return dict(niter=it, status=int(r.status), true_rel=rel,
                backward_error=eta, applications=counts, launches=launches,
                wall_s=wall, gates=gates), [f for f in fail if f]


def _funm_sketch(nx, impl, device, shared, faults):
    """(e) ``sketched_gmres`` and ``restarted_sketched_gmres`` (the V-cycle
    as the right preconditioner ``M``) on the north star's operator with
    ``b = A x*``, and ``sketched_eigs`` (k = 4, ``"lm"``), each on the one
    sketch ``shared`` holds for both lanes."""
    import torch
    from krypy_tpu_torch import eigen, functional as F, ops

    A, M, A64 = _funm_northstar(nx, impl, device)
    nlev = _eigen_vcycle_levels(nx, device)
    Np = A.shape[0]
    b = _funm_rough_rhs(nx, A64, device, True)
    if "gmres" not in shared:
        gen = torch.Generator(device=device).manual_seed(FUNM_SEED)
        shared["gmres"] = F.kron_sketch(
            Np, 8 * (FUNM_SGM["maxiter"] + 1), seed=gen)
        shared["eigs"] = F.kron_sketch(
            Np, 8 * (FUNM_SEIG["maxiter"] + 1), seed=gen)
    recs, fail = {}, []

    Ac, Mc, counts = _funm_counted(A, M)
    gates = {}
    r, launches, wall = _lsq_run(
        f"funm sketched_gmres {impl}@{nx}", lambda: F.sketched_gmres(
            Ac, b, M=Mc, sketch=shared["gmres"], **FUNM_SGM))
    _funm_identity("sketched_gmres", launches, impl, nlev, counts)
    it = int(r.niter)
    # one A M per iteration; r0; three assembled candidates' M and A
    if counts != {"A": it + 4, "M": it + 3}:
        raise AssertionError(f"funm sketched_gmres: applications {counts} "
                             f"for {it} iterations")
    rel = _funm_true_rel(A64, b, r.x)
    fault = None
    if faults:
        fault = _funm_true_rel(A64, b, F.sketched_gmres(
            A, b, M=M, sketch=shared["gmres"], **dict(
                FUNM_SGM, maxiter=max(1, it // 2))).x)
    fail.append(_funm_gate(gates, f"sketched_gmres true residual {impl}",
                           rel, FUNM_SGM["tol"], fault))
    fault = None
    if faults:
        # a starved embedding (d = maxiter + 2) of the unpreconditioned
        # Krylov space, which then fills all maxiter columns
        fault = float(F.sketched_gmres(A, b, sketch=F.kron_sketch(
            Np, FUNM_SGM["maxiter"] + 1, seed=torch.Generator(
                device=device).manual_seed(FUNM_SEED)), **FUNM_SGM)
            .distortion)
    fail.append(_funm_gate(gates, f"sketched_gmres distortion {impl}",
                           float(r.distortion), 4.0, fault))
    recs["sketched_gmres"] = dict(
        niter=it, status=int(r.status), true_rel=rel,
        distortion=float(r.distortion), sketch_d=r.sketch_d,
        resnorms=r.resnorms[: it + 1].tolist(), applications=dict(counts),
        launches=launches, wall_s=wall, gates=gates)

    counts.update(A=0, M=0)
    gates = {}
    r, launches, wall = _lsq_run(
        f"funm restarted_sketched_gmres {impl}@{nx}",
        lambda: F.restarted_sketched_gmres(
            Ac, b, M=Mc, sketch=shared["gmres"], tol=FUNM_SGM["tol"],
            maxiter=FUNM_SGM_CYCLE, max_restarts=FUNM_SGM_RESTARTS,
            k_ortho=FUNM_SGM["k_ortho"]))
    _funm_identity("restarted_sketched_gmres", launches, impl, nlev, counts)
    rel = _funm_true_rel(A64, b, r.x)
    fault = None
    if faults:
        # its first cycle alone
        fault = _funm_true_rel(A64, b, F.restarted_sketched_gmres(
            A, b, M=M, sketch=shared["gmres"], tol=FUNM_SGM["tol"],
            maxiter=FUNM_SGM_CYCLE, max_restarts=0,
            k_ortho=FUNM_SGM["k_ortho"]).x)
    fail.append(_funm_gate(gates, f"restarted_sketched_gmres true residual "
                           f"{impl}", rel, FUNM_SGM["tol"], fault))
    fail.append(_funm_gate(gates, f"restarted_sketched_gmres distortion "
                           f"{impl}", float(r.distortion), 4.0))
    recs["restarted_sketched_gmres"] = dict(
        niter=int(r.niter), status=int(r.status), true_rel=rel,
        distortion=float(r.distortion), applications=dict(counts),
        launches=launches, wall_s=wall, gates=gates)
    for name in ("sketched_gmres", "restarted_sketched_gmres"):
        if recs[name]["status"] != 0:
            fail.append(f"{name} status {recs[name]['status']}")

    counts.update(A=0, M=0)
    gates = {}
    v0 = ops.pad_grid_vec(torch.cos(torch.arange(
        nx * nx, dtype=torch.float64, device=device) * 0.7391) + 0.01, nx,
        nx).float()
    r, launches, wall = _lsq_run(
        f"funm sketched_eigs {impl}@{nx}", lambda: F.sketched_eigs(
            Ac, v0=v0, sketch=shared["eigs"], **FUNM_SEIG))
    _funm_identity("sketched_eigs", launches, impl, 0, counts)
    m, k = FUNM_SEIG["maxiter"], FUNM_SEIG["k"]
    # the basis, then each Ritz vector's parts (one where they are real)
    per = 2 if r.U.is_complex() else 1
    if counts["A"] != m + per * k:
        raise AssertionError(f"funm sketched_eigs: {counts['A']} "
                             f"applications, expected {m} + {per} x {k}")
    theta = r.theta.cpu().numpy()

    def recomputed(U, th):
        out = []
        for j in range(U.shape[1]):
            u = U[:, j].to(torch.complex128)
            u = u / torch.linalg.vector_norm(u)
            Au = torch.complex(A64(u.real.contiguous()),
                               A64(u.imag.contiguous()))
            out.append(float(torch.linalg.vector_norm(Au - th[j] * u))
                       / max(abs(th[j]), 1e-300))
        return np.array(out)

    rec64 = recomputed(r.U, theta)
    rep = r.pair_resnorms.double().cpu().numpy()
    dev_res = float(np.max(np.abs(rep - rec64) / rec64))
    fault = None
    if faults:
        # the start vector returned in place of the Ritz vectors
        fault = float(np.max(np.abs(rep - recomputed(
            v0[:, None].expand(-1, k), theta)) / rec64))
    fail.append(_funm_gate(gates, f"sketched_eigs reported residual against "
                           f"float64 {impl}", dev_res, FUNM_SEIG_RES_RTOL,
                           fault))
    h2 = 1.0 / (nx + 1) ** 2
    lo = h2 * eigen.cd_eigenvalues(nx, 1)[0][0]
    hi = h2 * eigen.cd_eigenvalues(nx, 1, largest=True)[0][0]
    outside = float(max(np.max((lo - theta.real) / lo),
                        np.max((theta.real - hi) / hi), 0.0))
    fault = None
    if faults:
        outside_f = theta.real * 1.01
        fault = float(max(np.max((lo - outside_f) / lo),
                          np.max((outside_f - hi) / hi), 0.0))
    fail.append(_funm_gate(gates, f"sketched_eigs outside the spectrum "
                           f"{impl}", outside, FUNM_SEIG_RANGE, fault))
    recs["sketched_eigs"] = dict(
        theta=[complex(t) for t in theta], pair_resnorms=rep.tolist(),
        recomputed_float64=rec64.tolist(), spectrum=[lo, hi],
        applications=dict(counts), launches=launches, wall_s=wall,
        gates=gates)
    shared[f"theta {impl}"] = theta
    return recs, [f for f in fail if f]


def funm_phase(device, faults=False):
    """The Chebyshev, matrix-function, block and sketched lanes (``--only
    funm``), float32 through K1-K3 on the kernel lane and the plain
    stencil on the plain lane, at ``FUNM_NX``^2: (a) ``chebyshev`` with
    the V-cycle and ``spectral_bounds``; (b) ``ops.chebyshev_preconditioner``
    as CG's ``M`` at ``FUNM_PREC_NX``^2 (``reduced_from``); (c)
    ``expm_multiply``, ``inv_sqrt_multiply`` and ``slq_logdet`` of Poisson
    against their closed forms, the Arnoldi ``expm_multiply`` on the north
    star's operator against its float64 run; (d) ``block_cg`` and
    ``block_gmres``; (e) ``sketched_gmres``, ``restarted_sketched_gmres``
    and ``sketched_eigs``.  Each run's applications of ``A`` and ``M`` are
    counted and the kernel lane's K1-K3 launches held to them; the lanes'
    counts within ``FUNM_LANE_SLACK`` (Chebyshev: one check block), the
    Arnoldi lanes and sketched_eigs' values to each other.  With
    ``faults`` (``--funm-faults``) the kernel lane only, each gate also
    read on its planted fault, which must fail it.  Prints one JSON line
    and returns it."""
    import torch

    t0 = time.perf_counter()
    nx = FUNM_NX
    record = {"device": _smi(), "nx": nx,
              "reduced_from": {"chebyshev_preconditioner cg": {
                  "nx": FUNM_PREC_NX, "from": nx, "why": "plain float32 CG "
                  "at 4095^2 (kappa ~7e6) is no useful yardstick"}},
              "runs": {}, "launches": {}, "gates": {}}
    failed = []
    arn_ref, shared = {}, {}

    def attempt(key, fn, *args):
        t = time.perf_counter()
        try:
            rec, fails = fn(*args)
            record["runs"][key] = rec
            subs = rec.items() if all(isinstance(v, dict) and "launches" in v
                                      for v in rec.values()) \
                else [(None, rec)]
            for sub, r in subs:
                label = key if sub is None else f"{sub} {key.split(' ', 1)[1]}"
                if " cuda@" in label:
                    record["launches"][label] = r["launches"]
                record["gates"].update(r.get("gates", {}))
            failed.extend(f"{key}: {f}" for f in fails)
            return rec
        except AssertionError as exc:
            failed.append(f"{key}: {exc}")
        finally:
            torch.cuda.empty_cache()
            print(f"funm {key}: {time.perf_counter() - t:.1f} s", flush=True)

    lanes = ("cuda",) if faults else ("cuda", "torch")
    runs = {}
    for impl in lanes:
        runs["cheb", impl] = attempt(f"chebyshev {impl}@{nx}", _funm_cheb,
                                     nx, impl, device, faults)
        attempt(f"chebyshev_preconditioner {impl}@{FUNM_PREC_NX}",
                _funm_prec, FUNM_PREC_NX, impl, device, faults)
        attempt(f"hermitian {impl}@{nx}", _funm_hermitian, nx, impl, device,
                faults)
        runs["arn", impl] = attempt(f"expm_multiply arnoldi {impl}@{nx}",
                                    _funm_arnoldi, nx, impl, device, arn_ref,
                                    faults)
        runs["bcg", impl] = attempt(f"block_cg {impl}@{nx}", _funm_block_cg,
                                    nx, impl, device, faults)
        runs["bgm", impl] = attempt(f"block_gmres {impl}@{nx}",
                                    _funm_block_gmres, nx, impl, device,
                                    faults)
        runs["sk", impl] = attempt(f"sketch {impl}@{nx}", _funm_sketch, nx,
                                   impl, device, shared, faults)
    gates = record["gates"]
    if len(lanes) == 2 or faults:
        def lanes_gate(name, reading, limit, fault=None):
            msg = _funm_gate(gates, name, reading, limit, fault)
            if msg:
                failed.append(msg)

        k, t = runs.get(("cheb", "cuda")), runs.get(("cheb", "torch"))
        if k and (t or faults):
            gap = abs(k["niter"] - (t or k)["niter"])
            lanes_gate("chebyshev lanes' iterations apart", gap,
                       FUNM_CHEB["check_every"],
                       abs(k["niter"] - k["fault_niter_lmin_over_10"])
                       if faults else None)
        for key, name in (("bcg", "block_cg"), ("bgm", "block_gmres")):
            k, t = runs.get((key, "cuda")), runs.get((key, "torch"))
            if k and t:
                lanes_gate(f"{name} lanes' steps apart",
                           abs(k["niter"] - t["niter"]), FUNM_LANE_SLACK)
        k, t = arn_ref.get("cuda"), arn_ref.get("torch")
        if k is not None and t is not None:
            lanes_gate("expm arnoldi lanes apart", float(
                torch.linalg.vector_norm(k - t) / torch.linalg.vector_norm(t)),
                FUNM_ARN_LANE_RTOL)
        k, t = shared.get("theta cuda"), shared.get("theta torch")
        if k is not None and t is not None:
            lanes_gate("sketched_eigs lanes' values apart", float(np.max(
                np.abs(np.sort_complex(k) - np.sort_complex(t))
                / np.abs(np.sort_complex(t)))), FUNM_SEIG_THETA_RTOL)
    del arn_ref, shared
    record["phase_s"] = time.perf_counter() - t0
    record["failed"] = failed
    if faults:
        missed = [n for n, g in gates.items() if g["fault_caught"] is False]
        record["faults_missed"] = missed
    print(json.dumps({"funm_faults" if faults else "funm": record},
                     default=str), flush=True)
    if failed:
        raise AssertionError("funm phase: " + "; ".join(failed))
    return record


#: the sstep phase (``--only sstep``): the s-step lane and the unstructured
#: gallery at the north star's grid, float32 inner solves through K1-K3
#: on the kernel lane and the plain stencil on the plain lane, float64
#: refinement to SS_TOL.  (a) ``ca_cg`` (s = 4, bench.py's padded V-cycle
#: as M, one block a refinement cycle) inside ``refine_to`` on bench.py's
#: Poisson, beside ``cg`` with bench.py's inner budget (tol 1e-4, 12
#: iterations, stagnation window 4; ``ca_cg`` with that budget raises the
#: residual after its first block: ROADMAP.md C); (b) ``ca_gmres`` on the
#: north star's h^2-scaled
#: operator with its scaled V-cycle as Ml (24 steps a call, tol 1e-3):
#: monomial s = 4, Newton s = 8 and Chebyshev s = 8 (their shifts from one
#: ``newton_shifts`` call per lane), then ``restarted_ca_gmres`` (Newton,
#: s = 8, 3 cycles of 24 steps); (c) ``gmres_polynomial_preconditioner``
#: (degree 8) of the V-cycle-preconditioned north-star operator as Mr of
#: ``gmres(ortho="cgs2_fused")`` (GMRES(25)) and of ``ca_gmres`` (Newton,
#: s = 4), one float32 solve each to tol 1e-3 beside the same solve
#: without it; (d) the gallery on scipy matrices (CSR first, so that the
#: DIA layout reads a canonical matrix): the DIA forms of the five-point
#: Poisson and of the convection-diffusion operator at SS_NX^2 against K1
#: (float32) and scipy (float64, bit for bit), CG with block Jacobi (block
#: 32) beside point Jacobi on the CSR Poisson at SS_GAL_NX^2, and SPAI as
#: Mr of GMRES on the CSR convection-diffusion operator at SS_GAL_NX^2
#: (its host setup over every column takes ~7 s at 1023^2 on an 8-core
#: x86 CPU, ~110 s at 4095^2 by the same rate: cut to 1023^2)
SS_NX = NS_NX
SS_GAL_NX = NX
SS_TOL = 1e-8
SS_CG_S = 4
SS_CG_INNER = dict(tol=1e-4, maxiter=12, stagnation_window=4)
SS_GM_BASES = (("monomial", 4), ("newton", 8), ("chebyshev", 8))
SS_GM_INNER = dict(tol=1e-3, maxiter=24)
SS_RESTARTED = dict(s=8, maxiter=24, max_restarts=2, tol=1e-3)
SS_POLY_DEGREE, SS_POLY_S = 8, 4
SS_POLY_GMRES = dict(tol=1e-3, maxiter=25)
SS_POLY_CA = dict(tol=1e-3, maxiter=24)
SS_GAL_CG = dict(tol=1e-6, maxiter=4000)
SS_GAL_BLOCK = 32
SS_SPAI_ITERS = 60
SS_SEED = 18
#: gate limits (each also read on its planted fault with
#: ``--sstep-faults``): the first inner CA-CG solve's relative M-norm
#: residual after its block (CG's after s iterations 2.4e-4; float32's
#: monomial block 2.1e-3 on the kernel lane at 4095^2 on the H100, the
#: block solves by their diagonals 2.4); the
#: monomial basis' orthogonality ||V^T V - I||_max of one CA-GMRES call
#: to the inner tolerance (float32: 2.9e-3 at 127^2 on an x86 CPU,
#: 0.25 with a Gram-Schmidt pass dropped); the polynomial preconditioner's
#: roots against the float64 build from the same seed, relative to the
#: largest; the float32 DIA against K1, relative to the largest output
SS_CG_FIRST_LIMIT = 1e-2
SS_ORTH_LIMIT = 3e-2
#: SPAI-preconditioned GMRES(60)'s final residual over Jacobi's at 1023^2
#: (0.930 on the H100: the convection-diffusion operator's constant
#: diagonal makes Jacobi a scaling; its planted fault, a solve with
#: Jacobi in SPAI's place, reads its own ratio)
SS_SPAI_RATIO = 0.97
SS_ROOT_RTOL = 1e-5
SS_DIA_K1_RTOL = 1e-5


def _ss_gate(gates, failed, name, reading, limit, fault=None, above=False):
    msg = _funm_gate(gates, name, reading, limit, fault, above, "sstep")
    if msg:
        failed.append(msg)


def _ss_refined(label, A64, b, inner, impl, nlev, counts, iters,
                setup=None):
    """One refined solve (after ``setup()``, inside the counted run), its
    launches held to the counted applications; returns its record."""
    import torch

    def go():
        if setup is not None:
            setup()
        return _ss_refine(A64, b, inner)

    (res, info), launches, wall = _lsq_run(f"sstep {label}", go)
    _funm_identity(label, launches, impl, nlev, counts, "sstep")
    rel = float(torch.linalg.vector_norm(b - A64(res.x))
                / torch.linalg.vector_norm(b))
    hist = res.resnorms.tolist()
    print(f"sstep {label}: {info['cycles']} cycles, inner iterations "
          f"{iters}, true residual {rel:.3e}, outer {hist}", flush=True)
    return dict(cycles=info["cycles"], inner_iters=list(iters),
                inner_total=sum(iters), true_rel=rel, outer=hist,
                applications=dict(counts), launches=launches, wall_s=wall,
                status=int(res.status))


def _ss_refine(A64, b, inner):
    from krypy_tpu_torch import functional as F

    return F.refine_to(A64, b, inner, tol=SS_TOL, max_cycles=12)


def _ss_cacg(nx, impl, device, nlev, faults):
    """(a) ``ca_cg`` (one block of s a refinement cycle) and ``cg``
    (bench.py's inner budget) inside ``refine_to`` on bench.py's Poisson
    (ones) with the padded V-cycle."""
    import torch
    from krypy_tpu_torch import functional as F, ops

    A, M, A64 = _funm_poisson(nx, impl, device)
    b = torch.ones(nx * nx, dtype=torch.float64, device=device)
    recs, gates, fail = {}, {}, []

    def run(kind, tag, budget):
        Ac, Mc, counts = _funm_counted(A, M)
        iters, first = [], []

        def inner(r32):
            r = ops.pad_grid_vec(r32, nx, nx)
            res = (F.ca_cg(Ac, r, s=SS_CG_S, M=Mc, **budget)
                   if kind == "ca_cg" else F.cg(Ac, r, M=Mc, **budget))
            iters.append(int(res.niter))
            if not first:
                first.append(res.resnorms.tolist())
            return res._replace(x=ops.unpad_grid_vec(res.x, nx, nx))

        rec = _ss_refined(f"{tag} {impl}@{nx}", A64, b, inner, impl, nlev,
                          counts, iters)
        rec["first_inner_resnorms"] = [v for v in first[0] if v == v]
        return rec

    one_block = dict(SS_CG_INNER, maxiter=SS_CG_S)
    recs["ca_cg"] = run("ca_cg", "ca_cg", one_block)
    recs["cg"] = run("cg", "cg", SS_CG_INNER)
    k, c = recs["ca_cg"], recs["cg"]
    k["blocks_apart_from_cg"] = (k["inner_total"] - c["inner_total"]) \
        / SS_CG_S
    first = k["first_inner_resnorms"][1]
    k["cg_at_s"] = c["first_inner_resnorms"][SS_CG_S]
    fault_first = fault_rel = None
    if faults:
        # the block solves (conjugation and Gram) by their diagonals only
        keep = torch.linalg.solve_ex

        def diagonal(W, B, **kw):
            d = torch.diagonal(W)
            X = B / (d if B.ndim == 1 else d[:, None])
            return X, torch.zeros((), dtype=torch.int32, device=W.device)

        torch.linalg.solve_ex = diagonal
        try:
            bad = run("ca_cg", "ca_cg fault", one_block)
        finally:
            torch.linalg.solve_ex = keep
        fault_first = bad["first_inner_resnorms"][1]
        fault_rel = k["outer"][-2]
    _ss_gate(gates, fail, f"ca_cg refined true residual {impl}",
             k["true_rel"], SS_TOL, fault_rel)
    _ss_gate(gates, fail, f"ca_cg first block's M-norm residual {impl}",
             first, SS_CG_FIRST_LIMIT, fault_first)
    return dict(recs, gates=gates), fail


def _ss_northstar(nx, impl, device):
    """The north star's h^2-scaled padded float32 operator, its scaled
    V-cycle, its unscaled float64 operator, the inner scale and b."""
    import torch
    from krypy_tpu_torch import ops

    A, M, _ = _funm_northstar(nx, impl, device)
    cd64 = ops.convection_diffusion_2d(nx, wind=(1.0, 0.5), eps=1.0,
                                       device=device)
    h2 = float(np.float32(1.0 / (nx + 1) ** 2))
    b = torch.ones(nx * nx, dtype=torch.float64, device=device)
    return A, M, cd64, h2, b


def _ss_orthogonality(V, K):
    """||V_{K+1} V_{K+1}^T - I||_max of a basis' first K + 1 rows, in
    float64 from the float32 rows."""
    import torch

    W = V[: K + 1].double()
    G = W @ W.T
    return float((G - torch.eye(K + 1, dtype=G.dtype, device=G.device))
                 .abs().max())


def _ss_cagmres(nx, impl, device, nlev, faults):
    """(b) ``ca_gmres`` with each basis and ``restarted_ca_gmres`` inside
    ``refine_to`` on the north star's system, the V-cycle as Ml; the
    monomial basis' orthogonality in one call to the inner tolerance."""
    from krypy_tpu_torch import functional as F, ops
    from krypy_tpu_torch.functional import sstep

    A, M, cd64, h2, b = _ss_northstar(nx, impl, device)
    rs0 = ops.pad_grid_vec((b * h2).float(), nx, nx)
    recs, gates, fail = {}, {}, []
    for basis, s in SS_GM_BASES + (("restarted", SS_RESTARTED["s"]),):
        Ac, Mc, counts = _funm_counted(A, M)
        iters, box = [], {"shifts": None}

        def setup(basis=basis, s=s, box=box):
            # the Newton and Chebyshev shifts, once per lane
            if basis in ("newton", "chebyshev"):
                box["shifts"] = F.newton_shifts(Ac, rs0, s, Ml=Mc)

        def inner(r32, basis=basis, s=s, box=box):
            rs = ops.pad_grid_vec(r32 * h2, nx, nx)
            if basis == "restarted":
                res = F.restarted_ca_gmres(Ac, rs, Ml=Mc, basis="newton",
                                           **SS_RESTARTED)
            else:
                res = F.ca_gmres(Ac, rs, s=s, basis=basis,
                                 shifts=box["shifts"], Ml=Mc, **SS_GM_INNER)
            iters.append(int(res.niter))
            return res._replace(x=ops.unpad_grid_vec(res.x, nx, nx))

        label = ("restarted_ca_gmres newton" if basis == "restarted"
                 else f"ca_gmres {basis}") + f" s={s}"
        rec = _ss_refined(f"{label} {impl}@{nx}", cd64, b, inner, impl, nlev,
                          counts, iters, setup)
        rec["s"] = s
        shifts = box["shifts"]
        if shifts is not None:
            rec["shifts"] = [[float(z.real), float(z.imag)] for z in shifts]
        recs[label] = rec
        _ss_gate(gates, fail, f"{label} refined true residual {impl}",
                 rec["true_rel"], SS_TOL,
                 rec["outer"][-2] if faults else None)
        if basis != "monomial" or impl != "cuda":
            continue
        # one call's basis to the inner tolerance, its orthogonality
        one, internal = F.ca_gmres(A, rs0, s=s, basis=basis, Ml=M,
                                   return_internal=True, **SS_GM_INNER)
        orth = _ss_orthogonality(internal["V"], int(one.niter))
        del internal
        fault = None
        if faults:
            # every second Gram-Schmidt pass dropped
            keep, calls = sstep._gs_pass, []

            def one_pass(V, Z, C, k, rows, proj, upd):
                calls.append(1)
                return Z if len(calls) % 2 == 0 else keep(
                    V, Z, C, k, rows, proj, upd)

            sstep._gs_pass = one_pass
            try:
                res, bad = F.ca_gmres(A, rs0, s=s, basis=basis, Ml=M,
                                      return_internal=True, **SS_GM_INNER)
                fault = _ss_orthogonality(bad["V"], int(res.niter))
                del bad
            finally:
                sstep._gs_pass = keep
        rec["orthogonality"] = dict(reading=orth, steps=int(one.niter))
        _ss_gate(gates, fail, f"{label} basis orthogonality {impl}", orth,
                 SS_ORTH_LIMIT, fault)
    return dict(recs, gates=gates), fail


def _ss_roots_apart(got, want):
    """The largest distance from a root of ``want`` to its nearest unused
    root of ``got`` (greedy matching; a conjugate pair's members are not
    told apart by their rounded real parts), relative to the largest."""
    left = list(np.asarray(got, complex))
    dist = 0.0
    for w in np.asarray(want, complex):
        j = int(np.argmin([abs(g - w) for g in left]))
        dist = max(dist, abs(left.pop(j) - w))
    return dist / float(np.max(np.abs(want)))


def _ss_poly(nx, impl, device, nlev, faults):
    """(c) the GMRES-polynomial preconditioner of the V-cycle-preconditioned
    north-star operator as Mr of GMRES (cgs2_fused) and CA-GMRES (Newton),
    beside the same solves without it; its roots against the float64 build
    from the same seed."""
    from krypy_tpu_torch import functional as F, ops

    A, M, A64pad = _funm_northstar(nx, impl, device)
    h2 = float(np.float32(1.0 / (nx + 1) ** 2))
    import torch

    rs0 = ops.pad_grid_vec(torch.full((nx * nx,), h2, device=device), nx, nx)
    recs, gates, fail = {}, {}, []
    Ac, Mc, counts = _funm_counted(A, M)

    def MA(v):
        return Mc(Ac(v))

    MA.shape = A.shape
    (P, launches, wall) = _lsq_run(
        f"sstep gmres_polynomial_preconditioner {impl}@{nx}",
        lambda: ops.gmres_polynomial_preconditioner(MA, SS_POLY_DEGREE,
                                                    seed=rs0))
    _funm_identity("gmres_polynomial_preconditioner", launches, impl, nlev,
                   counts, "sstep")
    recs["build"] = dict(roots=[[float(z.real), float(z.imag)]
                                for z in P.roots], launches=launches,
                         wall_s=wall, applications=dict(counts))
    if impl == "cuda":
        def MA64(v):
            return M(A64pad(v))

        P64 = ops.gmres_polynomial_preconditioner(MA64, SS_POLY_DEGREE,
                                                  seed=rs0.double())
        dist = _ss_roots_apart(P.roots, P64.roots)
        fault = None
        if faults:
            # the seed not passed through: the float64 build from ones
            Pf = ops.gmres_polynomial_preconditioner(
                MA64, SS_POLY_DEGREE, seed=torch.ones_like(rs0.double()))
            fault = _ss_roots_apart(Pf.roots, P64.roots)
        recs["build"]["roots_f64"] = [[float(z.real), float(z.imag)]
                                      for z in P64.roots]
        _ss_gate(gates, fail, "polynomial roots against float64",
                 dist, SS_ROOT_RTOL, fault)
    solves = {
        "gmres": lambda Mr: F.gmres(Ac, rs0, Ml=Mc, Mr=Mr,
                                    ortho="cgs2_fused", **SS_POLY_GMRES),
        "ca_gmres": lambda Mr: F.ca_gmres(Ac, rs0, Ml=Mc, Mr=Mr,
                                          s=SS_POLY_S, basis="newton",
                                          **SS_POLY_CA),
    }
    for name, solve in solves.items():
        row = {}
        for with_p in (False, True):
            for k in counts:
                counts[k] = 0
            r, launches, wall = _lsq_run(
                f"sstep {name} {'Mr=p(MA)' if with_p else 'no Mr'} "
                f"{impl}@{nx}", lambda: solve(P if with_p else None))
            prefix = int(r.niter) if name == "gmres" and impl == "cuda" \
                else 0
            if impl == "cuda":
                _eigen_identity(f"{name} poly={with_p}", launches, nlev,
                                k1=counts["A"], vcycles=counts["M"],
                                prefix=prefix, phase="sstep")
            row["with_p" if with_p else "without"] = dict(
                niter=int(r.niter), status=int(r.status), wall_s=wall,
                launches=launches, applications=dict(counts))
        fault = None
        if faults:
            # the degree not passed through: a degree-1 polynomial
            P1 = ops.gmres_polynomial_preconditioner(MA, 1, seed=rs0)
            fault = int(solve(P1).niter)
        _ss_gate(gates, fail, f"{name} outer iterations with p(MA) {impl}",
                 row["with_p"]["niter"], row["without"]["niter"] - 1, fault)
        recs[name] = row
    return dict(recs, gates=gates), fail


def _ss_scipy(kind, n):
    """The five-point Poisson (1/h^2) or the convection-diffusion operator
    (wind (1, 0.5), eps 1, upwind) of ``ops`` as a scipy CSR matrix on an
    n-grid (row-major, Dirichlet)."""
    import scipy.sparse as sp

    if kind == "poisson":
        h = 1.0 / (n + 1)
        cc, cu, cd, cl, cr = (4.0 / h ** 2, -1.0 / h ** 2, -1.0 / h ** 2,
                              -1.0 / h ** 2, -1.0 / h ** 2)
    else:
        cc, cu, cd, cl, cr = _cd_raw(n)
    N = n * n
    j = np.arange(N) % n
    left = np.where(j[1:] != 0, cl, 0.0)      # (i, j-1) of row i*n + j
    right = np.where(j[:-1] != n - 1, cr, 0.0)
    return sp.diags([np.full(N, cc), right, left, np.full(N - n, cd),
                     np.full(N - n, cu)], [0, 1, -1, n, -n],
                    format="csr")


def _ss_gallery(device, faults):
    """(d) the DIA forms at SS_NX^2 against K1 and scipy, CG with block
    Jacobi on the CSR Poisson and SPAI as Mr of GMRES on the CSR
    convection-diffusion operator at SS_GAL_NX^2."""
    import torch
    from krypy_tpu_torch import functional as F, interop, ops

    nx = SS_NX
    recs, gates, fail = {}, {}, []
    rng = np.random.default_rng(SS_SEED)
    x64 = rng.standard_normal(nx * nx)
    for kind in ("poisson", "convdiff"):
        t = time.perf_counter()
        S = _ss_scipy(kind, nx)
        D64 = ops.dia_from_scipy(S, device=device)
        D32 = ops.dia_from_scipy(S.astype(np.float32), device=device)
        build = time.perf_counter() - t
        xg = torch.from_numpy(x64).to(device)
        y = D64(xg).cpu().numpy()
        want = S @ x64
        exact = y.tobytes() == want.tobytes()
        k1 = (ops.poisson_2d(nx, impl="cuda", device=device) if kind ==
              "poisson" else ops.convection_diffusion_2d(nx, impl="cuda",
                                                         device=device))
        x32 = xg.float()
        y32, yk = D32(x32), k1(x32)
        dk = float((y32 - yk).abs().max() / yk.abs().max())
        fault_exact = fault_dk = None
        if faults:
            # one diagonal's offset moved by one
            offs = D64.offsets.copy()
            offs[-1] += 1
            bad = interop.dia_from_numpy(D64.dia_data.cpu().numpy(), offs,
                                         device=device)
            fault_exact = float(np.abs(bad(xg).cpu().numpy() - want).max())
            bad32 = interop.dia_from_numpy(D32.dia_data.cpu().numpy(),
                                           offs, device=device)
            fault_dk = float((bad32(x32) - yk).abs().max()
                             / yk.abs().max())
        dia_ms = _time_ms(lambda: D32(x32), samples=5, per_sample=5)
        k1_ms = _time_ms(lambda: k1(x32), samples=5, per_sample=5)
        recs[f"dia {kind}@{nx}"] = dict(
            build_s=build, bitwise_scipy_f64=exact, k1_max_rel=dk,
            dia_f32_ms=dia_ms, k1_ms=k1_ms, n_diags=len(D64.offsets))
        print(f"sstep dia {kind}@{nx}: built in {build:.1f} s, float64 "
              f"{'bit for bit' if exact else 'NOT bit for bit'} scipy's, "
              f"float32 against K1 {dk:.3e}; matvec {dia_ms:.4f} ms "
              f"(K1 {k1_ms:.4f} ms)", flush=True)
        _ss_gate(gates, fail, f"dia {kind} float64 against scipy, max abs",
                 0.0 if exact else float(np.abs(y - want).max()), 0.0,
                 fault_exact)
        _ss_gate(gates, fail, f"dia {kind} float32 against K1", dk,
                 SS_DIA_K1_RTOL, fault_dk)
        del D64, D32, xg, x32, y32, yk, S
        torch.cuda.empty_cache()
    n = SS_GAL_NX
    S = _ss_scipy("poisson", n)
    csr = ops.sparse_from_scipy(S, device=device)
    b = torch.from_numpy(rng.standard_normal(n * n)).to(device)
    row = {}
    for label, M in (("jacobi", ops.jacobi_preconditioner(csr)),
                     ("block_jacobi", ops.block_jacobi_preconditioner(
                         csr, SS_GAL_BLOCK))):
        r, _, wall = _lsq_run(f"sstep csr cg {label}@{n}",
                              lambda: F.cg(csr, b, M=M, **SS_GAL_CG))
        row[label] = dict(niter=int(r.niter), status=int(r.status),
                          wall_s=wall)
    fault = None
    if faults:
        # the block size not passed through: blocks of one
        fault = int(F.cg(csr, b, M=ops.block_jacobi_preconditioner(csr, 1),
                         **SS_GAL_CG).niter)
    _ss_gate(gates, fail, "csr cg block-Jacobi iterations",
             row["block_jacobi"]["niter"], row["jacobi"]["niter"] - 1, fault)
    recs[f"csr cg@{n}"] = row
    S = _ss_scipy("convdiff", n)
    csr = ops.sparse_from_scipy(S, device=device)
    t = time.perf_counter()
    Ms = ops.spai_preconditioner(csr)
    setup = time.perf_counter() - t
    b = torch.ones(n * n, dtype=torch.float64, device=device)
    row = dict(spai_setup_s=setup, spai_residual=Ms.spai_residual,
               spai_format="dia" if hasattr(Ms, "dia_data") else "csr")
    finals = {}
    pairs = [("jacobi", ops.jacobi_preconditioner(csr)), ("spai", Ms)]
    if faults:
        # SPAI's solves left out: its diagonal scaling, Jacobi, in its place
        pairs.append(("spai fault", ops.jacobi_preconditioner(csr)))
    for label, M in pairs:
        r, _, wall = _lsq_run(f"sstep csr gmres {label}@{n}", lambda: F.gmres(
            csr, b, Mr=M, tol=1e-12, maxiter=SS_SPAI_ITERS))
        finals[label] = float(r.resnorms[int(r.niter)])
        row[label] = dict(niter=int(r.niter), final=finals[label],
                          wall_s=wall)
    print(f"sstep spai@{n}: setup {setup:.1f} s, ||AM - I||_F/sqrt(N) "
          f"{Ms.spai_residual:.4f}, GMRES({SS_SPAI_ITERS}) residual "
          f"{finals['spai']:.3e} (Jacobi {finals['jacobi']:.3e})", flush=True)
    _ss_gate(gates, fail, "spai gmres residual over jacobi's",
             finals["spai"] / finals["jacobi"], SS_SPAI_RATIO,
             finals["spai fault"] / finals["jacobi"] if faults else None)
    recs[f"spai gmres@{n}"] = row
    return dict(recs, gates=gates), fail


def _ss_profile(device, out_dir):
    """(``--profile`` with the sstep phase) the CholQR2 panel solve at the
    north star's N, as one library triangular solve with N right-hand
    sides (the JAX package's form) and as the port's row-by-row
    substitution, one synchronised call each after a warm one; then the
    wall of one monomial CA-GMRES block (s = 4) on the kernel lane with
    each form, and the block under the profiler with the port's."""
    import torch
    from krypy_tpu_torch import functional as F, ops
    from krypy_tpu_torch.functional import sstep

    nx = SS_NX
    N = nx * nx
    gen = torch.Generator(device=device).manual_seed(SS_SEED)

    def triangular(L, Z):
        return torch.linalg.solve_triangular(L.conj(), Z, upper=False)

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    for s in (4, 8):
        Z = torch.randn(s, N, generator=gen, device=device)
        L = torch.linalg.cholesky(Z @ Z.T / N + torch.eye(s, device=device))
        t_tri, a = wall(lambda: triangular(L, Z))
        t_sub, b = wall(lambda: sstep._panel_solve(L, Z))
        diff = float((a - b).abs().max() / a.abs().max())
        print(f"profile sstep panel solve s={s} N={N}: triangular solve "
              f"{t_tri:.6f} s, row substitution {t_sub:.6f} s, max rel "
              f"diff {diff:.3e}", flush=True)
        del Z, a, b
    A, M, _ = _funm_northstar(nx, "cuda", device)
    rs0 = ops.pad_grid_vec(torch.full((N,), float(np.float32(
        1.0 / (nx + 1) ** 2)), device=device), nx, nx)
    def block(b):
        return F.ca_gmres(A, b, s=4, Ml=M, tol=1e-12, maxiter=4)

    keep = sstep._panel_solve
    sstep._panel_solve = triangular
    try:
        # no profiler here: it did not finish this block in 250 s
        torch.cuda.synchronize()
        t = time.perf_counter()
        block(rs0)
        torch.cuda.synchronize()
        t_tri = time.perf_counter() - t
    finally:
        sstep._panel_solve = keep
    t_sub, _ = wall(lambda: block(rs0))
    print(f"profile sstep one CA-GMRES block (monomial, s = 4): with the "
          f"triangular solve {t_tri:.6f} s, with the substitution "
          f"{t_sub:.6f} s", flush=True)
    _profile_solve("ca_gmres_block", block, rs0, out_dir)
    torch.cuda.empty_cache()


def sstep_phase(device, faults=False, profile=None):
    """The s-step lane and the rest of the ``ops`` gallery (``--only
    sstep``): (a) ``ca_cg`` beside ``cg`` inside ``refine_to`` on bench.py's
    Poisson, (b) ``ca_gmres`` with each basis and ``restarted_ca_gmres`` on
    the north star's system, (c) the GMRES-polynomial preconditioner as Mr
    of GMRES and CA-GMRES, each on both lanes with K1-K3 (and K4-K6)
    held to the counted applications; (d) the DIA, CSR, block-Jacobi and
    SPAI gallery.  With ``faults`` (``--sstep-faults``) the kernel lane
    only, each gate also read on its planted fault, which must fail it.
    Prints one JSON line and returns it."""
    import torch

    t0 = time.perf_counter()
    nx = SS_NX
    nlev = _eigen_vcycle_levels(nx, device)
    record = {"device": _smi(), "nx": nx, "runs": {}, "launches": {},
              "gates": {}, "reduced_from": {
                  "csr cg, spai gmres": {
                      "nx": SS_GAL_NX, "from": nx, "why":
                      "SPAI's host setup over every column (~110 s at "
                      "4095^2 by its 1023^2 rate); point-Jacobi CG at "
                      "4095^2 takes thousands of iterations"}}}
    failed = []

    def attempt(key, fn, *args):
        t = time.perf_counter()
        try:
            rec, fails = fn(*args)
            record["gates"].update(rec.pop("gates", {}))
            record["runs"][key] = rec
            if " cuda@" in key:
                # the kernel lane's runs: their launches, by run
                for sub, r in rec.items():
                    for k2, v in [(sub, r)] + [
                            (f"{sub} {a}", b) for a, b in r.items()
                            if isinstance(b, dict)]:
                        if isinstance(v, dict) and v.get("launches"):
                            record["launches"][f"{key} {k2}"] = \
                                v["launches"]
            failed.extend(f"{key}: {f}" for f in fails)
        except AssertionError as exc:
            failed.append(f"{key}: {exc}")
        finally:
            torch.cuda.empty_cache()
            print(f"sstep {key}: {time.perf_counter() - t:.1f} s",
                  flush=True)

    lanes = ("cuda",) if faults else ("cuda", "torch")
    for impl in lanes:
        attempt(f"ca_cg {impl}@{nx}", _ss_cacg, nx, impl, device, nlev,
                faults)
        attempt(f"ca_gmres {impl}@{nx}", _ss_cagmres, nx, impl, device, nlev,
                faults)
        attempt(f"polynomial {impl}@{nx}", _ss_poly, nx, impl, device, nlev,
                faults)
    attempt("gallery", _ss_gallery, device, faults)
    record["phase_s"] = time.perf_counter() - t0
    if profile:
        _ss_profile(device, profile)
    record["failed"] = failed
    if faults:
        record["faults_missed"] = [n for n, g in record["gates"].items()
                                   if g["fault_caught"] is False]
    print(json.dumps({"sstep_faults" if faults else "sstep": record},
                     default=str), flush=True)
    if failed:
        raise AssertionError("sstep phase: " + "; ".join(failed))
    return record


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
    # no one call computes K5: the pair of calls
    "apply_project": "torch.addmv then torch.mv (two calls)",
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
            "library_ms": t.get("library_ms"),
            "library": "torch.nn.functional.conv2d on the block with its "
                       "two halo rows" if k8 else None,
            "timed_by": t["timed_by"],
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
    ap.add_argument("--funm-faults", action="store_true",
                    help="run ONLY the funm phase's kernel lane with each "
                         "gate also read on a planted fault, which must "
                         "fail it; prints no result line")
    ap.add_argument("--sstep-faults", action="store_true",
                    help="run ONLY the sstep phase's kernel lane with each "
                         "gate also read on a planted fault, which must "
                         "fail it; prints no result line")
    ap.add_argument("--only",
                    choices=("stencil", "ortho", "baseline", "kernels",
                             "config5", "mesh", "onereduce", "compat",
                             "recycle", "nonsym", "eigen", "lsq",
                             "shifted", "funm", "sstep"),
                    help="run ONLY this phase (K1-K3 or K4-K6 against "
                         "their plain versions, and their times; the "
                         "baseline phase, unpadded K1 and configs 1-3; "
                         "the device times of K1's matvec, K4 and K7 by "
                         "phase; config 5 with K1's forward-mode "
                         "rule; the mesh phase; or the one-reduce lane: "
                         "the policy constants, the north star's "
                         "cgs2_1r forms, the pairs' slopes and checks; "
                         "or the reference-compatible lane: the goldens, "
                         "configs 2 and 3 and the padded Poisson through "
                         "linsys, deflation and Ritz; or the recycling "
                         "lane: the battery, config 5 through "
                         "recycling.RecyclingGmres, checkpoint; or the "
                         "nonsymmetric short recurrences on the north "
                         "star's system; or the eigensolvers; or the "
                         "least-squares and randomized lane; or the "
                         "Arnoldi and multi-shift lane; or the Chebyshev, "
                         "matrix-function, block and sketched lanes; or "
                         "the s-step lane and the unstructured gallery); "
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
    if args.funm_faults:
        funm_phase(device, faults=True)
        return
    if args.sstep_faults:
        sstep_phase(device, faults=True)
        return
    if args.only == "sstep":
        sstep_phase(device, profile=args.profile)
        return
    if args.only == "config5":
        config5_phase(device, smi)
        return
    if args.only == "recycle":
        recycle_phase(device, smi)
        return
    if args.only:
        {"stencil": stencil_phase, "ortho": ortho_phase,
         "baseline": baseline_phase, "kernels": kernels_phase,
         "mesh": mesh_phase, "onereduce": onereduce_phase,
         "compat": compat_phase, "nonsym": nonsym_phase,
         "eigen": eigen_phase, "lsq": lsq_phase,
         "shifted": shifted_phase, "funm": funm_phase,
         "sstep": sstep_phase}[args.only](device)
        return
    last = [t0]

    def mark(what):
        """Print the phase's wall and the script's so far."""
        now = time.perf_counter()
        print(f"phase wall {what}: {now - last[0]:.1f} s (script "
              f"{now - t0:.1f} s)", flush=True)
        last[0] = now

    report = stencil_phase(device)
    report["coarse"] = coarse_phase(device)
    laplacian_entry_phase(device)
    report.update(ortho_phase(device))
    report.update(project_phase(device))
    mark("kernel parity")
    _, solves, b = solve_phase(device)
    timing_phase("poisson", solves, b, ROUNDS)
    ns_counts, ns_solves, ns_b = northstar_phase(device)
    timing_phase("northstar", ns_solves, ns_b, NS_ROUNDS)
    level_ranking(report, ns_counts)
    vcycle_host_phase(device)
    mark("poisson, north star")
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
    mark("config 4")
    bl_report, c2_counts, c3_counts, c2_rec, c3_rec = baseline_phase(device)
    mark("baseline")
    c5_jvp, c5_full, _ = config5_phase(device, smi)
    mark("config 5")
    onered = onereduce_phase(device, reps=OR_WHOLE_REPS)
    mark("onereduce")
    compat = compat_phase(device)
    mark("compat")
    recycle = recycle_phase(device, smi, grids=RC_C5_WHOLE_GRIDS)
    mark("recycle")
    nonsym = nonsym_phase(device)
    mark("nonsym")
    eig = eigen_phase(device, pair_nx=EIGEN_PAIR_NX)
    mark("eigen")
    lsq = lsq_phase(device)
    mark("lsq")
    shf = shifted_phase(device)
    mark("shifted")
    fnm = funm_phase(device)
    mark("funm")
    sst = sstep_phase(device)
    mark("sstep")
    worlds = mesh_phase(device)
    mark("mesh")
    if args.profile:
        _profile_solve("poisson", solves["cuda"], b, args.profile)
        _profile_solve("northstar", ns_solves["cuda"], ns_b, args.profile)
        _profile_solve("config4_deflated", c4_solves["cuda"], c4_b,
                       args.profile)
        _profile_deflation(device, C4_NX)
        _ss_profile(device, args.profile)

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
        # the reference-compatible lane's runs (compat phase): K1 in configs
        # 2 and 3 at 4095^2, K1-K3 in bench.py's Poisson through linsys.Cg
        for run, used in compat["launches"].items():
            if name == "stencil5_affine" or run.startswith("poisson") and \
                    name in ("stencil5_jacobi2", "stencil5_resrestrict_rows"):
                rows[-1][f"launches_compat {run}"] = used[name]
        # the recycling lane's runs (recycle phase): K1 in config 5 through
        # recycling.RecyclingGmres, K1-K3 and K7 in the checkpointed
        # config-4 sequence
        for nx in RC_C5_WHOLE_GRIDS:
            for rule in ("", " recycle_capped"):
                if name == "stencil5_affine":
                    rows[-1][f"launches_recycle config5 compat{rule}@{nx}"] \
                        = recycle["config5"][f"{nx}{rule}"]["launches"][name]
        if name in recycle["checkpoint"]["launches"]:
            rows[-1][f"launches_recycle checkpoint@{RC_CK_NX}"] = \
                recycle["checkpoint"]["launches"][name]
        # the north star's one-reduce forms on the kernel lane
        for label, *_ in OR_NORTHSTAR:
            rows[-1][f"launches_northstar {label}@{NS_NX}"] = \
                onered["northstar_launches"][f"{label} cuda"][name]
        # the nonsymmetric short recurrences on the north star's system
        if cu == "stencil5.cu":
            for label, used in nonsym["launches"].items():
                rows[-1][f"launches_nonsym {label}@{NONSYM_NX}"] = used[name]
                if name == "stencil5_affine":
                    rows[-1][f"coarse_launches_nonsym {label}@"
                             f"{NONSYM_NX}"] = used["stencil5_coarse"]
        # the least-squares, randomized, Arnoldi, multi-shift, Chebyshev,
        # matrix-function, block, sketched and s-step lanes' kernel-lane
        # runs (lsq, shifted, funm and sstep phases): K1, K1-K3 of the
        # V-cycles, and K4-K6 of the polynomial-preconditioned GMRES
        for phase, rec in (("lsq", lsq), ("shifted", shf), ("funm", fnm),
                           ("sstep", sst)):
            for run, used in rec["launches"].items():
                if used.get(name):
                    rows[-1][f"launches_{phase} {run}"] = used[name]
        # the eigensolver lane's kernel-lane runs (eigen phase)
        for run, used in eig["launches"].items():
            if used.get(name):
                rows[-1][f"launches_eigen {run}"] = used[name]
            if name == "stencil5_affine" and used.get("stencil5_coarse"):
                rows[-1][f"coarse_launches_eigen {run}"] = \
                    used["stencil5_coarse"]
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
    for nx in RC_C5_WHOLE_GRIDS:
        for rule in ("", " recycle_capped"):
            rows[-1][f"launches_recycle config5 compat{rule}@{nx}"] = \
                recycle["config5"][f"{nx}{rule}"]["tangent_launches"]
    rows += _mesh_rows(worlds, report["stencil5_halo"])
    print(json.dumps({"walls_s": {
        label: record[label] for record in (c2_rec, c3_rec)
        for label in record if str(label).startswith("config")},
        "compat_walls_s": compat["walls_s"]}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
