"""Drive the PyTorch/CUDA port (`smcnuts_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; one GPU
    python3 chip_smoke.py --only autodiff,strategies,cli   # some phases, while
                                 # developing: prints no kernels line, no "ok"
    (phase keys: arma, prmwcd, main, batched, staged_times, cli, autodiff,
    gaussian, logistic, eightschools (phase 8 for one model alone),
    strategies, fused_kernel, eager, unfused, wide_eager, generated, runner,
    stan, solvers, lv_rk45 (phase solvers (b) alone), tile_programs, mesh, oracle;
    device, build and peak always run first; `--only batched,strategies` also
    runs phase parity)

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device: the GPU's name, `nvidia-smi` name and power limit, versions.
2. build: nvcc builds the kernels from smcnuts_torch/csrc (sm_90a), one nvcc
   a source, all at once: the NUTS kernel with two instantiations per entry
   (arma, PRMwCD, the Gaussian at D = 2, 3 and 5, eight schools, logistic):
   the first stage, which is the whole tree when nothing is staged, and the
   continuation stage; and the fused ARMA value and gradient. Prints ptxas's
   registers, stack frame and spills for each, and fails if the build took
   more than a minute. The kernel template is csrc/nuts_tree.cuh; the hand
   models' entries are csrc/nuts_tree.cu; the FP32 peak kernel
   (csrc/fma_peak.cu) builds beside them.
2b. peak (K8): the FP32 peak kernel (csrc/fma_peak.cu) against its plain
   chain at 64 steps (FMUL+FADD equal to the bit; FMA within one spacing of
   the chain's value a step and chain), then 4, 8, 16 and 32 chains of 2,000
   steps a thread, FMA and FMUL+FADD, on 8 blocks of 256 threads an SM (the
   device alone, median of 5 of 20 launches back to back, TFLOP/s counted as
   experiments/bench_vpu_peak.py:92 counts them). Every later bound divides
   by the card's FP32 rate (the data sheet's 67 TFLOP/s, which counts a
   fused multiply-add as two); its second bound, bound_unfused_ms, divides by
   the measured FMUL+FADD rate, the most the port's -fmad=false builds reach.
3. arma kernel vs plain: `nuts_tree` (the CUDA kernel, a group of
   models.arma.GROUP lanes a tree) and `nuts_tree_plain` (the model in the
   same group order) on the same CUDA inputs, with zero-bits and Philox
   draws, phi 1.0 and 0.4 (two runs in one launch), a non-unit inverse mass,
   the r-given variant at max_depth 0, each with lanes at log_sigma +-20,
   +-60 and |theta| >= 2 (a density that is not finite or nearly so), and the
   main path's shape (N=512, max_depth 10): every output equal to the bit
   (NaN equal to NaN), and the contract of the other models (below) too.
   Times both at N=512 and at the batched shape 25 x 512: the kernel on the
   device alone (utils/timing.device_ms: 20 launches queued back to back
   behind a device-side wait, events around them) and one call timed alone
   (the host's launch included), the plain version one call. Then the W = 1
   witness (`ops.nuts_cuda.ARMA_VARIANTS`, one thread a tree, the sequential
   order) equal to the bit to the plain version at group=1, timed in turns
   with the main entry at 25 x 512 and at 1,048,576 trees, with ptxas's
   lines for each.
   Then the staged dispatch at 25 x 512, depth 10: for Philox and zero bits,
   the accept-reject epilogue off and on (the zero-bits cloud holds a lane
   with a NaN density, the only kind zero bits reject), and r given, the
   kernel with the reference's splits, with one split at every depth 1..9
   and with all nine must equal the single kernel to the bit on every lane
   and output, and is held to the plain version to the bit. The staged
   dispatch (as above) and its plain version (one call) are timed.
   The contract of the kernels not held to the bit (phase 11's generated
   model against the hand kernel of the same density): fails when
   fewer than 99.9% of lanes agree on depth, leapfrogs and moved; when x, r,
   logp0, logp_prop or delta_h differ on agreeing lanes by more than
   atol 1e-4 + rtol 1e-4; or when an output is not finite.
4. PRMwCD kernel vs plain: the same cases for the PRMwCD instantiation (a
   group of 16 lanes a particle; a 13-vector inverse mass), plus the batched
   main path's shape, 25 runs x 512 at max_depth 10, where both are timed,
   each held to the plain version summing in the kernel's group order to
   the bit; then PRMwCD's measurement entries (`ops.nuts_cuda.
   PRMWCD_VARIANTS`: the W = 1 witness, one thread a particle; W = 32 in
   blocks of 64; the main path's W = 16 in blocks of 128), each equal to the
   bit to the plain version at its width or to the main entry, all timed in
   turns with the main entry (median of 6 device times) beside ptxas's
   registers, stack and spills for each; then the staged dispatch as in
   phase 3, every single kernel equal to its plain version to the bit.
5. arma main path, one run: SMCSampler(K=100, N=512, step 0.01, max depth 10)
   on the GPU, then `python -m smcnuts_torch` through its main(). Each run
   must launch the kernel exactly 100 times and the plain tree never; every
   series is finite with K+1 entries, acceptance[K] == 0, and each final
   posterior mean lies within one posterior sd of the reference ground truth.
6. the three batched workloads of bench.py, each 25 runs x N=512 x K=100
   through `run_smc_batched` (step 0.01, max depth 10): arma, PRMwCD, and
   PRMwCD with step-size and mass adaptation at target_accept 0.5. Each must
   launch its kernel exactly 100 times and the plain tree never; every series
   is finite with K+1 entries; the 25-run MC mean and variance of the final
   estimates lie in the PARITY bands of `smcnuts_torch.utils.parity` (those
   of experiments/parity_summary.py: 3 MC standard errors + 0.1 posterior
   sd; 3 MC standard errors + 40%);
   runs 0 and 24 equal single runs with their seeds, to the bit. The adapted
   run's step size is constant over the frozen iterations, and its mean
   leapfrogs per particle-iteration are below half the fixed run's. Prints
   wall time and particle-iterations/s of each workload. Then each workload
   again with compaction=None and with the staged dispatch in turns (none,
   staged, staged, none): every SMCResult field equal to the bit, K
   dispatches, K x stages kernel launches, no plain call, runs 0 and 24
   equal to their single runs with compaction on, wall beside wall; and the
   first 20 iterations of its loop under torch.profiler (device kernels an
   iteration, device busy time, idle share). Last,
   PRMwCD with 100 runs and compaction="auto" for 5 iterations: past
   the model's compaction_min_lanes "auto" takes the hint, and the runs equal
   those with compaction=None.
6b. times of the staged dispatch: each workload's K iterations are driven
   once more through init_state and smc_step, and on the population they
   end with, the single kernel and every candidate split tuple are timed
   (the device alone, 20 launches back to back), with the survivors after
   each split, the stage launches, and the per-warp lockstep waste (lane-steps
   a warp walks over lane-steps its trees need) from the kernel's own leapfrogs
   and depth outputs (the trees a warp holds: 32, arma's 4, PRMwCD's 2), and
   the block's tail
   (the same count at the trees a block holds). The first 2 and 5 runs of each
   population are timed alone, and each population is also tiled to 2, 4 and
   16 times the lanes: past the lanes the card holds at once, a warp or block
   that ends early makes room for a waiting one, and compaction has
   something to remove.
7. CLI: `python -m smcnuts_torch --model prmwcd --device cuda`, without and
   with --adapt-step-size --adapt-mass-matrix, through its main(): 100
   launches each and finite estimates; then `--model eightschools --lkernel
   asymptoticLKernel` (tempering on, as the CLI sets it): one launch per
   iteration and a schedule that ends at 1.
8. the Gaussian, eight-schools and logistic kernels vs plain: the contract
   and cases of phases 3 and 4 for each of the three models whose gradient
   the JAX package takes by autodiff inside its kernel and this port writes
   out by hand, on a dispersed synthetic cloud: zero bits and Philox, phi 1.0
   and 0.4, a non-unit inverse mass, r given at depth 0, the batched shape
   25 x 512 at depth 10 (timed), then the staged dispatch as in phase 3
   (accept-reject off and on, a lane with a -inf density, r given; every
   split tuple equal to the single kernel to the bit). Each kernel is held
   to its plain version to the bit in every case: the Gaussian's (one thread
   a tree), and the group kernels of logistic regression
   (models.logistic.GROUP lanes a tree) and eight schools
   (models.eightschools.GROUP) in their plain versions' group order; then
   the latter two's W = 1
   witness (`ops.nuts_cuda.LOGISTIC_VARIANTS`, `EIGHTSCHOOLS_VARIANTS`, one
   thread a tree, the sequential order) equal to the bit to the plain
   version at group=1, timed in turns with the main entry at 25 x 512 and at
   1,048,576 trees, with ptxas's lines for each. The Gaussian's main entry
   runs the template's pipelined walk; its witness, the kernel before it (`GAUSSIAN_VARIANTS`: one thread a
   tree, the walk every other model runs), equal to the main entry's output
   to the bit (no second plain tree at 25 x 512), both timed in turns at
   25 x 512 x depth 10 and at 1 x 2048, 25 x 2048 and 100 x 512 at the
   tempered run's step 0.5 and depth 5, with ptxas's lines and the SASS
   instructions of each. Last, each model's
   single kernel and a few split tuples timed at 100 x 512 lanes at the step
   size of its run in phase 9: what the models' compaction hints rest on.
9. the three strategies, full width, through `run_smc_batched` with 25 runs:
   arma and PRMwCD at N=512, K=100, depth 10 with the asymptotic L-kernel
   (tempering, saved history) and the Gaussian-approximation L-kernel, inside
   the PARITY bands; the tempered Gaussian (D=3, prior variance 9, N=2048,
   K=20, step 0.5, depth 5, forwards L-kernel) with final moments within
   4 standard errors / 25% of the closed form, every dispatch to the entry
   `ops.nuts_cuda` names (`smcnuts_nuts_tree_gaussian3`, the pipelined
   walk; nuts_tree.entry_launches) and none to the witness; eight schools (N=1024, K=30,
   step 0.2, depth 6, forwards L-kernel, tempered) with 3 < mu < 6 and
   2 < tau < 6; logistic regression (N=1024, K=30, step 0.1, depth 6,
   asymptotic) held, by the PARITY bands (3 MC standard errors + 0.1
   reference sd on the means, 3 MC se + 40% on the variances), to one long
   run of the plain tree on the card (N=4096, K=25, forwards L-kernel). The
   loop of the arma and PRMwCD runs is also profiled on its first 20
   iterations (device kernels an iteration, device busy time, idle share). Each run: exactly K
   dispatches and no plain call; a tempered schedule starts above 0, never
   decreases and ends at 1; runs 0 and 24 equal their single runs to the
   bit; for the asymptotic strategy the estimates made inside the loop
   (save_history=False) equal those from the saved history to the bit.
parity. the six parity configurations' summary: phases 6 and 9's final
   estimates of arma and PRMwCD (forwards; asymptotic with tempering and the
   Gaussian L-kernel), 25 runs each, through `smcnuts_torch.utils.parity`
   (strategy_entry, summary): one <model>_summary.json object a model
   (experiments/parity_summary_torch.py's keys) printed as a JSON line;
   fails unless both pass. No device time: it reuses those runs.
oracle. the card against the serial NumPy oracle, the card's counterpart of
   tests/test_oracle_crossval.py: the Gaussian N([1, -2], diag(0.5, 2)) with
   a unit prior (D = 2, K6a's gaussian2 entry) at N=192, K=8, step 0.5,
   seeds 0-2 in one run_smc_batched call, forwards without tempering and
   asymptotic with it (K dispatches each, all to the pipelined walk, no
   plain call); `smcnuts_torch.baselines.numpy_smc.run_numpy_smc` over
   NumpyModelAdapter of the same model on the host's CPU, its six runs in
   spawned worker processes meanwhile. Each MC mean within 0.3 of the truth
   and the two within 0.4 of each other (the test's tolerances). Prints the
   host's numpy and scipy versions (a missing scipy fails the phase) and
   times one run_numpy_smc(NumpyArmaModel(), 64, 5, 0.01) (bench.py:45-46's
   size) on the host's CPU. Its launches count on the Gaussian's row.
10. the eager backend on the card with the fused ARMA kernel, and the unfused
   proposal path. (a) The fused ARMA value and gradient (K5, models.arma.GROUP
   lanes a particle) against its plain version in the same order at 1, 513,
   4,096, 12,800 and 1,048,576 lanes, with lanes at log_sigma +-20, +-60 and
   |theta| >= 2: equal to the bit; its W = 1 witness likewise against the
   plain version at group=1; both timed in turns on the device alone, with
   the plain version, one call timed alone and the bound, at 4,096 (the
   eager tree's block), 12,800 and 1,048,576 lanes; the device-alone time
   beside torch.profiler's device time of the same launches. (b) The
   slice's path, run_smc_batched(make_arma(fused="cuda"), eager,
   fused_epilogue=False) at 25 x 512 x K=15 (EAGER_K), depth 10, blocks of 4,096: K5
   launched once per model evaluation of the tree, the whole-tree kernel and
   the plain K5 never; finite series, the PARITY bands, runs 0 and 24 equal
   their single runs; wall, and the profile of 2 iterations; then 3
   iterations beside the plain ARMA loop (fused=None). (c) The unfused path
   on the whole-tree kernel (momenta given, K1u), arma 25 x 512 x K=100:
   forwards with the standard, a diagonal (var 2) and a dense momentum
   proposal, and asymptotic with tempering; the bands, K dispatches with the
   momenta given and no plain tree, runs 0 and 24 equal their single runs;
   K1u against its plain version at 25 x 512 x depth 10, timed. (d) arma at
   N = 1,048,576, one run, K = 2, eager with K5, in one block and in blocks
   of 262,144: every field equal to the bit; wall and peak device memory of
   each call, then the peak of one eager tree alone at each block size.

11. user-written densities: arma written as a scalar torch density
   (`arma_model_fwd`, forward mode, T=200, 3,837 operations) and eight
   schools as a per-particle torch density (`make_eightschools_generated`,
   reverse mode, straight-line, one thread a particle), traced, simplified
   and built into one library each (each
   build's seconds, the values its program holds live at once in emission
   order (`ops.generated.peak_live`), ptxas's registers, stack and spills and
   its SASS instructions; fails past two minutes). K7f is emitted in
   (primal node, pass) order with its error recurrence as a loop over the
   observations (`ops.generated.Recurrence`; the phase fails if it is not);
   its witnesses, the same program straight-line and straight-line in the
   order it was built, are libraries of their own; so is K7r split over 2 lanes a
   particle (group=2, its sums over the schools a loop). Each generated
   kernel (K7f, K7r) against its plain version (the program executed op by op
   in torch) at 25 x 512 x depth 10 under zero bits and Philox: equal to the
   bit, and phase 3's contract; staged with a split after every depth equal
   to the single kernel to the bit; against the hand kernel of the same
   density on identical inputs (logp0 at atol/rtol 1e-4, integer outputs on
   99.9% of lanes), both timed in turns. K7f's witnesses each equal to its
   plain program and to K7f's kernel to the bit, and timed in turns with K7f
   and the hand kernel (median of 6); K7r at 2 lanes equal to its plain program
   to the bit, and timed in turns with K7r and the hand K6b at 25 x 512 x
   depth 10, at the tempered run's 25 x 1024 x depth 6, phi 1 and 0.1, and
   at 1,048,576 trees.
   The main path:
   run_smc_batched on the generated arma at 25 x 512 x K=100 inside the
   PARITY bands; the
   generated eight schools at phase 9's settings inside the bands of the hand
   kernel's 25 runs; after each, init_state alone and a profile of the first
   iterations (as phase 9's), generated and hand; the same eight-schools
   density without a generated model, eager by autograd, on the card (5
   iterations).

12. the runner, checkpoints, the CLI's output and phase profiling, on the
   card. (a) arma forwards at 25 x 512 x K=100 through `run_smc_batched`
   and `runner.ChunkedRunner` in chunks of 10, with a checkpoint after each
   and without, in turns (each order forwards, then backwards): every
   SMCResult field equal to the bit, K dispatches a call, no plain call,
   the walls (CUDA events) and what a checkpoint adds. (b) A K=30 run with a checkpoint, then the
   K=100 run from the file: 70 dispatches, equal to (a) to the bit; the
   file's version and k_done. (c) PRMwCD adapted (bench.py:176-178) at
   25 x 512 x K=100, stopped after iteration 40 (its progress callback
   raises) and resumed: equal to the bit, the kernel launches of both sides.
   (d) Eight schools, asymptotic with tempering, N=1024, K=30, step 0.2,
   depth 6, save_history on and off, stopped after iteration 10 and resumed:
   equal to the bit. (e) `python -m smcnuts_torch --model prmwcd -N 512 -K 100
   --checkpoint --chunk-size 10 --output` through its main(): the npz equal
   to the in-process run_smc result in every field, to the bit; run again,
   it resumes at k_done == K, launches no kernel and returns the same
   summary. (f) `utils.profiling.phase_timings` on arma, one run at N=512:
   milliseconds an iteration of each phase. The launches of (a)-(e) count on
   their rows of the kernels line.

13. Stan programs on the card, through the port's frontend (`stan/`):
   examples/stan/radon_intercepts (D = 9, reverse mode, K7r), examples/stan/
   irt_ar (D = 64, forward, K7f) and the AR(1)-error recurrence of
   tests/test_stan_frontend.py at T = 200 (D = 2, forward, K7f). (a), before
   phase 2: each parsed, interpreted and traced on the card's machine
   (seconds each, the mode tile_autodiff="auto" chose, operations a
   leapfrog; the two forward programs' recurrences emitted as loops, else
   it fails), then one nvcc each, and one for each forward program's
   straight-line witness, all at once in the background (beside phase 2's);
   phase 13 prints their seconds and ptxas's lines. (c) run_smc_batched at 25 x 512 x
   K=100, forwards, depth 10, each at its step (STAN_PROGRAMS): K launches,
   no plain call, finite series, runs 0 and 24 equal their single runs to the
   bit; wall and the 25-run means beside the values that generated the data.
   (b) Each kernel against its plain version at 25 x 512 x depth 10 on the
   population (c) ended with, zero bits and Philox: equal to the bit; its
   device time, the plain version's and the bound; each forward program's
   straight-line witness equal to its kernel to the bit, with its ptxas
   lines and SASS counts, both timed in turns (median of 6). (d) radon without a
   generated model, eager by autograd on the card (its logp_and_grad a graph
   traced once and replayed), at 5 x 512 x K=20, beside the kernel's run of
   the same shape: the means within 4 MC standard errors; ms a
   logp_and_grad call of each eager model at 512 particles, interpreted,
   and for radon replayed (equal to the bit). (e)
   `python -m smcnuts_torch --stan radon --data ... --stan-tile -N 512 -K 100
   --step-size 0.05` (K launches, the JAX CLI's keys) and the same without
   --stan-tile at K=10 (eager, no launch), each with acceptance above 0 and
   a final ESS below N (the particles moved).

solvers. float64 on the card, the rest of the Stan frontend, the special
   functions of the generated lowering. (a), after phase 2b: lv_rk4 and the
   five special-function programs (STAN_PROGRAMS) traced with tile=True,
   in worker processes three at once, and each library's nvcc started as its
   trace ends, beside the later phases. Then: arma in float64 on the eager
   tree (F64_RUNS x F64_N x K=F64_K, depth F64_DEPTH, with and without
   tempering): float64 throughout, no NUTS kernel and no K5 launch, finite
   series, the float32 kernel run's moments inside the float64 runs' Monte
   Carlo spread, the float64 draws on the card equal to the CPU's; (b)
   lv_rk45 (the adaptive solver and its adjoint) in float64 through the
   ODE kernel (csrc/ode_dopri5.cuh, one launch a solve, its right-hand side
   generated): its call site on the kernel route; a run at 25 x 512 x
   K=LV_K, depth 10 on the eager tree, started around the data's generating
   values: finite, both ODE kernels launched, no NUTS kernel, the model
   calls an iteration; the solve and its adjoint held to their plain
   version (`solve_batched` / `_adjoint` over the same generated code) to
   the bit, step counts included, at LV_CHECK_N lanes and at LV_BLOCK lanes
   of the run's population, where both are timed, with ptxas's lines; a
   logp_and_grad call at LV_TIMED_N particles on the kernel route
   (replayed) and on the host loop (interpreted) side by side, both equal
   to the CPU's float64 values at rtol 1e-10, with the RK steps a particle;
   (c) lv_rk4 (ode_rk4 at LV_RK4_STEPS
   steps a year, K7r) at 25 x 512 x K=LV_RK4_K: K dispatches, no plain call,
   runs 0 and 24 equal their single runs; then on the population it ended
   with, the kernel against its plain version at 25 x 512 x depth 10, zero
   bits and Philox, to the bit (the plain program replayed as a CUDA graph,
   held to the program op by op), both timed there, and the kernel's
   bound; (d) the five special-function programs (N = 200): each kernel
   against its plain version likewise on a cloud around its generating
   values, timed, and a run at 25 x 512 x K=SPECIAL_K (its launches); the
   libdevice calls they emit (cos, sin, erf, erfc, lgamma) equal to torch's op on every float32 of the range the
   densities use (`ops.generated.libdevice_unary`), timed beside torch's
   op (a measurement entry).

tile_programs. every Stan program the JAX frontend tiles, through the
   generated NUTS kernel (`TILE_PROGRAMS`): examples/stan/mvn_quadform,
   inv_wishart_cov, multi_student_t and ordered_logistic, the algebra solver
   (16 Newton steps), the decay ODE (ode_rk45, the adaptive solve and its
   adjoint inlined in K7r), the lowering's new elementwise ops in one
   density in reverse mode (K7r) and in forward mode (K7f), and lv_rk45
   through K7r. (a), after phase 2b: each traced in a worker process (two
   at once) and built as its trace ends, beside the later phases. (b) Each
   program but lv_rk45 at 25 x 512 x K=TILE_K, forwards, depth 10: K
   launches, no plain call, finite series, runs 0 and 24 equal their single
   runs; then on its final population the kernel against its plain tree to
   the bit under zero bits and Philox at 25 x 512 x depth 10 (a program that
   solves an ODE: at ODE_BIT_LANES lanes x depth ODE_BIT_DEPTH, its plain
   tree stepping each solve from the host), timed, with the bound and
   ptxas's lines. (c) lv_rk45 through K7r at 25 x 512 x K=LV_K, depth 10,
   from phase solvers (b)'s start: K launches, its moments inside the bands
   of `estimates_band` against (b)'s eager float64 run, the RK steps its
   solves and adjoints took (the library's counter); then as (b)'s ODE
   program. The bound of a program that solves an ODE adds the RK steps of
   its timed call x the operations of a float32 step.

mesh. the particle and run axes over torch.distributed process groups
   (`smcnuts_torch/parallel/`; the ranks load the libraries phase 2 built).
   (a) `python -m torch.distributed.run --standalone --nproc-per-node 1 -m
   smcnuts_torch --mesh` arma at N=512, K=100, depth 10 on NCCL: its JSON
   equal to the run without --mesh. If the card's compute mode keeps a
   second process off it, (b)-(d) are not run and the phase says so. (b)
   arma forwards at N = 1,048,576 (the multihost entry's default), K=20,
   depth 10, over 2 and then 4 rank processes sharing the card (gloo on
   CUDA tensors; `parallel/gang.py`'s `wide` job): every field equal to
   the unsharded run on the card to the bit, K dispatches a rank, each
   rank's kernel on its final shard (device alone, one rank at a time),
   the collectives' calls, bytes and milliseconds an iteration, the walls
   beside the unsharded run's (one card: overhead, not scaling). (c)
   PRMwCD at 25 x 512 x K=100 over 2 ranks: each rank's "auto" stages its
   6,400 lanes; equal to the unsharded run to the bit. (d) `Supervisor`
   over 2 ranks of the multihost entry at (b)'s size, K=10 in chunks of 5,
   rank 1 exiting after chunk 1 (its recovery drill): the restarted gang
   resumes from the checkpoint, equal to the unsharded K=10 run and to (b)'s
   first 10 iterations to the bit. The ranks' dispatches count on the arma
   and PRMwCD rows of the kernels line.

The line before the last two repeats the card's name and power limit, the
second-to-last line is a JSON object describing the kernels (for each: the
launches on the main path, the error against its plain version, its time,
the plain version's, and the least time the card could take for the same
work, from this run's leapfrog count or particle count over the data
sheet's 67 TFLOP/s, and bytes over the data sheet's memory rate, and
bound_unfused_ms, the same with the FMUL+FADD peak measured in phase 2b for
the operations, what a build with -fmad=false can reach; no single PyTorch
call builds a NUTS tree,
computes the fused ARMA value and gradient or runs FMA chains, so there is no
library time; nor does any solve an ODE: the two ODE rows, the counterpart
of XLA's odeint loop and of no Pallas kernel, are float64 and bound by the
data sheet's FP64 rate, 34 TFLOP/s, without bound_unfused_ms). Every "ms" is
the device's time alone (utils/timing.device_ms);
"host_call_ms" beside it is one call timed alone between two events, the
host's launch included, as the rows were timed before. The witnesses' rows
(the W = 1 NUTS kernels of arma, PRMwCD, logistic regression and eight
schools, K5's, K7f straight-line and in the order it was built, the Stan
forward programs straight-line, and K7r split over 2 lanes) are
measurement entries: 0 launches on the main path and "measurement_entry":
true. The
last line is {"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside it, the script fails before printing any result.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

import torch

ATOL = RTOL = 1e-4
MIN_AGREE = 0.999
POST_MODE = (0.007, 0.957, -0.034, math.log(0.166))
K, N, MAX_DEPTH, STEP, SEED = 100, 512, 10, 0.01, 0
RUNS = 25  # bench.py's runs per launch
SEEDS = list(range(RUNS))
ADAPT_TARGET = 0.5  # bench.py:176-178
# Mean leapfrogs per particle-iteration that the JAX package counted for
# PRMwCD at this config (experiments/output/adaptation.json): algorithmic
# counts, independent of the device.
JAX_LEAPFROGS = {"fixed": 322.13, "adapted": 62.74}
# The splits of the JAX package's tile models (nuts_pallas.py:1862-1864,
# :1985-1986): what the staged checks run with where a model's own hint for
# this card is empty. The JAX package gives the three autodiff models none;
# (3, 6) is this script's choice for them.
REFERENCE_SPLITS = {"arma": (4,), "prmwcd": (7, 8, 9), "prmwcd_adapted": (5, 6),
                    "gaussian": (3, 6), "eightschools": (3, 6), "logistic": (3, 6)}
CANDIDATE_SPLITS = (
    tuple((s,) for s in range(1, MAX_DEPTH))
    + ((5, 6), (6, 8), (7, 8, 9), (3, 5, 7), (2, 4, 6, 8),
       tuple(range(1, MAX_DEPTH)))
)
# Single splits timed on the tiled populations of phase 6b, beside the
# candidates of more than one split: the depths where each workload's trees end.
WIDE_SINGLES = {"arma": ((2,), (3,), (4,)), "prmwcd": ((6,), (7,), (8,)),
                "prmwcd_adapted": ((4,), (5,), (6,))}
# NVIDIA's data sheet for the H100 SXM at 700 W: FP32 outside the tensor
# cores (a multiply-add counts as two) and device memory.
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
PEAK_FP64 = 34e12  # the data sheet's non-tensor FP64 rate (an FMA counted as two)
# Launches queued back to back behind a device-side wait for each device time
# of the kernels line (utils/timing.py::device_ms).
DEVICE_REPEATS = 20
# The FP32 rates this run measures (phase 2b, K8): "fmul_fadd", the rate of
# separately rounded multiplies and adds, the most a kernel built with
# -fmad=false reaches (every bound_unfused_ms divides by it); "fma" beside it.
MEASURED_PEAK = {}


def roofline(ops, nbytes):
    """The bound keys of the kernels line for work of `ops` FP32 operations
    and `nbytes` bytes moved: bound_ms, the larger of ops over the card's
    FP32 rate (the data sheet's, a multiply and an add fusing into one FMA)
    and bytes over its memory rate; bound_by, which of the two; and
    bound_unfused_ms, the same with the FMUL+FADD peak measured in phase 2b,
    what the port's -fmad=false builds can reach."""
    if "fmul_fadd" not in MEASURED_PEAK:
        raise AssertionError("the FP32 peak (phase 2b) has not been measured")
    t_ops, t_bytes = 1e3 * ops / PEAK_FP32, 1e3 * nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_unfused_ms": max(1e3 * ops / MEASURED_PEAK["fmul_fadd"], t_bytes)}
# FP32 operations of one leapfrog, counted from the sources: arma 19 a step
# of the T = 200 recurrence (csrc/arma_model.cuh) and ~100 for the closed
# forms and the leapfrog; PRMwCD 50 an observation x 100 (22 for eta, 22 for
# the covariate sums, 6 more, the expf as one; csrc/prmwcd_model.cuh) and
# ~230 for the prior, the leapfrog and the U-turn tests.
# The three autodiff models, with ~17 D + 30 for the leapfrog, the kinetic
# energy and the U-turn tests: Gaussian (D = 3, with a prior) 53 in the
# density and gradient (csrc/gaussian_model.cuh); eight schools 22 a school
# x 8 and ~25 around them (csrc/eightschools_model.cuh); logistic 44 an
# observation x 64 (15 for eta, 16 for the covariate sums, the expf, log1pf
# and division as one each) and ~60 for the prior and the gradient
# (csrc/logistic_model.cuh).
OPS_PER_LEAPFROG = {"arma": 19 * 200 + 100, "prmwcd": 50 * 100 + 230,
                    "gaussian": 53 + 81, "eightschools": 22 * 8 + 25 + 200,
                    "logistic": 44 * 64 + 60 + 166}
MODEL_DATA_FLOATS = {"arma": 200, "prmwcd": 100 * 12, "gaussian": 9,
                     "eightschools": 24, "logistic": 64 * 9}
# The three models whose in-kernel gradient is written out by hand (the JAX
# package differentiates the named tile density inside its kernel,
# nuts_pallas.py:1094): the step size of the synthetic cloud's trees, and the
# settings of the full-width run (tests/test_nuts_pallas.py:309-353 for the
# first two).
GAUSSIAN = dict(mean=(1.0, -2.0, 3.0), var=(0.5, 2.0, 1.0), prior_var=(9.0, 9.0, 9.0))
AUTODIFF_MODELS = {
    "gaussian": dict(density="smcnuts_tpu/models/gaussian.py:70", cloud_step=0.02,
                     n=2048, k=20, step=0.5, depth=5, lkernel="forwardsLKernel"),
    "eightschools": dict(density="smcnuts_tpu/models/eightschools.py:44",
                         cloud_step=0.02, n=1024, k=30, step=0.2, depth=6,
                         lkernel="forwardsLKernel"),
    "logistic": dict(density="smcnuts_tpu/models/logistic.py:44", cloud_step=0.01,
                     n=1024, k=30, step=0.1, depth=6, lkernel="asymptoticLKernel"),
}
REF_K = 25  # iterations of the logistic reference run on the plain tree
# (coordinate, value) that gives a lane a start density of -inf, per model.
NAN_LANE = {"arma": (3, 200.0), "prmwcd": (0, 200.0), "gaussian": (0, 1e20),
            "eightschools": (1, 200.0), "logistic": (0, 1e20)}


_PHASE_CLOCK = [time.perf_counter()]


def phase(name):
    now = time.perf_counter()
    print(f"\n== {name}  [+{now - _PHASE_CLOCK[0]:.0f} s since the last phase]",
          flush=True)
    _PHASE_CLOCK[0] = now


def device_phase():
    phase("1. device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return name, smi


def build_phase():
    from smcnuts_torch.ops.nuts_cuda import build_library

    phase("2. build")
    t0 = time.perf_counter()
    lib = build_library()
    print(f"built {os.path.relpath(lib.path)} in {lib.build_seconds:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s), kernel max_depth "
          f"{lib.max_depth}, PRMwCD covariates {lib.prmwcd_n_cov}, schools "
          f"{lib.eightschools_j}, logistic covariates {lib.logistic_dim}")
    n_inst = sum("Compiling entry" in line for line in lib.log.splitlines())
    if lib.build_seconds > 60.0:
        raise AssertionError(f"the build of {n_inst} kernels took "
                             f"{lib.build_seconds:.1f} s, more than a minute")
    print(f"{n_inst} kernels (the NUTS tree's first stage and continuation of "
          f"each entry, the fused ARMA value and gradient, and the FP32 peak's "
          f"eight), one nvcc a source, all at once")
    for line in lib.log.splitlines():
        if ("Compiling entry" in line or "registers" in line or "spill" in line
                or "stack frame" in line):
            print("  ptxas:", line.strip())
    return lib


# ---- phase 2b: the FP32 peak (K8), the denominator of every bound.

PEAK_CHECK_STEPS = 64  # steps of the kernel-vs-plain check


def peak_phase(smi):
    """Phase 2b: K8 against its plain chain, then its rows; sets
    MEASURED_PEAK and returns what the kernels line says of K8."""
    from smcnuts_torch.ops.peak import (
        BLOCKS_PER_SM, CHAINS, STEPS, THREADS, flops, fma_chains, fma_chains_plain,
        launch_size, peak_table)
    from smcnuts_torch.utils.timing import median_ms

    phase("2b. FP32 peak (K8)")
    dev = torch.device("cuda")
    n = launch_size(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"launch: {BLOCKS_PER_SM} blocks of {THREADS} threads on each of {sms} "
          f"SMs, {n} threads; {STEPS} steps a chain")
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    worst = 0.0
    for c in CHAINS:
        plain = fma_chains_plain(x, c, PEAK_CHECK_STEPS)
        sep = fma_chains(x, c, PEAK_CHECK_STEPS, "fmul_fadd")
        fused = fma_chains(x, c, PEAK_CHECK_STEPS, "fma")
        torch.cuda.synchronize()
        if not torch.equal(sep, plain):
            raise AssertionError(f"K8 FMUL+FADD, {c} chains: differs from the plain chain")
        # Each step of a chain rounds once less fused: at most one spacing of
        # the chain's value a step, c chains summed.
        tol = c * PEAK_CHECK_STEPS * 2.0 ** -23 * (float(x.abs().max()) + 0.125 * c + 1.0)
        err = float((fused - plain).abs().max())
        if not err <= tol:
            raise AssertionError(f"K8 FMA, {c} chains: |kernel - plain| {err:.3g} > {tol:.3g}")
        worst = max(worst, err)
        print(f"K8 {c} chains, {PEAK_CHECK_STEPS} steps: FMUL+FADD equal to the plain "
              f"chain to the bit; FMA within {err:.3g} of it (bound {tol:.3g})")
    reset_counts()
    rows = peak_table(dev)
    launches = fma_chains.launches
    for r in rows:
        print(f"peak {r['variant']:9s} {r['nchains']:2d} chains: {r['ms']:.4f} ms a "
              f"launch, {r['tflops']:.3f} TFLOP/s (device alone, median of 5 of 20 "
              f"launches back to back; {smi})")
    for variant in ("fma", "fmul_fadd"):
        MEASURED_PEAK[variant] = 1e12 * max(r["tflops"] for r in rows
                                            if r["variant"] == variant)
    print(f"peak: FMA {MEASURED_PEAK['fma'] / 1e12:.3f} TFLOP/s, FMUL+FADD "
          f"{MEASURED_PEAK['fmul_fadd'] / 1e12:.3f} TFLOP/s ({smi}); every bound "
          f"below divides by the data sheet's {PEAK_FP32 / 1e12:.0f}, every "
          f"bound_unfused_ms by the FMUL+FADD rate (the kernels are built with "
          f"-fmad=false)")
    best = max((r for r in rows if r["variant"] == "fma"), key=lambda r: r["tflops"])
    c = best["nchains"]
    plain_ms = median_ms(lambda: fma_chains_plain(x, c, STEPS), repeats=1, warmup=0)
    host_ms = median_ms(lambda: fma_chains(x, c, STEPS, "fma"), repeats=5)
    work = flops(n, c, STEPS)
    return {"launches": launches, "max_abs_err": worst, "ms": best["ms"],
            "host_call_ms": host_ms, "plain_ms": plain_ms, **roofline(work, 8 * n)}


def reset_counts():
    from smcnuts_torch.ops.arma_fused import arma_ll_vg, arma_ll_vg_plain
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.ops.ode import dopri5, dopri5_adjoint
    from smcnuts_torch.ops.peak import fma_chains

    nuts_tree.launches = 0
    nuts_tree.model_launches = {k: 0 for k in nuts_tree.model_launches}
    nuts_tree.r_given_launches = {k: 0 for k in nuts_tree.r_given_launches}
    nuts_tree.stage_launches = 0
    nuts_tree.cont_launches = {k: 0 for k in nuts_tree.cont_launches}
    nuts_tree.entry_launches = {}
    nuts_tree_plain.calls = 0
    nuts_tree_plain.model_calls = 0
    arma_ll_vg.launches = 0
    arma_ll_vg_plain.calls = 0
    fma_chains.launches = 0
    dopri5.launches = 0
    dopri5_adjoint.launches = 0


def read_counts():
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain

    return dict(nuts_tree.model_launches), nuts_tree_plain.calls


def read_stage_counts():
    """(kernel launches of every stage, launches of each model's
    continuation-stage kernel) since reset_counts."""
    from smcnuts_torch.ops.nuts_cuda import nuts_tree

    return nuts_tree.stage_launches, dict(nuts_tree.cont_launches)


def particles(n, seed, device):
    """arma: three quarters at POST_MODE +- 0.02, one quarter dispersed
    (+- 0.3)."""
    g = torch.Generator(device=device).manual_seed(seed)
    mode = torch.tensor(POST_MODE, device=device)
    x = mode + 0.02 * torch.randn(n, 4, generator=g, device=device)
    q = n // 4
    x[:q] = mode + 0.3 * torch.randn(q, 4, generator=g, device=device)
    return x


def prmwcd_particles(shape, seed, device):
    """PRMwCD: three quarters within 0.1 posterior sd of the posterior mean
    (Gamma on the log scale), one quarter within 1 sd."""
    from smcnuts_torch.models.prmwcd import ground_truth

    mean, var = ground_truth()
    centre = [float(v) for v in mean[:12]] + [math.log(float(mean[12]))]
    sd = [float(v) ** 0.5 for v in var[:12]] + [float(var[12]) ** 0.5 / float(mean[12])]
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(*shape, 13, generator=g, device=device)
    scale = torch.full(shape, 0.1, device=device)
    scale[..., : shape[-1] // 4] = 1.0
    return (torch.tensor(centre, device=device)
            + scale[..., None] * torch.tensor(sd, device=device) * z).contiguous()


def compare(label, model, args, r=None, nan_lanes=False, bitwise=False):
    """Run kernel and plain version on the same inputs; return max abs err."""
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain

    return check_outputs(label, nuts_tree(model, *args, r=r),
                         nuts_tree_plain(model, *args, r=r), nan_lanes=nan_lanes,
                         bitwise=bitwise)


def check_outputs(label, out_k, out_p, nan_lanes=False, quiet=False, bitwise=False):
    """Hold a kernel's outputs to the plain version's by the contract of
    phase 3; return max abs err on agreeing lanes. With nan_lanes, a value
    that is not finite passes where the other side holds the same value.
    With bitwise, every output must also equal the plain version's to the
    bit (NaN equal to NaN)."""
    torch.cuda.synchronize()
    if bitwise:
        diff = bitwise_differences(out_k, out_p)
        if diff:
            raise AssertionError(f"{label}: the kernel differs from its plain "
                                 f"version in {diff}")
    xk, rk, sk = out_k
    xp, rp, sp = out_p
    agree = ((sk["depth"] == sp["depth"]) & (sk["leapfrogs"] == sp["leapfrogs"])
             & (sk["moved"] == sp["moved"]))
    share = float(agree.float().mean())
    if share < MIN_AGREE:
        raise AssertionError(f"{label}: only {100 * share:.3f}% of lanes agree")
    pairs = {"x": (xk, xp), "r": (rk, rp)}
    pairs.update({k: (sk[k], sp[k]) for k in sk})
    worst, diffs = 0.0, []
    for k, (a, b) in pairs.items():
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        finite = torch.isfinite(a) & torch.isfinite(b)
        if not bool((finite | same).all() if nan_lanes else finite.all()):
            raise AssertionError(f"{label}: non-finite {k}")
        d = torch.where(same, torch.zeros_like(a), (a - b).abs())
        diffs.append(f"{k}={float(d.max()):.3g}")
        if k in ("x", "r", "logp0", "logp_prop", "delta_h"):
            lanes = agree if d.dim() == 2 else agree[..., None].expand_as(d)
            bad = lanes & ~same & (d > ATOL + RTOL * b.abs())
            if bad.any():
                raise AssertionError(
                    f"{label}: {k} differs beyond atol {ATOL} + rtol {RTOL} "
                    f"on {int(bad.sum())} values of agreeing lanes"
                )
            worst = max(worst, float(d[lanes].max()))
    if not quiet:
        print(f"{label}: {agree.numel()} lanes, mean depth "
              f"{float(sk['depth'].mean()):.3f}, integer outputs agree on "
              f"{100 * share:.3f}%; max |kernel - plain|: {', '.join(diffs)}")
    return worst


def bitwise_differences(a, b):
    """Names of the outputs of two tree calls that differ in any bit (NaN
    equal to NaN)."""
    pairs = {"x": (a[0], b[0]), "r": (a[1], b[1])}
    pairs.update({k: (a[2][k], b[2][k]) for k in a[2]})
    return [k for k, (u, v) in pairs.items()
            if not bool(((u == v) | (torch.isnan(u) & torch.isnan(v))).all())]


def equal_fields(a, b):
    """Names of the SMCResult fields in which a and b differ in any bit."""
    return [f for f, v in a._asdict().items()
            if v is not None and not torch.equal(v, getattr(b, f))]


def single_run_diff(one, res, b):
    """Names of the fields in which the single run `one` differs from run b
    of the batched result `res` in any bit (NaN equal to NaN: a particle
    whose density is NaN, as irt_ar's at a prior draw with |rho| > 1, has a
    NaN weight in both)."""
    def same(u, v):
        return torch.equal(u, v) or (u.is_floating_point() and u.shape == v.shape and bool(
            ((u == v) | (torch.isnan(u) & torch.isnan(v))).all()))

    return [f for f, v in one._asdict().items()
            if v is not None and not same(v, getattr(res, f)[b])]


def tree_roofline(name, out, survivors=(), bundle_rows=0, model=None):
    """The bound keys (`roofline`) for the trees of `out`: their model
    evaluations (the kernel's own leapfrogs output) x the model's
    operations, and the bytes moved (every input read once, every output
    written once, and for a staged dispatch every survivor's bundle column
    written once and read once). A generated `model` counts its program's
    operations, exact, and its data block."""
    x_out, _, st = out
    B, n, D = x_out.shape
    P = B * n
    per_leapfrog = OPS_PER_LEAPFROG[name] if model is None else model.n_ops
    data_floats = MODEL_DATA_FLOATS[name] if model is None else model.data.numel()
    ops = float(st["leapfrogs"].sum()) * per_leapfrog
    floats = (P * D + 3 * B + B * D + data_floats  # inputs
              + 2 * P * D + len(st) * P  # outputs
              + 2 * bundle_rows * sum(survivors))
    return roofline(ops, 4 * floats)


def kernel_times(fn):
    """What the kernels line says of a kernel's time: ms, the device's time a
    call of fn (`utils.timing.device_ms`: DEVICE_REPEATS calls back to back
    behind a device-side wait, events around them), and host_call_ms, the
    median of 5 calls each timed alone between two events on an idle
    stream, the host's launch included (how the rows were timed before
    device_ms; kept beside the device time so that the two compare)."""
    from smcnuts_torch.utils.timing import device_ms, median_ms

    return {"ms": device_ms(fn, repeats=DEVICE_REPEATS),
            "host_call_ms": median_ms(fn, repeats=5)}


def times_text(t):
    """A kernel's times (`kernel_times`) as one printed phrase."""
    return (f"kernel {t['ms']:.4f} ms on the device alone ({DEVICE_REPEATS} launches "
            f"back to back), {t['host_call_ms']:.4f} ms a call timed alone")


def ptxas_lines(log):
    """ptxas's lines of registers, stack and spills in an nvcc log."""
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "stack frame" in line]


def time_pair(label, model, args, smi):
    """The kernel's times (`kernel_times`) and plain_ms, the plain version's
    one call (CUDA events; the caller has just run it on these inputs, and
    one run takes seconds)."""
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import median_ms

    t = kernel_times(lambda: nuts_tree(model, *args))
    t["plain_ms"] = median_ms(lambda: nuts_tree_plain(model, *args), repeats=1, warmup=0)
    print(f"time {label}: {times_text(t)}, plain {t['plain_ms']:.1f} ms ({smi})")
    return t


def staged_kernel_phase(name, model, batch_args, single_out, plain_out, smi,
                        bitwise=False):
    """The staged dispatch of one model at the batched main path's shape,
    against the single kernel (to the bit) and the plain version (by the
    contract; with bitwise, to the bit); returns what the kernels line says
    of it. single_out and plain_out are the outputs for batch_args, computed
    by the caller."""
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import build_library, nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import median_ms

    x, seed, step, phi, im, depth, _ = batch_args
    dev = x.device
    own = model.compaction_hint or REFERENCE_SPLITS[name]
    split_sets = tuple(dict.fromkeys(
        (own, REFERENCE_SPLITS[name]) + tuple((s,) for s in range(1, depth))
        + (tuple(range(1, depth)),)))
    # A lane whose start density is -inf, so that its delta_h is NaN (arma:
    # sigma = e^200; PRMwCD: an intercept of 200; eight schools: tau = e^200;
    # Gaussian and logistic: a coordinate of 1e20, whose square overflows):
    # under zero bits u = 2^-24 and the slice lies 16.6 nats below the start,
    # so every finite delta_h accepts and only such a lane rejects.
    x_nan = x.clone()
    x_nan[0, 0, NAN_LANE[name][0]] = NAN_LANE[name][1]
    r = torch.randn(x.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    cases = (
        ("philox", x, PHILOX, False, None, single_out, plain_out),
        ("philox, acc_rej", x, PHILOX, True, None, None, None),
        ("zero_bits", x_nan, ZERO_BITS, False, None, None, None),
        ("zero_bits, acc_rej", x_nan, ZERO_BITS, True, None, None, None),
        ("philox, acc_rej, r given", x, PHILOX, True, r, None, None),
    )
    worst = 0.0
    for label, xc, source, acc, rc, single, plain in cases:
        label = f"{name} staged [{label}]"
        args = (xc, seed, step, phi, im, depth, source)
        kw = dict(r=rc, acc_rej=acc)
        if single is None:
            single = nuts_tree(model, *args, **kw)
            plain = nuts_tree_plain(model, *args, **kw)
        worst = max(worst, check_outputs(f"{label} single kernel", single, plain,
                                         nan_lanes=True, bitwise=bitwise))
        dh, moved = single[2]["delta_h"], single[2]["moved"]
        if source == ZERO_BITS:
            nan = torch.isnan(dh)
            if not (bool(nan.any()) and bool((moved[nan] == 0).all())
                    and bool((moved[~nan] == 1).any())):
                raise AssertionError(f"{label}: the NaN lane must not move and "
                                     f"others must")
            if acc and not torch.equal(single[0][nan], xc[nan]):
                raise AssertionError(f"{label}: a rejected lane must keep its x")
        for splits in split_sets:
            staged = nuts_tree(model, *args, compaction=splits, **kw)
            if splits == own:
                survivors = survivor_counts()
            diff = bitwise_differences(staged, single)
            if diff:
                raise AssertionError(f"{label}: splits {splits} differ from the "
                                     f"single kernel in {diff}")
            worst = max(worst, check_outputs(f"{label} splits {splits}", staged,
                                             plain, nan_lanes=True, quiet=True,
                                             bitwise=bitwise))
        print(f"{label}: {len(split_sets)} split tuples ({own}, "
              f"{REFERENCE_SPLITS[name]}, one split at each depth "
              f"1..{depth - 1}, all of them) equal the single kernel "
              f"to the bit on every output; lanes that did not move "
              f"{int((moved == 0).sum())}, NaN delta_h {int(torch.isnan(dh).sum())}; "
              f"survivors after {own}: {survivors}")
    staged_out = nuts_tree(model, *batch_args, compaction=own)
    survivors = survivor_counts()
    t = kernel_times(lambda: nuts_tree(model, *batch_args, compaction=own))
    plain_ms = median_ms(
        lambda: nuts_tree_plain(model, *batch_args, compaction=own),
        repeats=1, warmup=0)
    bound = tree_roofline(name, staged_out, survivors,
                          build_library().bundle_rows(x.shape[2]))
    print(f"time {name} staged {own}, {RUNS} x {N} x depth {depth} [philox]: "
          f"{times_text(t)}, in {len(own) + 1} launches a call, plain {plain_ms:.1f} ms "
          f"(one call); {bound_text(bound)} ({smi})")
    return {"max_abs_err": worst, **t, "plain_ms": plain_ms, **bound}


def arma_cloud(n, seed, device):
    """arma particles (n, 4): the cloud of `particles`, and where n allows,
    lanes with log_sigma = +-20 and +-60 (inv_s2 of e^-40, e^40, 0 and inf
    in float32) and lanes with |theta| >= 2, where the error recurrence
    overflows (an inf in the sequential order, an inf or a NaN in the group
    order: a density that is not finite either way)."""
    x = particles(n, seed, device).contiguous()
    for i, (col, v) in enumerate(((3, 20.0), (3, -20.0), (3, 60.0), (3, -60.0),
                                  (2, 2.0), (2, -2.5), (2, 3.0), (2, -7.0))):
        if 4 * (i + 1) < n:
            x[4 * (i + 1), col] = v
    return x


# arma trees timed at the width where one thread a tree fills the card.
WIDE_TREES = 1 << 20


def arma_kernel_phase(smi):
    from smcnuts_torch.models import get_model
    from smcnuts_torch.models.arma import GROUP
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import build_library, nuts_tree, nuts_tree_plain

    phase("3. arma kernel vs plain")
    dev = torch.device("cuda")
    model = get_model("arma").to(dev)
    lib = build_library()
    print(f"arma entry: W={GROUP} lanes a tree, blocks of {lib.arma_block} threads, "
          f"{lib.arma_blocks_per_sm} blocks an SM at once")
    ones = torch.ones(4, device=dev)
    im = torch.tensor([0.5, 2.0, 1.5, 0.25], device=dev)
    seed2 = torch.tensor([11, 12], dtype=torch.int32, device=dev)
    phis = torch.tensor([1.0, 0.4], device=dev)
    worst = 0.0
    for source in (ZERO_BITS, PHILOX):
        x2 = arma_cloud(4096, 1, dev).view(2, 2048, 4)
        worst = max(worst, compare(
            f"[{source}] phi 1.0 | 0.4, 2 runs x 2048, depth 6", model,
            (x2, seed2, 0.01, phis, ones, 6, source), nan_lanes=True, bitwise=True))
        x1 = arma_cloud(4096, 2, dev)[None]
        worst = max(worst, compare(
            f"[{source}] inv_mass {im.tolist()}, 4096, depth 6", model,
            (x1, 13, 0.01, 1.0, im, 6, source), nan_lanes=True, bitwise=True))
    r = torch.randn(1, 4096, 4, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    worst = max(worst, compare(
        "[zero_bits] r given, 4096, depth 0", model,
        (arma_cloud(4096, 4, dev)[None], 0, 0.01, 0.7, im, 0, ZERO_BITS), r=r,
        nan_lanes=True, bitwise=True))
    main_args = (particles(N, 5, dev)[None], 21, STEP, 1.0, ones, MAX_DEPTH, PHILOX)
    worst = max(worst, compare(
        f"[philox] main path shape, {N}, depth {MAX_DEPTH}", model, main_args,
        bitwise=True))
    batch_args = (particles(RUNS * N, 6, dev).view(RUNS, N, 4),
                  torch.arange(RUNS, dtype=torch.int32, device=dev), STEP, 1.0,
                  ones, MAX_DEPTH, PHILOX)
    single_out = nuts_tree(model, *batch_args)
    plain_out = nuts_tree_plain(model, *batch_args)
    worst = max(worst, check_outputs(
        f"[philox] batched main path shape, {RUNS} x {N}, depth {MAX_DEPTH}",
        single_out, plain_out, bitwise=True))
    print(f"arma: the group kernel (W={GROUP}) equals its plain version to the bit "
          f"in every case, the lanes whose density is not finite included")
    time_pair(f"arma {N} x depth {MAX_DEPTH} [philox]", model, main_args, smi)
    times = time_pair(f"arma {RUNS} x {N} x depth {MAX_DEPTH} [philox]",
                      model, batch_args, smi)
    bound = tree_roofline("arma", single_out)
    print(f"arma: max |kernel - plain| on agreeing lanes, all cases: {worst:.3g}; "
          f"at {RUNS} x {N}: {bound_text(bound)}")
    whole = {"max_abs_err": worst, **times, **bound}
    small = (arma_cloud(2048, 7, dev).view(2, 1024, 4), seed2, 0.01, phis, ones, 6,
             ZERO_BITS)
    wide = (particles(WIDE_TREES, 8, dev)[None], 31, STEP, 1.0, ones, MAX_DEPTH, PHILOX)
    witness = measurement_entries("arma", model, batch_args, single_out, small, smi,
                                  wide=(wide,))
    wide_out = nuts_tree(model, *wide)
    print(f"arma at {WIDE_TREES} trees, depth {MAX_DEPTH}: "
          f"{bound_text(tree_roofline('arma', wide_out))}")
    return whole, staged_kernel_phase("arma", model, batch_args, single_out,
                                      plain_out, smi, bitwise=True), witness


def prmwcd_kernel_phase(smi):
    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain

    phase("4. PRMwCD kernel vs plain")
    dev = torch.device("cuda")
    model = get_model("prmwcd").to(dev)
    ones = torch.ones(13, device=dev)
    im = torch.tensor([0.5, 2.0, 1.5, 0.25, 1.0, 0.8, 1.2, 0.6, 1.4, 0.9, 1.1,
                       0.7, 3.0], device=dev)
    seed2 = torch.tensor([11, 12], dtype=torch.int32, device=dev)
    phis = torch.tensor([1.0, 0.4], device=dev)
    worst = 0.0
    for source in (ZERO_BITS, PHILOX):
        worst = max(worst, compare(
            f"[{source}] phi 1.0 | 0.4, 2 runs x 1024, depth 6", model,
            (prmwcd_particles((2, 1024), 1, dev), seed2, STEP, phis, ones, 6, source),
            bitwise=True))
        worst = max(worst, compare(
            f"[{source}] 13-vector inv_mass, 2048, depth 6", model,
            (prmwcd_particles((1, 2048), 2, dev), 13, STEP, 1.0, im, 6, source),
            bitwise=True))
    r = torch.randn(1, 2048, 13, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    worst = max(worst, compare(
        "[zero_bits] r given, 2048, depth 0", model,
        (prmwcd_particles((1, 2048), 4, dev), 0, STEP, 0.7, im, 0, ZERO_BITS), r=r,
        bitwise=True))
    batch_args = (prmwcd_particles((RUNS, N), 5, dev),
                  torch.arange(RUNS, dtype=torch.int32, device=dev), STEP, 1.0,
                  ones, MAX_DEPTH, PHILOX)
    single_out = nuts_tree(model, *batch_args)
    plain_out = nuts_tree_plain(model, *batch_args)
    worst = max(worst, check_outputs(
        f"[philox] batched main path shape, {RUNS} x {N}, depth {MAX_DEPTH}",
        single_out, plain_out, bitwise=True))
    print("PRMwCD: the group kernel equals its plain version to the bit in every case")
    times = time_pair(f"PRMwCD {RUNS} x {N} x depth {MAX_DEPTH} [philox]",
                      model, batch_args, smi)
    bound = tree_roofline("prmwcd", single_out)
    print(f"PRMwCD: max |kernel - plain| on agreeing lanes, all cases: {worst:.3g}; "
          f"at {RUNS} x {N}: {bound_text(bound)}")
    whole = {"max_abs_err": worst, **times, **bound}
    small = (prmwcd_particles((2, 1024), 1, dev),
             torch.tensor([11, 12], dtype=torch.int32, device=dev), STEP,
             torch.tensor([1.0, 0.4], device=dev), torch.ones(13, device=dev), 6,
             ZERO_BITS)
    witness = measurement_entries("prmwcd", model, batch_args, single_out, small, smi)
    return whole, staged_kernel_phase("prmwcd", model, batch_args, single_out,
                                      plain_out, smi, bitwise=True), witness


# Rounds of the timing in turns of phases 3, 4, 8 and 11: each round times
# every entry of a model (on the device alone, DEVICE_REPEATS launches), in
# the opposite order to the round before.
VARIANT_ROUNDS = 6


def timed_in_turns(calls):
    """(times, medians): each of `calls` (name -> function) timed on the
    device alone VARIANT_ROUNDS times, in turns."""
    import statistics

    from smcnuts_torch.utils.timing import device_ms

    names = list(calls)
    rounds = {k: [] for k in names}
    for i in range(VARIANT_ROUNDS):
        for k in (names if i % 2 == 0 else names[::-1]):
            rounds[k].append(device_ms(calls[k], repeats=DEVICE_REPEATS))
    return rounds, {k: statistics.median(v) for k, v in rounds.items()}


def model_ptxas(log, model):
    """ptxas's stack and register lines for every instantiation of the NUTS
    kernel with the model (`"arma"`, `"prmwcd"`, `"logistic"` or
    `"eightschools"`), by a readable name (group width, stage, threads a
    block)."""
    import re

    lines, name = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1] if "'" in line else line
            lines[name] = []
        elif name is not None and ("stack frame" in line or "registers" in line):
            lines[name].append(line.split(":", 1)[-1].strip())
    # nuts_tree_kernel<ArmaModel<W>, kCont, kBlock>,
    # nuts_tree_kernel<PrmwcdModel<NCov, W>, kCont, kBlock>,
    # nuts_tree_kernel<LogisticModel<Dim, W>, kCont, kBlock> or
    # nuts_tree_kernel<EightSchoolsModel<J, W>, kCont, kBlock>, mangled.
    pattern = re.compile({
        "arma": r"ArmaModelILi(\d+)EEELb([01])ELi(\d+)E",
        "prmwcd": r"PrmwcdModelILi\d+ELi(\d+)EEELb([01])ELi(\d+)E",
        "logistic": r"LogisticModelILi\d+ELi(\d+)EEELb([01])ELi(\d+)E",
        "eightschools": r"EightSchools(?:ModelILi\d+ELi(\d+)EE|Uncapped)ELb([01])ELi(\d+)E"}[model])
    out = {}
    for mangled, info in lines.items():
        m = pattern.search(mangled)
        if m is None:
            continue
        w, cont, block = m.groups()
        label = (f"W={w or '2 uncapped'}, {'continuation' if cont == '1' else 'first stage'}, "
                 f"{block} threads")
        out[label] = "; ".join(info)
    if not out:
        raise AssertionError(f"no {model} instantiation found in the nvcc log")
    return out


def measurement_entries(name, model, batch_args, single_out, small, smi, wide=()):
    """A model's measurement entries (`ops.nuts_cuda.ARMA_VARIANTS`,
    `PRMWCD_VARIANTS`, `LOGISTIC_VARIANTS` or `EIGHTSCHOOLS_VARIANTS`) at the
    batched main path's
    shape: each entry of another
    group width than the main path's equal to the plain version at its width
    (`model.at_group(W)`) to the bit, the W = 1 witness (one thread a particle,
    the sequential order) also on `small` (phi 1.0 and 0.4, zero bits); an
    entry of the main path's width equal to the main path's entry to the
    bit. Then every entry timed in turns (on the device alone, median of
    VARIANT_ROUNDS), with ptxas's lines; for each argument tuple of `wide`
    (other shapes, not checked against the plain version, which would take
    too long there) the main entry and the witness once more in turns there.
    Returns what the
    kernels line says of the witness: a measurement entry, which the main
    path launches no time."""
    from smcnuts_torch.models import arma, eightschools, logistic, prmwcd
    from smcnuts_torch.ops.nuts_cuda import (
        ARMA_VARIANTS, EIGHTSCHOOLS_VARIANTS, LOGISTIC_VARIANTS, PRMWCD_VARIANTS,
        build_library, nuts_tree, nuts_tree_plain, nuts_tree_variant)
    from smcnuts_torch.utils.timing import CudaTimer, median_ms

    variants, mod = {"arma": (ARMA_VARIANTS, arma), "prmwcd": (PRMWCD_VARIANTS, prmwcd),
                     "logistic": (LOGISTIC_VARIANTS, logistic),
                     "eightschools": (EIGHTSCHOOLS_VARIANTS, eightschools)}[name]
    group, block = mod.GROUP, mod.BLOCK
    witness_key = next(v for v, (_, g, _) in variants.items() if g == 1)
    for v in variants:
        nuts_tree_variant.launches[v] = 0
    errs = {witness_key: [check_outputs(
        f"{name} witness W=1 [zero_bits] phi 1.0 | 0.4, small cloud", nuts_tree_variant(
            witness_key, model, *small), nuts_tree_plain(model.at_group(1), *small),
        nan_lanes=True, bitwise=True)]}
    outs, plain_ms, plains = {}, {}, {}
    for variant, (_, w, b) in variants.items():
        out = nuts_tree_variant(variant, model, *batch_args)
        label = f"{name} {variant} (W={w}, {b} threads) {RUNS} x {N}, depth {MAX_DEPTH}"
        if w == group:
            diff = bitwise_differences(out, single_out)
            if diff:
                raise AssertionError(f"{label}: differs from the main entry in {diff}")
            print(f"{label}: equal to the main path's entry to the bit")
        else:
            if w not in plains:
                with CudaTimer() as t:
                    plains[w] = nuts_tree_plain(model.at_group(w), *batch_args)
                plain_ms[variant] = t.ms
            errs.setdefault(variant, []).append(check_outputs(
                f"{label} vs plain group={w}", out, plains[w], bitwise=True))
        outs[variant] = out
    witness_host = median_ms(lambda: nuts_tree_variant(witness_key, model, *batch_args),
                             repeats=5)

    def in_turns(calls, args_label):
        rounds, med = timed_in_turns(calls)
        for k in calls:
            print(f"time {name} {k} ({described[k]}), {args_label} [philox]: "
                  f"{med[k]:.4f} ms, {med[witness_key] / med[k]:.3f}x faster than the "
                  f"W=1 witness (device alone, {DEVICE_REPEATS} launches back to "
                  f"back; median of {VARIANT_ROUNDS} in turns: "
                  f"{', '.join(f'{v:.4f}' for v in rounds[k])}; {smi})")
        return med

    described = {"main": f"W={group}, {block} threads, the main path's entry"}
    described.update({v: f"W={w}, {b} threads" for v, (_, w, b) in variants.items()})
    calls = {"main": lambda: nuts_tree(model, *batch_args)}
    calls.update({v: (lambda v=v: nuts_tree_variant(v, model, *batch_args))
                  for v in variants})
    med = in_turns(calls, f"{RUNS} x {N} x depth {MAX_DEPTH}")
    for args in wide:
        x = args[0]
        in_turns({"main": lambda: nuts_tree(model, *args),
                  witness_key: lambda: nuts_tree_variant(witness_key, model, *args)},
                 f"{x.shape[0]} x {x.shape[1]} x depth {args[5]}, step {args[2]}")
    lib = build_library()
    for label, info in model_ptxas(lib.log, name).items():
        print(f"  ptxas {name} {label}: {info}")
    witness = outs[witness_key]
    bound = tree_roofline(name, witness)
    print(f"{name} witness W=1: {bound_text(bound)}; launches in this phase (not on "
          f"the main path) {nuts_tree_variant.launches[witness_key]}")
    return {"launches": 0, "measurement_entry": True,
            "max_abs_err": max(errs[witness_key]), "ms": med[witness_key],
            "host_call_ms": witness_host, "plain_ms": plain_ms[witness_key], **bound}


def check_run(label, mean, means_ok_sd):
    from smcnuts_torch.models.arma import ground_truth

    gt_mean, gt_var = ground_truth()
    sd = gt_var ** 0.5
    z = [(m - g) / s for m, g, s in zip(mean, gt_mean, sd)]
    print(f"{label}: final means {[round(m, 5) for m in mean]}, "
          f"ground truth {[round(float(g), 5) for g in gt_mean]}, "
          f"(mean - truth) / sd {[round(float(v), 3) for v in z]}")
    if not all(math.isfinite(v) and abs(v) <= means_ok_sd for v in z):
        raise AssertionError(f"{label}: a final mean is more than "
                             f"{means_ok_sd} posterior sd from the ground truth")


def check_series(label, res, k):
    """Every series finite with k+1 entries on its iteration axis (axis -2
    for the estimates, -1 for the scalar series)."""
    for name, v in res._asdict().items():
        if v is None or name in ("x_saved", "logw_saved", "x_final", "logw_final"):
            continue
        axis = -2 if name in ("mean_estimate", "variance_estimate") else -1
        if v.shape[axis] != k + 1 or not torch.isfinite(v.float()).all():
            raise AssertionError(f"{label}: series {name}: shape "
                                 f"{tuple(v.shape)} or not finite")


def quiet_cli(argv):
    """`python -m smcnuts_torch` through its main(); its JSON summary is
    returned, not printed."""
    from smcnuts_torch.__main__ import main as cli_main

    with contextlib.redirect_stdout(io.StringIO()):
        return cli_main(argv)


def main_path_phase(smi):
    from smcnuts_torch import SMCSampler
    from smcnuts_torch.models import get_model
    from smcnuts_torch.utils.timing import CudaTimer

    phase("5. arma main path, one run")
    sampler = SMCSampler(K=K, N=N, target=get_model("arma"), step_size=STEP,
                         device="cuda")
    reset_counts()
    with CudaTimer() as t:
        res = sampler.sample(seed=SEED)
    counts, plain_calls = read_counts()
    wall_ms = t.ms
    print(f"SMCSampler: kernel launches {counts}, plain calls {plain_calls}")
    if counts["arma"] != K or plain_calls != 0:
        raise AssertionError("the main path did not run the kernel once per iteration")
    check_series("SMCSampler", res, K)
    if float(res.acceptance_rate[K]) != 0.0:
        raise AssertionError("acceptance[K] must be 0")
    check_run("SMCSampler", res.mean_estimate[K].tolist(), 1.0)
    ess = res.ess.cpu()
    print(f"SMCSampler: ESS final {float(ess[K]):.1f}, min {float(ess.min()):.1f}; "
          f"resampled {int(res.resampled.sum())}/{K}; mean tree depth "
          f"{float(res.tree_depth[:K].mean()):.3f}, leapfrogs "
          f"{float(res.tree_leapfrogs[:K].mean()):.2f}; acceptance "
          f"{float(res.acceptance_rate[:K].mean()):.3f}")
    rate = N * K / (wall_ms / 1000.0)
    print(f"SMCSampler: wall {wall_ms:.1f} ms for K={K} (CUDA events, results "
          f"on the host), {rate:.0f} particle-iterations/s, host run_time "
          f"{sampler.run_time:.3f} s ({smi})")
    launches = counts["arma"]

    reset_counts()
    summary = quiet_cli(["--model", "arma", "-N", str(N), "-K", str(K),
                         "--step-size", str(STEP), "--max-tree-depth",
                         str(MAX_DEPTH), "--seed", str(SEED), "--device", "cuda"])
    counts, plain_calls = read_counts()
    print(f"CLI: kernel launches {counts}, plain calls {plain_calls}")
    if counts["arma"] != K or plain_calls != 0:
        raise AssertionError("the CLI run did not run the kernel once per iteration")
    if summary["phi_schedule"] != [1.0] * (K + 1):
        raise AssertionError("phi must stay 1 without tempering")
    check_run("CLI", summary["mean"], 1.0)
    return launches + counts["arma"]


def band_errors(final_mean, final_var, ref_mean, ref_var):
    """The MC mean of the runs' final estimates (R, D), and |MC mean -
    reference| and |MC var - reference| beside their bands, those of
    `smcnuts_torch.utils.parity` (experiments/parity_summary.py:45-54)."""
    from smcnuts_torch.utils.parity import mean_band, var_band

    m = final_mean.double().cpu().numpy()
    v = final_var.double().cpu().numpy()
    ref_mean = torch.as_tensor(ref_mean).double().cpu().numpy()
    ref_var = torch.as_tensor(ref_var).double().cpu().numpy()
    r = m.shape[0]
    return (m.mean(0), abs(m.mean(0) - ref_mean), mean_band(m.std(0, ddof=1), r, ref_var),
            abs(v.mean(0) - ref_var), var_band(v.std(0, ddof=1), r, ref_var))


def parity_bands(label, name, final_mean, final_var):
    """The PARITY verdict of `smcnuts_torch.utils.parity` over the runs'
    final estimates (R, D): |MC mean - truth| <= 3 MC se + 0.1 posterior sd,
    and for the variances <= 3 MC se + 40%."""
    from smcnuts_torch.models import ground_truth

    mc_mean, mean_err, mean_band, var_err, var_band = band_errors(
        final_mean, final_var, *ground_truth(name))
    print(f"{label}: MC mean {[round(float(a), 4) for a in mc_mean]}")
    print(f"{label}: |MC mean - truth| / band "
          f"{[round(float(a), 3) for a in mean_err / mean_band]}")
    print(f"{label}: |MC var - truth| / band "
          f"{[round(float(a), 3) for a in var_err / var_band]}")
    if not (bool((mean_err <= mean_band).all()) and bool((var_err <= var_band).all())):
        raise AssertionError(f"{label}: outside the PARITY bands")


# The runs' final estimates (mean, variance), each (RUNS, D), of the six
# parity configurations, by (model, strategy directory of
# smcnuts_torch.utils.parity.STRATEGIES): forwards from phase 6, the
# asymptotic and Gaussian L-kernels from phase 9. Phase `parity` reads them.
PARITY_FINALS = {}

WORKLOADS = (  # label, model, adapted
    ("arma", "arma", False),
    ("prmwcd", "prmwcd", False),
    ("prmwcd_adapted", "prmwcd", True),
)


def workload_config(adapt):
    from smcnuts_torch import SMCConfig

    return SMCConfig(
        n_particles=N, n_iterations=K, step_size=STEP,
        max_tree_depth=MAX_DEPTH, save_history=False,
        adapt_step_size=adapt, adapt_mass_matrix=adapt,
        target_accept=ADAPT_TARGET if adapt else 0.8,
    )


def compaction_on(label, name, model, cfg, res_auto, smi):
    """One workload with compaction=None and with the staged dispatch, in
    turns (none, staged, staged, none), through run_smc_batched: every field
    of the results equal to the bit (and to the "auto" result), K dispatches
    and K x stages kernel launches with no plain call, runs 0 and the last
    equal to their single runs with compaction on. Returns the launches of
    the continuation-stage kernel in the first staged run."""
    import dataclasses

    from smcnuts_torch import run_smc, run_smc_batched
    from smcnuts_torch.sampler import resolve_compaction
    from smcnuts_torch.utils.timing import CudaTimer

    auto = resolve_compaction(cfg, model, RUNS * N)
    hint = (model.compaction_hint_adapted if cfg.adapt_step_size
            else model.compaction_hint)
    splits = hint or REFERENCE_SPLITS[label]
    stages = len(splits) + 1
    cfgs = {"none": dataclasses.replace(cfg, compaction=None),
            "staged": dataclasses.replace(cfg, compaction=splits)}
    walls, results, cont = {"none": [], "staged": []}, {}, None
    for turn in ("none", "staged", "staged", "none"):
        reset_counts()
        with CudaTimer() as t:
            res = run_smc_batched(model, cfgs[turn], SEEDS, "cuda")
            res.mean_estimate[:, K].cpu()
        walls[turn].append(t.ms)
        counts, plain_calls = read_counts()
        stage_launches, cont_counts = read_stage_counts()
        want = K * (stages if turn == "staged" else 1)
        if (counts[name] != K or plain_calls != 0 or stage_launches != want
                or cont_counts[name] != want - K):
            raise AssertionError(
                f"{label} compaction {turn}: {counts} dispatches, "
                f"{stage_launches} kernel launches ({cont_counts} of the "
                f"continuation kernel), {plain_calls} plain calls; expected "
                f"{K}, {want}, {want - K}, 0")
        if turn == "staged" and cont is None:
            cont = cont_counts
        results[turn] = res
    for turn, res in results.items():
        diff = equal_fields(res_auto, res)
        if diff:
            raise AssertionError(f"{label}: compaction {turn} differs from "
                                 f"\"auto\" in {diff}")
    for b in (0, RUNS - 1):
        diff = single_run_diff(run_smc(model, cfgs["staged"], SEEDS[b], "cuda"),
                               results["staged"], b)
        if diff:
            raise AssertionError(f"{label}: staged run {b} differs from its "
                                 f"single run in {diff}")
    print(f"{label}: \"auto\" at {RUNS * N} lanes is {auto or 'the single kernel'}"
          f", the model's hint {hint or 'none'}; staged with "
          f"{splits}: every SMCResult field equals compaction=None to the bit; "
          f"{K} dispatches, {K * stages} kernel launches, no plain call; runs 0 "
          f"and {RUNS - 1} equal their single runs")
    print(f"{label}: wall in turns, compaction=None "
          f"{', '.join(f'{v:.1f}' for v in walls['none'])} ms, staged {splits} "
          f"{', '.join(f'{v:.1f}' for v in walls['staged'])} ms (CUDA events, "
          f"results on the host; {smi})")
    return cont


def wide_auto_run(smi, tiles=4, k=5):
    """PRMwCD with tiles x RUNS runs and the default compaction="auto": past
    the model's compaction_min_lanes "auto" must take its hint, so k
    iterations are k dispatches of len(hint) + 1 kernel launches, and equal
    the same runs with compaction=None to the bit. Returns the launches of
    the continuation-stage kernel."""
    import dataclasses

    from smcnuts_torch import run_smc_batched
    from smcnuts_torch.models import get_model
    from smcnuts_torch.sampler import resolve_compaction
    from smcnuts_torch.utils.timing import CudaTimer

    model = get_model("prmwcd")
    cfg = dataclasses.replace(workload_config(False), n_iterations=k)
    seeds = list(range(tiles * RUNS))
    splits = resolve_compaction(cfg, model, len(seeds) * N)
    if len(seeds) * N <= model.compaction_min_lanes or splits != model.compaction_hint:
        raise AssertionError(f"\"auto\" at {len(seeds) * N} lanes gave {splits}")
    results, walls = {}, {}
    for compaction in ("auto", None, None, "auto"):
        reset_counts()
        with CudaTimer() as t:
            res = run_smc_batched(
                model, dataclasses.replace(cfg, compaction=compaction), seeds, "cuda")
            res.mean_estimate[:, k].cpu()
        walls.setdefault(compaction, []).append(t.ms)
        counts, plain_calls = read_counts()
        stage_launches, cont = read_stage_counts()
        want = k * (len(splits) + 1 if compaction else 1)
        if counts["prmwcd"] != k or stage_launches != want or plain_calls != 0:
            raise AssertionError(
                f"wide run, compaction={compaction}: {counts} dispatches, "
                f"{stage_launches} kernel launches, {plain_calls} plain calls")
        if compaction:
            cont_auto = cont["prmwcd"]
        results[compaction] = res
    diff = equal_fields(results[None], results["auto"])
    if diff:
        raise AssertionError(f"wide run: \"auto\" differs from None in {diff}")
    print(f"prmwcd, {len(seeds)} runs x N={N} x K={k} ({len(seeds) * N} lanes, "
          f"past the model's compaction_min_lanes {model.compaction_min_lanes}): "
          f"\"auto\" "
          f"is {splits}, {k} dispatches of {len(splits) + 1} kernel launches, "
          f"every field equal to compaction=None; wall in turns, auto "
          f"{', '.join(f'{v:.1f}' for v in walls['auto'])} ms, None "
          f"{', '.join(f'{v:.1f}' for v in walls[None])} ms (CUDA events; {smi})")
    return cont_auto


def batched_phase(smi):
    from smcnuts_torch import run_smc, run_smc_batched
    from smcnuts_torch.models import get_model
    from smcnuts_torch.utils.timing import CudaTimer

    phase(f"6. batched workloads, {RUNS} runs x N={N} x K={K}")
    launches, leapfrogs = {"arma": 0, "prmwcd": 0}, {}
    cont_launches = {"arma": 0, "prmwcd": 0}
    for label, name, adapt in WORKLOADS:
        cfg = workload_config(adapt)
        model = get_model(name)
        reset_counts()
        t0 = time.perf_counter()
        with CudaTimer() as t:
            res = run_smc_batched(model, cfg, SEEDS, "cuda")
            final_mean = res.mean_estimate[:, K].cpu()
        host_s = time.perf_counter() - t0
        counts, plain_calls = read_counts()
        _, cont_first = read_stage_counts()
        wall_ms = t.ms
        print(f"{label}: kernel launches {counts}, plain calls {plain_calls}, "
              f"continuation-stage launches {cont_first[name]}")
        if counts[name] != K or sum(counts.values()) != K or plain_calls != 0:
            raise AssertionError(f"{label}: not one kernel launch per iteration")
        launches[name] += counts[name]
        cont_launches[name] += cont_first[name]
        check_series(label, res, K)
        if res.mean_estimate.shape[0] != RUNS:
            raise AssertionError(f"{label}: expected {RUNS} runs")
        rate = RUNS * N * K / (wall_ms / 1000.0)
        lf = float(res.tree_leapfrogs[:, :K].mean())
        leapfrogs[label] = lf
        print(f"{label}: wall {wall_ms:.1f} ms (CUDA events, results on the "
              f"host; host clock {host_s:.3f} s), {rate:.0f} "
              f"particle-iterations/s ({smi})")
        print(f"{label}: mean tree depth {float(res.tree_depth[:, :K].mean()):.3f}, "
              f"leapfrogs per particle-iteration {lf:.2f}, acceptance "
              f"{float(res.acceptance_rate[:, :K].mean()):.3f}, resampled "
              f"{int(res.resampled.sum())}/{RUNS * K}, final ESS mean "
              f"{float(res.ess[:, K].mean()):.1f}, final step size mean "
              f"{float(res.step_size[:, K].mean()):.5f}")
        parity_bands(label, name, final_mean, res.variance_estimate[:, K])
        if adapt:
            w = max(1, round(cfg.adapt_warmup_frac * K))
            frozen = res.step_size[:, w:]
            if not bool((frozen == frozen[:, :1]).all()):
                raise AssertionError(f"{label}: step size moves after warmup")
            print(f"{label}: step size constant over iterations {w}..{K} of "
                  f"every run")
        else:
            PARITY_FINALS[(name, "forward_lkernel")] = (
                final_mean, res.variance_estimate[:, K].cpu())
        for b in (0, RUNS - 1):
            diff = single_run_diff(run_smc(model, cfg, SEEDS[b], "cuda"), res, b)
            if diff:
                raise AssertionError(f"{label}: run {b} differs from its single "
                                     f"run in {diff}")
        print(f"{label}: runs 0 and {RUNS - 1} equal single runs with their "
              f"seeds, bit for bit")
        cont_launches[name] += compaction_on(label, name, model, cfg, res, smi)[name]
        profile_call(label, model, cfg, smi)
    cont_launches["prmwcd"] += wide_auto_run(smi)
    fixed, adapted = leapfrogs["prmwcd"], leapfrogs["prmwcd_adapted"]
    print(f"PRMwCD leapfrogs per particle-iteration: fixed {fixed:.2f}, adapted "
          f"{adapted:.2f} (the JAX package counted {JAX_LEAPFROGS['fixed']} and "
          f"{JAX_LEAPFROGS['adapted']}, experiments/output/adaptation.json)")
    if not adapted < 0.5 * fixed:
        raise AssertionError("adaptation did not shorten the PRMwCD trees")
    return launches, cont_launches


def survivor_counts():
    """Lanes still at work after each split of the last dispatch."""
    from smcnuts_torch.ops.nuts_cuda import nuts_tree

    return [] if nuts_tree.survivors is None else nuts_tree.survivors.tolist()


def tree_slots(model):
    """(trees a warp holds, trees a block holds) in the NUTS kernel: arma,
    PRMwCD, eight schools and logistic regression run a group of GROUP lanes
    a tree in blocks of BLOCK threads (their models/ modules), every other
    model one lane in blocks of 128 threads."""
    from smcnuts_torch.models import ArmaModel, LogisticModel, PrmwcdModel, arma, prmwcd
    from smcnuts_torch.models import eightschools, logistic
    from smcnuts_torch.models.eightschools import EightSchoolsModel

    for cls, mod in ((ArmaModel, arma), (PrmwcdModel, prmwcd), (LogisticModel, logistic),
                     (EightSchoolsModel, eightschools)):
        if isinstance(model, cls):
            return 32 // mod.GROUP, mod.BLOCK // mod.GROUP
    return 32, 128


def candidate_times(label, model, args, smi, candidates=None):
    """Time the single kernel and each candidate split tuple on one
    population (on the device alone, DEVICE_REPEATS launches back to back),
    the single kernel first and last; print survivors, launches, the
    per-warp lockstep waste and the block's tail (lockstep_waste at the
    trees a warp and a block hold)."""
    from smcnuts_torch.ops.nuts_cuda import lockstep_waste, nuts_tree
    from smcnuts_torch.utils.timing import device_ms

    warp, block = tree_slots(model)
    single = nuts_tree(model, *args)
    depth, leapfrogs = single[2]["depth"], single[2]["leapfrogs"]
    hist = torch.bincount(depth.reshape(-1).int()).tolist()
    print(f"{label}: {depth.numel()} lanes, mean depth {float(depth.mean()):.3f}, "
          f"leapfrogs per lane {float(leapfrogs.mean()):.2f}, lanes by depth {hist}")
    rows = []
    for splits in ((),) + tuple(candidates or CANDIDATE_SPLITS) + ((),):
        staged = nuts_tree(model, *args, compaction=splits)
        survivors = survivor_counts()
        if bitwise_differences(staged, single):
            raise AssertionError(f"{label}: splits {splits} differ from the "
                                 f"single kernel")
        ms = device_ms(lambda: nuts_tree(model, *args, compaction=splits),
                       repeats=DEVICE_REPEATS)
        walked, needed = lockstep_waste(leapfrogs, depth, splits, width=warp)
        tail, _ = lockstep_waste(leapfrogs, depth, splits, width=block)
        rows.append((splits, ms))
        print(f"  {label} splits {splits or 'none'}: {ms:.4f} ms, "
              f"{len(splits) + 1} launches, survivors {survivors}, waste of a "
              f"warp ({warp} trees) {walked / needed:.4f} ({walked} / {needed} "
              f"lane-steps), of a block ({block} trees) {tail / needed:.4f}")
    best = min(rows, key=lambda row: row[1])
    print(f"{label}: fastest {best[0] or 'none'} at {best[1]:.4f} ms; single "
          f"kernel {rows[0][1]:.4f} and {rows[-1][1]:.4f} ms ({smi})")


def staged_times_phase(smi):
    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.draws import PHILOX, run_draws
    from smcnuts_torch.sampler import init_state, smc_step

    phase(f"6b. times of the staged dispatch on each workload's population, "
          f"{RUNS} x {N}, depth {MAX_DEPTH}")
    dev = torch.device("cuda")
    seeds_t = torch.tensor(SEEDS, dtype=torch.int64, device=dev)
    for label, name, adapt in WORKLOADS:
        cfg = workload_config(adapt)
        model = get_model(name).to(dev)
        carry = init_state(model, cfg, SEEDS, dev)
        uniforms, tree_seeds = run_draws(seeds_t, range(K + 1), N, carry.x.dtype)
        for k in range(K):
            carry, _ = smc_step(model, cfg, carry, uniforms[k], tree_seeds[k], "cuda")
        print(f"{label}: population after {K} iterations, step size mean "
              f"{float(carry.step_size.mean()):.5f}, inverse mass from "
              f"{float(carry.inv_mass.min()):.4g} to {float(carry.inv_mass.max()):.4g}")
        args = (carry.x, tree_seeds[K], carry.step_size, 1.0, carry.inv_mass,
                MAX_DEPTH, PHILOX)
        candidate_times(label, model, args, smi)
        few = tuple(c for c in CANDIDATE_SPLITS if len(c) > 1) + WIDE_SINGLES[label]
        # The first runs of the population alone: around one block an SM of
        # the PRMwCD kernel (1,024 trees at 16 lanes a tree fill 128 blocks).
        for runs in (2, 5):
            part = (carry.x[:runs], tree_seeds[K][:runs], carry.step_size[:runs], 1.0,
                    carry.inv_mass[:runs], MAX_DEPTH, PHILOX)
            candidate_times(f"{label} runs 0..{runs - 1} ({runs} x {N})", model, part,
                            smi, few)
        # The same population tiled over more runs, each with its own seed.
        # Once the lanes exceed what the card holds at once, a warp that ends
        # early makes room for a waiting one.
        for tiles in (2, 4, 16):
            wide = (carry.x.repeat(tiles, 1, 1),
                    torch.arange(tiles * RUNS, dtype=torch.int32, device=dev),
                    carry.step_size.repeat(tiles), 1.0,
                    carry.inv_mass.repeat(tiles, 1), MAX_DEPTH, PHILOX)
            candidate_times(f"{label} x {tiles} ({tiles * RUNS} x {N})", model,
                            wide, smi, few)


def cli_phase():
    phase("7. CLI, PRMwCD and eight schools")
    launches = 0
    for extra in ([], ["--adapt-step-size", "--adapt-mass-matrix"]):
        reset_counts()
        summary = quiet_cli(["--model", "prmwcd", "-N", str(N), "-K", str(K),
                             "--device", "cuda", "--seed", "3"] + extra)
        counts, plain_calls = read_counts()
        print(f"CLI {' '.join(extra) or '(fixed step)'}: kernel launches "
              f"{counts}, plain calls {plain_calls}; final means "
              f"{[round(v, 4) for v in summary['mean']]}")
        if counts["prmwcd"] != K or plain_calls != 0:
            raise AssertionError("the CLI run did not run the kernel once per iteration")
        if not all(math.isfinite(v) for v in summary["mean"] + summary["variance"]):
            raise AssertionError("the CLI estimates are not finite")
        launches += counts["prmwcd"]
    # The asymptotic strategy through the CLI, which turns tempering on for it.
    k = 8
    reset_counts()
    summary = quiet_cli(["--model", "eightschools", "-N", "128", "-K", str(k),
                         "--lkernel", "asymptoticLKernel", "--step-size", "0.2",
                         "--max-tree-depth", "5", "--device", "cuda"])
    counts, plain_calls = read_counts()
    print(f"CLI --model eightschools --lkernel asymptoticLKernel: kernel launches "
          f"{counts}, plain calls {plain_calls}; phi schedule "
          f"{summary['phi_schedule']}; final mu {summary['mean'][0]:.3f}, tau "
          f"{summary['mean'][1]:.3f}")
    phis = summary["phi_schedule"]
    if counts["eightschools"] != k or sum(counts.values()) != k or plain_calls != 0:
        raise AssertionError("the CLI run did not run the kernel once per iteration")
    if not (0 < phis[0] and phis[-1] == 1.0 and phis == sorted(phis)
            and all(math.isfinite(v) for v in summary["mean"] + summary["variance"])):
        raise AssertionError("the CLI run's schedule or estimates are wrong")
    return launches, counts["eightschools"]


def autodiff_model(name):
    from smcnuts_torch.models import get_model, make_gaussian

    return make_gaussian(**GAUSSIAN) if name == "gaussian" else get_model(name)


def autodiff_cloud(name, shape, seed, device):
    """A dispersed cloud (..., D) for one of the three models: three quarters
    of each run at one scale around the centre, one quarter at three times
    it. Gaussian: the target's own mean and sd; eight schools: around
    mu 4.4, log tau 1.2, tt 0 with sd 3, 0.5, 1; logistic: N(0, 0.7^2)."""
    if name == "gaussian":
        centre = list(GAUSSIAN["mean"])
        sd = [v ** 0.5 for v in GAUSSIAN["var"]]
    elif name == "eightschools":
        centre, sd = [4.4, 1.2] + [0.0] * 8, [3.0, 0.5] + [1.0] * 8
    else:
        centre, sd = [0.0] * 8, [0.7] * 8
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(*shape, len(centre), generator=g, device=device)
    scale = torch.ones(shape, device=device)
    scale[..., : shape[-1] // 4] = 3.0
    return (torch.tensor(centre, device=device)
            + scale[..., None] * torch.tensor(sd, device=device) * z).contiguous()


def gaussian_entry_check(label, model, k):
    """Every one of the k dispatches since reset_counts went to the Gaussian
    entry that ops.nuts_cuda names (the pipelined walk), none to the
    witness."""
    from smcnuts_torch.ops.nuts_cuda import GAUSSIAN_VARIANTS, nuts_tree

    entry = f"smcnuts_nuts_tree_gaussian{model.dim}"
    witness = GAUSSIAN_VARIANTS[GAUSSIAN_WITNESS][0]
    got = dict(nuts_tree.entry_launches)
    if got.get(entry) != k or sum(got.values()) != k:
        raise AssertionError(f"{label}: dispatches by entry {got}; expected {k} to {entry}")
    print(f"{label}: all {k} dispatches to {entry} (the pipelined walk), none to the "
          f"witness {witness}")


# The Gaussian's witness (ops.nuts_cuda.GAUSSIAN_VARIANTS), and the shapes
# both builds are timed at beside 25 x 512 x depth 10: (runs, particles) at
# the tempered run's step and depth (phase 9: one run, and the dispatch of
# its 25 runs; the compaction hint's 100 x 512).
GAUSSIAN_WITNESS = "gaussian3_witness"
GAUSSIAN_SHAPES = ((1, 2048), (RUNS, 2048), (4 * RUNS, N))


def gaussian_witness(model, batch_args, single_out, plain_ms, smi):
    """The Gaussian's witness against the main entry's output to the bit (a
    small cloud with a lane of density -inf under zero bits, and the batched
    shape), both timed in turns at 25 x 512 x depth 10 and at
    GAUSSIAN_SHAPES, with ptxas's lines and SASS counts of both builds;
    returns what the kernels line says of the witness."""
    import re

    from smcnuts_torch.models import gaussian
    from smcnuts_torch.ops.nuts_cuda import (
        GAUSSIAN_VARIANTS, build_library, nuts_tree, nuts_tree_variant)
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.utils.timing import median_ms

    dev = batch_args[0].device
    ones = torch.ones(model.dim, device=dev)
    nuts_tree_variant.launches[GAUSSIAN_WITNESS] = 0
    small = (autodiff_cloud("gaussian", (2, 1024), 7, dev),
             torch.tensor([11, 12], dtype=torch.int32, device=dev), 0.02,
             torch.tensor([1.0, 0.4], device=dev), ones, 6, ZERO_BITS)
    small[0][0, 0, NAN_LANE["gaussian"][0]] = NAN_LANE["gaussian"][1]
    for label, args in (("[zero_bits] phi 1.0 | 0.4, 2 x 1024, depth 6", small),
                        (f"[philox] {RUNS} x {N}, depth {MAX_DEPTH}", batch_args)):
        main = single_out if args is batch_args else nuts_tree(model, *args)
        diff = bitwise_differences(nuts_tree_variant(GAUSSIAN_WITNESS, model, *args), main)
        if diff:
            raise AssertionError(f"gaussian witness {label}: differs from the main "
                                 f"entry in {diff}")
        print(f"gaussian witness {label}: equal to the main entry to the bit")
    witness_out = nuts_tree_variant(GAUSSIAN_WITNESS, model, *batch_args)
    witness_host = median_ms(lambda: nuts_tree_variant(GAUSSIAN_WITNESS, model, *batch_args),
                             repeats=5)
    cfg = AUTODIFF_MODELS["gaussian"]
    shapes = [(f"{RUNS} x {N} x depth {MAX_DEPTH}", batch_args)] + [
        (f"{runs} x {n} x depth {cfg['depth']}, step {cfg['step']}",
         (autodiff_cloud("gaussian", (runs, n), 6, dev),
          torch.arange(runs, dtype=torch.int32, device=dev), cfg["step"], 1.0, ones,
          cfg["depth"], PHILOX))
        for runs, n in GAUSSIAN_SHAPES]
    med = {}
    for label, args in shapes:
        rounds, m = timed_in_turns({
            "main": lambda: nuts_tree(model, *args),
            GAUSSIAN_WITNESS: lambda: nuts_tree_variant(GAUSSIAN_WITNESS, model, *args)})
        med.setdefault("main", m["main"])
        med.setdefault(GAUSSIAN_WITNESS, m[GAUSSIAN_WITNESS])
        for k in ("main", GAUSSIAN_WITNESS):
            print(f"time gaussian {k}, {label} [philox]: {m[k]:.4f} ms, "
                  f"{m[GAUSSIAN_WITNESS] / m[k]:.3f}x the witness's speed (device alone, "
                  f"{DEVICE_REPEATS} launches back to back; median of {VARIANT_ROUNDS} in "
                  f"turns: {', '.join(f'{v:.4f}' for v in rounds[k])}; {smi})")
    lib = build_library()
    counts = sass_instructions(lib.path)
    entries = {"main": "GaussianPipelinedILi3EEELb", "witness": "GaussianModelILi3EEELb"}
    blocks = {"main": str(gaussian.BLOCK), "witness": "128"}
    name, found = None, set()
    for line in lib.log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name is not None and ("registers" in line or "stack frame" in line):
            for who, pattern in entries.items():
                block = re.search(r"ELb([01])ELi(\d+)E", name)
                if pattern in name and block.group(2) == blocks[who]:
                    stage = "continuation" if block.group(1) == "1" else "first stage"
                    found.add((who, stage))
                    print(f"  ptxas gaussian {who}, {stage}, {block.group(2)} threads: "
                          f"{line.split(':', 1)[-1].strip()}")
    if len(found) != 2 * len(entries):
        raise AssertionError(f"gaussian: ptxas lines found for {sorted(found)} only")
    for who, pattern in entries.items():
        tail = f"ELi{blocks[who]}EEEvNS_8TreeArgsE"
        mine = {k: v for k, v in counts.items() if k.endswith(tail)}
        print(f"  SASS gaussian {who}: {sass_text(mine, pattern)}")
    bound = tree_roofline("gaussian", witness_out)
    print(f"gaussian witness: {bound_text(bound)}; launches in this phase (not on the "
          f"main path) {nuts_tree_variant.launches[GAUSSIAN_WITNESS]}; entry "
          f"{GAUSSIAN_VARIANTS[GAUSSIAN_WITNESS][0]}")
    return {"launches": 0, "measurement_entry": True, "max_abs_err": 0.0,
            "ms": med[GAUSSIAN_WITNESS], "host_call_ms": witness_host,
            "plain_ms": plain_ms, **bound}


def autodiff_kernel_phase(name, smi):
    """Phase 8 for one model; returns what the kernels line says of it and of
    its witness: the W = 1 witness of logistic regression and eight schools,
    the Gaussian's kernel before the pipelined walk."""
    from smcnuts_torch.models import eightschools, logistic
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import build_library, nuts_tree, nuts_tree_plain

    dev = torch.device("cuda")
    model = autodiff_model(name).to(dev)
    D = model.dim
    step = AUTODIFF_MODELS[name]["cloud_step"]
    ones = torch.ones(D, device=dev)
    im = torch.linspace(0.5, 2.0, D, device=dev)
    seed2 = torch.tensor([11, 12], dtype=torch.int32, device=dev)
    # Each kernel computes in the order of its plain version (the logistic
    # and eight-schools group kernels in their lanes' order): held to it to
    # the bit, lanes whose density is not finite included.
    group_mod = {"logistic": logistic, "eightschools": eightschools}.get(name)
    if group_mod is not None:
        lib = build_library()
        print(f"{name} entry: W={group_mod.GROUP} lanes a tree, blocks of "
              f"{group_mod.BLOCK} threads, {getattr(lib, f'{name}_blocks_per_sm')} "
              f"blocks an SM at once")
    worst = 0.0
    for source in (ZERO_BITS, PHILOX):
        worst = max(worst, compare(
            f"{name} [{source}] phi 1.0 | 0.4, 2 runs x 1024, depth 6", model,
            (autodiff_cloud(name, (2, 1024), 1, dev), seed2, step,
             torch.tensor([1.0, 0.4], device=dev), ones, 6, source), bitwise=True))
        worst = max(worst, compare(
            f"{name} [{source}] {D}-vector inv_mass, 2048, depth 6", model,
            (autodiff_cloud(name, (1, 2048), 2, dev), 13, step, 1.0, im, 6, source),
            bitwise=True))
    r = torch.randn(1, 2048, D, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    worst = max(worst, compare(
        f"{name} [zero_bits] r given, 2048, depth 0", model,
        (autodiff_cloud(name, (1, 2048), 4, dev), 0, step, 0.7, im, 0, ZERO_BITS),
        r=r, bitwise=True))
    batch_args = (autodiff_cloud(name, (RUNS, N), 5, dev),
                  torch.arange(RUNS, dtype=torch.int32, device=dev), step, 1.0,
                  ones, MAX_DEPTH, PHILOX)
    single_out = nuts_tree(model, *batch_args)
    plain_out = nuts_tree_plain(model, *batch_args)
    worst = max(worst, check_outputs(
        f"{name} [philox] batched shape, {RUNS} x {N}, depth {MAX_DEPTH}",
        single_out, plain_out, bitwise=True))
    kernel = "the kernel" if group_mod is None else f"the group kernel (W={group_mod.GROUP})"
    print(f"{name}: {kernel} equals its plain version to the bit in every case")
    times = time_pair(f"{name} {RUNS} x {N} x depth {MAX_DEPTH} [philox]",
                      model, batch_args, smi)
    bound = tree_roofline(name, single_out)
    witness = None
    if name == "gaussian":
        witness = gaussian_witness(model, batch_args, single_out, times["plain_ms"], smi)
    if group_mod is not None:
        small = (autodiff_cloud(name, (2, 1024), 7, dev), seed2, step,
                 torch.tensor([1.0, 0.4], device=dev), ones, 6, ZERO_BITS)
        small[0][0, 0, NAN_LANE[name][0]] = NAN_LANE[name][1]
        wide = (autodiff_cloud(name, (1, WIDE_TREES), 8, dev), 31, step, 1.0, ones,
                MAX_DEPTH, PHILOX)
        # Beside the 1,048,576 trees: the shapes of the model's own runs, at
        # their step and depth, 100 x 512 (the compaction hint's) and
        # RUNS x n (the full-width run of phase 9).
        cfg = AUTODIFF_MODELS[name]
        own = tuple((autodiff_cloud(name, (runs, n), 6, dev),
                     torch.arange(runs, dtype=torch.int32, device=dev), cfg["step"],
                     1.0, ones, cfg["depth"], PHILOX)
                    for runs, n in ((4 * RUNS, N), (RUNS, cfg["n"])))
        witness = measurement_entries(name, model, batch_args, single_out, small, smi,
                                      wide=own + (wide,))
        wide_out = nuts_tree(model, *wide)
        print(f"{name} at {WIDE_TREES} trees, depth {MAX_DEPTH}: "
              f"{bound_text(tree_roofline(name, wide_out))}")
    staged = staged_kernel_phase(name, model, batch_args, single_out, plain_out, smi,
                                 bitwise=True)
    worst = max(worst, staged["max_abs_err"])
    print(f"{name}: max |kernel - plain| on agreeing lanes, all cases, staged "
          f"included: {worst:.3g}; at {RUNS} x {N}: {bound_text(bound)}; staged "
          f"dispatch {staged['ms']:.4f} ms")
    # What the model's compaction hint rests on: 100 x 512 lanes at the step
    # size of the model's own run.
    cfg = AUTODIFF_MODELS[name]
    wide = (autodiff_cloud(name, (4 * RUNS, N), 6, dev),
            torch.arange(4 * RUNS, dtype=torch.int32, device=dev), cfg["step"],
            1.0, ones, cfg["depth"], PHILOX)
    candidate_times(f"{name} {4 * RUNS} x {N}, step {cfg['step']}, depth "
                    f"{cfg['depth']}", model, wide, smi,
                    ((1,), (2,), (3,), (1, 2), (2, 4), tuple(range(1, cfg["depth"]))))
    return {"max_abs_err": worst, **times, **bound}, witness


def autodiff_kernels_phase(smi):
    """Phase 8: what the kernels line says of each model, and of its witness
    (the W = 1 witnesses of logistic regression and eight schools, the
    Gaussian's kernel before the pipelined walk)."""
    phase("8. Gaussian, eight-schools and logistic kernels vs plain")
    rows = {name: autodiff_kernel_phase(name, smi) for name in AUTODIFF_MODELS}
    return ({name: row for name, (row, _) in rows.items()},
            {name: w for name, (_, w) in rows.items() if w is not None})


def one_model_phase(name):
    """Phase 8 for one model alone (`--only logistic` or `--only
    eightschools`)."""
    def run(smi):
        phase(f"8. {name} kernel vs plain")
        return autodiff_kernel_phase(name, smi)
    return run


def estimates_band(label, got_mean, got_var, ref_mean, ref_var):
    """The PARITY bands of `parity_bands` against a reference run's moments."""
    mc_mean, mean_err, mean_band, var_err, var_band = band_errors(
        got_mean, got_var, ref_mean, ref_var)
    print(f"{label}: MC mean {[round(float(a), 4) for a in mc_mean]}, "
          f"reference {[round(float(a), 4) for a in torch.as_tensor(ref_mean).cpu()]}")
    print(f"{label}: |MC mean - reference| / band "
          f"{[round(float(a), 3) for a in mean_err / mean_band]}, variances "
          f"{[round(float(a), 3) for a in var_err / var_band]}")
    if not (bool((mean_err <= mean_band).all()) and bool((var_err <= var_band).all())):
        raise AssertionError(f"{label}: outside the bands (3 MC se + 0.1 sd; "
                             f"3 MC se + 40%)")


PROFILE_ITERATIONS = 20


def profile_call(label, model, cfg, smi, momentum_proposal=None,
                 iterations=PROFILE_ITERATIONS):
    """Where an iteration's time goes, for RUNS runs
    (`utils.profiling.profile_iterations`): prints the device kernels per
    iteration, the device's busy time, its idle share of the wall time, and
    the time of the port's own kernels. A measurement, not a check: without
    device events it says so and goes on."""
    from smcnuts_torch.utils.profiling import profile_iterations

    p = profile_iterations(model, cfg, SEEDS, iterations, momentum_proposal, "cuda")
    if p is None:
        print(f"{label}: torch.profiler recorded no device event; launches per "
              f"iteration and idle share not measured")
        return
    own = [f"{name} {launches:.1f} launches and {ms:.3f} ms an iteration, "
           f"{share:.3f} of the device time"
           for name, (launches, ms, share) in p["own"].items()]
    print(f"{label}: iterations 0..{p['iterations'] - 1} of the loop, {RUNS} runs: "
          f"{p['ms']:.3f} ms an iteration (CUDA events, unprofiled); under "
          f"torch.profiler {p['kernels']:.1f} device kernels an iteration, "
          f"device busy {p['busy_ms']:.3f} ms an iteration, idle share "
          f"{p['idle_share']:.3f}; {'; '.join(own) or 'no kernel of the port'} "
          f"({smi})")


def strategy_run(label, name, model, cfg, smi, profiled=False):
    """One full-width configuration through run_smc_batched with RUNS runs:
    K dispatches, no plain call, finite series, the tempered schedule, runs 0
    and the last equal to their single runs, and for the asymptotic strategy
    the estimates of the other save_history mode equal to the bit. Returns
    (result, dispatches of the batched run, its launches of the
    continuation-stage kernel)."""
    import dataclasses

    from smcnuts_torch import run_smc, run_smc_batched
    from smcnuts_torch.utils.timing import CudaTimer

    k = cfg.n_iterations
    reset_counts()
    t0 = time.perf_counter()
    with CudaTimer() as t:
        res = run_smc_batched(model, cfg, SEEDS, "cuda")
        res.mean_estimate[:, k].cpu()
    host_s = time.perf_counter() - t0
    counts, plain_calls = read_counts()
    stage_launches, cont = read_stage_counts()
    if counts[name] != k or sum(counts.values()) != k or plain_calls != 0:
        raise AssertionError(f"{label}: {counts} dispatches, {plain_calls} plain "
                             f"calls; expected {k} and 0")
    if name == "gaussian":
        gaussian_entry_check(label, model, k)
    check_series(label, res, k)
    if float(res.acceptance_rate[:, k].abs().max()) != 0.0:
        raise AssertionError(f"{label}: acceptance[K] must be 0")
    phi = res.phi
    if cfg.tempering:
        if not (bool((phi[:, 0] > 0).all()) and bool((phi[:, 1:] >= phi[:, :-1]).all())
                and bool((phi[:, k] == 1).all())):
            raise AssertionError(f"{label}: the schedule must start above 0, "
                                 f"never decrease and end at 1")
        reached = (phi < 1).sum(1)
        sched = (f"phi[0] from {float(phi[:, 0].min()):.4g} to "
                 f"{float(phi[:, 0].max()):.4g}, 1 reached after "
                 f"{int(reached.min())} to {int(reached.max())} iterations")
    else:
        if not bool((phi == 1).all()):
            raise AssertionError(f"{label}: phi must stay 1 without tempering")
        sched = "phi = 1"
    rate = RUNS * cfg.n_particles * k / (t.ms / 1000.0)
    print(f"{label}: {k} dispatches ({stage_launches} kernel launches), no plain "
          f"call; wall {t.ms:.1f} ms (CUDA events, results on the host; host clock "
          f"{host_s:.3f} s), {rate:.0f} particle-iterations/s ({smi})")
    print(f"{label}: {sched}; mean tree depth "
          f"{float(res.tree_depth[:, :k].mean()):.3f}, leapfrogs per "
          f"particle-iteration {float(res.tree_leapfrogs[:, :k].mean()):.2f}, "
          f"acceptance {float(res.acceptance_rate[:, :k].mean()):.3f}, resampled "
          f"{int(res.resampled.sum())}/{RUNS * k}, final ESS mean "
          f"{float(res.ess[:, k].mean()):.1f}")
    for b in (0, RUNS - 1):
        diff = single_run_diff(run_smc(model, cfg, SEEDS[b], "cuda"), res, b)
        if diff:
            raise AssertionError(f"{label}: run {b} differs from its single run "
                                 f"in {diff}")
    same = f"runs 0 and {RUNS - 1} equal their single runs, bit for bit"
    if cfg.is_asymptotic:
        other = run_smc_batched(
            model, dataclasses.replace(cfg, save_history=not cfg.save_history),
            SEEDS, "cuda")
        diff = [f for f in ("mean_estimate", "variance_estimate", "phi", "x_final",
                            "logw_final", "ess")
                if not torch.equal(getattr(other, f), getattr(res, f))]
        if diff:
            raise AssertionError(f"{label}: save_history={not cfg.save_history} "
                                 f"differs in {diff}")
        same += ("; the recycled estimates made inside the loop equal those "
                 "from the saved history, bit for bit")
    print(f"{label}: {same}")
    if profiled:
        profile_call(label, model, cfg, smi)
    return res, counts[name], cont[name]


def strategies_phase(smi):
    from smcnuts_torch import SMCConfig, run_smc
    from smcnuts_torch.models import get_model, tempered_moments

    phase(f"9. the three strategies, full width, {RUNS} runs each")
    launches, cont = {}, {}

    def add(name, n, n_cont):
        launches[name] = launches.get(name, 0) + n
        cont[name] = cont.get(name, 0) + n_cont

    for name in ("arma", "prmwcd"):
        for lkernel in ("asymptoticLKernel", "GaussianApproxLKernel"):
            asym = lkernel == "asymptoticLKernel"
            cfg = SMCConfig(n_particles=N, n_iterations=K, step_size=STEP,
                            lkernel=lkernel, tempering=asym, save_history=asym,
                            max_tree_depth=MAX_DEPTH)
            label = f"{name} {lkernel}"
            res, n, n_cont = strategy_run(label, name, get_model(name), cfg, smi,
                                          profiled=True)
            add(name, n, n_cont)
            final = (res.mean_estimate[:, K].cpu(), res.variance_estimate[:, K].cpu())
            parity_bands(label, name, *final)
            PARITY_FINALS[(name, "asymptotic_lkernel" if asym else "gaussian_lkernel")] = final

    for name, c in AUTODIFF_MODELS.items():
        cfg = SMCConfig(n_particles=c["n"], n_iterations=c["k"], step_size=c["step"],
                        lkernel=c["lkernel"], tempering=True, save_history=False,
                        max_tree_depth=c["depth"])
        label = f"{name} {c['lkernel']} tempered"
        res, n, n_cont = strategy_run(label, name, autodiff_model(name), cfg, smi)
        add(name, n, n_cont)
        k = c["k"]
        mean, var = res.mean_estimate[:, k].double().cpu(), res.variance_estimate[:, k].double().cpu()
        if name == "gaussian":
            # tests/test_nuts_pallas.py:326-330, for every run.
            want_mean, want_var = tempered_moments(
                GAUSSIAN["mean"], GAUSSIAN["var"], GAUSSIAN["prior_var"], 1.0)
            want_mean, want_var = torch.as_tensor(want_mean), torch.as_tensor(want_var)
            ess = res.ess[:, k].double().cpu()
            se = (want_var.max() / ess).sqrt()
            z = ((mean - want_mean).abs() / se[:, None]).max()
            rel = ((var - want_var).abs() / want_var).max()
            print(f"{label}: closed-form mean {want_mean.tolist()}, variance "
                  f"{want_var.tolist()}; over {RUNS} runs the worst |mean error| "
                  f"is {float(z):.3f} se, the worst relative variance error "
                  f"{float(rel):.4f}, the least final ESS {float(ess.min()):.1f}")
            if not (float(ess.min()) > 1000 and float(z) <= 4.0 and float(rel) <= 0.25):
                raise AssertionError(f"{label}: outside ESS > 1000, 4 se, rtol 0.25")
        elif name == "eightschools":
            mu, tau = mean[:, 0], mean[:, 1]
            print(f"{label}: mu from {float(mu.min()):.3f} to {float(mu.max()):.3f}, "
                  f"tau from {float(tau.min()):.3f} to {float(tau.max()):.3f} "
                  f"over {RUNS} runs")
            if not (bool(((3.0 < mu) & (mu < 6.0)).all())
                    and bool(((2.0 < tau) & (tau < 6.0)).all())):
                raise AssertionError(f"{label}: outside 3 < mu < 6, 2 < tau < 6")
        else:
            # The reference: one long run of the plain tree on the card.
            long_cfg = SMCConfig(n_particles=4096, n_iterations=REF_K, step_size=c["step"],
                                 max_tree_depth=c["depth"], save_history=False,
                                 nuts_backend="eager")
            reset_counts()
            ref = run_smc(autodiff_model(name), long_cfg, 12345, "cuda")
            counts, plain_calls = read_counts()
            if sum(counts.values()) != 0 or plain_calls != REF_K:
                raise AssertionError(f"{label}: the reference run must take the "
                                     f"plain tree: {counts}, {plain_calls}")
            estimates_band(f"{label} vs plain-tree run (N=4096, K={REF_K}, forwards)",
                           mean, var, ref.mean_estimate[REF_K],
                           ref.variance_estimate[REF_K])
    return launches, cont


def parity_summary_phase():
    """The six parity configurations' summary: phases 6 and 9's final
    estimates through `smcnuts_torch.utils.parity`, one <model>_summary.json
    object a model (experiments/parity_summary_torch.py's keys), printed
    as a JSON line; fails unless both pass. No device time."""
    from smcnuts_torch.models import ground_truth
    from smcnuts_torch.utils.parity import STRATEGIES, strategy_entry, summary

    phase(f"parity. the six parity configurations of phases 6 and 9, {RUNS} runs each")
    failed = []
    for model in ("arma", "prmwcd"):
        gt_mean, gt_var = ground_truth(model)
        entries = {s: strategy_entry(*(v.double().numpy() for v in PARITY_FINALS[(model, s)]),
                                     gt_mean, gt_var)
                   for s in STRATEGIES}
        out = summary(model, RUNS, entries)
        print(json.dumps(out))
        print(f"{model}: " + ", ".join(f"{s} {'pass' if e['pass'] else 'FAIL'}"
                                       for s, e in entries.items()))
        if not out["pass"]:
            failed.append(model)
    if failed:
        raise AssertionError(f"the parity summary of {failed} does not pass")


# ---- phase oracle: the card against the serial NumPy oracle, the card's
# counterpart of tests/test_oracle_crossval.py:17-55 (its model, config and
# tolerances); the oracle runs on the host's CPU.

ORACLE_GAUSSIAN = dict(mean=(1.0, -2.0), var=(0.5, 2.0), prior_var=(1.0, 1.0))
ORACLE_N, ORACLE_K, ORACLE_STEP, ORACLE_SEEDS = 192, 8, 0.5, (0, 1, 2)
ORACLE_STRATEGIES = (("forwardsLKernel", False), ("asymptoticLKernel", True))
# bench.py:45-46: the size at which bench.py times the serial baseline.
BASELINE_N, BASELINE_K = 64, 5


def oracle_run(lkernel, tempering, seed):
    """In a worker process: the serial NumPy oracle over NumpyModelAdapter of
    the oracle phase's Gaussian on the CPU; returns (final mean estimate,
    seconds)."""
    from smcnuts_torch.baselines.numpy_smc import NumpyModelAdapter, run_numpy_smc
    from smcnuts_torch.models import make_gaussian

    torch.set_num_threads(1)
    adapter = NumpyModelAdapter(make_gaussian(**ORACLE_GAUSSIAN))
    t0 = time.perf_counter()
    out = run_numpy_smc(adapter, ORACLE_N, ORACLE_K, ORACLE_STEP, lkernel=lkernel,
                        tempering=tempering, seed=seed)
    return out["mean_estimate"][-1].tolist(), time.perf_counter() - t0


def oracle_phase(smi):
    """The Gaussian of tests/test_oracle_crossval.py (D=2) on the card through
    K6a, 3 seeds a strategy in one run_smc_batched call (run b equals run_smc
    with seed b), forwards without tempering and asymptotic with it; the
    serial NumPy oracle on the same model on the host's CPU, its six runs in
    worker processes meanwhile. The test's tolerances: each MC mean within
    0.3 of the truth, the two within 0.4 of each other. Then one run of the
    serial baseline at bench.py's size, timed on the host's CPU. Returns the
    Gaussian kernel's launches."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    phase("oracle. the card against the serial NumPy oracle (tests/test_oracle_crossval.py)")
    started = time.perf_counter()
    try:
        import scipy
    except ImportError as e:
        raise AssertionError("scipy is missing on this machine: the serial NumPy "
                             "oracle (smcnuts_torch.baselines.numpy_smc) needs it") from e
    print(f"host: numpy {np.__version__}, scipy {scipy.__version__}, "
          f"{os.cpu_count()} CPU cores")
    from smcnuts_torch import SMCConfig, run_smc_batched
    from smcnuts_torch.baselines.numpy_smc import NumpyArmaModel, run_numpy_smc
    from smcnuts_torch.models import make_gaussian
    from smcnuts_torch.utils.timing import CudaTimer

    truth = np.asarray(ORACLE_GAUSSIAN["mean"])
    launches = 0
    with ProcessPoolExecutor(len(ORACLE_STRATEGIES) * len(ORACLE_SEEDS),
                             mp_context=multiprocessing.get_context("spawn")) as procs:
        oracle = {(lk, seed): procs.submit(oracle_run, lk, temp, seed)
                  for lk, temp in ORACLE_STRATEGIES for seed in ORACLE_SEEDS}
        card = {}
        for lkernel, tempering in ORACLE_STRATEGIES:
            cfg = SMCConfig(n_particles=ORACLE_N, n_iterations=ORACLE_K,
                            step_size=ORACLE_STEP, lkernel=lkernel, tempering=tempering)
            model = make_gaussian(**ORACLE_GAUSSIAN)
            reset_counts()
            with CudaTimer() as t:
                res = run_smc_batched(model, cfg, list(ORACLE_SEEDS), "cuda")
                card[lkernel] = res.mean_estimate[:, ORACLE_K].double().cpu().numpy()
            counts, plain_calls = read_counts()
            label = f"oracle {lkernel}{' tempered' if tempering else ''}"
            if (counts["gaussian"] != ORACLE_K or sum(counts.values()) != ORACLE_K
                    or plain_calls != 0):
                raise AssertionError(f"{label}: {counts} dispatches, {plain_calls} plain "
                                     f"calls; expected {ORACLE_K} and 0")
            gaussian_entry_check(label, model, ORACLE_K)
            check_series(label, res, ORACLE_K)
            launches += counts["gaussian"]
            print(f"{label}: {len(ORACLE_SEEDS)} runs x N={ORACLE_N} x K={ORACLE_K} on the "
                  f"card in {t.ms:.1f} ms (CUDA events) ({smi})")
        for lkernel, tempering in ORACLE_STRATEGIES:
            label = f"oracle {lkernel}{' tempered' if tempering else ''}"
            runs = [oracle[(lkernel, seed)].result() for seed in ORACLE_SEEDS]
            cm = card[lkernel].mean(0)
            nm = np.mean([r[0] for r in runs], axis=0)
            print(f"{label}: MC mean of {len(ORACLE_SEEDS)} runs, card {cm.tolist()}, "
                  f"NumPy oracle {nm.tolist()} (its runs {[round(r[1], 3) for r in runs]} s "
                  f"on the host CPU, one process each), truth {truth.tolist()}")
            print(f"{label}: max |card - truth| {float(abs(cm - truth).max()):.4f}, "
                  f"|oracle - truth| {float(abs(nm - truth).max()):.4f} (tolerance 0.3), "
                  f"|card - oracle| {float(abs(cm - nm).max()):.4f} (tolerance 0.4)")
            np.testing.assert_allclose(cm, truth, atol=0.3, err_msg=f"{label}: card")
            np.testing.assert_allclose(nm, truth, atol=0.3, err_msg=f"{label}: oracle")
            np.testing.assert_allclose(cm, nm, atol=0.4, err_msg=f"{label}: card vs oracle")
    t0 = time.perf_counter()
    run_numpy_smc(NumpyArmaModel(), BASELINE_N, BASELINE_K, 0.01,
                  lkernel="forwardsLKernel", tempering=False, seed=0)
    seconds = time.perf_counter() - t0
    print(f"serial NumPy baseline, arma N={BASELINE_N} K={BASELINE_K} step 0.01 forwards "
          f"(bench.py:45-46's size), one run: {seconds:.3f} s on the host CPU of this "
          f"card's machine, {BASELINE_N * BASELINE_K / seconds:.1f} particle-iterations/s "
          f"(the host's, not the card's)")
    print(f"oracle phase: {time.perf_counter() - started:.1f} s")
    return launches


# ---- phase 10: the eager backend with the fused ARMA kernel (K5), the
# unfused proposal path on the whole-tree kernel (K1u), a wide eager run.

# FP32 operations of one particle in the fused ARMA kernel, counted from
# arma_loglik_grad (csrc/arma_model.cuh), the recurrence OPS_PER_LEAPFROG
# counts for the arma leapfrog: 19 a step of the T = 200 recurrence (3 for
# b_t, 2 each for the error and its three tangents, 2 each for the four sums;
# a negation folds into its FADD or FMUL and costs nothing) and 20 around it
# (8 for the first step, 12 for the loglik and gradient, expf as one).
ARMA_T = 200
ARMA_FUSED_OPS = 19 * (ARMA_T - 1) + 20
ARMA_FUSED_SIZES = (1, 513, 4096, RUNS * N, 1 << 20)
# The main path's shape: a leaf of the eager tree evaluates one block of
# eager_block_size = 4096 lanes (the last block of 25 x 512 holds 512).
EAGER_BLOCK = 4096
ARMA_FUSED_TIMED = (EAGER_BLOCK, RUNS * N, 1 << 20)
# Launches back to back for each device time of K5 (a few microseconds each).
FUSED_REPEATS = 200
WIDE_N, WIDE_K, WIDE_BLOCK = 1 << 20, 2, 1 << 18
FULL_COV = ((1.5, 0.3, 0.0, 0.0), (0.3, 1.0, 0.2, 0.0), (0.0, 0.2, 0.8, 0.0),
            (0.0, 0.0, 0.0, 1.2))


def fused_roofline(n):
    """The bound keys (`roofline`) of the fused kernel for n particles:
    n x ARMA_FUSED_OPS operations; 16 bytes in and 20 out a particle and y
    once."""
    return roofline(n * ARMA_FUSED_OPS, 36 * n + 4 * ARMA_T)


def bound_text(bound):
    """The bound keys as one printed phrase."""
    return (f"bound {bound['bound_ms']:.5f} ms by {bound['bound_by']} (FMUL+FADD: "
            f"{bound['bound_unfused_ms']:.5f} ms)")


def fused_equal(label, got, want):
    """Hold a fused kernel's (loglik, grad) to its plain version's to the bit
    (NaN equal to NaN); returns the non-finite values of each side."""
    for name, a, b in (("loglik", got[0], want[0]), ("grad", got[1], want[1])):
        if not bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()):
            d = (a - b).abs().nan_to_num(nan=float("inf"))
            raise AssertionError(f"{label}: {name} differs from the plain version "
                                 f"(max |diff| {float(d.max()):.3g})")
    return int((~torch.isfinite(got[0])).sum() + (~torch.isfinite(got[1])).sum())


def profiled_device_ms(fn, kernel, repeats):
    """(ms, count): the mean device time of the CUDA kernels whose name holds
    `kernel` that torch.profiler records over `repeats` calls of fn (one
    warmup), and how many it recorded: the cross-check of
    utils/timing.device_ms, which also counts the device's gap between two
    launches back to back."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total_us += getattr(evt, "device_time_total", None) or evt.cuda_time_total
            count += evt.count
    if count == 0:
        raise AssertionError(f"the profile holds no device kernel named *{kernel}*")
    return total_us / 1000.0 / count, count


def arma_fused_kernel_phase(smi):
    """10a: the fused ARMA kernel (W = GROUP lanes a particle) against its
    plain version at the same width on the same CUDA inputs at five sizes,
    equal to the bit, the lanes at log_sigma +-20, +-60 and |theta| >= 2
    included; its measurement entries (`FUSED_VARIANTS`: the one-thread
    witness and other widths) equal to the bit to the plain version at their
    width. Then every entry timed in turns on the device alone at the main
    path's block, 4,096 lanes, at 25 x 512 and at 1,048,576, the main entry's
    host-inclusive call time beside it, and the device-alone time
    cross-checked against torch.profiler's."""
    import statistics

    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.arma_fused import (
        FUSED_VARIANTS, GROUP, arma_ll_vg, arma_ll_vg_plain, arma_ll_vg_variant)
    from smcnuts_torch.utils.timing import device_ms, median_ms

    phase("10a. fused ARMA value and gradient (K5) vs plain")
    dev = torch.device("cuda")
    y = get_model("arma").to(dev).y32
    for v in FUSED_VARIANTS:
        arma_ll_vg_variant.launches[v] = 0
    for n in ARMA_FUSED_SIZES:
        theta = arma_cloud(n, 40 + n % 97, dev)
        nonfinite = fused_equal(f"K5 (W={GROUP}) at {n} lanes", arma_ll_vg(theta, y),
                                arma_ll_vg_plain(theta, y))
        print(f"K5 (W={GROUP}) at {n} lanes: equal to the plain version at W={GROUP} "
              f"to the bit, {nonfinite} non-finite values on both sides alike")
    theta = arma_cloud(EAGER_BLOCK, 41, dev)
    for v, (_, w) in FUSED_VARIANTS.items():
        fused_equal(f"K5 {v} at {EAGER_BLOCK} lanes", arma_ll_vg_variant(theta, y, v),
                    arma_ll_vg_plain(theta, y, group=w))
    print(f"K5 entries {sorted(FUSED_VARIANTS)} at {EAGER_BLOCK} lanes: each equal to "
          f"the plain version at its width to the bit")
    names = ["main", *FUSED_VARIANTS]
    widths = {"main": GROUP, **{v: w for v, (_, w) in FUSED_VARIANTS.items()}}
    times = {}
    for n in ARMA_FUSED_TIMED:
        theta = arma_cloud(n, 7, dev)
        calls = {"main": lambda: arma_ll_vg(theta, y)}
        calls.update({v: (lambda v=v: arma_ll_vg_variant(theta, y, v))
                      for v in FUSED_VARIANTS})
        rounds = {k: [] for k in names}
        for i in range(VARIANT_ROUNDS):
            for k in (names if i % 2 == 0 else names[::-1]):
                rounds[k].append(device_ms(calls[k], repeats=FUSED_REPEATS))
        med = {k: statistics.median(v) for k, v in rounds.items()}
        host_ms = median_ms(calls["main"], repeats=5)
        plain_ms = median_ms(lambda: arma_ll_vg_plain(theta, y), repeats=5)
        bound = fused_roofline(n)
        times[n] = (med, host_ms, plain_ms, bound)
        for k in names:
            print(f"time K5 {k} (W={widths[k]}) at {n} lanes: {med[k]:.5f} ms on the "
                  f"device alone ({FUSED_REPEATS} launches back to back; median of "
                  f"{VARIANT_ROUNDS} in turns: {', '.join(f'{v:.5f}' for v in rounds[k])}),"
                  f" {med['w1'] / med[k]:.3f}x faster than the W=1 witness ({smi})")
        print(f"time K5 at {n} lanes: a call timed alone {host_ms:.5f} ms (median of 5, "
              f"the host's launch included), plain {plain_ms:.3f} ms; "
              f"{bound_text(bound)} ({smi})")
    theta = arma_cloud(EAGER_BLOCK, 7, dev)
    prof_ms, count = profiled_device_ms(lambda: arma_ll_vg(theta, y), "arma_ll_vg_kernel",
                                        FUSED_REPEATS)
    alone = device_ms(lambda: arma_ll_vg(theta, y), repeats=FUSED_REPEATS)
    print(f"K5 at {EAGER_BLOCK} lanes: torch.profiler's device time {prof_ms:.5f} ms a "
          f"kernel (mean of the {count} it recorded of {FUSED_REPEATS} calls) against "
          f"device_ms {alone:.5f} ms a call ({smi})")
    med, host_ms, plain_ms, bound = times[ARMA_FUSED_TIMED[0]]
    k5 = {"max_abs_err": 0.0, "ms": med["main"], "host_call_ms": host_ms,
          "plain_ms": plain_ms, **bound}
    witness = {"launches": 0, "measurement_entry": True, "max_abs_err": 0.0,
               "ms": med["w1"],
               "host_call_ms": median_ms(lambda: arma_ll_vg_variant(theta, y, "w1"),
                                         repeats=5),
               "plain_ms": median_ms(lambda: arma_ll_vg_plain(theta, y, group=1),
                                     repeats=5), **bound}
    return k5, witness


# 10b's iterations: on an NVIDIA H100 80GB HBM3 at 700 W the eager path at
# K=100 took 88 s and its two single runs 40 more (PERF.md); the same checks
# at K=30 left time for phase `solvers` (71 s for 10b), at K=15 for phase
# tile_programs.
EAGER_K = 15


def eager_config(**kw):
    from smcnuts_torch import SMCConfig

    return SMCConfig(n_particles=N, n_iterations=K, step_size=STEP,
                     max_tree_depth=MAX_DEPTH, nuts_backend="eager",
                     fused_epilogue=False, **kw)


def eager_arma_phase(smi):
    """10b: the slice's path at full width, run_smc_batched(make_arma(
    fused="cuda"), eager, fused_epilogue=False) with 25 runs x 512 x
    K=EAGER_K at the default eager_block_size: K5 launched once per model evaluation of
    the tree, the whole-tree kernel and the plain K5 never; finite series,
    the PARITY bands, runs 0 and 24 equal to their single runs. Then 3
    iterations against the plain ARMA loop (fused=None). Returns K5's
    launches."""
    import dataclasses

    from smcnuts_torch import run_smc, run_smc_batched
    from smcnuts_torch.models import make_arma
    from smcnuts_torch.ops.arma_fused import arma_ll_vg, arma_ll_vg_plain
    from smcnuts_torch.ops.nuts_cuda import nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer

    phase(f"10b. eager arma path with K5, {RUNS} runs x N={N} x K={EAGER_K}")
    cfg = dataclasses.replace(eager_config(), n_iterations=EAGER_K)
    label = "arma eager, fused=\"cuda\", unfused proposal"
    reset_counts()
    t0 = time.perf_counter()
    with CudaTimer() as t:
        res = run_smc_batched(make_arma(fused="cuda"), cfg, SEEDS, "cuda")
        res.mean_estimate[:, EAGER_K].cpu()
    host_s = time.perf_counter() - t0
    counts, plain_calls = read_counts()
    k5, evals = arma_ll_vg.launches, nuts_tree_plain.model_calls
    print(f"{label}: K5 launches {k5}, model evaluations of the tree {evals}, "
          f"plain tree calls {plain_calls}, whole-tree kernel {counts}, plain K5 "
          f"calls {arma_ll_vg_plain.calls}")
    if not (k5 == evals > 0 and plain_calls == EAGER_K and sum(counts.values()) == 0
            and arma_ll_vg_plain.calls == 0):
        raise AssertionError(f"{label}: K5 must run every model evaluation of the "
                             f"eager tree, and nothing else may run")
    check_series(label, res, EAGER_K)
    print(f"{label}: wall {t.ms:.1f} ms (CUDA events, results on the host; host "
          f"clock {host_s:.3f} s), {t.ms / EAGER_K:.1f} ms an iteration, "
          f"{RUNS * N * EAGER_K / (t.ms / 1000.0):.0f} particle-iterations/s, "
          f"{k5 / EAGER_K:.1f} K5 launches an iteration ({smi})")
    print(f"{label}: mean tree depth {float(res.tree_depth[:, :EAGER_K].mean()):.3f}, "
          f"leapfrogs per particle-iteration "
          f"{float(res.tree_leapfrogs[:, :EAGER_K].mean()):.2f}, acceptance "
          f"{float(res.acceptance_rate[:, :EAGER_K].mean()):.3f}, resampled "
          f"{int(res.resampled.sum())}/{RUNS * EAGER_K}")
    parity_bands(label, "arma", res.mean_estimate[:, EAGER_K].cpu(),
                 res.variance_estimate[:, EAGER_K])
    for b in (0, RUNS - 1):
        diff = single_run_diff(run_smc(make_arma(fused="cuda"), cfg, SEEDS[b], "cuda"),
                               res, b)
        if diff:
            raise AssertionError(f"{label}: run {b} differs from its single run in {diff}")
    print(f"{label}: runs 0 and {RUNS - 1} equal their single runs, bit for bit")
    # Two iterations: an eager iteration takes seconds, and the profile runs three.
    profile_call(label, make_arma(fused="cuda"), dataclasses.replace(cfg, n_iterations=2),
                 smi, iterations=2)
    # What K5 removes: three iterations with the plain ARMA loop as the model.
    short = dataclasses.replace(cfg, n_iterations=3)
    walls = {}
    for name, fused in (("K5", "cuda"), ("plain ARMA loop", None)):
        with CudaTimer() as t:
            out = run_smc_batched(make_arma(fused=fused), short, SEEDS, "cuda")
            out.mean_estimate[:, 3].cpu()
        walls[name] = (t.ms, out)
    same = not equal_fields(walls["K5"][1], walls["plain ARMA loop"][1])
    print(f"{label}, K=3: {walls['K5'][0] / 3:.1f} ms an iteration with K5, "
          f"{walls['plain ARMA loop'][0] / 3:.1f} ms with the plain ARMA loop "
          f"(fused=None); results {'equal to the bit' if same else 'differ'} "
          f"(CUDA events; {smi})")
    return k5


def unfused_kernel_phase(smi):
    """10c: the unfused proposal path on the whole-tree kernel (momenta given,
    K1u): arma 25 x 512 x K=100 with fused_epilogue=False, forwards with the
    standard, a diagonal and a dense momentum proposal, and asymptotic with
    tempering: inside the bands, K dispatches with the momenta given and no
    plain tree, runs 0 and 24 equal their single runs. Then K1u against its
    plain version at 25 x 512, depth 10, timed. Returns (r-given launches,
    what the kernels line says of K1u)."""
    from smcnuts_torch import (
        DiagNormalProposal, FullNormalProposal, SMCConfig, run_smc, run_smc_batched)
    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.draws import PHILOX
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer, median_ms

    phase(f"10c. unfused proposal path on the kernel (K1u), {RUNS} runs x N={N} x K={K}")
    base = dict(n_particles=N, n_iterations=K, step_size=STEP,
                max_tree_depth=MAX_DEPTH, fused_epilogue=False)
    forwards = SMCConfig(**base)
    cases = (
        ("forwards, standard momentum", forwards, None),
        ("forwards, DiagNormalProposal(var=2)", forwards,
         DiagNormalProposal(4, var=(2.0, 2.0, 2.0, 2.0))),
        ("forwards, FullNormalProposal", forwards,
         FullNormalProposal(mean=(0.0,) * 4, cov=FULL_COV)),
        ("asymptotic, tempered", SMCConfig(**base, lkernel="asymptoticLKernel",
                                           tempering=True), None),
    )
    model = get_model("arma")
    r_given = 0
    for name, cfg, mp in cases:
        label = f"arma unfused, {name}"
        reset_counts()
        with CudaTimer() as t:
            res = run_smc_batched(model, cfg, SEEDS, "cuda", momentum_proposal=mp)
            res.mean_estimate[:, K].cpu()
        counts, plain_calls = read_counts()
        given = nuts_tree.r_given_launches["arma"]
        if counts["arma"] != K or given != K or plain_calls != 0:
            raise AssertionError(f"{label}: {counts} dispatches, {given} with the "
                                 f"momenta given, {plain_calls} plain calls")
        r_given += given
        check_series(label, res, K)
        print(f"{label}: {K} dispatches with the momenta given, no plain call; wall "
              f"{t.ms:.1f} ms (CUDA events, results on the host; {smi}); acceptance "
              f"{float(res.acceptance_rate[:, :K].mean()):.3f}, final ESS mean "
              f"{float(res.ess[:, K].mean()):.1f}")
        parity_bands(label, "arma", res.mean_estimate[:, K].cpu(), res.variance_estimate[:, K])
        for b in (0, RUNS - 1):
            diff = single_run_diff(
                run_smc(model, cfg, SEEDS[b], "cuda", momentum_proposal=mp), res, b)
            if diff:
                raise AssertionError(f"{label}: run {b} differs from its single run in {diff}")
        print(f"{label}: runs 0 and {RUNS - 1} equal their single runs, bit for bit")
    dev = torch.device("cuda")
    model = model.to(dev)
    args = (particles(RUNS * N, 8, dev).view(RUNS, N, 4),
            torch.arange(RUNS, dtype=torch.int32, device=dev), STEP, 1.0,
            torch.ones(4, device=dev), MAX_DEPTH, PHILOX)
    r = torch.randn(RUNS, N, 4, generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev)
    out = nuts_tree(model, *args, r=r)
    worst = check_outputs(f"K1u [philox] r given, {RUNS} x {N}, depth {MAX_DEPTH}",
                          out, nuts_tree_plain(model, *args, r=r), bitwise=True)
    t = kernel_times(lambda: nuts_tree(model, *args, r=r))
    plain_ms = median_ms(lambda: nuts_tree_plain(model, *args, r=r), repeats=1, warmup=0)
    bound = tree_roofline("arma", out)
    print(f"time K1u {RUNS} x {N} x depth {MAX_DEPTH} [philox, r given]: "
          f"{times_text(t)}, plain {plain_ms:.1f} ms (one call); "
          f"{bound_text(bound)} ({smi})")
    return r_given, {"max_abs_err": worst, **t, "plain_ms": plain_ms, **bound}


def wide_eager_phase(smi):
    """10d: arma at N = 1,048,576, one run, K = 2, on the eager tree with K5,
    in one block and in blocks of WIDE_BLOCK: every field equal to the bit;
    the wall and the peak device memory of each call. Then the tree's own
    peak: one eager tree (momenta given, as on the unfused path) on the run's
    final particles at each block size, the peak counter reset just before
    it and read above the memory held at its start."""
    import dataclasses

    from smcnuts_torch import run_smc_batched
    from smcnuts_torch.models import make_arma
    from smcnuts_torch.ops.arma_fused import arma_ll_vg
    from smcnuts_torch.ops.draws import PHILOX
    from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer

    phase(f"10d. wide eager run, arma N={WIDE_N}, K={WIDE_K}")
    cfg = dataclasses.replace(eager_config(), n_particles=WIDE_N, n_iterations=WIDE_K)
    results = {}
    for block in (None, WIDE_BLOCK):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with CudaTimer() as t:
            res = run_smc_batched(make_arma(fused="cuda"),
                                  dataclasses.replace(cfg, eager_block_size=block),
                                  [SEED], "cuda")
            res.mean_estimate[:, WIDE_K].cpu()
        check_series(f"wide eager, block {block}", res, WIDE_K)
        print(f"arma eager N={WIDE_N} K={WIDE_K}, eager_block_size {block}: wall "
              f"{t.ms:.1f} ms (CUDA events), peak device memory of the call "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, K5 launches "
              f"{arma_ll_vg.launches}, mean tree depth "
              f"{float(res.tree_depth[:, :WIDE_K].mean()):.3f} ({smi})")
        results[block] = res
    diff = equal_fields(results[None], results[WIDE_BLOCK])
    if diff:
        raise AssertionError(f"wide eager run: blocks of {WIDE_BLOCK} differ from one "
                             f"block in {diff}")
    print(f"wide eager run: blocks of {WIDE_BLOCK} equal one block in every field, "
          f"bit for bit")
    model = make_arma(fused="cuda").to("cuda")
    x = results[None].x_final.contiguous()
    r = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    trees = {}
    for block in (None, WIDE_BLOCK):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trees[block] = nuts_tree_plain(model, x, torch.tensor([SEED], dtype=torch.int32,
                                                              device="cuda"),
                                       STEP, 1.0, None, MAX_DEPTH, PHILOX, r=r,
                                       block_size=block)
        torch.cuda.synchronize()
        print(f"eager tree N={WIDE_N}, eager_block_size {block}: its own peak "
              f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.3f} GiB above the "
              f"{held / 2**30:.3f} GiB held before it ({smi})")
    a, b = trees[None], trees[WIDE_BLOCK]
    pairs = [(a[0], b[0]), (a[1], b[1])] + [(a[2][k], b[2][k]) for k in STAT_KEYS]
    if not all(bool(((u == v) | (u.isnan() & v.isnan())).all()) for u, v in pairs):
        raise AssertionError("wide eager tree: blocks differ from one block")
    print(f"eager tree N={WIDE_N}: blocks of {WIDE_BLOCK} equal one block, bit for bit")


def fused_phase(smi):
    """Phase 10: returns what the kernels line says of K5, its W = 1 witness
    and K1u."""
    k5, k5_w1 = arma_fused_kernel_phase(smi)
    k5["launches"] = eager_arma_phase(smi)
    r_given, k1u = unfused_kernel_phase(smi)
    k1u["launches"] = r_given
    wide_eager_phase(smi)
    return k5, k5_w1, k1u


# ---- phase 11: user-written densities, generated in-kernel models (K7).

GENERATED_BUILD_CAP_S = 120.0
EAGER_CARD_K = 5  # iterations of the eager (autograd) run on the card


def sass_instructions(path):
    """The SASS instructions of each kernel in the library at `path`
    (mangled name -> count, 16 bytes each), from the toolkit's cuobjdump; {}
    where the toolkit has none."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def sass_text(counts, match):
    """The instruction counts of the kernels whose mangled name contains
    `match`, as one printed phrase."""
    hits = [f"{n} ({16 * n / 1024:.1f} KB) in {name}" for name, n in sorted(counts.items())
            if match in name]
    return "; ".join(hits) if hits else "not measured (no cuobjdump)"


def generated_build(label, model):
    """Build one generated library; print its seconds, the values its
    program holds live at once in emission order, ptxas's lines and its
    kernels' SASS instructions."""
    from smcnuts_torch.ops.generated import build_generated, peak_live

    lib = build_generated(model.tile_model)
    tm = model.tile_model
    print(f"{label}: {tm.autodiff} mode, {tm.n_ops} operations, {tm.data.numel()} "
          f"data floats, at most {peak_live(tm.program)} values live at once in "
          f"emission order, source hash {tm.hash}; built {os.path.relpath(lib.path)} "
          f"in {lib.build_seconds:.1f} s")
    if lib.build_seconds > GENERATED_BUILD_CAP_S:
        raise AssertionError(f"{label}: the build took {lib.build_seconds:.1f} s, "
                             f"more than {GENERATED_BUILD_CAP_S:.0f}")
    for line in lib.log.splitlines():
        if ("Compiling entry" in line or "registers" in line or "spill" in line
                or "stack frame" in line):
            print("  ptxas:", line.strip())
    print(f"  SASS instructions: {sass_text(sass_instructions(lib.path), 'nuts_tree_kernel')}")


def require_rerolled(label, tm):
    """Fail unless the forward program's recurrences are emitted as loops
    (`ops.generated.Recurrence`); print each loop's plan."""
    import re

    recs = tm.program.recurrences
    if not recs:
        raise AssertionError(f"{label}: no recurrence was re-rolled as a loop")
    loops = "; ".join(
        f"ops {r.bounds[0]}..{r.bounds[-1] - 1}: {len(r.bounds) - 1} steps of "
        f"{len(r.classes)} kind(s), {len(r.registers)} registers "
        f"({sum(len(g.init) for g in r.registers if g.index >= 0)} slots in arrays), "
        f"{len(r.arrays)} export array(s)"
        + (f", in loop {r.head}'s iterations at shift {r.shift}" if r.head >= 0 else "")
        for r in recs)
    unroll = ", ".join(re.findall(r"#pragma unroll (\d+)", tm.source))
    print(f"{label}: {len(recs)} recurrence(s) emitted as loops ({loops}), unrolled by "
          f"{unroll}; {len(tm.source.splitlines())} source lines, {tm.data.numel()} data floats")


def generated_kernel_case(label, model, hand, x, step, smi):
    """K7 against its plain version at 25 x 512 x depth 10 under zero bits
    and Philox (to the bit, and phase 3's contract), the staged dispatch
    with a split after every depth against the single kernel (to the bit),
    and against the hand-written kernel of the same density on identical
    inputs (logp0 at atol/rtol 1e-4 on every lane, integer outputs on
    MIN_AGREE of the lanes); both timed in turns. Returns the kernels-line
    fields."""
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import device_ms, median_ms

    dev = x.device
    seeds = torch.arange(RUNS, dtype=torch.int32, device=dev)
    ones = torch.ones(x.shape[-1], device=dev)
    worst, plain_ms = 0.0, None
    for source in (ZERO_BITS, PHILOX):
        args = (x, seeds, step, 1.0, ones, MAX_DEPTH, source)
        out_k = nuts_tree(model, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = nuts_tree_plain(model, *args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        worst = max(worst, check_outputs(f"{label} [{source}] kernel vs plain", out_k,
                                         out_p, nan_lanes=True, bitwise=True))
        print(f"{label} [{source}]: kernel and plain version equal to the bit; plain "
              f"{plain_s:.1f} s")
        staged = nuts_tree(model, *args, compaction=tuple(range(1, MAX_DEPTH)))
        if bitwise_differences(staged, out_k):
            raise AssertionError(f"{label} [{source}]: staged differs from single")
        out_h = nuts_tree(hand, *args)
        torch.cuda.synchronize()
        lp_k, lp_h = out_k[2]["logp0"], out_h[2]["logp0"]
        bad = (lp_k - lp_h).abs() > ATOL + RTOL * lp_h.abs()
        if bad.any():
            raise AssertionError(f"{label} [{source}]: logp0 differs from the hand "
                                 f"kernel's on {int(bad.sum())} lanes")
        agree = float(((out_k[2]["depth"] == out_h[2]["depth"])
                       & (out_k[2]["leapfrogs"] == out_h[2]["leapfrogs"])
                       & (out_k[2]["moved"] == out_h[2]["moved"])).float().mean())
        if agree < MIN_AGREE:
            raise AssertionError(f"{label} [{source}]: integer outputs agree with the "
                                 f"hand kernel's on only {100 * agree:.3f}% of lanes")
        print(f"{label} [{source}]: staged (a split after every depth) equal to the "
              f"single kernel to the bit; against the hand kernel: logp0 within "
              f"{float((lp_k - lp_h).abs().max()):.3g}, integer outputs agree on "
              f"{100 * agree:.3f}% of lanes, max |x diff| "
              f"{float((out_k[0] - out_h[0]).abs().max()):.3g}, max |delta_h diff| "
              f"{float((out_k[2]['delta_h'] - out_h[2]['delta_h']).abs().nan_to_num().max()):.3g}")
        if source == PHILOX:
            # The Philox call above, timed on the host after a synchronize
            # (one call takes seconds).
            plain_ms = 1e3 * plain_s
            single = out_k
    times = {"hand": [], "generated": []}
    for who in ("hand", "generated", "generated", "hand"):
        m = hand if who == "hand" else model
        times[who].append(device_ms(lambda: nuts_tree(m, *args), repeats=DEVICE_REPEATS))
    ms, hand_ms = min(times["generated"]), min(times["hand"])
    host_ms = median_ms(lambda: nuts_tree(model, *args), repeats=5)
    bound = tree_roofline("generated", single, model=model.tile_model)
    print(f"time {label}, {RUNS} x {N} x depth {MAX_DEPTH} [philox]: generated "
          f"{times['generated']} ms, hand {times['hand']} ms (device alone, "
          f"{DEVICE_REPEATS} launches back to back, in turns hand, generated, "
          f"generated, hand; a call of the generated timed alone {host_ms:.4f} ms): "
          f"{ms / hand_ms:.3f}x; plain "
          f"{plain_ms:.1f} ms; {bound_text(bound)} "
          f"({model.tile_model.n_ops} operations x "
          f"{float(single[2]['leapfrogs'].sum()):.0f} leapfrogs; {smi})")
    return {"max_abs_err": worst, "ms": ms, "host_call_ms": host_ms, "plain_ms": plain_ms,
            **bound}


def generated_builds(label, model, others, hand, x, step, smi, same_program=True,
                     main_plain_ms=None):
    """Other builds of one generated density (`others`: a readable name ->
    a CallableModel of the same density, each its own library), under zero
    bits and Philox at 25 x 512 x depth 10: with `same_program` (the same
    program in another emission order) each equal to `model`'s kernel to the
    bit, which generated_kernel_case held to their one plain program
    (main_plain_ms its time); else each equal to its own plain program to
    the bit. Then every build, `model` and the hand kernel timed in turns
    (the device alone, median of VARIANT_ROUNDS). Returns the kernels-line
    row of each of `others` (name -> row), each a measurement entry that
    the main path never launches."""
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer, median_ms

    dev = x.device
    seeds = torch.arange(RUNS, dtype=torch.int32, device=dev)
    ones = torch.ones(x.shape[-1], device=dev)
    errs, plain_ms, outs = {who: [] for who in others}, {}, {}
    for source in (ZERO_BITS, PHILOX):
        args = (x, seeds, step, 1.0, ones, MAX_DEPTH, source)
        main = nuts_tree(model, *args) if same_program else None
        for who, other in others.items():
            out = nuts_tree(other, *args)
            if same_program:
                diff = bitwise_differences(out, main)
                if diff:
                    raise AssertionError(f"{label} {who} [{source}]: differs from the "
                                         f"main build's kernel in {diff}")
                err, ms = 0.0, main_plain_ms
                print(f"{label} {who} [{source}]: equal to the main build's kernel, and so "
                      f"to their plain program, to the bit")
            else:
                with CudaTimer() as t:
                    plain = nuts_tree_plain(other, *args)
                err = check_outputs(f"{label} {who} [{source}] kernel vs plain", out, plain,
                                    nan_lanes=True, bitwise=True)
                ms = t.ms
                print(f"{label} {who} [{source}]: equal to its plain program to the bit")
            errs[who].append(err)
            if source == PHILOX:
                plain_ms[who], outs[who] = ms, out
    calls = {"hand": lambda: nuts_tree(hand, *args),
             "main": lambda: nuts_tree(model, *args)}
    calls.update({who: (lambda m=m: nuts_tree(m, *args)) for who, m in others.items()})
    rounds, med = timed_in_turns(calls)
    for k in calls:
        print(f"time {label} {k}, {RUNS} x {N} x depth {MAX_DEPTH} [philox]: "
              f"{med[k]:.4f} ms, {med[k] / med['hand']:.3f}x the hand kernel's (device "
              f"alone, {DEVICE_REPEATS} launches back to back; median of "
              f"{VARIANT_ROUNDS} in turns: {', '.join(f'{v:.4f}' for v in rounds[k])}; "
              f"{smi})")
    rows = {}
    for who, other in others.items():
        bound = tree_roofline("generated", outs[who], model=other.tile_model)
        rows[who] = {"launches": 0, "measurement_entry": True, "max_abs_err": max(errs[who]),
                     "ms": med[who], "host_call_ms": median_ms(calls[who], repeats=5),
                     "plain_ms": plain_ms[who], **bound}
    return rows


def generated_split(label, model, hand, cfg, smi):
    """Where a generated model's main-path call spends the time beside the
    hand model's: `init_state` of each alone (CUDA events, the second of two
    calls), then `profile_call` of each (the first iterations of the loop).
    A measurement, not a check."""
    from smcnuts_torch.sampler import init_state
    from smcnuts_torch.utils.timing import CudaTimer

    init_ms = {}
    for who, m in (("generated", model), ("hand", hand)):
        for _ in range(2):
            with CudaTimer() as t:
                init_state(m, cfg, SEEDS, "cuda").logw.sum().item()
        init_ms[who] = t.ms
    print(f"{label}: init_state {init_ms['generated']:.1f} ms generated, "
          f"{init_ms['hand']:.1f} ms hand (CUDA events, second call; {smi})")
    profile_call(f"{label} (generated)", model, cfg, smi)
    profile_call(f"{label} (hand)", hand, cfg, smi)


def generated_phase(smi):
    """Phase 11: returns what the kernels line says of K7f and K7r."""
    from concurrent.futures import ThreadPoolExecutor

    from smcnuts_torch import SMCConfig, run_smc, run_smc_batched
    from smcnuts_torch.models import get_model
    from smcnuts_torch.models.arma import arma_model_fwd
    from smcnuts_torch.models.base import CallableModel
    from smcnuts_torch.models.eightschools import make_eightschools_generated
    from smcnuts_torch.ops.draws import PHILOX
    from smcnuts_torch.ops.generated import build_generated
    from smcnuts_torch.ops.nuts_cuda import build_library, nuts_tree

    phase("11. user-written densities: generated in-kernel models (K7f, K7r)")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    arma = arma_model_fwd().to(dev)
    t1 = time.perf_counter()
    schools = make_eightschools_generated().to(dev)
    print(f"traced and simplified: arma (T=200, forward) in {t1 - t0:.1f} s, eight "
          f"schools (reverse) in {time.perf_counter() - t1:.1f} s; K7r "
          f"{schools.tile_model.group} lane(s) a particle")
    # K7r split over 2 lanes a particle, its sums over the schools a loop: a
    # measurement entry, a library of its own.
    schools_w2 = make_eightschools_generated(group=2).to(dev)
    # K7f's witnesses: the same program straight-line (the emission before
    # its recurrence was re-rolled as a loop), and straight-line in the order
    # it was built, the whole primal before the first tangent pass (the
    # emission before the (primal node, pass) order).
    require_rerolled("K7f arma", arma.tile_model)
    others = {"straight-line": arma_model_fwd(reroll=False).to(dev),
              "built order": arma_model_fwd(order="built").to(dev)}
    # The five libraries' nvcc at once (~7 s each alone); generated_build
    # then reports each.
    with ThreadPoolExecutor(5) as pool:
        list(pool.map(lambda m: build_generated(m.tile_model),
                      (arma, others["straight-line"], others["built order"], schools,
                       schools_w2)))
    generated_build("K7f arma", arma)
    generated_build("K7f arma, straight-line (the witness)", others["straight-line"])
    generated_build("K7f arma, built order (the witness)", others["built order"])
    generated_build("K7r eight schools", schools)
    generated_build("K7r eight schools, 2 lanes a particle", schools_w2)
    hand = sass_instructions(build_library().path)
    print(f"hand arma entries, SASS instructions: {sass_text(hand, 'ArmaModel')}")
    print(f"hand eight-schools entries, SASS instructions: "
          f"{sass_text(hand, 'EightSchoolsModel')}")

    x_arma = particles(RUNS * N, 6, dev).view(RUNS, N, 4)
    k7f = generated_kernel_case("K7f arma", arma, get_model("arma").to(dev), x_arma,
                                STEP, smi)
    k7f_witnesses = generated_builds("K7f arma", arma, others, get_model("arma").to(dev),
                                     x_arma, STEP, smi, main_plain_ms=k7f["plain_ms"])
    es = AUTODIFF_MODELS["eightschools"]
    x_schools = autodiff_cloud("eightschools", (RUNS, N), 5, dev)
    k7r = generated_kernel_case("K7r eight schools", schools,
                                get_model("eightschools").to(dev), x_schools,
                                es["cloud_step"], smi)
    k7r_w2 = generated_builds("K7r eight schools", schools,
                              {"2 lanes a particle": schools_w2},
                              get_model("eightschools").to(dev), x_schools,
                              es["cloud_step"], smi, same_program=False)["2 lanes a particle"]

    # K7r at the shape of its main path's run below (RUNS x n trees at the
    # run's step and depth), phi 1.0 and 0.1, and at WIDE_TREES trees (where
    # one thread a particle fills the card), in turns with its split over 2
    # lanes and the hand kernel.
    ones = torch.ones(schools.dim, device=dev)
    shapes = [(f"{RUNS} x {es['n']} x depth {es['depth']}, step {es['step']}, phi {phi}",
               (autodiff_cloud("eightschools", (RUNS, es["n"]), 6, dev),
                torch.arange(RUNS, dtype=torch.int32, device=dev), es["step"], phi, ones,
                es["depth"], PHILOX)) for phi in (1.0, 0.1)]
    shapes.append((f"1 x {WIDE_TREES} x depth {MAX_DEPTH}, step {es['cloud_step']}, phi 1.0",
                   (autodiff_cloud("eightschools", (1, WIDE_TREES), 8, dev), 31,
                    es["cloud_step"], 1.0, ones, MAX_DEPTH, PHILOX)))
    hand_schools = get_model("eightschools").to(dev)
    for shape, args in shapes:
        calls = {"hand": lambda: nuts_tree(hand_schools, *args),
                 "main": lambda: nuts_tree(schools, *args),
                 "2 lanes a particle": lambda: nuts_tree(schools_w2, *args)}
        rounds, med = timed_in_turns(calls)
        for k in calls:
            print(f"time K7r eight schools {k}, {shape} [philox]: {med[k]:.4f} ms, "
                  f"{med['main'] / med[k]:.3f}x faster than the main entry "
                  f"(device alone, {DEVICE_REPEATS} launches back to back; median of "
                  f"{VARIANT_ROUNDS} in turns: {', '.join(f'{v:.4f}' for v in rounds[k])}; "
                  f"{smi})")

    # The main path: the generated arma at bench.py's configuration, inside
    # the PARITY bands.
    cfg = workload_config(False)
    res, k7f["launches"], _ = strategy_run("generated arma, forwards", "generated",
                                           arma, cfg, smi)
    parity_bands("generated arma, forwards", "arma", res.mean_estimate[:, K].cpu(),
                 res.variance_estimate[:, K])
    generated_split("arma, forwards", arma, get_model("arma").to(dev), cfg, smi)
    # Eight schools at phase 9's configuration, inside the bands of the hand
    # kernel's run with the same seeds.
    k = es["k"]
    cfg = SMCConfig(n_particles=es["n"], n_iterations=k, step_size=es["step"],
                    lkernel=es["lkernel"], tempering=True, save_history=False,
                    max_tree_depth=es["depth"])
    label = f"generated eight schools {es['lkernel']} tempered"
    res, k7r["launches"], _ = strategy_run(label, "generated", schools, cfg, smi)
    ref = run_smc_batched(get_model("eightschools"), cfg, SEEDS, "cuda")
    estimates_band(f"{label} vs the hand kernel's {RUNS} runs",
                   res.mean_estimate[:, k], res.variance_estimate[:, k],
                   ref.mean_estimate[:, k].double().mean(0),
                   ref.variance_estimate[:, k].double().mean(0))
    generated_split("eight schools, tempered", schools, get_model("eightschools").to(dev),
                    cfg, smi)

    # The same density without a generated model: eager, by autograd, on the card.
    eager = CallableModel("eightschools", schools.dim, schools._logprior, schools._loglik,
                          schools._constrain)
    cfg = SMCConfig(n_particles=es["n"], n_iterations=EAGER_CARD_K, step_size=es["step"],
                    max_tree_depth=es["depth"])
    reset_counts()
    t0 = time.perf_counter()
    res = run_smc(eager, cfg, 0, "cuda")
    wall = time.perf_counter() - t0
    counts, plain_calls = read_counts()
    check_series("eager eight schools (autograd) on the card", res, EAGER_CARD_K)
    if sum(counts.values()) != 0 or plain_calls != EAGER_CARD_K:
        raise AssertionError(f"the eager run must take the plain tree: {counts}, "
                             f"{plain_calls}")
    print(f"eager eight schools (autograd, no generated model) on the card: "
          f"{EAGER_CARD_K} iterations in {wall:.1f} s (host clock), no kernel launch, "
          f"final mean {[round(v, 3) for v in res.mean_estimate[EAGER_CARD_K].tolist()[:2]]}")
    return k7f, k7r, k7f_witnesses, k7r_w2


# ---- phase 12: chunked runs that resume, checkpoints, the CLI's output,
# phase profiling.

class Crash(Exception):
    """Raised from a runner's progress callback: a run that stops after a
    chunk, its checkpoint written."""


def crash_after(k_stop):
    def progress(k_done, total):
        if k_done == k_stop:
            raise Crash
    return progress


class PhaseCounts:
    """The main-path launches of a phase: `run(fn)` resets the counters,
    calls fn and adds what it launched (dispatches and continuation-stage
    launches, per model) to the phase's totals."""

    def __init__(self):
        self.launches, self.cont = {}, {}

    def run(self, fn):
        reset_counts()
        try:
            out = fn()
        finally:
            counts, plain_calls = read_counts()
            stage_launches, cont = read_stage_counts()
            for name, n in counts.items():
                self.launches[name] = self.launches.get(name, 0) + n
                self.cont[name] = self.cont.get(name, 0) + cont.get(name, 0)
        return out, counts, plain_calls, stage_launches


def same_result(label, got, want):
    diff = equal_fields(got, want)
    if diff:
        raise AssertionError(f"{label}: differs from the uninterrupted run in {diff}")


def runner_phase(smi):
    """Phase 12: ChunkedRunner, checkpoints of the SMC state, the CLI's
    --checkpoint / --chunk-size / --output, and utils.profiling.phase_timings,
    on the card. Returns the main-path launches (PhaseCounts)."""
    import tempfile

    import numpy as np

    from smcnuts_torch import SMCConfig, run_smc, run_smc_batched
    from smcnuts_torch.models import default_step_size, get_model
    from smcnuts_torch.runner import ChunkedRunner
    from smcnuts_torch.utils.checkpoint import CHECKPOINT_VERSION
    from smcnuts_torch.utils.profiling import phase_timings
    from smcnuts_torch.utils.timing import CudaTimer

    phase("12. runner, checkpoint, CLI output, profiling")
    started = time.perf_counter()
    tally = PhaseCounts()
    tmp = tempfile.TemporaryDirectory()
    ck = os.path.join(tmp.name, "smc.npz")

    def fresh():
        if os.path.exists(ck):
            os.remove(ck)

    def timed(fn):
        with CudaTimer() as t:
            res = fn()
            res.mean_estimate[:, -1].cpu()
        return res, t.ms

    # (a) arma forwards, bench.py's config: run_smc_batched, and
    # ChunkedRunner in chunks of 10 with a checkpoint after each and without
    # one, in turns (each order forwards, then backwards).
    arma, cfg = get_model("arma"), workload_config(False)
    calls = {
        "run_smc_batched": lambda: run_smc_batched(arma, cfg, SEEDS, "cuda"),
        "ChunkedRunner with checkpoints": lambda: ChunkedRunner(
            arma, cfg, checkpoint_path=ck, chunk_size=10, device="cuda").run(SEEDS),
        "ChunkedRunner without": lambda: ChunkedRunner(
            arma, cfg, chunk_size=10, device="cuda").run(SEEDS),
    }
    walls, ref = [], None
    for turn in list(calls) + list(calls)[::-1]:
        fresh()
        (res, ms), counts, plain_calls, _ = tally.run(lambda: timed(calls[turn]))
        if counts["arma"] != K or sum(counts.values()) != K or plain_calls != 0:
            raise AssertionError(f"(a) {turn}: {counts} dispatches, {plain_calls} "
                                 f"plain calls; expected {K} and 0")
        walls.append((turn, ms))
        if os.path.exists(ck):
            size = os.path.getsize(ck)
        if ref is None:
            ref = res
        same_result(f"(a) arma forwards, {turn}", res, ref)
    print(f"(a) arma forwards {RUNS} x {N} x K={K}: ChunkedRunner (chunks of 10, with "
          f"a checkpoint after each and without) equals run_smc_batched in every "
          f"field, bit for bit; {K} kernel launches, no plain call, each call")
    mean = {turn: sum(ms for t, ms in walls if t == turn) / 2 for turn in calls}
    print(f"(a) walls in turns (CUDA events, results on the host): "
          + ", ".join(f"{turn} {ms:.1f}" for turn, ms in walls) + f" ms ({smi}); a "
          f"checkpoint ({size} bytes) adds "
          f"{(mean['ChunkedRunner with checkpoints'] - mean['ChunkedRunner without']) / 10:.1f} "
          f"ms, the mean difference over its 10 writes")

    # (b) A crash after 30 iterations: a K=30 run with the checkpoint, then
    # the K=100 run from the same file.
    import dataclasses

    fresh()
    k_crash = 30
    tally.run(lambda: ChunkedRunner(arma, dataclasses.replace(cfg, n_iterations=k_crash),
                                    checkpoint_path=ck, chunk_size=10,
                                    device="cuda").run(SEEDS))
    with np.load(ck) as data:
        version, k_done = int(data["version"]), int(data["k_done"])
    if (version, k_done) != (CHECKPOINT_VERSION, k_crash):
        raise AssertionError(f"(b) checkpoint version {version}, k_done {k_done}")
    res, counts, plain_calls, _ = tally.run(
        lambda: ChunkedRunner(arma, cfg, checkpoint_path=ck, chunk_size=10,
                              device="cuda").run(SEEDS))
    if counts["arma"] != K - k_crash or sum(counts.values()) != K - k_crash or plain_calls:
        raise AssertionError(f"(b) the resumed run: {counts} dispatches, {plain_calls} "
                             f"plain calls; expected {K - k_crash} and 0")
    same_result("(b) arma resumed after 30", res, ref)
    print(f"(b) checkpoint version {version}, k_done {k_done}; the K={K} run resumed "
          f"from it launched the kernel {counts['arma']} times and equals the "
          f"uninterrupted run in every field, bit for bit")

    # (c) PRMwCD adapted (bench.py:176-178), stopped after iteration 40.
    prmwcd, cfg_a = get_model("prmwcd"), workload_config(True)
    ref_a, counts, _, stages_ref = tally.run(
        lambda: run_smc_batched(prmwcd, cfg_a, SEEDS, "cuda"))
    fresh()
    runner = ChunkedRunner(prmwcd, cfg_a, checkpoint_path=ck, chunk_size=10, device="cuda")

    def stopped():
        try:
            runner.run(SEEDS, progress=crash_after(40))
        except Crash:
            return
        raise AssertionError("(c) the run did not stop after iteration 40")

    _, counts_1, _, stages_1 = tally.run(stopped)
    res, counts_2, plain_calls, stages_2 = tally.run(lambda: runner.run(SEEDS))
    if (counts_1["prmwcd"], counts_2["prmwcd"], plain_calls) != (40, K - 40, 0):
        raise AssertionError(f"(c) dispatches {counts_1}, {counts_2}, plain {plain_calls}")
    same_result("(c) PRMwCD adapted resumed after 40", res, ref_a)
    print(f"(c) PRMwCD adapted {RUNS} x {N} x K={K}, stopped after iteration 40 and "
          f"resumed: every field equal to the uninterrupted run, bit for bit; kernel "
          f"launches (stages) uninterrupted {stages_ref}, stopped + resumed "
          f"{stages_1} + {stages_2}")

    # (d) Eight schools, asymptotic with tempering (K6b), history on and off,
    # stopped after iteration 10.
    c = AUTODIFF_MODELS["eightschools"]
    schools = autodiff_model("eightschools")
    for history in (True, False):
        cfg_s = SMCConfig(n_particles=c["n"], n_iterations=c["k"], step_size=c["step"],
                          lkernel="asymptoticLKernel", tempering=True,
                          save_history=history, max_tree_depth=c["depth"])
        ref_s, counts, _, _ = tally.run(lambda: run_smc_batched(schools, cfg_s, SEEDS, "cuda"))
        fresh()
        runner = ChunkedRunner(schools, cfg_s, checkpoint_path=ck, chunk_size=10,
                               device="cuda")
        try:
            tally.run(lambda: runner.run(SEEDS, progress=crash_after(10)))
            raise AssertionError("(d) the run did not stop after iteration 10")
        except Crash:
            pass
        res, counts_2, plain_calls, _ = tally.run(lambda: runner.run(SEEDS))
        if counts_2["eightschools"] != c["k"] - 10 or plain_calls:
            raise AssertionError(f"(d) the resumed run: {counts_2}, plain {plain_calls}")
        same_result(f"(d) eight schools save_history={history}", res, ref_s)
        print(f"(d) eight schools asymptotic tempered {RUNS} x {c['n']} x K={c['k']}, "
              f"save_history={history}: resumed after iteration 10 ({counts_2['eightschools']} "
              f"dispatches), every field equal to the uninterrupted run, bit for bit")

    # (e) The CLI with a checkpoint, chunks and an output file, then again.
    fresh()
    npz = ck + ".out.npz"
    argv = ["--model", "prmwcd", "-N", str(N), "-K", str(K), "--max-tree-depth",
            str(MAX_DEPTH), "--checkpoint", ck, "--chunk-size", "10", "--output", npz,
            "--device", "cuda"]
    summary, counts, plain_calls, _ = tally.run(lambda: quiet_cli(argv))
    if counts["prmwcd"] != K or plain_calls:
        raise AssertionError(f"(e) the CLI run: {counts}, plain {plain_calls}")
    # The configuration the CLI builds for these flags.
    cfg_cli = SMCConfig(n_particles=N, n_iterations=K,
                        step_size=default_step_size("prmwcd"), max_tree_depth=MAX_DEPTH,
                        save_history=False)
    want, _, _, _ = tally.run(lambda: run_smc(prmwcd, cfg_cli, 0, "cuda"))
    with np.load(npz) as data:
        fields = {f for f, v in want._asdict().items() if v is not None}
        if set(data.files) != fields:
            raise AssertionError(f"(e) the npz holds {sorted(data.files)}, not "
                                 f"{sorted(fields)}")
        diff = [f for f in fields
                if not torch.equal(torch.from_numpy(data[f]), getattr(want, f).cpu())]
    if diff:
        raise AssertionError(f"(e) the npz differs from the in-process run in {diff}")
    again, counts, plain_calls, _ = tally.run(lambda: quiet_cli(argv))
    if sum(counts.values()) or plain_calls or again != summary:
        raise AssertionError(f"(e) the rerun at k_done == K: {counts}, plain "
                             f"{plain_calls}, the same summary: {again == summary}")
    print(f"(e) CLI {' '.join(argv[:8])} --checkpoint --chunk-size 10 --output: the "
          f"npz's {len(fields)} fields equal the in-process run_smc result, bit for "
          f"bit; run again, it resumed at k_done == K, launched no kernel and "
          f"printed the same summary")
    tmp.cleanup()

    # (f) Seconds an iteration of each SMC phase, arma, one run at N=512.
    t = phase_timings(arma, cfg, seed=SEED, device="cuda")
    print(f"(f) phase_timings arma, one run, N={N}, depth {MAX_DEPTH}, ms an "
          f"iteration (CUDA events, 20 calls back to back, best of 3): "
          + ", ".join(f"{k} {1e3 * v:.4f}" for k, v in t.items()) + f" ({smi})")
    print(f"phase 12 took {time.perf_counter() - started:.1f} s (host clock; its "
          f"budget is 90 s)")
    return tally


# ---- phase 13: Stan programs on the card, through the port's frontend.

# The slice's three programs: two examples of the repository and the AR(1)
# error recurrence of tests/test_stan_frontend.py:270-284 at T = 200, its
# data made by `_recurrence_data(T=200)` there (copied, as the port's test
# copies it). Step sizes: examples/stan/README.md's 0.2 for radon is its
# tempered asymptotic run's; under the forwards L-kernel without tempering
# the trees diverge at 0.2 (radon) and at the CLI's 0.5 (the other two):
# experiments/stan_step_sizes_torch.py (the port, on the card or the CPU) and
# experiments/stan_step_sizes_jax.py (the JAX frontend, on the CPU) print
# acceptance and depth at each step (PERF.md, §6).
STAN_RECURRENCE = """
data { int<lower=1> T; real y[T]; real phi; }
parameters { real a; real<lower=0> s; }
model {
  vector[T] e;
  real acc;
  acc = 0;
  e[1] = y[1];
  for (t in 2:T) {
    e[t] = y[t] - a * e[t-1];
    acc += e[t] * 0.001;
  }
  target += normal_lpdf(a | 0, 1);
  target += phi * (normal_lpdf(e | 0, s) + acc);
}
"""
# The Stan case study's Lotka-Volterra model (N = 20 years of two species,
# D = 8, its priors), in the new ODE interface; `{solver}` is the call:
# lv_rk45 the adaptive solver (eager), lv_rk4 fixed-step RK4 at LV_RK4_STEPS
# steps a year (the kernel). The trajectory z is the model block's (the
# case study's transformed parameter): `constrain`, which the sampler calls
# every iteration for the estimates, then solves no ODE, and a prior draw
# whose RK4 trajectory overflows float32 leaves no infinite estimate (a
# zero weight times an infinite value is NaN in the weighted mean).
LV_PROGRAM = """
functions {
  vector dz_dt(real t, vector z, array[] real theta) {
    real u = z[1];
    real v = z[2];
    vector[2] dz;
    dz[1] = (theta[1] - theta[2] * v) * u;
    dz[2] = (-theta[3] + theta[4] * u) * v;
    return dz;
  }
}
data {
  int<lower=0> N;
  array[N] real ts;
  array[2] real y_init;
  array[N, 2] real<lower=0> y;
}
parameters {
  array[4] real<lower=0> theta;
  vector<lower=0>[2] z_init;
  array[2] real<lower=0> sigma;
}
model {
  array[N] vector[2] z = {solver};
  theta[{1, 3}] ~ normal(1, 0.5);
  theta[{2, 4}] ~ normal(0.05, 0.05);
  sigma ~ lognormal(-1, 1);
  z_init ~ lognormal(log(10), 1);
  for (k in 1:2) {
    y_init[k] ~ lognormal(log(z_init[k]), sigma[k]);
    y[:, k] ~ lognormal(log(z[:, k]), sigma[k]);
  }
}
"""
# The smallest steps a year whose RK4 solution is within 1e-4 relative of
# lv_rk45's on the median of 1,024 prior draws
# (experiments/lv_rk4_steps_torch.py; PERF.md).
LV_RK4_STEPS = 12
# The case study's posterior means, which lv_data's counts are drawn around.
LV_TRUTH = (0.55, 0.028, 0.80, 0.024, 33.9, 5.9, 0.25, 0.25)


def lv_data(seed=0):
    """N = 20 yearly counts of both species and the initial state: the
    trajectory from LV_TRUTH by RK4 at 1,000 steps a year, times lognormal
    noise of sd 0.25 drawn from a numpy seed (tests/test_torch_stan_solvers.py
    makes the same data)."""
    import numpy as np

    a, b, c, d, u0, v0 = LV_TRUTH[:6]
    z = np.array([u0, v0])

    def f(z):
        return np.array([(a - b * z[1]) * z[0], (-c + d * z[0]) * z[1]])

    h, zs = 1e-3, []
    for _ in range(20):
        for _ in range(1000):
            k1 = f(z)
            k2 = f(z + h / 2 * k1)
            k3 = f(z + h / 2 * k2)
            k4 = f(z + h * k3)
            z = z + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        zs.append(z)
    rng = np.random.default_rng(seed)
    y = np.array(zs) * np.exp(0.25 * rng.normal(size=(20, 2)))
    y_init = np.array([u0, v0]) * np.exp(0.25 * rng.normal(size=2))
    return {"N": 20, "ts": [float(t) for t in range(1, 21)], "y_init": y_init.tolist(),
            "y": y.tolist()}


# The five programs of the special functions (N = 200 observations each, made
# from a numpy seed; tests/test_torch_stan_special.py holds the same at
# N = 24): von Mises with unknown mu and kappa (cos, sin, i0e, i1e),
# skew-normal regression and exp-modified-normal reaction times (log_ndtr of
# a parameter), student-t regression with unknown nu (lgamma of a parameter,
# digamma), probit regression with K = 5 covariates (Phi of a parameter, erf).
SPECIAL_N = 200
VON_MISES = """
data { int<lower=1> N; vector[N] y; }
parameters { real mu; real<lower=0> kappa; }
model {
  mu ~ normal(0, 1);
  kappa ~ gamma(2, 0.5);
  y ~ von_mises(mu, kappa);
}
"""
SKEW_NORMAL = """
data { int<lower=1> N; vector[N] x; vector[N] y; }
parameters { real a; real b; real<lower=0> omega; real alpha; }
model {
  a ~ normal(0, 5);
  b ~ normal(0, 5);
  omega ~ normal(0, 2);
  alpha ~ normal(0, 3);
  y ~ skew_normal(a + b * x, omega, alpha);
}
"""
STUDENT_T = """
data { int<lower=1> N; vector[N] x; vector[N] y; }
parameters { real a; real b; real<lower=0> sigma; real<lower=1> nu; }
model {
  a ~ normal(0, 5);
  b ~ normal(0, 5);
  sigma ~ normal(0, 2);
  nu ~ gamma(2, 0.1);
  y ~ student_t(nu, a + b * x, sigma);
}
"""
PROBIT = """
data { int<lower=1> N; int<lower=1> K; matrix[N, K] X; array[N] int<lower=0, upper=1> y; }
parameters { real alpha; vector[K] beta; }
model {
  alpha ~ normal(0, 2);
  beta ~ normal(0, 1);
  y ~ bernoulli(Phi(alpha + X * beta));
}
"""
EXP_MOD_NORMAL = """
data { int<lower=1> N; vector[N] rt; }
parameters { real mu; real<lower=0> sigma; real<lower=0> lambda; }
model {
  mu ~ normal(0.5, 0.5);
  sigma ~ normal(0, 0.5);
  lambda ~ gamma(2, 0.5);
  rt ~ exp_mod_normal(mu, sigma, lambda);
}
"""


def von_mises_data(seed=0, n=SPECIAL_N):
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"N": n, "y": rng.vonmises(0.5, 4.0, n).tolist()}


def skew_normal_data(seed=0, n=SPECIAL_N):
    """y = 0.3 + 0.8 x + 0.7 z, z skew-normal of shape 3."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    delta = 3.0 / np.sqrt(1 + 3.0 ** 2)
    z = delta * np.abs(rng.normal(size=n)) + np.sqrt(1 - delta ** 2) * rng.normal(
        size=n)
    return {"N": n, "x": x.tolist(), "y": (0.3 + 0.8 * x + 0.7 * z).tolist()}


def student_t_data(seed=0, n=SPECIAL_N):
    """y = 0.3 + 0.8 x + 0.5 t, t student-t of 4 degrees of freedom."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    return {"N": n, "x": x.tolist(),
            "y": (0.3 + 0.8 * x + 0.5 * rng.standard_t(4.0, n)).tolist()}


def probit_data(seed=0, n=SPECIAL_N, k=5):
    """y ~ bernoulli(Phi(0.2 + X beta)), beta = (0.5, -1, 0.3, 0.8, -0.4)."""
    from math import erf, sqrt

    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k))
    eta = 0.2 + x @ np.array([0.5, -1.0, 0.3, 0.8, -0.4])
    p = 0.5 * (1 + np.vectorize(erf)(eta / sqrt(2)))
    return {"N": n, "K": k, "X": x.tolist(),
            "y": (rng.uniform(size=n) < p).astype(int).tolist()}


def exp_mod_normal_data(seed=0, n=SPECIAL_N):
    """Reaction times in seconds: normal(0.4, 0.05) plus exponential of rate 5."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"N": n,
            "rt": (rng.normal(0.4, 0.05, n) + rng.exponential(1 / 5.0, n))
            .tolist()}


K7R = "smcnuts_tpu/ops/nuts_pallas.py:1126"
K7F = "smcnuts_tpu/ops/nuts_pallas.py:1674"
# phase: 13, or "solvers". source and data: a program kept here (a string
# with its data recipe), else `path`. The steps of phase `solvers`' programs
# are the largest of 0.02, 0.05, 0.1 and 0.2 with an acceptance above 0.5
# at 25 x 512 x K=30 on the card (experiments/stan_step_sizes_torch.py;
# PERF.md §6), lv_rk45 taking lv_rk4's.
STAN_PROGRAMS = {
    "radon_intercepts": dict(path="examples/stan/radon_intercepts.stan", step=0.05,
                             mode="reverse", replaces=K7R, phase=13),
    "irt_ar": dict(path="examples/stan/irt_ar.stan", step=0.1, mode="forward",
                   replaces=K7F, phase=13),
    "ar1_errors_t200": dict(path=None, step=0.05, mode="forward", replaces=K7F, phase=13),
    "lv_rk45": dict(source=LV_PROGRAM.replace("{solver}", "ode_rk45(dz_dt, z_init, 0, ts, theta)"),
                    data=lv_data, step=0.02, mode=None, replaces=None, phase="solvers"),
    "lv_rk4": dict(source=LV_PROGRAM.replace(
                       "{solver}", f"ode_rk4(dz_dt, z_init, 0, ts, {LV_RK4_STEPS}, theta)"),
                   data=lv_data, step=0.02, mode="reverse", replaces=K7R, phase="solvers"),
    "von_mises": dict(source=VON_MISES, data=von_mises_data, step=0.05, mode="reverse",
                      replaces=K7R, phase="solvers"),
    "skew_normal": dict(source=SKEW_NORMAL, data=skew_normal_data, step=0.02, mode="reverse",
                        replaces=K7R, phase="solvers"),
    "student_t": dict(source=STUDENT_T, data=student_t_data, step=0.05, mode="reverse",
                      replaces=K7R, phase="solvers"),
    "probit": dict(source=PROBIT, data=probit_data, step=0.05, mode="reverse",
                   replaces=K7R, phase="solvers"),
    "exp_mod_normal": dict(source=EXP_MOD_NORMAL, data=exp_mod_normal_data, step=0.02,
                           mode="reverse", replaces=K7R, phase="solvers"),
}
STAN_PHASE13 = tuple(n for n, p in STAN_PROGRAMS.items() if p["phase"] == 13)
SPECIAL_PROGRAMS = ("von_mises", "skew_normal", "student_t", "probit", "exp_mod_normal")
STAN_EAGER_RUNS, STAN_EAGER_K = 5, 20  # the eager radon run and its kernel twin
STAN_CLI_EAGER_K = 10


def stan_source(name):
    """(source, data) of one of STAN_PROGRAMS."""
    import numpy as np

    from smcnuts_torch.stan import load_stan_data

    if "source" in STAN_PROGRAMS[name]:
        return STAN_PROGRAMS[name]["source"], STAN_PROGRAMS[name]["data"]()
    path = STAN_PROGRAMS[name]["path"]
    if path is None:
        y = np.random.default_rng(3).normal(size=200)
        return STAN_RECURRENCE, {"T": 200, "y": y.tolist()}
    with open(path) as f:
        return f.read(), load_stan_data(path[: -len(".stan")] + ".json")


def stan_generating(name, dim):
    """The values that generated each program's data, in its parameters'
    order and constrained, as the estimates are: radon's from
    examples/stan/README.md (mu_a and sigma_a not stated), irt_ar's item
    difficulties from its data file's `_b_true`, the recurrence's a = 0 and
    s = 1 (its y are iid standard normals)."""
    import numpy as np

    if name == "radon_intercepts":
        return [1.56, 0.90, 0.54, 1.29, 1.29, 0.7, None, None, 0.4]
    if name == "irt_ar":
        _, data = stan_source(name)
        b = list(np.asarray(data["_b_true"], dtype=float))
        return b + [None] * (dim - len(b))
    return [0.0, 1.0]


def stan_means_text(label, name, res, k, smi):
    """The 25-run means of the final estimates beside the generating values
    (both constrained)."""
    m = res.mean_estimate[:, k].double().mean(0).tolist()
    gen = stan_generating(name, len(m))
    shown = min(len(m), 12)
    pairs = [f"{m[i]:.3f}" + (f" ({gen[i]:.3f})" if gen[i] is not None else "")
             for i in range(shown)]
    more = "" if shown == len(m) else f", ... ({len(m) - shown} more)"
    print(f"{label}: {RUNS}-run mean of the final estimates (generating value): "
          f"{', '.join(pairs)}{more} ({smi})")


def stan_prepare(smi):
    """Phase 13 (a), run before phase 2: the three programs parsed,
    interpreted (the eager model) and traced (tile=True) on the card's
    machine, then one nvcc each started in the background, so that the
    builds (irt_ar's takes about a minute) run beside phase 2's and later
    phases, not inside phase 13. Returns what stan_phase takes."""
    from concurrent.futures import ThreadPoolExecutor

    from smcnuts_torch.models.base import CallableModel
    from smcnuts_torch.ops.generated import build_generated, straight_line
    from smcnuts_torch.stan import compile_stan_program, parse

    phase("13 (a). Stan programs: parse, interpret, trace; their nvcc started in the "
          "background")
    started = time.perf_counter()
    dev = torch.device("cuda")
    models, eager_models = {}, {}
    for name in STAN_PHASE13:
        src, data = stan_source(name)
        t0 = time.perf_counter()
        parse(src)
        t1 = time.perf_counter()
        eager_models[name] = compile_stan_program(src, data, name=name).to(dev)
        t2 = time.perf_counter()
        models[name] = compile_stan_program(src, data, name=name, tile=True).to(dev)
        t3 = time.perf_counter()
        tm = models[name].tile_model
        if tm.autodiff != STAN_PROGRAMS[name]["mode"]:
            raise AssertionError(f"(a) {name}: tile_autodiff='auto' chose {tm.autodiff}")
        print(f"(a) {name}: D = {tm.dim}, {tm.autodiff} mode, {tm.n_ops} operations a "
              f"leapfrog, {tm.data.numel()} data floats; parse {t1 - t0:.3f} s, "
              f"interpret (the eager model) {t2 - t1:.3f} s, interpret and trace "
              f"(tile=True) {t3 - t2:.1f} s (host clock; {smi})")
    # Each forward program's recurrences are loops; its witness, the same
    # program straight-line, is a library of its own (irt_ar's nvcc takes
    # about a minute).
    witnesses = {}
    for name, m in models.items():
        if m.tile_model.autodiff == "forward":
            require_rerolled(f"(a) {name}", m.tile_model)
            witnesses[name] = CallableModel(
                m.name, m.dim, m._logprior, m._loglik, m._constrain,
                tile_model=straight_line(m.tile_model)).to(dev)
    pool = ThreadPoolExecutor(len(models) + len(witnesses))
    builds = {name: pool.submit(build_generated, m.tile_model) for name, m in models.items()}
    witness_builds = {name: pool.submit(build_generated, w.tile_model)
                      for name, w in witnesses.items()}
    return dict(models=models, eager_models=eager_models, builds=builds, pool=pool,
                witnesses=witnesses, witness_builds=witness_builds,
                seconds=time.perf_counter() - started, started=time.perf_counter())


def stan_phase(smi, prep):
    """Phase 13: Stan programs compiled by the port's frontend (`prep`, from
    stan_prepare), through the generated NUTS kernels (K7r, K7f). Returns
    the kernels-line rows."""
    from smcnuts_torch import SMCConfig, run_smc_batched
    from smcnuts_torch.models.base import CallableModel
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer, device_ms, median_ms

    phase("13. Stan programs on the card (K7r, K7f through the port's frontend)")
    started = time.perf_counter()
    dev = torch.device("cuda")
    models, eager_models, builds = prep["models"], prep["eager_models"], prep["builds"]
    pool = prep["pool"]

    rows, launches = {}, {name: 0 for name in models}
    finals, witness_rows = {}, {}
    # (c) bench.py's shape: 25 runs x 512 x K=100, forwards, depth 10.
    for name in sorted(models, key=lambda n: models[n].tile_model.n_ops):
        m = models[name]
        lib = builds[name].result()
        print(f"(a) {name}: nvcc {lib.build_seconds:.1f} s (the three started at once, "
              f"{time.perf_counter() - prep['started']:.1f} s before it is read here; {smi})")
        generated_build(f"(a) {name}", m)
        cfg = SMCConfig(n_particles=N, n_iterations=K, step_size=STAN_PROGRAMS[name]["step"],
                        max_tree_depth=MAX_DEPTH)
        label = f"(c) {name}, forwards, step {cfg.step_size}"
        res, n_launch, _ = strategy_run(label, "generated", m, cfg, smi)
        launches[name] += n_launch
        stan_means_text(label, name, res, K, smi)
        finals[name] = res.x_final.contiguous()
    pool.shutdown()

    # (b) Each kernel against its plain version at 25 x 512 x depth 10, on
    # the posterior cloud (c) ended with, zero bits and Philox: to the bit.
    for name, m in models.items():
        x, step = finals[name], STAN_PROGRAMS[name]["step"]
        seeds = torch.arange(RUNS, dtype=torch.int32, device=dev)
        ones = torch.ones(x.shape[-1], device=dev)
        worst = 0.0
        for source in (ZERO_BITS, PHILOX):
            args = (x, seeds, step, 1.0, ones, MAX_DEPTH, source)
            out_k = nuts_tree(m, *args)
            with CudaTimer() as t:
                out_p = nuts_tree_plain(m, *args)
            worst = max(worst, check_outputs(f"(b) {name} [{source}] kernel vs plain",
                                             out_k, out_p, nan_lanes=True, bitwise=True))
            print(f"(b) {name} [{source}]: kernel and plain version equal to the bit; "
                  f"plain {t.ms:.1f} ms")
        call = lambda: nuts_tree(m, *args)  # noqa: E731 (Philox, the last args)
        ms = device_ms(call, repeats=DEVICE_REPEATS)
        host_ms = median_ms(call, repeats=5)
        bound = tree_roofline("generated", out_k, model=m.tile_model)
        print(f"(b) time {name}, {RUNS} x {N} x depth {MAX_DEPTH} [philox]: {ms:.4f} ms "
              f"(device alone, {DEVICE_REPEATS} launches back to back; a call timed "
              f"alone {host_ms:.4f} ms); plain {t.ms:.1f} ms; {bound_text(bound)} "
              f"({m.tile_model.n_ops} operations x {float(out_k[2]['leapfrogs'].sum()):.0f} "
              f"leapfrogs; {smi})")
        rows[name] = {"max_abs_err": worst, "ms": ms, "host_call_ms": host_ms,
                      "plain_ms": t.ms, **bound}
        if name in prep["witnesses"]:
            rows[name], witness_rows[name] = stan_witness(
                name, m, prep["witnesses"][name], prep["witness_builds"][name], x, step,
                rows[name], smi)

    # (d) radon eager by autograd on the card, beside its kernel run at the
    # same shape: the means within 4 MC standard errors.
    name = "radon_intercepts"
    cfg = SMCConfig(n_particles=N, n_iterations=STAN_EAGER_K,
                    step_size=STAN_PROGRAMS[name]["step"], max_tree_depth=MAX_DEPTH)
    seeds = SEEDS[:STAN_EAGER_RUNS]
    walls, res = {}, {}
    for who, m in (("eager", eager_models[name]), ("kernel", models[name])):
        reset_counts()
        with CudaTimer() as t:
            res[who] = run_smc_batched(m, cfg, seeds, "cuda")
            res[who].mean_estimate[:, -1].cpu()
        walls[who] = t.ms
        counts, plain_calls = read_counts()
        want = (0, STAN_EAGER_K) if who == "eager" else (STAN_EAGER_K, 0)
        if (sum(counts.values()), plain_calls) != want:
            raise AssertionError(f"(d) {name} {who}: {counts} launches, {plain_calls} "
                                 f"plain calls; expected {want}")
        check_series(f"(d) {name} {who}", res[who], STAN_EAGER_K)
        if who == "kernel":
            launches[name] += STAN_EAGER_K
    me, mk = (res[w].mean_estimate[:, STAN_EAGER_K].double() for w in ("eager", "kernel"))
    se = (me.var(0) / len(seeds) + mk.var(0) / len(seeds)).sqrt() + 1e-12
    z = ((me.mean(0) - mk.mean(0)).abs() / se)
    print(f"(d) {name} {len(seeds)} x {N} x K={STAN_EAGER_K}: eager (autograd, no kernel) "
          f"{walls['eager']:.1f} ms, kernel {walls['kernel']:.1f} ms (CUDA events); "
          f"|eager mean - kernel mean| / MC se {[round(float(v), 3) for v in z]} ({smi})")
    if not bool((z <= 4.0).all()):
        raise AssertionError(f"(d) {name}: the eager means are more than 4 MC standard "
                             f"errors from the kernel run's")
    # A logp_and_grad call of each eager model at 512 particles: interpreted
    # (CallableModel's, autograd of the interpretation) and, for radon, the
    # StanModel's replayed graph, equal to it to the bit.
    for prog, m in eager_models.items():
        xx = finals[prog][0].clone()
        phi = torch.full((N,), 1.0, device=dev)
        interpreted = median_ms(lambda: CallableModel.logp_and_grad(m, xx, phi), repeats=3)
        text = f"{interpreted:.3f} ms interpreted"
        if prog == name:
            def same(a, b):
                return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

            want = CallableModel.logp_and_grad(m, xx, phi)
            if not same(CallableModel.logp_and_grad(m, xx, phi), want):
                raise AssertionError(f"(d) {prog}: two interpretations differ (an op "
                                     f"that adds with atomics?)")
            if not same(m.logp_and_grad(xx, phi), want):
                raise AssertionError(f"(d) {prog}: the replayed graph differs from the "
                                     f"interpretation")
            replayed = median_ms(lambda: m.logp_and_grad(xx, phi), repeats=5)
            text += (f", {replayed:.3f} ms replayed (its graph, {len(m._graphs)} traced, "
                     f"equal to the interpretation to the bit)")
        print(f"(d) {prog}: a logp_and_grad call of the eager model at {N} particles: "
              f"{text} (CUDA events, median of 3 and 5; {smi})")

    # (e) The CLI, with --stan-tile at K=100 (the kernel) and without it at
    # K=10 (eager), through its main(), at (c)'s step: the particles must
    # move (acceptance above 0, from the --output file) and the weights
    # differ (final ESS below N).
    import tempfile

    import numpy as np

    base = ["--stan", STAN_PROGRAMS[name]["path"], "--data",
            STAN_PROGRAMS[name]["path"][: -len(".stan")] + ".json", "-N", str(N),
            "--step-size", str(STAN_PROGRAMS[name]["step"])]
    keys = {"model", "lkernel", "N", "K", "mean", "variance", "ess", "log_likelihood",
            "phi_schedule"}
    for argv, k, kernel in ((base + ["--stan-tile", "-K", str(K)], K, True),
                            (base + ["-K", str(STAN_CLI_EAGER_K)], STAN_CLI_EAGER_K, False)):
        reset_counts()
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "diagnostics.npz")
            t0 = time.perf_counter()
            summary = quiet_cli(argv + ["--device", "cuda", "--output", out])
            wall = time.perf_counter() - t0
            acceptance = float(np.load(out)["acceptance_rate"][:k].mean())
        counts, plain_calls = read_counts()
        want = (k, 0) if kernel else (0, k)
        if set(summary) != keys or (sum(counts.values()), plain_calls) != want:
            raise AssertionError(f"(e) {' '.join(argv)}: keys {sorted(summary)}, "
                                 f"{counts} launches, {plain_calls} plain calls")
        if not all(math.isfinite(v) for v in summary["mean"] + summary["variance"]):
            raise AssertionError(f"(e) {' '.join(argv)}: estimates not finite")
        if not (summary["ess"] < N and acceptance > 0.0):
            raise AssertionError(f"(e) {' '.join(argv)}: final ESS {summary['ess']} "
                                 f"(must be below N = {N}), acceptance {acceptance} "
                                 f"(must be above 0): the particles did not move")
        if kernel:
            launches[name] += k
        print(f"(e) python -m smcnuts_torch {' '.join(argv)}: the JAX CLI's keys, "
              f"{counts['generated']} kernel launches, {plain_calls} plain calls, "
              f"{wall:.1f} s (host clock, the trace included), model "
              f"{summary['model']}, acceptance {acceptance:.3f}, final ESS "
              f"{summary['ess']:.1f} ({smi})")
    for n in rows:
        rows[n]["launches"] = launches[n]
    print(f"phase 13 took {time.perf_counter() - started:.1f} s, and (a) before phase 2 "
          f"{prep['seconds']:.1f} s (host clock; the budget of both is 150 s; {smi})")
    return rows, witness_rows


def stan_witness(name, model, witness, build, x, step, row, smi):
    """Phase 13 (b) for a forward program: its straight-line witness (the
    same program, every op straight-line; its own library) equal to the
    re-rolled kernel, which (b) held to their one plain version, to the bit
    under zero bits and Philox at 25 x 512 x depth 10, both timed in turns (the
    device alone, median of VARIANT_ROUNDS), with ptxas's lines and SASS
    counts. Returns the re-rolled row with its time in turns, and the
    witness's row (a measurement entry)."""
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree
    from smcnuts_torch.utils.timing import median_ms

    lib = build.result()
    print(f"(b) {name}, straight-line (the witness): nvcc {lib.build_seconds:.1f} s (started "
          f"in (a) with the others; {smi})")
    generated_build(f"(b) {name}, straight-line (the witness)", witness)
    if witness.tile_model.program.ops != model.tile_model.program.ops:
        raise AssertionError(f"(b) {name}: the witness is another program")
    dev = x.device
    seeds = torch.arange(RUNS, dtype=torch.int32, device=dev)
    ones = torch.ones(x.shape[-1], device=dev)
    for source in (ZERO_BITS, PHILOX):
        args = (x, seeds, step, 1.0, ones, MAX_DEPTH, source)
        out_w = nuts_tree(witness, *args)
        diff = bitwise_differences(out_w, nuts_tree(model, *args))
        if diff:
            raise AssertionError(f"(b) {name} witness [{source}]: differs from the "
                                 f"re-rolled kernel in {diff}")
        print(f"(b) {name} witness [{source}]: equal to the re-rolled kernel to the bit")
    calls = {"re-rolled": lambda: nuts_tree(model, *args),
             "straight-line": lambda: nuts_tree(witness, *args)}
    rounds, med = timed_in_turns(calls)
    for k in calls:
        print(f"(b) time {name} {k}, {RUNS} x {N} x depth {MAX_DEPTH} [philox]: "
              f"{med[k]:.4f} ms, {med['straight-line'] / med[k]:.3f}x the witness's speed "
              f"(device alone, {DEVICE_REPEATS} launches back to back; median of "
              f"{VARIANT_ROUNDS} in turns: {', '.join(f'{v:.4f}' for v in rounds[k])}; {smi})")
    bound = tree_roofline("generated", out_w, model=witness.tile_model)
    witness_row = {"launches": 0, "measurement_entry": True, "max_abs_err": 0.0,
                   "ms": med["straight-line"],
                   "host_call_ms": median_ms(calls["straight-line"], repeats=5),
                   "plain_ms": row["plain_ms"], **bound}
    return {**row, "ms": med["re-rolled"]}, witness_row


# ---- phase `solvers`: float64 runs on the card (the eager backend), the
# Stan frontend's ODE solvers, and the special functions of the generated
# lowering (K7r).

# arma in float64 on the eager tree: tests/test_float64.py:30's 256
# particles, 5 runs, reduced from its K=20 to K=10 and to depth 5 (the eager
# tree with the plain ARMA model took 3.4 s an iteration at 25 x 512, depth
# 10, on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
F64_RUNS, F64_N, F64_K, F64_DEPTH = 5, 256, 10, 5
# lv_rk45 on the eager backend in float64 through the ODE kernel
# (csrc/ode_dopri5.cuh, one launch a solve and one an adjoint): the main
# path's 25 x 512 at depth 10, started around the data's generating values,
# K cut from 100 to LV_K: the eager tree's ~286 replayed model calls an
# iteration, not the solve, set its wall (K=20: 45.8 and 68.0 s on two hosts,
# the whole script 1,142 s of its 1,200; K=10: 34.4-54.2 s; with phase
# tile_programs, whose lv_rk45 run through K7r takes the same K, K=5 keeps
# the script near 1,100 s; PERF.md). The kernel is held to its
# plain version at LV_CHECK_N lanes and timed at LV_BLOCK, the eager tree's
# block (SMCConfig.eager_block_size); a logp_and_grad call is timed at
# LV_TIMED_N particles, kernel route and host loop side by side.
LV_K, LV_CHECK_N, LV_TIMED_N, LV_BLOCK = 5, 64, 256, 4096
# (c) lv_rk4's iterations, cut from 100 with phase tile_programs (its K=100
# run and two single runs took 35.6 s of phase solvers; PERF.md).
LV_RK4_K = 50
SPECIAL_K = 10  # the short main-path run of each special-function program
# The float32 inputs each libdevice call is swept over, every one of them:
# the ranges the densities use.
LIBDEVICE_RANGES = {"cos": (-50.0, 50.0), "sin": (-50.0, 50.0), "erf": (-10.0, 10.0),
                    "erfc": (-10.0, 10.0), "lgamma": (0.0, 1e4), "tan": (-10.0, 10.0),
                    "atan": (-100.0, 100.0), "asin": (-1.0, 1.0), "acos": (-1.0, 1.0),
                    "sinh": (-20.0, 20.0), "cosh": (-20.0, 20.0)}
SOLVER_TILE = ("lv_rk4",) + SPECIAL_PROGRAMS
# The spread of the special programs' clouds around their generating values
# (unconstrained): probit's eta stays within float32's Phi < 1.
SPECIAL_SPREAD = {"probit": 0.1}
SPECIAL_TRUTH = {
    "von_mises": (0.5, math.log(4.0)),
    "skew_normal": (0.3, 0.8, math.log(0.7), 3.0),
    "student_t": (0.3, 0.8, math.log(0.5), math.log(3.0)),
    "probit": (0.2, 0.5, -1.0, 0.3, 0.8, -0.4),
    "exp_mod_normal": (0.4, math.log(0.05), math.log(5.0)),
}


def trace_program(name):
    """In a worker process: compile STAN_PROGRAMS[name] with tile=True on the
    CPU; returns (its generated program, mode, seconds)."""
    from smcnuts_torch.stan import compile_stan_program

    torch.set_num_threads(1)
    src, data = stan_source(name)
    t0 = time.perf_counter()
    tm = compile_stan_program(src, data, name=name, tile=True).tile_model
    return tm.program, tm.autodiff, time.perf_counter() - t0


def start_builds(names, trace, workers, smi):
    """Each program of `names` traced by `trace` (tile=True on the CPU) in
    worker processes, `workers` at once, and its library's nvcc started in
    a thread as its trace ends, so that both run beside the later phases.
    Returns what the phase that reads them takes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from smcnuts_torch.ops.generated import GeneratedModel, build_generated

    started = time.perf_counter()
    procs = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    traces = {name: procs.submit(trace, name) for name in names}

    def build(name):
        program, mode, seconds = traces[name].result()
        gm = GeneratedModel(program, mode, name)
        return gm, seconds, build_generated(gm)

    threads = ThreadPoolExecutor(len(names))
    builds = {name: threads.submit(build, name) for name in names}
    print(f"(a) {len(names)} traces and builds started ({smi})")
    return dict(builds=builds, procs=procs, threads=threads, started=started)


def solvers_prepare(smi):
    """Phase `solvers` (a), run after phase 2b (phase 2's build keeps its
    minute): lv_rk4 and the five special programs traced and built in the
    background (`start_builds`), three at once: the card's machine has 8
    cores, and the phases that run beside them time their host."""
    phase("solvers (a). lv_rk4 and the special-function programs: traced in processes, "
          "their nvcc started in the background")
    return start_builds(SOLVER_TILE, trace_program, 3, smi)


def solver_model(name, gm=None):
    """STAN_PROGRAMS[name] compiled on the card, eager, with the generated
    model gm (traced in solvers_prepare) attached."""
    from smcnuts_torch.stan import compile_stan_program

    src, data = stan_source(name)
    m = compile_stan_program(src, data, name=name)
    if gm is not None:
        m.tile_model = gm
    return m.to(torch.device("cuda"))


def float64_eager_phase(smi):
    """(a) arma in float64 on the card through the eager tree ("auto"), with
    and without tempering, beside the float32 kernel run of the same
    configuration: float64 throughout, no NUTS kernel and no K5 launch,
    finite series, the float32 moments inside the float64 runs' Monte Carlo
    spread (tests/test_float64.py's bound); the float64 draws on the card
    equal the CPU's."""
    import dataclasses

    from smcnuts_torch import SMCConfig, run_smc_batched
    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.arma_fused import arma_ll_vg
    from smcnuts_torch.ops.draws import LEAF, PHILOX, TreeDraws
    from smcnuts_torch.ops.nuts_cuda import nuts_tree
    from smcnuts_torch.utils.timing import CudaTimer

    seeds = [7 * (i + 1) for i in range(F64_RUNS)]
    for tempering in (False, True):
        cfg = SMCConfig(n_particles=F64_N, n_iterations=F64_K, step_size=STEP,
                        max_tree_depth=F64_DEPTH, dtype="float64", tempering=tempering,
                        save_history=False)
        label = f"(a) arma float64, {F64_RUNS} x {F64_N} x K={F64_K}, depth {F64_DEPTH}, " + (
            "tempered" if tempering else "forwards")
        res = {}
        for dtype in ("float64", "float32"):
            reset_counts()
            with CudaTimer() as t:
                res[dtype] = run_smc_batched(get_model("arma"),
                                             dataclasses.replace(cfg, dtype=dtype), seeds, "cuda")
                res[dtype].mean_estimate[:, -1].cpu()
            check_series(f"{label} [{dtype}]", res[dtype], F64_K)
            want = 0 if dtype == "float64" else F64_K
            if nuts_tree.launches != want or arma_ll_vg.launches != 0:
                raise AssertionError(f"{label} [{dtype}]: {nuts_tree.launches} NUTS kernel "
                                     f"launches (expected {want}), {arma_ll_vg.launches} K5")
            print(f"{label} [{dtype}]: wall {t.ms:.1f} ms (CUDA events), NUTS kernel "
                  f"launches {nuts_tree.launches}, K5 launches {arma_ll_vg.launches} ({smi})")
        wrong = [f for f, v in res["float64"]._asdict().items()
                 if v is not None and v.is_floating_point() and v.dtype != torch.float64]
        if wrong:
            raise AssertionError(f"{label}: not float64: {wrong}")
        m32, m64 = (res[d].mean_estimate[:, -1].double().cpu() for d in ("float32", "float64"))
        v32, v64 = (res[d].variance_estimate[:, -1].double().cpu()
                    for d in ("float32", "float64"))
        se = (m32.var(0) / F64_RUNS + m64.var(0) / F64_RUNS).sqrt()
        vse = (v32.var(0) / F64_RUNS + v64.var(0) / F64_RUNS).sqrt()
        delta, vdelta = (m32.mean(0) - m64.mean(0)).abs(), (v32.mean(0) - v64.mean(0)).abs()
        if not (bool((delta <= 4 * se + 1e-3).all())
                and bool((vdelta <= 4 * vse + 0.05 * v64.mean(0).abs() + 1e-3).all())):
            raise AssertionError(f"{label}: the float32 moments lie outside the float64 "
                                 f"runs' spread: {delta.tolist()} against {se.tolist()}")
        print(f"{label}: |float32 mean - float64 mean| {[round(float(v), 5) for v in delta]}, "
              f"MC standard error {[round(float(v), 5) for v in se]}: inside 4 of them + 1e-3")
    seed = torch.tensor([11, 12])
    run, particle = torch.tensor([0, 0, 1, 1]), torch.tensor([0, 5, 2, 7])
    draws = [TreeDraws(PHILOX, seed.to(d), run.to(d), particle.to(d), torch.float64)
             .uniforms(LEAF, range(64), 0).cpu() for d in ("cpu", "cuda")]
    if not torch.equal(*draws):
        raise AssertionError("(a) the float64 draws on the card differ from the CPU's")
    print("(a) the float64 draws on the card equal the CPU's, bit for bit")


def lv_ode_inputs(m, x):
    """The ODE solve's inputs of lv_rk45 at unconstrained particles x (P,
    8): y0 = z_init (P, 2), the arguments theta (P, 4) and the times (P,
    21), as the program hands them to the solver."""
    c = m.constrain(x)
    ts = torch.tensor([0.0] + lv_data()["ts"], dtype=x.dtype, device=x.device)
    return (c[:, 4:6].contiguous(), ts.expand(x.shape[0], ts.numel()).contiguous(),
            c[:, :4].contiguous())


def ode_row(label, kernel, plain, prog, inputs, adjoint, smi):
    """The kernels-line row of the ODE solve or its adjoint: the kernel
    against its plain version to the bit on `inputs` (every output and each
    lane's steps), then both timed there, and the bound: this call's steps
    times the operations of a step (`OdeProgram.step_ops`) over the data
    sheet's FP64 rate."""
    from smcnuts_torch.utils.timing import CudaTimer

    out_k, steps_k = kernel(prog, *inputs)
    with CudaTimer() as t:
        out_p, steps_p = plain(prog, *inputs)
    plain_ms = t.ms
    out_k = out_k if adjoint else (out_k,)
    out_p = out_p if adjoint else (out_p,)
    def same_bits(u, v):
        return u.shape == v.shape and torch.equal(u.contiguous().view(torch.uint8),
                                                  v.contiguous().view(torch.uint8))

    if not (all(same_bits(u, v) for u, v in zip(out_k, out_p))
            and torch.equal(steps_k, steps_p)):
        raise AssertionError(f"{label}: the kernel differs from its plain version")
    times = kernel_times(lambda: kernel(prog, *inputs))
    lanes, steps = int(steps_k.numel()), int(steps_k.sum())
    ops = steps * prog.step_ops(adjoint)
    bound = 1e3 * ops / PEAK_FP64
    print(f"{label}, {lanes} lanes: equal to its plain version to the bit (every output, each "
          f"lane's steps: mean {steps / lanes:.1f}, {int(steps_k.min())}-{int(steps_k.max())}); "
          f"{times_text(times)}; plain {plain_ms:.1f} ms (its host loop); bound "
          f"{bound:.5f} ms by operations ({steps} steps x {prog.step_ops(adjoint)} FP64 "
          f"operations over {PEAK_FP64 / 1e12:.0f} TFLOP/s; {smi})")
    return {"max_abs_err": 0.0, **times, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations"}


def lv_rk45_phase(smi):
    """(b) lv_rk45 (the adaptive solver and its adjoint) in float64 through
    the ODE kernel: its call site takes the kernel route; a run at 25 x 512 x
    K=LV_K, depth 10 (the eager tree), counts set to 0 just before it: finite
    series, both kernels launched, no NUTS kernel; the kernel and its
    adjoint's held to their plain version to the bit at LV_CHECK_N lanes and
    timed at LV_BLOCK lanes of the run's final population; a logp_and_grad
    call at LV_TIMED_N particles timed on the kernel route (replayed) and on
    the host loop (interpreted, as before the kernel), the two and the CPU's
    float64 values equal at rtol 1e-10. Returns
    the kernels-line rows of the solve and its adjoint."""
    from smcnuts_torch import DiagNormalProposal, SMCConfig, run_smc_batched
    from smcnuts_torch.models.base import CallableModel
    from smcnuts_torch.ops import ode
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer

    name = "lv_rk45"
    m = solver_model(name)
    if list(m.ode_routes.values()) != [{"float32": ode.KERNEL, "float64": ode.KERNEL}]:
        raise AssertionError(f"(b) lv_rk45 must take the kernel route: {m.ode_routes}")
    cfg = SMCConfig(n_particles=N, n_iterations=LV_K, step_size=STAN_PROGRAMS[name]["step"],
                    max_tree_depth=MAX_DEPTH, dtype="float64")
    # The initial particles around the data's generating values: the
    # default proposal, N(0, I) on the unconstrained scale, puts beta and
    # delta at ~1 (their prior's mean is 0.05), where the system is stiff
    # and a solve takes thousands of steps.
    start = DiagNormalProposal(8, mean=tuple(math.log(v) for v in LV_TRUTH),
                               var=(0.01,) * 8)
    reset_counts()
    ode.solve_batched.steps = 0
    with CudaTimer() as t:
        res = run_smc_batched(m, cfg, SEEDS, "cuda", sample_proposal=start)
        res.mean_estimate[:, -1].cpu()
    launches = {"ode_dopri5": ode.dopri5.launches,
                "ode_dopri5_adjoint": ode.dopri5_adjoint.launches}
    calls, wall_s, run_steps = nuts_tree_plain.model_calls, t.ms / 1e3, ode.solve_batched.steps
    check_series("(b) lv_rk45", res, LV_K)
    LV_EAGER.update(res=res, wall_s=wall_s)
    if nuts_tree.launches != 0 or res.x_final.dtype != torch.float64 or min(launches.values()) < 1:
        raise AssertionError(f"(b) lv_rk45: {nuts_tree.launches} NUTS kernel launches, "
                             f"{res.x_final.dtype}, ODE kernel launches {launches}")
    print(f"(b) lv_rk45 float64 through the ODE kernel, {RUNS} x {N} x K={LV_K}, depth "
          f"{MAX_DEPTH}, step {cfg.step_size}, started around the generating values: wall "
          f"{wall_s:.1f} s (CUDA events), ODE kernel launches {launches}, no NUTS kernel "
          f"launch, {calls} model calls in the trees ({calls / LV_K:.1f} an iteration), "
          f"{run_steps} RK steps ({run_steps / (RUNS * N * LV_K):.1f} a particle-iteration), "
          f"mean tree depth {float(res.tree_depth[:, :-1].mean()):.2f}, acceptance "
          f"{float(res.acceptance_rate[:, :-1].mean()):.3f}, final means of run 0 "
          f"{[round(float(v), 4) for v in res.mean_estimate[0, -1]]} ({smi})")

    # The kernel against its plain version: the solver's inputs at
    # LV_CHECK_N particles near the generating values, then timed at an
    # eager block of the run's final population.
    site, = m._ode_sites.values()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = (torch.tensor(LV_TRUTH, dtype=torch.float64, device="cuda").log()
         + 0.05 * torch.randn(LV_TIMED_N, 8, generator=gen, device="cuda",
                              dtype=torch.float64))
    rows = {}
    for n_lanes, cloud, what in ((LV_CHECK_N, x[:LV_CHECK_N], "near the generating values"),
                                 (LV_BLOCK, res.x_final.reshape(-1, 8)[:LV_BLOCK],
                                  "of the run's final population")):
        y0, ts, a = lv_ode_inputs(m, cloud)
        prog = site.program(y0, [a])
        ys, _ = ode.dopri5(prog, y0, ts, a)
        g = torch.randn(ys.shape, generator=gen, device="cuda", dtype=torch.float64)
        for key, kernel, plain, inputs, adjoint in (
                ("ode_dopri5", ode.dopri5, ode.dopri5_plain, (y0, ts, a), False),
                ("ode_dopri5_adjoint", ode.dopri5_adjoint, ode.dopri5_adjoint_plain,
                 (ys, ts, g, a), True)):
            row = ode_row(f"(b) {key} {what}", kernel, plain, prog, inputs, adjoint, smi)
            if n_lanes == LV_BLOCK:
                rows[key] = {**row, "launches": launches[key]}
    for line in ptxas_lines(ode.build_ode(prog).log):
        print("  ptxas:", line)

    # A logp_and_grad call at LV_TIMED_N particles: the kernel route, replayed
    # (timed at its second call), beside the host loop as it ran before the
    # kernel: a second compile of the program, its call site routed to the
    # host loop, interpreted.
    host = solver_model(name)
    for other in host._ode_sites.values():
        other.routes[torch.float64] = "host loop: the witness of chip_smoke.py (b)"
    phi = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    timed = {}
    m.logp_and_grad(x, phi)
    for label, call in (("kernel", lambda: m.logp_and_grad(x, phi)),
                        ("host loop", lambda: CallableModel.logp_and_grad(host, x, phi))):
        ode.solve_batched.steps = 0
        with CudaTimer() as t:
            out = call()
        timed[label] = (t.ms, ode.solve_batched.steps / x.shape[0], out)
    m_cpu = solver_model(name).to("cpu")
    lp_c, g_c = m_cpu.logp_and_grad(x[:LV_CHECK_N].cpu(), phi[:LV_CHECK_N].cpu())
    for label, (_, _, (lp, gr)) in timed.items():
        if not (torch.allclose(lp[:LV_CHECK_N].cpu(), lp_c, rtol=1e-10, atol=0)
                and torch.allclose(gr[:LV_CHECK_N].cpu(), g_c, rtol=1e-10, atol=1e-12)):
            raise AssertionError(f"(b) lv_rk45 {label}: the card's logp and gradient differ "
                                 f"from the CPU's beyond rtol 1e-10: "
                                 f"{float((lp[:LV_CHECK_N].cpu() - lp_c).abs().max())}")
    print(f"(b) lv_rk45: a logp_and_grad call at {x.shape[0]} particles around the data's "
          f"generating values: kernel route (replayed) {timed['kernel'][0]:.2f} ms, host loop "
          f"(interpreted) {timed['host loop'][0]:.2f} ms (CUDA events); {timed['kernel'][1]:.1f} and "
          f"{timed['host loop'][1]:.1f} RK steps a particle (the solve and its adjoint's 20 "
          f"intervals, accepted and rejected); at {LV_CHECK_N} of them both equal the CPU's "
          f"float64 values at rtol 1e-10 ({smi})")
    return rows


def special_cloud(name, dev):
    """RUNS x N points around a special program's generating values."""
    g = torch.Generator(device=dev).manual_seed(5)
    truth = torch.tensor(SPECIAL_TRUTH[name], device=dev)
    noise = torch.randn((RUNS, N, truth.numel()), generator=g, device=dev)
    return (truth + SPECIAL_SPREAD.get(name, 0.3) * noise).contiguous()


def solver_kernel_case(label, name, m, x, smi):
    """A generated program's kernel against its plain version on x (RUNS x
    N) at depth MAX_DEPTH, zero bits and Philox, to the bit; the plain
    program replayed as a CUDA graph (`GeneratedModel._replay`) equal to
    the program run op by op; the kernel's device time and the plain
    version's at that shape, and the kernel's bound. Returns its row of the
    kernels line (launches added later)."""
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer

    step = STAN_PROGRAMS[name]["step"]
    ones = torch.ones(x.shape[-1], device=x.device)
    seeds = torch.arange(RUNS, dtype=torch.int32, device=x.device)
    worst, plain_ms = 0.0, {}
    for source in (ZERO_BITS, PHILOX):
        args = (x, seeds, step, 1.0, ones, MAX_DEPTH, source)
        out_k = nuts_tree(m, *args)
        with CudaTimer() as t:
            out_p = nuts_tree_plain(m, *args)
        plain_ms[source] = t.ms
        worst = max(worst, check_outputs(
            f"{label} [{source}] kernel vs plain, {RUNS} x {N} x depth {MAX_DEPTH}, plain "
            f"{t.ms:.1f} ms", out_k, out_p, nan_lanes=True, bitwise=True))
    gm, flat = m.tile_model, x.reshape(-1, x.shape[-1])
    phi = torch.full((flat.shape[0],), 0.5, device=x.device)
    gm.logp_and_grad(flat, phi)  # op by op if the lane count is new
    replayed = gm.logp_and_grad(flat, phi)
    if not all(torch.equal(u.view(torch.int32), v.view(torch.int32))
               for u, v in zip(replayed, gm.graph(flat, phi))):
        raise AssertionError(f"{label}: the plain program replayed as a CUDA graph differs "
                             f"from the program run op by op")
    times = kernel_times(lambda: nuts_tree(m, *args))
    bound = tree_roofline("generated", nuts_tree(m, *args), model=m.tile_model)
    print(f"{label} time, {RUNS} x {N} x depth {MAX_DEPTH}, step {step} [philox]: "
          f"{times_text(times)}; plain {plain_ms[PHILOX]:.1f} ms (its program replayed as a "
          f"CUDA graph, equal to the program op by op); {bound_text(bound)} "
          f"({m.tile_model.n_ops} operations x the kernel's leapfrogs; {smi})")
    return {"max_abs_err": worst, **times, "plain_ms": plain_ms[PHILOX], **bound}


def float32_patterns(lo, hi):
    """The bit patterns, as int64 ranges (first, last), of every float32 in
    [lo, hi] (lo <= 0 <= hi): +0 up to hi, and -0 down to lo."""
    def bits(v):
        return int(torch.tensor([v], dtype=torch.float32).view(torch.int32).item())

    parts = [(0, bits(hi))]
    if lo < 0.0:
        parts.append((1 << 31, (1 << 31) + bits(-lo)))
    return parts


def libdevice_phase(smi):
    """(d) the libdevice calls the generated models emit for cos, sin, erf,
    erfc and lgamma (`ops.generated.libdevice_unary`, csrc/libdevice_sweep.cu)
    against ATen's CUDA op on every float32 of LIBDEVICE_RANGES, to the bit;
    then timed at 2^26 inputs beside torch's op, the plain version and the
    library call at once. Returns its row, a measurement entry."""
    from smcnuts_torch.ops.generated import libdevice_unary
    from smcnuts_torch.utils.timing import device_ms

    dev = torch.device("cuda")
    chunk = 1 << 27
    for op, (lo, hi) in LIBDEVICE_RANGES.items():
        fn, count = getattr(torch, op), 0
        for first, last in float32_patterns(lo, hi):
            for start in range(first, last + 1, chunk):
                bits = torch.arange(start, min(start + chunk, last + 1), device=dev,
                                    dtype=torch.int64)
                x = bits.to(torch.int32).view(torch.float32)
                got, want = libdevice_unary(op, x).view(torch.int32), fn(x).view(torch.int32)
                if not torch.equal(got, want):
                    raise AssertionError(f"(d) libdevice {op}: {int((got != want).sum())} "
                                         f"inputs differ from torch.{op} on the card")
                count += x.numel()
        print(f"(d) libdevice {op}: equal to torch.{op} on the card on every float32 in "
              f"[{lo}, {hi}], {count} values ({smi})")
    x = torch.linspace(-50.0, 50.0, 1 << 26, device=dev)
    times = kernel_times(lambda: libdevice_unary("cos", x))
    torch_ms = device_ms(lambda: torch.cos(x), repeats=DEVICE_REPEATS)
    bound = roofline(0.0, 8.0 * x.numel())
    print(f"time libdevice cos, {x.numel()} values: {times_text(times)}, torch.cos "
          f"{torch_ms:.4f} ms (device alone); {bound_text(bound)} (its bytes; {smi})")
    return {"launches": 0, "measurement_entry": True, "max_abs_err": 0.0, **times,
            "plain_ms": torch_ms, "library_ms": torch_ms, **bound}


def solvers_phase(smi, prep):
    """Phase `solvers`: (a) float64 arma on the eager tree; (b) lv_rk45 eager
    in float64; (c) lv_rk4 through the generated kernel (K7r): a run at RUNS x
    N x K=LV_RK4_K (K dispatches, no plain call), then the kernel against its plain
    version on the population it ended with; (d) the five special-function
    programs, each kernel against its plain version on a cloud around its
    generating values and a short run (their launches), and the libdevice
    sweep. Returns the kernels-line rows."""
    from smcnuts_torch import SMCConfig
    from smcnuts_torch.ops.generated import peak_live

    phase("solvers. float64 on the card, the Stan solvers, the special functions (K7r)")
    started = time.perf_counter()
    dev = torch.device("cuda")
    clock = [started]

    def part_took(what):
        now = time.perf_counter()
        print(f"solvers: {what} took {now - clock[0]:.1f} s (host clock)")
        clock[0] = now

    float64_eager_phase(smi)
    part_took("(a) float64 arma")
    rows = lv_rk45_phase(smi)
    part_took("(b) lv_rk45")
    for name in SOLVER_TILE:
        gm, trace_s, lib = prep["builds"][name].result()
        print(f"(a) {name}: {gm.autodiff} mode, {gm.n_ops} operations a leapfrog, "
              f"{gm.data.numel()} data floats, at most {peak_live(gm.program)} values live "
              f"at once; traced in {trace_s:.1f} s (a worker process), nvcc {lib.build_seconds:.1f}"
              f" s; its result read {time.perf_counter() - prep['started']:.0f} s after (a) "
              f"began ({smi})")
        for line in ptxas_lines(lib.log):
            print("  ptxas:", line)
        m = solver_model(name, gm)
        if gm.autodiff != STAN_PROGRAMS[name]["mode"]:
            raise AssertionError(f"(a) {name}: tile_autodiff='auto' chose {gm.autodiff}")
        step = STAN_PROGRAMS[name]["step"]
        k = LV_RK4_K if name == "lv_rk4" else SPECIAL_K
        cfg = SMCConfig(n_particles=N, n_iterations=k, step_size=step, max_tree_depth=MAX_DEPTH)
        label = f"({'c' if name == 'lv_rk4' else 'd'}) {name}"
        res, launches, _ = strategy_run(f"{label}, forwards, step {step}", "generated", m, cfg,
                                        smi)
        x = res.x_final.contiguous() if name == "lv_rk4" else special_cloud(name, dev)
        rows[name] = {**solver_kernel_case(label, name, m, x, smi), "launches": launches}
        part_took(label)
    prep["threads"].shutdown()
    prep["procs"].shutdown()
    rows["libdevice"] = libdevice_phase(smi)
    part_took("(d) the libdevice sweep")
    print(f"phase solvers took {time.perf_counter() - started:.1f} s (host clock; its "
          f"budget is 120 s; {smi})")
    return rows


# ---- phase tile_programs: every Stan program the JAX frontend tiles, through
# the generated NUTS kernel (K7r, K7f): dense linear algebra, the Newton
# solver, the adaptive ODE solve inlined in K7r, and the elementwise ops.

# The elementwise ops the lowering gained (tan, atan, asin, acos, sinh, cosh
# and the select-built atan2 and fmin / fmax, log_mix's logaddexp,
# log_sum_exp, inv_Phi's ndtri, digamma's derivative trigamma, weibull's pow
# with a parameter exponent) in one density: a Weibull likelihood with a
# location, a scale and a correlation-like parameter.
ELEMENTWISE_PROGRAM = """
data { int<lower=1> N; vector[N] y; real phi; }
parameters { real mu; real<lower=0> sigma; real<lower=-1, upper=1> rho; }
model {
  mu ~ normal(0, 1);
  sigma ~ lognormal(0, 0.5);
  target += 0.1 * (tan(0.5 * rho) + atan(mu) + asin(0.9 * rho) - acos(0.9 * rho)
                   + sinh(0.3 * mu) - cosh(0.3 * mu) + atan2(mu, sigma));
  target += -0.5 * square(fmax(mu, -3) - fmin(sigma, 3));
  target += log_mix(0.3, normal_lpdf(rho | -0.5, 0.5), normal_lpdf(rho | 0.5, 0.5));
  target += -0.1 * log_sum_exp(mu, sigma);
  target += 0.1 * inv_Phi(0.5 + 0.45 * rho) + 0.1 * digamma(1 + sigma);
  target += phi * weibull_lpdf(y | 1 + sigma, exp(mu));
}
"""
# tests/test_stan_orientation.py:420's algebra solver: root = sqrt(a).
ALGEBRA_PROGRAM = """
functions {
  vector sq_system(vector y, array[] real theta, array[] real x_r, array[] int x_i) {
    vector[1] z;
    z[1] = y[1] * y[1] - theta[1];
    return z;
  }
}
data { real phi; }
parameters { real<lower=0> a; }
model {
  vector[1] guess = [1.0]';
  vector[1] root = algebra_solver(sq_system, guess, {a}, {0.0}, {0});
  target += -0.5 * square(root[1] - 2.0);
  a ~ normal(4, 2);
}
"""
# tests/test_stan_ode.py:17's decay model, the adaptive solver (ode_rk45).
DECAY_PROGRAM = """
functions { vector decay(real t, vector y, real k) { return -k * y; } }
data { int<lower=1> N; array[N] real ts; vector[N] yobs; real y0; }
parameters { real<lower=0> k; real<lower=0> sigma; }
model {
  array[N] vector[1] mu = ode_rk45(decay, to_vector({y0}), 0, ts, k);
  k ~ lognormal(0, 1);
  sigma ~ exponential(1);
  for (n in 1:N) { yobs[n] ~ normal(mu[n][1], sigma); }
}
"""


def elementwise_data(seed=0, n=50):
    import numpy as np

    return {"N": n, "y": np.random.default_rng(seed).weibull(2.0, n).tolist()}


def decay_data():
    import numpy as np

    ts = [0.25, 0.5, 1.0, 2.0]
    return {"N": 4, "ts": ts, "yobs": (2.0 * np.exp(-0.8 * np.asarray(ts))).tolist(),
            "y0": 2.0}


# name -> its source (a path, or a string and its data), tile_autodiff, the
# step of its runs. lv_rk45 is LV_PROGRAM with ode_rk45 (STAN_PROGRAMS), here
# through the kernel: the adaptive solve and its adjoint inlined in K7r.
TILE_PROGRAMS = {
    "mvn_quadform": dict(path="examples/stan/mvn_quadform.stan", mode="reverse", step=0.2),
    "inv_wishart_cov": dict(path="examples/stan/inv_wishart_cov.stan", mode="reverse",
                            step=0.1),
    "multi_student_t": dict(path="examples/stan/multi_student_t.stan", mode="reverse",
                            step=0.2),
    "ordered_logistic": dict(path="examples/stan/ordered_logistic.stan", mode="reverse",
                             step=0.1),
    "algebra_solver": dict(source=ALGEBRA_PROGRAM, data=dict, mode="reverse", step=0.2),
    "decay_rk45": dict(source=DECAY_PROGRAM, data=decay_data, mode="reverse", step=0.05),
    "elementwise": dict(source=ELEMENTWISE_PROGRAM, data=elementwise_data, mode="reverse",
                        step=0.1),
    "elementwise_fwd": dict(source=ELEMENTWISE_PROGRAM, data=elementwise_data,
                            mode="forward", step=0.1),
    "lv_rk45": dict(source=LV_PROGRAM.replace("{solver}", "ode_rk45(dz_dt, z_init, 0, ts, theta)"),
                    data=lv_data, mode="reverse", step=0.02),
}
TILE_K = 10  # the short run of each small program
# A program that solves an ODE, against its plain tree (which steps each
# solve from the host, a leaf at a time): ODE_BIT_LANES lanes of run 0 at
# depth ODE_BIT_DEPTH.
ODE_BIT_LANES, ODE_BIT_DEPTH = 64, 3
# phase solvers (b)'s eager lv_rk45 run, the reference of the kernel's.
LV_EAGER = {}


def tile_source(name):
    """(source, data) of one of TILE_PROGRAMS."""
    from smcnuts_torch.stan import load_stan_data

    spec = TILE_PROGRAMS[name]
    if "source" in spec:
        return spec["source"], spec["data"]()
    with open(spec["path"]) as f:
        return f.read(), load_stan_data(spec["path"][: -len(".stan")] + ".json")


def trace_tile_program(name):
    """In a worker process: TILE_PROGRAMS[name] compiled with tile=True on
    the CPU; returns (its generated program, mode, seconds)."""
    from smcnuts_torch.stan import compile_stan_program

    torch.set_num_threads(1)
    src, data = tile_source(name)
    t0 = time.perf_counter()
    tm = compile_stan_program(src, data, name=name, tile=True,
                              tile_autodiff=TILE_PROGRAMS[name]["mode"]).tile_model
    return tm.program, tm.autodiff, time.perf_counter() - t0


def tile_prepare(smi):
    """Phase tile_programs (a), beside the later phases: each program traced
    and built in the background (`start_builds`), two at once."""
    phase("tile_programs (a). the Stan programs of the lowering's new ops: traced in "
          "processes, their nvcc started in the background")
    return start_builds(tuple(TILE_PROGRAMS), trace_tile_program, 2, smi)


def tile_model(name, gm):
    """TILE_PROGRAMS[name] compiled on the card, eager, with the generated
    model gm (traced in tile_prepare) attached."""
    from smcnuts_torch.stan import compile_stan_program

    src, data = tile_source(name)
    m = compile_stan_program(src, data, name=name)
    m.tile_model = gm
    return m.to(torch.device("cuda"))


def tile_kernel_case(label, m, x, depth, step, smi):
    """A program's kernel against its plain tree on x (B x n lanes) at
    `depth`, zero bits and Philox, to the bit; the kernel's device time, the
    plain tree's (one call) and the bound: the program's operations x the
    kernel's leapfrogs. Returns its row of the kernels line (launches added
    later)."""
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer

    ones = torch.ones(x.shape[-1], device=x.device)
    seeds = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    worst, plain_ms = 0.0, {}
    for source in (ZERO_BITS, PHILOX):
        args = (x, seeds, step, 1.0, ones, depth, source)
        out_k = nuts_tree(m, *args)
        with CudaTimer() as t:
            out_p = nuts_tree_plain(m, *args)
        plain_ms[source] = t.ms
        worst = max(worst, check_outputs(
            f"{label} [{source}] kernel vs plain, {x.shape[0]} x {x.shape[1]} x depth {depth}, "
            f"plain {t.ms:.1f} ms", out_k, out_p, nan_lanes=True, bitwise=True))
    times = kernel_times(lambda: nuts_tree(m, *args))
    bound = tree_roofline("generated", nuts_tree(m, *args), model=m.tile_model)
    print(f"{label} time, {x.shape[0]} x {x.shape[1]} x depth {depth}, step {step} [philox]: "
          f"{times_text(times)}; plain {plain_ms[PHILOX]:.1f} ms; {bound_text(bound)} "
          f"({m.tile_model.n_ops} operations x the kernel's leapfrogs; {smi})")
    return {"max_abs_err": worst, **times, "plain_ms": plain_ms[PHILOX], **bound}


def lv_eager_reference(smi):
    """Phase solvers (b)'s eager lv_rk45 run (float64, 25 x 512 x K=LV_K,
    depth 10, started around the generating values): its result, or, where
    that phase did not run, the same run made here."""
    if "res" not in LV_EAGER:
        lv_rk45_phase(smi)
    return LV_EAGER["res"]


def lv_tile_phase(gm, smi):
    """lv_rk45 through K7r, the adaptive solve and its adjoint inlined: a
    run at 25 x 512 x K=LV_K, depth 10, float32, from phase (b)'s start
    (counts set to 0 just before it): K launches, no plain call, finite
    series, the moments inside the bands of `estimates_band` against (b)'s
    eager float64 run; the RK steps its solves and adjoints took (the
    library's counter); then `ode_kernel_case` on the run's population."""
    from smcnuts_torch import DiagNormalProposal, SMCConfig, run_smc_batched
    from smcnuts_torch.ops.generated import ode_steps
    from smcnuts_torch.utils.timing import CudaTimer

    name, step = "lv_rk45", TILE_PROGRAMS["lv_rk45"]["step"]
    ref = lv_eager_reference(smi)
    m = tile_model(name, gm)
    cfg = SMCConfig(n_particles=N, n_iterations=LV_K, step_size=step, max_tree_depth=MAX_DEPTH)
    start = DiagNormalProposal(8, mean=tuple(math.log(v) for v in LV_TRUTH), var=(0.01,) * 8)
    ode_steps(gm, reset=True)
    reset_counts()
    with CudaTimer() as t:
        res = run_smc_batched(m, cfg, SEEDS, "cuda", sample_proposal=start)
        res.mean_estimate[:, -1].cpu()
    counts, plain_calls = read_counts()
    fwd, adj = ode_steps(gm, reset=True)
    label = f"(c) lv_rk45 through K7r, {RUNS} x {N} x K={LV_K}, depth {MAX_DEPTH}, step {step}"
    check_series(label, res, LV_K)
    if counts["generated"] != LV_K or plain_calls != 0:
        raise AssertionError(f"{label}: {counts} dispatches, {plain_calls} plain calls")
    leapfrogs = float(res.tree_leapfrogs[:, :LV_K].sum()) * N
    print(f"{label}: {LV_K} dispatches, no plain call; wall {t.ms:.1f} ms (CUDA events; "
          f"phase (b)'s eager float64 run of the same shape took {LV_EAGER['wall_s']:.1f} s); "
          f"{fwd} RK steps of the solves and {adj} of the adjoints, {fwd / leapfrogs:.1f} and "
          f"{adj / leapfrogs:.1f} a leapfrog (float32, the initial evaluations counted; (b)'s "
          f"float64 steps a lane stand beside its ODE rows); mean tree depth "
          f"{float(res.tree_depth[:, :LV_K].mean()):.3f}, acceptance "
          f"{float(res.acceptance_rate[:, :LV_K].mean()):.3f} ({smi})")
    estimates_band(f"{label} against (b)'s eager float64 run", res.mean_estimate[:, -1],
                   res.variance_estimate[:, -1], ref.mean_estimate[:, -1].mean(0),
                   ref.variance_estimate[:, -1].mean(0))
    return {**ode_kernel_case("(c) lv_rk45", m, res.x_final.contiguous(), step, smi),
            "launches": counts["generated"]}


def ode_kernel_case(label, m, x, step, smi):
    """A program that solves an ODE: its kernel against its plain tree to
    the bit on ODE_BIT_LANES lanes of x's run 0 at depth ODE_BIT_DEPTH (the
    plain tree steps each solve from the host), then timed at x's shape
    (`ode_kernel_timed`). Returns its row of the kernels line."""
    row = tile_kernel_case(f"{label} [bits]", m, x[:1, :ODE_BIT_LANES].contiguous(),
                           ODE_BIT_DEPTH, step, smi)
    return {**ode_kernel_timed(label, m, x, MAX_DEPTH, step, smi),
            "max_abs_err": row["max_abs_err"], "plain_ms": row["plain_ms"]}


def ode_kernel_timed(label, m, x, depth, step, smi):
    """The kernel of a program that solves an ODE timed at x's shape, where
    its plain tree (which steps each solve from the host) is not run: the
    device time and the bound from this call's leapfrogs and RK steps."""
    from smcnuts_torch.ops.draws import PHILOX
    from smcnuts_torch.ops.generated import ode_steps
    from smcnuts_torch.ops.nuts_cuda import nuts_tree

    gm = m.tile_model
    ones = torch.ones(x.shape[-1], device=x.device)
    seeds = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    args = (x, seeds, step, 1.0, ones, depth, PHILOX)
    times = kernel_times(lambda: nuts_tree(m, *args))
    ode_steps(gm, reset=True)
    out = nuts_tree(m, *args)
    fwd, adj = ode_steps(gm, reset=True)
    progs = {d.kind: d.prog for d in gm.program.calls}
    tree_ops = float(out[2]["leapfrogs"].sum()) * gm.n_ops
    ode_ops = fwd * progs["ode"].step_ops(False) + adj * progs["ode_adj"].step_ops(True)
    bound = roofline(tree_ops + ode_ops, 0.0)
    evals = float(out[2]["leapfrogs"].sum()) + x.shape[0] * x.shape[1]
    print(f"{label} time, {x.shape[0]} x {x.shape[1]} x depth {depth}, step {step} [philox]: "
          f"{times_text(times)}; {bound_text(bound)} ({gm.n_ops} operations x "
          f"{int(out[2]['leapfrogs'].sum())} leapfrogs, {fwd} and {adj} RK steps of the solves "
          f"and adjoints ({fwd / evals:.1f} and {adj / evals:.1f} a model evaluation) x "
          f"{progs['ode'].step_ops(False)} and {progs['ode_adj'].step_ops(True)} operations a "
          f"step; {smi})")
    return {**times, **bound}


def tile_programs_phase(smi, prep):
    """Phase tile_programs: (b) each small program's generated model (the
    nvcc of (a): its seconds, ptxas's lines, operations a leapfrog) through
    the kernel at 25 x 512 x K=TILE_K, forwards, depth 10 (`strategy_run`:
    K launches, no plain call, finite series, runs 0 and 24 equal their
    single runs), then on the population it ended with the kernel against
    its plain tree at 25 x 512 x depth 10, zero bits and Philox, to the bit,
    timed beside its bound (a program that solves an ODE, decay_rk45: to
    the bit at ODE_BIT_LANES lanes x depth ODE_BIT_DEPTH, timed at 25 x 512
    x depth 10, `ode_kernel_case`); (c) lv_rk45 through K7r
    (`lv_tile_phase`). Returns the kernels-line rows."""
    from smcnuts_torch import SMCConfig
    from smcnuts_torch.ops.generated import peak_live

    phase("tile_programs. the Stan programs the JAX frontend tiles, through K7r and K7f")
    started = time.perf_counter()
    rows = {}
    for name, spec in TILE_PROGRAMS.items():
        gm, trace_s, lib = prep["builds"][name].result()
        print(f"(a) {name}: {gm.autodiff} mode, {gm.n_ops} operations a leapfrog, "
              f"{len(gm.program.calls)} ODE call(s), {gm.data.numel()} data floats, at most "
              f"{peak_live(gm.program)} values live at once; traced in {trace_s:.1f} s (a "
              f"worker process), nvcc {lib.build_seconds:.1f} s; read "
              f"{time.perf_counter() - prep['started']:.0f} s after (a) began ({smi})")
        for line in ptxas_lines(lib.log):
            print("  ptxas:", line)
        if gm.autodiff != spec["mode"]:
            raise AssertionError(f"(a) {name}: built in {gm.autodiff} mode")
        t0 = time.perf_counter()
        if name == "lv_rk45":
            rows[name] = lv_tile_phase(gm, smi)
        else:
            m = tile_model(name, gm)
            cfg = SMCConfig(n_particles=N, n_iterations=TILE_K, step_size=spec["step"],
                            max_tree_depth=MAX_DEPTH)
            label = f"(b) {name}"
            res, launches, _ = strategy_run(f"{label}, forwards, step {spec['step']}",
                                            "generated", m, cfg, smi)
            x = res.x_final.contiguous()
            if gm.program.calls:
                row = ode_kernel_case(label, m, x, spec["step"], smi)
            else:
                row = tile_kernel_case(label, m, x, MAX_DEPTH, spec["step"], smi)
            rows[name] = {**row, "launches": launches}
        print(f"tile_programs: {name} took {time.perf_counter() - t0:.1f} s (host clock)")
    prep["threads"].shutdown()
    prep["procs"].shutdown()
    print(f"phase tile_programs took {time.perf_counter() - started:.1f} s (host clock; {smi})")
    return rows


# ---- phase mesh: the particle and run axes over a process group.

# (b): arma forwards at the multihost entry's default N (full width), K=20,
# depth 10, one run, over 2 and 4 rank processes sharing the card (gloo);
# without the saved history, as the multihost entry runs it.
MESH_WIDE = dict(n_particles=1 << 20, n_iterations=20, step_size=STEP,
                 max_tree_depth=MAX_DEPTH, save_history=False)
MESH_RANKS = (2, 4)
# (d): the elastic gang at (b)'s size, K=10 in chunks of 5.
MESH_ELASTIC_K, MESH_ELASTIC_CHUNK = 10, 5


def mesh_npz_diff(path, want):
    """Fields of an SMCResult `want` in which the .npz at path differs in
    any bit (or is missing)."""
    import numpy as np

    got = np.load(path)
    diff = []
    for name, v in want._asdict().items():
        if v is None:
            continue
        w = v.detach().cpu().numpy()
        g = got[name] if name in got.files else None
        if (g is None or g.shape != w.shape or g.dtype != w.dtype
                or not np.array_equal(np.atleast_1d(g).view(np.uint8),
                                      np.atleast_1d(w).view(np.uint8))):
            diff.append(name)
    return diff


def mesh_rank_lines(label, infos, k):
    """Each rank's line of a gang's run (gang.py's `wide` job), and checks
    that every rank launched its kernel once an iteration."""
    for info in infos:
        if info["launches"] != k:
            raise AssertionError(f"{label}: rank {info['rank']} dispatched "
                                 f"{info['launches']} times, not {k}")
        print(f"  rank {info['rank']} of {info['size']}: {info['lanes']} lanes, "
              f"{info['launches']} dispatches in {info['stage_launches']} kernel launches "
              f"(splits {info['splits']}), {info['resampled']} run-iterations resampled, "
              f"wall {1e3 * info['wall_s']:.1f} ms; its kernel "
              f"on its final shard {info['kernel_ms']:.4f} ms (device alone, one rank at a "
              f"time); collectives {info['collective_calls'] / k:.1f} calls, "
              f"{info['collective_bytes_in'] / k / 2**20:.3f} MiB in and "
              f"{1e3 * info['collective_s'] / k:.2f} ms an iteration (gloo, device "
              f"synchronised around each)")


def mesh_phase(smi):
    """Phase mesh: the particle and run axes over torch.distributed process
    groups (`smcnuts_torch/parallel/`). (a) `python -m torch.distributed.run
    --standalone --nproc-per-node 1 -m smcnuts_torch --mesh` arma at N=512,
    K=100, depth 10 (NCCL, world size 1): its JSON equal to the run without
    --mesh. The card's compute mode must let processes share it for the
    rest: (b) arma forwards at N = 1,048,576, K=20, depth 10, over 2 and 4
    rank processes sharing the card (gloo on CUDA tensors): every field equal
    to the unsharded run on the card to the bit, K dispatches a rank, each
    rank's kernel time and collectives, the walls against the unsharded run;
    (c) PRMwCD at 25 x 512 x K=100 over 2 ranks (in (b)'s gang of 2), each
    rank's "auto" staging its 6,400 lanes: equal to the unsharded run to the
    bit; (d) `Supervisor` over 2 ranks of the multihost entry at (b)'s size,
    K=10 in chunks of 5, rank 1 exiting after chunk 1, the gang restarted
    from the checkpoint: equal to the unsharded K=10 run and to (b)'s first
    iterations to the bit. The libraries are built (phase 2) before any rank
    starts. Returns the NUTS dispatches and continuation launches of the
    phase, this process's and the ranks', per model."""
    import tempfile

    from smcnuts_torch import SMCConfig, run_smc, run_smc_batched
    from smcnuts_torch.models import get_model
    from smcnuts_torch.parallel import Supervisor, gang
    from smcnuts_torch.utils.timing import CudaTimer

    phase("mesh. the particle and run axes over a process group")
    started = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    counts = PhaseCounts()
    ranks = {"launches": {}, "cont": {}}
    tmp = tempfile.TemporaryDirectory()

    # (a) torchrun, NCCL, world size 1, through the CLI.
    argv = ["--model", "arma", "-N", str(N), "-K", str(K), "--max-tree-depth", str(MAX_DEPTH)]
    t0 = time.perf_counter()
    # torchrun's worker does not put the working directory on its path.
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "1", "-m", "smcnuts_torch", "--mesh", *argv],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"(a) torchrun --mesh failed ({run.returncode}):\n"
                             f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    printed = json.loads(run.stdout[run.stdout.index("{"):run.stdout.rindex("}") + 1])
    wall_a = time.perf_counter() - t0
    plain, launched, plain_calls, _ = counts.run(lambda: quiet_cli(argv))
    if printed != plain or launched["arma"] != K or plain_calls:
        raise AssertionError(f"(a) the --mesh JSON differs from the run without it, or "
                             f"the run dispatched {launched['arma']} times: {printed} "
                             f"against {plain}")
    print(f"(a) torchrun --standalone --nproc-per-node 1 -m smcnuts_torch --mesh (NCCL, "
          f"world size 1) arma N={N} K={K} depth {MAX_DEPTH}: its JSON equals the run "
          f"without --mesh; {wall_a:.1f} s with the launcher and the process's start")

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"compute mode: {mode}")
    if mode.splitlines()[0] != "Default":
        print(f"(b)-(d) not run: the compute mode {mode!r} keeps a second process off the "
              f"card ({smi})")
        tmp.cleanup()
        return counts, ranks

    def add_ranks(model, infos):
        ranks["launches"][model] = ranks["launches"].get(model, 0) + sum(
            i["launches"] for i in infos)
        ranks["cont"][model] = ranks["cont"].get(model, 0) + sum(
            i["stage_launches"] - i["launches"] for i in infos)

    # (b) and (c): the unsharded runs on the card, then the gangs.
    arma, prmwcd = get_model("arma").to("cuda"), get_model("prmwcd").to("cuda")
    cfg_b = SMCConfig(**MESH_WIDE)
    cfg_c = SMCConfig(n_particles=N, n_iterations=K, step_size=STEP, max_tree_depth=MAX_DEPTH)

    def timed(fn):
        with CudaTimer() as t:
            res = fn()
            res.mean_estimate.cpu()
        return res, t.ms

    (ref_b, wall_b), _, _, _ = counts.run(lambda: timed(
        lambda: run_smc_batched(arma, cfg_b, [0], "cuda")))
    (ref_c, wall_c), _, _, _ = counts.run(lambda: timed(
        lambda: run_smc_batched(prmwcd, cfg_c, SEEDS, "cuda")))
    check_series("(b) unsharded", ref_b, cfg_b.n_iterations)
    check_series("(c) unsharded", ref_c, K)
    runs = [{"name": "arma", "model": "arma", "seeds": [0], "config": MESH_WIDE},
            {"name": "prmwcd", "model": "prmwcd", "seeds": SEEDS,
             "config": dict(n_particles=N, n_iterations=K, step_size=STEP,
                            max_tree_depth=MAX_DEPTH)}]
    for size in MESH_RANKS:
        out = os.path.join(tmp.name, f"gang{size}")
        os.makedirs(out)
        t0 = time.perf_counter()
        gang.launch(out, size, ["wide"], {"runs": runs if size == 2 else runs[:1]},
                    backend="gloo", device="cuda", timeout=900)
        gang_s = time.perf_counter() - t0
        for name, ref, wall, k in (("arma", ref_b, wall_b, cfg_b.n_iterations),
                                   ("prmwcd", ref_c, wall_c, K)):
            stem = os.path.join(out, f"wide_{name}_P{size}")
            if not os.path.exists(stem + ".npz"):
                continue
            diff = mesh_npz_diff(stem + ".npz", ref)
            if diff:
                raise AssertionError(f"{'(b)' if name == 'arma' else '(c)'} {name} over "
                                     f"{size} ranks differs from the unsharded run in {diff}")
            with open(stem + ".json") as f:
                infos = json.load(f)
            label = (f"(b) arma N={cfg_b.n_particles} K={k}" if name == "arma" else
                     f"(c) PRMwCD {RUNS} x {N} x K={K}")
            if name == "prmwcd" and not all(i["splits"] and i["stage_launches"] > i["launches"]
                                            for i in infos):
                raise AssertionError(f"{label}: a rank did not stage its "
                                     f"{infos[0]['lanes']} lanes: {infos}")
            walls = ", ".join(f"{1e3 * i['wall_s']:.1f}" for i in infos)
            print(f"{label} over {size} ranks sharing the card (gloo): every field equal to "
                  f"the unsharded run on the card to the bit; walls {walls} ms against the "
                  f"unsharded {wall:.1f} ms (CUDA events); one card, so this is the "
                  f"collectives' and the processes' overhead, not scaling ({smi})")
            mesh_rank_lines(label, infos, k)
            add_ranks(name, infos)
        print(f"  the gang of {size}: {gang_s:.1f} s with its processes' start")

    # (d) the elastic gang.
    ckpt, output = os.path.join(tmp.name, "elastic.npz"), os.path.join(tmp.name, "elastic_out.npz")

    def make_cmd(pid, coordinator, attempt):
        cmd = [sys.executable, "-m", "smcnuts_torch.parallel.multihost", "--backend", "gloo",
               "--device", "cuda", "--model", "arma", "-N", str(MESH_WIDE["n_particles"]),
               "-K", str(MESH_ELASTIC_K), "--max-tree-depth", str(MAX_DEPTH),
               "--step-size", str(STEP), "--checkpoint", ckpt,
               "--chunk-size", str(MESH_ELASTIC_CHUNK), "--output", output,
               "--coordinator", coordinator, "--num-processes", "2", "--process-id", str(pid)]
        return cmd + (["--crash-after-chunk", "1"] if pid == 1 and attempt == 0 else [])

    t0 = time.perf_counter()
    sup = Supervisor(make_cmd, 2, max_restarts=1, cwd=repo)
    inc = sup.run(timeout=900)
    elastic_s = time.perf_counter() - t0
    first = sup.incarnations[0]
    if (len(sup.incarnations) != 2 or 17 not in first.returncodes
            or "resumed=True" not in inc.outputs[0]):
        raise AssertionError(f"(d) the gang did not fail once and resume: "
                             f"{[i.returncodes for i in sup.incarnations]}\n{inc.outputs[0][-2000:]}")
    cfg_d = SMCConfig(**{**MESH_WIDE, "n_iterations": MESH_ELASTIC_K})
    ref_d, _, _, _ = counts.run(lambda: run_smc(arma, cfg_d, 0, "cuda"))
    diff = mesh_npz_diff(output, ref_d)
    if diff:
        raise AssertionError(f"(d) the resumed gang differs from the unsharded run in {diff}")
    import numpy as np

    got = np.load(output)
    k = MESH_ELASTIC_K
    prefix = [f for f in ("ess", "log_likelihood", "phi", "acceptance_rate", "resampled",
                          "step_size", "tree_depth", "tree_leapfrogs", "accept_stat",
                          "mean_estimate", "variance_estimate")
              if not np.array_equal(got[f][:k], getattr(ref_b, f)[0, :k].cpu().numpy())]
    prefix += [f for f in ("ess", "log_likelihood", "phi", "mean_estimate",
                           "variance_estimate")
               if not np.array_equal(got[f][k], getattr(ref_b, f)[0, k].cpu().numpy())]
    if prefix:
        raise AssertionError(f"(d) the resumed gang differs from (b)'s first {k} "
                             f"iterations in {prefix}")
    print(f"(d) Supervisor over 2 ranks of the multihost entry (gloo on the card), arma "
          f"N={MESH_WIDE['n_particles']} K={k} in chunks of {MESH_ELASTIC_CHUNK}: rank 1 "
          f"exited after chunk 1 (return codes {first.returncodes}), the gang restarted and "
          f"resumed from the checkpoint; every field equal to the unsharded K={k} run, and "
          f"its series to (b)'s first {k} iterations, to the bit; {elastic_s:.1f} s for both "
          f"incarnations ({smi})")
    tmp.cleanup()
    print(f"phase mesh: {time.perf_counter() - started:.1f} s")
    return counts, ranks


def partial_run(only, smi, stan_prep, solvers_prep, tile_prep):
    """The phases named in `only` (after device and build), for development:
    no kernels line and no "ok" line, so it cannot pass for the whole run."""
    phases = {"arma": arma_kernel_phase, "prmwcd": prmwcd_kernel_phase,
              "main": main_path_phase, "batched": batched_phase,
              "staged_times": staged_times_phase, "cli": lambda smi: cli_phase(),
              "autodiff": autodiff_kernels_phase, "gaussian": one_model_phase("gaussian"),
              "logistic": one_model_phase("logistic"),
              "eightschools": one_model_phase("eightschools"),
              "strategies": strategies_phase,
              "fused_kernel": arma_fused_kernel_phase, "eager": eager_arma_phase,
              "unfused": unfused_kernel_phase, "wide_eager": wide_eager_phase,
              "generated": generated_phase, "runner": runner_phase,
              "stan": lambda smi: stan_phase(smi, stan_prep),
              "solvers": lambda smi: solvers_phase(smi, solvers_prep),
              "lv_rk45": lv_rk45_phase,
              "tile_programs": lambda smi: tile_programs_phase(smi, tile_prep),
              "mesh": mesh_phase, "oracle": oracle_phase}
    for key in only:
        phases[key](smi)
    if len(PARITY_FINALS) == 6:  # `--only batched,strategies`
        parity_summary_phase()
    print(f"\nchip_smoke: partial run of {only} passed; no result line")


def main():
    started = time.perf_counter()
    name, smi = device_phase()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    only = sys.argv[2].split(",") if len(sys.argv) == 3 and sys.argv[1] == "--only" else None
    stan_prep = stan_prepare(smi) if only is None or "stan" in only else None
    build_phase()
    k8 = peak_phase(smi)
    # After phase 2's build (its minute), beside the phases that follow.
    solvers_prep = solvers_prepare(smi) if only is None or "solvers" in only else None
    tile_prep = tile_prepare(smi) if only is None or "tile_programs" in only else None
    if only is not None:
        return partial_run(only, smi, stan_prep, solvers_prep, tile_prep)
    arma, arma_staged, arma_w1 = arma_kernel_phase(smi)
    prmwcd, prmwcd_staged, prmwcd_w1 = prmwcd_kernel_phase(smi)
    arma_launches = main_path_phase(smi)
    batched, cont = batched_phase(smi)
    staged_times_phase(smi)
    prm_cli, schools_cli = cli_phase()
    autodiff, witnesses = autodiff_kernels_phase(smi)
    strategies, strategies_cont = strategies_phase(smi)
    strategies["eightschools"] += schools_cli
    parity_summary_phase()
    strategies["gaussian"] += oracle_phase(smi)
    k5, k5_w1, k1u = fused_phase(smi)
    k7f, k7r, k7f_witnesses, k7r_w2 = generated_phase(smi)
    tally = runner_phase(smi)
    stan, stan_witnesses = stan_phase(smi, stan_prep)
    solvers = solvers_phase(smi, solvers_prep)
    tiles = tile_programs_phase(smi, tile_prep)
    mesh_counts, mesh_ranks = mesh_phase(smi)
    source = "smcnuts_torch/csrc/nuts_tree.cuh"

    def mesh_launches(kind, model):
        """Phase mesh's launches of a model: this process's and its ranks'."""
        own = mesh_counts.launches if kind == "launches" else mesh_counts.cont
        return own.get(model, 0) + mesh_ranks[kind].get(model, 0)

    # No single PyTorch call builds a NUTS tree, computes the fused ARMA
    # value and gradient or runs FMA chains, so no kernel but libdevice_unary
    # (torch's op) has a library time.
    kernels = [
        # K2, inlined into the K1 instantiation this entry launches.
        dict(name="nuts_tree_arma", route="cuda", source="smcnuts_torch/csrc/arma_model.cuh",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:154",
             launches=arma_launches + batched["arma"] + strategies["arma"]
             + tally.launches["arma"] + mesh_launches("launches", "arma"), **arma),
        # K3, inlined into the K1 instantiation this entry launches.
        dict(name="nuts_tree_prmwcd", route="cuda",
             source="smcnuts_torch/csrc/prmwcd_model.cuh",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1803",
             launches=batched["prmwcd"] + prm_cli + strategies["prmwcd"]
             + tally.launches["prmwcd"] + mesh_launches("launches", "prmwcd"), **prmwcd),
        # K4: the continuation-stage instantiations of the staged dispatch.
        dict(name="nuts_tree_arma_staged", route="cuda", source=source,
             replaces="smcnuts_tpu/ops/nuts_pallas.py:794",
             launches=cont["arma"] + strategies_cont["arma"] + tally.cont["arma"]
             + mesh_launches("cont", "arma"), **arma_staged),
        dict(name="nuts_tree_prmwcd_staged", route="cuda", source=source,
             replaces="smcnuts_tpu/ops/nuts_pallas.py:794",
             launches=cont["prmwcd"] + strategies_cont["prmwcd"] + tally.cont["prmwcd"]
             + mesh_launches("cont", "prmwcd"), **prmwcd_staged),
        # The W = 1 witnesses of K1 + K2 and K1 + K3 (one thread a particle),
        # measurement entries that the main path never dispatches: 0
        # launches, and marked.
        dict(name="nuts_tree_arma_w1", route="cuda",
             source="smcnuts_torch/csrc/arma_variants.cu",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1931", **arma_w1),
        dict(name="nuts_tree_prmwcd_w1", route="cuda",
             source="smcnuts_torch/csrc/prmwcd_variants.cu",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1803", **prmwcd_w1),
    ]
    # K6: the densities the JAX package differentiates inside its kernel
    # (elementwise_tile_model), each inlined into its own K1 instantiation.
    kernels += [
        dict(name=f"nuts_tree_{model}", route="cuda",
             source=f"smcnuts_torch/csrc/{model}_model.cuh",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1094",
             launches=strategies[model] + tally.launches.get(model, 0), **autodiff[model])
        for model in AUTODIFF_MODELS
    ]
    # The W = 1 witnesses of K6c and K6b (one thread a particle), and K6a's
    # kernel before the pipelined walk: measurement entries.
    kernels += [
        dict(name=f"nuts_tree_{model}_w1", route="cuda",
             source=f"smcnuts_torch/csrc/{model}_variants.cu",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1094", **witnesses[model])
        for model in ("logistic", "eightschools")
    ]
    kernels.append(dict(name="nuts_tree_gaussian_witness", route="cuda",
                        source="smcnuts_torch/csrc/gaussian_variants.cu",
                        replaces="smcnuts_tpu/ops/nuts_pallas.py:1094",
                        **witnesses["gaussian"]))
    kernels += [
        # K5: the fused ARMA value and gradient that the eager tree calls.
        dict(name="arma_ll_vg", route="cuda", source="smcnuts_torch/csrc/arma_fused.cu",
             replaces="smcnuts_tpu/ops/arma_fused.py:115", **k5),
        # K5's W = 1 witness (one thread a particle): a measurement entry.
        dict(name="arma_ll_vg_w1", route="cuda", source="smcnuts_torch/csrc/arma_fused.cu",
             replaces="smcnuts_tpu/ops/arma_fused.py:115", **k5_w1),
        # K1u: the whole-tree kernel with the momenta given (the unfused path).
        dict(name="nuts_tree_arma_r_given", route="cuda", source=source,
             replaces="smcnuts_tpu/ops/nuts_pallas.py:999", **k1u),
        # K7: generated models inlined into the K1 template, one library each.
        dict(name="nuts_tree_generated_arma_forward", route="cuda",
             source="smcnuts_torch/ops/generated.py",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1674", **k7f),
        # K7f's witnesses: the same program straight-line, and straight-line
        # in the order it was built, each its own library; measurement
        # entries.
        dict(name="nuts_tree_generated_arma_forward_straight_line", route="cuda",
             source="smcnuts_torch/ops/generated.py",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1674", **k7f_witnesses["straight-line"]),
        dict(name="nuts_tree_generated_arma_forward_built_order", route="cuda",
             source="smcnuts_torch/ops/generated.py",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1674", **k7f_witnesses["built order"]),
        dict(name="nuts_tree_generated_eightschools_reverse", route="cuda",
             source="smcnuts_torch/ops/generated.py",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1126", **k7r),
        # K7r split over 2 lanes a particle, its own library; a measurement
        # entry.
        dict(name="nuts_tree_generated_eightschools_reverse_w2", route="cuda",
             source="smcnuts_torch/ops/generated.py",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1126", **k7r_w2),
    ]
    # K7 through the Stan frontend: each program's generated model inlined
    # into the K1 template, one library each (phase 13).
    kernels += [
        dict(name=f"nuts_tree_generated_stan_{prog}_{STAN_PROGRAMS[prog]['mode']}",
             route="cuda", source="smcnuts_torch/ops/generated.py",
             replaces=STAN_PROGRAMS[prog]["replaces"], **row)
        for prog, row in stan.items()
    ]
    # The forward programs' straight-line witnesses, each its own library;
    # measurement entries.
    kernels += [
        dict(name=f"nuts_tree_generated_stan_{prog}_forward_straight_line", route="cuda",
             source="smcnuts_torch/ops/generated.py",
             replaces=STAN_PROGRAMS[prog]["replaces"], **row)
        for prog, row in stan_witnesses.items()
    ]
    # Phase `solvers`: lv_rk4 and the special-function programs through the
    # Stan frontend, each its generated model inlined into the K1 template,
    # one library each; and the check of the libdevice calls they emit, a
    # measurement entry whose library call is torch's op.
    kernels += [
        dict(name=f"nuts_tree_generated_stan_{prog}_{STAN_PROGRAMS[prog]['mode']}",
             route="cuda", source="smcnuts_torch/ops/generated.py",
             replaces=STAN_PROGRAMS[prog]["replaces"], **solvers[prog])
        for prog in SOLVER_TILE
    ]
    # Phase tile_programs: the Stan programs of the lowering's linear algebra,
    # Newton solver, inlined adaptive ODE solve and elementwise ops, each its
    # generated model inlined into the K1 template, one library each.
    kernels += [
        dict(name=f"nuts_tree_generated_stan_{prog}_{TILE_PROGRAMS[prog]['mode']}",
             route="cuda", source="smcnuts_torch/ops/generated.py",
             replaces=K7F if TILE_PROGRAMS[prog]["mode"] == "forward" else K7R, **row)
        for prog, row in tiles.items()
    ]
    kernels.append(dict(name="libdevice_unary", route="cuda",
                        source="smcnuts_torch/csrc/libdevice_sweep.cu", replaces=K7R,
                        **solvers["libdevice"]))
    # The adaptive ODE solve and its adjoint (phase `solvers` (b)): no Pallas
    # kernel's port, the counterpart of XLA's odeint loop, which the JAX
    # frontend lowers every adaptive solver to; float64, bound by FP64
    # operations (no bound_unfused_ms: phase 2b measures FP32).
    kernels += [
        dict(name=key, route="cuda", source="smcnuts_torch/csrc/ode_dopri5.cuh",
             replaces="smcnuts_tpu/stan/compiler.py:1031", **solvers[key])
        for key in ("ode_dopri5", "ode_dopri5_adjoint")
    ]
    kernels += [
        # K8: the FP32 peak, through its own entry point (ops/peak.peak_table).
        dict(name="fma_peak", route="cuda", source="smcnuts_torch/csrc/fma_peak.cu",
             replaces="experiments/bench_vpu_peak.py:38", **k8),
    ]
    for kernel in kernels:
        kernel.setdefault("library_ms", None)
        if kernel["launches"] < 1 and not kernel.get("measurement_entry"):
            raise AssertionError(f"{kernel['name']}: the main path never launched it")
        if "bound_unfused_ms" not in kernel:  # float64: the FP64 rate
            print(f"{kernel['name']}: {kernel['ms']:.4f} ms on the device alone (a call "
                  f"timed alone {kernel['host_call_ms']:.4f} ms), bound "
                  f"{kernel['bound_ms']:.5f} ms by {kernel['bound_by']}, "
                  f"{kernel['bound_ms'] / kernel['ms']:.5f} of it at the data sheet's FP64 "
                  f"{PEAK_FP64 / 1e12:.0f} TFLOP/s ({smi})")
            continue
        print(f"{kernel['name']}: {kernel['ms']:.4f} ms on the device alone (a call "
              f"timed alone {kernel['host_call_ms']:.4f} ms), {bound_text(kernel)}, "
              f"{kernel['bound_ms'] / kernel['ms']:.3f} of it at the data sheet's "
              f"{PEAK_FP32 / 1e12:.0f} TFLOP/s, "
              f"{kernel['bound_unfused_ms'] / kernel['ms']:.3f} at the measured "
              f"FMUL+FADD {MEASURED_PEAK['fmul_fadd'] / 1e12:.3f} TFLOP/s ({smi})")
    print(f"\nchip_smoke: all phases passed in {time.perf_counter() - started:.0f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
