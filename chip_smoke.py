#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`helmnet_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Drives the learned 2D solve at 96^2 x batch 32 x 500 iterations through
`IterativeSolver.forward` with the fused DoubleConv kernel K1, the
channel-packed solve at 256^2 x 16 x 50 through `rollout_packed` with the
packed fused DoubleConv kernel K3 (and at 256^2 x 32 x 50, g = 32, with
K3's cluster instance), the FD-stencil residual kernels K2a-c
at bench.py's 512^2 x 8, batched GMRES on the stencil operator at
256^2 x 16, unsupervised replay-buffer training at 96^2 x 32 with 10 unrolled
steps, and the classical solvers (learned-preconditioned FGMRES,
two-level, deflated GMRES, hybrid, `solve_auto`, `cli/solve`) with the
tpu_r2c weights, serving (`SolverService`, `cli/serve`) with the
remaining 2D entry points, the 3D solvers with the tpu3d_a and tpu3d_het
weights, the distribution modules on NCCL, and the skull solve at
512^2, `produce_figures`' compute path, the sanitizers and the dry run,
and the 1024^2 train step and K1 rollout on the fft operator (the split
grid's single-card end) and the CSLP-preconditioned GMRES on the split
grid at 1024^2, and checks them all:

1. device: name, count, and `nvidia-smi`'s name and power limit;
2. build: the `nvcc` build of the CUDA kernels and, for every instance
   of K1, K3 and K2, its registers, shared memory and spills from ptxas's
   resource lines (the whole log goes to --out);
3. kernel against plain version: each of the 14 DoubleConv calls of one
   solver step, at their real shapes, with the weights prepared once
   (`ops/double_conv.prepare`), against `double_conv_plain` (atol
   2e-2 * max|ref|, the JAX package's bound in
   tests/test_pallas_pixconv.py), and bit-equal to the same call with the
   weights converted in the call; each with the output tile `tile_for`
   chose; and the NaN gate (`nan_gate`) at decode[0]+outc at each output
   tile: a NaN planted at a seeded pixel and channel gives NaN exactly
   where the plain version (cuDNN off: the direct sums) has one, its
   5 x 5 receptive field over every channel, and atol 2e-2 * max|ref|
   elsewhere;
4. main path: trained weights (trained_models/round1_best_epoch890.npz)
   and the first 32 maps of datasets/splitted_96/testset.npz, 500
   iterations in 'pallas' mode. Exactly 14 x 500 kernel launches, finite
   and falling rmse, and agreement with the same solve in 'xla' mode
   (cuDNN, f32) and with the port's CPU path on a small input;
5. times: each kernel shape beside its plain version, the cuDNN
   DoubleConv and its bound, its share of the bound and its time at the
   output tile `tile_for` did not choose (device time from CUDA events
   around a CUDA graph replay, after a warm-up), and the rollout's gridpoints per
   second in both modes (host clock around synchronised runs), and where
   a step's time goes in both modes: wall and device time per step, the
   device's busy share and the busiest kernels (torch.profiler over 50
   steps);
6. K3 against its plain version: the 14 DoubleConv calls of one packed
   step at 256^2, g = 16 (the trained weights packed by `pack_params`,
   seeded random inputs), within atol 2e-2 * max|ref|, each with its tile,
   beside its plain version, the cuDNN f32 DoubleConv and its bound, with
   its TFLOP/s, share of the bound and time at the other tiles; 6b: the
   same at the 14 calls of a g = 32 and a g = 64 step at 256^2 (mid and
   out widths 256 and 512: K3's cluster instance, and the 128-wide one at
   the state convs), each call timed in a graph of 10, each with its
   cluster size, CTAs, and the weight bytes the design reads from L2 (a
   model, `k3_design_bytes`: tiles x the prepared w1, w2 and w3; not
   measured) with the rate that implies, beside a probe of the card's
   read rate from a tensor that fits the L2 (`l2_read_tb_s`); in 6 and
   6b the NaN gate
   at the first call of each instance (128-wide, cluster) at each of its
   tiles (the packed block-diagonal weights carry the NaN to every
   problem of the pack, in the kernel as in the plain version);
7. the packed path: `rollout_packed` on the 16 maps of
   datasets/eval256/maps.npz, g = 16, 50 iterations (bench.py:234) in
   'pallas' mode. Exactly 14 x 50 K3 launches and no K1 launch, finite
   rmse, the first 4 rmse within rtol 0.05 of the unpacked cuDNN-f32
   rollout and the best rmse within a factor 1.5 of its best, packed
   'xla' against unpacked 'xla' within rtol 1e-3 on the first 10 rmse,
   and the card against the port's CPU path (16 maps at 96^2, 4
   iterations) within rtol 0.05; 7b (run after phase 8): the same at
   g = 32 on 32 maps (those 16 and 16 of `make_dataset(16, 256, seed=0)`),
   50 iterations: exactly 14 x 50 K3 launches and no other hand-kernel
   launch, the first 4 rmse within rtol 0.05 of the unpacked cuDNN-f32
   rollout and the best within a factor 1.5, its wall and gridpoints/s,
   and a profile of 5 steps (device time, busy share, K3's share);
8. throughput at 256^2 x 16 x 50 of packed 'pallas' (K3), packed 'xla'
   (cuDNN), unpacked 'pallas' (K1) and unpacked 'xla', in turns within
   this run, and torch.profiler over 10 packed 'pallas' steps;
9. K2 at bench.py's stencil_spmv_512 shape (512^2 x 8, order 4, seeded
   normal u): `residual_planes` (K2a), `residual_planes_tiled` (K2b,
   tile_h=128) and `residual_planes_mxu` (K2c), all three one kernel,
   against their plain versions at atol 1e-5, 1e-5 and 2e-4
   (tests/test_pallas_stencil.py:35, 90, 116), with k^2 = 1 and s = u
   (bench.py:258-267) and with random k^2 and s; the same at order 2, on
   a ragged 40x72 grid (K2a) and through the stride-2 channel-pair
   wrapper; each with the kernel instance it took and whether K2a and
   K2b equal their plain versions to the bit; each timed warm (`ms`, a
   CUDA-graph replay of repeated calls, as K1 and K3) and cold (`cold_ms`,
   `cuda_cold_ms`: the L2 overwritten before every call) beside its bound,
   its plain version and the library's form of the same function (one
   cuSPARSE `torch.addmm` on the block-diagonal complex64 CSR of
   `stencil_to_csr`, itself held against the plain version at atol 1e-4,
   tests/test_pallas_stencil.py:51); then bench.py's chain of 100 applies
   (c <- 0.999 c + 1e-3 r_re) through K2b with exactly 100 K2b launches,
   and through K2c with exactly 100 K2c launches, held against the plain
   chain, with bench.py's seconds per apply, gridpoints/s and nnz/s;
10. `solve_helmholtz_batch` on the stencil operator for the 16 maps of
   datasets/eval256/maps.npz (k^2 and source as phase 7 forms them),
   restart 20, 10 restarts: exactly 1 + 10 x (20 + 2) = 221 K2a launches
   and no other kernel launch, finite and non-increasing (factor
   1 + 1e-3) residual histories ending below their start, the first 3
   cycles within rtol 1e-6 of the same solve with the plain matvec on the
   card; the wall of 3 more solves (median and best); K2a at the
   matvec's own shape (stride-2 complex64 views, no source) against its
   plain version at atol 1e-5, with its instance, timed warm and cold
   beside its bound, its plain version, cuSPARSE and an elementwise pass
   over the same bytes; the 32^2 problem of tests/test_gmres.py:131-153
   against
   scipy's spsolve of `stencil_to_csr` within 5e-3 max|u|; K2's share of
   a solve's device time (torch.profiler);
11. training (`train/loop.Trainer`) at `experiments/base.json`'s full
   width (batch 32, 10 unrolled steps, buffer 600) in 'xla' mode (cuDNN,
   the JAX package's training mode), from the trained weights, on the
   first 640 maps of datasets/splitted_96/trainset.npz: one step's loss
   and every grad leaf on the card against the port's CPU path (4
   experiences; loss rel 1e-3, grads atol 2e-3 max|ref| + rtol 2e-3,
   tests/test_parity.py:182-190); the device buffer's first step against
   the host buffer's on the same draw (loss rel 1e-5); after that step
   every leaf has a finite, nonzero grad and has moved; then two
   device-buffer epochs and one host-buffer epoch (20 steps each) with
   finite losses and grad norms, the curriculum going from 1 to 21
   iterations, evolved experiences re-admitted in the second epoch, every
   leaf moved, and no launch of K1, K2a-c or K3; the wall of a train step
   (median of 5 after the first), device time, busy share and busiest
   kernels over 5 steps (torch.profiler), the peak memory of a step with
   remat off and on, and `cli/train --smoke` on the card;
12. the classical 2D solvers with the trained tpu_r2c weights
   (trained_models/tpu_r2c_best.npz), K1 in every learned part and K2a in
   the deflated solve on the stencil operator, each path's launches counted
   from 0: (a) a 'pallas' rollout of the first 4 maps of
   datasets/eval256/maps.npz, 100 iterations, exactly 14 x 100 K1
   launches, every rmse falling by CONV_FACTOR or more and the first 4
   within rtol 0.05 of the CPU path; (b) `solve_hybrid` on the first 8
   maps of the 96^2 test set (100 learned iterations, restart 50), with the
   bare and the CSLP polish: exactly 14 x 100 K1 launches each, the warm
   rmse equal to the rollout's best, reported residuals equal to the true
   ones (rtol 1e-3; the CSLP polish at tests/test_hybrid.py:101's
   tolerance) and none above the warm start's; (c) `solve_fgmres_learned`
   on map 0 (inner 20, restart 10, tol 1e-5) with the device and the host
   cycle: exactly 14 x 20 K1 launches per preconditioner application, the
   final residual equal to the true one (rtol 1e-3), no history rising, and
   both cycles reaching the tolerance at the same solution (2e-2 max|u|);
   (d) `solve_auto` on tests/test_solve_auto.py's strong-contrast 512^2
   map: the two-level plan with the learned smoother, AUTO_CYCLES outer
   cycles, exactly 14 x 20 K1 launches per smoother application, the
   residual falling at every cycle and the last equal to the true one;
   (e) `solve_helmholtz_deflated` on the order-4 stencil operator for map 0
   of datasets/eval256 (restart 30, k 10): exactly one K2a launch per
   matvec and no other launch, the first cycle within rtol 1e-6 of the
   plain matvec's, the last residual equal to the true one; (f) `cli/solve`
   on the 96^2 test set with the npz, rc 0 and the learned plan. Each of
   (b)-(e) is timed: the wall of a solve after the counted one,
   and one profiled solve's device time, busy share and busiest kernels;
13. serving and the remaining 2D entry points with the tpu_r2c weights on
   the default config at full width and depth: (a) K1 against its plain
   version at each of a served step's 14 calls, batch 8 at 96^2 and 256^2
   (atol 2e-2 max|ref|, as phase 3); `SolverService` with
   `ServeConfig()`'s defaults ('pallas' mode, K1), warmed up at 96^2 and
   256^2, then a burst of 64 requests from 8 client threads (the first 48
   test maps at 96^2 and the 16 maps of datasets/eval256 at 256^2, 4 of
   them with a source location, 500 iterations each): every future
   resolves, no request fails, `completed` and `by_size` as sent, exactly
   14 x 500 K1 launches a batch, every request's best rmse at or below
   its first over 20; requests/s, p50/p95 latency, occupancy, padded slots
   and the wall of each batch; then one batch of each bucket, taken whole
   while the worker is busy, equal to a direct `IterativeSolver.forward`
   of the same padded stack and sources (rtol 1e-6, with cuDNN's
   deterministic algorithms) and its first 4 rmse within rtol 0.05 of an
   'xla' (cuDNN f32) forward of that stack, and a profile of a 96^2
   batch; (b)
   `python -m helmnet_tpu_torch.cli.serve` as a subprocess on port 0: /healthz, /solve (one 96^2 map, 100 iterations) and /stats
   answer 200, the wavefield is finite [96, 96, 2] with a falling rmse,
   and the server exits when terminated; (c) `cli/example`'s
   `simple_scattering` (256^2, 100 iterations, K1): exactly 1400 K1
   launches, finite falling rmse, the first 4 within rtol 0.05 of the CPU
   path; the CLI itself where matplotlib is installed; (d)
   `compare_solvers` on tests/test_harness.py's 96^2 slab ('xla' mode,
   200 iterations, CSLP-GMRES(50) x 20): l_inf, rmse and the model's
   traces within 5% of the CPU path, GMRES's residual down by 1e4;
   (e) `solve_cw` on tests/test_timedomain.py's two 64^2 problems
   (roundtrips 30) against a float64 dense Helmholtz solve within 0.03
   and 0.06; (f) a seeded resnet (depth 3, features 8) 96^2 x 8 x 50
   rollout (cuDNN f32), no hand-kernel launch, the first 4 rmse within
   rtol 1e-3 of the CPU path;
14. the 3D path (`solvers3d_phase`, callable alone: it needs no build,
   since the JAX package has no 3D Pallas kernel and no hand kernel runs
   here), every path's K1-K3 and K2a-c counts from 0 and required to stay
   0: (a) `helmholtz_residual3d` at 2 x 48^3 and 2 x 64^3, matmul against
   fft and the card against the CPU within 2e-5 max|ref|
   (tests/test_spectral3d.py:39), each mode timed; (b) `IterativeSolver3D`
   at full width and depth with trained_models/tpu3d_a_ep80.npz on the 16
   volumes of datasets/val3d/tpu3d_a_val.npz (48^3) and
   trained_models/tpu3d_het_ep49.npz on datasets/val3d/tpu3d_het_val.npz
   (64^3), 400 iterations with the fixed and the seed-99 random sources of
   tools/eval3d_trained.py: finite rmse and a median reduction (source rms
   over best rmse) of at least 100x for each model and source kind
   (TRAINING3D.md's bar), gridpoints/s, peak memory and a profile of 20
   steps; for tpu3d_a also the first 4 rmse of 2 volumes within rtol 1e-3
   of the CPU path, chunks of 100 equal to one run (rtol 1e-5) and the
   sub-pixel up convs against the dilated ones at one call (rtol 1e-5,
   atol 1e-6, tests/test_model3d.py:79-80), both under cuDNN's
   deterministic algorithms; (c) CSLP `solve_helmholtz3d` (restart 20, 40
   cycles, tol 1e-6) on volume 0 with the fixed source: the reported
   residual equal to the true one (rtol 2e-2) and 14b's best field within
   0.02 of it (PML-cropped relative l_inf); `solve_helmholtz3d_batch` on 4
   volumes equal to their single solves within 1e-3 max|u|; (d)
   `solve_fgmres_two_level3d` on tests/test_twolevel3d.py's 48^3 block
   problem with the CSLP and the tpu3d_a learned smoother, device and host
   cycles: the last reported residual equal to the true one (rtol 1e-3)
   and both cycles' solutions within 2e-2 max|u|; (e) `solve_cw3d` on
   tests/test_timedomain3d.py's two 48^3 problems against CSLP-GMRES
   (0.05, 0.08) and `solve_cw3d_chunked(37)` equal to `solve_cw3d` at 16^3
   (rtol 2e-5, atol 2e-6); (f) `solve_auto` on a 48^3 contrast-1 cube (the
   `cslp3d` plan, to its tolerance) and on a 64^3 contrast-4 block (the
   `two_level3d` plan, 3 cycles, falling), and `cli/solve` on a 3D npz
   without `--source-npz` as a subprocess; (g) `Trainer3D` at the tpu3d_a
   run's settings (48^3, buffer 96, batch 8, 10 unrolled, lr 1e-3,
   p_random_source 0.5, remat) from the tpu3d_a weights on 96 volumes of
   `make_dataset3d(seed=0)`: one step's loss and grads against the CPU
   path at 2 experiences x 2 unrolled (phase 11's bounds), remat on
   against off at 8 x 3 unrolled (rtol 1e-5, cuDNN deterministic), one
   epoch of 12 steps finite with every leaf moved, the step's wall
   (median of 5 after the first), a profiled step and the peak memory
   with remat at 10 unrolled and without at 3;
15. distribution (`distribution_phase`) on an NCCL process group of world
   size 1 (their multi-rank behaviour is held against the JAX package on
   gloo ranks by tests/test_torch_distributed.py): (a) the halo-exchanged
   stencil residual (8 x 256^2, order 4) and its norm, (b) the slab-FFT
   residual, (c) the z-slab 3D residual (2 x 48^3) in all three methods,
   each timed, and its norm, each against the unsharded function within
   1e-5 (norms 1e-6) of max|ref| (tests/test_stencil_distributed.py:81,
   89, tests/test_slab3d.py:52); (d) `put_global` / `fetch_global` round
   trips, equal; (e) a data=1 mesh `Trainer` against the plain one over an
   epoch of 3 steps (experiments/base.json, batch 32, 96 maps) under
   cuDNN's deterministic algorithms: loss, every param and the written-back
   wavefields within 1e-6 of max|ref|; no hand-kernel launch;
16. the last modules (`last_slice_phase`): (a) `produce_figures --skull`'s
   solve, `skull_example_problem(512)` with its arc source, the tpu_r2c
   weights on the default config in 'pallas' mode, 3000 iterations: K1
   against its plain version at the 14 calls of a 512^2 step (atol 2e-2
   max|ref|), exactly 14 x 3000 K1 launches, the first 4 rmse within rtol
   0.05 of a cuDNN f32 forward, the best iterate finite and at most the
   first rmse over 5 (the model diverges on this problem after its best
   iterate, on K1 and cuDNN alike), wall, gridpoints/s and a 20-step
   profile; (b) `produce_figures`' compute path without drawing: 2
   generated maps at 96^2, 200 iterations, `compare_solvers` and the f64
   `solve_helmholtz_refined` truth, every l_inf finite and the learned
   one against the truth below 1e-3, no hand-kernel launch; (c) the
   sanitizers: `checked` around a 'pallas' rollout (8 test maps, 10
   steps) equal to the unchecked one to the bit under cuDNN's
   deterministic algorithms (exactly 140 K1 launches) and its wall
   overhead, a NaN in K1's input named by K1, `Trainer(sanitize=True)`
   equal to `sanitize=False` on a clean step and, on a poisoned one,
   raising with params and Adam state unchanged, `solve_helmholtz_checked`
   on the order-4 stencil at 96^2 equal to the unchecked solve (221 K2a
   launches) and a NaN medium named by K2a; (d) `dryrun.entry()` on the
   card within 1e-5 of the CPU, and `dryrun_multichip(1)` on an NCCL
   group of world size 1;
17. the grid split over y and x, its single-card end at 1024^2
   (`split_grid_phase`; the multi-rank behaviour is held against the JAX
   package on gloo ranks by tests/test_torch_spatial_cases.py): (a)
   `helmholtz_residual` in fft against matmul mode at 4 x 1024^2 within
   1e-5 max|ref|, each mode's device ms, and `laplacian(mode='fft',
   spatial=)` on an NCCL mesh of world size 1 with its input gradient
   against the unsplit `laplacian_fft` (1e-5 max|ref|) and the autograd
   all-to-all the identity both ways; (b) the 1024^2 train step of
   TRAINING1024.md (experiments/base.json at 1024^2, the source location
   scaled, buffer 24, batch 2 x 2 unrolled, remat, lr 3e-4, device
   buffer, `make_dataset(24, 1024, seed=42)`, 'auto' resolving to fft) for
   3 steps: every loss finite and step 1 within rel 1e-4 of the same step
   with the matmul operator (cuDNN deterministic), wall per step, peak
   memory and a 2-step profile, no hand-kernel launch; (c) a rollout of 4
   maps x 1024^2 x 50 with the tpu_r2c weights in 'pallas' mode on the
   fft operator: K1 against its plain version at the 14 calls of a 1024^2
   step (each timed beside its plain version and bound), exactly 14 x 50
   K1 launches, the first 4 rmse within rtol 0.05 of a cuDNN f32 forward,
   gridpoints/s and a 10-step profile; K1's 14 calls are also timed beside
   the cuDNN f32 DoubleConv (phase 5's library form);
18. the CSLP preconditioner on the split grid at 1024^2
   (`cslp_split_phase`; the multi-rank behaviour is held against the JAX
   package on gloo ranks by tests/test_torch_spatial_cases.py), on an
   NCCL mesh of world size 1: `make_shifted_laplace_inverse(...,
   spatial=)` against the unsplit inverse on a seeded field within 1e-5
   max|ref|; `solve_helmholtz(..., precond='shifted_laplace')`, GMRES(20)
   x 10 at tol 1e-6, with the fft operator on the first map of
   `make_dataset(24, 1024, seed=42)` and 17b's source, through `spatial=`
   and without, and unpreconditioned: every true relative residual
   finite, the split and unsplit histories within a factor 2 at every
   cycle, the preconditioned final residual below the unpreconditioned
   one, the reported final residual within rtol 1e-3 of one recomputed
   with the matmul operator, no hand-kernel launch; each solve's wall and
   the split solve's device time and busy share.

Needs one card. Without one, or without the package beside it, it exits
non-zero before printing any result. A watchdog ends a hung run with a
traceback. The last line is the JSON device record.
"""

import faulthandler
import sys
import time

faulthandler.dump_traceback_later(1000, exit=True)
T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense), at the full 700 W
# power limit: bf16 products on the tensor cores (the DoubleConv's taps
# and operands are bf16, its sums f32), f32 outside the tensor cores (the
# rate the kernel's CUDA-core design can reach) and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

BATCH, GRID, ITERS = 32, 96, 500
PROFILE_STEPS = 50
PACK_G, PACK_GRID, PACK_ITERS = 16, 256, 50  # bench.py:234 grid_256_packed
PACK_PROFILE_STEPS = 10
WIDE_STEPS = (32, 64)  # 6b: K3's wide instances at the packed step of each g
WIDE_ITERS = 10  # 6b: calls a CUDA graph holds, per time
WIDE_G, WIDE_MAPS, WIDE_PROFILE_STEPS = 32, 32, 5  # 7b: rollout_packed at g = 32
DIST_GRID, DIST_GRID3D = 256, 48  # 15a-c
DIST_RTOL = 1e-5  # 15a-c: * max|ref|; test_stencil_distributed.py:81, test_slab3d.py:52
DIST_NORM_RTOL = 1e-6  # 15a, 15c: test_stencil_distributed.py:89
DIST_TRAIN_MAPS = 96  # 15e: 3 steps of 32 (experiments/base.json's batch)
DIST_TRAIN_RTOL = 1e-6  # 15e: * max|ref|, data=1 mesh against the plain Trainer
SPMV_N, SPMV_B, SPMV_APPLIES = 512, 8, 100  # bench.py:259 stencil_spmv_512
K2_ATOL = {"K2a": 1e-5, "K2b": 1e-5, "K2c": 2e-4}  # test_pallas_stencil.py:35,90,116
GMRES_RESTART, GMRES_CYCLES = 20, 10
# K2a repeats its plain version's roundings and the rest of the solve is
# the same ops, so the gap measured on an H100 was 0; 1e-6 leaves room for
# a reduction that the library orders otherwise
GMRES_PLAIN_CYCLES, GMRES_PLAIN_RTOL = 3, 1e-6
MONOTONE_SLACK = 1e-3  # restarted GMRES never rises, up to f32 round-off
SCIPY_ATOL = 5e-3  # * max|u|, tests/test_gmres.py:153
CSR_ATOL = 1e-4  # stencil_to_csr @ u against the kernel, test_pallas_stencil.py:51
GMRES_TIMED = 3  # warm solves timed after the counted one
XLA_RTOL = 1e-3  # packed against unpacked, both f32 (the port tests' rtol)
KERNEL_RTOL = 2e-2  # atol = KERNEL_RTOL * max|ref| (test_pallas_pixconv.py:36)
EARLY_RTOL = 0.05  # bf16 kernel vs f32 path, first 4 rmse (:125-127)
LATE_FACTOR = 1.5  # rmse at the last iteration (tests/test_parity.py:94)
TRAIN_MAPS = 640  # 20 batches of 32 an epoch
TRAIN_CPU_BATCH = 4  # experiences of the step held against the CPU path
TRAIN_LOSS_RTOL = 1e-3  # tests/test_parity.py:182-190: loss rel 1e-3,
TRAIN_GRAD_RTOL = 2e-3  # each grad leaf atol 2e-3 * max|ref|, rtol 2e-3
TRAIN_BUFFER_RTOL = 1e-5  # device vs host buffer (test_device_buffer.py:78)
TRAIN_TIMED, TRAIN_PROFILE_STEPS = 5, 5
R2C_NPZ = "trained_models/tpu_r2c_best.npz"  # checkpoints/tpu_r2c, best step
CONV_MAPS, CONV_ITERS = 4, 100  # 12a: the first maps of datasets/eval256
CONV_FACTOR = 30.0  # 12a: first rmse over the last, per map; 33.71 at worst on an H100
HYBRID_MAPS, HYBRID_LEARNED = 8, 100  # 12b: solve_hybrid's default iterations
FGMRES_INNER, FGMRES_RESTART, FGMRES_TOL = 20, 10, 1e-5  # 12c
AUTO_GRID, AUTO_CONTRAST = 512, 1.0  # 12d: tests/test_solve_auto.py's _sos(512, 1.0)
AUTO_CYCLES = 3  # 12d: outer cycles (max_restarts), to stay inside the time limit
DEFL_RESTART, DEFL_K = 30, 10  # 12e
RELRES_RTOL = 1e-3  # reported against true residual, tests/test_fgmres.py:56
SOLUTION_ATOL = 2e-2  # * max|u|: two FGMRES solutions, tests/test_fgmres.py:73
# reported against the float64 true residual of the CSLP polish, whose
# defect correction rounds b - A x0 once: tests/test_hybrid.py:101
HYBRID_CSLP_RTOL, HYBRID_CSLP_ATOL = 5e-2, 1e-6
CLASSICAL_TIMED = 1  # 12b-e: solves timed after the counted one (one: the time limit)
SERVE_96, SERVE_256, SERVE_CLIENTS = 48, 16, 8  # 13a's burst: requests, clients
SERVE_LOCS = ((60, 128), (128, 60), (128, 196), (200, 128))  # 13a: 256^2 sources
SERVE_RMSE_FACTOR = 20.0  # 13a: rmse[0] / best_rmse per request, 12a's bound
SERVE_EXACT_RTOL = 1e-6  # 13a: a served batch against a direct forward
EXAMPLE_ITERS = 100  # 13c: cli/example's default
CMP_RTOL = 0.05  # 13d: compare_solvers on the card against the CPU path
CW_GRID, CW_ROUNDTRIPS = 64, 30  # 13e: tests/test_timedomain.py:44-53
RESNET_ITERS, RESNET_RTOL = 50, 1e-3  # 13f: cuDNN f32 against the CPU, first 4 rmse
MODELS_3D = {  # 14b: the trained 3D models, their validation volumes, their grid
    "tpu3d_a": ("trained_models/tpu3d_a_ep80.npz", "datasets/val3d/tpu3d_a_val.npz", 48),
    "tpu3d_het": ("trained_models/tpu3d_het_ep49.npz", "datasets/val3d/tpu3d_het_val.npz",
                  64),
}
ITERS_3D = 400  # 14b: tools/eval3d_trained.py's rollout
REDUCTION_3D = 100.0  # 14b: source rms over best rmse, median; TRAINING3D.md's bar
PROFILE_STEPS_3D = 20
OP3D_RTOL = 2e-5  # 14a: * max|ref|, tests/test_spectral3d.py:39
CPU3D_RTOL = 1e-3  # 14b: first 4 rmse against the CPU path
CHUNK_3D, CHUNK_RTOL = 100, 1e-5  # 14b: chunks against one run, tests/test_model3d.py:106-112
UP_RTOL, UP_ATOL = 1e-5, 1e-6  # 14b: subpixel against dilated, tests/test_model3d.py:79-80
CSLP3D_RESTART, CSLP3D_CYCLES, CSLP3D_TOL = 20, 40, 1e-6  # 14c
CSLP3D_TRUE_RTOL = 2e-2  # 14c: reported against true, tests/test_spectral3d.py:113
ANCHOR_3D = 0.02  # 14c: PML-cropped rel l_inf, learned against CSLP-GMRES
BATCH3D_RTOL = 1e-3  # 14c: batched against single solves, * max|u|
AUTO3D_CYCLES = 3  # 14f: outer cycles of the two-level plan on the 64^3 cube
REMAT_RTOL = 1e-5  # 14g: remat on against off, loss and each grad leaf
TRAIN3D_PROFILE_STEPS = 1
SKULL_GRID, SKULL_ITERS = 512, 3000  # 16a: produce_figures --skull
SKULL_PROFILE_STEPS = 20
SKULL_DROP = 5.0  # 16a: the best rmse at most the first over this
FIG_MAPS, FIG_ITERS = 2, 200  # 16b: produce_figures' flow at the default 96^2
FIG_LINF = 1e-3  # 16b: learned l_inf against the f64 truth, PML-cropped
SANITIZE_MAPS, SANITIZE_ITERS = 8, 10  # 16c
DRYRUN_RTOL = 1e-5  # 16d: dryrun.entry() on the card against the CPU
SPLIT_GRID, SPLIT_OP_BATCH = 1024, 4  # 17: the grid where 'auto' takes the fft operator
SPLIT_RTOL = 1e-5  # 17a: * max|ref|, fft against matmul, split against unsplit
SPLIT_TRAIN = dict(buffer_size=24, train_batch_size=2, unrolling_steps=2, remat=True,
                   learning_rate=3e-4)  # 17b: TRAINING1024.md's run
SPLIT_TRAIN_STEPS = 3
SPLIT_TRAIN_RTOL = 1e-4  # 17b: step 1 against its matmul twin (phase 11's bound)
SPLIT_MAPS, SPLIT_ITERS, SPLIT_PROFILE_STEPS = 4, 50, 10  # 17c
CSLP_RESTART, CSLP_CYCLES, CSLP_TOL = 20, 10, 1e-6  # 18: the CSLP solves at 1024^2
CSLP_RTOL = 1e-5  # 18: * max|ref|, the split inverse against the unsplit one
CSLP_HISTORY = 2.0  # 18: split against unsplit true residual, at every cycle


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int = 50, graph: bool = True) -> float:
    """Mean device time of fn() in ms: CUDA events around the replay of a
    CUDA graph that holds `iters` calls, so no host time falls between
    the launches. Warmed up on a side stream before capture. With
    graph=False the events bracket `iters` eager calls instead (for
    library calls that are not known to be safe to capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not graph:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        for _ in range(iters):
            fn()
    cuda_graph.replay()
    start.record()
    cuda_graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_cold_ms(fn, iters: int = 50) -> float:
    """Mean device time of fn() in ms with a cold L2: one CUDA graph holds
    `iters` x (a write over a buffer of twice the L2's size, then fn()),
    another `iters` x the write alone, both captured on one stream; the
    difference of their replays (CUDA events, after a warm-up replay) per
    call, the median of 3 such pairs. fn() then reads its inputs from
    device memory, as a caller whose data was swept out by other work
    finds them."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    flush = torch.empty(2 * l2 // 4 + 1, dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            flush.fill_(1.0)
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for with_fn in (True, False):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                flush.fill_(1.0)
                if with_fn:
                    fn()
        graphs.append(graph)
    for graph in graphs:
        graph.replay()
    diffs = []
    for _ in range(3):
        times = []
        for graph in graphs:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        diffs.append((times[0] - times[1]) / iters)
    del graphs, flush
    return float(np.median(diffs))


def profile_steps(run, steps: int) -> dict:
    """Where a rollout's time goes: the wall per step of `run(steps)` on
    the host clock without the profiler, then the same steps traced with
    torch.profiler for the device time per step, the device's busy share
    (device time over that wall) and the busiest kernels. Only the device
    activity is traced: the CPU ops would carry the same time again, and
    processing their events took the profiler minutes on the Krylov
    solves (about 4x the device-only time on an H100's host, the same
    device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt) -> float:
        return float(getattr(evt, "self_device_time_total", 0.0)
                     or getattr(evt, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    t = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    # device-side events (kernels, copies, memsets)
    kernels = sorted(
        ((e.key, device_us(e), e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and device_us(e) > 0),
        key=lambda k: -k[1],
    )
    device_ms = sum(k[1] for k in kernels) / 1e3
    return {
        "wall_ms_per_step": 1e3 * wall_s / steps,
        "device_ms_per_step": device_ms / steps,
        "busy_share": device_ms / (1e3 * wall_s),
        "top": [{"name": n[:80], "device_ms_per_step": us / 1e3 / steps,
                 "calls_per_step": c / steps} for n, us, c in kernels[:12]],
        "device_ms_by_name": {n: us / 1e3 / steps for n, us, _ in kernels},
    }


@contextlib.contextmanager
def world_of_one(dev):
    """A torch.distributed process group of world size 1 on `dev` (NCCL on
    a card) at a free localhost port; yields its backend and destroys the
    group on the way out."""
    import socket

    from helmnet_tpu_torch.distributed import multihost

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"localhost:{port}", 1, 0, device=dev)
    try:
        yield torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()


def ptxas_table(log: str) -> list[dict]:
    """One row per instance of K1, K3 and K2 from nvcc's -Xptxas -v lines:
    its template arguments, registers, static shared memory and spills."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(packed_double_conv|cluster_double_conv"
                      r"|double_conv|stencil_residual)_kernelI((?:Li\d+E)+)E", line)
        if m:
            cur = {"kernel": {"packed_double_conv": "K3", "cluster_double_conv": "K3",
                              "double_conv": "K1",
                              "stencil_residual": "K2"}[m.group(1)],
                   "wide": m.group(1) == "cluster_double_conv",
                   "args": [int(a) for a in re.findall(r"Li(\d+)E", m.group(2))],
                   "spill_stores": 0, "spill_loads": 0, "smem": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
            rows.append(cur)
            cur = None
    return rows


def step_calls(params, model, n: int):
    """The 14 DoubleConv calls of one solver step: (name, params, grid,
    input part channels)."""
    f, sc, depth = model.features, model.state_channels, model.depth
    calls = [("inc", params["inc"], n, (model.in_channels,))]
    for d in range(depth):
        blk = params["enc"][d]
        calls.append((f"enc[{d}].conv_signal", blk["conv_signal"], n >> d, (f, sc)))
        calls.append((f"enc[{d}].conv_state", blk["conv_state"], n >> d, (f, sc)))
    calls.append((f"decode[{depth}]", params["decode"][depth], n >> depth, (f,)))
    for d in range(depth - 1, 0, -1):
        calls.append((f"decode[{d}]", params["decode"][d], n >> d, (f, f)))
    post = dict(params["decode"][0], post=params["outc"])
    calls.append(("decode[0]+outc", post, n, (f, f)))
    return calls


def bound(p, parts, out) -> tuple[float, float, float, float]:
    """(flops, ops_ms, bytes_ms, cuda_core_ms) of one call: operations at
    the bf16 tensor-core peak, and each input read once and each output
    written once at the HBM rate; the bound is the larger of the two.
    cuda_core_ms is the same operations at the f32 CUDA-core peak, the
    ceiling of a kernel that runs its FMAs there."""
    b, h, w, _ = out.shape
    cin = sum(t.shape[-1] for t in parts)
    cm, co = p["c1"]["w"].shape[0], p["c2"]["w"].shape[0]
    macs = cin * cm * 9 + cm * co * 9
    if "post" in p:
        macs += co * p["post"]["w"].shape[0]
    flops = 2.0 * b * h * w * macs
    weights = sum(t.numel() for v in p.values() for t in v.values())
    nbytes = 4.0 * (sum(t.numel() for t in parts) + out.numel() + weights)
    return (flops, 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_S,
            1e3 * flops / PEAK_F32_FLOPS)


def packed_step_calls(kparams, model, n: int):
    """The 14 K3 calls of one packed step, from the params that
    `prepare_k3` made: (name, prepared weights, grid, part channels)."""
    from helmnet_tpu_torch.models.packed import K3_KEY

    depth = model.depth
    sites = [("inc", kparams["inc"], n)]
    for d in range(depth):
        blk = kparams["enc"][d]
        sites.append((f"enc[{d}].conv_signal", blk["conv_signal"], n >> d))
        sites.append((f"enc[{d}].conv_state", blk["conv_state"], n >> d))
    sites.append((f"decode[{depth}]", kparams["decode"][depth], n >> depth))
    for d in range(depth - 1, 0, -1):
        sites.append((f"decode[{d}]", kparams["decode"][d], n >> d))
    sites.append(("decode[0]+outc", kparams["decode"][0], n))
    return [(name, p[K3_KEY], grid,
             tuple(int(w.shape[1]) for w in p[K3_KEY].params["c1"]["w"]))
            for name, p, grid in sites]


def packed_bound(pw, parts, out) -> tuple[float, float, float, float]:
    """`bound` for one K3 call: every product of the dense packed convs
    (the kernel does not skip the block-diagonal zeros), and the bytes of
    the f32 inputs and output, the bf16 weights and the f32 biases."""
    b, h, w, _ = out.shape
    macs = pw.cin * pw.cm * 9 + pw.cm * pw.co * 9 + pw.co * pw.ce
    flops = 2.0 * b * h * w * macs
    nbytes = (4.0 * (sum(t.numel() for t in parts) + out.numel())
              + 2.0 * macs + 4.0 * (pw.cm + pw.co + pw.ce + 1))
    return (flops, 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_S,
            1e3 * flops / PEAK_F32_FLOPS)


def k3_design_bytes(pw, tiles: int) -> int:
    """The weight bytes a K3 call reads from L2 if each of its `tiles`
    output tiles reads the prepared w1, w2 and w3 once (a cluster's CTAs
    each their slice): a model of the design, not a measured count."""
    return tiles * sum(2 * w.numel() for w in (pw.w1, pw.w2, pw.w3) if w is not None)


def stencil_bound(radius: int, b: int, h: int, w: int,
                  with_s: bool) -> tuple[float, float, float, float]:
    """(bytes, flops, bytes_ms, ops_ms) of one fused stencil residual:
    u (2 planes), k^2, s (2, when given) read once and r (2) written once,
    plus the tap tables ([2r+1, W] and [2r+1, H], re and im); 16 flops per
    tap and point (a complex multiply-add on each axis) and 4 for
    k^2 u - s, at the f32 CUDA-core peak. K2c computes the same function
    (its band matrices hold the tables' values) and launches the same
    kernel with the tables, so its bound is the same."""
    points = b * h * w
    planes = 2 + 1 + (2 if with_s else 0) + 2
    tables = 2 * (2 * radius + 1) * (h + w)
    nbytes = 4.0 * (planes * points + tables)
    flops = float(points) * (16 * (2 * radius + 1) + 4)
    return nbytes, flops, 1e3 * nbytes / PEAK_BYTES_S, 1e3 * flops / PEAK_F32_FLOPS


def stencil_csr(op, k_sq: torch.Tensor) -> torch.Tensor:
    """The stencil operator plus diag(k^2) of every plane of k_sq
    [B, H, W] as one block-diagonal complex64 CSR matrix on the card,
    int32 indices: the library (cuSPARSE) form of the function K2
    computes, for its `library_ms`. Built on the host with scipy from
    `stencil_to_csr`; the port never calls it."""
    import scipy.sparse as sp

    from helmnet_tpu_torch.ops.stencil_residual import stencil_to_csr

    blocks = sp.kron(sp.identity(k_sq.shape[0], format="csr"),
                     stencil_to_csr(op), format="csr")
    m = (blocks + sp.diags(k_sq.detach().cpu().numpy().astype(np.complex128)
                           .ravel())).tocsr()
    m.sort_indices()
    return torch.sparse_csr_tensor(
        torch.from_numpy(m.indptr.astype(np.int32)),
        torch.from_numpy(m.indices.astype(np.int32)),
        torch.from_numpy(m.data.astype(np.complex64)),
        size=m.shape, check_invariants=True).to(k_sq.device)


def hand_kernel_counts() -> tuple:
    """(K2a, K2b, K2c, K1, K3) launches since the last `reset_counts()`."""
    from helmnet_tpu_torch.ops import stencil_residual as sr
    from helmnet_tpu_torch.ops.double_conv import fused_double_conv
    from helmnet_tpu_torch.ops.packed_double_conv import packed_double_conv

    return (sr.residual_planes.launches, sr.residual_planes_tiled.launches,
            sr.residual_planes_mxu.launches, fused_double_conv.launches,
            packed_double_conv.launches)


def reset_counts() -> None:
    from helmnet_tpu_torch.ops import stencil_residual as sr
    from helmnet_tpu_torch.ops.double_conv import fused_double_conv
    from helmnet_tpu_torch.ops.packed_double_conv import packed_double_conv

    sr.reset_launches()
    fused_double_conv.launches = packed_double_conv.launches = 0


def train_phase(dev, cfg, params, hand_kernels) -> dict:
    """Phase 11: the unsupervised training path on the card, in 'xla' mode
    (cuDNN convs, the JAX package's training mode), from the trained
    weights, on the first TRAIN_MAPS maps of the 96^2 train set. Every gate
    failure exits; the returned dict holds what was measured.
    `hand_kernels()` reads the launch counts of K1, K2a-c and K3."""
    import contextlib
    import io
    import tempfile

    from helmnet_tpu_torch.cli import train as train_cli
    from helmnet_tpu_torch.data.ellipses import load_maps
    from helmnet_tpu_torch.models.hybridnet import iter_leaves, map_leaves
    from helmnet_tpu_torch.train.device_buffer import FIELDS
    from helmnet_tpu_torch.train.loop import Trainer, unrolled_loss
    from helmnet_tpu_torch.train.replay import ExperienceBatch

    t0 = time.perf_counter()
    if cfg.model.double_conv_mode != "xla":
        fail("training runs in 'xla' mode")
    tc = cfg.training
    bs, unroll = tc.train_batch_size, tc.unrolling_steps
    maps = load_maps(cfg.medium.train_set)[:TRAIN_MAPS]

    def grads_of(p, op, batch):
        leaves = [t for _, t in iter_leaves(p)]
        loss, _ = unrolled_loss(p, op, batch, cfg=cfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    # the card against the port's CPU path: loss and grads of one step
    host = Trainer(cfg, params=params, device=dev)
    host.fill_buffer(maps)
    idx = np.random.default_rng(7).choice(tc.buffer_size, TRAIN_CPU_BATCH, replace=False)
    rows = [getattr(host.buffer, k)[idx] for k in FIELDS]
    card_batch = ExperienceBatch(*(torch.as_tensor(a, device=dev) for a in rows), idx)
    cpu_batch = ExperienceBatch(*(torch.as_tensor(a) for a in rows), idx)
    cpu_params = map_leaves(params, lambda _, t: t.detach().cpu().requires_grad_(True))
    card_loss, card_grads = grads_of(host.params, host.op, card_batch)
    cpu_loss, cpu_grads = grads_of(cpu_params, host.op.to("cpu"), cpu_batch)
    loss_gap = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    worst = 0.0  # max over leaves of |card - cpu| / (atol + rtol |cpu|)
    for (path, _), g, r in zip(iter_leaves(params), card_grads, cpu_grads):
        g = g.cpu()
        limit = TRAIN_GRAD_RTOL * (r.abs().max() + r.abs())
        worst = max(worst, float(((g - r).abs() / limit).max()))
    log(f"phase 11 one step ({TRAIN_CPU_BATCH} experiences x {unroll} unrolled "
        f"steps) on the card against the CPU path: loss {float(card_loss):.6e} / "
        f"{float(cpu_loss):.6e}, rel diff {loss_gap:.3e} (rtol {TRAIN_LOSS_RTOL}); "
        f"grads at {worst:.3f} of atol {TRAIN_GRAD_RTOL}*max|ref| + rtol "
        f"{TRAIN_GRAD_RTOL}")
    if not loss_gap <= TRAIN_LOSS_RTOL or not worst <= 1.0:
        fail("a training step on the card disagrees with the CPU path")

    # the device buffer against the host buffer: the first step on one draw
    dbuf = Trainer(cfg, params=params, device=dev, device_buffer=True)
    dbuf.fill_buffer(maps)
    before = {p: t.detach().clone() for p, t in iter_leaves(dbuf.params)}
    mh, _ = host._train_step(card_batch, 1)
    zeros = torch.zeros(TRAIN_CPU_BATCH, dtype=torch.long, device=dev)
    md = dbuf._mega_step(dbuf._dev_buf, dbuf.op, dbuf.src_pool, dbuf._sos_pool,
                         torch.as_tensor(idx, device=dev), zeros, zeros, 1,
                         cfg.max_iterations)
    buf_gap = abs(float(md["loss"]) - float(mh["loss"])) / abs(float(mh["loss"]))
    log(f"phase 11 device buffer against host buffer, first step: loss rel diff "
        f"{buf_gap:.3e} (rtol {TRAIN_BUFFER_RTOL})")
    if not buf_gap <= TRAIN_BUFFER_RTOL:
        fail("the device-buffer step disagrees with the host-buffer step")
    # guard against a weight left out of autograd: after step 1 every leaf
    # has a finite, nonzero grad and has moved
    for path, t in iter_leaves(dbuf.params):
        g = t.grad
        if g is None or not bool(torch.isfinite(g).all()) or not bool(g.any()):
            fail(f"{path} has no finite, nonzero grad after the first step")
        if torch.equal(t.detach(), before[path]):
            fail(f"{path} did not move in the first step")
    log(f"phase 11 after step 1 all {len(before)} leaves have a finite, nonzero "
        f"grad and moved")

    # the main path: two device-buffer epochs, then one host-buffer epoch,
    # with every hand kernel's count set to 0 just before
    train = Trainer(cfg, params=params, device=dev, device_buffer=True)
    train.fill_buffer(maps)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    epochs = [train.training_epoch(maps) for _ in range(2)]
    epochs.append(host.training_epoch(maps))
    torch.cuda.synchronize()
    epochs_s = time.perf_counter() - t
    counts = hand_kernels()
    for i, e in enumerate(epochs):
        log(f"phase 11 epoch {i} ({'host' if i == 2 else 'device'} buffer): "
            f"loss {e['train_loss_mean']:.6e}, mean grad norm "
            f"{e['grad_norm_mean']:.4e}, maxiter {e['maxiter']}, new_sos "
            f"{e['new_sos']} of {len(maps)} draws, {e['epoch_time_s']:.2f} s")
    log(f"phase 11 three epochs of {len(maps) // bs} steps in {epochs_s:.2f} s; "
        f"launches K2a/K2b/K2c/K1/K3 {counts}")
    if any(counts):
        fail(f"training launched a hand kernel: {counts}")
    if not all(np.isfinite(e["train_loss_mean"]) and np.isfinite(e["grad_norm_mean"])
               for e in epochs):
        fail("a training loss or grad norm is not finite")
    if [e["maxiter"] for e in epochs[:2]] != [1, 1 + tc.curriculum_slope]:
        fail("the curriculum did not go from 1 to 21 iterations")
    if not epochs[1]["new_sos"] < len(maps):
        fail("no evolved experience was re-admitted in the second epoch")
    start = dict(iter_leaves(params))
    for path, t in iter_leaves(train.params):
        if torch.equal(t.detach(), start[path].to(dev)):
            fail(f"{path} did not move in two epochs")

    # times: the wall of single steps, then a profile of 5
    maxiter = train.max_allowed_iterations()
    walls = []
    for _ in range(TRAIN_TIMED + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        train.device_step(maxiter)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    step_wall = float(np.median(walls[1:]))
    prof = profile_steps(
        lambda n: [train.device_step(maxiter) for _ in range(n)], TRAIN_PROFILE_STEPS)
    log(f"phase 11 train step ({bs} x {GRID}^2 x {unroll} unrolled): wall "
        f"{1e3 * step_wall:.2f} ms (median of {TRAIN_TIMED} after the first; all "
        f"{[round(1e3 * w, 2) for w in walls]}), {bs * unroll / step_wall:.1f} "
        f"experience-steps/s; profile of {TRAIN_PROFILE_STEPS}: wall "
        f"{prof['wall_ms_per_step']:.2f} ms/step, device "
        f"{prof['device_ms_per_step']:.2f} ms/step, busy share "
        f"{prof['busy_share']:.4f}")
    for k in prof["top"][:5]:
        print(f"    {k['device_ms_per_step']:.4f} ms/step {k['calls_per_step']:6.1f} "
              f"calls/step  {k['name']}", flush=True)

    # peak memory of one host-buffer step, remat off and on
    peaks = {}
    for remat in (False, True):
        rcfg = cfg.replace(training=dataclasses.replace(tc, remat=remat))
        trainer = Trainer(rcfg, params=params, device=dev)
        batch = ExperienceBatch(*(torch.as_tensor(a[:bs], device=dev) for a in (
            getattr(host.buffer, k) for k in FIELDS)), np.arange(bs))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer._train_step(batch, 0)
        torch.cuda.synchronize()
        peaks["on" if remat else "off"] = {
            "max_allocated": torch.cuda.max_memory_allocated(), "before": base}
        del trainer, batch
    log("phase 11 peak memory of one step (batch {}): remat off {:.3f} GiB, on "
        "{:.3f} GiB (allocated before the step: {:.3f} / {:.3f} GiB)".format(
            bs, *(peaks[k]["max_allocated"] / 2**30 for k in ("off", "on")),
            *(peaks[k]["before"] / 2**30 for k in ("off", "on"))))

    # the CLI's smoke run on the card
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as logs, contextlib.redirect_stdout(out):
        rc = train_cli.main(["--smoke", "--log-dir", logs])
    smoke = out.getvalue().strip().splitlines()[-1]
    log(f"phase 11 cli/train --smoke on the card: rc {rc}, {smoke}")
    if rc != 0 or not smoke.startswith("SMOKE PASS"):
        fail("cli/train --smoke failed on the card")
    seconds = time.perf_counter() - t0
    log(f"phase 11 done in {seconds:.1f} s")
    return {
        "maps": len(maps), "batch": bs, "unrolled": unroll,
        "cpu_loss_rel_diff": loss_gap, "cpu_grad_worst": worst,
        "buffer_loss_rel_diff": buf_gap, "epochs": epochs, "epochs_s": epochs_s,
        "hand_kernel_launches": list(counts), "step_walls_s": walls,
        "step_wall_s": step_wall, "experience_steps_per_s": bs * unroll / step_wall,
        "profile": prof, "peak_memory": peaks, "smoke": smoke, "seconds": seconds,
    }


def solve_times(run, short_run, short: str) -> dict:
    """Phase 12's times of a solve: the wall (host clock around a
    synchronised call, the median of CLASSICAL_TIMED calls after the counted
    first one), then `short_run`, the same solve cut short as `short` says
    (a whole solve makes up to a million launches, and tracing them takes
    minutes), once without and once with torch.profiler for its device
    time, busy share and busiest kernels."""
    walls = []
    for _ in range(CLASSICAL_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    prof = profile_steps(lambda _: short_run(), 1)
    return {"wall_s": float(np.median(walls)), "walls_s": walls, "profiled": short,
            "device_ms": prof["device_ms_per_step"], "busy_share": prof["busy_share"],
            "profile_wall_ms": prof["wall_ms_per_step"], "top": prof["top"][:6]}


def log_times(name: str, t: dict) -> None:
    log(f"phase {name} wall {t['wall_s']:.4f} s (median of {CLASSICAL_TIMED} after the "
        f"counted one; {[round(w, 4) for w in t['walls_s']]}); profiled {t['profiled']}: "
        f"device {t['device_ms']:.2f} ms of {t['profile_wall_ms']:.1f} ms wall, busy "
        f"share {t['busy_share']:.4f}")
    for k in t["top"][:4]:
        print(f"    {k['device_ms_per_step']:.3f} ms {k['calls_per_step']:7.0f} calls  "
              f"{k['name']}", flush=True)


def host_relres64(cfg, sos, src, field, warm, op, k_sq, mode):
    """Per map: ||b - A x|| / ||b|| in float64 on the host (the dense
    per-axis operators of solvers/precond._HostOperator), and the f32
    rounding of the defect b - A x0 that a CSLP polish starts from, in
    units of ||b|| (A x0 on the card against float64)."""
    from helmnet_tpu_torch.ops.spectral import helmholtz_residual
    from helmnet_tpu_torch.solvers.precond import _HostOperator

    g = cfg.geometry
    as64 = lambda t: t.detach().cpu().numpy().astype(np.float64)
    cx = lambda a: a[..., 0] + 1j * a[..., 1]
    r_card = as64(helmholtz_residual(op, warm, k_sq, src, mode))
    true, err = [], []
    for i in range(len(sos)):
        h, w = sos[i].shape
        host = _HostOperator(h, w, g.pml_size, g.sigma_max, cfg.k0,
                             (cfg.source.omega / sos[i].astype(np.float64)) ** 2)
        b = cx(as64(src[i]))
        nb = np.linalg.norm(b)
        true.append(np.linalg.norm(b - host(cx(as64(field[i])))) / nb)
        err.append(np.linalg.norm(cx(r_card[i]) - (host(cx(as64(warm[i]))) - b)) / nb)
    return np.asarray(true), np.asarray(err)


def strong_contrast_sos(n: int, contrast: float) -> np.ndarray:
    """The 2D map of tests/test_solve_auto.py:16: sound speed 1 with a
    central block of 1 + contrast * uniform noise (seed 0)."""
    sos = np.ones((n, n), np.float32)
    c = (slice(n // 4, 3 * n // 4),) * 2
    sos[c] = 1.0 + contrast * np.random.default_rng(0).random(sos[c].shape, np.float32)
    return sos


def classical_phase(dev, cfg, cfg_kernel, hand_kernels) -> dict:
    """Phase 12: the classical 2D solvers with the trained tpu_r2c weights,
    K1 ('pallas' mode) inside every learned part and K2a inside the
    deflated solve on the stencil operator. Every gate failure exits; the
    returned dict holds what was measured. `hand_kernels()` reads the
    launch counts of K2a, K2b, K2c, K1 and K3."""
    import contextlib
    import io

    from helmnet_tpu_torch.cli import solve as solve_cli
    from helmnet_tpu_torch.data.ellipses import load_maps
    from helmnet_tpu_torch.models.hybridnet import params_to
    from helmnet_tpu_torch.ops import stencil_residual as sr
    from helmnet_tpu_torch.ops.source import point_source_map
    from helmnet_tpu_torch.ops.spectral import helmholtz_residual, make_operator
    from helmnet_tpu_torch.ops.stencil import make_stencil_operator
    from helmnet_tpu_torch.solvers.auto import choose_solver, solve_auto
    from helmnet_tpu_torch.solvers.deflation import gmres_deflated, solve_helmholtz_deflated
    from helmnet_tpu_torch.solvers.fgmres import solve_fgmres_learned
    from helmnet_tpu_torch.solvers.hybrid import solve_hybrid
    from helmnet_tpu_torch.solvers.iterative import IterativeSolver, rollout
    from helmnet_tpu_torch.weights import load_params_npz

    t0 = time.perf_counter()
    out = {}
    steps = 14  # K1 launches a learned step (phase 4)
    params = load_params_npz(R2C_NPZ, cfg, device=dev)

    def with_grid(c, n):
        return c.replace(geometry=dataclasses.replace(c.geometry, domain_size=n))

    def relres(op, k_sq, src, field, mode) -> np.ndarray:
        """||b - A x|| / ||b|| per sample, on the card with the plain
        spectral operator: field, src [B, H, W, 2], k_sq [B, H, W]."""
        r = helmholtz_residual(op, field, k_sq, src, mode)
        num = torch.linalg.vector_norm(r.reshape(len(r), -1), dim=1)
        return (num / torch.linalg.vector_norm(src.reshape(len(src), -1), dim=1)).cpu().numpy()

    def want_k1(n_launch):
        return (0, 0, 0, n_launch, 0)

    # -- 12a: convergence at 256^2 -------------------------------------------
    cfg256 = with_grid(cfg_kernel, PACK_GRID)
    maps256 = load_maps("datasets/eval256/maps.npz")[:CONV_MAPS]
    solver256 = IterativeSolver(cfg256, params=params, device=dev)
    src256 = solver256.source.expand(CONV_MAPS, -1, -1, -1)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    conv = rollout(params, solver256.op, src256, maps256, cfg=cfg256,
                   num_iterations=CONV_ITERS, device=dev)
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t
    counts = hand_kernels()
    rmse = conv["rmse"].cpu().numpy()
    factor = rmse[0] / rmse[-1]
    cpu = rollout(params_to(params, "cpu"), solver256.op.to("cpu"), src256.cpu(), maps256,
                  cfg=cfg256, num_iterations=4, device="cpu")["rmse"].numpy()
    early = np.abs(rmse[:4] - cpu) / cpu
    log(f"phase 12a tpu_r2c rollout {CONV_MAPS} x {PACK_GRID}^2 x {CONV_ITERS} "
        f"('pallas'): {conv_s:.2f} s, launches K2a/K2b/K2c/K1/K3 {counts}; rmse "
        f"{rmse[0].tolist()} -> {rmse[-1].tolist()}, factor {factor.min():.2f} (worst), "
        f"{factor.mean():.2f} (mean); bound {CONV_FACTOR}; first 4 against the CPU "
        f"path max rel diff {early.max():.3e} (rtol {EARLY_RTOL})")
    if counts != want_k1(steps * CONV_ITERS):
        fail(f"the 256^2 rollout launched {counts}")
    if not np.all(np.isfinite(rmse)) or not factor.min() >= CONV_FACTOR:
        fail("the tpu_r2c rollout at 256^2 does not converge by the stated factor")
    if not early.max() <= EARLY_RTOL:
        fail("the 256^2 rollout on the card disagrees with the CPU path")
    out["convergence_256"] = {"rmse_first": rmse[0].tolist(), "rmse_last": rmse[-1].tolist(),
                              "factor": factor.tolist(), "seconds": conv_s,
                              "cpu_rel_diff": float(early.max()), "k1_launches": counts[3]}

    # -- 12b: solve_hybrid at 96^2 -------------------------------------------
    sos96 = np.load("datasets/splitted_96/testset.npz")["maps"][:HYBRID_MAPS]
    solver96 = IterativeSolver(cfg_kernel, params=params, device=dev)
    op96, mode = solver96.op, cfg_kernel.operator_mode
    src96 = solver96.source.expand(HYBRID_MAPS, -1, -1, -1).contiguous()
    k_sq96 = (cfg.source.omega / torch.tensor(sos96, device=dev)) ** 2
    warm = rollout(params, op96, src96, sos96, cfg=cfg_kernel,
                   num_iterations=HYBRID_LEARNED, collect=("rmse", "best"), device=dev)
    warm_rel = relres(op96, k_sq96, src96, warm["best_wavefield"], mode)
    out["hybrid"] = {}
    for precond in ("none", "shifted_laplace"):
        def run(maps=HYBRID_MAPS):
            return solve_hybrid(params, op96, src96[:maps], sos96[:maps], cfg=cfg_kernel,
                                learned_iterations=HYBRID_LEARNED, precond=precond,
                                device=dev)

        reset_counts()
        res = run()
        torch.cuda.synchronize()
        counts = hand_kernels()
        final = res.final_relres.cpu().numpy()
        if precond == "none":  # the reported norm is ||b - A x|| itself
            true = relres(op96, k_sq96, src96, res.wavefield, mode)
            limit = RELRES_RTOL * true
        else:
            # the CSLP polish reports ||b_eff - A M^-1 y||, b_eff = b - A x0
            # rounded to f32 once, which near 1e-6 is the size of the residual
            # itself; an f32 residual on the card has that floor as well. So
            # held in float64 on the host at tests/test_hybrid.py:101's
            # tolerance, with the rounding of b_eff printed beside it
            true, beff_err = host_relres64(cfg, sos96, src96, res.wavefield,
                                           warm["best_wavefield"], op96, k_sq96, mode)
            limit = HYBRID_CSLP_RTOL * np.maximum(final, 1e-6) + HYBRID_CSLP_ATOL
            log(f"phase 12b CSLP polish per map: reported {final.tolist()}, float64 "
                f"{true.tolist()}, rounding of b - A x0 {beff_err.tolist()}")
        gap = np.abs(final - true) / true
        true_ok = np.all(np.abs(final - true) <= limit)
        warm_equal = bool(torch.equal(res.warm_rmse, warm["best_rmse"]))
        log(f"phase 12b solve_hybrid ({HYBRID_MAPS} x {GRID}^2, {HYBRID_LEARNED} learned "
            f"iterations, polish '{precond}'): launches K2a/K2b/K2c/K1/K3 {counts}; warm "
            f"rmse equal to the rollout's best: {warm_equal}; relres warm "
            f"{warm_rel.max():.3e} -> final {final.max():.3e} (worst), GMRES iterations "
            f"{res.gmres_iterations.tolist()}; reported against true max rel diff "
            f"{gap.max():.3e}")
        if counts != want_k1(steps * HYBRID_LEARNED):
            fail(f"solve_hybrid launched {counts}")
        if not warm_equal:
            fail("solve_hybrid's warm rmse is not the rollout's best rmse")
        if not (np.all(np.isfinite(final)) and true_ok):
            fail("solve_hybrid's reported residuals are not the true ones")
        if not np.all(final <= warm_rel * (1 + MONOTONE_SLACK)):
            fail("solve_hybrid's polish ended above its warm start")
        times = solve_times(run, lambda: run(1), "on map 0 alone")
        log_times(f"12b solve_hybrid '{precond}'", times)
        out["hybrid"][precond] = {"final_relres": final.tolist(), "warm_relres": warm_rel.tolist(),
                                  "gmres_iterations": res.gmres_iterations.tolist(),
                                  "k1_launches": counts[3], "true_rel_diff": float(gap.max()),
                                  **times}

    # -- 12c: solve_fgmres_learned at 96^2, device and host cycles ------------
    src0 = solver96.source[0]
    k_sq0 = k_sq96[:1]
    out["fgmres"] = {}
    for host in (False, True):
        def run(cycles=10, host=host):
            return solve_fgmres_learned(params, op96, src0, sos96[0], cfg=cfg_kernel,
                                        inner_iterations=FGMRES_INNER,
                                        restart=FGMRES_RESTART, max_restarts=cycles,
                                        tol=FGMRES_TOL, host_arnoldi=host, device=dev)

        reset_counts()
        res = run()
        torch.cuda.synchronize()
        counts = hand_kernels()
        norms = res.residual_norms.numpy()
        true = relres(op96, k_sq0, src0[None], res.wavefield[None], mode)[0]
        gap = float(abs(norms[-1] - true) / true)
        rise = float(np.max(norms[1:] / norms[:-1]))
        kind = "host" if host else "device"
        log(f"phase 12c solve_fgmres_learned ({kind} cycle, inner {FGMRES_INNER}, restart "
            f"{FGMRES_RESTART}, tol {FGMRES_TOL}): {res.iterations} preconditioner "
            f"applications, launches K2a/K2b/K2c/K1/K3 {counts}; relres "
            f"{[float(f'{x:.4e}') for x in norms]}; reported against true rel diff "
            f"{gap:.3e} (rtol {RELRES_RTOL}); largest rise {rise:.6f}")
        if counts != want_k1(steps * FGMRES_INNER * res.iterations):
            fail(f"solve_fgmres_learned launched {counts}")
        if not (np.all(np.isfinite(norms)) and gap <= RELRES_RTOL):
            fail("solve_fgmres_learned's reported residual is not the true one")
        if rise > 1 + MONOTONE_SLACK:
            fail("solve_fgmres_learned's residual history rises")
        times = solve_times(run, lambda: run(1), "its first cycle")
        log_times(f"12c solve_fgmres_learned {kind} cycle", times)
        out["fgmres"][kind] = {"residual_norms": norms.tolist(),
                               "applications": res.iterations, "k1_launches": counts[3],
                               "true_rel_diff": gap, "x": res.wavefield, **times}
    # the learned preconditioner returns its best iterate, an argmin over
    # the rollout, so a round-off apart bases (MGS against CGS2) can pick
    # another iterate: the histories of the two kinds part after the first
    # Krylov step (6% after one cycle on the CPU path). What must agree is
    # the solve: both reach the tolerance, at the same solution
    dev_x, host_x = (out["fgmres"][k].pop("x") for k in ("device", "host"))
    sol_gap = float((dev_x - host_x).abs().max() / host_x.abs().max())
    finals = [out["fgmres"][k]["residual_norms"][-1] for k in ("device", "host")]
    log(f"phase 12c device against host cycle: final relres {finals}, solutions "
        f"max|diff| {sol_gap:.3e} of max|u| (atol {SOLUTION_ATOL} max|u|)")
    if not (max(finals) < FGMRES_TOL and sol_gap <= SOLUTION_ATOL):
        fail("FGMRES's device and host cycles do not reach the same solution")

    # -- 12d: solve_auto at 512^2: two-level with the learned smoother --------
    n, g = AUTO_GRID, cfg.geometry
    cfg512 = with_grid(cfg_kernel, n)
    sos512 = strong_contrast_sos(n, AUTO_CONTRAST)
    loc = tuple(int(c * n / GRID) for c in cfg.source.location)  # as cli/solve
    s = cfg.source
    src512 = point_source_map(n, n, loc, s.amplitude, s.phase, s.omega)
    plan = choose_solver(sos512, cfg=cfg512, params=params)
    log(f"phase 12d solve_auto at {n}^2 (contrast {sos512.max() / sos512.min():.3f}): plan "
        f"{plan.method}, kwargs {plan.kwargs}; max_restarts {AUTO_CYCLES}")
    if plan.method != "two_level" or plan.kwargs.get("smoother") != "learned":
        fail(f"the {n}^2 strong-contrast plan is {plan.method}, not two-level learned")
    def run(cycles=AUTO_CYCLES):
        return solve_auto(src512, sos512, cfg=cfg512, params=params, device=dev,
                          max_restarts=cycles)[0]

    reset_counts()
    t = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t
    counts = hand_kernels()
    norms = res.residual_norms.numpy()
    k_sq512 = (s.omega / torch.tensor(sos512, device=dev)) ** 2
    op512 = make_operator(n, n, g.pml_size, g.sigma_max, cfg.k0, device=dev)
    true = relres(op512, k_sq512[None], torch.tensor(src512, device=dev)[None],
                  res.wavefield[None], cfg512.operator_mode)[0]
    gap = float(abs(norms[-1] - true) / true)
    smooth_iters = plan.kwargs.get("smoother_iterations", 20)
    log(f"phase 12d solve_auto: {auto_s:.2f} s, {res.iterations} smoother applications, "
        f"launches K2a/K2b/K2c/K1/K3 {counts}; relres {[float(f'{x:.4e}') for x in norms]}; "
        f"reported against true rel diff {gap:.3e} (rtol {RELRES_RTOL})")
    if counts != want_k1(steps * smooth_iters * res.iterations):
        fail(f"solve_auto's two-level solve launched {counts}")
    if not (np.all(np.isfinite(norms)) and np.all(np.diff(norms) < 0)):
        fail("the two-level residual does not fall at every cycle")
    if not gap <= RELRES_RTOL:
        fail("the two-level solve's reported residual is not the true one")
    times = solve_times(run, lambda: run(1), "its first cycle")
    log_times("12d solve_auto two-level", times)
    out["auto_512"] = {"plan": plan.method, "kwargs": {k: str(v) for k, v in plan.kwargs.items()},
                       "residual_norms": norms.tolist(), "applications": res.iterations,
                       "k1_launches": counts[3], "true_rel_diff": gap,
                       "seconds_first": auto_s, **times}
    del op512

    # -- 12e: deflated GMRES on the stencil operator: K2a --------------------
    st = make_stencil_operator(PACK_GRID, PACK_GRID, g.pml_size, g.sigma_max, cfg.k0,
                               order=4, device=dev)
    k_sq_st = (s.omega / torch.tensor(maps256[0], device=dev)) ** 2
    src_st = src256[0]
    def run(cycles=20):
        return solve_helmholtz_deflated(st, k_sq_st, src_st, restart=DEFL_RESTART,
                                        k=DEFL_K, max_cycles=cycles, precond="none",
                                        device=dev)

    reset_counts()
    res = run()
    torch.cuda.synchronize()
    counts = hand_kernels()
    cycles = len(res.residual_norms) - 1
    matvecs = 1 + res.iterations + cycles  # first residual, Arnoldi steps, a residual a cycle

    def plain_mv(v):
        p = torch.view_as_real(v)
        return torch.complex(*sr.residual_planes_plain(st, p[..., 0], p[..., 1], k_sq_st))

    b_st = torch.complex(src_st[..., 0], src_st[..., 1]).contiguous()
    plain = gmres_deflated(plain_mv, b_st, restart=DEFL_RESTART, k=DEFL_K, max_cycles=1)
    head = res.residual_norms[:2]
    plain_gap = float(np.max(np.abs(head - plain.residual_norms[:2]) / head))
    x = torch.view_as_complex(res.x.contiguous())
    true = float(torch.linalg.vector_norm(b_st - plain_mv(x)))
    gap = float(abs(res.residual_norms[-1] - true) / true)
    rel = res.residual_norms / res.residual_norms[0]
    log(f"phase 12e solve_helmholtz_deflated (StencilPML order 4, {PACK_GRID}^2, restart "
        f"{DEFL_RESTART}, k {DEFL_K}): {cycles} cycles, {res.iterations} Arnoldi steps, "
        f"launches K2a/K2b/K2c/K1/K3 {counts} (expected {matvecs} K2a); relres "
        f"{rel[1]:.4e} after a cycle, {rel[-1]:.4e} at the end; first cycle against the "
        f"plain matvec max rel diff {plain_gap:.3e} (rtol {GMRES_PLAIN_RTOL}); reported "
        f"against true rel diff {gap:.3e} (rtol {RELRES_RTOL})")
    if counts != (matvecs, 0, 0, 0, 0):
        fail(f"the deflated solve launched {counts}, expected ({matvecs}, 0, 0, 0, 0)")
    if not (np.all(np.isfinite(res.residual_norms)) and plain_gap <= GMRES_PLAIN_RTOL):
        fail("the deflated solve with K2a disagrees with the plain matvec")
    if not gap <= RELRES_RTOL:
        fail("the deflated solve's reported residual is not the true one")
    times = solve_times(run, lambda: run(5), "its first 5 cycles")
    log_times("12e solve_helmholtz_deflated", times)
    out["deflated"] = {"residual_norms": res.residual_norms.tolist(), "cycles": cycles,
                       "iterations": res.iterations, "k2a_launches": counts[0],
                       "plain_rel_diff": plain_gap, "true_rel_diff": gap, **times}

    # -- 12f: cli/solve on the card ------------------------------------------
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = solve_cli.main(["--sos", "datasets/splitted_96/testset.npz",
                             "--checkpoint", R2C_NPZ])
    lines = text.getvalue().strip().splitlines()
    log(f"phase 12f cli/solve on the card: rc {rc}, {lines[0]}; {lines[-1]}")
    if rc != 0 or lines[0] != "plan: learned":
        fail("cli/solve did not solve with the learned plan on the card")
    out["cli_solve"] = lines
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 12 done in {out['seconds']:.1f} s")
    return out


def read_serving_port(proc, deadline_s: float) -> tuple[int, list]:
    """The port from the `serving on http://HOST:PORT` line of a cli/serve
    subprocess, read by a thread so the wait has a deadline; returns the
    port and the lines read until then."""
    import queue
    import re
    import threading

    lines: "queue.Queue[str]" = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)

    threading.Thread(target=pump, daemon=True).start()
    seen, end = [], time.perf_counter() + deadline_s
    while time.perf_counter() < end:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            if proc.poll() is not None:
                break
            continue
        seen.append(line.rstrip())
        m = re.search(r"serving on http://[^:]+:(\d+)", line)
        if m:
            return int(m.group(1)), seen
    return 0, seen


def serve_phase(dev, hand_kernels) -> dict:
    """Phase 13: serving and the remaining 2D entry points, with the
    tpu_r2c weights on the default config at full width and depth (K1,
    'pallas' mode, wherever the learned solver runs unless said). Every
    gate failure exits; the returned dict holds what was measured.
    `hand_kernels()` reads the launch counts of K2a, K2b, K2c, K1 and K3."""
    import importlib.util
    import json as _json
    import os
    import tempfile
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from helmnet_tpu_torch.cli.example import simple_scattering
    from helmnet_tpu_torch.core.config import Config
    from helmnet_tpu_torch.data.ellipses import load_maps
    from helmnet_tpu_torch.eval.harness import compare_solvers, normalize_wavefield
    from helmnet_tpu_torch.models.hybridnet import params_to
    from helmnet_tpu_torch.models.registry import get_architecture
    from helmnet_tpu_torch.ops.double_conv import (double_conv_plain, fused_double_conv,
                                                   prepare, tile_for)
    from helmnet_tpu_torch.ops.source import point_source_amplitude, point_source_map
    from helmnet_tpu_torch.ops.spectral import assemble_dense, make_operator
    from helmnet_tpu_torch.serve import ServeConfig, SolverService
    from helmnet_tpu_torch.solvers.iterative import IterativeSolver, rollout
    from helmnet_tpu_torch.solvers.timedomain import solve_cw

    t0 = time.perf_counter()
    out = {}
    steps = 14  # K1 launches a learned step (phase 4)
    base = Config()
    cfg = base.replace(model=dataclasses.replace(base.model, double_conv_mode="pallas"))
    solver = IterativeSolver.from_params_npz(R2C_NPZ, cfg, device=dev)
    params = solver.params
    sos96 = np.load("datasets/splitted_96/testset.npz")["maps"][:SERVE_96]
    maps256 = load_maps("datasets/eval256/maps.npz")[:SERVE_256]

    # -- 13a: SolverService, K1 ------------------------------------------------
    service = SolverService(solver, ServeConfig())
    sc = service.config

    # K1 against its plain version at each call of a served step (phase 3's
    # check, at the batch and grids serving gives it: the batch picks the
    # output tile). These launches are made before the counts are reset.
    gen = torch.Generator(device=dev).manual_seed(13)
    k1_check = {}
    for n in (GRID, PACK_GRID):
        for name, p, m, cins in step_calls(params, cfg.model, n):
            parts = tuple(torch.randn((sc.max_batch, m, m, c), generator=gen, device=dev)
                          for c in cins)
            ref_out = double_conv_plain(p, parts)
            got_out = fused_double_conv(prepare(p), parts)
            torch.cuda.synchronize()
            err = (got_out - ref_out).abs().max().item()
            scale = ref_out.abs().max().item()
            tile = tile_for(sc.max_batch, m, m)
            ok = bool(torch.isfinite(got_out).all()) and err <= KERNEL_RTOL * scale
            k1_check[f"{n}^2 {name}"] = {"grid": m, "tile": list(tile), "max_abs_err": err,
                                         "atol": KERNEL_RTOL * scale}
            log(f"phase 13a K1 {name:20s} {sc.max_batch} x {m}^2, tile "
                f"{tile[0]}x{tile[1]}: max|err| {err:.3e} (atol "
                f"{KERNEL_RTOL * scale:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K1 disagrees with its plain version at {name}, "
                     f"{sc.max_batch} x {m}^2")
    out["k1_against_plain"] = k1_check
    try:
        reset_counts()
        t = time.perf_counter()
        service.warmup([(GRID, GRID), (PACK_GRID, PACK_GRID)], timeout=600)
        warm_s = time.perf_counter() - t
        warm_counts = hand_kernels()
        before = service.stats()
        reqs = [(sos96[i], {}) for i in range(SERVE_96)] + [
            (maps256[i], {"source_location": SERVE_LOCS[i]} if i < len(SERVE_LOCS) else {})
            for i in range(SERVE_256)]
        order = np.random.default_rng(0).permutation(len(reqs))  # the buckets mixed
        share = [order[c::SERVE_CLIENTS] for c in range(SERVE_CLIENTS)]

        def client(idx):
            futs = [(i, service.submit(reqs[i][0], **reqs[i][1])) for i in idx]
            return [(i, f.result(timeout=600)) for i, f in futs]

        reset_counts()
        t = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            results = dict(r for part in pool.map(client, share) for r in part)
        burst_s = time.perf_counter() - t
        counts = hand_kernels()
        after = service.stats()
        d = {k: after[k] - before[k] for k in ("requests", "completed", "failed", "batches",
                                               "padded_slots", "batched_slots")}
        by_size = {k: after["by_size"].get(k, 0) - before["by_size"].get(k, 0)
                   for k in after["by_size"]}
        lat = [results[i]["latency_s"] for i in range(len(reqs))]
        p50, p95 = (float(p) for p in np.percentile(lat, [50, 95]))
        walls = {}  # a batch's wall: the device_s its requests share
        for i, r in results.items():
            walls.setdefault(f"{r['wavefield'].shape[0]}^2", set()).add(r["device_s"])
        ratio = np.array([results[i]["rmse"][0] / results[i]["best_rmse"]
                          for i in range(len(reqs))])
        finite = all(np.isfinite(r["wavefield"]).all() and np.isfinite(r["rmse"]).all()
                     for r in results.values())
        occupancy = 1.0 - d["padded_slots"] / d["batched_slots"]
        log(f"phase 13a SolverService ({sc.max_batch} a batch, chunk "
            f"{sc.chunk_iterations}, window {sc.batch_window_s} s, "
            f"{sc.default_iterations} iterations): warm-up of 96^2 and 256^2 in "
            f"{warm_s:.2f} s, launches K2a/K2b/K2c/K1/K3 {warm_counts}; burst of "
            f"{len(reqs)} ({SERVE_96} at 96^2, {SERVE_256} at 256^2, {len(SERVE_LOCS)} "
            f"with a source location) from {SERVE_CLIENTS} clients in {burst_s:.2f} s: "
            f"{len(reqs) / burst_s:.3f} requests/s; latency p50 {p50:.3f} s, p95 "
            f"{p95:.3f} s; {d['batches']} batches, occupancy {occupancy:.4f}, {d['padded_slots']} "
            f"padded slots; launches K2a/K2b/K2c/K1/K3 {counts}; stats {d}, by size "
            f"{by_size}")
        for k, v in sorted(walls.items()):
            log(f"phase 13a wall per {k} batch: {[round(x, 4) for x in sorted(v)]} s")
        log(f"phase 13a rmse[0] / best_rmse per request: min {ratio.min():.2f}, "
            f"median {np.median(ratio):.2f} (gate {SERVE_RMSE_FACTOR})")
        if d["failed"] or d["completed"] != len(reqs) or len(results) != len(reqs):
            fail(f"the service completed {d['completed']} of {len(reqs)}, "
                 f"{d['failed']} failed")
        if by_size != {f"{GRID}x{GRID}": SERVE_96, f"{PACK_GRID}x{PACK_GRID}": SERVE_256}:
            fail(f"the service's by_size {by_size} is not what was sent")
        if counts != (0, 0, 0, steps * sc.default_iterations * d["batches"], 0):
            fail(f"the burst launched {counts}, expected {steps} x "
                 f"{sc.default_iterations} x {d['batches']} K1")
        if not finite or not ratio.min() >= SERVE_RMSE_FACTOR:
            fail("a served solve is not finite or did not fall by the stated factor")
        out["burst"] = {"requests": len(reqs), "seconds": burst_s,
                        "requests_per_s": len(reqs) / burst_s,
                        "latency_p50_s": p50, "latency_p95_s": p95, "latency_s": lat,
                        "occupancy": occupancy, "stats_delta": d, "by_size": by_size,
                        "batch_walls_s": {k: sorted(v) for k, v in walls.items()},
                        "k1_launches": counts[3], "warmup_s": warm_s,
                        "warmup_k1_launches": warm_counts[3],
                        "rmse_factor_min": float(ratio.min())}

        # where a 96^2 batch's time goes: a direct forward of the same stack
        # as a served batch (the default source), one chunk, profiled
        ref = IterativeSolver(cfg, params=params, device=dev)
        stack96 = sos96[:sc.max_batch]
        prof = profile_steps(lambda _: ref.forward(
            stack96, num_iterations=sc.chunk_iterations,
            chunk_iterations=sc.chunk_iterations), 1)
        log(f"phase 13a profile of one {GRID}^2 x {sc.max_batch} batch of "
            f"{sc.chunk_iterations} iterations: wall {prof['wall_ms_per_step']:.1f} "
            f"ms, device {prof['device_ms_per_step']:.1f} ms, busy share "
            f"{prof['busy_share']:.4f}")
        for k in prof["top"][:6]:
            print(f"    {k['device_ms_per_step']:.3f} ms {k['calls_per_step']:7.0f} "
                  f"calls  {k['name']}", flush=True)
        out["batch_profile"] = {k: prof[k] for k in ("wall_ms_per_step",
                                                     "device_ms_per_step",
                                                     "busy_share", "top")}

        # one batch a bucket against a direct forward of the same padded
        # stack and sources: the worker is kept busy by a first request of
        # the other bucket while the batch queues, so it is taken whole.
        # cuDNN's transposed convs may sum in another order from run to
        # run (atomics), and the recurrent rollout carries that far; so
        # this check runs with cuDNN's deterministic algorithms, and the
        # run-to-run gap of the default ones is logged beside it
        exact = {}
        xla = IterativeSolver(base, params=params, device=dev)  # cuDNN f32, TF32 off
        for n, blocker, sos, kws in (
                (GRID, maps256[0], stack96, [{}] * sc.max_batch),
                (PACK_GRID, sos96[0], maps256[:3],
                 [{"source_location": SERVE_LOCS[0]}, {}, {}])):
            ref.set_domain_size((n, n))
            # the service scales the default source location with the grid
            scaled = tuple(int(round(c * n / GRID)) for c in cfg.source.location)
            maps = []
            for kw in kws:
                ref.set_sources([kw.get("source_location", scaled)])
                maps.append(ref.source[0])
            maps += [maps[0]] * (sc.max_batch - len(maps))
            ref.set_source_maps(torch.stack(maps))
            xla.set_domain_size((n, n))
            xla.set_source_maps(torch.stack(maps))
            stack = np.concatenate([sos, np.repeat(sos[:1], sc.max_batch - len(sos), 0)])

            def direct(stack=stack):
                return ref.forward(stack, num_iterations=sc.chunk_iterations,
                                   chunk_iterations=sc.chunk_iterations)

            def gaps(got, want) -> dict:
                """Max over the requests of max|got - want| / max|want|."""
                rel = {}
                for i, g in enumerate(got):
                    for key, w in (("wavefield", want["wavefield"][i]),
                                   ("rmse", want["rmse"][:, i]),
                                   ("best_rmse", want["best_rmse"][i])):
                        w = w.cpu().numpy()
                        d = float(np.abs(np.asarray(g[key]) - w).max() / np.abs(w).max())
                        rel[key] = max(rel.get(key, 0.0), d)
                return rel

            first = direct()
            again = direct()
            spread = gaps([{"wavefield": again["wavefield"][i].cpu().numpy(),
                            "rmse": again["rmse"][:, i].cpu().numpy(),
                            "best_rmse": float(again["best_rmse"][i])}
                           for i in range(len(sos))], first)
            torch.backends.cudnn.deterministic = True
            try:
                busy = service.submit(blocker, iterations=3 * sc.chunk_iterations)
                time.sleep(0.2)
                futs = [service.submit(s, iterations=sc.chunk_iterations, **kw)
                        for s, kw in zip(sos, kws)]
                busy.result(timeout=600)
                got = [f.result(timeout=600) for f in futs]
                want = direct()
            finally:
                torch.backends.cudnn.deterministic = False
            if any(g["batch_size"] != len(sos) for g in got):
                fail(f"the {n}^2 requests were not served as one batch")
            rel = gaps(got, want)
            # the served requests' first 4 rmse against cuDNN f32 on the same
            # padded stack: K1's bf16 taps against the f32 path (phase 4)
            cudnn_rmse = xla.forward(stack, num_iterations=4)["rmse"].cpu().numpy()
            early = max(float((np.abs(g["rmse"][:4] - cudnn_rmse[:, i])
                               / np.abs(cudnn_rmse[:, i])).max()) for i, g in enumerate(got))
            exact[f"{n}^2"] = {"deterministic": rel, "default_run_to_run": spread,
                               "early_rmse_vs_cudnn": early}
            log(f"phase 13a a served {n}^2 batch of {len(sos)} (padded to "
                f"{sc.max_batch}) against a direct forward, cuDNN deterministic: max "
                f"rel diff {rel} (tol {SERVE_EXACT_RTOL}); two direct forwards with "
                f"cuDNN's default algorithms: {spread}; first 4 rmse against an 'xla' "
                f"(cuDNN f32) forward: max rel diff {early:.3e} (rtol {EARLY_RTOL})")
            if max(rel.values()) > SERVE_EXACT_RTOL:
                fail(f"the served {n}^2 batch differs from the direct forward")
            if not early <= EARLY_RTOL:
                fail(f"the served {n}^2 batch's first rmse disagree with cuDNN f32")
        out["exact_rel_diff"] = exact
        final = service.stats()
        if final["failed"]:
            fail(f"{final['failed']} served requests failed")
        out["stats"] = final
    finally:
        service.shutdown()

    # -- 13b: cli/serve on the card --------------------------------------------
    proc = subprocess.Popen(
        [sys.executable, "-m", "helmnet_tpu_torch.cli.serve", "--checkpoint", R2C_NPZ,
         "--port", "0", "--warmup", str(GRID)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, seen = read_serving_port(proc, 300)
        if not port:
            fail(f"cli/serve did not start: {seen[-5:]}")
        url = f"http://127.0.0.1:{port}"

        def call(path, body=None):
            req = urllib.request.Request(
                url + path, data=None if body is None else _json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, _json.load(r)

        health = call("/healthz")
        t = time.perf_counter()
        solved = call("/solve", {"sos": sos96[0].tolist(), "iterations": 100})
        http_s = time.perf_counter() - t
        stats = call("/stats")
        wf = np.asarray(solved[1]["wavefield"], np.float32)
        rm = np.asarray(solved[1]["rmse"])
        log(f"phase 13b cli/serve (`{seen[-1]}`): /healthz {health}, /solve "
            f"{solved[0]} in {http_s:.2f} s (wavefield {list(wf.shape)}, rmse "
            f"{rm[0]:.4e} -> {rm[-1]:.4e}), /stats {stats[0]} completed "
            f"{stats[1]['completed']}")
        if (health != (200, {"ok": True}) or solved[0] != 200 or stats[0] != 200
                or wf.shape != (GRID, GRID, 2) or not np.isfinite(wf).all()
                or not rm[-1] < rm[0] or stats[1]["completed"] < 1):
            fail("cli/serve did not answer as it should")
    finally:
        proc.terminate()
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
            fail("cli/serve did not exit when terminated")
    log(f"phase 13b cli/serve terminated, exit code {rc}")
    out["cli_serve"] = {"solve_s": http_s, "completed": stats[1]["completed"],
                        "rmse_first": float(rm[0]), "rmse_last": float(rm[-1])}

    # -- 13c: cli/example ------------------------------------------------------
    reset_counts()
    t = time.perf_counter()
    ex = simple_scattering(IterativeSolver(cfg, params=params, device=dev),
                           EXAMPLE_ITERS)
    ex_s = time.perf_counter() - t
    counts = hand_kernels()
    cpu = simple_scattering(IterativeSolver(cfg, params=params_to(params, "cpu"),
                                            device="cpu"), 4)
    early = np.abs(ex["rmse"][:4] - cpu["rmse"]) / cpu["rmse"]
    log(f"phase 13c simple_scattering (256^2 slab, line source) {EXAMPLE_ITERS} "
        f"iterations: {ex_s:.2f} s, launches K2a/K2b/K2c/K1/K3 {counts}; rmse "
        f"{ex['rmse'][0]:.4e} -> {ex['rmse'][-1]:.4e}; first 4 against the CPU path "
        f"max rel diff {early.max():.3e} (rtol {EARLY_RTOL})")
    if counts != (0, 0, 0, steps * EXAMPLE_ITERS, 0):
        fail(f"simple_scattering launched {counts}")
    if not (np.isfinite(ex["rmse"]).all() and np.isfinite(ex["wavefield"]).all()
            and ex["rmse"][-1] < ex["rmse"][0] and early.max() <= EARLY_RTOL):
        fail("the example's solve is not finite, not falling or not the CPU path's")
    if importlib.util.find_spec("matplotlib") is None:
        log("phase 13c matplotlib is not installed here: `python -m "
            "helmnet_tpu_torch.cli.example` (which plots) not run")
    else:
        png = os.path.join(tempfile.mkdtemp(), "wavefield.png")
        proc = subprocess.run([sys.executable, "-m", "helmnet_tpu_torch.cli.example",
                               "--checkpoint", R2C_NPZ, "--out", png],
                              capture_output=True, text=True, timeout=300)
        log(f"phase 13c cli/example: rc {proc.returncode}, "
            f"{proc.stdout.strip().splitlines()[:1]}")
        if proc.returncode != 0 or not os.path.exists(png):
            fail(f"cli/example failed: {proc.stderr[-500:]}")
    out["example"] = {"seconds": ex_s, "rmse_first": float(ex["rmse"][0]),
                      "rmse_last": float(ex["rmse"][-1]), "cpu_rel_diff": float(early.max()),
                      "k1_launches": counts[3]}

    # -- 13d: compare_solvers (the fig_generic flow) ---------------------------
    sos_cmp = np.ones((GRID, GRID), np.float32)
    sos_cmp[30:60, 20:70] = 1.6  # tests/test_harness.py:52-58
    kw = dict(num_iterations=200, decimate=20, gmres_restart=50, gmres_max_restarts=20,
              gmres_tol=1e-7)
    t = time.perf_counter()
    cmp = compare_solvers(IterativeSolver(base, params=params, device=dev), sos_cmp, **kw)
    cmp_s = time.perf_counter() - t
    cmp_cpu = compare_solvers(IterativeSolver(base, params=params_to(params, "cpu"),
                                              device="cpu"), sos_cmp, **kw)
    rel = {k: float(np.max(np.abs(np.asarray(getattr(cmp, k)) - getattr(cmp_cpu, k))
                           / np.abs(getattr(cmp_cpu, k))))
           for k in ("linf", "rmse", "model_linf_trace", "model_rmse_trace",
                     "model_residual_rmse")}
    norms = cmp.gmres_residual_norms
    log(f"phase 13d compare_solvers ({GRID}^2 slab, 200 iterations, GMRES(50) x 20 "
        f"CSLP, 'xla' mode): {cmp_s:.2f} s; linf {cmp.linf:.4e}, rmse {cmp.rmse:.4e}; "
        f"linf trace {[float(f'{x:.4e}') for x in cmp.model_linf_trace]}; GMRES "
        f"residual {norms[0]:.4e} -> {norms[-1]:.4e}; against the CPU path max rel "
        f"diff {rel} (rtol {CMP_RTOL})")
    if max(rel.values()) > CMP_RTOL or not norms[-1] <= norms[0] / 1e4:
        fail("compare_solvers on the card disagrees with the CPU path, or GMRES "
             "did not converge")
    out["compare"] = {"linf": cmp.linf, "rmse": cmp.rmse, "seconds": cmp_s,
                      "cpu_rel_diff": rel, "gmres_first": float(norms[0]),
                      "gmres_last": float(norms[-1]),
                      "linf_trace": cmp.model_linf_trace.tolist()}

    # -- 13e: solve_cw against a float64 dense Helmholtz solve -----------------
    n = CW_GRID
    slab = np.ones((n, n), np.float32)
    slab[24:34, 18:46] = 1.5
    out["timedomain"] = {}
    for name, sos, loc, tol in (("homogeneous", np.ones((n, n), np.float32), (40, 32), 0.03),
                                ("slab", slab, (44, 32), 0.06)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        td = solve_cw(sos, point_source_amplitude(n, n, loc, 1.0), omega=1.0, cfl=0.1,
                      roundtrips=CW_ROUNDTRIPS, record_periods=3, sponge_width=16,
                      sponge_strength=1.0, device=dev)
        phasor = td.phasor.cpu().numpy()
        td_s = time.perf_counter() - t
        m = assemble_dense(n, n, 8, 2.0, 1.0, k_sq=(1.0 / sos) ** 2)
        s = point_source_map(n, n, loc, 1.0)
        u = np.linalg.solve(m, (s[..., 0] + 1j * s[..., 1]).ravel()).reshape(n, n)
        p_td, p_hh = normalize_wavefield(phasor, loc), normalize_wavefield(u, loc)
        inner = np.s_[18:-18, 18:-18]  # tests/test_timedomain.py:32-40
        err = min(np.abs(p_td - p_hh)[inner].max(), np.abs(np.conj(p_td) - p_hh)[inner].max())
        err = float(err / np.abs(p_hh[inner]).max())
        log(f"phase 13e solve_cw {name} {n}^2, roundtrips {CW_ROUNDTRIPS}: {td.num_steps} "
            f"steps (dt {td.dt:.6g}) in {td_s:.2f} s ({1e6 * td_s / td.num_steps:.1f} us a "
            f"step); against the float64 Helmholtz solve {err:.4e} (tol {tol})")
        if not (np.isfinite(phasor).all() and err < tol):
            fail(f"solve_cw {name} disagrees with the Helmholtz solve")
        out["timedomain"][name] = {"steps": td.num_steps, "dt": td.dt, "seconds": td_s,
                                   "rel_err": err, "tol": tol}

    # -- 13f: resnet on the card against the CPU path --------------------------
    rcfg = base.replace(model=dataclasses.replace(base.model, architecture="resnet",
                                                  depth=3, features=8))
    arch = get_architecture("resnet")
    rparams = arch.init_params(torch.Generator(device=dev).manual_seed(0), rcfg.model)
    g = rcfg.geometry
    op = make_operator(GRID, GRID, g.pml_size, g.sigma_max, rcfg.k0, device=dev)
    src = torch.tensor(point_source_map(GRID, GRID, tuple(rcfg.source.location),
                                        rcfg.source.amplitude), device=dev)[None]
    sos8 = sos96[:8]
    reset_counts()
    t = time.perf_counter()
    res = rollout(rparams, op, src.expand(8, -1, -1, -1), sos8, cfg=rcfg,
                  num_iterations=RESNET_ITERS, device=dev)["rmse"].cpu().numpy()
    res_s = time.perf_counter() - t
    counts = hand_kernels()
    res_cpu = rollout(params_to(rparams, "cpu"), op.to("cpu"), src.cpu().expand(8, -1, -1, -1),
                      sos8, cfg=rcfg, num_iterations=4, device="cpu")["rmse"].numpy()
    diff = float(np.max(np.abs(res[:4] - res_cpu) / res_cpu))
    log(f"phase 13f resnet (depth 3, features 8, seeded) {GRID}^2 x 8 x {RESNET_ITERS}: "
        f"{res_s:.2f} s, launches K2a/K2b/K2c/K1/K3 {counts}; rmse {res[0].mean():.4e} -> "
        f"{res[-1].mean():.4e}; first 4 against the CPU path max rel diff {diff:.3e} "
        f"(rtol {RESNET_RTOL})")
    if counts != (0, 0, 0, 0, 0) or not np.isfinite(res).all() or diff > RESNET_RTOL:
        fail("the resnet rollout on the card disagrees with the CPU path")
    out["resnet"] = {"seconds": res_s, "cpu_rel_diff": diff}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 13 done in {out['seconds']:.1f} s")
    return out


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block (for equality
    gates: with the default ones two runs of one recurrent rollout differ,
    phase 13a)."""
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


def config3d(n: int, **training):
    """The tpu3d runs' config (tools/train3d_tpu_run.py): the default with
    an n^3 grid, depth 3, state depth 3, features 16, 7 input channels."""
    from helmnet_tpu_torch.core.config import Config

    cfg = Config()
    return cfg.replace(
        geometry=dataclasses.replace(cfg.geometry, domain_size=n),
        model=dataclasses.replace(cfg.model, depth=3, state_depth=3, features=16,
                                  in_channels=7),
        training=dataclasses.replace(cfg.training, **training))


def sources3d(cfg, count: int):
    """tools/eval3d_trained.py:80-98: the fixed source (the 2D default
    scaled to the grid) and `count` seeded (99) random interior sources,
    each [count, n, n, n, 2]."""
    from helmnet_tpu_torch.ops.spectral3d import point_source_map3d

    n, s = cfg.geometry.domain_size, cfg.source
    loc = tuple(max(4, min(n - 4, int(round(c * n / 96.0))))
                for c in (s.location[0], s.location[1], 48))
    fixed = np.broadcast_to(point_source_map3d(n, n, n, loc, s.amplitude)[None],
                            (count, n, n, n, 2)).copy()
    rng = np.random.default_rng(99)
    margin = cfg.geometry.pml_size + 2
    rand = np.stack([point_source_map3d(
        n, n, n, tuple(int(v) for v in rng.integers(margin, n - margin, 3)), s.amplitude)
        for _ in range(count)])
    return {"fixed": fixed, "random": rand}


def conv_flops3d(params, model, n: int) -> float:
    """Operations of one `hybridnet3d.apply` on one n^3 volume, counted
    from the weights' shapes: 2 x MACs of every conv at its output grid
    (a transposed k=4, s=2 conv as its 8 octant convs of (k/2)^3 taps)."""
    vox = lambda level: (n >> level) ** 3
    macs = lambda p: p["w"].shape[0] * p["w"].shape[1] * p["w"][0, 0].numel()
    dconv = lambda p, level: vox(level) * (macs(p["c1"]) + macs(p["c2"]))
    total = dconv(params["inc"], 0) + vox(0) * macs(params["outc"])
    for d in range(model.depth):
        blk = params["enc"][d]
        total += sum(dconv(blk[k], d) for k in ("conv_signal", "conv_state") if k in blk)
        total += vox(d + 1) * macs(blk["down"]) + vox(d) * macs(params["up"][d]) / 8
    total += sum(dconv(params["decode"][d], d) for d in range(model.depth + 1))
    return 2.0 * total


def relerr(got, ref) -> float:
    """max|got - ref| / max|ref| on the host (0 where both are all zero)."""
    got, ref = (np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)
                for t in (got, ref))
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def solvers3d_phase(dev, hand_kernels) -> dict:
    """Phase 14: the 3D path on the card: the operator, the learned solve
    with the tpu3d_a and tpu3d_het weights at their full width and depth,
    CSLP-GMRES, two-level FGMRES, the time domain, `solve_auto` and
    `cli/solve`, and `Trainer3D`. No hand kernel runs here (the JAX
    package has no 3D Pallas kernel): every path's K1-K3 counts must stay 0.
    Every gate failure exits; the returned dict holds what was measured.
    `hand_kernels()` reads the launch counts of K2a, K2b, K2c, K1 and K3."""
    import os
    import tempfile

    from helmnet_tpu_torch.data.ellipsoids3d import make_dataset3d
    from helmnet_tpu_torch.models import hybridnet3d
    from helmnet_tpu_torch.models.hybridnet import iter_leaves, params_to
    from helmnet_tpu_torch.ops.spectral3d import (helmholtz_residual3d, make_operator3d,
                                                  point_source_map3d)
    from helmnet_tpu_torch.solvers.auto import choose_solver, solve_auto
    from helmnet_tpu_torch.solvers.helm3d import solve_helmholtz3d, solve_helmholtz3d_batch
    from helmnet_tpu_torch.solvers.iterative3d import IterativeSolver3D
    from helmnet_tpu_torch.solvers.timedomain import solve_cw3d, solve_cw3d_chunked
    from helmnet_tpu_torch.solvers.twolevel3d import solve_fgmres_two_level3d
    from helmnet_tpu_torch.train.loop3d import FIELDS, Trainer3D
    from helmnet_tpu_torch.weights import load_params3d_npz

    t0 = time.perf_counter()
    out = {"launches": {}}
    zero = (0, 0, 0, 0, 0)

    def counted(path: str, fn):
        """fn() with every hand kernel's count set to 0 just before and read
        just after; any launch fails the run."""
        reset_counts()
        result = fn()
        torch.cuda.synchronize()
        counts = hand_kernels()
        out["launches"][path] = counts
        if counts != zero:
            fail(f"{path} launched a hand kernel: {counts}")
        return result

    # -- 14a: the operator at 48^3 and 64^3 -------------------------------------
    out["operator"] = {}
    for n in (48, 64):
        rng = np.random.default_rng(n)
        op = make_operator3d(n, n, n, 8, 2.0, 1.0, device=dev)
        u, s = (rng.standard_normal((2, n, n, n, 2)).astype(np.float32) for _ in range(2))
        k_sq = (1.0 + rng.random((2, n, n, n))).astype(np.float32)
        args = [torch.tensor(a, device=dev) for a in (u, k_sq, s)]
        res = {m: helmholtz_residual3d(op, *args, m) for m in ("matmul", "fft")}
        cpu = helmholtz_residual3d(op.to("cpu"), *map(torch.tensor, (u, k_sq, s)), "matmul")
        modes, vs_cpu = relerr(res["fft"], res["matmul"]), relerr(res["matmul"], cpu)
        ms = {m: cuda_ms(lambda m=m: helmholtz_residual3d(op, *args, m), iters=20)
              for m in ("matmul", "fft")}
        log(f"phase 14a helmholtz_residual3d 2 x {n}^3: fft against matmul {modes:.3e}, "
            f"card against CPU {vs_cpu:.3e} (of max|ref|, tol {OP3D_RTOL}); {ms['matmul']:.4f} "
            f"ms matmul, {ms['fft']:.4f} ms fft a call")
        if not (modes <= OP3D_RTOL and vs_cpu <= OP3D_RTOL):
            fail(f"the 3D operator's modes or the card and the CPU disagree at {n}^3")
        out["operator"][n] = {"fft_vs_matmul": modes, "card_vs_cpu": vs_cpu, "ms": ms}

    # -- 14b: the learned 3D solve, tpu3d_a then tpu3d_het ----------------------
    out["learned"] = {}
    for tag, (npz, val_npz, n) in MODELS_3D.items():
        cfg = config3d(n)
        solver = IterativeSolver3D.from_params_npz(npz, cfg, device=dev)
        with np.load(val_npz) as f:
            val = f["val"]
        b = len(val)
        srcs = sources3d(cfg, b)
        row = {"batch": b, "grid": n, "iterations": ITERS_3D}

        def forward(src, sos, iters, **kw):
            solver.set_source_maps(src)
            return solver.forward(sos, num_iterations=iters, **kw)

        for kind, src in srcs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            res = counted(f"14b {tag} {kind} {b} x {n}^3 x {ITERS_3D}",
                          lambda: forward(src, val, ITERS_3D))
            wall = time.perf_counter() - t
            rmse = res["rmse"].cpu().numpy()
            best = res["best_rmse"].cpu().numpy()
            rmse0 = np.sqrt(np.mean(src.astype(np.float64) ** 2, axis=(1, 2, 3, 4)))
            reduction = float(np.median(rmse0 / best))
            row[kind] = {"wall_s": wall, "gridpoints_per_s": b * n**3 * ITERS_3D / wall,
                         "median_reduction": reduction, "best_rmse": best.tolist(),
                         "median_best_rmse": float(np.median(best)),
                         "peak_bytes": torch.cuda.max_memory_allocated()}
            if kind == "fixed":
                row["best_field_0"] = res["wavefield"][0].cpu().numpy()
            log(f"phase 14b {tag} {kind} source {b} x {n}^3 x {ITERS_3D}: {wall:.2f} s, "
                f"{b * n**3 * ITERS_3D / wall:.4e} gridpoints/s, peak "
                f"{row[kind]['peak_bytes'] / 2**30:.3f} GiB; best rmse median "
                f"{np.median(best):.4e}, median reduction {reduction:.1f}x (bar "
                f"{REDUCTION_3D}x); rmse {rmse[0].mean():.4e} -> {rmse[-1].mean():.4e}")
            if not np.isfinite(rmse).all() or not reduction >= REDUCTION_3D:
                fail(f"the {tag} 3D solve ({kind} source) is not finite or falls short "
                     f"of {REDUCTION_3D}x")
        prof = profile_steps(lambda k: forward(srcs["fixed"], val, k), PROFILE_STEPS_3D)
        row["profile"] = prof
        row["gflop_per_step"] = b * conv_flops3d(solver.params, cfg.model, n) / 1e9
        log(f"phase 14b {tag} profile of {PROFILE_STEPS_3D} steps: wall "
            f"{prof['wall_ms_per_step']:.2f} ms/step, device {prof['device_ms_per_step']:.2f} "
            f"ms/step, busy share {prof['busy_share']:.4f}; the convs' "
            f"{row['gflop_per_step']:.1f} GFLOP a step at "
            f"{row['gflop_per_step'] / prof['device_ms_per_step']:.2f} TFLOP/s of device time")
        for k in prof["top"][:5]:
            print(f"    {k['device_ms_per_step']:.4f} ms/step {k['calls_per_step']:6.1f} "
                  f"calls/step  {k['name']}", flush=True)
        if tag == "tpu3d_a":
            two = srcs["fixed"][:2], val[:2]
            card = forward(*two, 4)["rmse"].cpu().numpy()
            cpu_solver = IterativeSolver3D(cfg, params=params_to(solver.params, "cpu"),
                                           device="cpu")
            cpu_solver.set_source_maps(two[0])
            cpu = cpu_solver.forward(two[1], num_iterations=4)["rmse"].numpy()
            row["cpu_rel_diff"] = float(np.max(np.abs(card - cpu) / cpu))
            with deterministic_cudnn():
                full = forward(*two, ITERS_3D, best_iterate=False)["rmse"].cpu().numpy()
                chunked = forward(*two, ITERS_3D, best_iterate=False,
                                  chunk_iterations=CHUNK_3D)["rmse"].cpu().numpy()
                row["chunk_rel_diff"] = float(np.max(np.abs(chunked - full) / full))
                gen = torch.Generator(device=dev).manual_seed(14)
                x = torch.randn((2, n, n, n, 7), generator=gen, device=dev)
                states = tuple(torch.randn(s.shape, generator=gen, device=dev) for s in
                               hybridnet3d.init_states(2, n, cfg.model, device=dev))
                outs = {m: hybridnet3d.apply(solver.params, x, states, cfg=dataclasses.replace(
                    cfg.model, up_mode=m))[0] for m in ("dilated", "subpixel")}
                gap = (outs["subpixel"] - outs["dilated"]).abs()
                limit = UP_ATOL + UP_RTOL * outs["dilated"].abs()
                row["up_mode_worst"] = float((gap / limit).max())
            log(f"phase 14b tpu3d_a: first 4 rmse of 2 volumes against the CPU path max "
                f"rel diff {row['cpu_rel_diff']:.3e} (rtol {CPU3D_RTOL}); chunks of {CHUNK_3D} "
                f"against one run of {ITERS_3D} {row['chunk_rel_diff']:.3e} (rtol "
                f"{CHUNK_RTOL}); subpixel against dilated up convs at "
                f"{row['up_mode_worst']:.3f} of atol {UP_ATOL} + rtol {UP_RTOL} (cuDNN "
                f"deterministic)")
            if not (row["cpu_rel_diff"] <= CPU3D_RTOL and row["chunk_rel_diff"] <= CHUNK_RTOL
                    and row["up_mode_worst"] <= 1.0):
                fail("the tpu3d_a solve disagrees with the CPU path, its chunked run or "
                     "the other up mode")
        out["learned"][tag] = row
        del solver

    # -- 14c: CSLP-GMRES on validation volume 0 --------------------------------
    npz, val_npz, n = MODELS_3D["tpu3d_a"]
    cfg = config3d(n)
    g = cfg.geometry
    op = make_operator3d(n, n, n, g.pml_size, g.sigma_max, cfg.k0, device=dev)
    with np.load(val_npz) as f:
        val = f["val"][:4]
    src = sources3d(cfg, 4)["fixed"]
    k_sq = (cfg.source.omega / val) ** 2
    kw = dict(restart=CSLP3D_RESTART, max_restarts=CSLP3D_CYCLES, tol=CSLP3D_TOL,
              precond="shifted_laplace", device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = counted("14c solve_helmholtz3d 48^3", lambda: solve_helmholtz3d(
        op, k_sq[0], src[0], **kw))
    cslp_s = time.perf_counter() - t
    norms = res.residual_norms.cpu().numpy()
    r = helmholtz_residual3d(op, res.x, torch.tensor(k_sq[0], device=dev),
                             torch.tensor(src[0], device=dev))
    true = float(torch.linalg.vector_norm(r))
    gap = float(abs(norms[-1] - true) / true)
    p = g.pml_size + 2
    crop = (slice(p, n - p),) * 3
    learned = out["learned"]["tpu3d_a"].pop("best_field_0")
    anchor = relerr(learned[crop], res.x.cpu().numpy()[crop])
    for row in out["learned"].values():
        row.pop("best_field_0", None)
    prof = profile_steps(lambda _: solve_helmholtz3d(op, k_sq[0], src[0], **dict(
        kw, max_restarts=2)), 1)
    log(f"phase 14c solve_helmholtz3d CSLP ({CSLP3D_RESTART} x {CSLP3D_CYCLES}, tol "
        f"{CSLP3D_TOL}) {n}^3 volume 0: {cslp_s:.2f} s, rel residual "
        f"{norms[-1] / norms[0]:.3e}; reported against true {gap:.3e} (rtol "
        f"{CSLP3D_TRUE_RTOL}); the learned best field against it (PML-cropped rel "
        f"l_inf) {anchor:.4f} (tol {ANCHOR_3D}); profile of 2 cycles: device "
        f"{prof['device_ms_per_step']:.2f} ms of {prof['wall_ms_per_step']:.1f} ms, busy "
        f"share {prof['busy_share']:.4f}")
    if not (np.isfinite(norms).all() and gap <= CSLP3D_TRUE_RTOL and anchor <= ANCHOR_3D):
        fail("3D CSLP-GMRES's residual or its agreement with the learned solve failed")
    torch.cuda.synchronize()
    t = time.perf_counter()
    batch = counted("14c solve_helmholtz3d_batch 4 x 48^3", lambda: solve_helmholtz3d_batch(
        op, k_sq, src, **kw))
    batch_s = time.perf_counter() - t
    singles = [res] + [solve_helmholtz3d(op, k_sq[i], src[i], **kw) for i in (1, 2, 3)]
    batch_gap = max(relerr(batch.x[i], singles[i].x) for i in range(4))
    log(f"phase 14c solve_helmholtz3d_batch 4 x {n}^3: {batch_s:.2f} s; each against its "
        f"single solve {batch_gap:.3e} of max|u| (rtol {BATCH3D_RTOL})")
    if not batch_gap <= BATCH3D_RTOL:
        fail("the batched 3D solve disagrees with the single solves")
    out["cslp"] = {"seconds": cslp_s, "relres": float(norms[-1] / norms[0]),
                   "true_rel_diff": gap, "anchor": anchor, "batch_seconds": batch_s,
                   "batch_rel_diff": batch_gap, "profile": prof}

    # -- 14d: two-level FGMRES, CSLP and learned smoothers ----------------------
    rng = np.random.default_rng(7)
    sos = np.ones((n, n, n), np.float32)
    lo, hi = n // 3, 2 * n // 3
    sos[lo:hi, lo:hi, lo:hi] = 1.0 + 0.8 * rng.random((hi - lo,) * 3).astype(np.float32)
    k_sq = (cfg.k0 / sos) ** 2
    src = point_source_map3d(n, n, n, (n - 12, n // 2, n // 2), 10.0, 0.0, cfg.k0)
    a_params = load_params3d_npz(npz, cfg, device=dev)
    out["two_level"] = {}
    for smoother, kw in (("cslp", dict(restart=8, max_restarts=8, tol=1e-6)),
                         ("learned", dict(restart=8, max_restarts=6, tol=1e-5,
                                          params=a_params, cfg=cfg))):
        fields, rows = {}, {}
        for host in (False, True):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = counted(f"14d two-level {smoother} {'host' if host else 'device'} 48^3",
                          lambda: solve_fgmres_two_level3d(
                              op, src, k_sq, k0=cfg.k0, pml_size=g.pml_size,
                              sigma_max=g.sigma_max, smoother=smoother, coarse_restart=16,
                              coarse_max_restarts=2, host_arnoldi=host, device=dev, **kw))
            wall = time.perf_counter() - t
            norms = res.residual_norms.numpy()
            r = helmholtz_residual3d(op, res.wavefield, torch.tensor(k_sq, device=dev),
                                     torch.tensor(src, device=dev))
            true = float(torch.linalg.vector_norm(r)) / float(np.linalg.norm(src))
            rows["host" if host else "device"] = {
                "wall_s": wall, "residual_norms": norms.tolist(),
                "true_rel_diff": float(abs(norms[-1] - true) / true)}
            fields[host] = res.wavefield.cpu().numpy()
        # one cycle of 2 applications: tracing a whole solve's launches
        # takes the profiler minutes
        prof = profile_steps(lambda _: solve_fgmres_two_level3d(
            op, src, k_sq, k0=cfg.k0, pml_size=g.pml_size, sigma_max=g.sigma_max,
            smoother=smoother, coarse_restart=16, coarse_max_restarts=2, device=dev,
            **dict(kw, restart=2, max_restarts=1)), 1)
        same = relerr(fields[True], fields[False])
        rows.update(host_vs_device=same, profile=prof)
        out["two_level"][smoother] = rows
        log(f"phase 14d solve_fgmres_two_level3d {smoother} smoother {n}^3: device cycle "
            f"{rows['device']['wall_s']:.2f} s to {rows['device']['residual_norms'][-1]:.3e}, "
            f"host cycle {rows['host']['wall_s']:.2f} s to "
            f"{rows['host']['residual_norms'][-1]:.3e}; reported against true "
            f"{rows['device']['true_rel_diff']:.3e} / {rows['host']['true_rel_diff']:.3e} "
            f"(rtol {RELRES_RTOL}); host against device solution {same:.3e} of max|u| (tol "
            f"{SOLUTION_ATOL}); 2 applications: device {prof['device_ms_per_step']:.1f} ms of "
            f"{prof['wall_ms_per_step']:.1f} ms, busy share {prof['busy_share']:.4f}")
        if not (max(rows[k]["true_rel_diff"] for k in ("device", "host")) <= RELRES_RTOL
                and same <= SOLUTION_ATOL):
            fail(f"3D two-level FGMRES ({smoother}) failed its gates")

    # -- 14e: the time domain against CSLP-GMRES -------------------------------
    out["timedomain"] = {}
    het = np.ones((n, n, n), np.float32)
    het[18:26, 14:34, 14:34] = 1.5
    for name, sos, loc, tol in (("homogeneous", np.ones((n, n, n), np.float32), (32, 24, 24),
                                 0.05), ("heterogeneous", het, (34, 24, 24), 0.08)):
        amp = np.zeros((n, n, n), np.float32)
        amp[loc] = 1.0
        torch.cuda.synchronize()
        t = time.perf_counter()
        td = counted(f"14e solve_cw3d {name} 48^3", lambda: solve_cw3d(
            sos, amp, omega=1.0, cfl=0.2, roundtrips=12, record_periods=3, sponge_width=10,
            sponge_strength=1.0, device=dev))
        td_s = time.perf_counter() - t
        op8 = make_operator3d(n, n, n, 8, 2.0, 1.0, device=dev)
        hh = solve_helmholtz3d(op8, (1.0 / sos) ** 2, point_source_map3d(n, n, n, loc, 1.0),
                               precond="shifted_laplace", restart=15, max_restarts=40,
                               tol=1e-7, device=dev)
        cx = lambda a: a[..., 0].astype(np.float64) + 1j * a[..., 1]
        p_td, p_hh = cx(td.phasor.cpu().numpy()), cx(hh.x.cpu().numpy())
        p_td, p_hh = p_td / p_td[loc], p_hh / p_hh[loc]
        inner = np.s_[14:-14, 14:-14, 14:-14]  # tests/test_timedomain3d.py:48-54
        err = min(np.abs(p_td - p_hh)[inner].max(), np.abs(np.conj(p_td) - p_hh)[inner].max())
        err = float(err / np.abs(p_hh[inner]).max())
        log(f"phase 14e solve_cw3d {name} {n}^3: {td.num_steps} steps in {td_s:.2f} s "
            f"({1e6 * td_s / td.num_steps:.1f} us a step); against CSLP-GMRES {err:.4e} "
            f"(tol {tol})")
        if not err < tol:
            fail(f"solve_cw3d {name} disagrees with the Helmholtz solve")
        out["timedomain"][name] = {"steps": td.num_steps, "seconds": td_s, "rel_err": err}
    sos16 = np.ones((16, 16, 16), np.float32)
    sos16[6:10, 5:11, 5:11] = 1.4
    amp16 = np.zeros((16, 16, 16), np.float32)
    amp16[11, 8, 8] = 1.0
    kw16 = dict(omega=1.0, cfl=0.2, roundtrips=3, record_periods=2, sponge_width=4,
                sponge_strength=1.0, device=dev)
    mono = solve_cw3d(sos16, amp16, **kw16)
    chunked = solve_cw3d_chunked(sos16, amp16, chunk_steps=37, **kw16)
    gap = (chunked.phasor - mono.phasor).abs()
    worst = float((gap / (2e-6 + 2e-5 * mono.phasor.abs())).max())
    log(f"phase 14e solve_cw3d_chunked(37) against solve_cw3d at 16^3: {chunked.num_steps} "
        f"/ {mono.num_steps} steps, phasor at {worst:.3f} of atol 2e-6 + rtol 2e-5")
    if chunked.num_steps != mono.num_steps or worst > 1.0:
        fail("the chunked 3D time-domain solve differs from the monolithic one")
    out["timedomain"]["chunked_worst"] = worst

    # -- 14f: solve_auto and cli/solve in 3D ----------------------------------
    sos = np.ones((n, n, n), np.float32)
    c = (slice(n // 4, 3 * n // 4),) * 3
    sos[c] = 1.0 + np.random.default_rng(0).random(sos[c].shape, np.float32)
    src = point_source_map3d(n, n, n, (n - 12, n // 2, n // 2), 10.0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res, plan = counted("14f solve_auto cslp3d 48^3", lambda: solve_auto(
        src, sos, cfg=cfg, tol=1e-4, device=dev))
    auto_s = time.perf_counter() - t
    norms = res.residual_norms.cpu().numpy()
    ext = np.ones((64, 64, 64), np.float32)
    ext[16:48, 16:48, 16:48] = 4.0
    ext_plan = choose_solver(ext, cfg=cfg)
    cfg64 = config3d(64)
    src64 = point_source_map3d(64, 64, 64, (52, 32, 32), 10.0)
    t = time.perf_counter()
    ext_res, _ = counted("14f solve_auto two_level3d 64^3", lambda: solve_auto(
        src64, ext, cfg=cfg64, tol=1e-4, max_restarts=AUTO3D_CYCLES, device=dev))
    ext_s = time.perf_counter() - t
    ext_norms = ext_res.residual_norms.numpy()
    log(f"phase 14f solve_auto {n}^3 contrast 1: plan {plan.method}, {auto_s:.2f} s, rel "
        f"residual {norms[-1] / norms[0]:.3e} (tol 1e-4); 64^3 contrast 4 block: plan "
        f"{ext_plan.method}, {AUTO3D_CYCLES} cycles in {ext_s:.2f} s, relres "
        f"{[float(f'{x:.3e}') for x in ext_norms]}")
    if plan.method != "cslp3d" or not norms[-1] <= 1e-4 * norms[0]:
        fail("3D solve_auto did not take cslp3d or did not reach its tolerance")
    if ext_plan.method != "two_level3d" or not np.all(np.diff(ext_norms) < 0):
        fail("3D solve_auto on the extreme cube did not take two_level3d or stalled")
    with tempfile.TemporaryDirectory() as tmp:
        cube = os.path.join(tmp, "cube.npz")
        np.savez(cube, maps=sos)
        proc = subprocess.run([sys.executable, "-m", "helmnet_tpu_torch.cli.solve", "--sos",
                               cube, "--out", os.path.join(tmp, "out.npz")],
                              capture_output=True, text=True, timeout=300)
    cli_lines = proc.stdout.strip().splitlines()
    log(f"phase 14f cli/solve on a {n}^3 cube (default source) as a subprocess: rc "
        f"{proc.returncode}, {cli_lines[:1]} {cli_lines[-2:]}")
    if proc.returncode != 0 or not cli_lines or cli_lines[0] != "plan: cslp3d":
        fail(f"cli/solve in 3D failed: {proc.stderr[-2000:]}")
    out["auto"] = {"cslp3d_s": auto_s, "cslp3d_relres": float(norms[-1] / norms[0]),
                   "two_level3d_s": ext_s, "two_level3d_norms": ext_norms.tolist(),
                   "cli": cli_lines}

    # -- 14g: Trainer3D at the tpu3d_a run's settings ----------------------------
    tkw = dict(buffer_size=96, train_batch_size=8, unrolling_steps=10, learning_rate=1e-3,
               p_random_source=0.5, remat=True)
    tcfg = config3d(n, **tkw)
    maps = make_dataset3d(96, n, seed=0)
    params = load_params3d_npz(npz, tcfg, device=dev)
    small = Trainer3D(config3d(n, **dict(tkw, unrolling_steps=2)), params=params, device=dev)
    small.fill_buffer(maps)
    idx = torch.tensor([3, 50], device=dev)
    batch = {k: small._buf[k][idx] for k in FIELDS}

    def grads_of(trainer, b):
        loss, _ = trainer.unrolled_loss(b)
        leaves = [t for _, t in iter_leaves(trainer.params)]
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    card_loss, card_grads = grads_of(small, batch)
    cpu_tr = Trainer3D(small.cfg, params=params_to(params, "cpu"), device="cpu")
    cpu_loss, cpu_grads = grads_of(cpu_tr, {k: v.cpu() for k, v in batch.items()})
    loss_gap = abs(card_loss - cpu_loss) / abs(cpu_loss)
    limits = (TRAIN_GRAD_RTOL * (r.abs().max() + r.abs()).clamp_min(1e-30) for r in cpu_grads)
    worst = max(float(((g.cpu() - r).abs() / lim).max())
                for g, r, lim in zip(card_grads, cpu_grads, limits))
    log(f"phase 14g one step (2 experiences x 2 unrolled) on the card against the CPU "
        f"path: loss {card_loss:.6e} / {cpu_loss:.6e}, rel diff {loss_gap:.3e} (rtol "
        f"{TRAIN_LOSS_RTOL}); grads at {worst:.3f} of atol {TRAIN_GRAD_RTOL}*max|ref| + "
        f"rtol {TRAIN_GRAD_RTOL}")
    if not (loss_gap <= TRAIN_LOSS_RTOL and worst <= 1.0):
        fail("a 3D training step on the card disagrees with the CPU path")
    remat = {}
    peak_off = None
    with deterministic_cudnn():
        for on in (False, True):
            tr = Trainer3D(config3d(n, **dict(tkw, unrolling_steps=3, remat=on)),
                           params=params, device=dev)
            b8 = {k: small._buf[k][torch.arange(8, device=dev)] for k in FIELDS}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            remat[on] = grads_of(tr, b8)
            torch.cuda.synchronize()
            if not on:
                peak_off = torch.cuda.max_memory_allocated()
            del tr
    remat_gap = max([abs(remat[True][0] - remat[False][0]) / abs(remat[False][0])] + [
        relerr(a, b) for a, b in zip(remat[True][1], remat[False][1])])
    log(f"phase 14g remat on against off (8 x 3 unrolled, cuDNN deterministic): loss and "
        f"grads max rel diff {remat_gap:.3e} (rtol {REMAT_RTOL}); peak with remat off "
        f"{peak_off / 2**30:.3f} GiB")
    if not remat_gap <= REMAT_RTOL:
        fail("remat changes the 3D step's loss or grads")
    del small, cpu_tr, remat

    train = Trainer3D(tcfg, params=params, device=dev)
    train.fill_buffer(maps)
    train.epoch = 1  # maxiter 21: evolved experiences can return to the buffer
    start = {p: t.detach().clone() for p, t in iter_leaves(train.params)}
    epoch = counted(f"14g Trainer3D epoch 12 x 8 x {n}^3 x 10", train.training_epoch)
    moved = [p for p, t in iter_leaves(train.params) if not torch.equal(t.detach(), start[p])]
    log(f"phase 14g one epoch of {epoch['global_step']} steps: loss "
        f"{epoch['train_loss_mean']:.6e}, grad norm {epoch['grad_norm_mean']:.4e}, maxiter "
        f"{epoch['maxiter']}, restarts {epoch['new_sos']} of {8 * epoch['global_step']}, "
        f"{epoch['epoch_time_s']:.2f} s; {len(moved)} of {len(start)} leaves moved")
    if not (np.isfinite(epoch["train_loss_mean"]) and np.isfinite(epoch["grad_norm_mean"])
            and len(moved) == len(start)):
        fail("the 3D training epoch is not finite or left a leaf unmoved")
    maxiter = train.max_allowed_iterations()
    walls = []
    for i in range(TRAIN_TIMED + 1):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        train.device_step(maxiter)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    peak_on = torch.cuda.max_memory_allocated()
    prof = profile_steps(lambda k: [train.device_step(maxiter) for _ in range(k)],
                         TRAIN3D_PROFILE_STEPS)
    step_wall = float(np.median(walls[1:]))
    # forward, its recompute (remat), data and weight gradients: 4 forwards
    step_tflop = 4 * 8 * 10 * conv_flops3d(params, tcfg.model, n) / 1e12
    log(f"phase 14g train step (8 x {n}^3 x 10 unrolled, remat, the convs' "
        f"{step_tflop:.2f} TFLOP): wall {1e3 * step_wall:.1f} "
        f"ms (median of {TRAIN_TIMED} after the first; all "
        f"{[round(1e3 * w, 1) for w in walls]}); profile of {TRAIN3D_PROFILE_STEPS}: device "
        f"{prof['device_ms_per_step']:.1f} ms/step, busy share {prof['busy_share']:.4f}; peak "
        f"{peak_on / 2**30:.3f} GiB with remat at 10 unrolled")
    for k in prof["top"][:5]:
        print(f"    {k['device_ms_per_step']:.3f} ms/step {k['calls_per_step']:6.1f} "
              f"calls/step  {k['name']}", flush=True)
    out["training"] = {"cpu_loss_rel_diff": loss_gap, "cpu_grad_worst": worst,
                       "step_tflop": step_tflop,
                       "remat_rel_diff": remat_gap, "epoch": epoch,
                       "step_walls_s": walls, "step_wall_s": step_wall, "profile": prof,
                       "peak_bytes_remat_on_u10": peak_on, "peak_bytes_remat_off_u3": peak_off}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 14 done in {out['seconds']:.1f} s")
    return out

def nan_gate(tag: str, label: str, launch, params, parts, seed: int) -> dict:
    """The NaN gate of one K1 or K3 instance: a NaN planted at a seeded
    pixel and channel of one input part (in a copy); `launch(parts)`, the
    kernel, must give NaN exactly where the plain version does, which must
    be the NaN's 5 x 5 receptive field over every channel (with packed
    block-diagonal weights, every problem of the pack: NaN * 0 = NaN), and
    agree within atol 2e-2 * max|ref| elsewhere. The plain version runs
    with cuDNN off (im2col and a GEMM: the direct sums); its NaN count with
    cuDNN on, whose algorithms may transform whole tiles, is logged beside."""
    from helmnet_tpu_torch.ops.double_conv import double_conv_plain

    rng = np.random.default_rng(seed)
    part = int(rng.integers(len(parts)))
    b, y, x, c = (int(rng.integers(n)) for n in parts[part].shape)
    parts = tuple(t.clone() for t in parts)
    parts[part][b, y, x, c] = float("nan")
    with torch.backends.cudnn.flags(enabled=False):
        ref = double_conv_plain(params, parts)
    cudnn_nans = int(torch.isnan(double_conv_plain(params, parts)).sum())
    got = launch(parts)
    torch.cuda.synchronize()
    field = torch.zeros_like(ref, dtype=torch.bool)
    field[b, max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = True
    nan_got, nan_ref = torch.isnan(got), torch.isnan(ref)
    masks = torch.equal(nan_got, nan_ref) and torch.equal(nan_ref, field)
    keep = ~field
    err = (got[keep] - ref[keep]).abs().max().item()
    atol = KERNEL_RTOL * ref[keep].abs().max().item()
    ok = masks and err <= atol
    log(f"phase {tag} NaN gate {label}: NaN at part {part} (sample {b}, pixel "
        f"({y}, {x}), channel {c}): kernel {int(nan_got.sum())} NaNs, plain "
        f"{int(nan_ref.sum())} (cuDNN on {cudnn_nans}), receptive field "
        f"{int(field.sum())}; masks {'equal' if masks else 'DIFFER'}; elsewhere "
        f"max|err| {err:.3e} (atol {atol:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the NaN gate fails for {label} (phase {tag})")
    return dict(phase=tag, instance=label, at=[part, b, y, x, c],
                kernel_nans=int(nan_got.sum()), plain_nans=int(nan_ref.sum()),
                plain_cudnn_nans=cudnn_nans, field=int(field.sum()),
                max_abs_err=err, atol=atol)


def l2_read_tb_s(mib: int = 16, reads: int = 16, iters: int = 20) -> float:
    """A probe of the card's read rate from a tensor that fits the L2, in
    TB/s: `mib` MiB of f32 (well inside the 50 MB L2) read `reads` times
    by one kernel (the row sums of a [reads, rows, 4096] view that repeats
    it, stride 0 over its first dimension), `iters` calls in a CUDA graph
    (`cuda_ms`); the bytes read over the mean time of a call. One read a
    call would measure the launch: 16 MiB take about 4.6 us. The repeats
    of a row come `mib` MiB of reads apart, beyond an SM's 256 KB L1, but
    nothing here tells an L1 hit from an L2 hit: the reading is the rate
    this probe got, not a measured ceiling of the L2."""
    x = torch.ones(mib * 2**20 // 4, dtype=torch.float32, device="cuda").view(-1, 4096)
    rows = x.expand(reads, *x.shape)
    ms = cuda_ms(lambda: rows.sum(dim=2), iters)
    return reads * x.numel() * 4 / ms / 1e9


def k3_calls(tag: str, kparams, model, n: int, gen, dev, gates: list,
             iters: int = 50) -> list:
    """K3 against its plain version at the 14 calls of one packed step
    (batch 1 at n^2, seeded random inputs, the weights `prepare_k3` made),
    within atol 2e-2 * max|ref|; at the first call of each instance (128-wide
    or cluster), the NaN gate at each of its tiles, appended to `gates`;
    then each call timed (a CUDA graph of `iters` calls) at its tile and at
    the instance's other tiles, beside its plain version, the cuDNN f32
    DoubleConv and its bound; with its cluster size (1: the 128-wide
    instance), CTAs, and `k3_design_bytes` (a model, not measured) and
    that over the kernel's time."""
    from helmnet_tpu_torch.models.blocks import conv2d, double_conv
    from helmnet_tpu_torch.ops.double_conv import double_conv_plain
    from helmnet_tpu_torch.ops.packed_double_conv import (cluster_size, ctas,
                                                          packed_double_conv, tile_for,
                                                          tiles_for)

    rows, gated = [], set()
    for name, pw, n_, cins in packed_step_calls(kparams, model, n):
        parts = tuple(torch.randn((1, n_, n_, c), generator=gen, device=dev)
                      for c in cins)
        ref = double_conv_plain(pw.params, parts)
        got = packed_double_conv(pw, parts)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale
        log(f"phase {tag} {name:20s} {'+'.join(map(str, cins)):>13s} -> {pw.cm} -> "
            f"{got.shape[-1]} @{n_}^2: max|err| {err:.3e} (atol "
            f"{KERNEL_RTOL * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K3 disagrees with its plain version at {name} (phase {tag})")
        if pw.wide not in gated:
            gated.add(pw.wide)
            for t in tiles_for(pw.cmp, pw.cop, pw.ce):
                gates.append(nan_gate(
                    tag, f"K3 {'wide' if pw.wide else '128-wide'} {name} tile "
                    f"{t[0]}x{t[1]}", lambda xs, t=t: packed_double_conv(pw, xs, tile=t),
                    pw.params, parts, seed=1600 + len(gates)))
        fp = pw.params
        lib_p = dict(fp, c1={"w": torch.cat(fp["c1"]["w"], dim=1), "b": fp["c1"]["b"]})

        def library(p=lib_p, parts=parts):
            y = double_conv(p, torch.cat(parts, dim=-1), model.activation_function,
                            "highest")
            return conv2d(p["post"], y) if "post" in p else y

        kernel_ms = cuda_ms(lambda: packed_double_conv(pw, parts), iters)
        tile = tile_for(1, n_, n_, pw.cmp, pw.cop, pw.ce)
        alt_ms = {f"{t[0]}x{t[1]}": cuda_ms(
                      lambda t=t: packed_double_conv(pw, parts, tile=t), iters)
                  for t in tiles_for(pw.cmp, pw.cop, pw.ce) if t != tile}
        cluster = cluster_size(pw.cmp, pw.cop, pw.ce)
        n_ctas = ctas(1, n_, n_, tile, pw.cmp, pw.cop, pw.ce)
        design_bytes = k3_design_bytes(pw, n_ctas // cluster)
        plain_ms = cuda_ms(lambda: double_conv_plain(fp, parts), iters)
        library_ms = cuda_ms(library, iters)
        flops, ops_ms, bytes_ms, cuda_core_ms = packed_bound(pw, parts, got)
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        rows.append(dict(
            name=name, grid=n_, cins=list(cins), cmid=pw.cm, cout=int(got.shape[-1]),
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, ops_ms=ops_ms, bytes_ms=bytes_ms,
            cuda_core_ms=cuda_core_ms, max_abs_err=err, gflops=flops / 1e9,
            tflops=flops / kernel_ms / 1e9, tile=list(tile), wide=pw.wide,
            bound_share=bound_ms / kernel_ms, alt_ms=alt_ms, cluster=cluster,
            ctas=n_ctas, design_l2_bytes=design_bytes,
            design_l2_tb_s=design_bytes / kernel_ms / 1e9))
        log(f"phase {tag} {name:20s} tile {tile[0]}x{tile[1]}: K3 {kernel_ms:.4f} ms "
            f"({flops / kernel_ms / 1e9:.1f} TFLOP/s, {bound_ms / kernel_ms:.3f} of "
            f"its bound), plain {plain_ms:.4f} ms, cuDNN {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), f32 CUDA-core {cuda_core_ms:.4f} ms; "
            f"cluster {cluster}, {n_ctas} CTAs, design weight bytes from L2 "
            f"{design_bytes / 1e9:.3f} GB (a model) at {design_bytes / kernel_ms / 1e9:.3f} TB/s"
            + "".join(f"; at tile {k} {v:.4f} ms" for k, v in alt_ms.items()))
        del parts, ref, got
    total = lambda k: sum(r[k] for r in rows)
    log(f"phase {tag} a packed step at {n}^2 ({len(rows)} calls): K3 {total('ms'):.4f} "
        f"ms, plain {total('plain_ms'):.4f} ms, cuDNN {total('library_ms'):.4f} ms, "
        f"bound {total('bound_ms'):.4f} ms, {total('gflops'):.1f} GFLOP, design weight "
        f"bytes from L2 {total('design_l2_bytes') / 1e9:.3f} GB (a model)")
    return rows


def k3_step(rows: list) -> dict:
    """A packed step's K3 numbers: the sums over its calls."""
    total = lambda k: sum(r[k] for r in rows)
    return {
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if total("ops_ms") >= total("bytes_ms") else "bytes",
        "library_ms": total("library_ms"), "gflops": total("gflops"),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "tiles": {r["name"]: "x".join(map(str, r["tile"])) for r in rows},
    }


def wide_packed_phase(dev, cfg_kernel, cfg_cudnn, params, hand_kernels) -> dict:
    """Phase 7b: `rollout_packed` at g = WIDE_G on WIDE_MAPS maps at 256^2
    (the 16 of datasets/eval256 and as many from `make_dataset(seed=0)`),
    PACK_ITERS iterations in 'pallas' mode: exactly 14 x PACK_ITERS K3
    launches (the wide instances) and no other hand-kernel launch, finite
    rmse, the first 4 within rtol 0.05 of the unpacked cuDNN-f32 rollout
    and the best within a factor 1.5; then its wall and a profile."""
    from helmnet_tpu_torch.data.ellipses import load_maps, make_dataset
    from helmnet_tpu_torch.models.packed import rollout_packed
    from helmnet_tpu_torch.solvers.iterative import IterativeSolver, rollout

    t0 = time.perf_counter()
    g, n, iters = WIDE_G, PACK_GRID, PACK_ITERS
    half = load_maps("datasets/eval256/maps.npz")
    maps = np.concatenate([half, make_dataset(WIDE_MAPS - len(half), n, seed=0)])
    geometry = dataclasses.replace(cfg_kernel.geometry, domain_size=n)
    cfg_pack = cfg_kernel.replace(geometry=geometry)
    cfg_xla = cfg_cudnn.replace(geometry=geometry)
    solver = IterativeSolver(cfg_pack, params=params, device=dev)
    src = solver.source.expand(len(maps), -1, -1, -1)

    def packed_run(steps, collect=("rmse",)):
        return rollout_packed(params, solver.op, src, maps, cfg=cfg_pack, g=g,
                              num_iterations=steps, collect=collect, device=dev)

    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    pk = packed_run(iters, ("rmse", "best"))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    k2a, k2b, k2c, k1, k3 = hand_kernels()
    rmse, best = pk["rmse"].cpu().numpy(), pk["best_rmse"].cpu().numpy()
    log(f"phase 7b rollout_packed g={g}: {iters} iterations of {len(maps)} x {n}^2 in "
        f"{first_s:.2f} s; {k3} K3 launches, {k1} K1, {k2a + k2b + k2c} K2; mean rmse "
        f"{rmse[0].mean():.4e} -> {rmse[-1].mean():.4e}, best {best.mean():.4e}")
    if k3 != 14 * iters or k1 or k2a or k2b or k2c:
        fail(f"{k3} K3 and {k1 + k2a + k2b + k2c} other launches, expected "
             f"14 x {iters} and 0")
    if rmse.shape != (iters, len(maps)) or not np.all(np.isfinite(rmse)):
        fail("the g=32 packed rmse is not finite or has the wrong shape")
    f32 = rollout(params, solver.op, src, maps, cfg=cfg_xla, num_iterations=iters,
                  collect=("rmse", "best"), device=dev)
    f32_rmse, f32_best = f32["rmse"].cpu().numpy(), f32["best_rmse"].cpu().numpy()
    early = np.abs(rmse[:4] - f32_rmse[:4]) / np.abs(f32_rmse[:4])
    best_ratio = np.maximum(best / f32_best, f32_best / best)
    log(f"phase 7b against unpacked cuDNN f32: first 4 rmse max rel diff "
        f"{early.max():.3e} (rtol {EARLY_RTOL}); best rmse ratio max "
        f"{best_ratio.max():.3f} (limit {LATE_FACTOR})")
    if early.max() > EARLY_RTOL or best_ratio.max() > LATE_FACTOR:
        fail("the g=32 packed K3 path disagrees with the unpacked cuDNN path")
    torch.cuda.synchronize()
    t = time.perf_counter()
    packed_run(iters)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    prof = profile_steps(packed_run, WIDE_PROFILE_STEPS)
    k3_ms = sum(v for k, v in prof["device_ms_by_name"].items()
                if "packed_double_conv" in k or "cluster_double_conv" in k)
    log(f"phase 7b {len(maps)} x {n}^2 x {iters} at g={g}: {wall_s:.3f} s, "
        f"{len(maps) * n * n * iters / wall_s:.4e} gridpoints/s; profile of "
        f"{WIDE_PROFILE_STEPS} steps: wall {prof['wall_ms_per_step']:.4f} ms/step, "
        f"device {prof['device_ms_per_step']:.4f} ms/step, busy share "
        f"{prof['busy_share']:.4f}, K3 {k3_ms:.4f} ms/step")
    for k in prof["top"][:8]:
        print(f"    {k['device_ms_per_step']:.5f} ms/step "
              f"{k['calls_per_step']:5.1f} calls/step  {k['name']}", flush=True)
    return {"k3_launches": k3, "first_s": first_s, "wall_s": wall_s,
            "gridpoints_per_s": len(maps) * n * n * iters / wall_s,
            "rmse": rmse.tolist(), "best_rmse": best.tolist(),
            "f32_rmse": f32_rmse.tolist(), "early_rel_diff": float(early.max()),
            "best_ratio": float(best_ratio.max()), "profile": prof,
            "k3_ms_per_step": k3_ms, "seconds": time.perf_counter() - t0}


def distribution_phase(dev, cfg, params, hand_kernels) -> dict:
    """Phase 15: the distribution modules on NCCL at world size 1 (one card;
    their multi-rank behaviour is held against the JAX package on gloo
    ranks by tests/test_torch_distributed.py): (a) the halo-exchanged
    stencil residual and its norm, (b) the slab-FFT residual, (c) the
    z-slab 3D residual in all three methods and its norm, each against the
    unsharded function; (d) `put_global` / `fetch_global` round trips;
    (e) a data=1 mesh `Trainer` against the plain one over one epoch of 3
    steps under cuDNN's deterministic algorithms. No hand kernel runs."""
    import torch.distributed as dist

    from helmnet_tpu_torch.core.config import ParallelConfig
    from helmnet_tpu_torch.core.meshes import (Sharding, data_sharding, make_mesh,
                                               make_mesh3d, spatial_sharding)
    from helmnet_tpu_torch.data.ellipses import load_maps
    from helmnet_tpu_torch.distributed import dfft, halo, multihost, slab3d
    from helmnet_tpu_torch.ops.spectral import helmholtz_residual, make_operator
    from helmnet_tpu_torch.ops.spectral3d import helmholtz_residual3d, make_operator3d
    from helmnet_tpu_torch.ops.stencil import (helmholtz_residual_stencil,
                                               make_stencil_operator)
    from helmnet_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    with world_of_one(dev) as backend:
        out = {"backend": backend}
        if out["backend"] != "nccl":
            fail(f"the process group runs on {out['backend']}, not NCCL")
        reset_counts()
        gen = torch.Generator(device=dev).manual_seed(15)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        errs = {}

        def check(name, got, ref, rtol=DIST_RTOL):
            err = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
            errs[name] = err
            log(f"phase 15 {name}: max|err| / max|ref| {err:.3e} (limit {rtol})")
            if not err <= rtol:
                fail(f"{name} on NCCL disagrees with the unsharded function")

        n = DIST_GRID
        mesh = make_mesh(ParallelConfig(), device=dev)
        u, k_sq, s = rnd(8, n, n, 2), 0.5 + rnd(8, n, n).abs(), rnd(8, n, n, 2)
        st = make_stencil_operator(n, n, 8, 2.0, 1.0, order=4, device=dev)
        r = halo.make_sharded_stencil_residual(mesh, st)(*halo.spatial_put(mesh, (u, k_sq, s)))
        ref = helmholtz_residual_stencil(st, u, k_sq, s)
        check(f"15a halo stencil residual 8 x {n}^2", r, ref)
        check("15a its norm", halo.make_sharded_residual_norm(mesh)(r),
              torch.sqrt(torch.mean(ref**2, dim=(1, 2, 3))), DIST_NORM_RTOL)
        op = make_operator(n, n, 8, 2.0, 1.0, device=dev)
        rows = Sharding(mesh, ("data", "y"))
        r = dfft.make_sharded_residual_fft(mesh, op)(
            *(multihost.put_global(t, rows) for t in (u, k_sq, s)))
        check(f"15b slab-FFT residual 8 x {n}^2", r, helmholtz_residual(op, u, k_sq, s, "fft"))
        n3 = DIST_GRID3D
        mesh3 = make_mesh3d(device=dev)
        op3 = make_operator3d(n3, n3, n3, 8, 2.0, 1.0, device=dev)
        u3, k3, s3 = rnd(2, n3, n3, n3, 2), 0.5 + rnd(2, n3, n3, n3).abs(), rnd(2, n3, n3, n3, 2)
        ref3 = helmholtz_residual3d(op3, u3, k3, s3, "matmul")
        args3 = slab3d.slab_put(mesh3, (u3, k3, s3))
        times = {}
        for method in ("transpose", "scatter", "overlap"):
            fn = slab3d.make_sharded_residual3d(mesh3, op3, method=method)
            check(f"15c z-slab residual '{method}' 2 x {n3}^3", fn(*args3), ref3)
            times[method] = cuda_ms(lambda fn=fn: fn(*args3), 20, graph=False)
        times["unsharded"] = cuda_ms(lambda: helmholtz_residual3d(op3, u3, k3, s3, "matmul"),
                                     20, graph=False)
        log(f"phase 15c device ms a 2 x {n3}^3 residual: "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
        check("15c its norm", slab3d.make_sharded_residual_norm3d(mesh3)(ref3),
              torch.sqrt(torch.mean(ref3**2, dim=(1, 2, 3, 4))), DIST_NORM_RTOL)
        host = np.random.default_rng(15).standard_normal((8, 64, 64, 2)).astype(np.float32)
        for sh in (data_sharding(mesh), spatial_sharding(mesh), rows):
            back = multihost.fetch_global(multihost.put_global(host, sh), sh)
            if not np.array_equal(back, host):
                fail(f"put_global / fetch_global changed the array ({sh.spec})")
        log("phase 15d put_global / fetch_global round trips: equal")
        out.update(errors=errs, slab3d_ms=times)
        # (e) a data=1 mesh Trainer against the plain one
        cfg_t = cfg.replace(training=dataclasses.replace(
            cfg.training, buffer_size=DIST_TRAIN_MAPS))
        maps = load_maps(cfg.medium.train_set)[:DIST_TRAIN_MAPS]
        runs = {}
        with deterministic_cudnn():
            for kind, kw in (("plain", {}), ("mesh data=1", {"mesh": mesh})):
                tr = Trainer(cfg_t, params=params, device=dev, **kw)
                tr.fill_buffer(maps)
                torch.cuda.synchronize()
                t = time.perf_counter()
                stats = tr.training_epoch(maps)
                torch.cuda.synchronize()
                runs[kind] = (tr, stats, time.perf_counter() - t)
        (ta, sa, wa), (tb, sb, wb) = runs.values()
        loss_diff = abs(sb["train_loss_mean"] - sa["train_loss_mean"]) / abs(sa["train_loss_mean"])
        from helmnet_tpu_torch.models.hybridnet import iter_leaves

        leaf_diff = max(
            ((a - b).abs().max() / a.abs().max().clamp_min(1e-30)).item()
            for (_, a), (_, b) in zip(iter_leaves(ta.params), iter_leaves(tb.params)))
        wf_diff = np.abs(ta.buffer.wavefield - tb.buffer.wavefield).max() / max(
            np.abs(ta.buffer.wavefield).max(), 1e-30)
        steps = sa["global_step"]
        log(f"phase 15e Trainer mesh data=1 against the plain Trainer, {steps} steps "
            f"(batch {cfg.training.train_batch_size} x {cfg.geometry.domain_size}^2, "
            f"cuDNN deterministic): loss rel diff {loss_diff:.3e}, params "
            f"{leaf_diff:.3e}, written-back wavefields {wf_diff:.3e} (limit "
            f"{DIST_TRAIN_RTOL}); epoch wall {wa:.3f} / {wb:.3f} s")
        if steps != 3 or max(loss_diff, leaf_diff, wf_diff) > DIST_TRAIN_RTOL:
            fail("the data=1 mesh Trainer disagrees with the plain one")
        out.update(train_loss_rel_diff=loss_diff, train_param_rel_diff=leaf_diff,
                   train_wavefield_rel_diff=float(wf_diff), epoch_s={"plain": wa, "mesh": wb})
        launched = hand_kernels()
        if any(launched):
            fail(f"hand kernels launched on the distribution path: {launched}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 15 done in {out['seconds']:.1f} s")
    return out


def last_slice_phase(dev, cfg_kernel, cfg_cudnn, hand_kernels) -> dict:
    """Phase 16: the last modules of the port. (a) the transcranial skull
    solve at full size, as `produce_figures --skull` runs it; (b)
    `produce_figures`' compute path without drawing; (c) the sanitizers on
    the card; (d) the dry run on one card. Every gate failure exits; the
    returned dict holds what was measured. `hand_kernels()` reads the
    launch counts of K2a, K2b, K2c, K1 and K3."""
    from helmnet_tpu_torch import dryrun
    from helmnet_tpu_torch.cli.produce_figures import skull_solve, truth_errors
    from helmnet_tpu_torch.core.config import Config
    from helmnet_tpu_torch.core.sanitize import checked
    from helmnet_tpu_torch.data.ellipses import make_dataset
    from helmnet_tpu_torch.eval.harness import compare_solvers
    from helmnet_tpu_torch.models.hybridnet import iter_leaves
    from helmnet_tpu_torch.ops.double_conv import (double_conv_plain, fused_double_conv,
                                                   prepare, tile_for)
    from helmnet_tpu_torch.ops.stencil import make_stencil_operator
    from helmnet_tpu_torch.solvers.gmres import solve_helmholtz, solve_helmholtz_checked
    from helmnet_tpu_torch.solvers.iterative import IterativeSolver, rollout
    from helmnet_tpu_torch.train.loop import Trainer
    from helmnet_tpu_torch.weights import load_params_npz

    t0 = time.perf_counter()
    out = {}
    steps = 14  # K1 launches a learned step (phase 4)
    params = load_params_npz(R2C_NPZ, cfg_kernel, device=dev)

    # -- 16a: the skull solve at 512^2 -----------------------------------------
    # the CLI's config (Config(), `from_params_npz`'s default) on K1
    base = Config()
    cfg_skull = base.replace(model=dataclasses.replace(base.model, double_conv_mode="pallas"))
    n = SKULL_GRID
    gen = torch.Generator(device=dev).manual_seed(16)
    k1_check = {}
    for name, p, m, cins in step_calls(params, cfg_skull.model, n):
        parts = tuple(torch.randn((1, m, m, c), generator=gen, device=dev) for c in cins)
        ref_out = double_conv_plain(p, parts)
        got_out = fused_double_conv(prepare(p), parts)
        torch.cuda.synchronize()
        err = (got_out - ref_out).abs().max().item()
        scale = ref_out.abs().max().item()
        ok = bool(torch.isfinite(got_out).all()) and err <= KERNEL_RTOL * scale
        k1_check[name] = {"grid": m, "tile": list(tile_for(1, m, m)), "max_abs_err": err,
                          "atol": KERNEL_RTOL * scale}
        log(f"phase 16a K1 {name:20s} 1 x {m}^2, tile {tile_for(1, m, m)}: max|err| "
            f"{err:.3e} (atol {KERNEL_RTOL * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K1 disagrees with its plain version at {name}, 1 x {m}^2")
    out["k1_against_plain"] = k1_check
    solver = IterativeSolver(cfg_skull, params=params, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    sos, res = skull_solve(solver, n, SKULL_ITERS)
    torch.cuda.synchronize()
    skull_s = time.perf_counter() - t
    counts = hand_kernels()
    rmse = res["rmse"][:, 0].cpu().numpy()
    _, ref = skull_solve(IterativeSolver(base, params=params, device=dev), n, 4)
    ref_rmse = ref["rmse"][:, 0].cpu().numpy()
    early = np.abs(rmse[:4] - ref_rmse) / ref_rmse
    finite = np.isfinite(rmse)
    best_at = int(np.argmin(np.where(finite, rmse, np.inf)))
    blow_up = int(np.argmin(finite)) if not finite.all() else None
    prof = profile_steps(lambda k: rollout(solver.params, solver.op, solver.source, sos[None],
                                           cfg=solver.cfg, num_iterations=k, device=dev),
                         SKULL_PROFILE_STEPS)
    gps = n * n * SKULL_ITERS / skull_s
    log(f"phase 16a skull_example_problem({n}) x {SKULL_ITERS} ('pallas', tpu_r2c): "
        f"{skull_s:.2f} s, {gps:.4e} gridpoints/s, launches K2a/K2b/K2c/K1/K3 {counts}; "
        f"rmse {rmse[0]:.4e}, best {rmse[best_at]:.4e} at iteration {best_at + 1} (bound "
        f"first / {SKULL_DROP}), first non-finite at {blow_up}, last {rmse[-1]:.4e}; first "
        f"4 against 'xla' f32 max rel diff {early.max():.3e} (rtol {EARLY_RTOL}); profile "
        f"of {SKULL_PROFILE_STEPS} steps: wall {prof['wall_ms_per_step']:.3f} ms, device "
        f"{prof['device_ms_per_step']:.3f} ms a step, busy share {prof['busy_share']:.4f}")
    if counts != (0, 0, 0, steps * SKULL_ITERS, 0):
        fail(f"the skull solve launched {counts}, not {steps * SKULL_ITERS} K1 alone")
    # tpu_r2c diverges on this problem after its best iterate, on K1 and on
    # cuDNN f32 alike (PERF.md, Findings): what the CLI draws is the best
    # iterate, which `forward` returns
    if not (rmse[best_at] <= rmse[0] / SKULL_DROP
            and bool(torch.isfinite(res["wavefield"]).all())):
        fail("the skull solve's best iterate is not finite or not below the first / "
             f"{SKULL_DROP}")
    if not early.max() <= EARLY_RTOL:
        fail("the skull solve on K1 disagrees with the cuDNN f32 forward")
    out["skull"] = {"seconds": skull_s, "gridpoints_per_s": gps, "k1_launches": counts[3],
                    "rmse_first": float(rmse[0]), "rmse_last": float(rmse[-1]),
                    "rmse_best": float(rmse[best_at]), "best_iteration": best_at + 1,
                    "first_non_finite": blow_up, "xla_rel_diff": float(early.max()),
                    "profile": prof}

    # -- 16b: produce_figures' compute path, no drawing -------------------------
    fsolver = IterativeSolver.from_params_npz(R2C_NPZ, device=dev)  # the CLI's solver
    maps = make_dataset(FIG_MAPS, fsolver.height, seed=123)  # the CLI's generated maps
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fwd = fsolver.forward(maps, num_iterations=FIG_ITERS, collect=("rmse", "wavefields"),
                          decimate=FIG_ITERS)
    cmps = [compare_solvers(fsolver, m, num_iterations=FIG_ITERS, decimate=FIG_ITERS // 10,
                            gmres_restart=50, gmres_max_restarts=20, gmres_tol=1e-7)
            for m in maps]
    lm, rm, lg, rg = truth_errors(fsolver, maps, cmps)
    torch.cuda.synchronize()
    fig_s = time.perf_counter() - t
    counts = hand_kernels()
    linfs = [c.linf for c in cmps]
    log(f"phase 16b produce_figures compute ({FIG_MAPS} x {fsolver.height}^2, {FIG_ITERS} "
        f"iterations, 'xla'): {fig_s:.2f} s; l_inf vs GMRES {linfs}; vs f64 truth: learned "
        f"l_inf {lm} (bound {FIG_LINF}), GMRES {lg}; launches {counts}")
    every = np.array(linfs + lm + rm + lg + rg)
    if not (np.all(np.isfinite(every)) and bool(torch.isfinite(fwd["rmse"]).all())):
        fail("produce_figures' compute path gave non-finite errors")
    if not max(lm) <= FIG_LINF:
        fail("the learned solve's l_inf against the f64 truth is above its bound")
    if any(counts):
        fail(f"hand kernels launched on the 'xla' figures path: {counts}")
    out["figures"] = {"seconds": fig_s, "linf_vs_gmres": linfs, "learned_linf": lm,
                      "learned_rmse": rm, "gmres_linf": lg, "gmres_rmse": rg}

    # -- 16c: the sanitizers -----------------------------------------------------
    sos96 = np.load("datasets/splitted_96/testset.npz")["maps"][:SANITIZE_MAPS]
    solver96 = IterativeSolver(cfg_kernel, params=params, device=dev)
    src96 = solver96.source.expand(SANITIZE_MAPS, -1, -1, -1)

    def run():
        return rollout(params, solver96.op, src96, sos96, cfg=cfg_kernel,
                       num_iterations=SANITIZE_ITERS, device=dev)

    with deterministic_cudnn():
        run()  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain = run()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        reset_counts()
        t = time.perf_counter()
        chk = checked(run)()
        torch.cuda.synchronize()
        chk_s = time.perf_counter() - t
    counts = hand_kernels()
    same = all(torch.equal(plain[k], chk[k]) for k in ("wavefield", "residual", "rmse"))
    log(f"phase 16c checked rollout {SANITIZE_MAPS} x {GRID}^2 x {SANITIZE_ITERS} "
        f"('pallas'): equal to the unchecked one to the bit: {same}; wall {chk_s:.4f} s "
        f"against {plain_s:.4f} s ({chk_s / plain_s:.2f}x); launches {counts}")
    if not same or counts != (0, 0, 0, steps * SANITIZE_ITERS, 0):
        fail("the checked rollout differs from the unchecked one, or its launches do")
    x = torch.randn((SANITIZE_MAPS, GRID, GRID, cfg_kernel.model.in_channels),
                    generator=gen, device=dev)
    x[0, 5, 5, 0] = float("nan")
    try:
        checked(fused_double_conv)(prepare(params["inc"]), x)
        fail("a NaN in K1's input raised nothing under checked")
    except FloatingPointError as e:
        k1_msg = str(e)
    log(f"phase 16c a NaN in K1's input: {k1_msg}")
    if "K1 (fused_double_conv" not in k1_msg:
        fail("the NaN that went through K1 is not named by K1")
    cfg_t = cfg_cudnn.replace(training=dataclasses.replace(
        cfg_cudnn.training, buffer_size=SANITIZE_MAPS, train_batch_size=4, unrolling_steps=3))
    with deterministic_cudnn():
        ta = Trainer(cfg_t, params=params, sanitize=True, device=dev)
        tb = Trainer(cfg_t, params=params, device=dev)
        ta.fill_buffer(sos96)
        batch = ta._to_device(ta.buffer.sample(4))
        ma, _ = ta._train_step(batch, 1)
        mb, _ = tb._train_step(batch, 1)
    clean = float(ma["loss"]) == float(mb["loss"]) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(iter_leaves(ta.params),
                                                    iter_leaves(tb.params)))
    before = {k: v.detach().clone() for k, v in iter_leaves(ta.params)}
    state = {i: {k: v.clone() for k, v in s.items()}
             for i, s in ta.optimizer.state_dict()["state"].items()}
    wf = batch.wavefield.clone()
    wf[0, 5, 5, 0] = float("nan")
    try:
        ta._train_step(batch._replace(wavefield=wf), 1)
        fail("a poisoned train step raised nothing with sanitize=True")
    except FloatingPointError as e:
        step_msg = str(e)
    after = ta.optimizer.state_dict()["state"]
    unchanged = all(torch.equal(v.detach(), before[k]) for k, v in iter_leaves(ta.params)) \
        and all(torch.equal(after[i][k], v) for i, s in state.items() for k, v in s.items())
    log(f"phase 16c Trainer(sanitize=True) clean step equal to sanitize=False: {clean}; "
        f"poisoned step: {step_msg}; params and Adam state unchanged: {unchanged}")
    if not (clean and unchanged):
        fail("the sanitized train step changed a clean step, or a raising one changed state")
    st = make_stencil_operator(GRID, GRID, cfg_kernel.geometry.pml_size,
                               cfg_kernel.geometry.sigma_max, cfg_kernel.k0, order=4,
                               device=dev)
    k_sq = (cfg_kernel.source.omega / torch.tensor(sos96[0], device=dev)) ** 2
    gm = dict(restart=20, max_restarts=10, tol=1e-6, device=dev)
    reset_counts()
    good = solve_helmholtz_checked(st, k_sq, solver96.source[0], **gm)
    counts = hand_kernels()
    plain_gm = solve_helmholtz(st, k_sq, solver96.source[0], **gm)
    rn, rn_plain = good.residual_norms.cpu().numpy(), plain_gm.residual_norms.cpu().numpy()
    bad = k_sq.clone()
    bad[40, 40] = float("nan")
    try:
        solve_helmholtz_checked(st, bad, solver96.source[0], **gm)
        fail("solve_helmholtz_checked took a NaN medium")
    except FloatingPointError as e:
        gm_msg = str(e)
    log(f"phase 16c solve_helmholtz_checked (StencilPML order 4, {GRID}^2, restart 20 x "
        f"10): residual {rn[0]:.4e} -> {rn[-1]:.4e}, unchecked {rn_plain[-1]:.4e}; "
        f"launches {counts}; a NaN medium: {gm_msg}")
    if not (rn[-1] <= rn[0] / 10 and np.allclose(rn, rn_plain, rtol=1e-6)
            and counts[0] > 0 and not any(counts[1:])):
        fail("the checked GMRES on the stencil did not converge as the unchecked one")
    if "K2a (residual_planes" not in gm_msg:
        fail("the NaN medium is not named by K2a")
    out["sanitize"] = {"rollout_equal": same, "checked_s": chk_s, "plain_s": plain_s,
                       "overhead": chk_s / plain_s, "k1_launches": steps * SANITIZE_ITERS,
                       "k1_message": k1_msg, "train_clean_equal": clean,
                       "train_message": step_msg, "gmres_residual": rn.tolist(),
                       "k2a_launches": counts[0], "gmres_message": gm_msg}

    # -- 16d: the dry run on one card ------------------------------------------
    fn, args = dryrun.entry(device=dev)
    got = fn(*args)
    fn_cpu, args_cpu = dryrun.entry(device="cpu")
    want = fn_cpu(*args_cpu)
    entry_err = max(((g.cpu() - w).abs().max() / w.abs().max()).item()
                    for g, w in zip(got, want))
    log(f"phase 16d dryrun.entry() on the card against the CPU: max|err| / max|ref| "
        f"{entry_err:.3e} (limit {DRYRUN_RTOL})")
    if not entry_err <= DRYRUN_RTOL:
        fail("dryrun.entry() on the card disagrees with the CPU")
    with world_of_one(dev):
        t = time.perf_counter()
        dryrun.dryrun_multichip(1, device=dev)
        dry_s = time.perf_counter() - t
    out["dryrun"] = {"entry_rel_err": entry_err, "multichip_s": dry_s}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 16 done in {out['seconds']:.1f} s")
    return out


def split_grid_phase(dev, cfg, cfg_kernel, cfg_cudnn, params, hand_kernels) -> dict:
    """Phase 17: the single-card end of the grid split over y and x at
    1024^2 (its multi-rank behaviour is held against the JAX package on
    gloo ranks by tests/test_torch_spatial_cases.py): (a) the fft operator
    against the matmul one, and `laplacian(mode='fft', spatial=)` on a
    world-size-1 NCCL mesh with its gradient against the unsplit one; (b)
    the 1024^2 train step of TRAINING1024.md (fft operator, device buffer)
    against its matmul twin; (c) a 1024^2 rollout with the tpu_r2c weights
    on K1. Every gate failure exits; the returned dict holds what was
    measured. `hand_kernels()` reads the launch counts of K2a, K2b, K2c, K1
    and K3."""
    from helmnet_tpu_torch.core.config import ParallelConfig
    from helmnet_tpu_torch.core.meshes import make_mesh
    from helmnet_tpu_torch.data.ellipses import make_dataset
    from helmnet_tpu_torch.distributed.spatial import Spatial, _AxisAllToAll
    from helmnet_tpu_torch.models.blocks import conv2d, double_conv
    from helmnet_tpu_torch.ops.double_conv import (double_conv_plain, fused_double_conv,
                                                   prepare, tile_for)
    from helmnet_tpu_torch.ops.source import point_source_map
    from helmnet_tpu_torch.ops.spectral import (helmholtz_residual, laplacian,
                                                laplacian_fft, make_operator)
    from helmnet_tpu_torch.solvers.iterative import rollout
    from helmnet_tpu_torch.train.loop import Trainer
    from helmnet_tpu_torch.weights import load_params_npz

    t0 = time.perf_counter()
    n, out = SPLIT_GRID, {}
    g = cfg.geometry
    gen = torch.Generator(device=dev).manual_seed(17)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    rel = lambda a, b: (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)

    # -- 17a: the fft operator at 1024^2 ------------------------------------------
    reset_counts()
    op = make_operator(n, n, g.pml_size, g.sigma_max, cfg.k0, device=dev)
    b = SPLIT_OP_BATCH
    u, k_sq, src = rnd(b, n, n, 2), 0.5 + rnd(b, n, n).abs(), rnd(b, n, n, 2)
    r_fft = helmholtz_residual(op, u, k_sq, src, "fft")
    r_mm = helmholtz_residual(op, u, k_sq, src, "matmul")
    modes_err = rel(r_fft, r_mm)
    ms = {mode: cuda_ms(lambda mode=mode: helmholtz_residual(op, u, k_sq, src, mode), 10,
                        graph=False) for mode in ("fft", "matmul", "fft", "matmul")}
    with world_of_one(dev) as backend:
        mesh = make_mesh(ParallelConfig(), device=dev)
        sp = Spatial(mesh, n, n, 0)
        weights = rnd(b, n, n, 2)
        grads = []
        for spatial in (None, sp):
            x = u.clone().requires_grad_(True)
            lap = (laplacian_fft(op, x) if spatial is None
                   else laplacian(op, x, "fft", spatial=spatial))
            torch.sum(lap * weights).backward()
            grads.append((lap.detach(), x.grad))
        split_err, grad_err = rel(grads[1][0], grads[0][0]), rel(grads[1][1], grads[0][1])
        # the autograd all-to-all itself: at world size 1 the identity, both ways
        x = u.clone().requires_grad_(True)
        y = _AxisAllToAll.apply(x, mesh, "y", 2, 1)
        y.backward(weights)
        a2a_equal = bool(torch.equal(y, u) and torch.equal(x.grad, weights))
    log(f"phase 17a helmholtz_residual {b} x {n}^2: fft against matmul max|err| / "
        f"max|ref| {modes_err:.3e} (limit {SPLIT_RTOL}); device ms fft {ms['fft']:.4f}, "
        f"matmul {ms['matmul']:.4f}; laplacian(mode='fft', spatial=) on a {backend} mesh "
        f"of world size 1 against laplacian_fft {split_err:.3e}, its input gradient "
        f"{grad_err:.3e} (limit {SPLIT_RTOL}); the autograd all-to-all the identity "
        f"both ways: {a2a_equal}")
    if backend != "nccl" or not max(modes_err, split_err, grad_err) <= SPLIT_RTOL:
        fail("the fft operator disagrees at 1024^2 (against matmul or on the mesh)")
    if not a2a_equal:
        fail("the autograd all-to-all is not the identity at world size 1")
    out["operator"] = {"fft_vs_matmul": modes_err, "device_ms": ms,
                       "split_vs_unsplit": split_err, "split_grad": grad_err}
    del u, k_sq, src, r_fft, r_mm, weights, grads, x, y

    # -- 17b: the 1024^2 train step (TRAINING1024.md) -----------------------------
    scale = n / g.domain_size
    loc = tuple(int(round(c * scale)) for c in cfg.source.location)
    cfg_t = cfg.replace(
        geometry=dataclasses.replace(g, domain_size=n),
        source=dataclasses.replace(cfg.source, location=loc),
        training=dataclasses.replace(cfg.training, **SPLIT_TRAIN))
    maps = make_dataset(SPLIT_TRAIN["buffer_size"], n, seed=42)
    losses, walls = {}, {}
    with deterministic_cudnn():
        for mode, steps in (("auto", SPLIT_TRAIN_STEPS), ("matmul", 1)):
            tr = Trainer(cfg_t.replace(operator_mode=mode), params=params, device=dev,
                         device_buffer=True)
            tr.fill_buffer(maps)
            maxiter = tr.max_allowed_iterations()
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for _ in range(steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                metrics = tr.device_step(maxiter)
                runs.append((float(metrics["loss"]), time.perf_counter() - t))
            losses[mode] = [r[0] for r in runs]
            walls[mode] = [r[1] for r in runs]
            if mode == "auto":
                peak_gib = torch.cuda.max_memory_allocated() / 2**30
                prof = profile_steps(
                    lambda k: [tr.device_step(maxiter) for _ in range(k)], 2)
            del tr
    gap = abs(losses["matmul"][0] - losses["auto"][0]) / abs(losses["matmul"][0])
    launched = hand_kernels()
    log(f"phase 17b Trainer at {n}^2 (experiments/base.json, source {loc}, buffer "
        f"{SPLIT_TRAIN['buffer_size']}, batch {SPLIT_TRAIN['train_batch_size']} x "
        f"{SPLIT_TRAIN['unrolling_steps']} unrolled, remat, device buffer; 'auto' is fft): "
        f"losses {losses['auto']}, step 1 against matmul rel diff {gap:.3e} (limit "
        f"{SPLIT_TRAIN_RTOL}); wall per step {[round(w, 4) for w in walls['auto']]} s; "
        f"peak memory {peak_gib:.3f} GiB; profile of 2 steps: wall "
        f"{prof['wall_ms_per_step']:.3f} ms, device {prof['device_ms_per_step']:.3f} ms "
        f"a step, busy share {prof['busy_share']:.4f}; hand-kernel launches {launched}")
    if not (all(np.isfinite(losses["auto"])) and gap <= SPLIT_TRAIN_RTOL):
        fail("the 1024^2 train step is not finite or disagrees with its matmul twin")
    if any(launched):
        fail(f"hand kernels launched on the 17a-b path: {launched}")
    out["train"] = {"losses": losses["auto"], "matmul_loss": losses["matmul"][0],
                    "rel_diff": gap, "wall_s": walls["auto"], "peak_gib": peak_gib,
                    "profile": prof}
    del maps

    # -- 17c: a 1024^2 rollout with the tpu_r2c weights on K1 ---------------------
    r2c = load_params_npz(R2C_NPZ, cfg_kernel, device=dev)
    cfg_r = cfg_kernel.replace(geometry=cfg_t.geometry, source=cfg_t.source)
    cfg_x = cfg_cudnn.replace(geometry=cfg_t.geometry, source=cfg_t.source)
    sos = make_dataset(SPLIT_MAPS, n, seed=42)
    s = cfg_r.source
    source = point_source_map(n, n, loc, s.amplitude, s.phase, s.omega)[None]
    steps = 14  # K1 launches a learned step (phase 4)
    model = cfg_r.model
    rows = []
    for name, p, m, cins in step_calls(r2c, model, n):
        parts = tuple(rnd(SPLIT_MAPS, m, m, c) for c in cins)
        pw = prepare(p)
        ref_out = double_conv_plain(p, parts)
        got_out = fused_double_conv(pw, parts)
        torch.cuda.synchronize()
        err = (got_out - ref_out).abs().max().item()
        scale_ = ref_out.abs().max().item()
        if not (bool(torch.isfinite(got_out).all()) and err <= KERNEL_RTOL * scale_):
            fail(f"K1 disagrees with its plain version at {name}, {SPLIT_MAPS} x {m}^2")
        flops, ops_ms, bytes_ms, _ = bound(p, parts, got_out)

        def library(p=p, parts=parts):  # phase 5's cuDNN f32 DoubleConv
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            y = double_conv(p, x, model.activation_function, "highest")
            return conv2d(p["post"], y) if "post" in p else y

        rows.append(dict(name=name, grid=m, tile=list(tile_for(SPLIT_MAPS, m, m)),
                         max_abs_err=err, ms=cuda_ms(lambda: fused_double_conv(pw, parts), 10),
                         plain_ms=cuda_ms(lambda: double_conv_plain(p, parts), 10),
                         library_ms=cuda_ms(library, 10),
                         bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms))
        del parts, ref_out, got_out
    k1 = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                               "ops_ms", "bytes_ms")}
    k1["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    k1["bound_by"] = "operations" if k1["ops_ms"] >= k1["bytes_ms"] else "bytes"
    run = lambda cfg_, iters, collect=("rmse",): rollout(
        r2c, op, source, sos, cfg=cfg_, num_iterations=iters, collect=collect, device=dev)
    run(cfg_r, 2)  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = run(cfg_r, SPLIT_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = hand_kernels()
    rmse = res["rmse"].cpu().numpy()
    with deterministic_cudnn():
        ref = run(cfg_x, 4)["rmse"].cpu().numpy()
    early = (np.abs(rmse[:4] - ref) / ref).max()
    prof = profile_steps(lambda k: run(cfg_r, k), SPLIT_PROFILE_STEPS)
    gps = SPLIT_MAPS * n * n * SPLIT_ITERS / wall
    log(f"phase 17c rollout {SPLIT_MAPS} x {n}^2 x {SPLIT_ITERS} ('pallas', tpu_r2c, fft "
        f"operator): {wall:.3f} s, {gps:.4e} gridpoints/s, launches K2a/K2b/K2c/K1/K3 "
        f"{counts}; rmse {rmse[0].max():.4e} -> {rmse[-1].max():.4e}, first 4 against "
        f"'xla' f32 max rel diff {early:.3e} (rtol {EARLY_RTOL}); K1 a step (14 calls at "
        f"{SPLIT_MAPS} x {n}^2 and below, max|err| {k1['max_abs_err']:.3e}): "
        f"{k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, cuDNN {k1['library_ms']:.4f} "
        f"ms, bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}); profile of {SPLIT_PROFILE_STEPS} steps: wall "
        f"{prof['wall_ms_per_step']:.3f} ms, device {prof['device_ms_per_step']:.3f} ms "
        f"a step, busy share {prof['busy_share']:.4f}")
    if counts != (0, 0, 0, steps * SPLIT_ITERS, 0):
        fail(f"the 1024^2 rollout launched {counts}, not {steps * SPLIT_ITERS} K1 alone")
    if not (np.isfinite(rmse).all() and early <= EARLY_RTOL):
        fail("the 1024^2 rollout on K1 is not finite or disagrees with cuDNN f32")
    out["rollout"] = {"seconds": wall, "gridpoints_per_s": gps, "k1_launches": counts[3],
                      "rmse": rmse[[0, -1]].tolist(), "early_rel_diff": float(early),
                      "k1_step": k1, "k1_calls": rows, "profile": prof}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 17 done in {out['seconds']:.1f} s")
    return out


def cslp_split_phase(dev, cfg, hand_kernels) -> dict:
    """Phase 18: the CSLP preconditioner on the split grid's path at 1024^2
    on an NCCL mesh of world size 1, where the exchanges are the identity
    (its multi-rank behaviour is held against the JAX package on gloo
    ranks by tests/test_torch_spatial_cases.py): the split inverse
    against the unsplit one on a seeded field; `solve_helmholtz(...,
    precond='shifted_laplace')` with the fft operator on phase 17b's first
    map, through `spatial=` and without, and the same solve
    unpreconditioned. Every gate failure exits; the returned dict holds
    what was measured. `hand_kernels()` reads the launch counts of K2a,
    K2b, K2c, K1 and K3: none runs here."""
    from helmnet_tpu_torch.core.config import ParallelConfig
    from helmnet_tpu_torch.core.meshes import make_mesh
    from helmnet_tpu_torch.data.ellipses import make_dataset
    from helmnet_tpu_torch.distributed.spatial import Spatial
    from helmnet_tpu_torch.ops.source import point_source_map
    from helmnet_tpu_torch.ops.spectral import helmholtz_residual, make_operator
    from helmnet_tpu_torch.solvers.gmres import solve_helmholtz
    from helmnet_tpu_torch.solvers.precond import make_shifted_laplace_inverse

    t0 = time.perf_counter()
    n, g, s = SPLIT_GRID, cfg.geometry, cfg.source
    loc = tuple(int(round(c * n / g.domain_size)) for c in s.location)
    sos = make_dataset(1, n, seed=42)[0]  # the first of phase 17b's maps
    k_sq = torch.tensor((cfg.k0 / sos) ** 2, dtype=torch.float32, device=dev)
    src = torch.tensor(point_source_map(n, n, loc, s.amplitude, s.phase, s.omega),
                       device=dev)
    bnorm = torch.linalg.vector_norm(src).item()
    op = make_operator(n, n, g.pml_size, g.sigma_max, cfg.k0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    v = torch.complex(*(torch.randn((n, n), generator=gen, device=dev) for _ in range(2)))

    def solve(spatial, precond):
        return solve_helmholtz(op, k_sq, src, mode="fft", restart=CSLP_RESTART,
                               max_restarts=CSLP_CYCLES, tol=CSLP_TOL, precond=precond,
                               device=dev, spatial=spatial)

    with world_of_one(dev) as backend:
        sp = Spatial(make_mesh(ParallelConfig(), device=dev), n, n, 0)
        ref = make_shifted_laplace_inverse(op, k_sq)(v)
        got = make_shifted_laplace_inverse(op, k_sq, spatial=sp)(v)
        inv_err = (got - ref).abs().max().item() / ref.abs().max().item()
        del v, ref, got
        runs = {}
        reset_counts()
        for name, spatial, precond in (("split", sp, "shifted_laplace"),
                                       ("whole", None, "shifted_laplace"),
                                       ("none", None, "none")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = solve(spatial, precond)
            torch.cuda.synchronize()
            runs[name] = {"wall_s": time.perf_counter() - t,
                          "relres": (res.residual_norms / bnorm).cpu().numpy()}
            if name == "split":
                x_split = res.x
        launched = hand_kernels()
        prof = profile_steps(
            lambda k: [solve(sp, "shifted_laplace") for _ in range(k)], 1)
    # the reported final residual against one recomputed with the matmul
    # operator from the returned x = M^-1 y
    true = torch.linalg.vector_norm(helmholtz_residual(
        op, x_split[None], k_sq[None], src[None], mode="matmul")).item() / bnorm
    split, whole, plain = (runs[k]["relres"] for k in ("split", "whole", "none"))
    ratio = split / whole
    true_gap = abs(true - split[-1]) / split[-1]
    log(f"phase 18 CSLP on the split grid at {n}^2 ({backend} mesh of world size 1, "
        f"fft operator, source {loc}): the split inverse against the unsplit one "
        f"max|err| / max|ref| {inv_err:.3e} (limit {CSLP_RTOL}); GMRES({CSLP_RESTART}) x "
        f"{CSLP_CYCLES} true relative residual split {split[-1]:.4e}, whole "
        f"{whole[-1]:.4e}, unpreconditioned {plain[-1]:.4e}; split over whole at each "
        f"cycle {ratio.min():.4f}..{ratio.max():.4f} (limit {CSLP_HISTORY}x); reported "
        f"against recomputed (matmul) {true_gap:.3e} (rtol {RELRES_RTOL}); wall split "
        f"{runs['split']['wall_s']:.3f} s, whole {runs['whole']['wall_s']:.3f} s, "
        f"unpreconditioned {runs['none']['wall_s']:.3f} s; profile of the split solve: "
        f"wall {prof['wall_ms_per_step']:.1f} ms, device {prof['device_ms_per_step']:.1f} "
        f"ms, busy share {prof['busy_share']:.4f}; hand-kernel launches {launched}")
    if backend != "nccl":
        fail(f"the process group runs on {backend}, not NCCL")
    if not inv_err <= CSLP_RTOL:
        fail("the split CSLP inverse disagrees with the unsplit one at 1024^2")
    if not all(np.isfinite(r["relres"]).all() for r in runs.values()):
        fail("a CSLP solve at 1024^2 is not finite")
    if not (np.all(ratio <= CSLP_HISTORY) and np.all(ratio >= 1 / CSLP_HISTORY)):
        fail("the split CSLP solve's residual history departs from the unsplit one")
    if not split[-1] < plain[-1]:
        fail("the CSLP preconditioner did not lower the residual at 1024^2")
    if not true_gap <= RELRES_RTOL:
        fail("the split CSLP solve's reported residual is not its true one")
    if any(launched):
        fail(f"hand kernels launched on the CSLP path: {launched}")
    out = {"inverse_rel_err": inv_err, "true_relres": true,
           **{k: {"wall_s": r["wall_s"], "relres": r["relres"].tolist()}
              for k, r in runs.items()},
           "profile": prof, "seconds": time.perf_counter() - t0}
    log(f"phase 18 done in {out['seconds']:.1f} s")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from helmnet_tpu_torch import _build
    from helmnet_tpu_torch.core.config import Config
    from helmnet_tpu_torch.core.device import resolve_device
    from helmnet_tpu_torch.data.ellipses import load_maps
    from helmnet_tpu_torch.models.blocks import conv2d, double_conv
    from helmnet_tpu_torch.models.hybridnet import params_to
    from helmnet_tpu_torch.models.packed import pack_params, prepare_k3, rollout_packed
    from helmnet_tpu_torch.ops.double_conv import TILES as K1_TILES
    from helmnet_tpu_torch.ops.double_conv import (double_conv_plain, fused_double_conv,
                                                   prepare, tile_for)
    from helmnet_tpu_torch.ops.packed_double_conv import packed_double_conv
    from helmnet_tpu_torch.ops.packed_double_conv import TILES as K3_TILES
    from helmnet_tpu_torch.solvers.iterative import IterativeSolver, rollout
    from helmnet_tpu_torch.weights import load_params_npz

    # -- 1. device ---------------------------------------------------------
    dev = resolve_device()  # cuda, TF32 off
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1 device: {kind} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    log(f"nvidia-smi: {smi}")

    # -- 2. build ----------------------------------------------------------
    built = _build.build(force=True)
    log(f"phase 2 build: {built.path.name} in {built.seconds:.1f} s (nvcc's "
        f"output: `build_log` of --out)")
    lib = _build.load_library()
    # K1: <TH, TW, warps, CS, CMP, COP>; K3: <TH, TW, CMP, COP, stages>,
    # the cluster K3: <TH, TW, stages>, its shared memory a CTA the same at
    # every width; K3's is dynamic (hn_packed_double_conv_smem); K2:
    # <radius, instance> (0 scalar, 1 planes, 2 pairs)
    resources = ptxas_table(built.log)
    for r in resources:
        if r["kernel"] == "K3":
            th, tw = r["args"][:2]
            cmp_, cop_ = (256, 256) if r["wide"] else r["args"][2:4]
            r["smem"] = lib.hn_packed_double_conv_smem(K3_TILES.index((th, tw)),
                                                       cmp_, cop_)
        log(f"phase 2 {r['kernel']} <{', '.join(map(str, r['args']))}>: "
            f"{r['registers']} registers, {r['smem']} B shared memory, spills "
            f"{r['spill_stores']} B stored / {r['spill_loads']} B loaded")
    if {r["kernel"] for r in resources} != {"K1", "K3", "K2"}:
        fail("the build log names no instance of K1, of K3 or of K2")

    cfg = Config.from_json_file("experiments/base.json")
    model = dataclasses.replace(cfg.model, precision="default",
                                double_conv_mode="pallas", up_mode="subpixel")
    cfg_kernel = cfg.replace(model=model)
    cfg_cudnn = cfg.replace(model=dataclasses.replace(model, double_conv_mode="xla"))
    params = load_params_npz("trained_models/round1_best_epoch890.npz", cfg, device=dev)

    # -- 3. kernel against plain version -----------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for name, p, n, cins in step_calls(params, model, GRID):
        parts = tuple(torch.randn((BATCH, n, n, c), generator=gen, device=dev)
                      for c in cins)
        pw = prepare(p)  # as the rollout prepares them, once
        ref = double_conv_plain(p, parts)
        got = fused_double_conv(pw, parts)
        converted = fused_double_conv(p, parts)  # weights converted in the call
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale
        tile = tile_for(BATCH, n, n)
        log(f"phase 3 {name:20s} {'+'.join(map(str, cins)):>4s} -> "
            f"{p['c1']['w'].shape[0]} -> {got.shape[-1]} @{n}^2, tile "
            f"{tile[0]}x{tile[1]}: max|err| {err:.3e} (atol "
            f"{KERNEL_RTOL * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"kernel disagrees with its plain version at {name}")
        if not torch.equal(got, converted):
            fail(f"prepared and converted weights differ at {name}")
        cases.append(dict(name=name, grid=n, cins=list(cins), params=p, pw=pw,
                          parts=parts, out=got, max_abs_err=err, tile=list(tile)))
    # the NaN gate at one call (two parts and the head) at each output tile
    c = cases[-1]
    nan_gates = [nan_gate("3", f"K1 {c['name']} tile {t[0]}x{t[1]}",
                          lambda xs, t=t: fused_double_conv(c["pw"], xs, tile=t),
                          c["params"], c["parts"], seed=1600 + i)
                 for i, t in enumerate(K1_TILES)]

    # -- 4. main path --------------------------------------------------------
    sos = np.load("datasets/splitted_96/testset.npz")["maps"][:BATCH]
    solver = IterativeSolver(cfg_kernel, params=params)
    fused_double_conv.launches = packed_double_conv.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = solver.forward(sos, num_iterations=ITERS)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = fused_double_conv.launches
    if packed_double_conv.launches:
        fail(f"{packed_double_conv.launches} K3 launches on the unpacked path")
    rmse = out["rmse"].cpu().numpy()
    wf = out["wavefield"]
    log(f"phase 4 main path: {ITERS} iterations in {first_s:.2f} s, "
        f"{launches} kernel launches; mean rmse {rmse[0].mean():.4e} -> "
        f"{rmse[-1].mean():.4e}")
    calls_per_step = len(cases)
    if launches != calls_per_step * ITERS:
        fail(f"{launches} kernel launches, expected {calls_per_step} x {ITERS}")
    if rmse.shape != (ITERS, BATCH) or not np.all(np.isfinite(rmse)):
        fail("rmse trace is not finite or has the wrong shape")
    if tuple(wf.shape) != (BATCH, GRID, GRID, 2) or not bool(torch.isfinite(wf).all()):
        fail("wavefield is not finite or has the wrong shape")
    if not np.all(rmse[-1] < rmse[0]):
        fail("rmse at the last iteration is not below the first")
    cudnn_solver = IterativeSolver(cfg_cudnn, params=params)
    ref_rmse = cudnn_solver.forward(sos, num_iterations=ITERS)["rmse"].cpu().numpy()
    early = np.abs(rmse[:4] - ref_rmse[:4]) / np.abs(ref_rmse[:4])
    late = np.maximum(rmse[-1] / ref_rmse[-1], ref_rmse[-1] / rmse[-1])
    log(f"phase 4 against cuDNN f32: first 4 rmse max rel diff {early.max():.3e} "
        f"(rtol {EARLY_RTOL}); last rmse ratio max {late.max():.3f} "
        f"(limit {LATE_FACTOR})")
    if early.max() > EARLY_RTOL or late.max() > LATE_FACTOR:
        fail("the kernel path disagrees with the cuDNN path")
    # the port's CPU path (held against the JAX package by the tests) on a
    # small input: 2 samples, 4 iterations
    small = dict(cfg=cfg_kernel, num_iterations=4)
    src = solver.source.expand(2, -1, -1, -1)
    on_card = rollout(params, solver.op, src, sos[:2], device=dev, **small)["rmse"]
    on_cpu = rollout(params_to(params, "cpu"), solver.op.to("cpu"), src.cpu(),
                     sos[:2], device="cpu", **small)["rmse"]
    small_diff = (np.abs(on_card.cpu().numpy() - on_cpu.numpy()) / on_cpu.numpy()).max()
    log(f"phase 4 against the CPU path (2 x 96^2, 4 iterations): max rel diff "
        f"{small_diff:.3e} (rtol {EARLY_RTOL})")
    if small_diff > EARLY_RTOL:
        fail("the card disagrees with the port's CPU path")

    # -- 5. times --------------------------------------------------------------
    rows = []
    for c in cases:
        p, pw, parts = c["params"], c["pw"], c["parts"]

        def library(p=p, parts=parts):
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            y = double_conv(p, x, model.activation_function, "highest")
            return conv2d(p["post"], y) if "post" in p else y

        kernel_ms = cuda_ms(lambda: fused_double_conv(pw, parts))
        alt = K1_TILES[1 - K1_TILES.index(tuple(c["tile"]))]  # the tile not chosen
        alt_ms = cuda_ms(lambda: fused_double_conv(pw, parts, tile=alt))
        plain_ms = cuda_ms(lambda: double_conv_plain(p, parts))
        library_ms = cuda_ms(library)
        flops, ops_ms, bytes_ms, cuda_core_ms = bound(p, parts, c["out"])
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        row = dict(name=c["name"], grid=c["grid"], cins=c["cins"],
                   cmid=int(p["c1"]["w"].shape[0]), cout=int(c["out"].shape[-1]),
                   ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, ops_ms=ops_ms,
                   bytes_ms=bytes_ms, cuda_core_ms=cuda_core_ms,
                   max_abs_err=c["max_abs_err"], gflops=flops / 1e9,
                   tile=c["tile"], bound_share=bound_ms / kernel_ms,
                   tflops=flops / kernel_ms / 1e9, alt_tile=list(alt), alt_ms=alt_ms)
        rows.append(row)
        log(f"phase 5 {c['name']:20s} tile {c['tile'][0]}x{c['tile'][1]}: kernel "
            f"{kernel_ms:.4f} ms ({row['bound_share']:.3f} of its bound, "
            f"{row['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f} ms, cuDNN "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), f32 "
            f"CUDA-core ceiling {cuda_core_ms:.4f} ms; at tile {alt[0]}x{alt[1]} "
            f"{alt_ms:.4f} ms")
    rollouts = {}
    for mode, s in (("pallas", solver), ("xla", cudnn_solver),
                    ("xla", cudnn_solver), ("pallas", solver)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.forward(sos, num_iterations=ITERS)
        torch.cuda.synchronize()
        rollouts.setdefault(mode, []).append(time.perf_counter() - t)
    gps = {m: BATCH * GRID * GRID * ITERS / min(ts) for m, ts in rollouts.items()}
    log(f"phase 5 rollout {GRID}^2 x {BATCH} x {ITERS}: 'pallas' "
        f"{gps['pallas']:.4e} gridpoints/s (runs {rollouts['pallas']} s), "
        f"'xla' {gps['xla']:.4e} gridpoints/s (runs {rollouts['xla']} s)")

    profiles = {}
    for mode, s in (("pallas", solver), ("xla", cudnn_solver)):
        r = profiles[mode] = profile_steps(
            lambda n, s=s: s.forward(sos, num_iterations=n), PROFILE_STEPS)
        log(f"phase 5 profile '{mode}' {PROFILE_STEPS} steps: wall "
            f"{r['wall_ms_per_step']:.4f} ms/step, device "
            f"{r['device_ms_per_step']:.4f} ms/step, busy share "
            f"{r['busy_share']:.4f}")
        for k in r["top"]:
            print(f"    {k['device_ms_per_step']:.5f} ms/step "
                  f"{k['calls_per_step']:5.1f} calls/step  {k['name']}",
                  flush=True)

    # -- 6. K3 against its plain version, and its times --------------------
    g, n_pack = PACK_G, PACK_GRID
    kparams = prepare_k3(pack_params(params, g), model, g, inc_splits=(2, 2, 2))
    k3_rows = k3_calls("6", kparams, model, n_pack, gen, dev, nan_gates)
    # 6b: the cluster instance at the 14 calls of a g = 32 and a g = 64 step,
    # beside the card's L2 read rate
    l2_rate = l2_read_tb_s()
    log(f"phase 6b L2 read probe: {l2_rate:.3f} TB/s (16 MiB read 16 times a call; "
        f"L1 hits not told apart)")
    k3_wide = {}
    for gw in WIDE_STEPS:
        kw_params = prepare_k3(pack_params(params, gw), model, gw, inc_splits=(2, 2, 2))
        k3_wide[gw] = k3_calls(f"6b g={gw}", kw_params, model, n_pack, gen, dev,
                               nan_gates, WIDE_ITERS)
        del kw_params

    # -- 7. the packed path ----------------------------------------------------
    maps = load_maps("datasets/eval256/maps.npz")
    b_pack = maps.shape[0]
    if maps.shape != (16, n_pack, n_pack):
        fail(f"datasets/eval256/maps.npz holds {maps.shape}, expected 16 maps at 256^2")
    cfg_pack = cfg_kernel.replace(geometry=dataclasses.replace(
        cfg.geometry, domain_size=n_pack))
    cfg_pack_xla = cfg_cudnn.replace(geometry=cfg_pack.geometry)
    solver256 = IterativeSolver(cfg_pack, params=params)
    op256 = solver256.op
    src256 = solver256.source.expand(b_pack, -1, -1, -1)

    def packed_run(c, iters, collect=("rmse",)):
        return rollout_packed(params, op256, src256, maps, cfg=c, g=g,
                              num_iterations=iters, collect=collect)

    def unpacked_run(c, iters, collect=("rmse",)):
        return rollout(params, op256, src256, maps, cfg=c, num_iterations=iters,
                       collect=collect)

    fused_double_conv.launches = packed_double_conv.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    pk = packed_run(cfg_pack, PACK_ITERS, ("rmse", "best"))
    torch.cuda.synchronize()
    pack_first_s = time.perf_counter() - t
    k3_launches, k1_stray = packed_double_conv.launches, fused_double_conv.launches
    pk_rmse = pk["rmse"].cpu().numpy()
    pk_best = pk["best_rmse"].cpu().numpy()
    log(f"phase 7 packed path: {PACK_ITERS} iterations of {b_pack} x {n_pack}^2, "
        f"g={g}, in {pack_first_s:.2f} s; {k3_launches} K3 launches, {k1_stray} "
        f"K1 launches; mean rmse {pk_rmse[0].mean():.4e} -> {pk_rmse[-1].mean():.4e}, "
        f"best {pk_best.mean():.4e}")
    if k3_launches != len(k3_rows) * PACK_ITERS or k1_stray:
        fail(f"{k3_launches} K3 and {k1_stray} K1 launches, expected "
             f"{len(k3_rows)} x {PACK_ITERS} and 0")
    if pk_rmse.shape != (PACK_ITERS, b_pack) or not np.all(np.isfinite(pk_rmse)):
        fail("packed rmse trace is not finite or has the wrong shape")
    if tuple(pk["wavefield"].shape) != (b_pack, n_pack, n_pack, 2):
        fail("packed wavefield has the wrong shape")
    f32 = unpacked_run(cfg_pack_xla, PACK_ITERS, ("rmse", "best"))
    f32_rmse = f32["rmse"].cpu().numpy()
    f32_best = f32["best_rmse"].cpu().numpy()
    early = np.abs(pk_rmse[:4] - f32_rmse[:4]) / np.abs(f32_rmse[:4])
    best_ratio = np.maximum(pk_best / f32_best, f32_best / pk_best)
    log(f"phase 7 against unpacked cuDNN f32: first 4 rmse max rel diff "
        f"{early.max():.3e} (rtol {EARLY_RTOL}); best rmse ratio max "
        f"{best_ratio.max():.3f} (limit {LATE_FACTOR}); f32 mean rmse "
        f"{f32_rmse[0].mean():.4e} -> {f32_rmse[-1].mean():.4e}, best "
        f"{f32_best.mean():.4e}")
    if early.max() > EARLY_RTOL or best_ratio.max() > LATE_FACTOR:
        fail("the packed K3 path disagrees with the unpacked cuDNN path")
    pk_xla = packed_run(cfg_pack_xla, 10)["rmse"].cpu().numpy()
    xla_diff = (np.abs(pk_xla - f32_rmse[:10]) / np.abs(f32_rmse[:10])).max()
    log(f"phase 7 packed 'xla' against unpacked 'xla', first 10 rmse: max rel "
        f"diff {xla_diff:.3e} (rtol {XLA_RTOL})")
    if xla_diff > XLA_RTOL:
        fail("packed cuDNN path disagrees with the unpacked one")
    # the port's CPU path (plain K3, held against the JAX package by the
    # tests) on 16 maps at 96^2, g = 16, 4 iterations
    sos96 = np.load("datasets/splitted_96/testset.npz")["maps"][:b_pack]
    src96 = solver.source.expand(b_pack, -1, -1, -1)
    small = dict(cfg=cfg_kernel, g=g, num_iterations=4)
    on_card = rollout_packed(params, solver.op, src96, sos96, **small)["rmse"]
    on_cpu = rollout_packed(params_to(params, "cpu"), solver.op.to("cpu"),
                            src96.cpu(), sos96, device="cpu", **small)["rmse"]
    pack_cpu_diff = (np.abs(on_card.cpu().numpy() - on_cpu.numpy())
                     / on_cpu.numpy()).max()
    log(f"phase 7 packed against the CPU path ({b_pack} x 96^2, g={g}, 4 "
        f"iterations): max rel diff {pack_cpu_diff:.3e} (rtol {EARLY_RTOL})")
    if pack_cpu_diff > EARLY_RTOL:
        fail("the packed path on the card disagrees with the port's CPU path")

    # -- 8. throughput at 256^2 x 16 x 50, and a profile ------------------
    configs = {
        "packed 'pallas' (K3)": lambda: packed_run(cfg_pack, PACK_ITERS),
        "packed 'xla' (cuDNN)": lambda: packed_run(cfg_pack_xla, PACK_ITERS),
        "unpacked 'pallas' (K1)": lambda: unpacked_run(cfg_pack, PACK_ITERS),
        "unpacked 'xla' (cuDNN)": lambda: unpacked_run(cfg_pack_xla, PACK_ITERS),
    }
    order = [*configs, *reversed(configs)]  # in turns: A B C D D C B A
    unpacked_run(cfg_pack, 2)  # warm up the one configuration not run yet
    pack_runs = {}
    for key in order:
        torch.cuda.synchronize()
        t = time.perf_counter()
        configs[key]()
        torch.cuda.synchronize()
        pack_runs.setdefault(key, []).append(time.perf_counter() - t)
    pack_gps = {k: b_pack * n_pack * n_pack * PACK_ITERS / min(ts)
                for k, ts in pack_runs.items()}
    for k in configs:
        log(f"phase 8 {n_pack}^2 x {b_pack} x {PACK_ITERS} {k:24s} "
            f"{pack_gps[k]:.4e} gridpoints/s (runs {pack_runs[k]} s)")
    pack_profile = profile_steps(lambda n: packed_run(cfg_pack, n), PACK_PROFILE_STEPS)
    log(f"phase 8 profile packed 'pallas' {PACK_PROFILE_STEPS} steps: wall "
        f"{pack_profile['wall_ms_per_step']:.4f} ms/step, device "
        f"{pack_profile['device_ms_per_step']:.4f} ms/step, busy share "
        f"{pack_profile['busy_share']:.4f}")
    for k in pack_profile["top"]:
        print(f"    {k['device_ms_per_step']:.5f} ms/step "
              f"{k['calls_per_step']:5.1f} calls/step  {k['name']}", flush=True)


    # -- 7b. the packed path at g = 32: the wide K3 instances --------------
    wide_packed = wide_packed_phase(dev, cfg_kernel, cfg_cudnn, params,
                                    hand_kernel_counts)

    # -- 9. K2 at bench.py's stencil_spmv_512 shape ------------------------
    from helmnet_tpu_torch.ops import stencil_residual as sr
    from helmnet_tpu_torch.ops.source import point_source_map
    from helmnet_tpu_torch.ops.stencil import make_stencil_operator
    from helmnet_tpu_torch.solvers.gmres import (gmres_restarted_batch,
                                                 solve_helmholtz,
                                                 solve_helmholtz_batch)
    from helmnet_tpu_torch.solvers.iterative import get_initials

    geo = cfg.geometry
    n, b = SPMV_N, SPMV_B
    entries = {
        "K2a": (sr.residual_planes, sr.residual_planes_plain),
        "K2b": (lambda *a, **k: sr.residual_planes_tiled(*a, tile_h=128, **k),
                sr.residual_planes_plain),
        "K2c": (lambda *a, **k: sr.residual_planes_mxu(*a, tile_h=128, **k),
                sr.residual_planes_mxu_plain),
    }
    launch_counts = lambda: (sr.residual_planes.launches,
                             sr.residual_planes_tiled.launches,
                             sr.residual_planes_mxu.launches,
                             fused_double_conv.launches,
                             packed_double_conv.launches)
    rng = np.random.default_rng(0)
    on_card = lambda a: torch.tensor(a.astype(np.float32), device=dev)
    ur = on_card(rng.standard_normal((b, n, n)))
    ui = on_card(rng.standard_normal((b, n, n)))
    ones = torch.ones((b, n, n), device=dev)
    k_rand = on_card(rng.uniform(0.5, 1.2, (b, n, n)))
    s_re = on_card(rng.standard_normal((b, n, n)))
    s_im = on_card(rng.standard_normal((b, n, n)))
    k2_errs = {k: 0.0 for k in entries}
    k2_bit_equal = {"K2a": True, "K2b": True}

    def k2_check(label, op, key, inputs):
        kernel, plain = entries[key]
        got, ref = kernel(op, *inputs), plain(op, *inputs)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        ok = all(bool(torch.isfinite(g).all()) for g in got) and err <= K2_ATOL[key]
        same = ""
        if key in k2_bit_equal:  # K2c's plain version sums its x taps otherwise
            equal = all(torch.equal(g, r) for g, r in zip(got, ref))
            k2_bit_equal[key] &= equal
            same = f", bit-equal {equal}"
        log(f"phase 9 {key} {label} [{sr.stencil_variant(op, *inputs)}]: max|err| "
            f"{err:.3e} (atol {K2_ATOL[key]}){same} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{key} disagrees with its plain version ({label})")
        k2_errs[key] = max(k2_errs[key], err)

    for order in (4, 2):
        st = make_stencil_operator(n, n, geo.pml_size, geo.sigma_max, cfg.k0,
                                   order=order, device=dev)
        for label, inputs in (("k^2 = 1, s = u", (ur, ui, ones, ur, ui)),
                              ("random k^2 and s", (ur, ui, k_rand, s_re, s_im))):
            for key in entries:
                k2_check(f"{n}^2 x {b}, order {order}, {label}", st, key, inputs)
    st = make_stencil_operator(n, n, geo.pml_size, geo.sigma_max, cfg.k0,
                               order=4, device=dev)
    st_ragged = make_stencil_operator(40, 72, geo.pml_size, geo.sigma_max, cfg.k0,
                                      order=4, device=dev)
    rag = (ur[:, :40, :72].contiguous(), ui[:, :40, :72].contiguous(),
           k_rand[:, :40, :72].contiguous(), s_re[:, :40, :72].contiguous(),
           s_im[:, :40, :72].contiguous())
    k2_check("ragged 40x72, order 4", st_ragged, "K2a", rag)
    u_pair = torch.stack([ur, ui], -1)
    s_pair = torch.stack([s_re, s_im], -1)
    pair_got = sr.helmholtz_residual_kernel(st, u_pair, k_rand, s_pair)
    pair_ref = torch.stack(sr.residual_planes_plain(st, ur, ui, k_rand, s_re, s_im), -1)
    torch.cuda.synchronize()
    pair_err = (pair_got - pair_ref).abs().max().item()
    pair_variant = sr.stencil_variant(st, u_pair[..., 0], u_pair[..., 1], k_rand,
                                      s_pair[..., 0], s_pair[..., 1])
    log(f"phase 9 channel-pair wrapper (stride-2 halves) {n}^2 x {b} "
        f"[{pair_variant}]: max|err| {pair_err:.3e} (atol {K2_ATOL['K2b']}), "
        f"bit-equal {torch.equal(pair_got, pair_ref)}")
    if not pair_err <= K2_ATOL["K2b"]:
        fail("the channel-pair wrapper disagrees with the plain version")
    del u_pair, s_pair, pair_got, pair_ref

    btr, bti = sr.banded_matrices(st)
    k2_rows = {}
    k2_args = (ur, ui, k_rand, s_re, s_im)
    # the library's form of the same function: one cuSPARSE product
    # -s + A u on the block-diagonal CSR, on complex64 copies of u and s
    csr512 = stencil_csr(st, k_rand)
    u_col = torch.complex(ur, ui).reshape(-1, 1)
    s_col = torch.complex(s_re, s_im).reshape(-1, 1)
    spmm = lambda: torch.addmm(s_col, csr512, u_col, beta=-1)
    csr_err = (spmm() - torch.complex(*sr.residual_planes_plain(st, *k2_args))
               .reshape(-1, 1)).abs().max().item()
    library512_ms = cuda_ms(spmm, iters=20, graph=False)
    log(f"phase 9 cuSPARSE addmm on the block-diagonal complex64 CSR "
        f"({csr512.values().numel()} nonzeros) {n}^2 x {b}: {library512_ms:.4f} ms, "
        f"max|err| against the plain version {csr_err:.3e} (atol {CSR_ATOL})")
    if not csr_err <= CSR_ATOL:
        fail("the CSR matrix does not compute the stencil residual")
    del csr512, u_col, s_col
    variant512 = sr.stencil_variant(st, *k2_args)
    for key, (kernel, plain) in entries.items():
        kernel_ms = cuda_ms(lambda: kernel(st, *k2_args), iters=100)
        cold_ms = cuda_cold_ms(lambda: kernel(st, *k2_args))
        plain_ms = cuda_ms(lambda: plain(st, *k2_args), iters=20)
        nbytes, flops, bytes_ms, ops_ms = stencil_bound(st.radius, b, n, n, True)
        row = dict(name=key, variant=variant512, ms=kernel_ms, cold_ms=cold_ms,
                   plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bytes_ms=bytes_ms, ops_ms=ops_ms, mbytes=nbytes / 1e6,
                   gb_per_s=nbytes / cold_ms / 1e6,
                   share=max(bytes_ms, ops_ms) / cold_ms, max_abs_err=k2_errs[key],
                   bit_equal=k2_bit_equal.get(key), library_ms=library512_ms)
        if key == "K2c":  # context: the dense banded x products in f32
            row["banded_matmul_ms"] = cuda_ms(
                lambda: (ur @ btr - ui @ bti, ur @ bti + ui @ btr), iters=20)
        k2_rows[key] = row
        log(f"phase 9 {key} {n}^2 x {b} [{variant512}]: kernel warm "
            f"{kernel_ms:.5f} ms, cold {cold_ms:.5f} ms ({row['gb_per_s']:.1f} "
            f"GB/s, {row['share']:.3f} of the bound), plain {plain_ms:.4f} ms, "
            f"cuSPARSE {library512_ms:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}; {nbytes / 1e6:.2f} MB)"
            + (f", dense banded f32 matmuls {row['banded_matmul_ms']:.4f} ms"
               if key == "K2c" else ""))

    def chain(fn, applies=SPMV_APPLIES):
        c = ur
        for _ in range(applies):
            rr, _ri = fn(st, c, ui, ones, c, ui)
            c = c * 0.999 + rr * 1e-3
        return c

    chains = {}
    for key in ("K2b", "K2c"):
        reset_counts()
        torch.cuda.synchronize()
        c_kernel = chain(entries[key][0])
        torch.cuda.synchronize()
        counts = launch_counts()
        want = (0, SPMV_APPLIES, 0, 0, 0) if key == "K2b" else (0, 0, SPMV_APPLIES, 0, 0)
        log(f"phase 9 chain of {SPMV_APPLIES} applies through {key}: launches "
            f"K2a/K2b/K2c/K1/K3 {counts}")
        if counts != want:
            fail(f"the {key} chain launched {counts}, expected {want}")
        chain_err = (c_kernel - chain(entries[key][1])).abs().max().item()
        if not chain_err <= K2_ATOL[key]:
            fail(f"the {key} chain disagrees with the plain chain: {chain_err:.3e}")
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            chain(entries[key][0])
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        dt = min(ts) / SPMV_APPLIES
        chains[key] = {"launches": counts[1] if key == "K2b" else counts[2],
                       "max_abs_err_vs_plain": chain_err, "runs_s": ts,
                       "seconds_per_apply": dt,
                       "gridpoints_per_s": b * n * n / dt,
                       "nnz_per_s": b * n * n * (4 * st.radius + 1) / dt}
        log(f"phase 9 chain {key}: {dt * 1e6:.2f} us per apply (best of 3), "
            f"{b * n * n / dt:.4e} gridpoints/s, "
            f"{chains[key]['nnz_per_s']:.4e} nnz/s; final c within "
            f"{chain_err:.3e} of the plain chain")
    del ur, ui, ones, k_rand, s_re, s_im, k2_args, btr, bti

    # -- 10. batched GMRES on the stencil operator ---------------------------
    st256 = make_stencil_operator(n_pack, n_pack, geo.pml_size, geo.sigma_max,
                                  cfg.k0, order=4, device=dev)
    k_sq256, _ = get_initials(torch.tensor(maps, device=dev), cfg.source.omega)
    b256 = torch.complex(src256[..., 0], src256[..., 1]).contiguous()
    gm = dict(restart=GMRES_RESTART, max_restarts=GMRES_CYCLES, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = solve_helmholtz_batch(st256, k_sq256, src256, **gm)
    torch.cuda.synchronize()
    gmres_s = time.perf_counter() - t
    gmres_counts = launch_counts()
    want_k2a = 1 + GMRES_CYCLES * (GMRES_RESTART + 2)
    rn = res.residual_norms.cpu().numpy()
    log(f"phase 10 GMRES({GMRES_RESTART}) x {GMRES_CYCLES} on the stencil operator, "
        f"{b_pack} x {n_pack}^2: {gmres_s:.3f} s; launches K2a/K2b/K2c/K1/K3 "
        f"{gmres_counts}; relative residual {np.mean(rn[:, -1] / rn[:, 0]):.4e} "
        f"(mean), {np.max(rn[:, -1] / rn[:, 0]):.4e} (worst)")
    if gmres_counts != (want_k2a, 0, 0, 0, 0):
        fail(f"GMRES launched {gmres_counts}, expected ({want_k2a}, 0, 0, 0, 0)")
    if rn.shape != (b_pack, GMRES_CYCLES + 1) or not np.all(np.isfinite(rn)):
        fail("GMRES residual histories are not finite or have the wrong shape")
    rise = np.max(rn[:, 1:] / rn[:, :-1])
    if rise > 1 + MONOTONE_SLACK:
        fail(f"a GMRES residual history rises by a factor {rise:.6f}")
    if not np.all(rn[:, -1] < rn[:, 0]):
        fail("a GMRES residual did not fall below its start")
    if tuple(res.x.shape) != (b_pack, n_pack, n_pack, 2) or not bool(
            torch.isfinite(res.x).all()):
        fail("the GMRES solution is not finite or has the wrong shape")

    def plain_mv(u):
        p = torch.view_as_real(u)
        rr, ri = sr.residual_planes_plain(st256, p[..., 0], p[..., 1], k_sq256)
        return torch.complex(rr, ri)

    plain = gmres_restarted_batch(plain_mv, b256, restart=GMRES_RESTART,
                                  max_restarts=GMRES_PLAIN_CYCLES)
    head = rn[:, : GMRES_PLAIN_CYCLES + 1]
    plain_gap = np.max(np.abs(head - plain.residual_norms.cpu().numpy()) / head)
    log(f"phase 10 first {GMRES_PLAIN_CYCLES} cycles against the plain matvec on "
        f"the card: max rel diff {plain_gap:.3e} (rtol {GMRES_PLAIN_RTOL})")
    if not plain_gap <= GMRES_PLAIN_RTOL:
        fail("GMRES with K2 disagrees with GMRES on the plain matvec")
    del plain
    gmres_runs = []
    for _ in range(GMRES_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        solve_helmholtz_batch(st256, k_sq256, src256, **gm)
        torch.cuda.synchronize()
        gmres_runs.append(time.perf_counter() - t)
    gmres_wall = float(np.median(gmres_runs))
    log(f"phase 10 wall of {GMRES_TIMED} solves after the counted one: median "
        f"{gmres_wall:.4f} s, best {min(gmres_runs):.4f} s; the counted (first) "
        f"solve {gmres_s:.4f} s")

    # K2a at its main path's shape: GMRES's matvec, stride-2 views of
    # complex64 through the channel-pair wrapper, s = None
    u_cx = torch.complex(on_card(rng.standard_normal((b_pack, n_pack, n_pack))),
                         on_card(rng.standard_normal((b_pack, n_pack, n_pack))))
    pair = torch.view_as_real(u_cx)
    matvec = lambda: sr.helmholtz_residual_kernel(st256, pair, k_sq256)
    matvec_plain = lambda: sr.residual_planes_plain(st256, pair[..., 0],
                                                    pair[..., 1], k_sq256)
    before = launch_counts()
    got = matvec()
    if launch_counts() != (before[0] + 1,) + before[1:]:
        fail("GMRES's matvec shape did not go to K2a")
    ref = torch.complex(*matvec_plain())
    main_err = (torch.view_as_complex(got) - ref).abs().max().item()
    csr256 = stencil_csr(st256, k_sq256)
    u_col = u_cx.reshape(-1, 1)
    spmm = lambda: torch.mm(csr256, u_col)
    csr_err = (spmm() - ref.reshape(-1, 1)).abs().max().item()
    nbytes, _, bytes_ms, ops_ms = stencil_bound(st256.radius, b_pack, n_pack,
                                                n_pack, False)
    k2a_main = dict(variant=sr.stencil_variant(st256, pair[..., 0], pair[..., 1],
                                               k_sq256),
                    ms=cuda_ms(matvec, iters=100), cold_ms=cuda_cold_ms(matvec),
                    plain_ms=cuda_ms(matvec_plain, iters=20),
                    library_ms=cuda_ms(spmm, iters=20, graph=False),
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    mbytes=nbytes / 1e6, max_abs_err=main_err,
                    library_max_abs_err=csr_err)
    k2a_main["share"] = k2a_main["bound_ms"] / k2a_main["cold_ms"]
    # context: one elementwise PyTorch pass moving the bound's bytes (u and
    # k^2 read, r written), the floor of any kernel on this call
    r_pair = torch.empty_like(pair)
    elementwise = lambda: torch.mul(pair, k_sq256[..., None], out=r_pair)
    k2a_main["elementwise_ms"] = cuda_ms(elementwise, iters=100)
    k2a_main["elementwise_cold_ms"] = cuda_cold_ms(elementwise)
    log(f"phase 10 K2a at GMRES's matvec ({b_pack} x {n_pack}^2 complex64, "
        f"stride 2, no source) [{k2a_main['variant']}]: max|err| {main_err:.3e} "
        f"(atol {K2_ATOL['K2a']}); kernel warm {k2a_main['ms']:.5f} ms, cold "
        f"{k2a_main['cold_ms']:.5f} ms ({nbytes / k2a_main['cold_ms'] / 1e6:.1f} "
        f"GB/s, {k2a_main['share']:.3f} of the bound), plain "
        f"{k2a_main['plain_ms']:.4f} ms, cuSPARSE mm {k2a_main['library_ms']:.4f} ms "
        f"(max|err| {csr_err:.3e}, atol {CSR_ATOL}), bound "
        f"{k2a_main['bound_ms']:.5f} ms ({k2a_main['bound_by']}; {nbytes / 1e6:.2f} MB)")
    log(f"phase 10 an elementwise pass over the same bytes (torch.mul u k^2): "
        f"warm {k2a_main['elementwise_ms']:.5f} ms, cold "
        f"{k2a_main['elementwise_cold_ms']:.5f} ms")
    if not (main_err <= K2_ATOL["K2a"] and bool(torch.isfinite(got).all())):
        fail("K2a disagrees with its plain version at GMRES's matvec")
    if not csr_err <= CSR_ATOL:
        fail("the CSR matrix does not compute GMRES's matvec")
    del u_cx, pair, got, ref, csr256, u_col, r_pair

    import scipy.sparse.linalg as spla

    n32 = 32
    sos32 = np.ones((n32, n32), np.float32)
    sos32[10:20, 8:26] = 1.5
    k32 = (1.0 / sos32) ** 2
    src32 = point_source_map(n32, n32, (n32 - 8, n32 // 2), 10.0)
    st32 = make_stencil_operator(n32, n32, 4, 2.0, 1.0, order=4, device=dev)
    x32 = solve_helmholtz(st32, k32, src32, restart=40, max_restarts=30, tol=1e-6,
                          device=dev).x.cpu().numpy()
    u_direct = spla.spsolve(sr.stencil_to_csr(st32, k32).tocsc(),
                            (src32[..., 0] + 1j * src32[..., 1]).ravel()).reshape(n32, n32)
    scipy_err = np.abs(x32[..., 0] + 1j * x32[..., 1] - u_direct).max()
    scipy_scale = np.abs(u_direct).max()
    log(f"phase 10 {n32}^2 GMRES on the card against scipy spsolve: max|err| "
        f"{scipy_err:.3e} (atol {SCIPY_ATOL * scipy_scale:.3e})")
    if not scipy_err <= SCIPY_ATOL * scipy_scale:
        fail("GMRES on the card does not solve the stencil system")
    gmres_profile = profile_steps(
        lambda _: solve_helmholtz_batch(st256, k_sq256, src256, **gm), 1)
    k2_device_ms = sum(ms for name, ms in gmres_profile["device_ms_by_name"].items()
                       if "stencil_residual" in name)
    gmres_profile["k2_share"] = k2_device_ms / gmres_profile["device_ms_per_step"]
    log(f"phase 10 profile of one solve: wall {gmres_profile['wall_ms_per_step']:.1f} "
        f"ms, device {gmres_profile['device_ms_per_step']:.3f} ms (busy share "
        f"{gmres_profile['busy_share']:.4f}); K2 {k2_device_ms:.3f} ms, "
        f"{gmres_profile['k2_share']:.4f} of the device time")
    for k in gmres_profile["top"][:8]:
        print(f"    {k['device_ms_per_step']:.5f} ms {k['calls_per_step']:7.0f} "
              f"calls  {k['name']}", flush=True)

    # -- 11. training ----------------------------------------------------------
    training = train_phase(dev, cfg, params, launch_counts)

    # -- 12. the classical solvers with the tpu_r2c weights ----------------
    classical = classical_phase(dev, cfg, cfg_kernel, launch_counts)

    # -- 13. serving and the remaining 2D entry points ---------------------
    serving = serve_phase(dev, launch_counts)

    # -- 14. the 3D solvers, trainer and time domain ------------------------
    solvers3d = solvers3d_phase(dev, launch_counts)
    paths3d = solvers3d["launches"]  # every 3D path's counts, each from 0
    by_path3d = lambda i: {path: c[i] for path, c in paths3d.items()}

    # -- 15. distribution on NCCL at world size 1 --------------------------
    distribution = distribution_phase(dev, cfg, params, hand_kernel_counts)

    # -- 16. skull, figures, sanitizers, dry run -----------------------------
    last = last_slice_phase(dev, cfg_kernel, cfg_cudnn, hand_kernel_counts)

    # -- 17. the split grid's single-card end at 1024^2 ----------------------
    split = split_grid_phase(dev, cfg, cfg_kernel, cfg_cudnn, params, hand_kernel_counts)

    # -- 18. the CSLP preconditioner on the split grid at 1024^2 ------------
    cslp_split = cslp_split_phase(dev, cfg, hand_kernel_counts)

    total = lambda k: sum(r[k] for r in rows)
    k3_total = lambda k: sum(r[k] for r in k3_rows)
    kernels = {"kernels": [{
        "name": "fused_double_conv",
        "route": "cuda",
        "source": "helmnet_tpu_torch/csrc/double_conv.cu",
        "replaces": "helmnet_tpu/ops/pallas_pixconv.py:251",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times are per solver step: the sum over its 14 calls
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if total("ops_ms") >= total("bytes_ms") else "bytes",
        "library_ms": total("library_ms"),
        "tiles": {r["name"]: "x".join(map(str, r["tile"])) for r in rows},
        # each path's count, set to 0 just before it and read just after
        "launches_by_path": {
            "phase 4 rollout 96^2 x 32 x 500": launches,
            "12a rollout 256^2 x 4 x 100": classical["convergence_256"]["k1_launches"],
            **{f"12b solve_hybrid '{p}'": classical["hybrid"][p]["k1_launches"]
               for p in classical["hybrid"]},
            **{f"12c solve_fgmres_learned {k}": classical["fgmres"][k]["k1_launches"]
               for k in classical["fgmres"]},
            "12d solve_auto two-level 512^2": classical["auto_512"]["k1_launches"],
            "phase 13 serve": serving["burst"]["k1_launches"],
            **by_path3d(3),
            f"16a skull {SKULL_GRID}^2 x {SKULL_ITERS}": last["skull"]["k1_launches"],
            f"16c checked rollout {GRID}^2 x {SANITIZE_MAPS} x {SANITIZE_ITERS}":
                last["sanitize"]["k1_launches"],
            f"17c rollout {SPLIT_GRID}^2 x {SPLIT_MAPS} x {SPLIT_ITERS}":
                split["rollout"]["k1_launches"],
        },
        # a step at 17c's 1024^2 x 4: the sum over its 14 calls
        "step_1024": {k: split["rollout"]["k1_step"][k]
                      for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                "max_abs_err")},
    }, {
        "name": "packed_double_conv",
        "route": "cuda",
        "source": "helmnet_tpu_torch/csrc/packed_double_conv.cu",
        "replaces": "helmnet_tpu/ops/pallas_unet.py:175",
        "launches": k3_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
        # times are per packed step: the sum over its 14 calls
        "ms": k3_total("ms"),
        "plain_ms": k3_total("plain_ms"),
        "bound_ms": k3_total("bound_ms"),
        "bound_by": ("operations" if k3_total("ops_ms") >= k3_total("bytes_ms")
                     else "bytes"),
        "library_ms": k3_total("library_ms"),
        "tiles": {r["name"]: "x".join(map(str, r["tile"])) for r in k3_rows},
        "launches_by_path": {
            f"phase 7 rollout_packed g={PACK_G} {PACK_GRID}^2 x 16 x {PACK_ITERS}":
                k3_launches,
            f"7b rollout_packed g={WIDE_G} {PACK_GRID}^2 x {WIDE_MAPS} x {PACK_ITERS}":
                wide_packed["k3_launches"],
            **by_path3d(4),
        },
        # the wide instances: a packed step's 14 calls at g = 32 and 64 (6b)
        "wide_steps": {f"g={gw}": k3_step(r) for gw, r in k3_wide.items()},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "helmnet_tpu_torch/csrc/stencil_residual.cu",
        "replaces": replaces,
        "launches": launches_k2,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],  # warm: repeated calls, inputs in L2 where they fit
        "cold_ms": row["cold_ms"],  # the L2 overwritten before every call
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],  # cuSPARSE on the complex64 CSR
        "variant": row["variant"],  # the kernel's instance
        "launches_by_path": {
            **({"phase 10 GMRES 16 x 256^2": launches_k2,
                "12e solve_helmholtz_deflated 256^2": classical["deflated"]["k2a_launches"],
                f"16c solve_helmholtz_checked {GRID}^2": last["sanitize"]["k2a_launches"]}
               if name == "residual_planes" else {}),
            **by_path3d(k2_index),
        },
    } for k2_index, (name, replaces, launches_k2, row) in enumerate((
        # per call on each kernel's main path: K2a at GMRES's matvec
        # (16 x 256^2 complex64, no source), K2b and K2c at 512^2 x 8
        ("residual_planes", "helmnet_tpu/ops/pallas_stencil.py:212",
         gmres_counts[0], dict(k2a_main, max_abs_err=max(
             k2a_main["max_abs_err"], k2_rows["K2a"]["max_abs_err"]))),
        ("residual_planes_tiled", "helmnet_tpu/ops/pallas_stencil.py:161",
         chains["K2b"]["launches"], k2_rows["K2b"]),
        ("residual_planes_mxu", "helmnet_tpu/ops/pallas_stencil.py:452",
         chains["K2c"]["launches"], k2_rows["K2c"]),
    ))]}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": kind, "nvidia_smi": smi, "ptxas": resources,
                       "build_log": built.log,
                       "calls": rows, "nan_gates": nan_gates,
                       "rollout_seconds": rollouts, "gridpoints_per_s": gps,
                       "first_rollout_s": first_s, "build_s": built.seconds,
                       "profile": profiles, "k3_calls": k3_rows,
                       "k3_wide_calls": {str(gw): r for gw, r in k3_wide.items()},
                       "l2_read_tb_s": l2_rate,
                       "wide_packed": wide_packed, "distribution": distribution,
                       "packed": {
                           "first_rollout_s": pack_first_s,
                           "rmse": pk_rmse.tolist(), "best_rmse": pk_best.tolist(),
                           "f32_rmse": f32_rmse.tolist(),
                           "f32_best_rmse": f32_best.tolist(),
                           "early_rel_diff": float(early.max()),
                           "best_ratio": float(best_ratio.max()),
                           "xla_rel_diff": float(xla_diff),
                           "cpu_rel_diff": float(pack_cpu_diff),
                           "rollout_seconds": pack_runs,
                           "gridpoints_per_s": pack_gps,
                           "profile": pack_profile},
                       "k2_calls": k2_rows, "k2_chains": chains,
                       "gmres": {
                           "seconds_first": gmres_s, "seconds": gmres_wall,
                           "runs_s": gmres_runs, "k2a_main": k2a_main,
                           "residual_norms": rn.tolist(),
                           "plain_rel_diff": float(plain_gap),
                           "scipy_err": float(scipy_err),
                           "scipy_scale": float(scipy_scale),
                           "profile": gmres_profile},
                       "training": training, "classical": classical,
                       "serving": serving, "solvers3d": solvers3d, "last_slice": last,
                       "split_grid": split, "cslp_split": cslp_split,
                       **kernels}, fh, indent=1)
    log("done")
    faulthandler.cancel_dump_traceback_later()
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
