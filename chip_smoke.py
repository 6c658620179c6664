#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`helmnet_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Drives the learned 2D solve at 96^2 x batch 32 x 500 iterations through
`IterativeSolver.forward` with the fused DoubleConv kernel K1, the
channel-packed solve at 256^2 x 16 x 50 through `rollout_packed` with the
packed fused DoubleConv kernel K3, the FD-stencil residual kernels K2a-c
at bench.py's 512^2 x 8, batched GMRES on the stencil operator at
256^2 x 16, unsupervised replay-buffer training at 96^2 x 32 with 10 unrolled
steps, and the classical solvers (learned-preconditioned FGMRES,
two-level, deflated GMRES, hybrid, `solve_auto`, `cli/solve`) with the
tpu_r2c weights, and checks them all:

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
   chose;
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
   its TFLOP/s, share of the bound and time at the other tile;
7. the packed path: `rollout_packed` on the 16 maps of
   datasets/eval256/maps.npz, g = 16, 50 iterations (bench.py:234) in
   'pallas' mode. Exactly 14 x 50 K3 launches and no K1 launch, finite
   rmse, the first 4 rmse within rtol 0.05 of the unpacked cuDNN-f32
   rollout and the best rmse within a factor 1.5 of its best, packed
   'xla' against unpacked 'xla' within rtol 1e-3 on the first 10 rmse,
   and the card against the port's CPU path (16 maps at 96^2, 4
   iterations) within rtol 0.05;
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
   (b)-(e) is timed: the wall of 3 solves after the counted one (median),
   and one profiled solve's device time, busy share and busiest kernels.

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
CLASSICAL_TIMED = 3  # 12b-e: solves timed after the counted one


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
    (device time over that wall) and the busiest kernels."""
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies, memsets): the CPU ops that
    # launched them carry the same time again
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


def ptxas_table(log: str) -> list[dict]:
    """One row per instance of K1, K3 and K2 from nvcc's -Xptxas -v lines:
    its template arguments, registers, static shared memory and spills."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(packed_double_conv|double_conv"
                      r"|stencil_residual)_kernelI((?:Li\d+E)+)E", line)
        if m:
            cur = {"kernel": {"packed_double_conv": "K3", "double_conv": "K1",
                              "stencil_residual": "K2"}[m.group(1)],
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
    from helmnet_tpu_torch.ops.packed_double_conv import tile_for as k3_tile_for
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
    # whose shared memory is dynamic (hn_packed_double_conv_smem); K2:
    # <radius, instance> (0 scalar, 1 planes, 2 pairs)
    resources = ptxas_table(built.log)
    for r in resources:
        if r["kernel"] == "K3":
            th, tw, cmp_, cop_ = r["args"][:4]
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
    k3_rows = []
    for name, pw, n, cins in packed_step_calls(kparams, model, n_pack):
        parts = tuple(torch.randn((1, n, n, c), generator=gen, device=dev)
                      for c in cins)
        ref = double_conv_plain(pw.params, parts)
        got = packed_double_conv(pw, parts)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale
        log(f"phase 6 {name:20s} {'+'.join(map(str, cins)):>11s} -> {pw.cm} -> "
            f"{got.shape[-1]} @{n}^2: max|err| {err:.3e} (atol "
            f"{KERNEL_RTOL * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K3 disagrees with its plain version at {name}")
        fp = pw.params
        lib_p = dict(fp, c1={"w": torch.cat(fp["c1"]["w"], dim=1), "b": fp["c1"]["b"]})

        def library(p=lib_p, parts=parts):
            y = double_conv(p, torch.cat(parts, dim=-1), model.activation_function,
                            "highest")
            return conv2d(p["post"], y) if "post" in p else y

        kernel_ms = cuda_ms(lambda: packed_double_conv(pw, parts))
        tile = k3_tile_for(1, n, n)
        alt = K3_TILES[1 - K3_TILES.index(tile)]  # the tile not chosen
        alt_ms = cuda_ms(lambda: packed_double_conv(pw, parts, tile=alt))
        plain_ms = cuda_ms(lambda: double_conv_plain(fp, parts))
        library_ms = cuda_ms(library)
        flops, ops_ms, bytes_ms, cuda_core_ms = packed_bound(pw, parts, got)
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        k3_rows.append(dict(
            name=name, grid=n, cins=list(cins), cmid=pw.cm, cout=int(got.shape[-1]),
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, ops_ms=ops_ms, bytes_ms=bytes_ms,
            cuda_core_ms=cuda_core_ms, max_abs_err=err, gflops=flops / 1e9,
            tflops=flops / kernel_ms / 1e9, tile=list(tile),
            bound_share=bound_ms / kernel_ms, alt_tile=list(alt), alt_ms=alt_ms))
        log(f"phase 6 {name:20s} tile {tile[0]}x{tile[1]}: K3 {kernel_ms:.4f} ms "
            f"({flops / kernel_ms / 1e9:.1f} TFLOP/s, {bound_ms / kernel_ms:.3f} of "
            f"its bound), plain {plain_ms:.4f} ms, cuDNN {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), f32 CUDA-core {cuda_core_ms:.4f} ms; "
            f"at tile {alt[0]}x{alt[1]} {alt_ms:.4f} ms")
        del parts, ref, got

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
        },
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
        **({"launches_by_path": {
            "phase 10 GMRES 16 x 256^2": launches_k2,
            "12e solve_helmholtz_deflated 256^2": classical["deflated"]["k2a_launches"],
        }} if name == "residual_planes" else {}),
    } for name, replaces, launches_k2, row in (
        # per call on each kernel's main path: K2a at GMRES's matvec
        # (16 x 256^2 complex64, no source), K2b and K2c at 512^2 x 8
        ("residual_planes", "helmnet_tpu/ops/pallas_stencil.py:212",
         gmres_counts[0], dict(k2a_main, max_abs_err=max(
             k2a_main["max_abs_err"], k2_rows["K2a"]["max_abs_err"]))),
        ("residual_planes_tiled", "helmnet_tpu/ops/pallas_stencil.py:161",
         chains["K2b"]["launches"], k2_rows["K2b"]),
        ("residual_planes_mxu", "helmnet_tpu/ops/pallas_stencil.py:452",
         chains["K2c"]["launches"], k2_rows["K2c"]),
    )]}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": kind, "nvidia_smi": smi, "ptxas": resources,
                       "build_log": built.log,
                       "calls": rows,
                       "rollout_seconds": rollouts, "gridpoints_per_s": gps,
                       "first_rollout_s": first_s, "build_s": built.seconds,
                       "profile": profiles, "k3_calls": k3_rows,
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
