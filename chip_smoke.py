#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (bnpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

  1. device  — a CUDA device must be present; prints its name and power
               limit as nvidia-smi reports them;
  2. build   — compiles the kernels (bnpc_tpu_torch/csrc/*.cu), one nvcc
               per source, all at once;
  3. kernels — each kernel against its plain torch twin on the card, at its
               path's shapes; outputs must match exactly; prints each
               kernel's median time beside its twin's and its bound:
                 lazy_segment  5,000 x 256: no birth, a birth, a veto; and
                               crafted 300-cell sweeps from position 37 at
                               k_pad 32 ... 1,024 (a tie for the best logit
                               across lanes and within a lane, -0.0 against
                               +0.0, a cell whose logits are all -inf, a
                               death to size 0 and a later birth into the
                               freed slot);
                 rg_scan       5,000 cells: s_count 0, 1, 37, 1,984 (two
                               whole chunks of the kernel) and 5,000; a tie
                               dz == -dtab[s1]; dz +inf / -inf / NaN; a small
                               n_move (the table's +inf tail reached); a
                               start count1 in the middle; a non-monotone
                               table and one with a NaN (the kernel's serial
                               route); 131,072 cells at s_count 131,072 (the
                               table read from global memory) and 6,553;
                               timed at s_count 5,000, on the serial route
                               and at 131,072;
                 lazy_stream   131,072 x 128 over the last 8,192 positions:
                               no birth, a birth, a veto; and k_max 2,000
                               (the shared-memory sizes row) at 4,096
                               cells; timed over the full segment beside
                               lazy_segment on the same Z in cell order; the
                               crafted sweeps at k_pad 32 ... 1,024 and at
                               96, 160 and 992 (masked slots);
                 eager_sweep   5,000 x 256 with lf [5,000, 5,000]: no birth,
                               two births back to back (rows copied ahead
                               of the patch), a veto; crafted 300-cell
                               sweeps at k_pad 96, 160, 256 and 992 with
                               births 1, 3 and 8 positions apart, at the
                               first and the last position and into slots
                               of the last lane row; timed without and with
                               the two births;
                 vecflow       5,000 x 256 (the probe's shape): no birth, a
                               birth mid-batch (the rest of the batch
                               compared), a won new-cluster option with no
                               free slot, and n 4,993 (z rows padded to
                               5,000; the inert tail); the crafted cases of
                               vecflow_probe.CRAFTED (n a multiple of 128,
                               n 1, n < kRing, births at 0, in the last
                               full batch, in the ragged batch, two in one
                               batch) at k_pad 32 ... 1,024; timed beside
                               lazy_segment on the same input, in turns,
                               and on lazy_stream's 131,072 x 128 Z beside
                               lazy_segment there;
                 while_exit    512 x 256 (the probe's shape): NaN sizes from
                               0 (the probe verbatim), a birth from 0, a
                               birth from position 200; the crafted cases
                               of while_probe.CRAFTED (NaN sizes, a NaN in
                               slot 0 or a later one, NaNs of both signs
                               and several payloads, -0.0 / +0.0, every
                               logit -inf, sizes -1, births at i0 and at
                               n - 1) at 128 cells and k_pad 32 ... 1,024,
                               sizes bit for bit; timed beside lazy_segment
                               on the same z and perm, in turns;
                 mh_sweep      the fused MH sweep against the torch
                               composition it replaces (ops/mh.py::sweep_on,
                               run on the card) on one generator state, at
                               256 x 200, 2 x 200, 200 and 3 x 256 x 200:
                               new params and declined counts bit for bit,
                               row sums within 2 m 2^-24 (same-signed terms
                               added in another order); the realized mode;
                               a batch == its one-chain launches; the
                               runner's captured block == its eager block
                               with the kernel's launches counted alike
                               under replay; its time a call inside a CUDA
                               graph beside the composition's and its bytes
                               bound (run it alone with `python3 -c "import
                               chip_smoke as cs; cs.phase_mh_sweep('cuda',
                               cs.nvidia_smi())"`);
                 beta_post     the fused Beta posterior rows against the
                               torch composition they replace (randomx.
                               beta_general and the clamp, run on the card)
                               on one generator state, at 3 x 200 (a split-
                               merge launch), 1 x 200 and 256 x 200, and
                               against the twin on the wrapper's draws, bit
                               for bit with the generator's state; a batch
                               of 4 chains == its one-chain launches; the
                               crafted rows of BETA_CRAFTED == the twin; the
                               runner's captured block == its eager block
                               with the kernel's launches counted alike;
                               its time a call inside a CUDA graph beside
                               the composition's arithmetic (run it alone
                               with `python3 -c "import chip_smoke as cs;
                               cs.phase_beta_post('cuda', cs.nvidia_smi())"`);
                 rg_assign     a split-merge launch scan's per-cell work
                               (kernel 9) against the torch composition it
                               replaces (models/splitmerge.py's, kernel 2
                               inside it, on the card) and the twin at
                               5,000 cells: s_count 0, 1, 37, 1,984 and
                               4,998, equal keys, launch sides all 0 and
                               all 1, the table's +inf reached, trans_prob
                               off and on: the new sides, the side masks,
                               the chosen terms and their torch sum bit for
                               bit; a batch of 4 == its one-chain launches;
                               n = MAX_CELLS; _rg_scan_assign's route ==
                               its composition (split and merge, one chain
                               and a StackedDraws batch of 4) with the
                               generators' states; the runner's captured
                               block == its eager block, the launches
                               counted alike; its time a call in a CUDA
                               graph beside the composition's (run it alone
                               with `python3 -c "import chip_smoke as cs;
                               cs.phase_rg_assign('cuda', cs.nvidia_smi())"`);
                 error_mh,     the error-rate MH and the trace row (kernels
                 trace_row     10 and 11) against the torch composition on
                               the card at 256 x 200, one chain and a batch
                               of 4, Beta(0.25, 0.25) and uniform priors, a
                               padded mask: the rates, both flags, the
                               move's likelihood, ML, MAP and the whole row
                               bit for bit, the generators alike, the row
                               from the move's likelihood == the row from
                               the statistics; every outcome forced == the
                               twin (updates.error_rates_on); both inside a
                               CUDA graph; the captured block == eager;
                               10,000 eager steps of a chain past burn-in
                               and 512 of a batch of 4, each kernel's every
                               call held to the composition; each one's
                               time a call in a graph beside the
                               composition's (run it alone with `python3 -c
                               "import chip_smoke as cs;
                               cs.phase_rest('cuda', cs.nvidia_smi())"`);
                 sm_accept     the split-merge acceptance (kernel 12)
                               against the torch composition on the card
                               and the twin's stages on the card, from
                               seeded launch states at 5,000 x 200: splits
                               and merges, one chain and a batch of 4,
                               Beta(0.25, 0.25) and uniform priors, a padded
                               mask, the uniform forced to 0 and 1: the
                               state, the MH counts and the generators bit
                               for bit; a degenerate split declined; in a
                               CUDA graph; the captured block == eager;
                               7,000 eager steps of a chain past burn-in (at
                               least 2,000 moves) and 256 of a batch of 4,
                               every move held to the
                               composition; the time a call in a graph
                               beside the twin's (run it alone with
                               `python3 -c "import chip_smoke as cs;
                               cs.phase_sm_accept('cuda',
                               cs.nvidia_smi())"`);
  4. small   — 12 steps on a small input, GPU (kernels) against CPU (plain
               twins) fed identical draws, once per Gibbs impl ("auto" =
               lazy, "stream", "eager", and "blocked": gibbs_block 8, torch
               ops on both devices): assignments, sizes and MH counts
               exactly, every float to rtol 1e-4 (the two devices' ndtri and
               log differ in the last ulps, and the inverse-CDF proposals
               amplify that in the tails: measured 1.8e-5 on an H100);
  5. main    — the main path: MCMCRunner on the card at the bench
               configuration (5,000 x 200, k_max 256, learned errors,
               sm 0.33 / sm_steps 3 / dpa 0.25 / err 0.25), 256 warm-up and
               256 timed steps; state invariants, lazy_segment and
               rg_assign launched (rg_scan not), steps/s, launches per
               sweep, host syncs per step, cluster count and ARI against
               the planted truth; the mean and the largest s_count of its
               rg_assign launches (kept on the device, read once after the
               timed block);
  6. large   — the large-n path: MCMCRunner at 131,072 x 200, k_max 128
               (benchmarks/scale_bench.py's data and configuration), 16
               warm-up and 64 timed steps; the same invariants, lazy_stream
               and rg_scan launched and lazy_segment never; then rg_scan
               timed at 131,072 cells with the mean and the largest s_count
               this path gave it;
  7. eager   — make_block_fn(gibbs_impl="eager") at the bench
               configuration (the captured block: kernel 4 in a replayed
               graph, each replay counting its launch), 64 warm-up and 256
               timed steps; the same invariants, eager_sweep launched;
               steps/s beside phase 5's;
  8. probes  — the two probes' entry points (bnpc_tpu_torch/probes/):
               vecflow_probe.main() (vecflow against lazy_segment at 5,000
               x 256) and while_probe.main() (the full no-birth run at 512 x
               256 beside lazy_segment there, and one relaunch: alone, until
               the call returns, and with its host read); and
               chain_probe.main(), the cycles of the links of the serial
               chain, from which each kernel's chain bound is computed:
               cells x the shortest dependent chain / the SM clock;
  9. cli     — the port's entry point, bnpc_tpu_torch.cli.main, on the card:
               the main cell's data written as the reference's input file
               (mutations x cells, 3 for missing) and run with -s 512 -e
               posterior ML MAP (lazy_segment and rg_assign launched,
               lazy_stream and rg_scan not), then the 131,072-cell data with -s 64
               --max_clusters 128 (lazy_stream and rg_scan, never
               lazy_segment); args.txt, errors.txt, assignment.txt and every
               genotypes_<est>_mean.tsv parsed (n entries, m x n finite); a
               line of stage seconds per cell, each stage ending in
               torch.cuda.synchronize(); the posterior's ARI against the
               planted clones. Then the main cell's chain result through
               io.infer_results on the card and on the CPU, on the landmark
               MPEAR path and on the exact one (BNPC_TPU_MPEAR_EXACT_MAX
               8192): assignments equal exactly, floats to rtol 1e-5, PSRF
               equal.
 10. modes   — the other run modes at the main cell (5,000 x 200, k_max
               256, the bench mixture), each check on its own line:
               (a) 4 chains x 256 steps through MCMCRunner.run: total
               chain-steps/s beside the one-chain steps/s of this call,
               each chain's state invariants, lazy_segment and rg_assign
               launched (lazy_stream never), chain 1 == the one-chain run
               with its seed, bit for bit; (b) 2 coupled chains x 64 steps:
               invariants and launches; (c) 2 chains, block 64, a
               checkpoint every block: 128 steps, then fresh runners
               resume to 192 and (a partial final block) to 160, each ==
               the uninterrupted run bit for bit; each save's seconds and
               bytes; (d) time mode, 2 chains, a 10 s deadline and 3 s of
               burn-in: steps, burn-in, and the last block's end past the
               deadline (at most one block's time); (e) lugsail, 2 chains,
               cutoff 1.1: the PSRF log, the stop step and the burn-in;
               (f) gibbs_block 128 at the main cell (8 warm-up and 32
               timed steps) and 512 at the large-n cell (2 and 8): steps/s
               beside the exact path's from the same state in this call,
               both through the captured block,
               no Gibbs kernel launched by a blocked move,
               ARI against the planted clones; (g) cli.main with -n 2 -s
               256 --checkpoint_dir -e posterior: the files, two
               chain_seeds and a PSRF in args.txt, the checkpoint written.
 11. mesh    — bnpc_tpu_torch/parallel/ with two ranks sharing the card
               (gloo; spawned processes running mesh_rank): (a) a 2 x 1
               mesh, 2 chains x 128 steps at the main cell, each chain ==
               its one-process run in this process, bit for bit; (b) a
               1 x 2 mesh at the main cell, 128 steps in blocks of 32: the
               hashes of each block's replicated state (assignment, sizes,
               alpha, FP, FN) equal on both ranks, the invariants, kernels
               1 and 9 launched on each rank, steps/s beside one process's
               in this call, the all-reduces a step, their MB, and their
               ms a step (32 more steps, each all-reduce between two device
               synchronizations); (c) a 1 x 2 mesh at 131,072 x 200, k_max
               128, 16 steps: kernel 3 on each rank, hashes equal; (d)
               500 x 201 (padded to 202) over 1 x 2, 12 steps on the card
               and on the CPU (the same ranks, gloo on host tensors) from
               the same state each step on identical draws: discrete
               outputs exactly, floats rtol 1e-4 (params also atol 1e-6,
               8.4 float32 ulps of 1.0: near TMIN a proposal's last-ulp
               ndtri difference shows at that scale); (e) a rank's local
               chains as one batch (chain_exec="vmap") against one after
               another ("sequential"), same seed, at the main cell, 64
               steps in blocks of 32: a 2 x 1 mesh with 4 chains (2 a rank)
               and a 1 x 2 mesh with 2 chains; each chain == its sequential
               run bit for bit, the hashes of the replicated state and the
               all-reduce count after every block equal on both ranks of
               the 1 x 2 group, kernels 1 and 9 launched batched only, on
               grids of 1 and 2 (2 among them), chain-steps/s, all-reduces
               a step with their MB and ms (16 more steps, timed) of both
               forms; (f) cli.main with --mesh 1,2 and --mesh 2,1 at the
               main cell, -s 64: one set of files, "Writing output to"
               printed once; then run_bnpc_tpu_torch.py --mesh 1,2 -n 2 -s
               32 as a process of its own: the chain_exec "auto" chose
               (printed), the files.
 12. chains  — batched chains (MCMCRunner chain_exec="vmap": every chain
               steps at once, kernels 1, 3 and 2 on a grid of one block a
               chain): (a) each of the three kernels (kernel 3 in both
               layouts, the shared-memory one at k_pad 2,016) on a crafted
               5-chain batch, == its batched twin and == five one-chain
               launches exactly (kernels 1 and 3: a birth at the start, a
               birth at n - 1, no birth, a chain already done, a birth mid-
               segment; kernel 2: s_count 0, 1, 37, 1,984 and n), and at
               the large-n path's shapes: kernel 3 on the 131,072 x 128 Z
               (register layout; chains started near the end: a birth, a
               run to n, a chain already done) and kernel 2 at n =
               131,072 (s_count n, 6,557 and 1), each == its batched twin
               and == one one-chain launch a chain; one batched launch timed at C = 1, 4, 16, 132 chains (kernels 1
               and 2, main shape) and C = 1, 4, 16 (kernel 3, 131,072 x
               128), beside the one-chain wrapper; (b) after 2 chains x 8
               steps of each form (untimed: the kernels load), the main
               cell, 4 chains x 128 steps, "vmap" (the captured batch)
               against "sequential" (each chain's captured block) in this
               call, a fresh runner a run, runs vmap, sequential,
               sequential, vmap: chain by chain bit for bit, median, min
               and max chain-steps/s of both,
               every kernel launch of the batched run on a chain grid (the
               grids counted); a profiled step of all 4 chains in each form
               (the eager forms: launches, draw calls, device busy share,
               host syncs); the
               lazy loop's rounds a sweep against each chain's launches;
               64 steps saved under "vmap" resumed under "sequential" ==
               the uninterrupted run, bit for bit; (c) 16 chains x 64 steps;
               (d) 4 coupled chains x 64 steps; (e) the large-n cell, 2
               chains x 16 steps, kernels 3 and 2 on grids of 2 ((c)-(e)
               interleaved as (b)); (f) the
               blocked sweep batched: gibbs_block 128 at the main cell, 4
               chains x 64 steps, and 512 at the large-n cell, 2 x 16, each
               "vmap" (the captured batch) against "sequential" (captured
               blocks) in this call, runs vmap, sequential, sequential,
               vmap, a fresh runner a run, chain by chain bit for bit
               (assignments, MH counts, trace floats), chain-steps/s
               of both, the split-merge scan's kernel the only one
               (batched: rg_assign at the main cell, rg_scan at large-n); at the main cell
               a profiled step of all 4 chains in each form (launches, draw
               calls, busy share, host syncs); (g) cli.main -n 4 -s 128: the
               chain_exec "auto" chose printed, the files parsed. Then
               whether the batch reached the sequential chain-steps/s at
               both cells, exact and blocked (the rules of "auto").
 13. captured — the one-chain block as CUDA graphs (MCMCRunner.run_block
               on the card, mcmc.py::_CapturedBlock) against the eager
               block (mcmc._chain_block over the runner's own step) in
               this call: (a) from the same state and generator state,
               bit for bit in every trace field, the state and the
               generator's state: the main cell 2 x 256 steps from the
               initial state (a birth round, a split and a merge among
               them) and the large-n cell 32 steps; (b) blocks of 128
               (main) and 16 (large-n) steps from one state, eager,
               captured, captured, eager: min / median / max steps/s of
               each form and the ratio of the medians; (c) a step's costs
               of each form: host-side launches (cudaGraphLaunch and the
               kernel launches among torch.profiler's runtime and driver
               events), kernel executions, host syncs, device busy share,
               peak memory; the graphs captured, their capture seconds
               and their pool's MB. At the main cell the captured form
               must make fewer than 20 host-side launches a step and no
               more host syncs than the eager one. (d) the captured batch
               (MCMCRunner.run_chains under chain_exec="vmap",
               mcmc.py::_CapturedBatch) against the eager batch
               (mcmc._batch_block over the runner's own step) at the main
               cell, 4 chains x 128 steps, 16 x 64 and 4 coupled x 64, and
               at the large-n cell, 2 x 16: from the same initial states
               and generator states, blocks eager, captured, captured,
               eager, each bit for bit against the first (every trace
               field, each chain's state and generator state); min /
               median / max chain-steps/s of each form, the replay share
               of each captured block's piece runs; a step of all chains'
               costs in each form as in (c); the graphs a runner, their
               capture seconds and pool MB. At the main cell with 4 chains
               the captured batch must make fewer than 100 host-side
               launches a step and no more host syncs than the eager one.
               (e) the blocked sweep's captured block against its eager
               block as (a)-(c): main gibbs_block 128, 2 x 32 compared
               steps (at least two replayed birth blocks), 32 a timed
               block, 8 profiled; large-n 512, 8, 4, 2; (f) its captured
               batch against the eager batch as (d): main 4 chains x 64,
               large-n 2 x 16; (g) the eager sweep's captured block
               (make_block_fn(gibbs_impl="eager")) against _chain_block
               over make_step_fn's eager step, 64 steps compared and a
               timed block, 8 profiled, kernel 4's launches (each replay
               adding its graph's) == the Gibbs sweeps; in each one-chain
               window both forms' launch counts equal. Gates: the captured
               form makes fewer host-side launches a step than the eager
               one (eager: also under 20) and no more host syncs.
Phases 5-12 run the captured block wherever they take the one-chain path
of the lazy, stream, eager or blocked sweep (the runner's run_block and
run, chains one after another, the CLI, make_block_fn), and the captured
batch wherever they batch chains under "vmap" without a mesh; a launch
counter counts each replay's launches there.

Before each of phases 5-7, before each probe in phase 8, before each CLI
run of phase 9 and before each run of phase 10 that is checked for its
launches, every kernel's launch counter is set to 0; the counters read
after it are that path's launches (the probes' paths are their main()s).
The kernel line's launches are those of phases 5-8 (kernels 1-3 add
batched_ms, one launch of 16 chains, batched_launches, those of phase 12
(b) and (e), mesh_batched_launches, rank 0's of phase 11 (e) at 1 x 2,
and blocked_batched_launches, those of phase 12 (f) at the main cell);
phase 11's ranks
count their own launches (each rank's counters are 0 before each run).
The last three lines are the nvidia-smi line, a JSON line with one entry
per kernel, and {"ok": true, "device": {...}}; before them, the script's
total seconds.
"""

import json
import os
import time
import warnings

import numpy as np

from bnpc_tpu_torch.draws import TorchDraws
from bnpc_tpu_torch.probes import card as nvidia_smi
from bnpc_tpu_torch.probes import cuda_ms

N, M, K_MAX = 5000, 200, 256
N_LARGE, K_LARGE = 131072, 128
STREAM_TAIL = 8192
# The movable cells of the launch scan whose kernel 9 time the kernels
# line reports (the main path's moves hold 397 on average, 888 at most).
RG_TIMED_S = 1000
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): device memory bandwidth
# and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float operations the per-cell step spends on each slot: max(size, 0),
# log, subtract, add, the max reduction and the tie compare.
OPS_PER_SLOT = 6
MIX = dict(sm_prob=0.33, dpa_prob=0.25, error_prob=0.25, sm_steps=3)


def log(msg):
    print(msg, flush=True)


class HostDraws(TorchDraws):
    """Draws generated on the CPU and returned on `device`: a CPU run and a
    GPU run consume identical numbers (a shard's own stream too)."""

    def __init__(self, seed, device):
        import torch

        super().__init__(seed, "cpu")
        self.device = torch.device(device)


def make_data(n, m, k_clones, missing, seed=0, fp=0.001):
    """The bench's simulated clone matrix (the generator of
    benchmarks/accuracy_bench.py:make_data and, with fp=0.001, 20 clones
    and missing 0.1, of benchmarks/scale_bench.py:make_data; numpy only).
    Returns (data, planted assignment)."""
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 2, size=(k_clones, m))
    assign = rng.integers(0, k_clones, size=n)
    data = geno[assign].astype(float)
    data[(data == 1) & (rng.random((n, m)) < 0.1)] = 0
    data[(data == 0) & (rng.random((n, m)) < fp)] = 1
    data[rng.random((n, m)) < missing] = np.nan
    return data, assign


def bench_configs(n=N, k_max=K_MAX):
    from bnpc_tpu_torch.config import MCMCConfig, ModelConfig

    cfg = ModelConfig(n_cells=n, n_muts=M, k_max=k_max, p=0.25, q=0.25,
                      fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
                      fn_sd=0.1)
    return cfg, MCMCConfig(**MIX)


def bound(bytes_moved, ops):
    """(least ms, what bounds it): bytes over the HBM rate against float32
    operations over the float32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        d = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
        err = max(err, d)
    return err


def kernel_modules():
    from bnpc_tpu_torch.ops import (cuda_beta, cuda_error_mh, cuda_gibbs,
                                    cuda_mh, cuda_rg, cuda_rg_assign,
                                    cuda_row, cuda_sm_accept, cuda_stream,
                                    cuda_sweep)
    from bnpc_tpu_torch.probes import vecflow_probe, while_probe

    return {"lazy_segment": cuda_gibbs, "rg_scan": cuda_rg,
            "lazy_stream": cuda_stream, "eager_sweep": cuda_sweep,
            "vecflow": vecflow_probe, "while_exit": while_probe,
            "mh_sweep": cuda_mh, "beta_post": cuda_beta,
            "rg_assign": cuda_rg_assign, "error_mh": cuda_error_mh,
            "trace_row": cuda_row, "sm_accept": cuda_sm_accept}


# The kernels of every step's rest (kernels 10 and 11: the error-rate MH,
# which a step with learned errors takes a quarter of the time, and the
# trace row), on every path that runs steps.
REST_KERNELS = {"error_mh", "trace_row"}
# The split-merge move's kernels beside its launch scans' (kernels 8 and
# 12: the Beta rows and the acceptance), on every path that runs moves.
SM_KERNELS = {"beta_post", "sm_accept"}


def rg_kernel(n):
    """The kernel a split-merge launch scan of n cells runs on the card:
    kernel 9 (rg_assign) up to its cell cap, else kernel 2's own entry
    (rg_scan) inside the torch composition."""
    from bnpc_tpu_torch.ops.cuda_rg_assign import MAX_CELLS

    return "rg_assign" if n <= MAX_CELLS else "rg_scan"


def reset_launches():
    for mod in kernel_modules().values():
        mod.launches = 0
        if hasattr(mod, "chain_launches"):
            mod.chain_launches = 0
            mod.chain_grids.clear()


def read_launches():
    """Each kernel's launches since the reset, one-chain and batched."""
    return {name: mod.launches + getattr(mod, "chain_launches", 0)
            for name, mod in kernel_modules().items()}


def read_one_chain_launches():
    return {name: mod.launches for name, mod in kernel_modules().items()}


class SetupLaunches:
    """While active, the kernel launches made inside the captured
    executors' row set-up (mcmc._Captured._setup_rows: one eager summarize,
    which launches kernel 11, outside any graph): a captured block's first
    call adds them to what its steps' replays add."""

    def __enter__(self):
        from bnpc_tpu_torch import mcmc

        self.real = mcmc._Captured._setup_rows
        self.launches = {name: 0 for name in kernel_modules()}
        counted = self

        def setup_rows(block, state):
            before = read_launches()
            counted.real(block, state)
            for name, v in read_launches().items():
                counted.launches[name] += v - before[name]

        mcmc._Captured._setup_rows = setup_rows
        return self

    def __exit__(self, *exc):
        from bnpc_tpu_torch import mcmc

        mcmc._Captured._setup_rows = self.real

    def take(self):
        """The launches counted since the last take."""
        out = dict(self.launches)
        self.launches = {name: 0 for name in out}
        return out


def check_launches(path, launches, used):
    """Every kernel of `used` launched on the path, and no other."""
    for name, count in launches.items():
        if (count > 0) != (name in used):
            raise AssertionError(f"{path}: launches {launches}, expected "
                                 f"exactly {sorted(used)} to run")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their twins
# ---------------------------------------------------------------------------


def segment_case(dev, assign_np, hot, k_max, k_pad, i0):
    """(assign, aux, sizes, i0) tensors of one segment case: aux is -1e30
    except +1e30 at the `hot` indices."""
    import torch

    n = assign_np.shape[0]
    aux = np.full(n, -1e30, np.float32)
    aux[hot] = 1e30
    sizes = np.bincount(assign_np, minlength=k_pad).astype(np.float32)
    sizes[k_max:] = -1.0
    return (torch.from_numpy(assign_np.astype(np.int32)).to(dev),
            torch.from_numpy(aux).to(dev), torch.from_numpy(sizes).to(dev),
            i0)


def run_segment(fn, args, n, sizes0, i0, log_denom, dev):
    """One segment of `fn` on fresh outputs: (tgt, sizes, info)."""
    import torch

    sizes = sizes0.clone()
    tgt = torch.full((n,), -7, dtype=torch.int32, device=dev)
    info = torch.zeros((4,), dtype=torch.int32, device=dev)
    fn(*args, sizes, tgt, info, i0, log_denom)
    torch.cuda.synchronize()
    return tgt, sizes, info


def compare_segment(name, kernel, twin, expect_next, expect_b, veto_want):
    """Kernel and twin (tgt, sizes, info) equal, info as expected."""
    import torch

    (kt, ks, ki), (rt, rs, ri) = kernel, twin
    if not (torch.equal(kt, rt) and torch.equal(ks, rs)
            and torch.equal(ki, ri)):
        raise AssertionError(f"{name}: kernel {ki.tolist()} != twin "
                             f"{ri.tolist()} or targets/sizes differ")
    i_next, b, _, veto = ki.tolist()
    if (i_next, b) != (expect_next, expect_b) or bool(veto) != veto_want:
        raise AssertionError(f"{name}: info {ki.tolist()}")
    log(f"  {name}: info {ki.tolist()} — kernel == twin")
    return [(kt, rt), (ks, rs), (ki, ri)]


def crafted_case(k_pad, k_max, seed=0):
    """A 300-cell sweep from position 37 (the middle of a 32-position chunk
    and of a turn of the 8-row ring) that meets, in visit order: a tie for
    the best logit between two slots of different lanes; between two slots
    of one lane (k_max > 41); between -0.0 and +0.0; a cell whose logits are
    all -inf; a cluster dying to size 0 at a low slot; and a birth, which
    must take that slot. log_denom is 0 and the tied slots hold one
    (phantom) cell each, so their weights are exactly 0. Returns numpy
    inputs and {position: expected target}."""
    n, i0 = 300, 37
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((n, k_pad)) * 3.0).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    lanes = [k_max - 9, k_max - 8]        # a tie across lanes
    zeros = [k_max - 7, k_max - 6]        # -0.0 against +0.0
    pair = [8, 40] if k_max > 41 else []  # a tie within lane 8
    reserved = lanes + zeros + pair
    free = [k_max - 3, k_max - 2, k_max - 1]
    assign = rng.choice([0, 2, 3, 4, 5], n).astype(np.int32)
    sizes = np.full(k_pad, 3.0, np.float32)  # phantom cells elsewhere
    sizes[:6] = np.bincount(assign, minlength=6)[:6]
    sizes[reserved] = 1.0
    sizes[free] = 0.0
    sizes[k_max:] = -1.0
    z[:, reserved + [1]] = -100.0  # no other cell joins these slots
    aux = np.full(n, -1e30, np.float32)
    c_lanes, c_pair, c_zero, c_inf, c_die, c_born = perm[
        [60, 90, 120, 150, 180, 230]]
    want = {}
    z[c_lanes] = -100.0
    z[c_lanes, lanes] = 50.0
    want[60] = lanes[0]
    if pair:
        z[c_pair] = -100.0
        z[c_pair, pair] = 50.0
        want[90] = pair[0]
    z[c_zero] = -1000.0
    z[c_zero, zeros[0]], z[c_zero, zeros[1]] = -0.0, 0.0
    want[120] = zeros[0]
    z[c_inf] = -np.inf
    aux[c_inf] = -np.inf
    want[150] = 0
    # Slot 1 holds c_die alone; it leaves for slot 0, and c_born's winning
    # new-cluster option must take slot 1, below the free slots at the top.
    sizes[assign[c_die]] -= 1.0
    assign[c_die], sizes[1] = 1, 1.0
    z[c_die, 0] = 60.0
    want[180] = 0
    aux[c_born] = 1e30
    want[230] = 1
    return dict(z=z, aux=aux, assign=assign, perm=perm, sizes=sizes, n=n,
                i0=i0, want=want)


def crafted_check(name, dev, k_pad, k_max, stream_order):
    """Kernel == twin on crafted_case, relaunched after the birth as the
    drivers do (without their z patch), and the expected targets. Returns
    the compared pairs."""
    import torch

    from bnpc_tpu_torch.ops.cuda_gibbs import lazy_segment, lazy_segment_ref
    from bnpc_tpu_torch.ops.cuda_stream import (lazy_segment_stream,
                                                lazy_segment_stream_ref)

    c = crafted_case(k_pad, k_max)
    n, order = c["n"], c["perm"].astype(np.int64)

    def t(x):
        return torch.from_numpy(np.array(x)).to(dev)  # a copy each call

    if stream_order:
        args = (t(c["z"][order]), t(c["aux"][order]), t(c["assign"][order]))
        fns = (lazy_segment_stream, lazy_segment_stream_ref)
    else:
        args = (t(c["z"]), t(c["aux"]), t(c["assign"]), t(c["perm"]))
        fns = (lazy_segment, lazy_segment_ref)
    log_denom = torch.zeros((), device=dev)
    state = [t(c["sizes"]), t(c["sizes"])]
    tgts = [torch.full((n,), -7, dtype=torch.int32, device=dev)
            for _ in fns]
    pairs, i, launches = [], c["i0"], 0
    while i < n:
        infos = []
        for fn, sizes, tgt in zip(fns, state, tgts):
            info = torch.zeros((4,), dtype=torch.int32, device=dev)
            fn(*args, sizes, tgt, info, i, log_denom)
            infos.append(info)
        torch.cuda.synchronize()
        if not (torch.equal(infos[0], infos[1])
                and torch.equal(state[0], state[1])
                and torch.equal(tgts[0], tgts[1])):
            raise AssertionError(f"{name} crafted k_pad={k_pad} from {i}: "
                                 f"kernel {infos[0].tolist()} != twin "
                                 f"{infos[1].tolist()} or targets/sizes "
                                 "differ")
        pairs += [(infos[0], infos[1]), (state[0].clone(), state[1].clone())]
        i, launches = int(infos[0][0]), launches + 1
    pairs.append((tgts[0], tgts[1]))
    got = tgts[0].tolist()
    for pos, slot in c["want"].items():
        if got[pos] != slot:
            raise AssertionError(f"{name} crafted k_pad={k_pad}: position "
                                 f"{pos} went to {got[pos]}, expected {slot}")
    if launches != 2:
        raise AssertionError(f"{name} crafted k_pad={k_pad}: {launches} "
                             "launches, expected 2 (one birth)")
    return pairs


def _log_weight(size, log_denom):
    """The kernels' log weight of one slot size, as the plain twin takes
    it (float32)."""
    import torch

    x = torch.tensor([size], dtype=torch.float32)
    return (torch.log(torch.clamp(x, min=0.0)) - log_denom).numpy()[0]


def _z_for(target, w):
    """A float32 z with fl(z + w) == target (None if no float near
    target - w gives it)."""
    z = np.float32(target - w)
    for _ in range(8):
        s = np.float32(z + w)
        if s == target:
            return z
        z = np.nextafter(z, np.float32(np.inf if s < target else -np.inf),
                         dtype=np.float32)
    return None


def near_tie_case(k_pad, seed=0):
    """A 160-cell sweep from position 5 for kernel 1's bound and verify
    (csrc/lazy_segment.cu). Every cell's home slot beats the rest by ~100
    nats, except, in visit order: cells whose top two logits at their visit
    sit 0, 1 and 2 floats apart, the better one at the lower or the higher
    slot, across lanes and (k_pad >= 64) within one lane; a cell that
    moves to slot 0, a singleton, whose log weight so rises by ~log 2; and
    then a cell whose slot-0 logit at its visit ties its best slot's (slot
    0 wins the tie), while its launch bound plus D, the bound on that rise,
    rounds to the float below: a check without its tolerance settles that
    cell on the wrong slot. Returns crafted_case's dict with `log_denom`."""
    n, i0, k_max = 160, 5, k_pad - 2
    rng = np.random.default_rng(seed)
    log_denom = np.float32(np.log(n - 1.0 + 1.0))
    live = min(k_max, 24)  # slots 0 .. live - 1 hold cells
    pairs = [(1, 2), (2, 3)]  # across lanes
    if k_pad >= 64:
        pairs += [(1, 33), (2, 34)]  # within lane 1, lane 2
    specials = []
    for gap in (0, 1, 2):
        for lo, hi in pairs:
            for better in ((lo,) if gap == 0 else (lo, hi)):
                specials.append(("tie", lo, hi, gap, better))
    specials += [("gain",), ("round",)]
    # The special cells at every fifth position from i0 + 3, each leaving
    # slot live - 1 for its pick; every other cell has a home in 6 ..
    # live - 1 and returns to it.
    at = {i0 + 3 + 5 * j: sp for j, sp in enumerate(specials)}
    perm = rng.permutation(n).astype(np.int32)
    assign = rng.integers(6, live, n).astype(np.int32)
    assign[perm[list(at)]] = live - 1
    z = (rng.standard_normal((n, k_pad)) * 0.5 - 100.0).astype(np.float32)
    z[np.arange(n), assign] = 0.0
    sizes = np.zeros(k_pad, np.float32)
    sizes[1:live] = 20.0  # phantom cells
    sizes[[33, 34] if k_pad >= 64 else []] = 20.0
    sizes[0] = 1.0
    sizes += np.bincount(assign, minlength=k_pad).astype(np.float32)
    sizes[k_max:] = -1.0
    launch = sizes.copy()
    want = {}
    cur = launch.copy()
    for i in range(i0, n):
        c = perm[i]
        sp = at.get(i)
        if sp is None:
            continue  # home again: the sizes stand as they were
        cur[assign[c]] -= 1.0
        z[c] = -100.0
        if sp[0] == "tie":
            _, lo, hi, gap, better = sp
            other = hi if better == lo else lo
            top = np.float32(-2.5 + 0.1 * rng.standard_normal())
            low = top
            for _ in range(gap):
                low = np.nextafter(low, np.float32(-np.inf),
                                   dtype=np.float32)
            for slot, target in ((better, top), (other, low)):
                z[c, slot] = _z_for(target, _log_weight(cur[slot],
                                                        log_denom))
                assert not np.isnan(z[c, slot]), "no z for a near tie"
            t = better
        elif sp[0] == "gain":
            z[c, 0] = 0.0
            t = 0
        else:
            # D is the gain's rise, fl(w_0 - w0_0), the largest change yet.
            w_now = _log_weight(cur[0], log_denom)
            d = np.float32(w_now - _log_weight(launch[0], log_denom))
            w0_g = _log_weight(launch[0], log_denom)
            q, found = 5, None
            for trial in range(64):
                top = np.float32(-10.0 - 0.37 * trial)
                zq = _z_for(top, _log_weight(cur[q], log_denom))
                for k in range(-64, 65):
                    zg = np.float32(top - w_now + np.float32(k) * np.float32(
                        2.0 ** -20))
                    if (np.float32(zg + w_now) == top
                            and np.float32(np.float32(zg + w0_g) + d) < top):
                        found = zq, zg
                        break
                if found:
                    break
            assert found, "no rounding case"
            z[c, q], z[c, 0] = found
            t = 0
        cur[t] += 1.0
        want[i] = t
    aux = np.full(n, -1e30, np.float32)
    return dict(z=z, aux=aux, assign=assign, perm=perm, sizes=launch, n=n,
                i0=i0, want=want, log_denom=log_denom)


def verified_check(dev, cases, batched):
    """Kernel 1 on `cases` (near_tie_case dicts of one n), relaunched after
    each birth as the sweep's host loop does (without its z patch): one
    chain through the one-chain entry, or all of them on one grid. At every
    launch its tgt, sizes and info == the twin's, its bounds ==
    lazy_bounds_ref's; over the sweep each chain's full picks ==
    lazy_segment_verified_ref's.
    Returns (compared pairs, full picks a chain)."""
    import torch

    from bnpc_tpu_torch.ops import cuda_gibbs as cg

    k, n = len(cases), cases[0]["n"]

    def t(f):
        return torch.from_numpy(np.stack([c[f] for c in cases])).to(dev)

    z, aux, assign, perm, sizes0 = (t(f) for f in ("z", "aux", "assign",
                                                   "perm", "sizes"))
    ld = torch.tensor([c["log_denom"] for c in cases], device=dev)
    sizes = [sizes0.clone(), sizes0.clone()]  # kernel, twin
    tgts = [torch.full((k, n), -7, dtype=torch.int32, device=dev)
            for _ in sizes]
    i0s = [torch.tensor([c["i0"] for c in cases], dtype=torch.int32,
                        device=dev) for _ in sizes]
    bounds = torch.empty((k, 3, n), device=dev)
    full = torch.zeros(k, dtype=torch.int32, device=dev)
    model_full = [0] * k
    pairs = []
    while bool((i0s[0] < n).any()):
        before, starts = sizes[0].clone(), i0s[0].tolist()
        infos = [torch.zeros((k, 4), dtype=torch.int32, device=dev)
                 for _ in sizes]
        if batched:
            cg.lazy_segment_chains(z, aux, assign, perm, sizes[0], tgts[0],
                                   infos[0], i0s[0], ld, bounds, full)
            cg.lazy_segment_chains_ref(z, aux, assign, perm, sizes[1],
                                       tgts[1], infos[1], i0s[1], ld)
        else:
            for j, fn in enumerate((cg.lazy_segment, cg.lazy_segment_ref)):
                kw = dict(bounds=bounds[0], full=full) if j == 0 else {}
                fn(z[0], aux[0], assign[0], perm[0], sizes[j][0], tgts[j][0],
                   infos[j][0], starts[0], ld[0], **kw)
                i0s[j][0] = infos[j][0, 0]
        torch.cuda.synchronize()
        for c, i0 in enumerate(starts):
            if i0 >= n:
                continue
            want = cg.lazy_bounds_ref(z[c], perm[c], before[c], i0, ld[c])
            if not torch.equal(bounds[c][:, i0:], want[:, i0:]):
                raise AssertionError(f"lazy_segment bounds from {i0}: "
                                     "kernel != lazy_bounds_ref")
            model_full[c] += cg.lazy_segment_verified_ref(
                z[c].cpu(), aux[c].cpu(), assign[c].cpu(), perm[c].cpu(),
                before[c].cpu(), torch.empty(n, dtype=torch.int32),
                torch.empty(4, dtype=torch.int32), i0, ld[c].cpu())
        if not all(torch.equal(a, b) for a, b in
                   zip((infos[0], sizes[0], tgts[0], i0s[0]),
                       (infos[1], sizes[1], tgts[1], i0s[1]))):
            raise AssertionError(f"lazy_segment near ties k_pad "
                                 f"{z.shape[-1]} x {k} from {starts}: "
                                 f"kernel {infos[0].tolist()} != twin "
                                 f"{infos[1].tolist()} or targets/sizes "
                                 "differ")
        pairs += [(infos[0], infos[1]), (sizes[0].clone(), sizes[1].clone())]
    pairs.append((tgts[0], tgts[1]))
    for c, case in enumerate(cases):
        got = tgts[0][c].tolist()
        if any(got[p] != slot for p, slot in case["want"].items()):
            raise AssertionError(f"lazy_segment near ties chain {c}: "
                                 "targets not the crafted ones")
    if full.tolist() != model_full:
        raise AssertionError(f"lazy_segment full picks {full.tolist()} != "
                             f"the model's {model_full}")
    return pairs, model_full


def real_sweep_input(dev, blocks=7):
    """Kernel 1's input as the main path makes it: the sweep input of a
    5,000 x 200 chain (chip_smoke's main cell) after `blocks` 256-step
    blocks, past the benchmark's 1,650-step burn-in. Returns (z, aux,
    assign, perm, sizes, log_denom) at k_pad 256."""
    import torch

    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.mcmc import MCMCRunner
    from bnpc_tpu_torch.models.gibbs import (_padded_sizes,
                                             _split_sweep_keys,
                                             _sweep_inputs)
    from bnpc_tpu_torch.ops.cuda_gibbs import lazy_k_pad

    data, _ = make_data(N, M, 10, 0.1, seed=0)
    cfg, mc = bench_configs()
    packed = pack_data(data, dev)
    runner = MCMCRunner(cfg, mc, packed, device=dev, block_size=256)
    state = runner.init_chains(TorchDraws(0, dev))[0]
    draws = TorchDraws(1, dev)
    for _ in range(blocks):
        state, _, draws = runner.run_block(state, draws, 256)
    k_perm, k_gumbel, _ = _split_sweep_keys(TorchDraws(2, dev))
    perm, _, z, aux, ld = _sweep_inputs(k_perm, k_gumbel, state, packed, cfg)
    k_pad = lazy_k_pad(K_MAX)
    zp = torch.nn.functional.pad(z, (0, k_pad - K_MAX)).contiguous()
    return (zp, aux.contiguous(), state.assignment.to(torch.int32),
            perm.to(torch.int32), _padded_sizes(state, k_pad),
            ld.to(torch.float32))


def kernel1_timing(dev, name, args, sizes0, reps=21):
    """Kernel 1 from position 0 on (z, aux, assign, perm), sizes0 fresh each
    call: CUDA-event ms a call, the bound pass's share of the kernels'
    device time (torch.profiler, 5 calls), positions visited and the share
    of full picks."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bnpc_tpu_torch.ops.cuda_gibbs import lazy_segment

    n = args[3].shape[0]
    tgt = torch.empty((n,), dtype=torch.int32, device=dev)
    info = torch.empty((4,), dtype=torch.int32, device=dev)
    full = torch.zeros(1, dtype=torch.int32, device=dev)
    ld = args[-1]
    lazy_segment(*args[:4], sizes0.clone(), tgt, info, 0, ld, full=full)
    torch.cuda.synchronize()
    visited, picks = int(info[0]), int(full[0])
    buf = iter([sizes0.clone() for _ in range(reps)])
    ms = cuda_ms(lambda: lazy_segment(*args[:4], next(buf), tgt, info, 0,
                                      ld), reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            lazy_segment(*args[:4], sizes0.clone(), tgt, info, 0, ld)
        torch.cuda.synchronize()
    role_us = {True: 0.0, False: 0.0}
    for ev in prof.key_averages():
        if "lazy_segment_kernel" in ev.key:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            role_us[", true>" in ev.key] += us
    total = role_us[True] + role_us[False]
    out = {"ms": ms, "visited": visited, "full_picks": picks,
           "full_share": picks / max(visited, 1),
           "bound_pass_us": role_us[True] / 5,
           "bound_pass_share": role_us[True] / total if total else None}
    log(f"  lazy_segment on {name} (n={n}): {ms:.4f} ms a call, "
        f"{visited} positions to its first birth or the end, full picks "
        f"{picks} ({100.0 * out['full_share']:.2f}%); bound pass "
        f"{out['bound_pass_us']:.2f} us a call, share "
        f"{out['bound_pass_share']} of the kernels' device time (profiler)")
    return out


def phase_lazy_segment(dev):
    import torch

    from bnpc_tpu_torch.ops.cuda_gibbs import (lazy_k_pad, lazy_segment,
                                               lazy_segment_ref)

    k_pad = lazy_k_pad(K_MAX)
    rng = np.random.default_rng(0)
    z = torch.from_numpy(
        (rng.standard_normal((N, k_pad)) * 4.0).astype(np.float32)).to(dev)
    perm = torch.from_numpy(rng.permutation(N).astype(np.int32)).to(dev)
    log_denom = torch.tensor(np.log(N - 1.0 + 10.0), dtype=torch.float32,
                             device=dev)
    perm_h = perm.cpu().numpy()

    cases = {
        # 200 live slots, 56 free; the new-cluster option never wins.
        "no_birth": (segment_case(dev, rng.integers(0, 200, N), [], K_MAX,
                                  k_pad, 0), (N, -1, False)),
        # From position 1000, a birth forced at position 2600.
        "birth": (segment_case(dev, rng.integers(0, 200, N), perm_h[[2600]],
                               K_MAX, k_pad, 1000),
                  (2601, int(perm_h[2600]), False)),
        # Every slot live (>= 19 cells): the first 5 cells' new-cluster
        # option wins with no free slot — vetoed, no birth.
        "veto": (segment_case(dev, np.arange(N) % K_MAX, perm_h[:5], K_MAX,
                              k_pad, 0), (N, -1, True)),
    }
    pairs = []
    for name, ((assign, aux, sizes0, i0), want) in cases.items():
        args = (z, aux, assign, perm)
        outs = [run_segment(fn, args, N, sizes0, i0, log_denom, dev)
                for fn in (lazy_segment, lazy_segment_ref)]
        pairs += compare_segment(f"lazy_segment {name}", *outs, *want)

    # Ties, zeros, -inf, a death and a birth into the freed slot, from the
    # middle of a chunk, at every slots-per-lane width.
    for kp in (32, 64, 128, 256, 512, 1024):
        pairs += crafted_check("lazy_segment", dev, kp, kp - 3, False)
    log("  lazy_segment crafted sweeps (ties across and within lanes, "
        "-0.0/+0.0, all -inf, death then birth into the freed slot, from "
        "position 37) at k_pad 32 ... 1,024 — kernel == twin")
    # Bound and verify: near ties 0, 1 and 2 floats apart and the rounding
    # case a tolerance of 0 gets wrong, one chain and a grid of 4.
    for kp in (32, 64, 128, 256, 512, 1024):
        for chains in (1, 4):
            got, fulls = verified_check(
                dev, [near_tie_case(kp, seed) for seed in range(chains)],
                chains > 1)
            pairs += got
        log(f"  lazy_segment near ties k_pad {kp}: kernel == twin, bounds "
            f"== lazy_bounds_ref, full picks {fulls} == the model's (one "
            "chain and a grid of 4)")

    assign, aux, sizes0, _ = cases["no_birth"][0]
    tgt = torch.empty((N,), dtype=torch.int32, device=dev)
    info = torch.empty((4,), dtype=torch.int32, device=dev)
    rand = kernel1_timing(dev, "random Z", (z, aux, assign, perm, log_denom),
                          sizes0)
    ms = rand["ms"]
    plain_ms = cuda_ms(lambda: lazy_segment_ref(
        z, aux, assign, perm, sizes0.clone(), tgt, info, 0, log_denom), 3)
    # The main path's input: a chain's sweep input past burn-in, kernel ==
    # twin there too.
    real = real_sweep_input(dev)
    outs = [run_segment(fn, real[:4], N, real[4], 0, real[5], dev)
            for fn in (lazy_segment, lazy_segment_ref)]
    pairs += compare_segment("lazy_segment real Z", *outs,
                             int(outs[1][2][0]), int(outs[1][2][1]),
                             bool(outs[1][2][3]))
    real_t = kernel1_timing(dev, "a chain's Z past burn-in", real[:4] +
                            (real[5],), real[4])
    # Every cell: its z row, aux, assign and perm entries in, its target
    # out; the sizes row in and out.
    bound_ms, bound_by = bound(4 * (N * k_pad + 4 * N + 2 * k_pad + 4),
                               OPS_PER_SLOT * N * k_pad)
    log(f"  lazy_segment full segment (n={N}, k_pad={k_pad}): kernel "
        f"{ms:.4f} ms, plain twin {plain_ms:.1f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by})")
    return {"max_abs_err": max_err(pairs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "random_z": rand, "real_z": real_t}


def rg_table(n, n_move, dev):
    """The count log-table as models/splitmerge.py builds it."""
    import torch

    s1r = torch.arange(n + 2, dtype=torch.float32, device=dev)
    n_move = torch.tensor(float(n_move), device=dev)
    return torch.log(s1r + 1.0) \
        - torch.log(torch.clamp(n_move - s1r - 2.0, min=0.0))


def rg_inputs(n, seed, dev):
    """Random margins and launch sides of n cells."""
    import torch

    rng = np.random.default_rng(seed)
    dz = torch.from_numpy(
        (rng.standard_normal(n) * 3.0).astype(np.float32)).to(dev)
    lau = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(dev)
    return dz, lau


def rg_check(name, dz, lau, dtab, s_count, count1, twin_dev=None):
    """Kernel == twin below s_count (the twin on `twin_dev` copies of the
    same inputs where given). Returns the compared pair."""
    import torch

    from bnpc_tpu_torch.ops.cuda_rg import rg_scan, rg_scan_ref

    dev = dz.device
    sc = torch.tensor(s_count, dtype=torch.int32, device=dev)
    c1 = torch.tensor(count1, dtype=torch.int32, device=dev)
    out_k = rg_scan(dz, lau, dtab, sc, c1)[:s_count]
    torch.cuda.synchronize()
    args = (dz, lau, dtab, sc, c1)
    if twin_dev is not None:
        args = tuple(t.to(twin_dev) for t in args)
    out_r = rg_scan_ref(*args)[:s_count].to(dev)
    if not torch.equal(out_k, out_r):
        raise AssertionError(f"rg_scan {name}: kernel != twin")
    log(f"  rg_scan {name}: {int(out_k.sum())} of {s_count} cells on side 1 "
        "— kernel == twin")
    return out_k, out_r


def rg_time(n, s_count, seed, dev, reps):
    """Median ms of the scan at n cells and s_count, on the table and the
    start count a move of that size has."""
    import torch

    from bnpc_tpu_torch.ops.cuda_rg import rg_scan

    dz, lau = rg_inputs(n, seed, dev)
    dtab = rg_table(n, s_count + 2, dev)
    sc = torch.tensor(s_count, dtype=torch.int32, device=dev)
    c1 = lau[:s_count].sum().to(torch.int32)
    rg_scan(dz, lau, dtab, sc, c1)
    return cuda_ms(lambda: rg_scan(dz, lau, dtab, sc, c1), reps)


def phase_rg_scan(dev):
    import torch

    from bnpc_tpu_torch.ops.cuda_rg import rg_scan, rg_scan_ref

    dz, lau = rg_inputs(N, 1, dev)
    lau_h = lau.cpu().numpy()

    def start(s_count):
        return int(lau_h[:s_count].sum())

    pairs = []
    # 1,984 is two whole chunks of the kernel; the others end inside one.
    for s_count in (0, 1, 37, 1984, N):
        pairs.append(rg_check(f"s_count={s_count}", dz, lau,
                              rg_table(N, s_count + 2, dev), s_count,
                              start(s_count)))

    # A tie at the s1 the scan really meets: dz == -dtab[s1], side 0.
    n_c = 600
    dz_c, lau_c = rg_inputs(n_c, 4, dev)
    dtab_c = rg_table(n_c, n_c + 2, dev)
    c1_c = int(lau_c.sum())
    dz_h, lau_ch, tab_h = (t.cpu().numpy() for t in (dz_c, lau_c, dtab_c))
    c1, ties = c1_c, []
    for i in range(n_c):
        s1 = c1 - int(lau_ch[i])
        if i % 97 == 50 and np.isfinite(tab_h[s1]):
            dz_h[i] = -tab_h[s1]
            ties.append(i)
        c1 = s1 + int(np.float32(dz_h[i]) + tab_h[s1] > 0)
    dz_t = torch.from_numpy(dz_h).to(dev)
    out_k, out_r = rg_check(f"{len(ties)} ties", dz_t, lau_c, dtab_c, n_c,
                            c1_c)
    if not ties or int(out_k[ties].sum()) != 0:
        raise AssertionError("rg_scan ties: a tie must go to side 0")
    pairs.append((out_k, out_r))
    # Margins that are not finite, on the full table and on one whose +inf
    # tail (side 0 would empty) the scan reaches.
    dz_n = dz_c.clone()
    dz_n[[4, 140, 390]] = float("inf")
    dz_n[[9, 141, 400]] = float("-inf")
    dz_n[[10, 142, 410]] = float("nan")
    pairs.append(rg_check("dz +inf/-inf/NaN", dz_n, lau_c, dtab_c, n_c,
                          c1_c))
    pairs.append(rg_check("dz +inf/-inf/NaN, n_move 40", dz_n, lau_c,
                          rg_table(n_c, 40, dev), n_c, 30))
    pairs.append(rg_check("+inf tail reached, n_move 40", dz_c.abs() + 5.0,
                          lau_c, rg_table(n_c, 40, dev), n_c, 30))
    pairs.append(rg_check("count1 in the middle", dz_c, lau_c, dtab_c, 150,
                          170))
    # Tables without thresholds: the kernel's serial route.
    for fault in ("swapped pair", "NaN"):
        bad = dtab_c.clone()
        if fault == "NaN":
            bad[c1_c] = float("nan")
        else:
            bad[[c1_c, c1_c + 3]] = bad[[c1_c + 3, c1_c]]
        pairs.append(rg_check(f"serial route ({fault} in the table)",
                              dz_c * 0.1, lau_c, bad, n_c, c1_c))
    # 131,072 cells: the whole table (read from global memory) and a move
    # of one planted clone's size (its range staged). The twin's loop runs
    # on CPU copies of the same tensors there: 131,072 host reads.
    dz_l, lau_l = rg_inputs(N_LARGE, 5, dev)
    lau_lh = lau_l.cpu().numpy()
    for s_count in (N_LARGE, N_LARGE // 20):
        pairs.append(rg_check(
            f"n={N_LARGE} s_count={s_count}", dz_l, lau_l,
            rg_table(N_LARGE, s_count + 2, dev), s_count,
            int(lau_lh[:s_count].sum()), twin_dev="cpu"))

    dtab = rg_table(N, N + 2, dev)
    sc = torch.tensor(N, dtype=torch.int32, device=dev)
    c1 = torch.tensor(start(N), dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: rg_scan(dz, lau, dtab, sc, c1), 51)
    plain_ms = cuda_ms(lambda: rg_scan_ref(dz, lau, dtab, sc, c1), 3)
    bad = dtab.clone()
    bad[[start(N), start(N) + 3]] = bad[[start(N) + 3, start(N)]]
    serial_ms = cuda_ms(lambda: rg_scan(dz, lau, bad, sc, c1), 21)
    large_ms = rg_time(N_LARGE, N_LARGE, 5, dev, 11)
    # dz, lau and dtab in, the sides out; four operations per cell.
    bound_ms, bound_by = bound(4 * (4 * N + 4), 4 * N)
    log(f"  rg_scan s_count={N}: kernel {ms:.4f} ms, plain twin "
        f"{plain_ms:.1f} ms, bound {bound_ms:.6f} ms ({bound_by}); on the "
        f"serial route (a swapped pair in the table) {serial_ms:.4f} ms; at "
        f"n={N_LARGE} with s_count=n {large_ms:.4f} ms")
    return {"max_abs_err": max_err(pairs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "serial_route_ms": serial_ms, "large_full_ms": large_ms}


def phase_lazy_stream(dev):
    import torch

    from bnpc_tpu_torch.ops.cuda_gibbs import (lazy_segment, lazy_segment_ref,
                                               stream_k_pad)
    from bnpc_tpu_torch.ops.cuda_stream import (lazy_segment_stream,
                                                lazy_segment_stream_ref)
    from bnpc_tpu_torch.probes.vecflow_probe import BATCH, n_batches, vecflow

    n, k_pad = N_LARGE, stream_k_pad(K_LARGE)
    rng = np.random.default_rng(2)
    zp = torch.from_numpy(
        (rng.standard_normal((n, k_pad)) * 4.0).astype(np.float32)).to(dev)
    log_denom = torch.tensor(np.log(n - 1.0 + 10.0), dtype=torch.float32,
                             device=dev)
    i0 = n - STREAM_TAIL
    cases = {
        # 100 live slots, 28 free; the new-cluster option never wins.
        "no_birth": (segment_case(dev, rng.integers(0, 100, n), [], K_LARGE,
                                  k_pad, i0), (n, -1, False)),
        # A birth forced mid-segment.
        "birth": (segment_case(dev, rng.integers(0, 100, n), [n - 4000],
                               K_LARGE, k_pad, i0),
                  (n - 3999, n - 4000, False)),
        # Every slot live (1,024 cells each): vetoed wins, no birth.
        "veto": (segment_case(dev, np.arange(n) % K_LARGE,
                              np.arange(i0, i0 + 5), K_LARGE, k_pad, i0),
                 (n, -1, True)),
    }
    pairs = []
    for name, ((assignp, auxp, sizes0, start), want) in cases.items():
        args = (zp, auxp, assignp)
        outs = [run_segment(fn, args, n, sizes0, start, log_denom, dev)
                for fn in (lazy_segment_stream, lazy_segment_stream_ref)]
        pairs += compare_segment(f"lazy_stream {name} (n={n}, k_pad={k_pad},"
                                 f" from {start})", *outs, *want)

    # k_max 2,000: k_pad 2,016 > 1,024, the shared-memory sizes row.
    n_w, k_w = 4096, 2000
    kp_w = stream_k_pad(k_w)
    zw = torch.from_numpy(
        (rng.standard_normal((n_w, kp_w)) * 4.0).astype(np.float32)).to(dev)
    ld_w = torch.tensor(np.log(n_w - 1.0 + 10.0), dtype=torch.float32,
                        device=dev)
    assignp, auxp, sizes0, _ = segment_case(
        dev, rng.integers(0, 1500, n_w), [3000], k_w, kp_w, 0)
    outs = [run_segment(fn, (zw, auxp, assignp), n_w, sizes0, 0, ld_w, dev)
            for fn in (lazy_segment_stream, lazy_segment_stream_ref)]
    pairs += compare_segment(f"lazy_stream wide (n={n_w}, k_pad={kp_w})",
                             *outs, 3001, 3000, False)

    # The crafted sweeps at every slots-per-lane width, and at widths that
    # are not 32 x a power of two (masked slots in the last lane rows).
    for kp in (32, 64, 96, 128, 160, 256, 512, 992, 1024):
        pairs += crafted_check("lazy_stream", dev, kp, kp - 3, True)
    log("  lazy_stream crafted sweeps (as lazy_segment's) at k_pad 32 ... "
        "1,024 and 96, 160, 992 — kernel == twin")

    # Timing: the full no-birth segment, and the resident kernel on the same
    # Z read in cell order through a random permutation.
    assignp, auxp, sizes0, _ = cases["no_birth"][0]
    tgt = torch.empty((n,), dtype=torch.int32, device=dev)
    info = torch.empty((4,), dtype=torch.int32, device=dev)
    buf = iter([sizes0.clone() for _ in range(21)])
    ms = cuda_ms(lambda: lazy_segment_stream(zp, auxp, assignp, next(buf),
                                             tgt, info, 0, log_denom), 21)
    plain_ms = cuda_ms(lambda: lazy_segment_stream_ref(
        zp, auxp, assignp, sizes0.clone(), tgt, info, 0, log_denom), 1)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    buf = iter([sizes0.clone() for _ in range(21)])
    resident_ms = cuda_ms(lambda: lazy_segment(
        zp, auxp, assignp, perm, next(buf), tgt, info, 0, log_denom), 21)
    # The vecflow probe on the same Z and permutation: equal targets, sizes
    # and info to lazy_segment's, then its time.
    tgt_v = torch.empty((n_batches(n), BATCH), device=dev)
    info_v = torch.empty((1,), dtype=torch.int32, device=dev)
    sizes_l, sizes_v = sizes0.clone(), sizes0.clone()
    lazy_segment(zp, auxp, assignp, perm, sizes_l, tgt, info, 0, log_denom)
    vecflow(zp, auxp, assignp, perm, sizes_v, tgt_v, info_v, log_denom)
    if not (torch.equal(tgt_v.reshape(-1)[:n].to(torch.int32), tgt)
            and torch.equal(sizes_v, sizes_l)
            and int(info_v[0]) == int(info[0]) == n):
        raise AssertionError("vecflow != lazy_segment on the 131,072-cell Z")
    buf = iter([sizes0.clone() for _ in range(21)])
    vecflow_ms = cuda_ms(lambda: vecflow(zp, auxp, assignp, perm, next(buf),
                                         tgt_v, info_v, log_denom), 21)
    for i in range(2):  # twice more after the resident kernel: the spread
        buf = iter([sizes0.clone() for _ in range(21)])
        t = cuda_ms(lambda: lazy_segment_stream(zp, auxp, assignp, next(buf),
                                                tgt, info, 0, log_denom), 21)
        log(f"  lazy_stream full segment, repeat {i + 1}: {t:.4f} ms")
    # Every position: its zp row, aux and assign in, its target out; the
    # sizes row in and out.
    bound_ms, bound_by = bound(4 * (n * k_pad + 3 * n + 2 * k_pad + 4),
                               OPS_PER_SLOT * n * k_pad)
    log(f"  lazy_stream full segment (n={n}, k_pad={k_pad}, Z "
        f"{4 * n * k_pad / 1e6:.1f} MB): kernel {ms:.4f} ms, plain twin "
        f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"lazy_segment on the same Z in cell order {resident_ms:.4f} ms, "
        f"vecflow there {vecflow_ms:.4f} ms (targets equal; vecflow / "
        f"lazy_segment {vecflow_ms / resident_ms:.4f})")
    return {"max_abs_err": max_err(pairs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "resident_same_z_ms": resident_ms, "vecflow_same_z_ms": vecflow_ms}


def eager_crafted_check(dev, k_pad):
    """Kernel == twin on a 300-cell sweep at row width k_pad with births
    forced 1, 3 and 8 positions apart (inside and at the edge of the reach
    of the kernel's 8-row ring), at the first and the last position; the
    two lowest free slots are 3 and 5, the others lie in the last lane row
    that holds real slots. Every newborn column of lf is large, so the
    cells after a birth follow it only if the row they read holds the
    patch. Returns the compared pairs."""
    import torch

    from bnpc_tpu_torch.ops.cuda_sweep import eager_sweep, eager_sweep_ref

    n, m, k_max = 300, 7, k_pad - 3
    births = [0, 1, 4, 12, 150, 151, 299]
    free = [3, 5] + list(range(k_max - 5, k_max))
    rng = np.random.default_rng(k_pad)
    z = (rng.standard_normal((n, k_pad)) * 3.0).astype(np.float32)
    gum = rng.gumbel(size=(n, k_pad)).astype(np.float32)
    lf = (rng.standard_normal((n, n)) * 3.0).astype(np.float32)
    fresh = rng.uniform(1e-5, 1 - 1e-5, (n, m)).astype(np.float32)
    params = rng.uniform(1e-5, 1 - 1e-5, (k_max, m)).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    assign = rng.choice([0, 1, 2, 4, 6, 7], n).astype(np.int32)
    sizes = np.full(k_pad, 2.0, np.float32)  # phantom cells elsewhere
    sizes[:8] = np.bincount(assign, minlength=8) + 2.0
    sizes[free] = 0.0
    sizes[k_max:] = -1.0
    aux = np.full(n, -1e30, np.float32)
    aux[perm[births]] = 1e30
    lf[:, perm[births]] = 30.0
    args = [torch.from_numpy(x).to(dev)
            for x in (z, gum, lf, fresh, aux, assign, perm, sizes, params)]
    args.append(torch.tensor(np.log(n - 1.0 + 10.0), dtype=torch.float32,
                             device=dev))
    (ka, ks, kp), (ra, rs, rp) = eager_sweep(*args), eager_sweep_ref(*args)
    torch.cuda.synchronize()
    if not (torch.equal(ka, ra) and torch.equal(ks, rs)
            and torch.equal(kp, rp)):
        raise AssertionError(f"eager_sweep crafted k_pad={k_pad}: kernel != "
                             "twin")
    born = ka[args[6][births].long()].tolist()
    if born != free:
        raise AssertionError(f"eager_sweep crafted k_pad={k_pad}: births "
                             f"into {born}, expected {free}")
    return [(ka, ra), (ks, rs), (kp, rp)]


def phase_eager_sweep(dev):
    import torch

    from bnpc_tpu_torch.ops.cuda_gibbs import stream_k_pad
    from bnpc_tpu_torch.ops.cuda_sweep import eager_sweep, eager_sweep_ref

    k_pad = stream_k_pad(K_MAX)
    rng = np.random.default_rng(3)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    z = t((rng.standard_normal((N, k_pad)) * 4.0).astype(np.float32))
    gum = t(rng.gumbel(size=(N, k_pad)).astype(np.float32))
    lf_np = (rng.standard_normal((N, N)) * 4.0).astype(np.float32)
    fresh = t(rng.uniform(1e-5, 1 - 1e-5, (N, M)).astype(np.float32))
    params = t(rng.uniform(1e-5, 1 - 1e-5, (K_MAX, M)).astype(np.float32))
    perm_h = rng.permutation(N).astype(np.int32)
    perm = t(perm_h)
    log_denom = torch.tensor(np.log(N - 1.0 + 10.0), dtype=torch.float32,
                             device=dev)
    # Two births back to back at positions 2600 and 2601; both newborn
    # columns are large, so every later cell, the one visited right after
    # each birth included, follows them only if it sees the patch.
    lf_births = lf_np.copy()
    lf_births[:, perm_h[[2600, 2601]]] = 30.0
    lf, lf_b = t(lf_np), t(lf_births)
    cases = {
        "no_birth": (segment_case(dev, rng.integers(0, 200, N), [], K_MAX,
                                  k_pad, 0), lf, 0),
        "two_births": (segment_case(dev, rng.integers(0, 200, N),
                                    perm_h[[2600, 2601]], K_MAX, k_pad, 0),
                       lf_b, 2),
        "veto": (segment_case(dev, np.arange(N) % K_MAX, perm_h[:5], K_MAX,
                              k_pad, 0), lf, 0),
    }
    pairs = []
    for name, ((assign, aux, sizes0, _), lf_c, births) in cases.items():
        args = (z, gum, lf_c, fresh, aux, assign, perm, sizes0, params,
                log_denom)
        (ka, ks, kp), (ra, rs, rp) = eager_sweep(*args), eager_sweep_ref(*args)
        torch.cuda.synchronize()
        if not (torch.equal(ka, ra) and torch.equal(ks, rs)
                and torch.equal(kp, rp)):
            raise AssertionError(f"eager_sweep {name}: kernel != twin")
        born = int(((sizes0 == 0) & (ks > 0)).sum())
        changed = int((kp != params).any(dim=1).sum())
        if changed != births:
            raise AssertionError(f"eager_sweep {name}: {changed} newborn "
                                 f"rows, expected {births}")
        if births:
            slots = ka[perm[2600:2603].long()].tolist()
            log(f"  eager_sweep {name}: slots of positions 2600-2602 "
                f"{slots}; {born} slots born")
            if slots[0] == slots[1] or slots[2] not in slots[:2]:
                raise AssertionError(f"eager_sweep {name}: slots {slots}")
        pairs += [(ka, ra), (ks, rs), (kp, rp)]
        log(f"  eager_sweep {name}: {int((ks > 0).sum())} live slots — "
            "kernel == twin")

    for kp in (96, 160, 256, 992):
        pairs += eager_crafted_check(dev, kp)
    log("  eager_sweep crafted sweeps (births 1, 3 and 8 positions apart, "
        "at the first and the last position, into slots 3 and 5 and the "
        "last lane row) at k_pad 96, 160, 256, 992 — kernel == twin")

    (assign, aux, sizes0, _), lf_c, _ = cases["two_births"]
    args = (z, gum, lf_c, fresh, aux, assign, perm, sizes0, params, log_denom)
    births_ms = cuda_ms(lambda: eager_sweep(*args), 21)
    (assign, aux, sizes0, _), _, _ = cases["no_birth"]
    args = (z, gum, lf, fresh, aux, assign, perm, sizes0, params, log_denom)
    ms = cuda_ms(lambda: eager_sweep(*args), 21)
    plain_ms = cuda_ms(lambda: eager_sweep_ref(*args), 3)
    # No birth: every z row, aux, assign and perm entry in, the assignment
    # out; the sizes row and the params in and out (lf, gum and fresh are
    # read only on a birth).
    bound_ms, bound_by = bound(
        4 * (N * k_pad + 4 * N + 2 * k_pad + 2 * K_MAX * M),
        OPS_PER_SLOT * N * k_pad)
    log(f"  eager_sweep no birth (n={N}, k_pad={k_pad}): kernel {ms:.4f} ms,"
        f" plain twin {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); the sweep with two births {births_ms:.4f} ms")
    return {"max_abs_err": max_err(pairs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "two_births_ms": births_ms}


def phase_vecflow(dev, smi):
    import torch

    from bnpc_tpu_torch.ops.cuda_gibbs import lazy_segment
    from bnpc_tpu_torch.probes.vecflow_probe import (BATCH, CRAFTED, K_PAD,
                                                     crafted_inputs,
                                                     make_inputs, n_batches,
                                                     vecflow, vecflow_ref)

    def case(n, hot=(), free=True):
        """The probe's input at n cells; aux +1e30 at the `hot` positions;
        slots 20-23 free (size 0) unless `free` is False."""
        z, aux, assign, perm, sizes, log_denom = make_inputs(n, K_PAD, dev)
        aux[perm[list(hot)].long()] = 1e30
        if free:
            sizes[20:24] = 0.0
        return (z, aux, assign, perm), sizes, log_denom

    def run(fn, args, sizes0, log_denom):
        n = args[3].shape[0]
        sizes = sizes0.clone()
        tgt = torch.full((n_batches(n), BATCH), -7.0, device=dev)
        info = torch.zeros((1,), dtype=torch.int32, device=dev)
        fn(*args, sizes, tgt, info, log_denom)
        torch.cuda.synchronize()
        return tgt, sizes, info

    cases = {
        # 12 live slots, aux -inf: the probe's main() input.
        "no_birth": (case(N, free=False), N),
        # A birth at position 2,600 (batch 20, position 40): the batch runs
        # on, its later cells seeing the newborn, and the sweep ends there.
        "birth_mid_batch": (case(N, hot=[2600]), 2600),
        # The new-cluster option wins for 5 cells with no free slot: no
        # birth (the probe has no veto output), the argmax instead.
        "no_free_slot": (case(N, hot=range(5), free=False), N),
        # z rows padded to 5,000; 121 inert tail positions in the last batch.
        "ragged": (case(N - 7), N - 7),
    }
    pairs = []
    for name, ((args, sizes0, log_denom), want) in cases.items():
        (kt, ks, ki), (rt, rs, ri) = [run(fn, args, sizes0, log_denom)
                                      for fn in (vecflow, vecflow_ref)]
        if not (torch.equal(kt, rt) and torch.equal(ks, rs)
                and torch.equal(ki, ri)) or int(ki[0]) != want:
            raise AssertionError(f"vecflow {name}: kernel info {ki.tolist()}"
                                 f" twin {ri.tolist()}, targets or sizes "
                                 "differ")
        rows = int((kt[:, 0] != -7.0).sum())
        pairs += [(kt, rt), (ks, rs), (ki, ri)]
        log(f"  vecflow {name} (n={args[3].shape[0]}, k_pad={K_PAD}): info "
            f"{ki.tolist()}, {rows} batches written — kernel == twin")

    # The crafted cases of vecflow_probe.CRAFTED (n a multiple of 128, n 1,
    # n < kRing, a birth at 0, in the last full batch, in the ragged batch,
    # two in one batch) at every slots-per-lane width.
    for name in CRAFTED:
        for kp in (32, 64, 128, 256, 512, 1024):
            *arrays, want = crafted_inputs(name, kp)
            z, aux, assign, perm, sizes0, ld = (torch.from_numpy(
                np.asarray(x)).to(dev) for x in arrays)
            (kt, ks, ki), (rt, rs, ri) = [run(fn, (z, aux, assign, perm),
                                              sizes0, ld)
                                          for fn in (vecflow, vecflow_ref)]
            if not (torch.equal(kt, rt) and torch.equal(ks, rs)
                    and torch.equal(ki, ri)) or int(ki[0]) != want:
                raise AssertionError(f"vecflow crafted {name} k_pad {kp}: "
                                     f"kernel info {ki.tolist()} twin "
                                     f"{ri.tolist()}, targets or sizes "
                                     "differ")
            pairs += [(kt, rt), (ks, rs), (ki, ri)]
    log(f"  vecflow crafted cases ({', '.join(CRAFTED)}) at k_pad 32 ... "
        "1,024 — kernel == twin")

    (args, sizes0, log_denom), _ = cases["no_birth"]
    tgt = torch.empty((n_batches(N), BATCH), device=dev)
    info = torch.empty((1,), dtype=torch.int32, device=dev)
    buf = iter([sizes0.clone() for _ in range(21)])
    ms = cuda_ms(lambda: vecflow(*args, next(buf), tgt, info, log_denom), 21)
    plain_ms = cuda_ms(lambda: vecflow_ref(*args, sizes0.clone(), tgt, info,
                                           log_denom), 3)
    # Kernel 1 on the same input, in turns with the probe: the probe differs
    # from it only in its batched target stores and birth test.
    z, aux, assign, perm = args
    tgt_l = torch.empty((N,), dtype=torch.int32, device=dev)
    info_l = torch.empty((4,), dtype=torch.int32, device=dev)
    turns = []
    for fn in ("lazy_segment", "vecflow", "lazy_segment"):
        buf = iter([sizes0.clone() for _ in range(21)])
        turns.append(cuda_ms(
            (lambda: lazy_segment(z[:N], aux, assign, perm, next(buf), tgt_l,
                                  info_l, 0, log_denom))
            if fn == "lazy_segment" else
            (lambda: vecflow(*args, next(buf), tgt, info, log_denom)), 21))
    lazy_ms = (turns[0] + turns[2]) / 2
    # Every cell: its z row, aux, assign and perm entries in; the sizes row
    # in and out; the [nb, 128] targets and info out. Every cell takes the
    # per-slot step; the inert tail positions share one argmax (the sizes
    # do not change there).
    steps = N + (N % BATCH != 0)
    bound_ms, bound_by = bound(
        4 * (N * K_PAD + 3 * N + 2 * K_PAD + n_batches(N) * BATCH + 1),
        OPS_PER_SLOT * steps * K_PAD)
    log(f"  vecflow full sweep (n={N}, k_pad={K_PAD}): kernel {ms:.4f} ms, "
        f"plain twin {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    log(f"  vecflow beside lazy_segment on the same input, in turns "
        f"(lazy, vecflow, lazy): {turns[0]:.4f} / {turns[1]:.4f} / "
        f"{turns[2]:.4f} ms; vecflow / lazy_segment {ms:.4f} / {lazy_ms:.4f}"
        f" = {ms / lazy_ms:.4f}, {turns[1]:.4f} / {lazy_ms:.4f} = "
        f"{turns[1] / lazy_ms:.4f} ({smi})")
    return {"max_abs_err": max_err(pairs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "lazy_segment_same_input_ms": lazy_ms,
            "turns_ms": turns}


def phase_while_exit(dev, smi):
    import torch

    from bnpc_tpu_torch.ops.cuda_gibbs import lazy_segment
    from bnpc_tpu_torch.probes.while_probe import (CRAFTED, K_PAD, N,
                                                   crafted_inputs,
                                                   make_inputs, while_exit,
                                                   while_exit_ref)

    z, perm, sizes_fin = make_inputs(N, K_PAD, dev)
    perm_h = perm.cpu().numpy()

    def birth_case(i0, pos):
        """Finite sizes with slot 0 empty, and z[perm[pos], 0] large: the
        first birth is at position `pos`, into slot 0."""
        zb = z.clone()
        zb[int(perm_h[pos]), 0] = 50.0
        sizes = sizes_fin.clone()
        sizes[0] = 0.0
        return zb, sizes, i0, [pos + 1, int(perm_h[pos]), -1, -1]

    cases = {
        # The TPU probe verbatim: its sizes output unwritten (NaN).
        "verbatim": (z, torch.full((K_PAD,), float("nan"), device=dev), 0,
                     [N, -1, -1, -1]),
        "birth": birth_case(0, 100),
        "late_i0": birth_case(200, 350),
    }
    pairs = []
    for name, (zc, sizes0, i0, want) in cases.items():
        outs = []
        for fn in (while_exit, while_exit_ref):
            sizes = sizes0.clone()
            out = torch.full((N,), -7, dtype=torch.int32, device=dev)
            info = torch.zeros((4,), dtype=torch.int32, device=dev)
            fn(zc, perm, sizes, out, info, i0)
            torch.cuda.synchronize()
            outs.append((out, sizes, info))
        (ko, ks, ki), (ro, rs, ri) = outs
        if not (torch.equal(ko, ro) and torch.equal(ki, ri)) \
                or ki.tolist() != want:
            raise AssertionError(f"while_exit {name}: kernel info "
                                 f"{ki.tolist()} twin {ri.tolist()}, "
                                 f"expected {want}, or targets differ")
        torch.testing.assert_close(ks, rs, rtol=0, atol=0, equal_nan=True)
        pairs += [(ko, ro), (ki, ri)]
        log(f"  while_exit {name} (n={N}, k_pad={K_PAD}, from {i0}): info "
            f"{ki.tolist()} — kernel == twin")

    # The crafted cases of while_probe.CRAFTED (NaN sizes, a NaN in one
    # slot, NaNs of both signs and several payloads, -0.0 / +0.0, every
    # logit -inf, sizes -1, births at i0 and at n - 1) at every
    # slots-per-lane width: targets and info equal, sizes bit for bit (NaN
    # for NaN).
    n_c = 128
    for name in CRAFTED:
        for kp in (32, 64, 128, 256, 512, 1024):
            zc_np, perm_np, sizes_np, i0, want = crafted_inputs(name, n_c, kp)
            zc, permc, sizes0 = (torch.from_numpy(x).to(dev)
                                 for x in (zc_np, perm_np, sizes_np))
            outs = []
            for fn in (while_exit, while_exit_ref):
                sizes = sizes0.clone()
                out = torch.full((n_c,), -7, dtype=torch.int32, device=dev)
                info = torch.zeros((4,), dtype=torch.int32, device=dev)
                fn(zc, permc, sizes, out, info, i0)
                torch.cuda.synchronize()
                outs.append((out, sizes, info))
            (ko, ks, ki), (ro, rs, ri) = outs
            nan = torch.isnan(rs)
            same_sizes = (torch.equal(torch.isnan(ks), nan) and torch.equal(
                ks[~nan].view(torch.int32), rs[~nan].view(torch.int32)))
            if not (torch.equal(ko, ro) and torch.equal(ki, ri)
                    and same_sizes) or (want is not None
                                        and ki.tolist()[:2] != want):
                raise AssertionError(f"while_exit crafted {name} k_pad {kp}:"
                                     f" kernel info {ki.tolist()} twin "
                                     f"{ri.tolist()}, expected {want}, or "
                                     "targets or sizes differ")
            pairs += [(ko, ro), (ki, ri)]
    log(f"  while_exit crafted cases ({', '.join(CRAFTED)}; n={n_c}) at "
        "k_pad 32 ... 1,024 — kernel == twin, sizes bit for bit")

    out = torch.empty((N,), dtype=torch.int32, device=dev)
    info = torch.empty((4,), dtype=torch.int32, device=dev)
    buf = iter([sizes_fin.clone() for _ in range(21)])
    ms = cuda_ms(lambda: while_exit(z, perm, next(buf), out, info, 0), 21)
    plain_ms = cuda_ms(lambda: while_exit_ref(z, perm, sizes_fin.clone(), out,
                                              info, 0), 3)
    # Kernel 1 on the same z, perm and sizes with no birth (aux -inf), in
    # turns with the probe, as the probe's main() times it.
    assign = (torch.arange(N, device=dev) % 12).to(torch.int32)
    aux = torch.full((N,), -float("inf"), device=dev)
    ld0 = torch.zeros((), device=dev)
    tgt_l = torch.empty((N,), dtype=torch.int32, device=dev)
    info_l = torch.empty((4,), dtype=torch.int32, device=dev)
    turns = []
    for fn in ("lazy_segment", "while_exit", "lazy_segment"):
        buf = iter([sizes_fin.clone() for _ in range(21)])
        turns.append(cuda_ms(
            (lambda: lazy_segment(z, aux, assign, perm, next(buf), tgt_l,
                                  info_l, 0, ld0))
            if fn == "lazy_segment" else
            (lambda: while_exit(z, perm, next(buf), out, info, 0)), 21))
    lazy_ms = (turns[0] + turns[2]) / 2
    # No birth, from 0: every cell's z row and perm entry in, its target
    # out; the sizes row in and out; five float operations per slot.
    bound_ms, bound_by = bound(4 * (N * K_PAD + 2 * N + 2 * K_PAD + 4),
                               5 * N * K_PAD)
    log(f"  while_exit full no-birth run (n={N}, k_pad={K_PAD}): kernel "
        f"{ms:.4f} ms, plain twin {plain_ms:.1f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by})")
    log(f"  while_exit beside lazy_segment on the same z and perm, in turns "
        f"(lazy, while, lazy): {turns[0]:.4f} / {turns[1]:.4f} / "
        f"{turns[2]:.4f} ms; while_exit / lazy_segment {ms:.4f} / "
        f"{lazy_ms:.4f} = {ms / lazy_ms:.4f}, {turns[1]:.4f} / {lazy_ms:.4f}"
        f" = {turns[1] / lazy_ms:.4f} ({smi})")
    return {"max_abs_err": max_err(pairs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "lazy_segment_same_input_ms": lazy_ms, "turns_ms": turns}


# ---------------------------------------------------------------------------
# Phase 3, kernel 7: the fused MH sweep against the torch composition
# ---------------------------------------------------------------------------

# The MH sweep's callers' row shapes: update_parameters (k_max rows), a
# split launch pair, a merge row, and a batch of 3 chains of k_max rows.
MH_SHAPES = (("update_parameters", (K_MAX, M), 0), ("split", (2, M), 0),
             ("merge", (M,), 0), ("batch3", (3, K_MAX, M), 3))
MH_SEEDS = (2147483901, 3100000007, 17)


def mh_rows(shape, chains, seed, dev):
    """Parameter rows as the bench's Beta(0.25, 0.25) prior leaves them
    (many near TMIN / TMAX), member counts up to 5,000 cells, and one
    chain's (0-d) or `chains` chains' ([C]) error rates."""
    import torch

    from bnpc_tpu_torch.config import TMAX, TMIN

    rng = np.random.default_rng(seed % 2**32)
    params = np.clip(rng.beta(0.25, 0.25, shape), TMIN, TMAX)
    n1 = rng.integers(0, 300, shape)
    n0 = rng.integers(0, 5000, shape)
    rates = (chains,) if chains else ()
    fp = rng.uniform(0.001, 0.02, rates)
    fn = rng.uniform(0.1, 0.3, rates)
    return [torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
            for x in (params, n1, n0, fp, fn)]


def mh_primitives(seed, shape, dev):
    """The sweep's three primitives in the composition's order."""
    d = TorchDraws(seed, dev)
    return (d.randint(shape, 0, 3), d.uniform(shape), d.uniform(shape))


def mh_sums_close(tag, got, want, m):
    """Per-row sums of same-signed terms (each <= 0) added in two orders:
    each within (m - 1) float32 roundings of the exact sum, so within
    2 m 2^-24 of each other relative to it. Returns the largest relative
    gap."""
    import torch

    rtol = 2 * m * 2.0**-24
    gap = ((got.double() - want.double()).abs()
           / want.double().abs().clamp(min=1e-30))
    worst = float(gap.max()) if gap.numel() else 0.0
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)) \
            or worst > rtol:
        raise AssertionError(f"{tag}: row sums {worst:.3g} apart "
                             f"(limit {rtol:.3g})")
    return worst


def mh_case(dev, shape, chains, seed, cfg, trans, mask):
    """ops/mh.py on TorchDraws(seed) (the kernel, on the card) against the
    composition on the same generator state's primitives (mh.sweep_on):
    new params and declined counts bit for bit, the generator left in the
    same state, row sums as above. Returns (largest row-sum gap, largest
    |got - want| of the new params)."""
    import torch

    from bnpc_tpu_torch.ops import mh
    from bnpc_tpu_torch.parallel.axis import MutAxis

    params, n1, n0, fp, fn = mh_rows(shape, chains, seed, dev)
    ax = MutAxis(mask=mask)
    d = TorchDraws(seed, dev)
    got = mh.mh_cluster_params(d, params, n1, n0, fp, fn, cfg, trans, ax)
    ref = TorchDraws(seed, dev)
    idx, u_prop, u = (ref.randint(shape, 0, 3), ref.uniform(shape),
                      ref.uniform(shape))
    want = mh.sweep_on(params, n1, n0, fp, fn, idx, u_prop, u, cfg, trans,
                       ax)
    err = float((got.params - want.params).abs().max())
    tag = f"mh_sweep {tuple(shape)} trans {trans} seed {seed}"
    if not torch.equal(d.gen.get_state(), ref.gen.get_state()):
        raise AssertionError(f"{tag}: the generator moved otherwise")
    diff = got.params != want.params
    if diff.any():
        ulps = (got.params.view(torch.int32)
                - want.params.view(torch.int32)).abs()[diff]
        flags = (got.params == params) != (want.params == params)
        raise AssertionError(f"{tag}: {int(diff.sum())} new params differ "
                             f"(up to {int(ulps.max())} ulps); declined "
                             f"flags differ at {int(flags.sum())}")
    if not torch.equal(got.declined, want.declined):
        raise AssertionError(f"{tag}: declined counts differ")
    gap = mh_sums_close(tag, got.trans_logprob, want.trans_logprob,
                        shape[-1]) if trans else 0.0
    if not trans and bool(got.trans_logprob.any()):
        raise AssertionError(f"{tag}: a transition sum without trans_prob")
    return gap, err


def mh_realized_case(dev, shape, chains, seed, cfg, mask):
    """The realized mode against the composition (row sums), and a sweep
    that accepts every coordinate against the realized mode on its move,
    bit for bit (the two modes share the log-acceptance and the sums)."""
    import torch

    from bnpc_tpu_torch.config import TMAX, TMIN
    from bnpc_tpu_torch.ops import cuda_mh, mh
    from bnpc_tpu_torch.parallel.axis import MutAxis

    params, n1, n0, fp, fn = mh_rows(shape, chains, seed, dev)
    idx, u_prop, _ = mh_primitives(seed, shape, dev)
    std = mh.choose(idx, mh.PARAM_PROPOSAL_SD)
    a, b = (0.0 - params) / std, (1.0 - params) / std
    target = mh_rows(shape, chains, seed + 1, dev)[0]
    got = cuda_mh.realized(target, params, n1, n0, a, b, std, fp, fn, cfg,
                           mask)
    want = mh.realized_sum(target, params, n1, n0, a, b, std, fp, fn, cfg,
                           MutAxis(mask=mask))
    gap = mh_sums_close(f"mh_realized {tuple(shape)} seed {seed}", got, want,
                        shape[-1])
    new, trans, declined = cuda_mh.mh_sweep(
        params, n1, n0, fp, fn, idx, u_prop, torch.zeros_like(params), cfg,
        True, mask)
    a, b = (TMIN - params) / std, (TMAX - params) / std
    again = cuda_mh.realized(new, params, n1, n0, a, b, std, fp, fn, cfg,
                             mask)
    if int(declined.sum()) or not torch.equal(again, trans):
        raise AssertionError(f"mh_realized {tuple(shape)} seed {seed}: the "
                             "accepted sweep's sums differ from the "
                             "realized mode's")
    return gap


def mh_batch_case(dev, seed, cfg):
    """A batch of 3 chains in one launch == 3 one-chain launches on each
    chain's slice, bit for bit (the row sums' order depends on m alone)."""
    import torch

    from bnpc_tpu_torch.ops import cuda_mh

    shape = (3, K_MAX, M)
    params, n1, n0, fp, fn = mh_rows(shape, 3, seed, dev)
    prims = mh_primitives(seed, shape, dev)
    batch = cuda_mh.mh_sweep(params, n1, n0, fp, fn, *prims, cfg, True)
    for c in range(3):
        one = cuda_mh.mh_sweep(params[c], n1[c], n0[c], fp[c], fn[c],
                               *(p[c] for p in prims), cfg, True)
        for f, g, w in zip(("params", "trans", "declined"), batch, one):
            if not torch.equal(g[c], w):
                raise AssertionError(f"mh_sweep batch seed {seed}: chain "
                                     f"{c}'s {f} differs from its "
                                     "one-chain launch")


def mh_graph_ms(fn, calls, reps=20):
    """Milliseconds a call of fn() inside a CUDA graph that holds `calls`
    calls back to back (median over `reps` replays)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps) / calls


def mh_kernels_per_call(fn):
    """Device kernels of one eager fn() call (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def mh_captured(dev, mod=None):
    """The runner's captured block against its eager block at a small
    cell, two 32-step windows from one state: bit for bit, and the launches
    of kernel wrapper `mod` (default the MH sweep's) counted alike (replays
    add what the capture took, graphs.COUNTED; the block's row set-up
    apart, SetupLaunches), and not zero. Returns launches a step."""
    import functools

    import torch

    from bnpc_tpu_torch import mcmc
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.ops import cuda_mh

    mod = mod or cuda_mh
    n, steps = 1000, 32
    data, _ = make_data(n, M, 5, 0.1, seed=1)
    cfg, mc = bench_configs(n, 64)
    runner = mcmc.MCMCRunner(cfg, mc, pack_data(data, dev), device=dev,
                             block_size=steps)
    forms = {"eager": functools.partial(mcmc._chain_block,
                                        runner._block.step),
             "captured": runner.run_block}
    state = runner.init_chains(TorchDraws(0, dev))[0]
    draws = TorchDraws(1, dev)
    name = next(k for k, v in kernel_modules().items() if v is mod)
    per_step = []
    for w in range(2):
        gen, out, count = draws.gen.get_state(), {}, {}
        for form, fn in forms.items():
            d = TorchDraws(1, dev)
            d.gen.set_state(gen)
            before = mod.launches
            with SetupLaunches() as setup:
                out[form] = fn(state, d, steps)
                torch.cuda.synchronize()
            count[form] = mod.launches - before - setup.take()[name]
        tag = f"{mod.__name__} captured window {w}"
        same_block(tag, out["captured"], out["eager"])
        if count["captured"] != count["eager"] or not count["eager"]:
            raise AssertionError(f"{tag}: launches {count}")
        per_step.append(count["eager"] / steps)
        state, draws = out["captured"][0], out["captured"][2]
    return per_step


def phase_mh_sweep(dev, smi):
    """Kernel 7 (csrc/mh_sweep.cu) against the torch composition it
    replaces, on the card: new params and declined counts bit for bit at
    the four caller shapes, trans_prob off and on, the bench's Beta(0.25,
    0.25) prior, a uniform prior and a padded column mask; row sums within
    their summation-order limit; the realized mode; a batch against its
    one-chain launches; the runner's captured block against its eager one;
    then the kernel's time a call inside a CUDA graph against its bytes
    bound and against the composition's."""
    import dataclasses

    import torch

    from bnpc_tpu_torch.ops import cuda_mh, mh

    cfg, _ = bench_configs()
    uniform = dataclasses.replace(cfg, p=1.0, q=1.0)
    mask = torch.ones(M, device=dev)
    mask[-3:] = 0.0
    cases = [(shape, chains, seed, cfg, trans, None)
             for _, shape, chains in MH_SHAPES for seed in MH_SEEDS
             for trans in (False, True)]
    cases += [(shape, chains, 5, uniform, True, None)
              for _, shape, chains in MH_SHAPES]
    cases += [(shape, 0, 9, cfg, trans, mask)
              for shape in ((K_MAX, M), (2, M)) for trans in (False, True)]
    gaps, errs = zip(*(mh_case(dev, *case) for case in cases))
    worst, max_abs_err = max(gaps), max(errs)
    for shape, chains in (((M,), 0), ((2, M), 0), ((3, M), 3)):
        for seed in MH_SEEDS:
            worst = max(worst, mh_realized_case(dev, shape, chains, seed,
                                                cfg, None))
        worst = max(worst, mh_realized_case(dev, shape, chains, 13, cfg,
                                            mask))
    for seed in MH_SEEDS:
        mh_batch_case(dev, seed, cfg)
    log(f"  mh_sweep == the torch composition: new params and declined "
        f"counts bit for bit at {[s for _, s, _ in MH_SHAPES]}, "
        f"{len(MH_SEEDS)} seeds, trans_prob off / on, Beta(0.25, 0.25) and "
        f"uniform priors, a padded mask; realized mode; row sums within "
        f"2 m 2^-24 (largest gap {worst:.3g}); a batch of 3 == its "
        "one-chain launches bit for bit")
    launches_per_step = mh_captured(dev)
    log(f"  mh_sweep in the captured block: == eager bit for bit, "
        f"{launches_per_step} launches a step counted under replay")

    timing = {}
    for name, shape, chains in MH_SHAPES:
        params, n1, n0, fp, fn = mh_rows(shape, chains, 1, dev)
        prims = mh_primitives(1, shape, dev)

        def kernel():
            cuda_mh.mh_sweep(params, n1, n0, fp, fn, *prims, cfg, True)

        def composed():
            mh.sweep_on(params, n1, n0, fp, fn, *prims, cfg, True)

        rows = params.numel() // M
        moved = params.numel() * 7 * 4 + rows * 8
        timing[name] = {
            "kernel_graph_ms": mh_graph_ms(kernel, 50),
            "kernel_eager_ms": cuda_ms(kernel, 200),
            "composition_graph_ms": mh_graph_ms(composed, 1),
            "composition_eager_ms": cuda_ms(composed, 50),
            "composition_kernels": mh_kernels_per_call(composed),
            "bytes_bound_ms": moved / HBM_BYTES_PER_S * 1e3}
        log(f"  mh_sweep {name} {tuple(shape)} ({smi}): "
            + ", ".join(f"{k} {v:.5g}" for k, v in timing[name].items()))
    main = timing["update_parameters"]
    return {"max_abs_err": max_abs_err, "row_sum_rel_gap": worst,
            "launches_per_step": launches_per_step, "timing": timing,
            "ms": main["kernel_graph_ms"],
            "plain_ms": main["composition_graph_ms"],
            "bound_ms": main["bytes_bound_ms"], "bound_by": "bytes"}


# Kernel 8's crafted rows (row names; beta_crafted builds them).
BETA_CRAFTED = ("v_nonpositive", "all_reject", "first_round", "third_round",
                "u_zero", "no_counts", "clamp_low", "clamp_high",
                "zero_denominator", "large_counts")
BETA_SEEDS = (2147483659, 3000000019, 23)


def beta_crafted(dev, m=8, seed=0):
    """Rows of counts and primitives that reach each branch of the Beta
    sampler, one row a name of BETA_CRAFTED: every round rejecting through
    v <= 0 (normals of -10) or through a high uniform with v > 0 (normals
    of 3, uniforms 0.99), gamma a's first or third round accepting and
    later ones accepting too (first accept wins), uniforms of 0 (log -inf),
    no counts, a zero boost uniform in gamma a (clamped to TMIN), in gamma
    b (to TMAX) and in both (0 / 0: 0.5), and large counts. Returns (n1,
    n0 [R, m], the 26 primitives [R, m] each, the names)."""
    import torch

    from bnpc_tpu_torch.ops.randomx import BETA_PRIMITIVES, GAMMA_PRIMITIVES

    g = torch.Generator().manual_seed(seed)
    rows = len(BETA_CRAFTED)
    n1 = torch.randint(0, 40, (rows, m), generator=g).to(torch.float32)
    n0 = torch.randint(0, 400, (rows, m), generator=g).to(torch.float32)
    boost = GAMMA_PRIMITIVES - 1
    prims = []
    for t in range(BETA_PRIMITIVES):
        # A gamma's even draws before its boost are normals, the rest
        # uniforms.
        i = t % GAMMA_PRIMITIVES
        draw = torch.randn if i < boost and i % 2 == 0 else torch.rand
        prims.append(draw((rows, m), generator=g))
    row = {name: r for r, name in enumerate(BETA_CRAFTED)}

    def rounds(r, xs, us, gamma=0):
        for i, (x, u) in enumerate(zip(xs, us)):
            prims[gamma * GAMMA_PRIMITIVES + 2 * i][r] = x
            prims[gamma * GAMMA_PRIMITIVES + 2 * i + 1][r] = u

    for name in ("v_nonpositive", "all_reject", "first_round",
                 "third_round"):
        n1[row[name]], n0[row[name]] = 3.0, 1.0
    for gamma in (0, 1):
        rounds(row["v_nonpositive"], [-10.0] * 6, [0.5] * 6, gamma)
        rounds(row["all_reject"], [3.0] * 6, [0.99] * 6, gamma)
        rounds(row["u_zero"], [0.1] * 6, [0.0] * 6, gamma)
    rounds(row["first_round"], [0.5] + [1.0] * 5, [0.01] * 6)
    rounds(row["third_round"], [-10.0, -10.0, 0.5, 1.0, 1.0, 1.0],
           [0.01] * 6)
    n1[row["no_counts"]], n0[row["no_counts"]] = 0.0, 0.0
    n1[row["large_counts"]], n0[row["large_counts"]] = 4000.0, 1000.0
    prims[boost][row["clamp_low"]] = 0.0
    prims[GAMMA_PRIMITIVES + boost][row["clamp_high"]] = 0.0
    prims[boost][row["zero_denominator"]] = 0.0
    prims[GAMMA_PRIMITIVES + boost][row["zero_denominator"]] = 0.0
    return (n1.to(dev), n0.to(dev), [p.to(dev) for p in prims],
            list(BETA_CRAFTED))


def beta_composed(seed, cfg, n1, n0, dev):
    """state.py::beta_posterior_params' torch composition (randomx.
    beta_general, then the clamp) on TorchDraws(seed) for each group g of
    the [..., G, m] counts in turn, on the card: (rows [..., G, m], the
    generator's state)."""
    import torch

    from bnpc_tpu_torch.config import TMAX, TMIN
    from bnpc_tpu_torch.ops import randomx

    d = TorchDraws(seed, dev)
    rows = [torch.clamp(randomx.beta_general(d, cfg.p + n1[..., g, :],
                                             cfg.q + n0[..., g, :]),
                        TMIN, TMAX) for g in range(n1.shape[-2])]
    return torch.stack(rows, dim=-2), d.gen.get_state()


def beta_case(dev, shape, seed, cfg):
    """Kernel 8 through state.beta_posterior_rows on TorchDraws(seed) (a
    group a row of the [G, m] counts, `shape` = (G, m), or a [K_MAX, 1, m]
    block of one group as init_state draws it) against the composition on
    the same seed, run on the card, and against the twin on the wrapper's
    own primitives: bit for bit, the generator left in the same state.
    Returns the largest |kernel - composition|."""
    import torch

    from bnpc_tpu_torch import state as st
    from bnpc_tpu_torch.ops import cuda_beta

    n1, n0 = mh_rows(shape, 0, seed, dev)[1:3]
    groups = shape[-2]
    want, gen = beta_composed(seed, cfg, n1, n0, dev)
    d = TorchDraws(seed, dev)
    before = cuda_beta.launches
    got = st.beta_posterior_rows((d,) * groups, cfg, n1, n0)
    tag = f"beta_post {tuple(shape)} seed {seed}"
    if cuda_beta.launches != before + 1:
        raise AssertionError(f"{tag}: {cuda_beta.launches - before} "
                             "launches, not one")
    if not torch.equal(d.gen.get_state(), gen):
        raise AssertionError(f"{tag}: the generator moved otherwise")
    twin_d = TorchDraws(seed, dev)
    row_shape = tuple(shape[:-2]) + (shape[-1],)
    twin = torch.stack([st.beta_posterior_on(
        cuda_beta.primitives(twin_d, row_shape), cfg, n1[..., g, :],
        n0[..., g, :]) for g in range(groups)], dim=-2)
    for name, ref in (("composition", want), ("twin", twin)):
        diff = got != ref
        if diff.any():
            ulps = (got.view(torch.int32) - ref.view(torch.int32)).abs()
            raise AssertionError(f"{tag}: {int(diff.sum())} rows' values "
                                 f"differ from the {name} (up to "
                                 f"{int(ulps[diff].max())} ulps)")
    return float((got - want).abs().max())


def beta_batch_case(dev, seed, cfg, chains=4):
    """A StackedDraws batch of `chains` chains' [3, m] rows in one batched
    launch == each chain's one-chain launch and its composition, bit for
    bit, each generator where its composition leaves it."""
    import torch

    from bnpc_tpu_torch import state as st
    from bnpc_tpu_torch.draws import StackedDraws
    from bnpc_tpu_torch.ops import cuda_beta

    shape = (chains, 3, M)
    n1, n0 = mh_rows(shape, 0, seed, dev)[1:3]
    stack = StackedDraws([TorchDraws(seed + c, dev) for c in range(chains)])
    before = dict(cuda_beta.chain_grids)
    got = st.beta_posterior_rows((stack,) * 3, cfg, n1, n0)
    if cuda_beta.chain_grids.get(chains, 0) != before.get(chains, 0) + 1:
        raise AssertionError(f"beta_post batch seed {seed}: not one launch "
                             f"on a grid of {chains} chains")
    for c in range(chains):
        one = st.beta_posterior_rows((TorchDraws(seed + c, dev),) * 3, cfg,
                                     n1[c], n0[c])
        want, gen = beta_composed(seed + c, cfg, n1[c], n0[c], dev)
        for w in (one, want):
            if not torch.equal(got[c], w):
                raise AssertionError(f"beta_post batch seed {seed}: chain "
                                     f"{c} differs from its one-chain run")
        if not torch.equal(stack.chains[c].gen.get_state(), gen):
            raise AssertionError(f"beta_post batch seed {seed}: chain {c}'s "
                                 "generator moved otherwise")


def beta_refuses(dev, cfg):
    """On the card, a provider whose Beta the kernel cannot replay (a
    TorchDraws with a beta_general of its own) raises in
    state.beta_posterior_rows before any draw: no other path."""
    import torch

    from bnpc_tpu_torch import state as st

    class OwnBeta(TorchDraws):
        def beta_general(self, a, b):
            raise AssertionError("beta_post: the card's path called a "
                                 "provider's own beta_general")

    d = OwnBeta(1, dev)
    before = d.gen.get_state()
    n1 = torch.zeros((3, M), device=dev)
    try:
        st.beta_posterior_rows((d,) * 3, cfg, n1, n1)
    except ValueError as e:
        if "cannot replay" not in str(e):
            raise
    else:
        raise AssertionError("beta_post: an OwnBeta provider on the card "
                             "did not raise")
    if not torch.equal(d.gen.get_state(), before):
        raise AssertionError("beta_post: a refused provider drew")


def phase_beta_post(dev, smi):
    """Kernel 8 (csrc/beta_post.cu) against the torch composition it
    replaces, on the card: a split-merge launch's 3 x 200 rows, one row,
    a k_max block as init_state draws it, bit for bit with the generator's
    state, and against the twin on the wrapper's primitives; a batch of 4
    chains against its one-chain launches; the crafted rows against the
    twin; a provider it cannot replay refused; the runner's captured block against its eager one;
    then the kernel's time a call inside a CUDA graph against its bytes
    bound and against the composition's."""
    import torch

    from bnpc_tpu_torch import state as st
    from bnpc_tpu_torch.ops import cuda_beta

    cfg, _ = bench_configs()
    errs = [beta_case(dev, shape, seed, cfg)
            for shape in ((3, M), (1, M), (K_MAX, 1, M))
            for seed in BETA_SEEDS]
    for seed in BETA_SEEDS:
        beta_batch_case(dev, seed, cfg)
    n1, n0, prims, names = beta_crafted(dev)
    got = cuda_beta.beta_post(n1, n0, torch.stack(prims, dim=-2), cfg)
    twin = st.beta_posterior_on(prims, cfg, n1, n0)
    if not torch.equal(got, twin):
        bad = [names[r] for r in range(len(names))
               if not torch.equal(got[r], twin[r])]
        raise AssertionError(f"beta_post crafted rows differ: {bad}")
    beta_refuses(dev, cfg)
    log(f"  beta_post == the torch composition and the twin bit for bit at "
        f"3 x {M}, 1 x {M} and {K_MAX} x {M}, {len(BETA_SEEDS)} seeds, the "
        f"generator's state alike; a batch of 4 == its one-chain launches; "
        f"crafted rows {names} == the twin")
    launches_per_step = mh_captured(dev, cuda_beta)
    log(f"  beta_post in the captured block: == eager bit for bit, "
        f"{launches_per_step} launches a step counted under replay")

    n1, n0 = mh_rows((3, M), 0, 1, dev)[1:3]
    keys = (TorchDraws(1, dev),) * 3
    row_shape = (M,)
    prims = torch.stack([torch.stack(cuda_beta.primitives(k, row_shape))
                         for k in keys])

    def kernel():
        cuda_beta.beta_post(n1, n0, prims, cfg)

    def composed():
        for g in range(3):
            st.beta_posterior_on(prims[g], cfg, n1[g], n0[g])

    moved = n1.numel() * (2 + 26 + 1) * 4
    timing = {"kernel_graph_ms": mh_graph_ms(kernel, 50),
              "kernel_eager_ms": cuda_ms(kernel, 200),
              "composition_graph_ms": mh_graph_ms(composed, 1),
              "composition_eager_ms": cuda_ms(composed, 50),
              "composition_kernels": mh_kernels_per_call(composed),
              "bytes_bound_ms": moved / HBM_BYTES_PER_S * 1e3}
    log(f"  beta_post (3, {M}) ({smi}): "
        + ", ".join(f"{k} {v:.5g}" for k, v in timing.items()))
    return {"max_abs_err": max(errs), "launches_per_step": launches_per_step,
            "timing": timing, "ms": timing["kernel_graph_ms"],
            "plain_ms": timing["composition_graph_ms"],
            "bound_ms": timing["bytes_bound_ms"], "bound_by": "bytes"}


RG_ASSIGN_COUNTS = (0, 1, 37, 1984, N - 2)


def rg_assign_case(seed, n, s_count, dev="cpu", launch="random", ties=0,
                   n_move=None):
    """One chain's launch-scan inputs after the draws, made on the host by
    a seeded generator: s_count movable cells and two anchors among n, the
    launch sides (random, or all 0 / all 1 on the movable cells), `ties`
    movable cells whose 64-bit keys equal another's, a uniform of 0 (the
    clamp at tiny), n_move (default s_count + 2, the move's cells)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=g)
    s_mask = torch.zeros(n, dtype=torch.bool)
    s_mask[perm[2:2 + s_count]] = True
    rg = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    if launch != "random":
        rg = torch.where(s_mask, int(launch == "ones"), rg).to(torch.int32)
    u = torch.rand((n, 2), generator=g)
    u[perm[2], 0] = 0.0
    bits = torch.randint(0, 2**32, (2, n), generator=g, dtype=torch.int64)
    for t in range(min(ties, s_count - 1)):
        bits[:, perm[3 + t]] = bits[:, perm[2]]
    x = dict(noise=u, bits=bits, ll2=-torch.rand((n, 2), generator=g) * 40.0,
             s_mask=s_mask, rg=rg, anchor_i=perm[0].to(torch.int32),
             anchor_j=perm[1].to(torch.int32),
             n_move=torch.tensor(float(s_count + 2 if n_move is None
                                       else n_move)),
             dp_alpha=torch.tensor(0.37 + 0.1 * (seed % 3)))
    return {k: v.to(dev) for k, v in x.items()}


def rg_assign_batch(cases):
    """The cases of rg_assign_case as one batch (a leading chain axis)."""
    import torch

    return {k: torch.stack([c[k] for c in cases]) for k in cases[0]}


def rg_assign_args(x, trans_prob):
    """The positional arguments of cuda_rg_assign.rg_assign / _ref."""
    return (x["noise"], x["bits"], x["ll2"], x["s_mask"], x["rg"],
            x["anchor_i"], x["anchor_j"], x["n_move"], x["dp_alpha"],
            trans_prob)


def rg_assign_composed(x, trans_prob):
    """models/splitmerge.py's composition after the draws
    (splitmerge._assign_composed) on x's device, kernel 2's own entry
    inside it on the card. Returns (rg_new, sides, chosen or None), what
    kernel 9 returns."""
    import torch

    from bnpc_tpu_torch.draws import gumbel_of
    from bnpc_tpu_torch.models import splitmerge as sm

    class GivenBits:
        def bits(self, shape):
            return x["bits"]

    idx = torch.arange(x["s_mask"].shape[-1], device=x["s_mask"].device)
    cells = x["s_mask"] | (idx == x["anchor_i"][..., None]) \
        | (idx == x["anchor_j"][..., None])
    zero = torch.zeros_like(x["n_move"])
    ctx = sm._MoveCtx(is_split=True, cells=cells, s_mask=x["s_mask"],
                      anchor_i=x["anchor_i"], anchor_j=x["anchor_j"],
                      cl_a=zero, cl_b=zero, n_move=x["n_move"],
                      ltrans_size=zero, inv_sum_others=zero)
    rg_new, sides, chosen = sm._assign_composed(
        ctx, x["rg"], x["ll2"], gumbel_of(x["noise"]), GivenBits(),
        x["dp_alpha"], trans_prob)
    return rg_new, torch.stack(sides, dim=-2), chosen


def same_bits(tag, got, want):
    """Raise unless two tensors (or Nones) are equal bit for bit, NaN
    payloads included."""
    import torch

    if got is None or want is None:
        if got is not None or want is not None:
            raise AssertionError(f"{tag}: one of the two is None")
        return
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{tag}: {got.dtype} {tuple(got.shape)} "
                             f"against {want.dtype} {tuple(want.shape)}")
    bits = {torch.float32: torch.int32,
            torch.float16: torch.int16}.get(got.dtype)
    if bits is not None:
        got, want = got.view(bits), want.view(bits)
    if not torch.equal(got, want):
        raise AssertionError(f"{tag}: differs bit for bit")


def rg_assign_sum(chosen):
    """The move's torch sum of the chosen terms (ax.sum): one chain's, or
    each chain's of a batch."""
    from bnpc_tpu_torch.parallel.axis import ChainAxis, MutAxis

    if chosen.dim() == 1:
        return MutAxis().sum(chosen)
    return ChainAxis(chains=chosen.shape[0]).sum(chosen)


def rg_assign_check(tag, x, trans_prob):
    """Kernel 9 == the composition on the card (kernel 2 inside it) == the
    twin on the card, bit for bit: the new sides, the side masks, the
    chosen terms and their torch sum. Returns the kernel's outputs."""
    import torch

    from bnpc_tpu_torch.ops import cuda_rg_assign

    args = rg_assign_args(x, trans_prob)
    got = cuda_rg_assign.rg_assign(*args)
    want = rg_assign_composed(x, trans_prob)
    twin = cuda_rg_assign.rg_assign_ref(*args)
    torch.cuda.synchronize()
    for name, g, w, t in zip(("rg_new", "sides", "chosen"), got, want, twin):
        same_bits(f"rg_assign {tag} {name} (composition)", g, w)
        same_bits(f"rg_assign {tag} {name} (twin)", g, t)
    if trans_prob:
        same_bits(f"rg_assign {tag} sum", rg_assign_sum(got[2]),
                  rg_assign_sum(want[2]))
    return got


def rg_move_inputs(dev, n, m, k_max, clones, seed, chains=0, split=True):
    """A split-merge move's context and launch state at n x m (planted
    clones as the state's clusters), for `_rg_scan_assign`: (cfg, data,
    state, ctx, rgs), one chain or a stack of `chains`."""
    import torch

    from bnpc_tpu_torch.config import ModelConfig
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.models import splitmerge as sm
    from bnpc_tpu_torch.state import init_state, stack_states

    cfg = ModelConfig(n_cells=n, n_muts=m, k_max=k_max, p=0.25, q=0.25)
    data_np, planted = make_data(n, m, clones, 0.1, seed=seed)
    data = pack_data(data_np, dev)
    out = []
    for c in range(max(chains, 1)):
        state = init_state(TorchDraws(seed + c, dev), cfg, data, dev,
                           assign=planted)
        ctx = sm._setup(TorchDraws(50 + c, dev), state, cfg, split)
        rgs = sm._rg_init(TorchDraws(70 + c, dev), ctx, state, data, cfg)
        out.append((state, ctx, rgs))
    if not chains:
        return (cfg, data) + out[0]
    fields = range(1, len(sm._MoveCtx._fields))
    ctx = sm._MoveCtx(split, *(torch.stack([o[1][f] for o in out])
                               for f in fields))
    rgs = sm._RGState(*(torch.stack([o[2][f] for o in out])
                        for f in range(len(sm._RGState._fields))))
    return cfg, data, stack_states([o[0] for o in out]), ctx, rgs


def rg_move_check(dev, chains, split, trans_prob, seed):
    """models/splitmerge.py::_rg_scan_assign on the card, kernel 9's route
    against the composition's (the route turned off), from one seed: the
    new sides, the transition sum and the side masks bit for bit, every
    generator left in the same state. Returns the move's s_counts."""
    import torch

    from bnpc_tpu_torch.draws import StackedDraws
    from bnpc_tpu_torch.models import splitmerge as sm
    from bnpc_tpu_torch.ops import cuda_rg_assign
    from bnpc_tpu_torch.parallel.axis import ChainAxis

    cfg, data, state, ctx, rgs = rg_move_inputs(dev, N, M, K_MAX, 10, seed,
                                                chains, split)
    ax = ChainAxis(chains=chains) if chains else sm._NO_AXIS

    def run(fits):
        provs = [TorchDraws(seed + 90 + c, dev) for c in range(max(chains, 1))]
        draws = StackedDraws(provs) if chains else provs[0]
        kept = cuda_rg_assign.fits
        cuda_rg_assign.fits = fits
        try:
            before = cuda_rg_assign.launches + cuda_rg_assign.chain_launches
            out = sm._rg_scan_assign(draws, ctx, rgs.rg, rgs.params_split,
                                     state, data, cfg, trans_prob, ax)
            torch.cuda.synchronize()
            launched = (cuda_rg_assign.launches
                        + cuda_rg_assign.chain_launches - before)
        finally:
            cuda_rg_assign.fits = kept
        return out, [p.gen.get_state() for p in provs], launched

    got, got_gens, launched = run(cuda_rg_assign.fits)
    want, want_gens, none = run(lambda device, n: False)
    tag = (f"rg_assign move ({'split' if split else 'merge'}, "
           f"{chains or 1} chain(s), trans_prob {trans_prob})")
    if (launched, none) != (1, 0):
        raise AssertionError(f"{tag}: launches {launched} / {none}")
    same_bits(f"{tag} rg_new", got[0], want[0])
    same_bits(f"{tag} sum", got[1], want[1])
    for side, g, w in zip((0, 1), got[2], want[2]):
        same_bits(f"{tag} side {side}", g, w)
    if not all(torch.equal(g, w) for g, w in zip(got_gens, want_gens)):
        raise AssertionError(f"{tag}: generator states differ")
    return ctx.s_mask.sum(-1).reshape(-1).tolist()


def phase_rg_assign(dev, smi):
    """Kernel 9 (csrc/rg_assign.cu) against the torch composition it
    replaces and the twin, on the card, bit for bit: at n = 5,000 with
    s_count 0, 1, 37, 1,984 and 4,998, equal keys, launch sides all 0 and
    all 1, the table's +inf reached, each with and without trans_prob; a
    batch of 4 (s_count 0, 1, 37, 4,998) against its one-chain launches;
    n = MAX_CELLS; _rg_scan_assign's route against its composition on
    TorchDraws (a split and a merge, one chain and a StackedDraws batch of
    4), generator states alike; the runner's captured block against its
    eager one; then the kernel's time a call in a CUDA graph against the
    composition's, at the s_counts of a move."""
    import torch

    from bnpc_tpu_torch.ops import cuda_rg_assign

    cases = {f"s_count={s}": rg_assign_case(s + 5, N, s, dev)
             for s in RG_ASSIGN_COUNTS}
    cases.update({
        "equal keys": rg_assign_case(11, N, 1200, dev, ties=40),
        "launch all 0": rg_assign_case(12, N, 1500, dev, launch="zeros"),
        "launch all 1": rg_assign_case(13, N, 1500, dev, launch="ones"),
        "table +inf reached": rg_assign_case(14, N, 900, dev, n_move=400)})
    for tag, x in cases.items():
        for trans_prob in (False, True):
            rg_assign_check(tag, x, trans_prob)
    batch_counts = (0, 1, 37, N - 2)
    one = [rg_assign_case(20 + c, N, s, dev)
           for c, s in enumerate(batch_counts)]
    x = rg_assign_batch(one)
    for trans_prob in (False, True):
        grids = dict(cuda_rg_assign.chain_grids)
        got = rg_assign_check(f"batch {batch_counts}", x, trans_prob)
        if cuda_rg_assign.chain_grids.get(4, 0) != grids.get(4, 0) + 1:
            raise AssertionError("rg_assign batch: not one launch on a "
                                 "grid of 4")
        for c, xc in enumerate(one):
            alone = cuda_rg_assign.rg_assign(*rg_assign_args(xc, trans_prob))
            for name, g, a in zip(("rg_new", "sides", "chosen"), got, alone):
                same_bits(f"rg_assign batch chain {c} {name} (one-chain "
                          "launch)", None if g is None else g[c], a)
    cap = cuda_rg_assign.MAX_CELLS
    rg_assign_check(f"n={cap}", rg_assign_case(30, cap, cap - 2, dev), True)
    s_counts = []
    for chains in (0, 4):
        for split in (True, False):
            for trans_prob in (False, True):
                s_counts += rg_move_check(dev, chains, split, trans_prob,
                                          40 + chains)
    log(f"  rg_assign == the torch composition (kernel 2 inside) and the "
        f"twin bit for bit at n = {N:,}: {sorted(cases)}, trans_prob off "
        f"and on; a batch of 4 == its one-chain launches; n = {cap:,}; "
        f"_rg_scan_assign's route == its composition (s_counts {s_counts}),"
        f" generators alike")
    launches_per_step = mh_captured(dev, cuda_rg_assign)
    log(f"  rg_assign in the captured block: == eager bit for bit, "
        f"{launches_per_step} launches a step counted under replay")

    timing = {}
    for s_count in (37, 500, RG_TIMED_S, 1984, N - 2):
        x = rg_assign_case(50 + s_count, N, s_count, dev)
        for trans_prob in (False, True):
            args = rg_assign_args(x, trans_prob)

            def kernel():
                cuda_rg_assign.rg_assign(*args)

            def composed():
                rg_assign_composed(x, trans_prob)

            timing[f"{s_count}{' trans' if trans_prob else ''}"] = {
                "kernel_graph_ms": mh_graph_ms(kernel, 20),
                "composition_graph_ms": mh_graph_ms(composed, 1),
                "composition_kernels": mh_kernels_per_call(composed)}
    # At the s_count timed for the kernels line, with trans_prob: s_mask
    # and rg of every cell; bits, noise and ll2 of the S cells alone;
    # rg_new, the two sides and chosen of every cell.
    moved = N * (1 + 4 + 4 + 8 + 4) + RG_TIMED_S * (16 + 8 + 8)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    for key, t in timing.items():
        log(f"  rg_assign s_count {key} ({smi}): kernel "
            f"{t['kernel_graph_ms']:.5f} ms in a graph; composition "
            f"{t['composition_graph_ms']:.5f} ms in a graph, "
            f"{t['composition_kernels']} kernels a call")
    main = timing[f"{RG_TIMED_S} trans"]
    log(f"  rg_assign bytes bound at s_count {RG_TIMED_S:,}: {moved:,} B, "
        f"{bound_ms:.7f} ms (the chain bound: phase 8)")
    return {"max_abs_err": 0.0, "launches_per_step": launches_per_step,
            "timing": timing, "ms": main["kernel_graph_ms"],
            "plain_ms": main["composition_graph_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes"}


# ---------------------------------------------------------------------------
# Phase 3, kernels 10 and 11: the error-rate MH and the trace row against
# the torch composition
# ---------------------------------------------------------------------------

REST_SEEDS = (2147483629, 3000000037, 29)
# (name, (FP's proposal uniform, acceptance uniform), FN's, expected
# flags): a uniform of 0 accepts any proposal (log 0 = -inf); a proposal in
# the far upper tail against a uniform of 1 is declined.
REST_FORCED = (("accept both", (None, 0.0), (None, 0.0), (True, True)),
               ("decline both", (1.0 - 1e-7, 1.0), (1.0 - 1e-7, 1.0),
                (False, False)),
               ("FP accepted", (None, 0.0), (1.0 - 1e-7, 1.0),
                (True, False)),
               ("FN accepted", (1.0 - 1e-7, 1.0), (None, 0.0),
                (False, True)))
REST_CHAIN_STEPS = 10_000
REST_BATCH_STEPS = 512
REST_TRACE_K = 128


def rest_case(seed, chains, dev):
    """A state at K_MAX x M whose statistics a 5,000-cell panel with FP
    0.01 and FN 0.2 would give: live slots of up to 400 cells and free
    slots, parameters as the bench's Beta(0.25, 0.25) prior leaves them,
    counts drawn from them (10% missing), and one chain's (0-d) or
    `chains` chains' ([C]) scalars. Returns (state, n1, n0)."""
    import torch

    from bnpc_tpu_torch.config import TMAX, TMIN
    from bnpc_tpu_torch.state import CRPState

    rng = np.random.default_rng(seed % 2**32)
    lead = (chains,) if chains else ()
    sizes = rng.integers(1, 400, lead + (K_MAX,)) \
        * (rng.random(lead + (K_MAX,)) < 0.7)
    params = np.clip(rng.beta(0.25, 0.25, lead + (K_MAX, M)), TMIN, TMAX)
    seen = np.broadcast_to(np.round(sizes[..., None] * 0.9).astype(int),
                           params.shape)
    n1 = rng.binomial(seen, params * 0.8 + (1.0 - params) * 0.01)

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    state = CRPState(
        assignment=torch.zeros(lead + (N,), dtype=torch.int32, device=dev),
        params=f32(params),
        cluster_size=torch.tensor(sizes, dtype=torch.int32, device=dev),
        dp_alpha=f32(rng.uniform(1.5, 30.0, lead)),
        fp=f32(rng.uniform(0.005, 0.015, lead)),
        fn=f32(rng.uniform(0.15, 0.25, lead)))
    return state, f32(n1), f32(seen - n1)


def rest_axis(chains, mask=None):
    from bnpc_tpu_torch.parallel.axis import ChainAxis, MutAxis

    mut = MutAxis(mask=mask)
    return ChainAxis(chains=chains, mut=mut) if chains else mut


def rest_draws(seed, chains, dev):
    """(draws, providers): TorchDraws(seed + c) a chain, stacked for a
    batch."""
    from bnpc_tpu_torch.draws import StackedDraws

    provs = [TorchDraws(seed + c, dev) for c in range(max(chains, 1))]
    return (StackedDraws(provs) if chains else provs[0]), provs


class rest_composed:
    """While active, update_error_rates and summarize take the torch
    composition on the card (kernels 10 and 11's routes turned off)."""

    def __enter__(self):
        from bnpc_tpu_torch.ops import cuda_error_mh, cuda_row

        self.kept = cuda_error_mh.fits, cuda_row.fits
        cuda_error_mh.fits = cuda_row.fits = lambda device: False

    def __exit__(self, *exc):
        from bnpc_tpu_torch.ops import cuda_error_mh, cuda_row

        cuda_error_mh.fits, cuda_row.fits = self.kept


def rest_launches():
    from bnpc_tpu_torch.ops import cuda_error_mh, cuda_row

    return [m.launches + m.chain_launches for m in (cuda_error_mh, cuda_row)]


def rest_outputs(case, cfg, draws, ax):
    """update_error_rates on `case`, then summarize twice, its ML from the
    statistics and handed from the move: every field kernels 10 and 11
    give."""
    from bnpc_tpu_torch import mcmc
    from bnpc_tpu_torch.models import updates

    state, n1, n0 = case
    st, fp_acc, fn_acc, ll = updates.update_error_rates(draws, state, n1, n0,
                                                        cfg, ax)
    row = mcmc.summarize(st, None, cfg, REST_TRACE_K, stats=(n1, n0), ax=ax)
    handed = mcmc.summarize(st, None, cfg, REST_TRACE_K,
                            stats=mcmc.StepStats(None, None, ll), ax=ax)
    return {"fp": st.fp, "fn": st.fn, "fp_acc": fp_acc, "fn_acc": fn_acc,
            "ll": ll, **{f"row {f}": v for f, v in row._asdict().items()},
            "handed ml": handed.ml, "handed map": handed.map_}


def rest_check(tag, dev, case, cfg, seed, mask=None):
    """The fused route (kernels 10 and 11) against the composition on the
    card, from one seed: every output bit for bit, the generators left
    alike, the row from the move's likelihood == the row from the
    statistics, and the kernels launched on the fused route alone. Returns
    the flags (FP, FN) of each chain."""
    import torch

    chains = case[0].fp.shape[0] if case[0].fp.dim() else 0
    ax = rest_axis(chains, mask)

    def run():
        draws, provs = rest_draws(seed, chains, dev)
        out = rest_outputs(case, cfg, draws, ax)
        return out, [p.gen.get_state() for p in provs]

    before = rest_launches()
    got, got_gens = run()
    fused = rest_launches()
    with rest_composed():
        want, want_gens = run()
    launched = [a - b for a, b in zip(fused, before)]
    if launched != [3, 4] or rest_launches() != fused:
        raise AssertionError(f"rest {tag}: launches {launched}, then "
                             f"{rest_launches()} after the composition")
    for name, w in want.items():
        same_bits(f"rest {tag} {name}", got[name], w)
    same_bits(f"rest {tag} ML handed", got["handed ml"], got["row ml"])
    same_bits(f"rest {tag} MAP handed", got["handed map"], got["row map_"])
    if not all(torch.equal(g, w) for g, w in zip(got_gens, want_gens)):
        raise AssertionError(f"rest {tag}: generator states differ")
    return torch.stack([got["fp_acc"], got["fn_acc"]], -1).reshape(
        -1, 2).tolist()


def rest_forced(dev, cfg, chains, seed):
    """Kernel 10 on drawn primitives whose uniforms force each outcome
    (REST_FORCED) against its twin on the card (updates.error_rates_on):
    the rates, flags and likelihood bit for bit, the flags as forced."""
    import torch

    from bnpc_tpu_torch.models import updates
    from bnpc_tpu_torch.ops import cuda_error_mh

    state, n1, n0 = rest_case(seed, chains, dev)
    ax = rest_axis(chains)
    prims = cuda_error_mh.primitives(rest_draws(seed, chains, dev)[0],
                                     tuple(state.fp.shape))
    for name, fp_u, fn_u, flags in REST_FORCED:
        p = list(prims)
        for at, v in zip((1, 2, 4, 5), (*fp_u, *fn_u)):
            if v is not None:
                p[at] = torch.full_like(p[at], v)
        got = cuda_error_mh.error_mh(state.params, n1, n0, state.fp,
                                     state.fn, p, cfg, ax)
        want = updates.error_rates_on(state.params, n1, n0, state.fp,
                                      state.fn, p, cfg, ax)
        tag = f"rest forced {name} ({chains or 1} chain(s))"
        for f, g, w in zip(("fp", "fn", "fp_acc", "fn_acc", "ll"), got,
                           want):
            same_bits(f"{tag} {f}", g, w)
        seen = torch.stack(got[2:4], -1).reshape(-1, 2).tolist()
        if any(tuple(s) != flags for s in seen):
            raise AssertionError(f"{tag}: flags {seen}")


def rest_graph(dev, cfg, chains, seed):
    """Kernels 10 and 11 on fixed primitives, captured in one CUDA graph
    (the torch sums between their launches inside it) and replayed twice,
    against the composition run eager: bit for bit."""
    import torch

    from bnpc_tpu_torch import mcmc
    from bnpc_tpu_torch.models import updates
    from bnpc_tpu_torch.ops import cuda_error_mh, cuda_row

    case = rest_case(seed, chains, dev)
    state, n1, n0 = case
    ax = rest_axis(chains)
    prims = cuda_error_mh.primitives(rest_draws(seed, chains, dev)[0],
                                     tuple(state.fp.shape))

    def fused():
        fp, fn, fp_acc, fn_acc, ll = cuda_error_mh.error_mh(
            state.params, n1, n0, state.fp, state.fn, prims, cfg, ax)
        st = state._replace(fp=fp, fn=fn)
        ml, map_ = cuda_row.ml_map(cfg, st, n1, n0, None, ax)
        _, map_handed = cuda_row.ml_map(cfg, st, None, None, ll, ax)
        return fp, fn, fp_acc, fn_acc, ll, ml, map_, map_handed

    fused()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fused()
    fp, fn, fp_acc, fn_acc, ll = updates.error_rates_on(
        state.params, n1, n0, state.fp, state.fn, prims, cfg, ax)
    with rest_composed():
        row = mcmc.summarize(state._replace(fp=fp, fn=fn), None, cfg,
                             REST_TRACE_K, stats=(n1, n0), ax=ax)
    want = (fp, fn, fp_acc, fn_acc, ll, row.ml, row.map_, row.map_)
    for rep in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for name, g, w in zip(("fp", "fn", "fp_acc", "fn_acc", "ll", "ml",
                               "map", "map (ML handed)"), outs, want):
            same_bits(f"rest graph ({chains or 1} chain(s)) replay {rep} "
                      f"{name}", g, w)


def bits_differ(tag, got, want):
    """The count of elements whose bits differ, on the device (a dtype or
    shape mismatch raises at once)."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{tag}: {got.dtype} {tuple(got.shape)} "
                             f"against {want.dtype} {tuple(want.shape)}")
    bits = {torch.float32: torch.int32,
            torch.float16: torch.int16}.get(got.dtype)
    if bits is not None:
        got, want = got.view(bits), want.view(bits)
    return (got != want).sum()


class RestChecker:
    """While active, every update_error_rates and summarize call of an
    eager step (mcmc.py looks both up at call time) runs twice: the fused
    route, then the composition (the routes turned off) from the same
    generator states; the fused results go on. summarize also runs the
    error MH both ways on the state it sums with side draws of its own, so
    that kernel 10 is held at every step, not on a quarter of them. The
    results are held bit for bit on the device and read once
    (:meth:`verify`)."""

    def __init__(self, dev, side_seed):
        import torch

        self.dev, self.side_seed = dev, side_seed
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.calls = {"error_mh": 0, "trace_row": 0}
        self.gen_faults = 0
        self.side = {}

    def __enter__(self):
        from bnpc_tpu_torch import mcmc

        self.real = mcmc.update_error_rates, mcmc.summarize
        self.start = rest_launches()
        mcmc.update_error_rates, mcmc.summarize = self.errors, self.summarize
        return self

    def __exit__(self, *exc):
        from bnpc_tpu_torch import mcmc

        mcmc.update_error_rates, mcmc.summarize = self.real

    def _differ(self, tag, got, want):
        for g, w in zip(got, want):
            self.bad += bits_differ(tag, g, w)

    def errors(self, draws, state, n1, n0, cfg, ax):
        import torch

        from bnpc_tpu_torch.draws import StackedDraws

        provs = draws.chains if isinstance(draws, StackedDraws) else [draws]
        before = [p.gen.get_state() for p in provs]
        got = self.real[0](draws, state, n1, n0, cfg, ax)
        after = [p.gen.get_state() for p in provs]
        for p, s in zip(provs, before):
            p.gen.set_state(s)
        with rest_composed():
            want = self.real[0](draws, state, n1, n0, cfg, ax)
        self.gen_faults += sum(not torch.equal(p.gen.get_state(), a)
                               for p, a in zip(provs, after))
        self._differ("error_mh", (got[0].fp, got[0].fn, *got[1:]),
                     (want[0].fp, want[0].fn, *want[1:]))
        self.calls["error_mh"] += 1
        return got

    def summarize(self, state, data, cfg, trace_k, stats=None, ax=None):
        from bnpc_tpu_torch.mcmc import StepStats

        got = self.real[1](state, data, cfg, trace_k, stats, ax)
        n1, n0, _ = StepStats(*stats)
        with rest_composed():
            want = self.real[1](state, data, cfg, trace_k, (n1, n0), ax)
        self._differ("trace_row", got, want)
        self.calls["trace_row"] += 1
        chains = state.fp.shape[0] if state.fp.dim() else 0
        if chains not in self.side:
            self.side[chains] = rest_draws(self.side_seed, chains,
                                           self.dev)[0]
        self.errors(self.side[chains], state, n1, n0, cfg, ax)
        return got

    def verify(self, tag):
        """Raise unless every pair agreed and the fused route launched
        kernel 10 three times and kernel 11 twice a call. Returns the
        calls."""
        bad = int(self.bad)
        launched = [a - b for a, b in zip(rest_launches(), self.start)]
        want = [3 * self.calls["error_mh"], 2 * self.calls["trace_row"]]
        if bad or self.gen_faults or launched != want:
            raise AssertionError(
                f"rest chain {tag}: {bad} elements differ, "
                f"{self.gen_faults} generators moved otherwise, launches "
                f"{launched} against {want}")
        return dict(self.calls)


def rest_chain(dev, chains, steps, seed):
    """A real chain at the main cell (or a batch of `chains` chains):
    burn-in (0.33 x 5,000 steps) through the captured block, then `steps`
    eager steps under RestChecker. Returns the calls checked."""
    from bnpc_tpu_torch import mcmc
    from bnpc_tpu_torch.data import pack_data

    data, _ = make_data(N, M, 10, 0.1, seed=3)
    cfg, mc = bench_configs()
    runner = mcmc.MCMCRunner(cfg, mc, pack_data(data, dev), device=dev,
                             block_size=256)
    states, draws = [], []
    for c in range(max(chains, 1)):
        state = runner.init_chains(TorchDraws(seed + c, dev))[0]
        d = TorchDraws(seed + 100 + c, dev)
        for _ in range(7):
            state, _, d = runner.run_block(state, d, 256)
        states.append(state)
        draws.append(d)
    step = runner._block.step
    with RestChecker(dev, seed + 1000) as checker:
        if chains:
            mcmc._batch_block(step, states, draws, steps)
        else:
            for _ in range(steps // 1000):
                states[0], _, draws[0] = mcmc._chain_block(
                    step, states[0], draws[0], 1000)
    return checker.verify(f"{chains or 1} chain(s)")


def rest_timing(dev, smi, cfg):
    """Each kernel's time a call inside a CUDA graph against the
    composition's, its device operations a call, and its bytes bound, at
    K_MAX x M, one chain."""
    from bnpc_tpu_torch.models import updates
    from bnpc_tpu_torch.ops import cuda_error_mh, cuda_row
    from bnpc_tpu_torch.ops import likelihood as lk

    state, n1, n0 = rest_case(1, 0, dev)
    ax = rest_axis(0)
    prims = cuda_error_mh.primitives(TorchDraws(1, dev), ())
    ll = updates.error_rates_on(state.params, n1, n0, state.fp, state.fn,
                                prims, cfg, ax)[4]

    forms = {
        "error_mh": (lambda: cuda_error_mh.error_mh(
            state.params, n1, n0, state.fp, state.fn, prims, cfg, ax),
            lambda: updates.error_rates_on(state.params, n1, n0, state.fp,
                                           state.fn, prims, cfg, ax)),
        "trace_row": (lambda: cuda_row.ml_map(cfg, state, n1, n0),
                      lambda: lk.ll_from_stats(
                          n1, n0, *lk.log_prob_tables(state.params, state.fp,
                                                      state.fn))
                      + lk.log_prior_full(cfg, state.cluster_size,
                                          state.params, state.dp_alpha,
                                          state.fp, state.fn)),
        "trace_row_ml_handed": (lambda: cuda_row.ml_map(
            cfg, state, None, None, ll), None)}
    plane = K_MAX * M * 4
    # Kernel 10: params, n1, n0 read by stages 0 and 1, three planes of
    # terms written and read back by the sums. Kernel 11: params, n1, n0
    # and the sizes read, the ML and Beta planes written and summed.
    moved = {"error_mh": 2 * 3 * plane + 2 * 3 * plane,
             "trace_row": 3 * plane + K_MAX * 4 + 2 * 2 * plane,
             "trace_row_ml_handed": plane + K_MAX * 4 + 2 * plane}
    out = {}
    for name, (kernel, composed) in forms.items():
        t = {"kernel_graph_ms": mh_graph_ms(kernel, 20),
             "kernel_ops": mh_kernels_per_call(kernel),
             "bytes_bound_ms": moved[name] / HBM_BYTES_PER_S * 1e3}
        if composed is not None:
            t.update(composition_graph_ms=mh_graph_ms(composed, 1),
                     composition_ops=mh_kernels_per_call(composed))
        out[name] = t
        log(f"  {name} at {K_MAX} x {M}, one chain ({smi}): "
            + ", ".join(f"{k} {v:.5g}" for k, v in t.items()))
    return out


def phase_rest(dev, smi):
    """Kernels 10 (csrc/error_mh.cu) and 11 (csrc/trace_row.cu) against
    the torch composition they replace, on the card, bit for bit: the
    rates, both flags, the move's likelihood, ML, MAP and the whole trace
    row, at K_MAX x M, one chain and a batch of 4, Beta(0.25, 0.25) and
    uniform priors, a padded column mask, every outcome forced against the
    twin; inside a CUDA graph; the runner's captured block against its
    eager one; along a real chain past burn-in (REST_CHAIN_STEPS steps, a
    check of each kernel every step) and a batch of 4; then each kernel's
    time a call in a graph against the composition's."""
    import dataclasses

    import torch

    from bnpc_tpu_torch.ops import cuda_error_mh, cuda_row

    cfg, _ = bench_configs()
    uniform = dataclasses.replace(cfg, p=1.0, q=1.0)
    mask = torch.ones(M, device=dev)
    mask[-3:] = 0.0
    flags = []
    for seed in REST_SEEDS:
        for chains in (0, 4):
            case = rest_case(seed, chains, dev)
            flags += rest_check(f"seed {seed} chains {chains}", dev, case,
                                cfg, seed)
            rest_check(f"uniform seed {seed} chains {chains}", dev, case,
                       uniform, seed + 1)
            rest_check(f"masked seed {seed} chains {chains}", dev, case,
                       cfg, seed + 2, mask)
    for chains in (0, 4):
        rest_forced(dev, cfg, chains, 31)
        rest_graph(dev, cfg, chains, 37)
    log(f"  error_mh and trace_row == the torch composition bit for bit "
        f"(rates, flags, likelihood, ML, MAP, the trace row; one chain and "
        f"4; Beta and uniform priors; a padded mask; drawn flags {flags}); "
        f"every outcome forced == the twin; in a CUDA graph, two replays")
    per_step = {}
    for mod in (cuda_error_mh, cuda_row):
        per_step[mod.__name__] = mh_captured(dev, mod)
    log(f"  in the captured block: == eager bit for bit, launches a step "
        f"counted under replay {per_step}")
    t0 = time.perf_counter()
    calls = rest_chain(dev, 0, REST_CHAIN_STEPS, 2147483001)
    calls_4 = rest_chain(dev, 4, REST_BATCH_STEPS, 2147484001)
    log(f"  along a real chain past burn-in at {N:,} x {M}: {calls} calls "
        f"of one chain, {calls_4} of a batch of 4, each fused == the "
        f"composition bit for bit ({time.perf_counter() - t0:.1f} s)")
    timing = rest_timing(dev, smi, cfg)
    return {name: {"max_abs_err": 0.0, "launches_per_step": per_step[
        mod.__name__], "chain_calls": calls[name], "timing": timing,
        "ms": timing[name]["kernel_graph_ms"],
        "plain_ms": timing[name]["composition_graph_ms"],
        "bound_ms": timing[name]["bytes_bound_ms"], "bound_by": "bytes"}
        for name, mod in (("error_mh", cuda_error_mh),
                          ("trace_row", cuda_row))}


# ---------------------------------------------------------------------------
# Phase 3, kernel 12: the split-merge acceptance against the torch
# composition
# ---------------------------------------------------------------------------

SM_SEEDS = (2147483647, 3000000019, 41)
# Eager steps of the chain past burn-in, and the moves they must hold at
# least (a move on ~1/3 of the steps: 1,949 in 6,000 on an H100).
SM_CHAIN_STEPS = 7000
SM_CHAIN_MOVES = 2000
SM_BATCH_STEPS = 256


class sm_twin:
    """While active, the split-merge branches take the plain twin's stages
    on the card (kernel 12's route turned off): the reference it is held
    to."""

    def __enter__(self):
        from bnpc_tpu_torch.ops import cuda_sm_accept

        self.kept = cuda_sm_accept.fits
        cuda_sm_accept.fits = lambda device: False

    def __exit__(self, *exc):
        from bnpc_tpu_torch.ops import cuda_sm_accept

        cuda_sm_accept.fits = self.kept


def sm_launches():
    from bnpc_tpu_torch.ops import cuda_sm_accept

    return cuda_sm_accept.launches + cuda_sm_accept.chain_launches


class ForcedUniform:
    """A provider of the acceptance uniform alone: `u` everywhere."""

    def __init__(self, u, dev):
        self.u, self.dev = u, dev

    def uniform(self, shape):
        import torch

        return torch.full(tuple(shape), self.u, device=self.dev)


def sm_branch(split, case, cfg, ax, seed, chains, dev, forced=None):
    """_split_branch or _merge_branch on `case` (rg_move_inputs' launch
    state) from TorchDraws(seed + c), the acceptance uniform forced to
    `forced` when given. Returns (state, counts, generator states)."""
    from bnpc_tpu_torch.models import splitmerge as sm
    from bnpc_tpu_torch.ops import cuda_sm_accept

    _, data, state, ctx, rgs = case
    draws, provs = rest_draws(seed, chains, dev)
    k_f1, k_f2, k_acc = draws.split(3)
    real = cuda_sm_accept.primitives
    if forced is not None:
        def primitives(k_std, k_accept, shape, lead, merge, device):
            idx, u = real(k_std, k_std, shape, lead, merge, device)
            return idx, u.fill_(forced)

        cuda_sm_accept.primitives = primitives
        k_acc = ForcedUniform(forced, dev)
    try:
        branch = sm._split_branch if split else sm._merge_branch
        st, counts = branch(k_f1, k_f2, k_acc, ctx, rgs, state, data, cfg,
                            ax)
    finally:
        cuda_sm_accept.primitives = real
    return st, counts, [p.gen.get_state() for p in provs]


def sm_check(tag, split, case, cfg, ax, seed, chains, dev, forced=None):
    """Kernel 12's route against the twin's stages on the card, from one
    seed: the state and the MH counts bit for bit, the generators left
    alike (unless the uniform is forced), 2 launches a split and 3 a
    merge. Returns (the accepted flags, the parameters' largest absolute
    difference)."""
    import torch

    before = sm_launches()
    got = sm_branch(split, case, cfg, ax, seed, chains, dev, forced)
    launched = sm_launches() - before
    with sm_twin():
        want = sm_branch(split, case, cfg, ax, seed, chains, dev, forced)
    if launched != (2 if split else 3) or sm_launches() != before + launched:
        raise AssertionError(f"sm_accept {tag}: launches {launched}, then "
                             f"{sm_launches() - before}")
    for f, g, w in zip(got[0]._fields, got[0], want[0]):
        same_bits(f"sm_accept {tag} {f}", g, w)
    same_bits(f"sm_accept {tag} counts", got[1], want[1])
    if forced is None and not all(
            torch.equal(g, w) for g, w in zip(got[2], want[2])):
        raise AssertionError(f"sm_accept {tag}: generator states differ")
    err = float((got[0].params - want[0].params).abs().max())
    return got[1].reshape(-1, 2, 2)[:, 0 if split else 1, 0].tolist(), err


def sm_degenerate(dev, cfg, seed):
    """A split whose final sides put every movable cell on side 0, the
    uniform 0: declined by the degenerate test, kernel == twin on the
    card."""
    import torch

    from bnpc_tpu_torch.models import splitmerge as sm
    from bnpc_tpu_torch.ops import cuda_sm_accept as ka

    _, data, state, ctx, rgs = rg_move_inputs(dev, N, M, K_MAX, 10, seed)
    rgs = rgs._replace(rg=torch.zeros_like(rgs.rg))
    prims = ka.primitives(TorchDraws(seed, dev), TorchDraws(seed + 1, dev),
                          rgs.params_merge.shape, (), False, dev)
    prims = (prims[0], torch.zeros_like(prims[1]))
    gs = torch.zeros((), device=dev)
    got = ka.split(prims, ctx, rgs, gs, state, cfg, sm._NO_AXIS)
    want = ka.split(prims, ctx, rgs, gs, state, cfg, sm._NO_AXIS,
                    stages=ka.TWIN)
    for f, g, w in zip(state._fields, got[0], want[0]):
        same_bits(f"sm_accept degenerate {f}", g, w)
    same_bits("sm_accept degenerate counts", got[1], want[1])
    if got[1].tolist() != [[0, 1], [0, 0]]:
        raise AssertionError(f"sm_accept degenerate: counts {got[1]}")


def sm_graph(dev, cfg, chains, seed):
    """Both branches' kernel routes after their final scans on fixed
    primitives, captured in one CUDA graph (the torch sums and products
    between the launches inside it) and replayed twice, against the twin's
    stages run eager on the card: bit for bit."""
    import torch

    from bnpc_tpu_torch.models import splitmerge as sm
    from bnpc_tpu_torch.ops import cuda_sm_accept as ka

    moves = []
    for split in (True, False):
        cfg0, data, state, ctx, rgs = rg_move_inputs(dev, N, M, K_MAX, 10,
                                                     seed, chains, split)
        ax = rest_axis(chains)
        draws, _ = rest_draws(seed, chains, dev)
        scan = sm._rg_scan_split if split else sm._rg_scan_merge
        rgs2, gs = scan(draws, ctx, rgs, state, data, cfg, True, ax)
        rows = rgs2.params_merge.shape if split else rgs2.params_split.shape
        prims = ka.primitives(draws, draws, rows, ctx.n_move.shape,
                              not split, dev)
        moves.append((split, prims, ctx, rgs2, gs, state, data, ax))

    def run(stages=None):
        out = []
        for split, prims, ctx, rgs2, gs, state, data, ax in moves:
            if split:
                st, c = ka.split(prims, ctx, rgs2, gs, state, cfg, ax,
                                 stages)
            else:
                st, c = ka.merge(prims, ctx, rgs2, gs, state, data, cfg, ax,
                                 stages)
            out += [*st[:3], c]
        return out

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    want = run(ka.TWIN)
    for rep in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(outs, want)):
            same_bits(f"sm_accept graph ({chains or 1} chain(s)) replay "
                      f"{rep} output {i}", g, w)


# The launches of one branch on kernel 12's route, its final scan included,
# by kernel wrapper: a split's scan runs kernel 9 and kernel 7's sweep, its
# tail kernel 7's realized mode once and kernel 12's two stages; a merge's
# scan kernel 7's sweep, its tail the realized mode twice (the reverse
# split's two rows) and kernel 12's three stages.
SM_BRANCH_LAUNCHES = {
    "split": {"mh_sweep": 2, "beta_post": 0, "rg_assign": 1, "sm_accept": 2},
    "merge": {"mh_sweep": 3, "beta_post": 0, "rg_assign": 0, "sm_accept": 3}}


def sm_branch_counts():
    """The launches so far of the wrappers SM_BRANCH_LAUNCHES names (one
    chain and batched together)."""
    mods = kernel_modules()
    return {name: mods[name].launches + mods[name].chain_launches
            for name in SM_BRANCH_LAUNCHES["split"]}


class SMChecker:
    """While active, every split-merge branch of an eager step runs twice:
    kernel 12's route, then the twin's stages (the route turned off) from
    the same generator states; the kernel's results go on. The results are
    held bit for bit on the device and read once (:meth:`verify`), and the
    route's launches of each kernel counted a branch
    (SM_BRANCH_LAUNCHES)."""

    def __init__(self, dev):
        import torch

        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.calls = {"split": 0, "merge": 0}
        self.launches = {kind: dict.fromkeys(SM_BRANCH_LAUNCHES[kind], 0)
                         for kind in self.calls}
        self.gen_faults = 0

    def __enter__(self):
        import functools

        from bnpc_tpu_torch.models import splitmerge as sm

        self.real = sm._split_branch, sm._merge_branch
        sm._split_branch = functools.partial(self.branch, 0)
        sm._merge_branch = functools.partial(self.branch, 1)
        return self

    def __exit__(self, *exc):
        from bnpc_tpu_torch.models import splitmerge as sm

        sm._split_branch, sm._merge_branch = self.real

    def branch(self, which, k_f1, *args):
        import torch

        from bnpc_tpu_torch.draws import StackedDraws

        kind = "merge" if which else "split"
        provs = k_f1.chains if isinstance(k_f1, StackedDraws) else [k_f1]
        before = [p.gen.get_state() for p in provs]
        counts = sm_branch_counts()
        got = self.real[which](k_f1, *args)
        for name, n in sm_branch_counts().items():
            self.launches[kind][name] += n - counts[name]
        after = [p.gen.get_state() for p in provs]
        for p, s in zip(provs, before):
            p.gen.set_state(s)
        with sm_twin():
            want = self.real[which](k_f1, *args)
        self.gen_faults += sum(not torch.equal(p.gen.get_state(), a)
                               for p, a in zip(provs, after))
        for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
            self.bad += bits_differ("sm_accept chain", g, w)
        self.calls[kind] += 1
        return got

    def verify(self, tag):
        """Raise unless every pair agreed and the route launched each
        kernel as SM_BRANCH_LAUNCHES says, every branch. Returns the calls
        and the launches a split and a merge."""
        bad = int(self.bad)
        want = {kind: {name: n * self.calls[kind] for name, n in
                       SM_BRANCH_LAUNCHES[kind].items()}
                for kind in self.calls}
        if bad or self.gen_faults or self.launches != want:
            raise AssertionError(
                f"sm_accept chain {tag}: {bad} elements differ, "
                f"{self.gen_faults} generators moved otherwise, launches "
                f"{self.launches} against {want}")
        per = {kind: {name: n / max(self.calls[kind], 1)
                      for name, n in self.launches[kind].items()}
               for kind in self.calls}
        return dict(self.calls), per


def sm_chain(dev, chains, steps, seed):
    """A real chain at the main cell (or a batch of `chains` chains):
    burn-in (0.33 x 5,000 steps) through the captured block, then `steps`
    eager steps under SMChecker. Returns the moves checked."""
    from bnpc_tpu_torch import mcmc
    from bnpc_tpu_torch.data import pack_data

    data, _ = make_data(N, M, 10, 0.1, seed=3)
    cfg, mc = bench_configs()
    runner = mcmc.MCMCRunner(cfg, mc, pack_data(data, dev), device=dev,
                             block_size=256)
    states, draws = [], []
    for c in range(max(chains, 1)):
        state = runner.init_chains(TorchDraws(seed + c, dev))[0]
        d = TorchDraws(seed + 100 + c, dev)
        for _ in range(7):
            state, _, d = runner.run_block(state, d, 256)
        states.append(state)
        draws.append(d)
    step = runner._block.step
    with SMChecker(dev) as checker:
        if chains:
            mcmc._batch_block(step, states, draws, steps)
        else:
            for _ in range(steps // 1000):
                states[0], _, draws[0] = mcmc._chain_block(
                    step, states[0], draws[0], 1000)
    return checker.verify(f"{chains or 1} chain(s)")


def kernel_device_ms(fn, kernel, calls=20):
    """Device ms a call of fn() spent in the kernels whose name holds
    `kernel` (torch.profiler over `calls` eager calls; None where the
    profiler reads no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if kernel in ev.key:
            t = getattr(ev, "device_time_total", None)
            us += ev.cuda_time_total if t is None else t
    return us / calls / 1e3 if us else None


def sm_timing(dev, smi, cfg):
    """Each branch's acceptance after its final scan on fixed primitives at
    the main cell, one chain: kernel 12's own device time a call (its
    stages alone, profiler), the route's time a call inside a CUDA graph
    (the torch sums and products and kernel 7's realized launches between
    the stages included) against the twin's stages on the card, the device
    operations a call of each, and kernel 12's bytes bound."""
    from bnpc_tpu_torch.models import splitmerge as sm
    from bnpc_tpu_torch.ops import cuda_sm_accept as ka

    out = {}
    for split in (True, False):
        _, data, state, ctx, rgs = rg_move_inputs(dev, N, M, K_MAX, 10, 5,
                                                  0, split)
        ax = rest_axis(0)
        draws = TorchDraws(7, dev)
        scan = sm._rg_scan_split if split else sm._rg_scan_merge
        rgs2, gs = scan(draws, ctx, rgs, state, data, cfg, True, ax)
        rows = rgs2.params_merge.shape if split else rgs2.params_split.shape
        prims = ka.primitives(draws, draws, rows, (), not split, dev)

        def call(stages=None):
            if split:
                return ka.split(prims, ctx, rgs2, gs, state, cfg, ax, stages)
            return ka.merge(prims, ctx, rgs2, gs, state, data, cfg, ax,
                            stages)

        # The parameters read and written, the cells' mask, sides,
        # assignment in and out; a split's [m] rows (~14 read or written),
        # a merge's [2, m] rows (~16) and its cells' ll2, sides and terms.
        plane = K_MAX * M * 4
        moved = 2 * plane + N * 13 + (14 * M * 4 if split
                                      else 32 * M * 4 + N * 28)
        name = "split" if split else "merge"
        out[name] = {"kernel_ms": kernel_device_ms(call, "sm_accept_kernel"),
                     "kernel_graph_ms": mh_graph_ms(call, 20),
                     "kernel_ops": mh_kernels_per_call(call),
                     "twin_graph_ms": mh_graph_ms(lambda: call(ka.TWIN), 1),
                     "twin_ops": mh_kernels_per_call(lambda: call(ka.TWIN)),
                     "bytes_bound_ms": moved / HBM_BYTES_PER_S * 1e3}
        log(f"  sm_accept {name} after the final scan at {N:,} x {M}, k_max "
            f"{K_MAX}, one chain ({smi}): "
            + ", ".join(f"{k} {v}" for k, v in out[name].items()))
    return out


def phase_sm_accept(dev, smi):
    """Kernel 12 (csrc/sm_accept.cu) against its plain twin's stages on
    the card, bit for bit: both branches at the main cell, one chain and a
    batch of 4, Beta(0.25, 0.25) and uniform priors, a padded column mask,
    from seeded launch states; the acceptance forced each way and a
    degenerate split; inside a CUDA graph; the runner's captured block
    against its eager one; along a real chain past burn-in
    (SM_CHAIN_STEPS steps, at least SM_CHAIN_MOVES moves, every one
    checked, each branch's launches of kernels 7, 8, 9 and 12 counted) and
    a batch of 4; then kernel 12's own time a call and the route's in a
    graph against the twin's."""
    import dataclasses

    import torch

    from bnpc_tpu_torch.ops import cuda_sm_accept

    cfg, _ = bench_configs()
    uniform = dataclasses.replace(cfg, p=1.0, q=1.0)
    mask = torch.ones(M, device=dev)
    mask[-3:] = 0.0
    flags, errs = {}, []
    for seed in SM_SEEDS:
        for chains in (0, 4):
            for split in (True, False):
                case = rg_move_inputs(dev, N, M, K_MAX, 10, seed, chains,
                                      split)
                for name, c, mk in (("beta", cfg, None),
                                    ("uniform", uniform, None),
                                    ("masked", cfg, mask)):
                    ax = rest_axis(chains, mk)
                    tag = (f"{'split' if split else 'merge'} {name} seed "
                           f"{seed} chains {chains}")
                    flags[tag], err = sm_check(tag, split, case, c, ax,
                                               seed + 90, chains, dev)
                    errs.append(err)
                for u in (0.0, 1.0):
                    tag = (f"{'split' if split else 'merge'} forced u={u} "
                           f"seed {seed} chains {chains}")
                    flags[tag], err = sm_check(tag, split, case, cfg,
                                               rest_axis(chains), seed + 91,
                                               chains, dev, forced=u)
                    errs.append(err)
    seen = {f for v in flags.values() for f in v}
    if seen != {0, 1}:
        raise AssertionError(f"sm_accept: outcomes seen {seen}, not both")
    sm_degenerate(dev, cfg, 43)
    for chains in (0, 4):
        sm_graph(dev, cfg, chains, 47)
    log(f"  sm_accept == the twin's stages on the card bit for bit "
        f"(state, MH counts, generators; splits and merges, one chain and "
        f"4; Beta and uniform priors; a padded mask; forced uniforms; flags "
        f"{flags}); a degenerate split declined; in a CUDA graph, two "
        f"replays")
    per_step = mh_captured(dev, cuda_sm_accept)
    log(f"  sm_accept in the captured block: == eager bit for bit, "
        f"{per_step} launches a step counted under replay")
    t0 = time.perf_counter()
    calls, per_branch = sm_chain(dev, 0, SM_CHAIN_STEPS, 2147483011)
    calls_4, per_branch_4 = sm_chain(dev, 4, SM_BATCH_STEPS, 2147484011)
    if sum(calls.values()) < SM_CHAIN_MOVES or not all(calls_4.values()):
        raise AssertionError(f"sm_accept chain: moves {calls}, batch "
                             f"{calls_4}")
    log(f"  along a real chain past burn-in at {N:,} x {M}: {calls} moves "
        f"of one chain, {calls_4} of a batch of 4, each kernel route == the "
        f"twin's bit for bit; launches a branch, its final scan included: "
        f"{per_branch} ({time.perf_counter() - t0:.1f} s)")
    timing = sm_timing(dev, smi, cfg)
    split, merge = timing["split"], timing["merge"]
    return {"max_abs_err": max(errs), "launches_per_step": per_step,
            "chain_calls": calls, "batch_calls": calls_4,
            "launches_per_branch": per_branch,
            "launches_per_branch_batch": per_branch_4, "timing": timing,
            "ms": split["kernel_ms"], "plain_ms": split["twin_graph_ms"],
            "bound_ms": split["bytes_bound_ms"], "bound_by": "bytes",
            "fields": {"route_ms": split["kernel_graph_ms"],
                       "merge_ms": merge["kernel_ms"],
                       "merge_route_ms": merge["kernel_graph_ms"],
                       "merge_plain_ms": merge["twin_graph_ms"],
                       "merge_bound_ms": merge["bytes_bound_ms"]}}


# ---------------------------------------------------------------------------
# Phase 4: small input, GPU against CPU on identical draws
# ---------------------------------------------------------------------------


def gpu_against_cpu(steps, state, dev, tag, params_atol):
    """12 steps of steps[d] (a step body on device d), each from the CPU's
    state on identical draws (HostDraws): assignments, sizes and MH counts
    exactly, every float to rtol 1e-4 (params also to `params_atol`).
    Returns (gibbs / split / merge step counts, params' largest
    difference)."""
    import torch

    kinds = np.zeros(3, int)
    worst = 0.0
    for s in range(12):
        out = {}
        for d in ("cpu", dev):
            st = type(state)(*(t.to(d) for t in state))
            out[d] = steps[d](st, HostDraws(100 + s, d))
        (cs, cr), (gs, gr) = out["cpu"], out[dev]
        for f in ("assignment", "cluster_size"):
            if not torch.equal(getattr(cs, f), getattr(gs, f).cpu()):
                raise AssertionError(f"{tag} step {s}: {f} differs")
        if not torch.equal(cr.mh_counts, gr.mh_counts.cpu()):
            raise AssertionError(f"{tag} step {s}: mh_counts differ")
        torch.testing.assert_close(gs.params.cpu(), cs.params, rtol=1e-4,
                                   atol=params_atol)
        worst = max(worst, (gs.params.cpu() - cs.params).abs().max().item())
        for a, b in [(cs.dp_alpha, gs.dp_alpha), (cs.fp, gs.fp),
                     (cs.fn, gs.fn), (cr.ml, gr.ml), (cr.map_, gr.map_)]:
            torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=0)
        c = cr.mh_counts.numpy()
        kinds += [c[1:3].sum() == 0, c[1].sum() > 0, c[2].sum() > 0]
        state = cs
    return kinds.tolist(), worst


def phase_small(dev, gibbs_impl):
    import torch

    from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.mcmc import make_step_fn, resolve_trace_k
    from bnpc_tpu_torch.state import init_state

    n, m = 40, 16
    data, _ = make_data(n, m, 3, 0.1, seed=3)
    cfg = ModelConfig(n_cells=n, n_muts=m, k_max=n, p=0.25, q=0.25,
                      fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
                      fn_sd=0.1)
    # "blocked": the step's Gibbs move is the blocked sweep, 8 cells a block.
    mc = MCMCConfig(**MIX, gibbs_block=8 if gibbs_impl == "blocked" else 0)
    trace_k = resolve_trace_k(cfg, mc)
    packed = {d: pack_data(data, d) for d in ("cpu", dev)}
    steps = {d: make_step_fn(cfg, mc, packed[d], trace_k,
                             gibbs_impl=gibbs_impl)
             for d in ("cpu", dev)}
    state = init_state(TorchDraws(0, "cpu"), cfg, packed["cpu"], "cpu")
    kinds, _ = gpu_against_cpu(steps, state, dev, f"small {gibbs_impl}", 0.0)
    log(f"  gibbs_impl={gibbs_impl!r}: 12 steps GPU == CPU "
        f"(gibbs/split/merge steps: {kinds})")


# ---------------------------------------------------------------------------
# Phases 5-7: the paths
# ---------------------------------------------------------------------------


def check_state(state, rows_list, n, k_max):
    """State invariants: sizes agree with the assignment, params inside
    [TMIN, TMAX], a finite ML/MAP trace."""
    from bnpc_tpu_torch.config import TMAX, TMIN

    a = state.assignment.cpu().numpy()
    sizes = state.cluster_size.cpu().numpy()
    params = state.params.cpu().numpy()
    if not (np.array_equal(sizes, np.bincount(a, minlength=k_max))
            and sizes.sum() == n):
        raise AssertionError("cluster sizes disagree with the assignment")
    if not ((params >= TMIN - 1e-7).all() and (params <= TMAX + 1e-7).all()):
        raise AssertionError("params outside [TMIN, TMAX]")
    for rows in rows_list:
        if not (np.isfinite(rows["ml"]).all()
                and np.isfinite(rows["map_"]).all()):
            raise AssertionError("non-finite ML/MAP in the trace")
    return a, sizes


def syncs_per_step(run, steps):
    """Host synchronizations per step of `run(steps)`, counted by torch's
    sync debug mode (its bookkeeping is kept out of the timed windows)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught) / steps


class ScanLengths:
    """While active, notes the s_count of every restricted scan of the
    split-merge move (a launch of kernel 2's own entry or of kernel 9) in
    a device buffer at a device position (one small device copy a launch,
    no host read). The noting runs inside the captured block's graphs too,
    so it counts every replay; it must be active when the runner first runs
    (captures) its split-merge pieces. One chain's moves only. `reset()`
    starts over; `read()` fetches the notes once, afterwards."""

    def __init__(self, dev, cap=4096):
        import torch

        self.buf = torch.zeros((cap,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((1,), dtype=torch.long, device=dev)

    def __enter__(self):
        import torch

        from bnpc_tpu_torch.models import splitmerge
        from bnpc_tpu_torch.ops import cuda_rg_assign

        self.scan = splitmerge.rg_scan
        self.assign = cuda_rg_assign.rg_assign
        last = self.buf.shape[0] - 1

        def note(s_count):
            self.buf.index_copy_(0, self.pos.clamp(max=last),
                                 s_count.reshape(1))
            self.pos.add_(1)

        def noting(dz_v, lau_v, dtab, s_count, count1):
            note(s_count)
            return self.scan(dz_v, lau_v, dtab, s_count, count1)

        def noting_assign(noise, bits, ll2, s_mask, *args):
            note(s_mask.sum(-1, dtype=torch.int32))
            return self.assign(noise, bits, ll2, s_mask, *args)

        splitmerge.rg_scan = noting
        cuda_rg_assign.rg_assign = noting_assign
        return self

    def __exit__(self, *exc):
        from bnpc_tpu_torch.models import splitmerge
        from bnpc_tpu_torch.ops import cuda_rg_assign

        splitmerge.rg_scan = self.scan
        cuda_rg_assign.rg_assign = self.assign

    def reset(self):
        self.pos.zero_()

    def read(self):
        count = int(self.pos.item())
        return self.buf[:min(count, self.buf.shape[0])].cpu().numpy()


def timed_path(name, run_block, state, draws, warm, timed, n, k_max, truth,
               sweep_kernel, scans):
    """Warm up, time, check and summarize one path. `run_block(state,
    draws, steps)` returns (state, rows, draws); `scans` is an active
    ScanLengths."""
    import torch

    from bnpc_tpu_torch.estimators import ari

    reset_launches()
    scans.reset()
    state, warm_rows, draws = run_block(state, draws, warm)
    torch.cuda.synchronize()
    warm_launches = read_launches()
    t0 = time.perf_counter()
    state, rows, draws = run_block(state, draws, timed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    s_counts = scans.read()
    rg = rg_kernel(n)
    if s_counts.size != launches[rg]:
        raise AssertionError(f"{name}: {s_counts.size} scan lengths noted, "
                             f"{launches[rg]} {rg} launches")
    check_launches(name, launches, {sweep_kernel, rg, "mh_sweep",
                                    *SM_KERNELS, *REST_KERNELS})
    a, sizes = check_state(state, [warm_rows, rows], n, k_max)

    sm_steps = int((rows["mh_counts"][:, 1:3].sum(axis=(1, 2)) > 0).sum())
    sweeps = timed - sm_steps
    timed_l = {k: launches[k] - warm_launches[k] for k in launches}
    out = {
        "steps_per_s": timed / seconds,
        "timed_seconds": seconds,
        "gibbs_sweeps": sweeps,
        "sm_moves": sm_steps,
        "launches_path": launches,
        "launches_per_sweep": timed_l[sweep_kernel] / max(sweeps, 1),
        "rg_kernel": rg,
        "rg_launches_per_sm_move": timed_l[rg] / max(sm_steps, 1),
        "host_syncs_per_step": syncs_per_step(
            lambda k: run_block(state, draws, k), 16),
        "clusters": int((sizes > 0).sum()),
        "ari": ari(a, truth),
        "s_count_mean": float(s_counts.mean()),
        "s_count_median": float(np.median(s_counts)),
        "s_count_max": int(s_counts.max()),
    }
    log(f"  steps/s {out['steps_per_s']:.3f} ({timed} timed steps, "
        f"{seconds:.3f} s, after {warm} warm-up; {sweeps} Gibbs sweeps, "
        f"{sm_steps} split-merge moves)")
    log(f"  launches on this path: {launches}; {sweep_kernel} per Gibbs "
        f"sweep {out['launches_per_sweep']:.3f}; {rg} per split-merge "
        f"{out['rg_launches_per_sm_move']:.3f}")
    log(f"  host syncs per step {out['host_syncs_per_step']:.3f}; clusters "
        f"{out['clusters']}; ARI vs truth {out['ari']:.4f}")
    log(f"  s_count over the {s_counts.size} {rg} launches: mean "
        f"{out['s_count_mean']:.1f}, median {out['s_count_median']:.1f}, "
        f"max {out['s_count_max']}")
    return out


def phase_main(dev):
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.draws import TorchDraws
    from bnpc_tpu_torch.mcmc import MCMCRunner

    data, truth = make_data(N, M, 10, 0.1, seed=0)
    cfg, mc = bench_configs()
    runner = MCMCRunner(cfg, mc, pack_data(data, dev), device=dev,
                        block_size=256)

    # Active from the runner's first step: its graphs note the scans.
    with ScanLengths(dev) as scans:
        # The user-facing entry point once, at a short length.
        res = runner.run((32, 16), seed=0)[0]
        if res.assignments.shape != (33, N) or res.params.shape[0] != 17 \
                or not np.isfinite(res.ML).all():
            raise AssertionError("run(): unexpected result shapes or "
                                 "values")
        return timed_path("main", runner.run_block,
                          runner.init_chains(TorchDraws(0, dev))[0],
                          TorchDraws(1, dev), 256, 256, N, K_MAX, truth,
                          "lazy_segment", scans)


def phase_large(dev):
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.draws import TorchDraws
    from bnpc_tpu_torch.mcmc import MCMCRunner
    from bnpc_tpu_torch.models.gibbs import resolve_impl

    data, truth = make_data(N_LARGE, M, 20, 0.1, seed=0)
    cfg, mc = bench_configs(N_LARGE, K_LARGE)
    if resolve_impl("auto", cfg, on_cuda=True) != "stream":
        raise AssertionError("the large-n path must resolve to 'stream'")
    runner = MCMCRunner(cfg, mc, pack_data(data, dev), device=dev,
                        block_size=64)
    with ScanLengths(dev) as scans:
        out = timed_path("large", runner.run_block,
                         runner.init_chains(TorchDraws(0, dev))[0],
                         TorchDraws(1, dev), 16, 64, N_LARGE, K_LARGE,
                         truth, "lazy_stream", scans)
    # The scan alone at the lengths this path really gave it.
    for key in ("mean", "max"):
        s_count = int(out[f"s_count_{key}"])
        out[f"rg_scan_ms_at_s_count_{key}"] = rg_time(N_LARGE, s_count, 6,
                                                      dev, 21)
        log(f"  rg_scan at n={N_LARGE}, s_count={s_count} (this path's "
            f"{key}): {out[f'rg_scan_ms_at_s_count_{key}']:.4f} ms")
    return out


def phase_eager(dev):
    """The eager path through its entry point, make_block_fn(gibbs_impl=
    "eager"): on the card the captured block, kernel 4 inside a replayed
    graph (each replay counts its launch)."""
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.draws import TorchDraws
    from bnpc_tpu_torch.mcmc import make_block_fn, resolve_trace_k
    from bnpc_tpu_torch.state import init_state

    data, truth = make_data(N, M, 10, 0.1, seed=0)
    cfg, mc = bench_configs()
    packed = pack_data(data, dev)
    state = init_state(TorchDraws(0, dev).split(1)[0], cfg, packed, dev)
    # Active from the block's first step: its graphs note the scans.
    with ScanLengths(dev) as scans:
        block = make_block_fn(cfg, mc, packed, resolve_trace_k(cfg, mc),
                              gibbs_impl="eager")
        return timed_path("eager", block, state, TorchDraws(1, dev), 64,
                          256, N, K_MAX, truth, "eager_sweep", scans)


def phase_probes():
    """Each probe's main() on the card, its launch counters set to 0
    before it: each runs its own kernel and lazy_segment."""
    from bnpc_tpu_torch.probes import vecflow_probe, while_probe

    out = {}
    for name, mod, used in (("vecflow", vecflow_probe,
                             {"vecflow", "lazy_segment"}),
                            ("while_exit", while_probe,
                             {"while_exit", "lazy_segment"})):
        reset_launches()
        res = mod.main([])
        launches = read_launches()
        check_launches(f"probe {name}", launches, used)
        out[name] = {**res, "launches_path": launches}
        log(f"  launches on this path: {launches}")
    out["chain"] = chain_bounds()
    return out


def chain_bounds():
    """The chain probe's cycles and, from them, the least time each
    kernel's serial chain can take at the shape phase 3 times it at."""
    from bnpc_tpu_torch.probes import chain_probe, vecflow_probe, while_probe

    res = chain_probe.main([])
    argmax, scan = res["argmax_chain_cycles"], res["scan_chain_cycles"]
    cells = {"lazy_segment": (N, argmax), "rg_scan": (N, scan),
             # Kernel 9's chain runs over S alone.
             "rg_assign": (RG_TIMED_S, scan),
             "lazy_stream": (N_LARGE, argmax), "eager_sweep": (N, argmax),
             # Every cell, and one argmax for the inert tail positions.
             "vecflow": (N + (N % vecflow_probe.BATCH != 0), argmax),
             "while_exit": (while_probe.N, argmax)}
    res["chain_bound_ms"] = {
        name: chain_probe.chain_bound_ms(n, cycles, res["clock_ghz"])
        for name, (n, cycles) in cells.items()}
    for name, ms in res["chain_bound_ms"].items():
        log(f"  chain bound {name}: {cells[name][0]:,} cells x "
            f"{cells[name][1]:.1f} cycles / {res['clock_ghz']:.4f} GHz = "
            f"{ms:.4f} ms")
    return res


# ---------------------------------------------------------------------------
# Phase 9: the CLI
# ---------------------------------------------------------------------------


def write_input(path, data):
    """The reference's input file: mutations x cells, space-separated, 3
    for missing; every cell one digit, so the text is built as bytes."""
    x = np.where(np.isnan(data), 3, data).astype(np.uint8).T
    buf = np.full((x.shape[0], 2 * x.shape[1]), ord(" "), np.uint8)
    buf[:, 0::2] = x + ord("0")
    buf[:, -1] = ord("\n")
    buf.tofile(path)


class Stages:
    """While active, times the CLI's stages: each function of `TARGETS` is
    wrapped so that its call ends in torch.cuda.synchronize() and its
    seconds add to its stage (nested stages count in both). Also keeps the
    arguments of the last generate_output call."""

    def __init__(self):
        from bnpc_tpu_torch import cli, diagnostics, estimators, io, mcmc

        self.targets = [
            (io, "load_data", "load"),
            (cli, "pack_data", "pack"),
            (mcmc.MCMCRunner, "run", "sample"),
            (diagnostics, "lugsail_psrf", "psrf"),
            (estimators, "mpear_assignment", "mpear"),
            (estimators, "_sim_to_cols_device", "similarity"),
            (estimators, "_ward_cuts", "ward_tree"),
            (estimators, "_extend", "extend_score"),
            (estimators, "_mpear_scores_pairs", "extend_score"),
            (estimators, "_mpear_scores_batch", "extend_score"),
            (estimators, "consensus_genotypes", "consensus"),
            (estimators, "latents_point", "point"),
            (io, "save_run", "write"),
        ]
        self.seconds = {}
        self.output_args = None
        self._cli = cli

    def _wrap(self, fn, stage):
        import torch

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            key = stage
            if stage == "point":  # latents_point(results, est, ...)
                key = f"point_{args[1]}"
            self.seconds[key] = (self.seconds.get(key, 0.0)
                                 + time.perf_counter() - t0)
            return out

        return timed

    def __enter__(self):
        self._saved = [(o, a, getattr(o, a)) for o, a, _ in self.targets]
        for owner, attr, stage in self.targets:
            setattr(owner, attr, self._wrap(getattr(owner, attr), stage))
        generate = self._cli.generate_output

        def keep(*args):
            self.output_args = args
            return generate(*args)

        self._saved.append((self._cli, "generate_output", generate))
        self._cli.generate_output = keep
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)

    def line(self):
        """One line of stage seconds; consensus and MPEAR without the
        stages inside them."""
        s = dict(self.seconds)
        inner = sum(s.get(k, 0.0) for k in ("similarity", "ward_tree",
                                              "extend_score"))
        s["mpear_rest"] = s.get("mpear", 0.0) - inner
        s["consensus_rest"] = s.get("consensus", 0.0) - s.get("mpear", 0.0)
        order = ["load", "pack", "sample", "psrf", "similarity", "ward_tree",
                 "extend_score", "mpear_rest", "consensus_rest", "point_ML",
                 "point_MAP", "write"]
        return {k: round(s[k], 4) for k in order if k in s}


def read_geno(path, n, m):
    """A genotypes_*.tsv as written: a header of n cell labels, m rows of
    a mutation label and n numbers."""
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [np.fromstring(line.split("\t", 1)[1], sep="\t")
                for line in fh]
    if len(header) != n + 1 or len(rows) != m \
            or any(r.size != n for r in rows):
        raise AssertionError(f"{path}: not {m} x {n}")
    geno = np.stack(rows)
    if not np.isfinite(geno).all():
        raise AssertionError(f"{path}: non-finite genotypes")
    return geno


def check_outputs(out_dir, estimators_, n, m):
    """The files of bnpc_tpu's generate_output, parsed: one assignment of
    n cells and one finite m x n genotype table per estimator."""
    import pandas as pd

    names = set(os.listdir(out_dir))
    need = {"args.txt", "errors.txt", "assignment.txt"} | {
        f"genotypes_{e}_mean.tsv" for e in estimators_}
    if not need <= names:
        raise AssertionError(f"{out_dir}: missing {sorted(need - names)}")
    with open(os.path.join(out_dir, "args.txt")) as fh:
        keys = {ln.split(":", 1)[0] for ln in fh if ":" in ln}
    if not {"input", "steps", "PSRF", "chain_seeds", "time"} <= keys:
        raise AssertionError("args.txt lacks run keys")
    errors = pd.read_csv(os.path.join(out_dir, "errors.txt"), sep="\t")
    table = pd.read_csv(os.path.join(out_dir, "assignment.txt"), sep="\t")
    if list(errors["estimator"]) != list(estimators_) \
            or list(table["estimator"]) != list(estimators_):
        raise AssertionError("errors.txt / assignment.txt rows")
    assigns = {}
    for est, text in zip(table["estimator"], table["Assignment"]):
        a = np.array(text.split(" "), dtype=np.int64)
        if a.size != n:
            raise AssertionError(f"{est}: {a.size} assignments, not {n}")
        assigns[est] = a
        read_geno(os.path.join(out_dir, f"genotypes_{est}_mean.tsv"), n, m)
    return assigns


def compare_inferred(tag, gpu, cpu, psrf_gpu, psrf_cpu):
    """GPU against CPU estimators: assignments exactly, every float to
    rtol 1e-5, PSRF equal."""
    if psrf_gpu != psrf_cpu:
        raise AssertionError(f"{tag}: PSRF {psrf_gpu} != {psrf_cpu}")
    for chain in cpu:
        for est, want in cpu[chain].items():
            got = gpu[chain][est]
            if not np.array_equal(np.asarray(got["assignment"]),
                                  np.asarray(want["assignment"])):
                raise AssertionError(f"{tag} {est}: assignments differ")
            np.testing.assert_allclose(got["genotypes"].values,
                                       want["genotypes"].values, rtol=1e-5)
            for key in ("a", "FN", "FP", "FN_geno", "FP_geno"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=f"{tag} {est} {key}")


def cli_run(dev, tmp, cell, n, k_clones, argv, estimators_, sweep, smi,
            verbosity="0"):
    """One CLI run through bnpc_tpu_torch.cli.main on the card; its
    launches, outputs and stage times; with a verbosity above 0, its
    standard output (captured)."""
    import contextlib
    import io as pyio

    import torch

    from bnpc_tpu_torch import cli
    from bnpc_tpu_torch.estimators import ari

    t0 = time.perf_counter()
    data, truth = make_data(n, M, k_clones, 0.1, seed=0)
    path = os.path.join(tmp, f"{cell}.txt")
    write_input(path, data)
    made = time.perf_counter() - t0
    out_dir = os.path.join(tmp, f"{cell}_out")
    args = cli.parse_args([path, *argv, "-b", "0.33", "-np", "--seed", "0",
                           "-o", out_dir, "-v", verbosity, "--device", dev])
    reset_launches()
    text = pyio.StringIO()
    with Stages() as stages, (contextlib.redirect_stdout(text)
                              if verbosity != "0"
                              else contextlib.nullcontext()):
        t0 = time.perf_counter()
        cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    check_launches(f"cli {cell}", launches,
                   {sweep, rg_kernel(n), "mh_sweep", *SM_KERNELS,
                    *REST_KERNELS})
    assigns = check_outputs(out_dir, estimators_, n, M)
    score = ari(assigns["posterior"], truth)
    line = stages.line()
    log(f"  {cell}: {n:,} x {M}, argv {' '.join(argv)}; input made and "
        f"written in {made:.1f} s; cli.main {wall:.3f} s; launches {launches}"
        f"; posterior ARI vs planted clones {score:.4f}")
    log(f"  stage seconds ({cell}; {smi}): {json.dumps(line)}")
    return {"wall_s": wall, "stages_s": line, "launches": launches,
            "ari_posterior": score, "output_args": stages.output_args,
            "stdout": text.getvalue()}


def phase_cli(dev, smi):
    """Phase 9: the port's entry point on the card at the main cell and the
    large cell; then the main cell's chain result through infer_results
    on the card and on the CPU, on the landmark and on the exact MPEAR
    path."""
    import tempfile

    from bnpc_tpu_torch import io

    ests = ["posterior", "ML", "MAP"]
    with tempfile.TemporaryDirectory() as tmp:
        main_cell = cli_run(dev, tmp, "main", N, 10,
                            ["-s", "512", "-e", *ests], ests,
                            "lazy_segment", smi)
        args, results, data, _ = main_cell.pop("output_args")
        knob = "BNPC_TPU_MPEAR_EXACT_MAX"
        for path_name, exact_max in (("landmark", None), ("exact", "8192")):
            saved = os.environ.get(knob)
            if exact_max is not None:
                os.environ[knob] = exact_max
            try:
                secs, out = {}, {}
                for d in (dev, "cpu"):
                    t0 = time.perf_counter()
                    out[d] = io.infer_results(args, results, data, device=d)
                    secs[d] = time.perf_counter() - t0
            finally:
                if saved is None:
                    os.environ.pop(knob, None)
                else:
                    os.environ[knob] = saved
            compare_inferred(path_name, out[dev][0], out["cpu"][0],
                             out[dev][1], out["cpu"][1])
            main_cell[f"infer_{path_name}_s"] = secs
            post = out[dev][0]["mean"]["posterior"]["assignment"]
            main_cell[f"{path_name}_assignment"] = post
            log(f"  infer_results, {path_name} MPEAR path: GPU == CPU "
                f"(assignments exactly, floats rtol 1e-5, PSRF equal); "
                f"{secs[dev]:.3f} s on {dev}, {secs['cpu']:.3f} s on the "
                f"CPU; {np.unique(post).size} clusters")
        from bnpc_tpu_torch.estimators import ari

        main_cell["ari_landmark_vs_exact"] = ari(
            main_cell.pop("landmark_assignment"),
            main_cell.pop("exact_assignment"))
        log(f"  landmark against exact consensus at {N:,} cells: ARI "
            f"{main_cell['ari_landmark_vs_exact']:.4f}")
        large_cell = cli_run(dev, tmp, "large", N_LARGE, 20,
                             ["-s", "64", "--max_clusters", str(K_LARGE)],
                             ["posterior"], "lazy_stream", smi)
        large_cell.pop("output_args")
    return {"main": main_cell, "large": large_cell}


# ---------------------------------------------------------------------------
# Phase 10: the run modes
# ---------------------------------------------------------------------------


def same_results(tag, got, want):
    """Two runs' ChainResults, bit for bit."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} chains, not {len(want)}")
    for c, (g, w) in enumerate(zip(got, want)):
        for f in ("ML", "MAP", "DP_alpha", "FN", "FP", "assignments",
                  "params", "mh_counts"):
            if not np.array_equal(getattr(g, f), getattr(w, f)):
                raise AssertionError(f"{tag}: chain {c} {f} differs")
        if (g.burn_in, g.PSRF) != (w.burn_in, w.PSRF):
            raise AssertionError(f"{tag}: chain {c} burn-in or PSRF differs")


class KeepStates:
    """Wraps runner.run_chains: the chain states of its last block stay in
    `states`, the seconds of each block in `block_s`."""

    def __init__(self, runner):
        import torch

        self.states, self.block_s = None, []
        run_chains = runner.run_chains

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = run_chains(*args, **kwargs)
            torch.cuda.synchronize()
            self.block_s.append(time.perf_counter() - t0)
            self.states = out[0]
            return out

        runner.run_chains = wrapped


class CheckpointCost:
    """Wraps runner.save_checkpoint: seconds and file bytes of each save."""

    def __init__(self, runner):
        self.saves = []
        save = runner.save_checkpoint

        def timed(path, *args, **kwargs):
            t0 = time.perf_counter()
            save(path, *args, **kwargs)
            self.saves.append({"done": int(args[3]),
                               "s": time.perf_counter() - t0,
                               "bytes": os.path.getsize(path)})

        runner.save_checkpoint = timed


def check_results(tag, results, states, n, k_max, rows):
    """Each chain's final state invariants (check_state) and its trace:
    `rows` finite ML / MAP rows, assignments inside the slots, params
    inside [0, 1] (recorded in f16)."""
    for c, (res, st) in enumerate(zip(results, states)):
        check_state(st, [], n, k_max)
        if res.ML.shape != (rows,) or res.assignments.shape != (rows, n) \
                or not (np.isfinite(res.ML).all()
                        and np.isfinite(res.MAP).all()):
            raise AssertionError(f"{tag}: chain {c} trace shapes / values")
        if res.assignments.min() < 0 or res.assignments.max() >= k_max \
                or not ((res.params >= 0) & (res.params <= 1)).all():
            raise AssertionError(f"{tag}: chain {c} assignments / params")
        if res.params.shape[0] != rows - res.burn_in:
            raise AssertionError(f"{tag}: chain {c} kept params rows")


def modes_runner(data, cfg, mc, dev, **kwargs):
    """A runner of phase 10: its chains one after another (phase 12 runs
    the batched form)."""
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.mcmc import MCMCRunner

    kwargs.setdefault("chain_exec", "sequential")
    return MCMCRunner(cfg, mc, pack_data(data, dev), device=dev, **kwargs)


def mode_chains(dev, data, cfg, mc):
    """(a) 4 chains x 256 steps through run(); chain 1 against the
    one-chain run with its seed."""
    import torch

    runner = modes_runner(data, cfg, mc, dev)
    kept = KeepStates(runner)
    # Each chain's block seconds inside the 4-chain run (the chains' own
    # trajectories differ in cost: births, split-merge lengths).
    chain_s = []
    run_block = runner.run_block

    def timed_block(*args, **kwargs):
        t0 = time.perf_counter()
        out = run_block(*args, **kwargs)
        torch.cuda.synchronize()
        chain_s.append(time.perf_counter() - t0)
        return out

    runner.run_block = timed_block
    reset_launches()
    t0 = time.perf_counter()
    res = runner.run((256, 85), seed=7, n_chains=4)
    chains_s = time.perf_counter() - t0
    launches = read_launches()
    check_launches("chains", launches,
                   {"lazy_segment", "rg_assign", "mh_sweep", *SM_KERNELS,
                    *REST_KERNELS})
    check_results("chains", res, kept.states, N, K_MAX, 257)
    seeds = runner.seeds.tolist()
    one = modes_runner(data, cfg, mc, dev)
    t0 = time.perf_counter()
    alone = one.run((256, 85), seed=seeds[1])
    one_s = time.perf_counter() - t0
    same_results("chain 1 against its one-chain run", [res[1]], alone)
    out = {"chain_steps_per_s": 4 * 256 / chains_s,
           "one_chain_steps_per_s": 256 / one_s, "seeds": seeds,
           "chain_block_s": chain_s, "one_chain_s": one_s,
           "launches": launches}
    log(f"  (a) chains: 4 x 256 steps in {chains_s:.3f} s, "
        f"{out['chain_steps_per_s']:.3f} chain-steps/s; one chain "
        f"{out['one_chain_steps_per_s']:.3f} steps/s in the same call; "
        f"invariants hold for each chain; launches {launches}; chain 1 == "
        f"the one-chain run with seed {seeds[1]}: ok")
    log(f"      each chain's 256 steps inside the run: "
        f"{[round(x, 3) for x in chain_s]} s; chain 1 alone {one_s:.3f} s")
    return out


def mode_coupled(dev, data, cfg, mc):
    """(b) 2 coupled chains x 64 steps."""
    import dataclasses

    runner = modes_runner(data, cfg, dataclasses.replace(
        mc, coupled_moves=True), dev, block_size=64)
    kept = KeepStates(runner)
    reset_launches()
    t0 = time.perf_counter()
    res = runner.run((64, 21), seed=8, n_chains=2)
    secs = time.perf_counter() - t0
    launches = read_launches()
    check_launches("coupled", launches,
                   {"lazy_segment", "rg_assign", "mh_sweep", *SM_KERNELS,
                    *REST_KERNELS})
    check_results("coupled", res, kept.states, N, K_MAX, 65)
    out = {"chain_steps_per_s": 2 * 64 / secs, "launches": launches}
    log(f"  (b) coupled: 2 x 64 steps, {out['chain_steps_per_s']:.3f} "
        f"chain-steps/s; invariants hold; launches {launches}: ok")
    return out


def mode_checkpoint(dev, data, cfg, mc, tmp):
    """(c) 2 chains, block 64, a checkpoint every block: 128 steps, then a
    fresh runner resumes to 192 (aligned) and, from the same 128-step
    checkpoint, to 160 (a partial block); each against an uninterrupted
    run."""
    import shutil

    ck, ck2 = os.path.join(tmp, "ck"), os.path.join(tmp, "ck160")
    kw = dict(block_size=64, checkpoint_every=1)
    first = modes_runner(data, cfg, mc, dev, checkpoint_dir=ck, **kw)
    cost = CheckpointCost(first)
    first.run((128, 43), seed=9, n_chains=2)
    os.makedirs(ck2)
    shutil.copy(os.path.join(ck, "mcmc_state.npz"), ck2)
    out = {}
    for steps, path in ((192, ck), (160, ck2)):
        resumed = modes_runner(data, cfg, mc, dev, checkpoint_dir=path, **kw)
        again = CheckpointCost(resumed)
        got = resumed.run((steps, 43), seed=9, n_chains=2)
        want = modes_runner(data, cfg, mc, dev, **kw).run(
            (steps, 43), seed=9, n_chains=2)
        same_results(f"resume to {steps}", got, want)
        cost.saves += again.saves
        out[f"resume_{steps}"] = "ok"
    out["saves"] = cost.saves
    log(f"  (c) checkpoint: 128 steps resumed to 192 (aligned) and to 160 "
        "(partial final block) == the uninterrupted runs, bit for bit: ok")
    for save in cost.saves:
        log(f"      checkpoint at step {save['done']}: {save['s']:.3f} s, "
            f"{save['bytes']:,} bytes")
    return out


def mode_time(dev, data, cfg, mc):
    """(d) 2 chains, a 10 s deadline, 3 s of burn-in, blocks of 32."""
    from datetime import datetime, timedelta

    runner = modes_runner(data, cfg, mc, dev, block_size=32)
    kept = KeepStates(runner)
    readings = []
    runner._now = lambda: readings.append(datetime.now()) or readings[-1]
    start = datetime.now()
    end = start + timedelta(seconds=10)
    res = runner.run((end, start + timedelta(seconds=3)), seed=10,
                     n_chains=2)
    returned = datetime.now()
    steps = res[0].ML.size - 1
    check_results("time", res, kept.states, N, K_MAX, steps + 1)
    # The last block's end is the last t_after reading before the loop
    # check that stopped the run.
    block_end = readings[-2]
    overshoot = (block_end - end).total_seconds()
    if not 0 <= overshoot <= max(kept.block_s):
        raise AssertionError(f"time: overshoot {overshoot:.3f} s against "
                             f"blocks of up to {max(kept.block_s):.3f} s")
    out = {"steps": steps, "burn_in": res[0].burn_in,
           "overshoot_s": overshoot,
           "return_after_deadline_s": (returned - end).total_seconds(),
           "block_s_max": max(kept.block_s), "blocks": len(kept.block_s)}
    log(f"  (d) time: {steps} steps kept, burn-in {res[0].burn_in}; "
        f"{len(kept.block_s)} blocks of up to {out['block_s_max']:.3f} s; "
        f"the last block ended {overshoot:.3f} s past the deadline, run() "
        f"returned {out['return_after_deadline_s']:.3f} s past it: ok")
    return out


def mode_lugsail(dev, data, cfg, mc):
    """(e) 2 chains until the lugsail PSRF of ML is below 1.1."""
    runner = modes_runner(data, cfg, mc, dev)
    kept = KeepStates(runner)
    t0 = time.perf_counter()
    res = runner.run((1.1, 0), seed=11, n_chains=2)
    secs = time.perf_counter() - t0
    rows = res[0].ML.size
    check_results("lugsail", res, kept.states, N, K_MAX, rows)
    if res[0].PSRF[-1][1] > 1.1 or res[0].burn_in != rows // 2 + 1:
        raise AssertionError(f"lugsail: PSRF {res[0].PSRF}, burn-in "
                             f"{res[0].burn_in} of {rows} rows")
    log(f"  (e) lugsail: cutoff 1.1, PSRF log {res[0].PSRF}; stopped at "
        f"step {rows - 1}, burn-in {res[0].burn_in}, {secs:.3f} s: ok")
    return {"psrf": [(st, v if np.isfinite(v) else None)
                     for st, v in res[0].PSRF], "steps": rows - 1,
            "burn_in": res[0].burn_in, "seconds": secs}


def mode_blocked(dev, n, k_clones, k_max, block, warm, timed, sweep):
    """(f) steps/s of the blocked sweep (gibbs_block = `block`) beside the
    exact path's, the same steps from the same state in this call, both
    through the captured block; launches (the blocked Gibbs move launches
    no Gibbs kernel); ARI."""
    import dataclasses

    import torch

    from bnpc_tpu_torch.draws import TorchDraws
    from bnpc_tpu_torch.estimators import ari

    data, truth = make_data(n, M, k_clones, 0.1, seed=0)
    cfg, mc = bench_configs(n, k_max)
    out = {}
    for name, blk in (("exact", 0), ("blocked", block)):
        runner = modes_runner(data, cfg, dataclasses.replace(
            mc, gibbs_block=blk), dev, block_size=warm + timed)
        (state,) = runner.init_chains(TorchDraws(0, dev))
        draws = TorchDraws(1, dev)
        state, _, draws = runner.run_block(state, draws, warm)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, rows, _ = runner.run_block(state, draws, timed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        gibbs = int((rows["mh_counts"][:, 1:3].sum(axis=(1, 2)) == 0).sum())
        a, sizes = check_state(state, [rows], n, k_max)
        used = ({rg_kernel(n), "mh_sweep", *SM_KERNELS} if gibbs < timed
                else {"mh_sweep"}) | REST_KERNELS
        if name == "exact" and gibbs:
            used.add(sweep)
        check_launches(f"blocked {n} {name}", launches, used)
        out[name] = {"steps_per_s": timed / secs, "gibbs_sweeps": gibbs,
                     "launches": launches, "ari": ari(a, truth),
                     "clusters": int((sizes > 0).sum())}
    log(f"  (f) blocked at {n:,} x {M}, k_max {k_max}, gibbs_block {block}, "
        f"both captured: {out['blocked']['steps_per_s']:.3f} steps/s "
        f"against the exact "
        f"path's {out['exact']['steps_per_s']:.3f} ({timed} steps after "
        f"{warm}, {out['blocked']['gibbs_sweeps']} / "
        f"{out['exact']['gibbs_sweeps']} Gibbs sweeps); launches blocked "
        f"{out['blocked']['launches']}, exact {out['exact']['launches']}; "
        f"ARI vs planted clones {out['blocked']['ari']:.4f} (exact "
        f"{out['exact']['ari']:.4f}): ok")
    return out


def mode_cli(dev, tmp, smi):
    """(g) bnpc_tpu_torch.cli.main with -n 2 and a checkpoint directory."""
    ck = os.path.join(tmp, "cli_ck")
    cell = cli_run(dev, tmp, "modes", N, 10,
                   ["-n", "2", "-s", "256", "--checkpoint_dir", ck, "-e",
                    "posterior"], ["posterior"], "lazy_segment", smi)
    args = cell.pop("output_args")[0]
    if len(args.chain_seeds) != 2 or not np.isfinite(args.PSRF) \
            or not os.path.exists(os.path.join(ck, "mcmc_state.npz")):
        raise AssertionError(f"cli modes: chain_seeds {args.chain_seeds}, "
                             f"PSRF {args.PSRF}, checkpoint files "
                             f"{os.listdir(ck) if os.path.isdir(ck) else []}")
    log(f"  (g) cli -n 2 --checkpoint_dir: files parsed, chain_seeds "
        f"{args.chain_seeds}, PSRF {args.PSRF:.5f}, checkpoint written: ok")
    return {"wall_s": cell["wall_s"], "psrf": float(args.PSRF),
            "ari_posterior": cell["ari_posterior"]}


def phase_modes(dev, smi):
    """Phase 10: multi-chain, coupled, checkpoint / resume, time and
    lugsail modes and the blocked sweep at the main cell's width, and one
    CLI run of them."""
    import tempfile

    t0 = time.perf_counter()
    data, _ = make_data(N, M, 10, 0.1, seed=0)
    cfg, mc = bench_configs(N, K_MAX)
    out = {"chains": mode_chains(dev, data, cfg, mc),
           "coupled": mode_coupled(dev, data, cfg, mc)}
    with tempfile.TemporaryDirectory() as tmp:
        out["checkpoint"] = mode_checkpoint(dev, data, cfg, mc, tmp)
        out["time"] = mode_time(dev, data, cfg, mc)
        out["lugsail"] = mode_lugsail(dev, data, cfg, mc)
        out["blocked_main"] = mode_blocked(dev, N, 10, K_MAX, 128, 8, 32,
                                           "lazy_segment")
        out["blocked_large"] = mode_blocked(dev, N_LARGE, 20, K_LARGE, 512,
                                            2, 8, "lazy_stream")
        out["cli"] = mode_cli(dev, tmp, smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 10: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the mesh (ranks sharing the card)
# ---------------------------------------------------------------------------

MESH_STEPS = 128


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def state_hash(st) -> str:
    """Hash of a state's replicated fields: assignment, sizes, alpha, FP,
    FN."""
    import hashlib

    h = hashlib.sha256()
    for t in (st.assignment, st.cluster_size, st.dp_alpha, st.fp, st.fn):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


class BlockHashes:
    """Wraps runner.run_chains: each block's chain state hashes, and the
    all-reduces issued so far after each block."""

    def __init__(self, runner):
        from bnpc_tpu_torch.parallel import axis

        self.hashes, self.all_reduces = [], []
        run_chains = runner.run_chains

        def wrapped(*args, **kwargs):
            out = run_chains(*args, **kwargs)
            self.hashes.append([state_hash(st) for st in out[0]])
            self.all_reduces.append(axis.all_reduces)
            return out

        runner.run_chains = wrapped


def mesh_run(mesh, n, k_clones, k_max, run_var, seed, dev, block, n_chains=1,
             chain_exec="auto"):
    """One runner.run on this rank of `mesh`: (results or None, seconds,
    launches, all-reduces, their bytes, block hashes, runner)."""
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.mcmc import MCMCRunner
    from bnpc_tpu_torch.parallel import axis

    data, truth = make_data(n, M, k_clones, 0.1, seed=0)
    cfg, mc = bench_configs(n, k_max)
    runner = MCMCRunner(cfg, mc, pack_data(data, dev), device=dev,
                        block_size=block, mesh=mesh, chain_exec=chain_exec)
    hashes = BlockHashes(runner)
    reset_launches()
    axis.reset_counters()
    sync(dev)
    t0 = time.perf_counter()
    res = runner.run(run_var, seed=seed, n_chains=n_chains)
    sync(dev)
    secs = time.perf_counter() - t0
    for st in runner.final_states:
        check_state(st, [], n, k_max)
    out = {"seconds": secs, "launches": read_launches(),
           "all_reduces": axis.all_reduces,
           "all_reduce_bytes": axis.all_reduce_bytes,
           "hashes": list(hashes.hashes),
           "block_all_reduces": list(hashes.all_reduces), "results": res,
           "truth": truth, "seeds": runner.seeds.tolist(),
           "chain_launches": read_chain_launches(),
           "chain_exec": runner.chain_exec}
    return out, runner


def mesh_small(mesh, dev):
    """(d) 500 x 201 (padded to 202) over a 1 x 2 mesh, 12 steps, each
    from the CPU's state: the card against the CPU on identical draws
    (HostDraws, the shards' own streams too). Returns the step kinds."""
    import torch

    from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
    from bnpc_tpu_torch.data import pack_data, pad_muts
    from bnpc_tpu_torch.parallel import sharded
    from bnpc_tpu_torch.state import init_state

    n, m = 500, 201
    data, _ = make_data(n, m, 5, 0.1, seed=3)
    cfg = ModelConfig(n_cells=n, n_muts=m, k_max=128, p=0.25, q=0.25,
                      fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
                      fn_sd=0.1)
    mc = MCMCConfig(**MIX)
    blocks = {d: sharded.make_sharded_block(
        mesh, cfg, mc, pad_muts(pack_data(data, d), mesh.muts)[0])
        for d in ("cpu", dev)}
    full = init_state(TorchDraws(0, "cpu"), cfg, pack_data(data, "cpu"),
                      "cpu")
    w = 202 // mesh.muts
    params = torch.nn.functional.pad(full.params, (0, 1), value=0.5)
    state = full._replace(params=params[:, mesh.mut_index * w:
                                        (mesh.mut_index + 1) * w]
                          .contiguous())
    # A proposal is loc + scale * ndtri(u), computed at the scale of 1: near
    # TMIN the two devices' ndtri (last ulps apart) leave params a few
    # float32 ulps of 1.0 apart (4 measured on an H100), so params take
    # 1e-6 (8.4 ulps of 1.0) as their atol.
    kinds, worst = gpu_against_cpu({d: b.step for d, b in blocks.items()},
                                   state, dev, "mesh small", 1e-6)
    return {"kinds": kinds, "params_max_abs_diff": worst}


def mesh_rank(rank, world, port, tmp, dev):
    """One rank of phase 11's world: (a)-(d) in turn; its outputs to
    tmp/rank<r>.pkl. Any failure ends this process with an error, which
    fails the phase."""
    import pickle

    import torch.distributed as dist

    from bnpc_tpu_torch.parallel import axis, multihost, sharded

    multihost.initialize(f"localhost:{port}", world, rank, device=dev)
    out = {"backend": dist.get_backend()}
    # (a) chains over a 2 x 1 mesh.
    out["a"], _ = mesh_run(sharded.make_mesh(2, 1), N, 10, K_MAX,
                           (MESH_STEPS, 42), 21, dev, 256, n_chains=2)
    mesh = sharded.make_mesh(1, 2)
    # (b) mutations over a 1 x 2 mesh at the main cell, blocks of 32; then
    # 32 steps with every all-reduce timed (device synchronized around).
    out["b"], runner = mesh_run(mesh, N, 10, K_MAX, (MESH_STEPS, 0), 22,
                                dev, 32)
    axis.reset_counters()
    axis.timed = True
    try:
        runner.run((32, 0), seed=23)
    finally:
        axis.timed = False
    out["b"]["timed"] = {"all_reduces": axis.all_reduces,
                         "seconds": axis.all_reduce_seconds, "steps": 32}
    # (c) the large-n cell over the same mesh.
    out["c"], _ = mesh_run(mesh, N_LARGE, 20, K_LARGE, (16, 0), 24, dev, 16)
    # (d) the card against CPU gloo ranks, step by step.
    out["d"] = mesh_small(mesh, dev)
    # (e) a rank's local chains as one batch against one after another.
    out["e"] = mesh_batched(dev)
    for key in ("a", "b", "c"):
        out[key].pop("truth")
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# Phase 11 (e): (mesh shape, chains, steps) at the main cell.
MESH_BATCHES = (((2, 1), 4, 64), ((1, 2), 2, 64))


def mesh_batched(dev):
    """(e) on this rank: each of MESH_BATCHES under "vmap" and
    "sequential" (same seed), in blocks of 32; then, for each form, 16
    steps with every all-reduce timed (device synchronized around)."""
    from bnpc_tpu_torch.parallel import axis, sharded

    out = {}
    for shape, n_chains, steps in MESH_BATCHES:
        mesh = sharded.make_mesh(*shape)
        for ex in ("vmap", "sequential"):
            run, runner = mesh_run(mesh, N, 10, K_MAX, (steps, 0), 25, dev,
                                   32, n_chains=n_chains, chain_exec=ex)
            run.pop("truth")
            axis.reset_counters()
            axis.timed = True
            try:
                runner.run((16, 0), seed=26, n_chains=n_chains)
            finally:
                axis.timed = False
            run["timed"] = {"all_reduces": axis.all_reduces,
                            "seconds": axis.all_reduce_seconds, "steps": 16}
            out[shape, ex] = run
    return out


def mesh_batched_check(ranks, smi):
    """(e) in the parent: each chain of a batched run == its sequential run
    bit for bit; replicated state and the all-reduces after every block
    equal on the ranks of a mutation group; kernels 1 and 9 batched, on
    grids of at most a rank's chains (2), a grid of 2 among them;
    chain-steps/s and all-reduces a step of both forms."""
    out = {}
    for shape, n_chains, steps in MESH_BATCHES:
        tag = f"mesh {shape[0]}x{shape[1]}"
        runs = {ex: [r["e"][shape, ex] for r in ranks]
                for ex in ("vmap", "sequential")}
        for ex, (r0, r1) in runs.items():
            if r0["chain_exec"] != ex or r1["results"] is not None:
                raise AssertionError(f"{tag} {ex}: chain_exec "
                                     f"{r0['chain_exec']}; results on rank 1")
            if shape[1] > 1 and (r0["hashes"] != r1["hashes"]
                                 or r0["block_all_reduces"]
                                 != r1["block_all_reduces"]):
                raise AssertionError(
                    f"{tag} {ex}: the ranks differ: hashes {r0['hashes']} / "
                    f"{r1['hashes']}, all-reduces after each block "
                    f"{r0['block_all_reduces']} / {r1['block_all_reduces']}")
        if not close_results(f"{tag} vmap against sequential",
                             runs["vmap"][0]["results"],
                             runs["sequential"][0]["results"]):
            raise AssertionError(f"{tag}: vmap == sequential only to rtol "
                                 "1e-6, not bit for bit")
        for r, run in enumerate(runs["vmap"]):
            grids = run["chain_launches"]
            for name in ("lazy_segment", "rg_assign"):
                g = grids[name][1]
                if 2 not in g or max(g) > 2:
                    raise AssertionError(f"{tag} vmap rank {r}: {name} "
                                         f"grids {g}")
            check_launches(f"{tag} vmap rank {r}", run["launches"],
                           {"lazy_segment", "rg_assign", "mh_sweep",
                            *SM_KERNELS, *REST_KERNELS})
            if any(v for k, v in read_one_chain_launches_of(run).items()):
                raise AssertionError(f"{tag} vmap rank {r}: one-chain "
                                     "launches")
        cell = {}
        for ex, (r0, r1) in runs.items():
            secs = max(r0["seconds"], r1["seconds"])
            cell[ex] = {
                "chain_steps_per_s": n_chains * steps / secs,
                "all_reduces_per_step": r0["all_reduces"] / steps,
                "all_reduce_mb_per_step": r0["all_reduce_bytes"] / steps
                / 1e6,
                "all_reduce_ms_per_step": r0["timed"]["seconds"] * 1e3
                / r0["timed"]["steps"],
                "launches": [r0["launches"], r1["launches"]]}
        cell["launches_grids"] = [r["chain_launches"] for r in runs["vmap"]]
        cell["ratio"] = (cell["vmap"]["chain_steps_per_s"]
                         / cell["sequential"]["chain_steps_per_s"])
        out[f"{shape[0]}x{shape[1]}"] = cell
        v, q = cell["vmap"], cell["sequential"]
        log(f"  (e) {shape[0]} x {shape[1]}, {n_chains} chains x {steps} "
            f"steps at {N:,} x {M} ({smi}): vmap "
            f"{v['chain_steps_per_s']:.3f} chain-steps/s, sequential "
            f"{q['chain_steps_per_s']:.3f} (x{cell['ratio']:.3f}); "
            f"all-reduces a step {v['all_reduces_per_step']:.2f} / "
            f"{q['all_reduces_per_step']:.2f} "
            f"({v['all_reduce_mb_per_step']:.3f} / "
            f"{q['all_reduce_mb_per_step']:.3f} MB), their ms a step "
            f"{v['all_reduce_ms_per_step']:.3f} / "
            f"{q['all_reduce_ms_per_step']:.3f}")
        log(f"      each chain == its sequential-mesh run, bit for bit; "
            f"replicated state and all-reduces equal on the group's ranks "
            f"at every block; batched launches (kernel: (launches, {{grid: "
            f"launches}})) {cell['launches_grids'][0]}: ok")
    return out


def read_one_chain_launches_of(run):
    """The one-chain wrappers' launches of a rank's run: its launches less
    its batched ones."""
    return {name: run["launches"][name] - run["chain_launches"][name][0]
            for name in run["chain_launches"]}


def mesh_cli_batched(dev, tmp):
    """(f) run_bnpc_tpu_torch.py --mesh 1,2 -n 2 at the main cell (a
    process of its own): the chain_exec "auto" chose, one set of files."""
    import subprocess
    import sys

    data, _ = make_data(N, M, 10, 0.1, seed=0)
    path = os.path.join(tmp, "mesh_batched.txt")
    write_input(path, data)
    out_dir = os.path.join(tmp, "mesh_1x2_n2")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "run_bnpc_tpu_torch.py"), path,
         "-s", "32", "-b", "0.33", "-np", "--seed", "0", "-n", "2", "-o",
         out_dir, "-e", "posterior", "--mesh", "1,2", "--device", dev],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"run_bnpc_tpu_torch.py --mesh 1,2 -n 2: exit "
                             f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    check_outputs(out_dir, ["posterior"], N, M)
    printed = proc.stdout
    chosen = [ln.split(":", 1)[1].strip() for ln in printed.splitlines()
              if ln.strip().startswith("chain_exec:")]
    if printed.count("Writing output to") != 1 or len(chosen) != 1:
        raise AssertionError(f"run_bnpc_tpu_torch.py --mesh 1,2 -n 2: "
                             f"output:\n{printed[-2000:]}")
    log(f"  (f) run_bnpc_tpu_torch.py --mesh 1,2 -n 2 -s 32: {wall:.3f} s; "
        f"chain_exec {chosen[0]} (auto); one set of files (parsed), "
        "printed once: ok")
    return {"wall_s": wall, "chain_exec": chosen[0]}


def run_captured(fn):
    """fn() with file descriptor 1 (this process's and its children's
    standard output) sent to a file; returns that output."""
    import sys
    import tempfile

    sys.stdout.flush()
    with tempfile.TemporaryFile(mode="w+") as f:
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)
        try:
            fn()
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        return f.read()


def mesh_cli(dev, tmp):
    """(f) cli.main with --mesh 1,2 and --mesh 2,1 at the main cell: the
    CLI starts two ranks on the card; one set of files, printed once."""
    from bnpc_tpu_torch import cli

    data, truth = make_data(N, M, 10, 0.1, seed=0)
    path = os.path.join(tmp, "mesh_main.txt")
    write_input(path, data)
    out = {}
    for mesh, n_chains in (("1,2", 1), ("2,1", 2)):
        out_dir = os.path.join(tmp, f"mesh_{mesh.replace(',', 'x')}")
        args = cli.parse_args([path, "-s", "64", "-b", "0.33", "-np",
                               "--seed", "0", "-n", str(n_chains), "-o",
                               out_dir, "-e", "posterior", "--mesh", mesh,
                               "--device", dev])
        t0 = time.perf_counter()
        printed = run_captured(lambda: cli.main(args))
        wall = time.perf_counter() - t0
        writes = printed.count("Writing output to")
        check_outputs(out_dir, ["posterior"], N, M)
        if writes != 1 or "backend gloo" not in printed:
            raise AssertionError(f"cli --mesh {mesh}: 'Writing output to' "
                                 f"printed {writes} times; output:\n"
                                 f"{printed[-2000:]}")
        out[mesh] = {"wall_s": wall}
        log(f"  (f) cli --mesh {mesh} -n {n_chains} -s 64: {wall:.3f} s; "
            "one set of files (parsed), printed once, backend gloo: ok")
    return out


def phase_mesh(dev, smi):
    """Phase 11: two ranks sharing the card (gloo): (a) 2 x 1, each chain
    == its one-process run; (b) 1 x 2 at the main cell, replicated state
    equal across the ranks at every block, kernels 1 and 9 on each rank,
    all-reduces a step and their ms; (c) 1 x 2 at the large-n cell, kernel
    3 on each rank; (d) 500 x 201 on the card against the CPU, step by
    step; (e) 2 x 1 with 4 chains and 1 x 2 with 2, a rank's local chains
    as one batch against one after another; (f) the CLI with --mesh 1,2
    and 2,1, and run_bnpc_tpu_torch.py with --mesh 1,2 -n 2."""
    import pickle
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.mcmc import MCMCRunner

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        mp.start_processes(mesh_rank, args=(2, port, tmp, dev), nprocs=2,
                           start_method="spawn")
        world_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        backend = ranks[0]["backend"]

        # (a) each chain against its one-process run, in this process.
        data, truth = make_data(N, M, 10, 0.1, seed=0)
        cfg, mc = bench_configs(N, K_MAX)
        one = MCMCRunner(cfg, mc, pack_data(data, dev), device=dev,
                         chain_exec="sequential")
        want = one.run((MESH_STEPS, 42), seed=21, n_chains=2)
        a0, a1 = ranks[0]["a"], ranks[1]["a"]
        if a1["results"] is not None or a0["seeds"] != one.seeds.tolist():
            raise AssertionError("mesh 2x1: results on rank 1 or seeds")
        same_results("mesh 2x1 against the one-process run", a0["results"],
                     want)
        for r, a in enumerate((a0, a1)):
            check_launches(f"mesh 2x1 rank {r}", a["launches"],
                           {"lazy_segment", "rg_assign", "mh_sweep",
                            *SM_KERNELS, *REST_KERNELS})
        log(f"  (a) 2 x 1 at {N:,} x {M}: 2 chains x {MESH_STEPS} steps, "
            f"{2 * MESH_STEPS / max(a0['seconds'], a1['seconds']):.3f} "
            f"chain-steps/s (ranks {a0['seconds']:.3f} / "
            f"{a1['seconds']:.3f} s); each chain == its one-process run, "
            f"bit for bit; launches {a0['launches']} / {a1['launches']}: ok")

        # (b) the main cell over 1 x 2, beside one process in this call.
        b0, b1 = ranks[0]["b"], ranks[1]["b"]
        if b0["hashes"] != b1["hashes"] \
                or len(b0["hashes"]) != -(-MESH_STEPS // 32):
            raise AssertionError(f"mesh 1x2: replicated state differs "
                                 f"across ranks: {b0['hashes']} / "
                                 f"{b1['hashes']}")
        for r, b in enumerate((b0, b1)):
            check_launches(f"mesh 1x2 rank {r}", b["launches"],
                           {"lazy_segment", "rg_assign", "mh_sweep",
                            *SM_KERNELS, *REST_KERNELS})
        res = b0["results"][0]
        if res.ML.shape != (MESH_STEPS + 1,) or not (
                np.isfinite(res.ML).all() and np.isfinite(res.MAP).all()):
            raise AssertionError("mesh 1x2: trace shapes / values")
        one1 = MCMCRunner(cfg, mc, pack_data(data, dev), device=dev,
                          block_size=32)
        sync(dev)
        t0 = time.perf_counter()
        one1.run((MESH_STEPS, 0), seed=22)
        sync(dev)
        one_s = time.perf_counter() - t0
        timed = b0["timed"]
        from bnpc_tpu_torch.estimators import ari

        b_out = {
            "steps_per_s": MESH_STEPS / b0["seconds"],
            "one_process_steps_per_s": MESH_STEPS / one_s,
            "all_reduces_per_step": b0["all_reduces"] / MESH_STEPS,
            "all_reduce_mb_per_step": b0["all_reduce_bytes"] / MESH_STEPS
            / 1e6,
            "all_reduce_ms_per_step": timed["seconds"] * 1e3
            / timed["steps"],
            "all_reduces_per_step_timed": timed["all_reduces"]
            / timed["steps"],
            "launches": [b0["launches"], b1["launches"]],
            "ari": ari(res.assignments[-1], truth),
        }
        log(f"  (b) 1 x 2 at {N:,} x {M} ({smi}; backend {backend}, CUDA "
            "tensors all-reduced by gloo): "
            f"{b_out['steps_per_s']:.3f} steps/s against one process "
            f"{b_out['one_process_steps_per_s']:.3f} steps/s in this call "
            f"({MESH_STEPS} steps each); all-reduces a step "
            f"{b_out['all_reduces_per_step']:.2f} "
            f"({b_out['all_reduce_mb_per_step']:.3f} MB), their ms a step "
            f"{b_out['all_reduce_ms_per_step']:.3f} (32 steps, each "
            "all-reduce between two device synchronizations)")
        log(f"      replicated state hashes equal on both ranks at all "
            f"{len(b0['hashes'])} blocks; invariants hold; launches "
            f"{b0['launches']} / {b1['launches']}; ARI vs planted clones "
            f"{b_out['ari']:.4f}: ok")

        # (c) the large-n cell over 1 x 2.
        c0, c1 = ranks[0]["c"], ranks[1]["c"]
        if c0["hashes"] != c1["hashes"]:
            raise AssertionError("mesh 1x2 large: replicated state differs")
        for r, c in enumerate((c0, c1)):
            ln = c["launches"]
            if ln["lazy_stream"] == 0 or ln["lazy_segment"] \
                    or ln["eager_sweep"] or ln["rg_assign"]:
                raise AssertionError(f"mesh 1x2 large rank {r}: launches "
                                     f"{ln}")
        c_out = {"steps_per_s": 16 / c0["seconds"],
                 "all_reduces_per_step": c0["all_reduces"] / 16,
                 "all_reduce_mb_per_step": c0["all_reduce_bytes"] / 16 / 1e6,
                 "launches": [c0["launches"], c1["launches"]]}
        log(f"  (c) 1 x 2 at {N_LARGE:,} x {M}, k_max {K_LARGE}: 16 steps, "
            f"{c_out['steps_per_s']:.3f} steps/s; all-reduces a step "
            f"{c_out['all_reduces_per_step']:.2f} "
            f"({c_out['all_reduce_mb_per_step']:.1f} MB); launches "
            f"{c0['launches']} / {c1['launches']}; replicated state equal; "
            "invariants hold: ok")

        # (d) reported by the ranks, which compared every step.
        kinds = ranks[0]["d"]["kinds"]
        worst = max(r["d"]["params_max_abs_diff"] for r in ranks)
        if kinds[0] == 0 or kinds[1] + kinds[2] == 0:
            raise AssertionError(f"mesh small: step kinds {kinds}")
        log(f"  (d) 1 x 2 at 500 x 201 (padded to 202): 12 steps, card == "
            f"CPU gloo ranks on identical draws (discrete exactly, floats "
            f"rtol 1e-4, params atol 1e-6; params' largest difference "
            f"{worst:.3g}) on both ranks; gibbs/split/merge steps {kinds}: "
            "ok")
        batched_out = mesh_batched_check(ranks, smi)
        cli_out = mesh_cli(dev, tmp)
        cli_out["1,2 -n 2"] = mesh_cli_batched(dev, tmp)
    out = {"backend": backend, "batched": batched_out,
           "world_s": world_s, "chains": {"seconds": [a0["seconds"],
                                                      a1["seconds"]]},
           "main": b_out, "large": c_out, "small_kinds": kinds,
           "small_params_max_abs_diff": worst,
           "cli": cli_out, "seconds": time.perf_counter() - t_phase}
    log(f"  phase 11: {out['seconds']:.1f} s (the two ranks' world "
        f"{world_s:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# Phase 12: batched chains (MCMCRunner chain_exec="vmap")
# ---------------------------------------------------------------------------

CHAIN_GRIDS = (1, 4, 16, 132)


def read_chain_launches():
    """{kernel: (batched launches, {grid: launches})} of the four sampler
    kernels that take a chain grid."""
    from bnpc_tpu_torch.ops import (cuda_gibbs, cuda_rg, cuda_rg_assign,
                                    cuda_stream)

    return {name: (mod.chain_launches, dict(mod.chain_grids))
            for name, mod in (("lazy_segment", cuda_gibbs),
                              ("rg_scan", cuda_rg),
                              ("lazy_stream", cuda_stream),
                              ("rg_assign", cuda_rg_assign))}


# Crafted chains of a segment batch, (start, birth position or None) each:
# a birth at the start, one at position n - 1, none, a chain already done,
# a birth mid-segment.
SEGMENT_PLAN = ("a birth at the start, one at n - 1, none, a chain already "
                "done, one mid-segment",
                lambda n: [(n // 4, n // 4), (0, n - 1), (37, None),
                           (n, None), (5, n // 2)])
# The large-n path's shape, the chains started near the end so that the
# twin stays short: a birth, a run to n with none, a chain already done.
SEGMENT_PLAN_LATE = ("starts near the end: a birth, a run to n with none, "
                     "a chain already done",
                     lambda n: [(n - 5000, n - 3766), (n - 4000, None),
                                (n, None)])


def segment_batch(dev, n, k_pad, k_max, stream, seed, plan):
    """A crafted batch of a segment kernel, one chain for each (start,
    birth position or None) of `plan`, each chain its own z, aux,
    pre-sweep assignment and permutation. Returns ([C, ...] device inputs,
    starts, expected (i_next, birth position) per chain)."""
    import torch

    rng = np.random.default_rng(seed)
    z, aux, assign, perm, sizes = [], [], [], [], []
    for start, hot in plan:
        z.append((rng.standard_normal((n, k_pad)) * 4.0).astype(np.float32))
        p = np.arange(n) if stream else rng.permutation(n)
        perm.append(p.astype(np.int32))
        a = np.full(n, -1e30, np.float32)
        if hot is not None:
            a[p[hot]] = 1e30
        aux.append(a)
        assign.append(rng.integers(0, k_max - 56, n).astype(np.int32))
        s = np.bincount(assign[-1], minlength=k_pad).astype(np.float32)
        s[k_max:] = -1.0
        sizes.append(s)
    log_denom = np.log(n - 1.0 + np.arange(2.0, 2.0 + len(plan))).astype(
        np.float32)

    def t(x):
        return torch.from_numpy(np.stack(x) if isinstance(x, list)
                                else x).to(dev)

    inputs = dict(z=t(z), aux=t(aux), assign=t(assign), perm=t(perm),
                  sizes=t(sizes), log_denom=t(log_denom))
    want = [(n, -1) if hot is None else (hot + 1, hot) for _, hot in plan]
    return inputs, [start for start, _ in plan], want


def segment_chains_check(name, dev, n, k_pad, k_max, stream, seed,
                         plan=SEGMENT_PLAN):
    """Kernel 1 or 3 on a crafted batch (`plan`: its description and its
    chains for n): == its batched twin (on CPU copies), == one one-chain
    launch a chain, and each chain's info as planned. Returns the compared
    pairs."""
    import torch

    from bnpc_tpu_torch.ops import cuda_gibbs, cuda_stream

    what, chains = plan
    inp, starts, want = segment_batch(dev, n, k_pad, k_max, stream, seed,
                                      chains(n))
    if stream:
        names = ("z", "aux", "assign")
        batched = cuda_stream.lazy_segment_stream_chains
        twin = cuda_stream.lazy_segment_stream_chains_ref
        single = cuda_stream.lazy_segment_stream
    else:
        names = ("z", "aux", "assign", "perm")
        batched = cuda_gibbs.lazy_segment_chains
        twin = cuda_gibbs.lazy_segment_chains_ref
        single = cuda_gibbs.lazy_segment
    c_all = len(starts)

    def run(fn, on):
        args = [inp[k].to(on) for k in names]
        sizes = inp["sizes"].to(on).clone()
        tgt = torch.full((c_all, n), -7, dtype=torch.int32, device=on)
        info = torch.zeros((c_all, 4), dtype=torch.int32, device=on)
        i0s = torch.tensor(starts, dtype=torch.int32).to(on)
        fn(*args, sizes, tgt, info, i0s, inp["log_denom"].to(on))
        return [x.to(dev) for x in (tgt, sizes, info, i0s)]

    got = run(batched, dev)
    torch.cuda.synchronize()
    ref = run(twin, "cpu")
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"{name} chains: kernel {got[2].tolist()} != "
                             f"twin {ref[2].tolist()} or targets / sizes / "
                             "starts differ")
    # The same kernel one chain at a time, from each chain's start.
    for c, start in enumerate(starts):
        sizes = inp["sizes"][c].clone()
        tgt = torch.full((n,), -7, dtype=torch.int32, device=dev)
        info = torch.zeros((4,), dtype=torch.int32, device=dev)
        single(*(inp[k][c] for k in names), sizes, tgt, info, start,
               inp["log_denom"][c])
        if not (torch.equal(tgt, got[0][c]) and torch.equal(sizes, got[1][c])
                and torch.equal(info, got[2][c])):
            raise AssertionError(f"{name} chains: chain {c}'s batched "
                                 "launch != its one-chain launch")
    for c, (i_next, pos) in enumerate(want):
        info = got[2][c].tolist()
        cell = pos if stream or pos < 0 else int(inp["perm"][c][pos])
        if info[0] != i_next or info[1] != cell or int(got[3][c]) != i_next:
            raise AssertionError(f"{name} chains: chain {c} info {info}, "
                                 f"expected i_next {i_next}, birth {cell}")
    log(f"  {name} chains (n={n}, k_pad={k_pad}; {what}): info "
        f"{got[2].tolist()} — kernel == twin == {c_all} one-chain launches")
    return list(zip(got, ref))


def rg_chains_check(dev, n, counts):
    """Kernel 2 on a batch of one chain a s_count of `counts`, each chain
    its own dz, launch sides and table: == its batched twin and == one
    one-chain launch a chain."""
    import torch

    from bnpc_tpu_torch.ops.cuda_rg import (rg_scan, rg_scan_chains,
                                            rg_scan_chains_ref)

    dz, lau, dtab, c1 = [], [], [], []
    for c, s_count in enumerate(counts):
        d, la = rg_inputs(n, 40 + c, dev)
        dz.append(d)
        lau.append(la)
        dtab.append(rg_table(n, s_count + 2, dev))
        c1.append(la[:s_count].sum().to(torch.int32))
    dz, lau, dtab = torch.stack(dz), torch.stack(lau), torch.stack(dtab)
    s_count = torch.tensor(counts, dtype=torch.int32).to(dev)
    count1 = torch.stack(c1)
    got = rg_scan_chains(dz, lau, dtab, s_count, count1)
    ref = rg_scan_chains_ref(dz.cpu(), lau.cpu(), dtab.cpu(), s_count.cpu(),
                             count1.cpu()).to(dev)
    pos = torch.arange(n, device=dev)
    valid = pos < s_count[:, None]
    if not torch.equal(torch.where(valid, got, 0), torch.where(valid, ref, 0)):
        raise AssertionError(f"rg_scan chains (n={n}): kernel != twin")
    for c in range(len(counts)):
        one = rg_scan(dz[c], lau[c], dtab[c], s_count[c], count1[c])
        if not torch.equal(one[:counts[c]], got[c, :counts[c]]):
            raise AssertionError(f"rg_scan chains (n={n}): chain {c}'s "
                                 "batched launch != its one-chain launch")
    log(f"  rg_scan chains (n={n}; s_count {list(counts)}): kernel == twin "
        f"== {len(counts)} one-chain launches")
    return [(torch.where(valid, got, 0), torch.where(valid, ref, 0))]


def chain_timings(dev, k_ms):
    """Median ms of one batched launch at C chains: kernels 1 and 2 at the
    main shape for C in CHAIN_GRIDS, kernel 3 on the 131,072 x 128 Z for
    C in (1, 4); beside the one-chain wrapper on chain 0's input in this
    call and phase 3's time. Returns {kernel: {...}}."""
    import torch

    from bnpc_tpu_torch.ops import cuda_gibbs, cuda_rg, cuda_stream

    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    out = {}

    def segment_inputs(c_all, n, k_pad, k_max):
        z = torch.randn((c_all, n, k_pad), generator=gen, device=dev) * 4.0
        aux = torch.full((c_all, n), -1e30, device=dev)
        assign = torch.randint(0, k_max - 56, (c_all, n), generator=gen,
                               device=dev, dtype=torch.int32)
        perm = torch.argsort(torch.rand((c_all, n), generator=gen,
                                        device=dev), dim=-1).to(torch.int32)
        sizes = torch.zeros((c_all, k_pad), device=dev).scatter_add_(
            1, assign.long(), torch.ones((c_all, n), device=dev))
        sizes[:, k_max:] = -1.0
        log_denom = torch.full((c_all,), float(np.log(n - 1.0 + 10.0)),
                               device=dev)
        return z, aux, assign, perm, sizes, log_denom

    def time_segment(name, fn, one, grids, n, k_pad, k_max, stream, reps):
        res, single_ms = {}, None
        for c_all in grids:
            z, aux, assign, perm, sizes0, log_denom = segment_inputs(
                c_all, n, k_pad, k_max)
            args = (z, aux, assign) if stream else (z, aux, assign, perm)
            tgt = torch.empty((c_all, n), dtype=torch.int32, device=dev)
            info = torch.empty((c_all, 4), dtype=torch.int32, device=dev)
            i0s = torch.zeros((c_all,), dtype=torch.int32, device=dev)
            buf = iter([sizes0.clone() for _ in range(reps)])

            def launch():
                i0s.zero_()
                fn(*args, next(buf), tgt, info, i0s, log_denom)

            res[c_all] = cuda_ms(launch, reps)
            if c_all == 1:
                buf = iter([sizes0[0].clone() for _ in range(reps)])
                single_ms = cuda_ms(lambda: one(
                    *(a[0] for a in args), next(buf), tgt[0], info[0], 0,
                    log_denom[0]), reps)
            if int(info[:, 0].min()) != n:
                raise AssertionError(f"{name} timing: a chain stopped "
                                     "early")
            del z, args
        # Every chain: its z rows, aux, assign (perm) in, its targets out,
        # its sizes row in and out.
        per_chain = (4 * (n * k_pad + (3 if stream else 4) * n + 2 * k_pad
                          + 4), OPS_PER_SLOT * n * k_pad)
        return res, single_ms, per_chain

    k1, k1_one, k1_chain = time_segment(
        "lazy_segment", cuda_gibbs.lazy_segment_chains,
        cuda_gibbs.lazy_segment, CHAIN_GRIDS, N, 256, K_MAX, False, 11)
    k3, k3_one, k3_chain = time_segment(
        "lazy_stream", cuda_stream.lazy_segment_stream_chains,
        cuda_stream.lazy_segment_stream, (1, 4, 16), N_LARGE, K_LARGE,
        K_LARGE, True, 5)
    for name, res, one, chain in (("lazy_segment", k1, k1_one, k1_chain),
                                  ("lazy_stream", k3, k3_one, k3_chain)):
        out[name] = {"batched_ms": res, "one_chain_ms": one,
                     "phase3_ms": k_ms.get(name),
                     "bound_ms": {c: bound(c * chain[0], c * chain[1])[0]
                                  for c in res}}

    # Kernel 2 at s_count = n in every chain.
    k2, k2_one = {}, None
    for c_all in CHAIN_GRIDS:
        dz = torch.randn((c_all, N), generator=gen, device=dev) * 2.0
        lau = torch.randint(0, 2, (c_all, N), generator=gen, device=dev,
                            dtype=torch.int32)
        dtab = rg_table(N, N + 2, dev).expand(c_all, N + 2).contiguous()
        sc = torch.full((c_all,), N, dtype=torch.int32, device=dev)
        c1 = lau.sum(-1).to(torch.int32) // 2
        k2[c_all] = cuda_ms(lambda: cuda_rg.rg_scan_chains(
            dz, lau, dtab, sc, c1), 21)
        if c_all == 1:
            k2_one = cuda_ms(lambda: cuda_rg.rg_scan(dz[0], lau[0], dtab[0],
                                                     sc[0], c1[0]), 21)
    out["rg_scan"] = {"batched_ms": k2, "one_chain_ms": k2_one,
                      "phase3_ms": k_ms.get("rg_scan"),
                      "bound_ms": {c: bound(c * 4 * (4 * N + 4),
                                            c * 4 * N)[0] for c in k2}}
    for name, t in out.items():
        z_mb = {"lazy_segment": 4 * N * 256, "lazy_stream":
                4 * N_LARGE * K_LARGE, "rg_scan": 0}[name] / 1e6
        log(f"  {name} one batched launch: " + ", ".join(
            f"C={c} {ms:.4f} ms" for c, ms in t["batched_ms"].items())
            + f"; one-chain wrapper on chain 0 {t['one_chain_ms']:.4f} ms"
            + (f", phase 3 {t['phase3_ms']:.4f} ms" if t["phase3_ms"]
               else "")
            + (f" (Z {z_mb:.1f} MB a chain)" if z_mb else ""))
    return out


def chains_runner(data, cfg, mc, dev, chain_exec, **kw):
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.mcmc import MCMCRunner

    return MCMCRunner(cfg, mc, pack_data(data, dev), device=dev,
                      chain_exec=chain_exec, **kw)


def close_results(tag, got, want):
    """Two runs' ChainResults chain by chain: assignments and MH counts
    exactly, floats to rtol 1e-6. Returns whether they are equal bit for
    bit."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} chains, not {len(want)}")
    bits = True
    for c, (g, w) in enumerate(zip(got, want)):
        for f in ("assignments", "mh_counts"):
            if not np.array_equal(getattr(g, f), getattr(w, f)):
                raise AssertionError(f"{tag}: chain {c} {f} differ")
        for f in ("ML", "MAP", "DP_alpha", "FN", "FP", "params"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=1e-6, err_msg=f"{tag} {c} {f}")
            bits &= np.array_equal(getattr(g, f), getattr(w, f))
    return bits


def chains_compare(tag, dev, data, cfg, mc, n_chains, steps, seed, kernels,
                   n, k_max, bits=False, interleave=False, **kw):
    """One run under chain_exec="vmap" and one under "sequential" (same
    seed, same call, a fresh runner each): equal chain by chain (with
    `bits`, bit for bit); chain-steps/s of both; the batched run's
    launches (every kernel launch of it on a chain grid); the Gibbs
    kernel's rounds a batched sweep where the run's Gibbs move launches one
    (not the blocked sweep). With `interleave` the runs go vmap,
    sequential, sequential, vmap, each later run bit for bit against its
    form's first, and each form's chain-steps/s is the median of its two
    (min and max beside it)."""
    import torch

    out, results = {}, {}
    sweep = next((k for k in ("lazy_stream", "lazy_segment")
                  if k in kernels), None)
    order = (("vmap", "sequential", "sequential", "vmap") if interleave
             else ("vmap", "sequential"))
    for ex in order:
        runner = chains_runner(data, cfg, mc, dev, ex, **kw)
        kept = KeepStates(runner)
        reset_launches()
        with SweepCounts() as sweeps:
            t0 = time.perf_counter()
            res = runner.run((steps, steps // 2), seed=seed,
                             n_chains=n_chains)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        check_results(f"{tag} {ex}", res, kept.states, n, k_max, steps + 1)
        if ex in results:
            if not close_results(f"{tag} {ex} again", res, results[ex]):
                raise AssertionError(f"{tag}: a second {ex} run differs "
                                     "from the first")
            out[ex]["runs"].append(n_chains * steps / secs)
            continue
        results[ex] = res
        out[ex] = {"runs": [n_chains * steps / secs]}
        if sweep is None:
            pass
        elif ex == "sequential":
            # Each chain's sweep: births + 1 launches.
            out[ex]["launches_per_sweep"] = (
                read_launches()[sweep] / max(sweeps.one, 1))
        else:
            # A batched sweep: max over its chains of (births + 1) rounds.
            out[ex]["rounds_per_sweep"] = (
                read_chain_launches()[sweep][0] / max(sweeps.batched, 1))
            out[ex]["sweeps"] = sweeps.batched
        if ex == "vmap":
            single = read_one_chain_launches()
            # The run's initial rows (MCMCRunner._init_rows): summarize on
            # each chain alone, kernel 11's two stages a chain, before the
            # first batched step.
            init = {"trace_row": 2 * n_chains}
            batched = read_chain_launches()
            if any(v != init.get(k, 0) for k, v in single.items()) or any(
                    (batched[k][0] > 0) != (k in kernels) for k in batched):
                raise AssertionError(f"{tag}: one-chain launches {single}, "
                                     f"batched {batched}; expected only "
                                     f"{sorted(kernels)}, batched, and the "
                                     f"initial rows' {init}")
            out["launches"] = batched
    for ex in ("vmap", "sequential"):
        r = out[ex]["runs"]
        out[ex].update(chain_steps_per_s=float(np.median(r)), min=min(r),
                       max=max(r))
    out["bit_for_bit"] = close_results(tag, results["vmap"],
                                       results["sequential"])
    if bits and not out["bit_for_bit"]:
        raise AssertionError(f"{tag}: vmap == sequential only to rtol "
                             "1e-6, not bit for bit")
    out["ratio"] = (out["vmap"]["chain_steps_per_s"]
                    / out["sequential"]["chain_steps_per_s"])
    rounds = "" if sweep is None else (
        f"; {sweep}: {out['vmap']['rounds_per_sweep']:.3f} rounds in each "
        f"of {out['vmap']['sweeps']} batched sweeps, "
        f"{out['sequential']['launches_per_sweep']:.3f} launches a "
        "one-chain sweep")
    log(f"  {tag}: {n_chains} chains x {steps} steps, runs "
        f"{' / '.join(order)}; vmap {out['vmap']['runs']}, sequential "
        f"{out['sequential']['runs']} chain-steps/s; medians "
        f"{out['vmap']['chain_steps_per_s']:.3f} / "
        f"{out['sequential']['chain_steps_per_s']:.3f} (x{out['ratio']:.3f}"
        f"); vmap == sequential chain by chain (bit for bit: "
        f"{out['bit_for_bit']}); batched launches (kernel: (launches, "
        f"{{grid: launches}})) {out['launches']}{rounds}")
    return out


def chains_warm(dev, data, cfg, mc):
    """2 chains x 8 steps under each chain_exec, untimed: the kernels a
    batch and a chain run first load here, not inside a timed run."""
    for ex in ("vmap", "sequential"):
        chains_runner(data, cfg, mc, dev, ex).run((8, 4), seed=40,
                                                  n_chains=2)


class SweepCounts:
    """While active, counts the exact Gibbs sweeps of the lazy and stream
    impls: one-chain (``_segment_impl`` on a one-chain state, or the
    captured block's sweep, which runs as graphs) and batched (one
    ``_segment_impl`` call for a sub-batch of chains, or one sub-batch
    sweep of the captured batch)."""

    def __enter__(self):
        from bnpc_tpu_torch import mcmc
        from bnpc_tpu_torch.models import gibbs

        self.one, self.batched = 0, 0
        self.saved = fn = gibbs._segment_impl
        self.saved_captured = sweep = mcmc._CapturedBlock._sweep
        self.saved_batch = assign = mcmc._CapturedBatch._assign

        def counted(draws, state, *args, **kwargs):
            if state.assignment.dim() == 1:
                self.one += 1
            else:
                self.batched += 1
            return fn(draws, state, *args, **kwargs)

        def captured(block, k_assign):
            self.one += 1
            return sweep(block, k_assign)

        def batch(block, draws, sm, gibbs_chains):
            self.batched += bool(gibbs_chains)
            return assign(block, draws, sm, gibbs_chains)

        gibbs._segment_impl = counted
        mcmc._CapturedBlock._sweep = captured
        mcmc._CapturedBatch._assign = batch
        return self

    def __exit__(self, *exc):
        from bnpc_tpu_torch import mcmc
        from bnpc_tpu_torch.models import gibbs

        gibbs._segment_impl = self.saved
        mcmc._CapturedBlock._sweep = self.saved_captured
        mcmc._CapturedBatch._assign = self.saved_batch


class DrawCalls:
    """While active, counts the calls of TorchDraws' primitive draws (each
    one launch or more on the card)."""

    NAMES = ("uniform", "normal", "bits", "randint", "permutation", "gamma")

    def __enter__(self):
        from bnpc_tpu_torch.draws import TorchDraws

        self.calls, self.saved = 0, {}
        for name in self.NAMES:
            fn = self.saved[name] = getattr(TorchDraws, name)

            def counted(*args, _fn=fn, **kwargs):
                self.calls += 1
                return _fn(*args, **kwargs)

            setattr(TorchDraws, name, counted)
        return self

    def __exit__(self, *exc):
        from bnpc_tpu_torch.draws import TorchDraws

        for name, fn in self.saved.items():
            setattr(TorchDraws, name, fn)


def step_profile(tag, step_fn, steps):
    """`steps` calls of step_fn under torch.profiler (device activity
    only): kernel launches and device busy share, and TorchDraws'
    primitive draw calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with DrawCalls() as draws, profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    kernels = [e for e in table
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    by_name = {}
    for e in kernels:
        name = e.key.replace("void ", "").replace("at::native::", "")
        name = name.split("(")[0][:90]
        by_name[name] = by_name.get(name, 0) + e.count / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"launches_per_step": launches / steps,
           "busy_share": dev_ms / wall_ms, "wall_ms_per_step": wall_ms / steps,
           "draw_calls_per_step": draws.calls / steps,
           "draw_share_of_launches": draws.calls / max(launches, 1),
           "top_kernels_per_step": dict(top)}
    log(f"  {tag}: {out['launches_per_step']:.1f} kernel launches a step, "
        f"{out['draw_calls_per_step']:.1f} of them draw calls "
        f"({out['draw_share_of_launches']:.4f}); device busy "
        f"{out['busy_share']:.4f} of {out['wall_ms_per_step']:.2f} ms a step "
        "(torch.profiler)")
    log("    most launched kernels a step: " + "; ".join(
        f"{k} {v:.1f}" for k, v in out["top_kernels_per_step"].items()))
    return out


def chains_step_costs(dev, data, cfg, mc, n_chains, steps, warm=16):
    """Per step of the main cell, batched (one step of every chain) against
    sequential (one step of each chain in turn), from the same states
    `warm` steps into a run and the same generator states, so both forms
    take the same moves: launches, draw calls, device busy share
    (profiled) and host syncs."""
    from bnpc_tpu_torch.draws import StackedDraws, TorchDraws
    from bnpc_tpu_torch.state import stack_states

    runner = chains_runner(data, cfg, mc, dev, "vmap")
    states = [runner.init_chains(TorchDraws(c, dev))[0]
              for c in range(n_chains)]
    gens = [TorchDraws(100 + c, dev) for c in range(n_chains)]
    # Past the first steps' many clusters.
    states, _, gens = runner.run_chains(states, gens, warm)
    gen_states = [d.gen.get_state() for d in gens]
    batch = [stack_states(states)]

    def batched():
        batch[0], _ = runner._block.step(batch[0], StackedDraws(gens))

    seq = list(states)

    def sequential():
        for c in range(n_chains):
            seq[c], _ = runner._block.step(seq[c], gens[c])

    out = {}
    for tag, fn in (("vmap", batched), ("sequential", sequential)):
        for d, g in zip(gens, gen_states):
            d.gen.set_state(g)
        out[tag] = step_profile(f"{tag} step of {n_chains} chains", fn,
                                steps)
        out[tag]["host_syncs_per_step"] = syncs_per_step(
            lambda k: [fn() for _ in range(k)], 4)
        log(f"    host syncs a step ({tag}, all {n_chains} chains): "
            f"{out[tag]['host_syncs_per_step']:.3f}")
    return out


def chains_resume(dev, data, cfg, mc, tmp):
    """2 chains, block 32: 32 steps under vmap with a checkpoint, resumed
    under sequential to 64 == the uninterrupted vmap run, bit for bit."""
    ck = os.path.join(tmp, "chains_ck")
    kw = dict(block_size=32, checkpoint_dir=ck, checkpoint_every=1)
    chains_runner(data, cfg, mc, dev, "vmap", **kw).run((32, 16), seed=31,
                                                        n_chains=2)
    resumed = chains_runner(data, cfg, mc, dev, "sequential", **kw).run(
        (64, 16), seed=31, n_chains=2)
    full = chains_runner(data, cfg, mc, dev, "vmap", block_size=32).run(
        (64, 16), seed=31, n_chains=2)
    same_results("chains: vmap checkpoint resumed under sequential",
                 resumed, full)
    log("  32 steps of 2 chains saved under vmap, resumed under sequential "
        "to 64 == the uninterrupted vmap run, bit for bit: ok")


def chains_blocked(dev, smi, data, data_l):
    """(f) the blocked sweep batched: gibbs_block 128 at the main cell (4
    chains x 64 steps) and 512 at the large-n cell (2 x 16), each under
    "vmap" (the captured batch) against "sequential" (each chain's captured
    block) in this call, a fresh runner a run, runs vmap, sequential,
    sequential, vmap, chain by chain bit for bit;
    at the main cell also launches, draw calls, busy share and host syncs
    a step of both forms from the same states and generators. `data` and
    `data_l` are the two cells' matrices."""
    import dataclasses

    out = {}
    cfg, mc = bench_configs(N, K_MAX)
    mc_b = dataclasses.replace(mc, gibbs_block=128)
    log(f"  (f) blocked sweep, gibbs_block 128, main cell, 4 chains x 64 "
        f"steps ({smi})")
    out["main_4"] = chains_compare("blocked main 4", dev, data, cfg, mc_b,
                                   4, 64, 45, {"rg_assign"}, N, K_MAX,
                                   bits=True, interleave=True)
    out["main_4"]["steps"] = chains_step_costs(dev, data, cfg, mc_b, 4, 4,
                                               warm=8)
    log(f"  (f) blocked sweep, gibbs_block 512, large-n, 2 chains x 16 "
        f"steps ({smi})")
    cfg_l, mc_l = bench_configs(N_LARGE, K_LARGE)
    out["large_2"] = chains_compare(
        "blocked large 2", dev, data_l, cfg_l,
        dataclasses.replace(mc_l, gibbs_block=512), 2, 16, 46, {"rg_scan"},
        N_LARGE, K_LARGE, bits=True, interleave=True, block_size=16)
    return out


def chains_cli(dev, tmp, smi):
    """(g) cli.main -n 4 -s 128 at the main cell: the chain_exec "auto"
    chose (printed), the files."""
    from bnpc_tpu_torch import mcmc

    cell = cli_run(dev, tmp, "chains", N, 10,
                   ["-n", "4", "-s", "128", "-e", "posterior"],
                   ["posterior"], "lazy_segment", smi, verbosity="1")
    text = cell.pop("stdout")
    want = f"chain_exec: {mcmc.AUTO_CUDA_CHAIN_EXEC}"
    if want not in text:
        raise AssertionError(f"cli -n 4: '{want}' not printed")
    args = cell.pop("output_args")[0]
    if len(args.chain_seeds) != 4:
        raise AssertionError(f"cli -n 4: chain_seeds {args.chain_seeds}")
    log(f"  (g) cli -n 4 -s 128: printed '{want}'; files parsed, 4 "
        f"chain_seeds; {cell['wall_s']:.3f} s")
    return {"wall_s": cell["wall_s"], "chain_exec":
            mcmc.AUTO_CUDA_CHAIN_EXEC, "ari_posterior": cell["ari_posterior"]}


def phase_chains(dev, smi, k):
    """Phase 12: batched chains (chain_exec="vmap") — see the module
    docstring. `k` holds phase 3's results (for its times)."""
    import contextlib
    import dataclasses
    import tempfile

    t_phase = time.perf_counter()
    out, parts = {}, {}

    @contextlib.contextmanager
    def part(name):
        t0 = time.perf_counter()
        yield
        parts[name] = time.perf_counter() - t0

    with part("a"):
        log("  (a) kernels 1, 3 and 2 on a chain grid")
        pairs = []
        pairs += segment_chains_check("lazy_segment", dev, N, 256, K_MAX,
                                      False, 1)
        pairs += segment_chains_check("lazy_stream", dev, N, 256, K_MAX,
                                      True, 2)
        # The shared-memory layout (k_pad > 1,024).
        pairs += segment_chains_check("lazy_stream smem", dev, 1024, 2016,
                                      2000, True, 3)
        pairs += rg_chains_check(dev, N, (0, 1, 37, 1984, N))
        # The large-n path's shapes: kernel 3's register layout on the
        # 131,072 x 128 Z, and kernel 2 at n = 131,072 with s_count = n
        # (its unstaged table, at each chain's own offset) beside a ragged
        # count and a count of one.
        pairs += segment_chains_check("lazy_stream large", dev, N_LARGE,
                                      K_LARGE, K_LARGE, True, 4,
                                      SEGMENT_PLAN_LATE)
        pairs += rg_chains_check(dev, N_LARGE, (N_LARGE, 6557, 1))
        out["max_abs_err"] = max_err(pairs)
        out["timing"] = chain_timings(dev, {name: k[name]["ms"] for name in k}
                                      if k else {})

    data, _ = make_data(N, M, 10, 0.1, seed=0)
    cfg, mc = bench_configs(N, K_MAX)
    main_kernels = {"lazy_segment", "rg_assign"}
    with part("b"):
        log(f"  (b) main cell, 4 chains x 128 steps ({smi})")
        chains_warm(dev, data, cfg, mc)
        out["main_4"] = chains_compare("main 4", dev, data, cfg, mc, 4, 128,
                                       41, main_kernels, N, K_MAX, bits=True,
                                       interleave=True)
    with part("b steps"):
        out["main_4"]["steps"] = chains_step_costs(dev, data, cfg, mc, 4, 4)
    with tempfile.TemporaryDirectory() as tmp:
        with part("b resume"):
            chains_resume(dev, data, cfg, mc, tmp)
        with part("c"):
            log(f"  (c) main cell, 16 chains x 64 steps ({smi})")
            out["main_16"] = chains_compare("main 16", dev, data, cfg, mc,
                                            16, 64, 42, main_kernels, N,
                                            K_MAX, bits=True,
                                            interleave=True)
        with part("d"):
            log(f"  (d) coupled, 4 chains x 64 steps ({smi})")
            out["coupled_4"] = chains_compare(
                "coupled 4", dev, data, cfg,
                dataclasses.replace(mc, coupled_moves=True), 4, 64, 43,
                main_kernels, N, K_MAX, bits=True, interleave=True)
        with part("e"):
            log(f"  (e) large-n, 2 chains x 16 steps ({smi})")
            data_l, _ = make_data(N_LARGE, M, 20, 0.1, seed=0)
            cfg_l, mc_l = bench_configs(N_LARGE, K_LARGE)
            out["large_2"] = chains_compare(
                "large 2", dev, data_l, cfg_l, mc_l, 2, 16, 44,
                {"lazy_stream", "rg_scan"}, N_LARGE, K_LARGE, bits=True,
                interleave=True, block_size=16)
            grids = out["large_2"]["launches"]
            if not all(2 in grids[name][1]
                       for name in ("lazy_stream", "rg_scan")):
                raise AssertionError(f"large 2: no launch of kernel 3 or 2 "
                                     f"on a grid of 2: {grids}")
        with part("f"):
            out["blocked"] = chains_blocked(dev, smi, data, data_l)
            del data_l
        with part("g"):
            out["cli"] = chains_cli(dev, tmp, smi)
    out["part_seconds"] = parts
    out["auto_rule_holds"] = all(
        out[c]["ratio"] >= 1.0 for c in ("main_4", "main_16", "large_2"))
    out["auto_blocked_rule_holds"] = all(
        out["blocked"][c]["ratio"] >= 1.0 for c in ("main_4", "large_2"))
    from bnpc_tpu_torch import mcmc

    out["auto_coupled_rule_holds"] = out["coupled_4"]["ratio"] >= 1.0
    out["auto_constant_agrees"] = (
        (mcmc.AUTO_CUDA_CHAIN_EXEC == "vmap") == out["auto_rule_holds"])
    log(f"  batched >= sequential chain-steps/s at both cells in this call "
        f"(main 4 and 16 chains, large-n 2): {out['auto_rule_holds']} "
        f"(AUTO_CUDA_CHAIN_EXEC = {mcmc.AUTO_CUDA_CHAIN_EXEC!r}, \"vmap\" "
        f"only where it holds in every call; this call agrees: "
        f"{out['auto_constant_agrees']}); coupled (main 4): "
        f"{out['auto_coupled_rule_holds']} (AUTO_CUDA_COUPLED_CHAIN_EXEC = "
        f"{mcmc.AUTO_CUDA_COUPLED_CHAIN_EXEC!r}); blocked (main 4, large-n "
        f"2): {out['auto_blocked_rule_holds']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12: {out['seconds']:.1f} s; parts (s) "
        + ", ".join(f"{name} {sec:.1f}" for name, sec in parts.items()))
    return out


# ---------------------------------------------------------------------------
# Phase 13: the captured block against the eager block
# ---------------------------------------------------------------------------

# Host-side launch calls in the profiler's runtime (and driver) events.
LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def same_block(tag, got, want):
    """Two blocks' (state, rows, draws), bit for bit: every TraceRow field,
    every state field and the generator's state."""
    import torch

    (g_state, g_rows, g_draws), (w_state, w_rows, w_draws) = got, want
    for f, w in w_rows.items():
        if g_rows[f].dtype != w.dtype or not np.array_equal(g_rows[f], w):
            raise AssertionError(f"{tag}: trace field {f} differs")
    for f, g, w in zip(type(w_state)._fields, g_state, w_state):
        if not torch.equal(g, w):
            raise AssertionError(f"{tag}: state field {f} differs")
    if not torch.equal(g_draws.gen.get_state(), w_draws.gen.get_state()):
        raise AssertionError(f"{tag}: the generator's state differs")


class BirthRounds:
    """While active, counts the birth rounds of the eager sweeps
    (models/gibbs.py::segment_births and blocked_births calls) and the
    blocked sweeps' later frozen passes, one a replayed birth block of one
    chain (blocked_pass calls from a block above 0)."""

    def __enter__(self):
        from bnpc_tpu_torch.models import gibbs

        self.rounds = self.birth_blocks = 0
        self.saved = {name: getattr(gibbs, name) for name in (
            "segment_births", "blocked_births", "blocked_pass")}

        def counted(fn):
            def run(*args, **kwargs):
                self.rounds += 1
                return fn(*args, **kwargs)
            return run

        def passes(ws, g_lo=0):
            self.birth_blocks += g_lo > 0
            return self.saved["blocked_pass"](ws, g_lo)

        gibbs.segment_births = counted(self.saved["segment_births"])
        gibbs.blocked_births = counted(self.saved["blocked_births"])
        gibbs.blocked_pass = passes
        return self

    def __exit__(self, *exc):
        from bnpc_tpu_torch.models import gibbs

        for name, fn in self.saved.items():
            setattr(gibbs, name, fn)


def launch_profile(fn, steps):
    """A step's costs over `steps` steps of fn() (torch.profiler, device
    activity): host-side launch calls by name (cudaGraphLaunch and the
    kernel launches among the runtime and driver events; with the host
    activity added when the device activity alone shows none), kernel
    executions on the device, device busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def window(activities):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof.key_averages(), wall_ms

    table, wall_ms = window([ProfilerActivity.CUDA])
    kernels = [e for e in table
               if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = {e.key: e.count for e in table if e.key in LAUNCH_EVENTS}
    source = "device activity"
    if not calls:
        more, _ = window([ProfilerActivity.CPU, ProfilerActivity.CUDA])
        calls = {e.key: e.count for e in more if e.key in LAUNCH_EVENTS}
        source = "host and device activity"
    return {"host_launches_per_step": sum(calls.values()) / steps,
            "host_launch_calls_per_step": {k: v / steps
                                           for k, v in calls.items()},
            "host_launch_source": source,
            "kernel_executions_per_step": sum(e.count for e in kernels)
            / steps,
            "busy_share": sum(e.self_device_time_total for e in kernels)
            / 1e3 / wall_ms,
            "wall_ms_per_step": wall_ms / steps}


def captured_pieces(executors):
    """The pieces of the one captured executor in `executors` (a block's,
    mcmc.py::_make_block), None before the block has made it."""
    return next(iter(executors.values())).pieces if executors else None


def captured_cell(dev, smi, cell, n, k_max, k_clones, windows, steps_a,
                  steps_b, steps_c, gibbs_block=0, gibbs_impl=None):
    """Phase 13 at one cell: (a) `windows` blocks of `steps_a` steps from
    the initial state, eager (_chain_block over the runner's step) and
    captured (MCMCRunner.run_block) from the same state and generator
    state, bit for bit; (b) eager, captured, captured, eager blocks of
    `steps_b` steps from one state, steps/s; (c) a step's costs of each
    form over `steps_c` steps. With `gibbs_block` the runner's step is the
    blocked sweep's; with `gibbs_impl` the forms are make_block_fn's block
    (captured) and _chain_block over make_step_fn's step with that impl
    (eager) instead of the runner's."""
    import dataclasses
    import functools

    import torch

    from bnpc_tpu_torch import mcmc
    from bnpc_tpu_torch.data import pack_data

    data, _ = make_data(n, M, k_clones, 0.1, seed=0)
    cfg, mc = bench_configs(n, k_max)
    mc = dataclasses.replace(mc, gibbs_block=gibbs_block)
    packed = pack_data(data, dev)
    runner = mcmc.MCMCRunner(cfg, mc, packed, device=dev,
                             block_size=steps_a)
    del data
    if gibbs_impl is None:
        forms = {"eager": functools.partial(mcmc._chain_block,
                                            runner._block.step),
                 "captured": runner.run_block}
        executors = runner._block.executors
    else:
        step = mcmc.make_step_fn(cfg, mc, packed, runner.trace_k,
                                 gibbs_impl=gibbs_impl)
        forms = {"eager": functools.partial(mcmc._chain_block, step),
                 "captured": mcmc.make_block_fn(
                     cfg, mc, packed, runner.trace_k,
                     gibbs_impl=gibbs_impl)}
        executors = forms["captured"].executors

    def fresh(gen_state):
        d = TorchDraws(1, dev)
        d.gen.set_state(gen_state)
        return d

    out = {"windows": []}
    state = runner.init_chains(TorchDraws(0, dev))[0]
    draws = TorchDraws(1, dev)
    for w in range(windows):
        gen = draws.gen.get_state()
        reset_launches()
        with BirthRounds() as births:
            want = forms["eager"](state, fresh(gen), steps_a)
        torch.cuda.synchronize()
        launches = read_launches()
        reset_launches()
        with SetupLaunches() as setup:
            got = forms["captured"](state, fresh(gen), steps_a)
            torch.cuda.synchronize()
        same_block(f"{cell} window {w}", got, want)
        # Each replay adds its graph's launches: the counts agree, the
        # block's row set-up apart.
        setup_l = setup.take()
        replayed = {k: v - setup_l[k] for k, v in read_launches().items()}
        if replayed != launches:
            raise AssertionError(f"{cell} window {w}: launches captured "
                                 f"{replayed} (set-up {setup_l} apart), "
                                 f"eager {launches}")
        counts = want[1]["mh_counts"]
        sm = counts[:, 1:3].sum(axis=(1, 2)) > 0
        out["windows"].append({
            "steps": steps_a, "sweeps": int((~sm).sum()),
            "launches": launches, "birth_rounds": births.rounds,
            "birth_blocks": births.birth_blocks,
            "splits": int((counts[:, 1].sum(-1) > 0).sum()),
            "merges": int((counts[:, 2].sum(-1) > 0).sum())})
        state, draws = got[0], got[2]
    totals = {k: sum(w[k] for w in out["windows"])
              for k in ("birth_rounds", "birth_blocks", "splits", "merges")}
    log(f"  (a) {cell}: {windows} x {steps_a} steps, captured == eager bit "
        f"for bit (every trace field, the state, the generator's state); "
        f"windows {out['windows']}")

    gen = draws.gen.get_state()
    rates = {"eager": [], "captured": []}
    for form in ("eager", "captured", "captured", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forms[form](state, fresh(gen), steps_b)
        torch.cuda.synchronize()
        rates[form].append(steps_b / (time.perf_counter() - t0))
    for form, r in rates.items():
        out[form] = {"steps_per_s": r, "min": min(r),
                     "median": float(np.median(r)), "max": max(r)}
    out["ratio"] = out["captured"]["median"] / out["eager"]["median"]
    log(f"  (b) {cell}, {steps_b} steps a block, eager / captured / "
        f"captured / eager ({smi}): eager {rates['eager']}, captured "
        f"{rates['captured']} steps/s; median ratio {out['ratio']:.3f}")

    for form, fn in forms.items():
        d = fresh(gen)
        torch.cuda.reset_peak_memory_stats()
        costs = launch_profile(lambda: fn(state, d, steps_c), steps_c)
        costs["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
        d = fresh(gen)
        costs["host_syncs_per_step"] = syncs_per_step(
            lambda k: fn(state, d, k), steps_c)
        out[form].update(costs)
        log(f"  (c) {cell} {form}: {costs['host_launches_per_step']:.2f} "
            f"host-side launches a step {costs['host_launch_calls_per_step']}"
            f" ({costs['host_launch_source']}), "
            f"{costs['kernel_executions_per_step']:.1f} kernel executions, "
            f"{costs['host_syncs_per_step']:.3f} host syncs, busy "
            f"{costs['busy_share']:.4f} of {costs['wall_ms_per_step']:.3f} "
            f"ms, peak {costs['peak_mb']:.1f} MB")
    pieces = captured_pieces(executors)
    out["graphs"] = sorted(str(k) for k in pieces.graphs)
    out["capture_seconds"] = pieces.capture_seconds
    out["pool_mb"] = (pieces.pool_bytes() or 0) / 1e6
    log(f"  (c) {cell}: {len(pieces.graphs)} graphs captured "
        f"({', '.join(out['graphs'])}) in {out['capture_seconds']:.3f} s; "
        f"pool {out['pool_mb']:.1f} MB")
    return out, totals


def same_batch(tag, got, want):
    """Two batch blocks' (states, rows, draws), bit for bit: every TraceRow
    field, each chain's state and each chain's generator state."""
    import torch

    (g_states, g_rows, g_draws), (w_states, w_rows, w_draws) = got, want
    for f, w in w_rows.items():
        if g_rows[f].dtype != w.dtype or not np.array_equal(g_rows[f], w):
            raise AssertionError(f"{tag}: trace field {f} differs")
    for c, (g_st, w_st) in enumerate(zip(g_states, w_states)):
        for f, g, w in zip(type(w_st)._fields, g_st, w_st):
            if not torch.equal(g, w):
                raise AssertionError(f"{tag}: chain {c} state field {f} "
                                     "differs")
    for c, (g, w) in enumerate(zip(g_draws, w_draws)):
        if not torch.equal(g.gen.get_state(), w.gen.get_state()):
            raise AssertionError(f"{tag}: chain {c}'s generator state "
                                 "differs")


# Phase 13 (d) and (f): (case, cell, chains, steps, coupled, profiled
# steps, gibbs_block).
BATCH_CASES = (("main 4", "main", 4, 128, False, 8, 0),
               ("main 16", "main", 16, 64, False, 4, 0),
               ("coupled 4", "main", 4, 64, True, 8, 0),
               ("large 2", "large", 2, 16, False, 4, 0))
BLOCKED_BATCH_CASES = (("blocked main 4", "main", 4, 64, False, 4, 128),
                       ("blocked large 2", "large", 2, 16, False, 2, 512))


def captured_batch_case(dev, smi, case, cell, n_chains, steps, coupled,
                        steps_c, gibbs_block=0, part="d"):
    """Phase 13 (d) at one case: the captured batch (MCMCRunner.run_chains
    under chain_exec="vmap") against the eager batch (mcmc._batch_block over
    the runner's own step) in blocks of `steps` steps from the same initial
    states and generator states, eager, captured, captured, eager, each
    bit for bit against the first: chain-steps/s of each block, the
    replay share of each captured block's piece runs; then a step's costs
    of each form over `steps_c` steps from the end states. With
    `gibbs_block` (13 (f)) the step's Gibbs move is the blocked sweep."""
    import dataclasses
    import functools

    import torch

    from bnpc_tpu_torch import mcmc
    from bnpc_tpu_torch.data import pack_data

    n, k_max, k_clones = ((N, K_MAX, 10) if cell == "main"
                          else (N_LARGE, K_LARGE, 20))
    data, _ = make_data(n, M, k_clones, 0.1, seed=0)
    cfg, mc = bench_configs(n, k_max)
    mc = dataclasses.replace(mc, coupled_moves=coupled,
                             gibbs_block=gibbs_block)
    runner = mcmc.MCMCRunner(cfg, mc, pack_data(data, dev), device=dev,
                             block_size=steps, chain_exec="vmap")
    del data
    step = runner._block.coupled_step if coupled else runner._block.step
    forms = {"eager": functools.partial(mcmc._batch_block, step,
                                        coupled=coupled),
             "captured": runner.run_chains}
    states = [runner.init_chains(TorchDraws(50 + c, dev))[0]
              for c in range(n_chains)]
    gens = [TorchDraws(150 + c, dev).gen.get_state()
            for c in range(n_chains)]

    def fresh(gen_states):
        out = []
        for g in gen_states:
            d = TorchDraws(1, dev)
            d.gen.set_state(g)
            out.append(d)
        return out

    out = {"eager": {"chain_steps_per_s": []},
           "captured": {"chain_steps_per_s": [], "replay_share": []}}
    want = None
    for form in ("eager", "captured", "captured", "eager"):
        pieces = captured_pieces(runner._block.executors)
        before = (pieces.replays, pieces.eager_runs) if pieces else (0, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = forms[form](states, fresh(gens), steps)
        torch.cuda.synchronize()
        out[form]["chain_steps_per_s"].append(
            n_chains * steps / (time.perf_counter() - t0))
        if want is None:
            want = got
        else:
            same_batch(f"{case} {form}", got, want)
        if form == "captured":
            pieces = captured_pieces(runner._block.executors)
            runs = (pieces.replays - before[0], pieces.eager_runs - before[1])
            out["captured"]["replay_share"].append(runs[0] / sum(runs))
    counts = want[1]["mh_counts"]  # [chains, steps, 5, 2]
    out["moves"] = {"splits": int((counts[:, :, 1].sum(-1) > 0).sum()),
                    "merges": int((counts[:, :, 2].sum(-1) > 0).sum())}
    for form in ("eager", "captured"):
        r = out[form]["chain_steps_per_s"]
        out[form].update(min=min(r), median=float(np.median(r)), max=max(r))
    out["ratio"] = out["captured"]["median"] / out["eager"]["median"]
    log(f"  ({part}) {case}: {n_chains} chains x {steps} steps, captured "
        f"batch == eager batch bit for bit (every trace field, each "
        f"chain's state and generator state) in all 4 blocks; {out['moves']}; eager / "
        f"captured / captured / eager ({smi}): eager "
        f"{out['eager']['chain_steps_per_s']}, captured "
        f"{out['captured']['chain_steps_per_s']} chain-steps/s; median "
        f"ratio {out['ratio']:.3f}; replay share of the captured blocks' "
        f"piece runs {out['captured']['replay_share']}")

    end, end_gens = want[0], [d.gen.get_state() for d in want[2]]
    for form, fn in forms.items():
        d = fresh(end_gens)
        torch.cuda.reset_peak_memory_stats()
        costs = launch_profile(lambda: fn(end, d, steps_c), steps_c)
        costs["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
        d = fresh(end_gens)
        costs["host_syncs_per_step"] = syncs_per_step(
            lambda k: fn(end, d, k), steps_c)
        out[form].update(costs)
        log(f"  ({part}) {case} {form}, a step of all {n_chains} chains: "
            f"{costs['host_launches_per_step']:.2f} host-side launches "
            f"{costs['host_launch_calls_per_step']} "
            f"({costs['host_launch_source']}), "
            f"{costs['kernel_executions_per_step']:.1f} kernel executions, "
            f"{costs['host_syncs_per_step']:.3f} host syncs, busy "
            f"{costs['busy_share']:.4f} of {costs['wall_ms_per_step']:.3f} "
            f"ms, peak {costs['peak_mb']:.1f} MB")
    pieces = captured_pieces(runner._block.executors)
    out["graphs"] = len(pieces.graphs)
    out["keys"] = sorted(str(k) for k in pieces.graphs)
    out["capture_seconds"] = pieces.capture_seconds
    out["pool_mb"] = (pieces.pool_bytes() or 0) / 1e6
    log(f"  ({part}) {case}: {out['graphs']} graphs captured "
        f"({', '.join(out['keys'])}) in {out['capture_seconds']:.3f} s; "
        f"pool {out['pool_mb']:.1f} MB")
    return out


def phase_captured_batch(dev, smi):
    """Phase 13 (d): the captured batch against the eager batch in one
    call, at the main cell (4 and 16 chains, 4 coupled) and at the large-n
    cell (2 chains)."""
    t0 = time.perf_counter()
    out = {}
    for case, cell, chains, steps, coupled, steps_c, _ in BATCH_CASES:
        out[case] = captured_batch_case(dev, smi, case, cell, chains, steps,
                                        coupled, steps_c)
    # At the main cell, 4 chains: fewer than 100 host-side launches a step
    # captured, no more host syncs than eager.
    e, c = out["main 4"]["eager"], out["main 4"]["captured"]
    if not (e["host_launches_per_step"] > 100
            and c["host_launches_per_step"] < 100
            and c["host_syncs_per_step"] <= e["host_syncs_per_step"]):
        raise AssertionError(
            f"main 4: host-side launches a step {c['host_launches_per_step']}"
            f" captured / {e['host_launches_per_step']} eager (want < 100 / "
            f"> 100), host syncs {c['host_syncs_per_step']} / "
            f"{e['host_syncs_per_step']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"  (d): {out['seconds']:.1f} s")
    return out


def phase_captured(dev, smi):
    """Phase 13: the one-chain block as captured graphs against the eager
    block in one call, at the main and the large-n cells; then (d), the
    captured batch against the eager batch."""
    t_phase = time.perf_counter()
    out = {}
    out["main"], totals = captured_cell(dev, smi, "main", N, K_MAX, 10, 2,
                                        256, 128, 16)
    if not all(totals[k] for k in ("birth_rounds", "splits", "merges")):
        raise AssertionError(f"main: the compared blocks need a birth "
                             f"round, a split and a merge: {totals}")
    out["large"], _ = captured_cell(dev, smi, "large", N_LARGE, K_LARGE, 20,
                                    1, 32, 16, 4)
    # At the main cell: the profiler sees the eager step's launches, the
    # captured step makes fewer than 20 and no more host syncs.
    e, c = out["main"]["eager"], out["main"]["captured"]
    if not (e["host_launches_per_step"] > 100
            and c["host_launches_per_step"] < 20
            and c["host_syncs_per_step"] <= e["host_syncs_per_step"]):
        raise AssertionError(
            f"main: host-side launches a step {c['host_launches_per_step']} "
            f"captured / {e['host_launches_per_step']} eager (want < 20 / "
            f"> 100), host syncs {c['host_syncs_per_step']} / "
            f"{e['host_syncs_per_step']}")
    out["batch"] = phase_captured_batch(dev, smi)
    out.update(phase_captured_blocked(dev, smi))
    eager_c, lazy_c = (out[c]["captured"]["median"]
                       for c in ("eager main", "main"))
    log(f"  (g) captured eager sweep {eager_c:.3f} steps/s against captured "
        f"lazy {lazy_c:.3f} (main cell, medians of this call)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13: {out['seconds']:.1f} s")
    return out


def fewer_launches(tag, form_out, limit=None):
    """The captured form's host-side launches a step below the eager
    form's (and below `limit`), its host syncs no more than eager's."""
    e, c = form_out["eager"], form_out["captured"]
    if not (c["host_launches_per_step"] < e["host_launches_per_step"]
            and (limit is None or c["host_launches_per_step"] < limit)
            and c["host_syncs_per_step"] <= e["host_syncs_per_step"]):
        raise AssertionError(
            f"{tag}: host-side launches a step {c['host_launches_per_step']}"
            f" captured / {e['host_launches_per_step']} eager (want fewer"
            f"{'' if limit is None else f', under {limit}'}), host syncs "
            f"{c['host_syncs_per_step']} / {e['host_syncs_per_step']}")


def phase_captured_blocked(dev, smi):
    """Phase 13 (e)-(g): the blocked sweep's captured block (one chain,
    main gibbs_block 128 and large-n 512) and captured batch (main 4 x 64,
    large-n 2 x 16), and the eager sweep's captured block (main, through
    make_block_fn), each against its eager form in this call, bit for bit,
    with a step's costs of both forms."""
    t0 = time.perf_counter()
    out = {}
    log("  (e) the blocked sweep, one chain, captured against eager")
    out["blocked main"], totals = captured_cell(
        dev, smi, "blocked main", N, K_MAX, 10, 2, 32, 32, 8,
        gibbs_block=128)
    if totals["birth_blocks"] < 2:
        raise AssertionError(f"blocked main: the compared blocks need two "
                             f"replayed birth blocks: {totals}")
    fewer_launches("blocked main", out["blocked main"])
    out["blocked large"], totals_l = captured_cell(
        dev, smi, "blocked large", N_LARGE, K_LARGE, 20, 1, 8, 4, 2,
        gibbs_block=512)
    log(f"  (e) birth blocks replayed in the compared blocks: main "
        f"{totals['birth_blocks']}, large-n {totals_l['birth_blocks']}")
    log("  (f) the blocked sweep batched, captured against eager")
    for case, cell, chains, steps, coupled, steps_c, gb in \
            BLOCKED_BATCH_CASES:
        out[case] = captured_batch_case(dev, smi, case, cell, chains, steps,
                                        coupled, steps_c, gb, part="f")
    fewer_launches("blocked main 4", out["blocked main 4"])
    log("  (g) the eager sweep (kernel 4), captured against eager")
    out["eager main"], _ = captured_cell(
        dev, smi, "eager main", N, K_MAX, 10, 1, 64, 64, 8,
        gibbs_impl="eager")
    window = out["eager main"]["windows"][0]
    if window["launches"]["eager_sweep"] != window["sweeps"]:
        raise AssertionError(f"eager main: {window['launches']} launches, "
                             f"{window['sweeps']} Gibbs sweeps")
    fewer_launches("eager main", out["eager main"], 20)
    log(f"  (g) kernel 4: {window['launches']['eager_sweep']} launches in "
        f"{window['sweeps']} captured Gibbs sweeps (replays counted); eager "
        f"{out['eager main']['eager']['median']:.3f} against captured "
        f"{out['eager main']['captured']['median']:.3f} steps/s (medians)")
    out["seconds_e_to_g"] = time.perf_counter() - t0
    log(f"  (e)-(g): {out['seconds_e_to_g']:.1f} s")
    return out


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = "cuda"
    smi = nvidia_smi()
    log(f"[1/13] device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    from bnpc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"[2/13] build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc build, one process per source, or cached load: "
        f"{_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line \
                or "Compiling entry" in line:
            log("  " + line.strip())

    log("[3/13] kernels against their plain twins (exact match)")
    k = {"lazy_segment": phase_lazy_segment(dev),
         "rg_scan": phase_rg_scan(dev),
         "lazy_stream": phase_lazy_stream(dev),
         "eager_sweep": phase_eager_sweep(dev),
         "vecflow": phase_vecflow(dev, smi),
         "while_exit": phase_while_exit(dev, smi),
         "mh_sweep": phase_mh_sweep(dev, smi),
         "beta_post": phase_beta_post(dev, smi),
         "rg_assign": phase_rg_assign(dev, smi),
         **phase_rest(dev, smi),
         "sm_accept": phase_sm_accept(dev, smi)}
    log("[4/13] small input: GPU against CPU on identical draws")
    for impl in ("auto", "stream", "eager", "blocked"):
        phase_small(dev, impl)
    log(f"[5/13] main path: MCMCRunner at {N:,} x {M}, k_max {K_MAX} "
        f"({smi})")
    main_out = phase_main(dev)
    log(f"[6/13] large-n path: MCMCRunner at {N_LARGE:,} x {M}, k_max "
        f"{K_LARGE} ({smi})")
    large_out = phase_large(dev)
    log(f"[7/13] eager path: gibbs_impl='eager' at {N:,} x {M}, k_max "
        f"{K_MAX} ({smi})")
    eager_out = phase_eager(dev)
    log(f"  eager {eager_out['steps_per_s']:.3f} steps/s against lazy "
        f"{main_out['steps_per_s']:.3f} steps/s (phase 5), same "
        "configuration")
    log(f"[8/13] probes: their entry points on the card ({smi})")
    probes = phase_probes()
    log(f"[9/13] cli: bnpc_tpu_torch.cli.main on the card ({smi})")
    cli_out = phase_cli(dev, smi)
    log(f"[10/13] run modes at {N:,} x {M}, k_max {K_MAX} ({smi})")
    modes_out = phase_modes(dev, smi)
    log(f"[11/13] mesh: two ranks sharing the card ({smi})")
    mesh_out = phase_mesh(dev, smi)
    log(f"[12/13] batched chains: chain_exec='vmap' ({smi})")
    chains_out = phase_chains(dev, smi, k)
    log(f"[13/13] the one-chain block and the batch captured against "
        f"eager: exact, blocked and eager sweeps ({smi})")
    captured_out = phase_captured(dev, smi)

    chain = probes.pop("chain")
    path_launches = {"lazy_segment": main_out["launches_path"],
                     "rg_scan": large_out["launches_path"],
                     "lazy_stream": large_out["launches_path"],
                     "eager_sweep": eager_out["launches_path"],
                     "vecflow": probes["vecflow"]["launches_path"],
                     "while_exit": probes["while_exit"]["launches_path"]}
    meta = {
        "lazy_segment": ("bnpc_tpu_torch/csrc/lazy_segment.cu",
                         "bnpc_tpu/ops/pallas_gibbs.py:316"),
        "rg_scan": ("bnpc_tpu_torch/csrc/rg_scan.cu",
                    "bnpc_tpu/ops/pallas_rg.py:68"),
        "lazy_stream": ("bnpc_tpu_torch/csrc/lazy_stream.cu",
                        "bnpc_tpu/ops/pallas_gibbs.py:521"),
        "eager_sweep": ("bnpc_tpu_torch/csrc/sweep.cu",
                        "bnpc_tpu/ops/pallas_gibbs.py:78"),
        "vecflow": ("bnpc_tpu_torch/csrc/vecflow_probe.cu",
                    "benchmarks/vecflow_probe.py:36"),
        "while_exit": ("bnpc_tpu_torch/csrc/while_probe.cu",
                       "benchmarks/mosaic_while_probe.py:22"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[name][name],
         "max_abs_err": k[name]["max_abs_err"], "ms": k[name]["ms"],
         "plain_ms": k[name]["plain_ms"], "bound_ms": k[name]["bound_ms"],
         "bound_by": k[name]["bound_by"], "library_ms": None}
        for name, (src, rep) in meta.items()]
    # Kernels 7-12 replace no TPU kernel of their own; their launches are
    # the main path's.
    for name, src in (("mh_sweep", "mh_sweep.cu"),
                      ("beta_post", "beta_post.cu"),
                      ("rg_assign", "rg_assign.cu"),
                      ("error_mh", "error_mh.cu"),
                      ("trace_row", "trace_row.cu"),
                      ("sm_accept", "sm_accept.cu")):
        out = k[name]
        bound_ms, bound_by = out["bound_ms"], out["bound_by"]
        chain_ms = chain["chain_bound_ms"].get(name)
        if chain_ms is not None and chain_ms > bound_ms:
            bound_ms, bound_by = chain_ms, "chain"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bnpc_tpu_torch/csrc/{src}", "replaces": None,
            "launches": main_out["launches_path"][name],
            "max_abs_err": out["max_abs_err"], "ms": out["ms"],
            "plain_ms": out["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            **out.get("fields", {})})
    # Kernels 1-3 and 9 on a chain grid: one launch of 16 chains (1-3),
    # and the batched launches of phase 12's paths (main cell, 4 chains;
    # large-n, 2).
    batched_path = {"lazy_segment": chains_out["main_4"]["launches"],
                    "rg_scan": chains_out["large_2"]["launches"],
                    "lazy_stream": chains_out["large_2"]["launches"],
                    "rg_assign": chains_out["main_4"]["launches"]}
    # And this rank-0 count on phase 11 (e)'s 1 x 2 batched mesh run, and
    # on phase 12 (f)'s batched blocked run at the main cell.
    mesh_path = mesh_out["batched"]["1x2"]["launches_grids"][0]
    blocked_path = chains_out["blocked"]["main_4"]["launches"]
    for entry in kernels:
        name = entry["name"]
        if name in batched_path:
            if name in chains_out["timing"]:
                entry["batched_ms"] = \
                    chains_out["timing"][name]["batched_ms"][16]
            entry["batched_launches"] = batched_path[name][name][0]
            entry["mesh_batched_launches"] = mesh_path[name][0]
            entry["blocked_batched_launches"] = blocked_path[name][0]
    log(json.dumps({"paths": {
        name: {f: out[f] for f in ("steps_per_s", "launches_per_sweep",
                                   "host_syncs_per_step", "clusters", "ari",
                                   "s_count_mean", "s_count_median",
                                   "s_count_max")}
        for name, out in (("main", main_out), ("large", large_out),
                          ("eager", eager_out))},
        "rg_scan": {"serial_route_ms": k["rg_scan"]["serial_route_ms"],
                    "n_large_s_count_n_ms": k["rg_scan"]["large_full_ms"],
                    "n_large_s_count_mean_ms": large_out[
                        "rg_scan_ms_at_s_count_mean"],
                    "n_large_s_count_max_ms": large_out[
                        "rg_scan_ms_at_s_count_max"]},
        "eager_sweep_two_births_ms": k["eager_sweep"]["two_births_ms"],
        "lazy_segment_on_stream_z_ms": k["lazy_stream"][
            "resident_same_z_ms"],
        "vecflow_on_stream_z_ms": k["lazy_stream"]["vecflow_same_z_ms"],
        "probes_beside_lazy_segment": {
            name: {f: k[name][f] for f in ("ms", "lazy_segment_same_input_ms",
                                           "turns_ms")}
            for name in ("vecflow", "while_exit")},
        "chain": chain,
        "probes": {name: {f: v for f, v in out.items()
                          if f != "launches_path"}
                   for name, out in probes.items()},
        "cli": cli_out, "run_modes": modes_out, "mesh": mesh_out,
        "chains": chains_out, "captured": captured_out}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    # The port runs on one device.
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    main()
