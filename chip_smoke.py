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
               256 timed steps; state invariants, lazy_segment and rg_scan
               launched, steps/s, launches per sweep, host syncs per step,
               cluster count and ARI against the planted truth; the mean
               and the largest s_count of its rg_scan launches (kept on the
               device, read once after the timed block);
  6. large   — the large-n path: MCMCRunner at 131,072 x 200, k_max 128
               (benchmarks/scale_bench.py's data and configuration), 16
               warm-up and 64 timed steps; the same invariants, lazy_stream
               and rg_scan launched and lazy_segment never; then rg_scan
               timed at 131,072 cells with the mean and the largest s_count
               this path gave it;
  7. eager   — the step body with gibbs_impl="eager" at the bench
               configuration, 64 warm-up and 256 timed steps; the same
               invariants, eager_sweep launched; steps/s beside phase 5's;
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
               posterior ML MAP (lazy_segment and rg_scan launched,
               lazy_stream not), then the 131,072-cell data with -s 64
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
               each chain's state invariants, lazy_segment and rg_scan
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
               1 and 2 launched on each rank, steps/s beside one process's
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
               the 1 x 2 group, kernels 1 and 2 launched batched only, on
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
               128), beside the one-chain wrapper; (b) the main cell, 4
               chains x 128 steps, "vmap" against "sequential" in this call:
               chain by chain assignments and MH counts exactly, floats to
               rtol 1e-6 (and whether bit for bit), chain-steps/s of both,
               every kernel launch of the batched run on a chain grid (the
               grids counted); a profiled step of all 4 chains in each form
               (launches, draw calls, device busy share, host syncs); the
               lazy loop's rounds a sweep against each chain's launches;
               64 steps saved under "vmap" resumed under "sequential" ==
               the uninterrupted run, bit for bit; (c) 16 chains x 64 steps;
               (d) 4 coupled chains x 64 steps; (e) the large-n cell, 2
               chains x 16 steps, kernels 3 and 2 on grids of 2; (f) the
               blocked sweep batched: gibbs_block 128 at the main cell, 4
               chains x 64 steps, and 512 at the large-n cell, 2 x 16, each
               "vmap" against "sequential" in this call, chain by chain bit
               for bit (assignments, MH counts, trace floats), chain-steps/s
               of both, rg_scan the only kernel (batched); at the main cell
               a profiled step of all 4 chains in each form (launches, draw
               calls, busy share, host syncs); (g) cli.main -n 4 -s 128: the
               chain_exec "auto" chose printed, the files parsed. Then
               whether the batch reached the sequential chain-steps/s at
               both cells, exact and blocked (the rules of "auto").

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
    from bnpc_tpu_torch.ops import cuda_gibbs, cuda_rg, cuda_stream, cuda_sweep
    from bnpc_tpu_torch.probes import vecflow_probe, while_probe

    return {"lazy_segment": cuda_gibbs, "rg_scan": cuda_rg,
            "lazy_stream": cuda_stream, "eager_sweep": cuda_sweep,
            "vecflow": vecflow_probe, "while_exit": while_probe}


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

    assign, aux, sizes0, _ = cases["no_birth"][0]
    buf = iter([sizes0.clone() for _ in range(21)])
    tgt = torch.empty((N,), dtype=torch.int32, device=dev)
    info = torch.empty((4,), dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: lazy_segment(z, aux, assign, perm, next(buf), tgt,
                                      info, 0, log_denom), 21)
    plain_ms = cuda_ms(lambda: lazy_segment_ref(
        z, aux, assign, perm, sizes0.clone(), tgt, info, 0, log_denom), 3)
    # Every cell: its z row, aux, assign and perm entries in, its target
    # out; the sizes row in and out.
    bound_ms, bound_by = bound(4 * (N * k_pad + 4 * N + 2 * k_pad + 4),
                               OPS_PER_SLOT * N * k_pad)
    log(f"  lazy_segment full segment (n={N}, k_pad={k_pad}): kernel "
        f"{ms:.4f} ms, plain twin {plain_ms:.1f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by})")
    return {"max_abs_err": max_err(pairs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    from bnpc_tpu_torch.mcmc import _make_step_body, resolve_trace_k
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
    steps = {d: _make_step_body(cfg, mc, packed[d], trace_k, gibbs_impl)
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
    """While active, notes the s_count of every rg_scan launch of the
    split-merge move in a device buffer (one small device copy a launch,
    no host read); `read()` fetches them once, afterwards."""

    def __init__(self, dev, cap=4096):
        import torch

        self.buf = torch.zeros((cap,), dtype=torch.int32, device=dev)
        self.count = 0

    def __enter__(self):
        from bnpc_tpu_torch.models import splitmerge

        self.scan = splitmerge.rg_scan

        def noting(dz_v, lau_v, dtab, s_count, count1):
            if self.count < self.buf.shape[0]:
                self.buf[self.count].copy_(s_count)
            self.count += 1
            return self.scan(dz_v, lau_v, dtab, s_count, count1)

        splitmerge.rg_scan = noting
        return self

    def __exit__(self, *exc):
        from bnpc_tpu_torch.models import splitmerge

        splitmerge.rg_scan = self.scan

    def read(self):
        return self.buf[:min(self.count, self.buf.shape[0])].cpu().numpy()


def timed_path(name, run_block, state, draws, warm, timed, n, k_max, truth,
               sweep_kernel):
    """Warm up, time, check and summarize one path. `run_block(state,
    draws, steps)` returns (state, rows, draws)."""
    import torch

    from bnpc_tpu_torch.estimators import ari

    reset_launches()
    with ScanLengths(state.assignment.device) as scans:
        state, warm_rows, draws = run_block(state, draws, warm)
        torch.cuda.synchronize()
        warm_launches = read_launches()
        t0 = time.perf_counter()
        state, rows, draws = run_block(state, draws, timed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = read_launches()
    s_counts = scans.read()
    if s_counts.size != launches["rg_scan"]:
        raise AssertionError(f"{name}: {s_counts.size} scan lengths noted, "
                             f"{launches['rg_scan']} rg_scan launches")
    check_launches(name, launches, {sweep_kernel, "rg_scan"})
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
        "rg_launches_per_sm_move": timed_l["rg_scan"] / max(sm_steps, 1),
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
        f"sweep {out['launches_per_sweep']:.3f}; rg_scan per split-merge "
        f"{out['rg_launches_per_sm_move']:.3f}")
    log(f"  host syncs per step {out['host_syncs_per_step']:.3f}; clusters "
        f"{out['clusters']}; ARI vs truth {out['ari']:.4f}")
    log(f"  s_count over the {s_counts.size} rg_scan launches: mean "
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

    # The user-facing entry point once, at a short length.
    res = runner.run((32, 16), seed=0)[0]
    if res.assignments.shape != (33, N) or res.params.shape[0] != 17 \
            or not np.isfinite(res.ML).all():
        raise AssertionError("run(): unexpected result shapes or values")

    return timed_path("main", runner.run_block,
                      runner.init_chains(TorchDraws(0, dev))[0],
                      TorchDraws(1, dev), 256, 256, N, K_MAX, truth,
                      "lazy_segment")


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
    out = timed_path("large", runner.run_block,
                     runner.init_chains(TorchDraws(0, dev))[0],
                     TorchDraws(1, dev), 16, 64, N_LARGE, K_LARGE, truth,
                     "lazy_stream")
    # The scan alone at the lengths this path really gave it.
    for key in ("mean", "max"):
        s_count = int(out[f"s_count_{key}"])
        out[f"rg_scan_ms_at_s_count_{key}"] = rg_time(N_LARGE, s_count, 6,
                                                      dev, 21)
        log(f"  rg_scan at n={N_LARGE}, s_count={s_count} (this path's "
            f"{key}): {out[f'rg_scan_ms_at_s_count_{key}']:.4f} ms")
    return out


def phase_eager(dev):
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.draws import TorchDraws
    from bnpc_tpu_torch.mcmc import (_make_step_body, _rows_to_host,
                                     resolve_trace_k)
    from bnpc_tpu_torch.state import init_state

    data, truth = make_data(N, M, 10, 0.1, seed=0)
    cfg, mc = bench_configs()
    packed = pack_data(data, dev)
    step = _make_step_body(cfg, mc, packed, resolve_trace_k(cfg, mc),
                           gibbs_impl="eager")

    def run_block(state, draws, n_steps):
        keys = draws.split(n_steps + 1)
        rows = []
        for k in keys[1:]:
            state, row = step(state, k)
            rows.append(row)
        return state, _rows_to_host(rows), keys[0]

    state = init_state(TorchDraws(0, dev).split(1)[0], cfg, packed, dev)
    return timed_path("eager", run_block, state, TorchDraws(1, dev), 64, 256,
                      N, K_MAX, truth, "eager_sweep")


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
    check_launches(f"cli {cell}", launches, {sweep, "rg_scan"})
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
    check_launches("chains", launches, {"lazy_segment", "rg_scan"})
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
    check_launches("coupled", launches, {"lazy_segment", "rg_scan"})
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
    exact path's, the same steps from the same state in this call;
    launches (the blocked Gibbs move launches no Gibbs kernel); ARI."""
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
        used = {"rg_scan"} if gibbs < timed else set()
        if name == "exact" and gibbs:
            used.add(sweep)
        check_launches(f"blocked {n} {name}", launches, used)
        out[name] = {"steps_per_s": timed / secs, "gibbs_sweeps": gibbs,
                     "launches": launches, "ari": ari(a, truth),
                     "clusters": int((sizes > 0).sum())}
    log(f"  (f) blocked at {n:,} x {M}, k_max {k_max}, gibbs_block {block}: "
        f"{out['blocked']['steps_per_s']:.3f} steps/s against the exact "
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
    equal on the ranks of a mutation group; kernels 1 and 2 batched, on
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
            for name in ("lazy_segment", "rg_scan"):
                g = grids[name][1]
                if 2 not in g or max(g) > 2:
                    raise AssertionError(f"{tag} vmap rank {r}: {name} "
                                         f"grids {g}")
            check_launches(f"{tag} vmap rank {r}", run["launches"],
                           {"lazy_segment", "rg_scan"})
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
    equal across the ranks at every block, kernels 1 and 2 on each rank,
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
                           {"lazy_segment", "rg_scan"})
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
                           {"lazy_segment", "rg_scan"})
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
                    or ln["eager_sweep"]:
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
    """{kernel: (batched launches, {grid: launches})} of the three sampler
    kernels that take a chain grid."""
    from bnpc_tpu_torch.ops import cuda_gibbs, cuda_rg, cuda_stream

    return {name: (mod.chain_launches, dict(mod.chain_grids))
            for name, mod in (("lazy_segment", cuda_gibbs),
                              ("rg_scan", cuda_rg),
                              ("lazy_stream", cuda_stream))}


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
                   n, k_max, bits=False, **kw):
    """One run under chain_exec="vmap" and one under "sequential" (same
    seed, same call): equal chain by chain (with `bits`, bit for bit);
    chain-steps/s of both; the batched run's launches (every kernel launch
    of it on a chain grid); the Gibbs kernel's rounds a batched sweep where
    the run's Gibbs move launches one (not the blocked sweep)."""
    import torch

    out, results = {}, {}
    sweep = next((k for k in ("lazy_stream", "lazy_segment")
                  if k in kernels), None)
    for ex in ("vmap", "sequential"):
        runner = chains_runner(data, cfg, mc, dev, ex, **kw)
        kept = KeepStates(runner)
        reset_launches()
        with SweepCounts() as sweeps:
            t0 = time.perf_counter()
            results[ex] = runner.run((steps, steps // 2), seed=seed,
                                     n_chains=n_chains)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        check_results(f"{tag} {ex}", results[ex], kept.states, n, k_max,
                      steps + 1)
        out[ex] = {"chain_steps_per_s": n_chains * steps / secs,
                   "seconds": secs}
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
            batched = read_chain_launches()
            if any(single.values()) or any(
                    (batched[k][0] > 0) != (k in kernels) for k in batched):
                raise AssertionError(f"{tag}: one-chain launches {single}, "
                                     f"batched {batched}; expected only "
                                     f"{sorted(kernels)}, batched")
            out["launches"] = batched
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
    log(f"  {tag}: {n_chains} chains x {steps} steps; vmap "
        f"{out['vmap']['chain_steps_per_s']:.3f} chain-steps/s, sequential "
        f"{out['sequential']['chain_steps_per_s']:.3f} (x{out['ratio']:.3f}"
        f"); vmap == sequential chain by chain (bit for bit: "
        f"{out['bit_for_bit']}); batched launches (kernel: (launches, "
        f"{{grid: launches}})) {out['launches']}{rounds}")
    return out


class SweepCounts:
    """While active, counts the exact Gibbs sweeps of the lazy and stream
    impls (``_segment_impl``), one-chain and batched (one call for a
    sub-batch of chains)."""

    def __enter__(self):
        from bnpc_tpu_torch.models import gibbs

        self.one, self.batched = 0, 0
        self.saved = fn = gibbs._segment_impl

        def counted(state, *args, **kwargs):
            if state.assignment.dim() == 1:
                self.one += 1
            else:
                self.batched += 1
            return fn(state, *args, **kwargs)

        gibbs._segment_impl = counted
        return self

    def __exit__(self, *exc):
        from bnpc_tpu_torch.models import gibbs

        gibbs._segment_impl = self.saved


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
        batch[0], _ = runner._step(batch[0], StackedDraws(gens))

    seq = list(states)

    def sequential():
        for c in range(n_chains):
            seq[c], _ = runner._step(seq[c], gens[c])

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
    "vmap" against "sequential" in this call, chain by chain bit for bit;
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
                                   4, 64, 45, {"rg_scan"}, N, K_MAX,
                                   bits=True)
    out["main_4"]["steps"] = chains_step_costs(dev, data, cfg, mc_b, 4, 4,
                                               warm=8)
    log(f"  (f) blocked sweep, gibbs_block 512, large-n, 2 chains x 16 "
        f"steps ({smi})")
    cfg_l, mc_l = bench_configs(N_LARGE, K_LARGE)
    out["large_2"] = chains_compare(
        "blocked large 2", dev, data_l, cfg_l,
        dataclasses.replace(mc_l, gibbs_block=512), 2, 16, 46, {"rg_scan"},
        N_LARGE, K_LARGE, bits=True, block_size=16)
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
    main_kernels = {"lazy_segment", "rg_scan"}
    with part("b"):
        log(f"  (b) main cell, 4 chains x 128 steps ({smi})")
        out["main_4"] = chains_compare("main 4", dev, data, cfg, mc, 4, 128,
                                       41, main_kernels, N, K_MAX)
    with part("b steps"):
        out["main_4"]["steps"] = chains_step_costs(dev, data, cfg, mc, 4, 4)
    with tempfile.TemporaryDirectory() as tmp:
        with part("b resume"):
            chains_resume(dev, data, cfg, mc, tmp)
        with part("c"):
            log(f"  (c) main cell, 16 chains x 64 steps ({smi})")
            out["main_16"] = chains_compare("main 16", dev, data, cfg, mc,
                                            16, 64, 42, main_kernels, N,
                                            K_MAX)
        with part("d"):
            log(f"  (d) coupled, 4 chains x 64 steps ({smi})")
            out["coupled_4"] = chains_compare(
                "coupled 4", dev, data, cfg,
                dataclasses.replace(mc, coupled_moves=True), 4, 64, 43,
                main_kernels, N, K_MAX)
        with part("e"):
            log(f"  (e) large-n, 2 chains x 16 steps ({smi})")
            data_l, _ = make_data(N_LARGE, M, 20, 0.1, seed=0)
            cfg_l, mc_l = bench_configs(N_LARGE, K_LARGE)
            out["large_2"] = chains_compare(
                "large 2", dev, data_l, cfg_l, mc_l, 2, 16, 44,
                {"lazy_stream", "rg_scan"}, N_LARGE, K_LARGE, block_size=16)
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
    log(f"  batched >= sequential chain-steps/s at both cells in this call "
        f"(main 4 and 16 chains, large-n 2): {out['auto_rule_holds']}; "
        f"blocked (main 4, large-n 2): {out['auto_blocked_rule_holds']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12: {out['seconds']:.1f} s; parts (s) "
        + ", ".join(f"{name} {sec:.1f}" for name, sec in parts.items()))
    return out


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = "cuda"
    smi = nvidia_smi()
    log(f"[1/12] device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    from bnpc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"[2/12] build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc, one process per source, {_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line \
                or "Compiling entry" in line:
            log("  " + line.strip())

    log("[3/12] kernels against their plain twins (exact match)")
    k = {"lazy_segment": phase_lazy_segment(dev),
         "rg_scan": phase_rg_scan(dev),
         "lazy_stream": phase_lazy_stream(dev),
         "eager_sweep": phase_eager_sweep(dev),
         "vecflow": phase_vecflow(dev, smi),
         "while_exit": phase_while_exit(dev, smi)}
    log("[4/12] small input: GPU against CPU on identical draws")
    for impl in ("auto", "stream", "eager", "blocked"):
        phase_small(dev, impl)
    log(f"[5/12] main path: MCMCRunner at {N:,} x {M}, k_max {K_MAX} "
        f"({smi})")
    main_out = phase_main(dev)
    log(f"[6/12] large-n path: MCMCRunner at {N_LARGE:,} x {M}, k_max "
        f"{K_LARGE} ({smi})")
    large_out = phase_large(dev)
    log(f"[7/12] eager path: gibbs_impl='eager' at {N:,} x {M}, k_max "
        f"{K_MAX} ({smi})")
    eager_out = phase_eager(dev)
    log(f"  eager {eager_out['steps_per_s']:.3f} steps/s against lazy "
        f"{main_out['steps_per_s']:.3f} steps/s (phase 5), same "
        "configuration")
    log(f"[8/12] probes: their entry points on the card ({smi})")
    probes = phase_probes()
    log(f"[9/12] cli: bnpc_tpu_torch.cli.main on the card ({smi})")
    cli_out = phase_cli(dev, smi)
    log(f"[10/12] run modes at {N:,} x {M}, k_max {K_MAX} ({smi})")
    modes_out = phase_modes(dev, smi)
    log(f"[11/12] mesh: two ranks sharing the card ({smi})")
    mesh_out = phase_mesh(dev, smi)
    log(f"[12/12] batched chains: chain_exec='vmap' ({smi})")
    chains_out = phase_chains(dev, smi, k)

    chain = probes.pop("chain")
    path_launches = {"lazy_segment": main_out["launches_path"],
                     "rg_scan": main_out["launches_path"],
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
    # Kernels 1-3 on a chain grid: one launch of 16 chains, and the batched
    # launches of phase 12's paths (main cell, 4 chains; large-n, 2).
    batched_path = {"lazy_segment": chains_out["main_4"]["launches"],
                    "rg_scan": chains_out["main_4"]["launches"],
                    "lazy_stream": chains_out["large_2"]["launches"]}
    # And this rank-0 count on phase 11 (e)'s 1 x 2 batched mesh run, and
    # on phase 12 (f)'s batched blocked run at the main cell.
    mesh_path = mesh_out["batched"]["1x2"]["launches_grids"][0]
    blocked_path = chains_out["blocked"]["main_4"]["launches"]
    for entry in kernels:
        name = entry["name"]
        if name in batched_path:
            entry["batched_ms"] = chains_out["timing"][name]["batched_ms"][16]
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
        "chains": chains_out}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    # The port runs on one device.
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    main()
