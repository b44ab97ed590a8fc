#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (bnpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

  1. device  — a CUDA device must be present; prints its name and power
               limit as nvidia-smi reports them;
  2. build   — compiles the kernels (bnpc_tpu_torch/csrc/*.cu) with nvcc;
  3. kernels — each kernel against its plain torch twin on the card, at the
               main path's shapes (5,000 cells, 256 slots); outputs must match
               exactly; prints each kernel's median time beside its twin's;
  4. small   — 12 steps on a small input, GPU (kernels) against CPU (plain
               twins) fed identical draws: assignments, sizes and MH counts
               exactly, every float to rtol 1e-4 (the two devices' ndtri and
               log differ in the last ulps, and the inverse-CDF proposals
               amplify that in the tails: measured 1.8e-5 on an H100);
  5. main    — the main path: MCMCRunner on the card at the bench
               configuration (5,000 x 200, k_max 256, learned errors,
               sm 0.33 / sm_steps 3 / dpa 0.25 / err 0.25), 256 warm-up and
               256 timed steps; state invariants, both kernels launched,
               steps/s, launches per sweep, host syncs per step, cluster
               count and ARI against the planted truth.

The last three lines are the nvidia-smi line, a JSON line with one entry per
kernel, and {"ok": true, "device": {...}}.
"""

import json
import subprocess
import time
import warnings

import numpy as np

N, M, K_MAX = 5000, 200, 256


def log(msg):
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def make_data(n, m, k_clones, missing, seed=0):
    """The bench's simulated clone matrix (the generator of
    benchmarks/accuracy_bench.py:make_data, numpy only)."""
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 2, size=(k_clones, m))
    assign = rng.integers(0, k_clones, size=n)
    data = geno[assign].astype(float)
    data[(data == 1) & (rng.random((n, m)) < 0.1)] = 0
    data[(data == 0) & (rng.random((n, m)) < 0.001)] = 1
    data[rng.random((n, m)) < missing] = np.nan
    return data, assign


def adjusted_rand(a, b) -> float:
    """Adjusted Rand index of two labelings (numpy only)."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)

    def comb2(x):
        return (x * (x - 1) // 2).sum()

    s_ij = comb2(table)
    s_a, s_b = comb2(table.sum(1)), comb2(table.sum(0))
    expected = s_a * s_b / comb2(np.array([len(a)]))
    return float((s_ij - expected) / (0.5 * (s_a + s_b) - expected))


def bench_configs():
    from bnpc_tpu_torch.config import MCMCConfig, ModelConfig

    cfg = ModelConfig(n_cells=N, n_muts=M, k_max=K_MAX, p=0.25, q=0.25,
                      fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
                      fn_sd=0.1)
    mc = MCMCConfig(sm_prob=0.33, dpa_prob=0.25, error_prob=0.25, sm_steps=3)
    return cfg, mc


def cuda_ms(fn, reps):
    """Median milliseconds of `fn` over `reps` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        d = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
        err = max(err, d)
    return err


# ---------------------------------------------------------------------------
# Phase 3: kernels against their twins
# ---------------------------------------------------------------------------


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

    def case(assign_np, hot_positions, i0):
        aux = np.full(N, -1e30, np.float32)
        aux[perm_h[hot_positions]] = 1e30
        sizes = np.bincount(assign_np, minlength=k_pad).astype(np.float32)
        sizes[K_MAX:] = -1.0
        return (torch.from_numpy(assign_np.astype(np.int32)).to(dev),
                torch.from_numpy(aux).to(dev),
                torch.from_numpy(sizes).to(dev), i0)

    cases = {
        # 200 live slots, 56 free; the new-cluster option never wins.
        "no_birth": case(rng.integers(0, 200, N), [], 0),
        # From position 1000, a birth forced at position 2600.
        "birth": case(rng.integers(0, 200, N), [2600], 1000),
        # Every slot live (>= 19 cells): the first 5 cells' new-cluster
        # option wins with no free slot — vetoed, no birth.
        "veto": case(np.arange(N) % K_MAX, [0, 1, 2, 3, 4], 0),
    }
    expect_info = {"no_birth": (N, -1), "birth": (2601, int(perm_h[2600])),
                   "veto": (N, -1)}
    pairs = []
    for name, (assign, aux, sizes0, i0) in cases.items():
        outs = []
        for fn in (lazy_segment, lazy_segment_ref):
            sizes = sizes0.clone()
            tgt = torch.full((N,), -7, dtype=torch.int32, device=dev)
            info = torch.zeros((4,), dtype=torch.int32, device=dev)
            fn(z, aux, assign, perm, sizes, tgt, info, i0, log_denom)
            torch.cuda.synchronize()
            outs.append((tgt, sizes, info))
        (kt, ks, ki), (rt, rs, ri) = outs
        if not (torch.equal(kt, rt) and torch.equal(ks, rs)
                and torch.equal(ki, ri)):
            raise AssertionError(
                f"lazy_segment {name}: kernel {ki.tolist()} != twin "
                f"{ri.tolist()} or targets/sizes differ")
        i_next, b_cell, _, veto = ki.tolist()
        want_next, want_cell = expect_info[name]
        if (i_next, b_cell) != (want_next, want_cell):
            raise AssertionError(f"lazy_segment {name}: info {ki.tolist()}")
        if (name == "veto") != bool(veto):
            raise AssertionError(f"lazy_segment {name}: veto {veto}")
        pairs += [(kt, rt), (ks, rs), (ki, ri)]
        log(f"  lazy_segment {name}: info {ki.tolist()} — kernel == twin")

    assign, aux, sizes0, i0 = cases["no_birth"]
    buf = [sizes0.clone() for _ in range(21)]
    tgt = torch.empty((N,), dtype=torch.int32, device=dev)
    info = torch.empty((4,), dtype=torch.int32, device=dev)
    it = iter(buf)
    ms = cuda_ms(lambda: lazy_segment(z, aux, assign, perm, next(it), tgt,
                                      info, 0, log_denom), 21)
    plain_ms = cuda_ms(lambda: lazy_segment_ref(
        z, aux, assign, perm, sizes0.clone(), tgt, info, 0, log_denom), 3)
    log(f"  lazy_segment full segment (n={N}, k_pad={k_pad}): kernel "
        f"{ms:.4f} ms, plain twin {plain_ms:.1f} ms")
    return {"max_abs_err": max_err(pairs), "ms": ms, "plain_ms": plain_ms}


def phase_rg_scan(dev):
    import torch

    from bnpc_tpu_torch.ops.cuda_rg import rg_scan, rg_scan_ref

    rng = np.random.default_rng(1)
    dz = torch.from_numpy(
        (rng.standard_normal(N) * 3.0).astype(np.float32)).to(dev)
    lau = torch.from_numpy(rng.integers(0, 2, N).astype(np.int32)).to(dev)
    s1r = torch.arange(N + 2, dtype=torch.float32, device=dev)

    def inputs(s_count):
        n_move = torch.tensor(float(s_count + 2), device=dev)
        dtab = torch.log(s1r + 1.0) \
            - torch.log(torch.clamp(n_move - s1r - 2.0, min=0.0))
        return (dtab, torch.tensor(s_count, dtype=torch.int32, device=dev),
                lau[:s_count].sum().to(torch.int32))

    pairs = []
    for s_count in (0, 1, 37, N):
        dtab, sc, c1 = inputs(s_count)
        out_k = rg_scan(dz, lau, dtab, sc, c1)
        out_r = rg_scan_ref(dz, lau, dtab, sc, c1)
        torch.cuda.synchronize()
        if not torch.equal(out_k[:s_count], out_r[:s_count]):
            raise AssertionError(f"rg_scan s_count={s_count}: kernel != twin")
        pairs.append((out_k[:s_count], out_r[:s_count]))
        log(f"  rg_scan s_count={s_count}: {int(out_k[:s_count].sum())} "
            "cells on side 1 — kernel == twin")
    dtab, sc, c1 = inputs(N)
    ms = cuda_ms(lambda: rg_scan(dz, lau, dtab, sc, c1), 51)
    plain_ms = cuda_ms(lambda: rg_scan_ref(dz, lau, dtab, sc, c1), 3)
    log(f"  rg_scan s_count={N}: kernel {ms:.4f} ms, plain twin "
        f"{plain_ms:.1f} ms")
    return {"max_abs_err": max_err(pairs), "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# Phase 4: small input, GPU against CPU on identical draws
# ---------------------------------------------------------------------------


def phase_small(dev):
    import torch

    from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.draws import TorchDraws
    from bnpc_tpu_torch.mcmc import _make_step_body, resolve_trace_k
    from bnpc_tpu_torch.state import init_state

    class HostDraws(TorchDraws):
        """Draws generated on the CPU and returned on `device`: a CPU run
        and a GPU run consume identical numbers."""

        def __init__(self, seed, device):
            super().__init__(seed, "cpu")
            self.device = torch.device(device)

    n, m = 40, 16
    data, _ = make_data(n, m, 3, 0.1, seed=3)
    cfg = ModelConfig(n_cells=n, n_muts=m, k_max=n, p=0.25, q=0.25,
                      fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
                      fn_sd=0.1)
    mc = MCMCConfig(sm_prob=0.33, dpa_prob=0.25, error_prob=0.25, sm_steps=3)
    trace_k = resolve_trace_k(cfg, mc)
    packed = {d: pack_data(data, d) for d in ("cpu", dev)}
    steps = {d: _make_step_body(cfg, mc, packed[d], trace_k)
             for d in ("cpu", dev)}
    state = init_state(TorchDraws(0, "cpu"), cfg, packed["cpu"], "cpu")
    kinds = np.zeros(3, int)  # gibbs, split, merge
    for s in range(12):
        out = {}
        for d in ("cpu", dev):
            st = type(state)(*(t.to(d) for t in state))
            out[d] = steps[d](st, HostDraws(100 + s, d))
        (cs, cr), (gs, gr) = out["cpu"], out[dev]
        for f in ("assignment", "cluster_size"):
            if not torch.equal(getattr(cs, f), getattr(gs, f).cpu()):
                raise AssertionError(f"small step {s}: {f} differs")
        if not torch.equal(cr.mh_counts, gr.mh_counts.cpu()):
            raise AssertionError(f"small step {s}: mh_counts differ")
        for a, b in [(cs.params, gs.params), (cs.dp_alpha, gs.dp_alpha),
                     (cs.fp, gs.fp), (cs.fn, gs.fn), (cr.ml, gr.ml),
                     (cr.map_, gr.map_)]:
            torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=0)
        c = cr.mh_counts.numpy()
        kinds += [c[1:3].sum() == 0, c[1].sum() > 0, c[2].sum() > 0]
        state = cs
    log(f"  12 steps GPU == CPU (gibbs/split/merge steps: {kinds.tolist()})")


# ---------------------------------------------------------------------------
# Phase 5: the main path
# ---------------------------------------------------------------------------


def phase_main(dev):
    import torch

    from bnpc_tpu_torch.config import TMAX, TMIN
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.draws import TorchDraws
    from bnpc_tpu_torch.mcmc import MCMCRunner
    from bnpc_tpu_torch.ops import cuda_gibbs, cuda_rg

    data, truth = make_data(N, M, 10, 0.1, seed=0)
    cfg, mc = bench_configs()
    runner = MCMCRunner(cfg, mc, pack_data(data, dev), device=dev,
                        block_size=256)

    # The user-facing entry point once, at a short length.
    res = runner.run((32, 16), seed=0)[0]
    if res.assignments.shape != (33, N) or res.params.shape[0] != 17 \
            or not np.isfinite(res.ML).all():
        raise AssertionError("run(): unexpected result shapes or values")

    state = runner.init_chains(TorchDraws(0, dev))
    draws = TorchDraws(1, dev)
    cuda_gibbs.launches = cuda_rg.launches = 0
    state, warm_rows, draws = runner.run_block(state, draws, 256)
    torch.cuda.synchronize()
    warm = (cuda_gibbs.launches, cuda_rg.launches)
    t0 = time.perf_counter()
    state, rows, draws = runner.run_block(state, draws, 256)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"lazy_segment": cuda_gibbs.launches,
                "rg_scan": cuda_rg.launches}
    timed = (launches["lazy_segment"] - warm[0],
             launches["rg_scan"] - warm[1])
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")

    # State invariants.
    a = state.assignment.cpu().numpy()
    sizes = state.cluster_size.cpu().numpy()
    params = state.params.cpu().numpy()
    if not (np.array_equal(sizes, np.bincount(a, minlength=K_MAX))
            and sizes.sum() == N):
        raise AssertionError("cluster sizes disagree with the assignment")
    if not ((params >= TMIN - 1e-7).all() and (params <= TMAX + 1e-7).all()):
        raise AssertionError("params outside [TMIN, TMAX]")
    if not (np.isfinite(rows["ml"]).all() and np.isfinite(rows["map_"]).all()
            and np.isfinite(warm_rows["ml"]).all()):
        raise AssertionError("non-finite ML/MAP in the trace")

    sm_steps = int((rows["mh_counts"][:, 1:3].sum(axis=(1, 2)) > 0).sum())
    gibbs_sweeps = 256 - sm_steps

    # Host synchronizations per step, counted by torch's sync debug mode
    # over a separate 16-step window (its bookkeeping is not in the timing).
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            runner.run_block(state, draws, 16)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)

    out = {
        "steps_per_s": 256 / seconds,
        "timed_seconds": seconds,
        "gibbs_sweeps": gibbs_sweeps,
        "sm_moves": sm_steps,
        "launches_main_path": launches,
        "launches_timed": {"lazy_segment": timed[0], "rg_scan": timed[1]},
        "lazy_launches_per_sweep": timed[0] / max(gibbs_sweeps, 1),
        "rg_launches_per_sm_move": timed[1] / max(sm_steps, 1),
        "host_syncs_per_step": syncs / 16,
        "clusters": int((sizes > 0).sum()),
        "ari": adjusted_rand(truth, a),
    }
    log(f"  steps/s {out['steps_per_s']:.3f} (256 timed steps, "
        f"{seconds:.3f} s; {gibbs_sweeps} Gibbs sweeps, {sm_steps} "
        "split-merge moves)")
    log(f"  launches: {launches}; per Gibbs sweep "
        f"{out['lazy_launches_per_sweep']:.3f}; rg per split-merge "
        f"{out['rg_launches_per_sm_move']:.3f}")
    log(f"  host syncs per step {out['host_syncs_per_step']:.3f}; clusters "
        f"{out['clusters']}; ARI vs truth {out['ari']:.4f}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = "cuda"
    smi = nvidia_smi()
    log(f"[1/5] device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    import bnpc_tpu_torch  # noqa: F401  (precision pins)
    from bnpc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"[2/5] build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  " + line.strip())

    log("[3/5] kernels against their plain twins (exact match)")
    k1 = phase_lazy_segment(dev)
    k2 = phase_rg_scan(dev)
    log("[4/5] small input: GPU against CPU on identical draws")
    phase_small(dev)
    log("[5/5] main path: MCMCRunner at 5,000 x 200, k_max 256")
    main_out = phase_main(dev)

    kernels = [
        {"name": "lazy_segment", "route": "cuda",
         "source": "bnpc_tpu_torch/csrc/lazy_segment.cu",
         "replaces": "bnpc_tpu/ops/pallas_gibbs.py:316",
         "launches": main_out["launches_main_path"]["lazy_segment"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "rg_scan", "route": "cuda",
         "source": "bnpc_tpu_torch/csrc/rg_scan.cu",
         "replaces": "bnpc_tpu/ops/pallas_rg.py:68",
         "launches": main_out["launches_main_path"]["rg_scan"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
    ]
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
