#!/usr/bin/env python3
"""Device kernels a chain-step of the port, by function, on a CUDA card.

    python3 scripts/kernel_census_torch.py [--steps 60] [--warm 30]

Runs the eager one-chain step (mcmc.make_step_fn) at the main path's
configuration (chip_smoke.py: 5,000 x 200, k_max 256, learned errors,
split-merge 0.33 with 3 launch scans) for --warm steps, then --steps steps
under torch.profiler with a record_function range around each function of
FUNCTIONS, and prints one JSON line: each function's calls and the device
kernels its ATen ops launched (the functions it calls included), a call
and a step; the step's device operations in all (kernels, copies and
sets; the hand-written kernels of csrc/, which no ATen op launches,
included); the card. The hand-written kernels' wrappers (the ctypes
launches of KERNELS) are ranges of their own, so each shows beside the
function that calls it. The captured block replays these same kernels as
CUDA graphs, one graph node each.
"""

import argparse
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# (module, function) pairs, wrapped where their callers look them up.
FUNCTIONS = [
    ("bnpc_tpu_torch.mcmc", f) for f in (
        "gibbs_sweep", "split_merge", "update_parameters", "update_dp_alpha",
        "update_error_rates", "summarize")] + [
    ("bnpc_tpu_torch.models.splitmerge", f) for f in (
        "_setup", "_rg_init", "beta_posterior_rows", "_rg_scan_split",
        "_rg_scan_merge", "_rg_scan_assign", "_split_branch",
        "_merge_branch", "_split_accept", "_merge_accept")] + [
    ("bnpc_tpu_torch.ops.mh", f) for f in (
        "mh_cluster_params", "realized_trans_logprob")] + [
    ("bnpc_tpu_torch.ops.cuda_beta", "primitives")] + [
    ("bnpc_tpu_torch.ops.cuda_rg_assign", "noise")]
# The hand-written kernels' ctypes launches: (module, wrapper) pairs.
KERNELS = [("bnpc_tpu_torch.ops.cuda_mh", f)
           for f in ("mh_sweep", "realized")] + [
    ("bnpc_tpu_torch.ops.cuda_beta", "beta_post"),
    ("bnpc_tpu_torch.ops.cuda_rg_assign", "rg_assign"),
    ("bnpc_tpu_torch.ops.cuda_error_mh", "error_mh"),
    ("bnpc_tpu_torch.ops.cuda_row", "ml_map"),
    ("bnpc_tpu_torch.ops.cuda_sm_accept", "launch")]


def wrap_all():
    import importlib

    import torch

    for mod_name, name in FUNCTIONS + KERNELS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)

        @functools.wraps(fn)
        def ranged(*args, _fn=fn, _name=name, **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)

        setattr(mod, name, ranged)


def kernels_under(event) -> int:
    return len(event.kernels) + sum(kernels_under(c)
                                    for c in event.cpu_children)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--warm", type=int, default=30)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from bnpc_tpu_torch import mcmc
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.draws import TorchDraws

    wrap_all()
    dev = "cuda"
    data, _ = cs.make_data(cs.N, cs.M, 10, 0.1, seed=0)
    cfg, mc = cs.bench_configs()
    packed = pack_data(data, dev)
    runner = mcmc.MCMCRunner(cfg, mc, packed, device=dev, block_size=8)
    step = mcmc.make_step_fn(cfg, mc, packed, runner.trace_k)
    state = runner.init_chains(TorchDraws(0, dev))[0]
    draws = TorchDraws(1, dev)
    state, _, draws = mcmc._chain_block(step, state, draws, args.warm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mcmc._chain_block(step, state, draws, args.steps)
        torch.cuda.synchronize()
    names = {f for _, f in FUNCTIONS + KERNELS}
    calls, kernels = {}, {}
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for e in prof.events():
        # Each range is recorded on the device's timeline too: count the
        # host's, which holds the ATen ops and their kernels.
        if e.device_type == cpu and e.name in names:
            calls[e.name] = calls.get(e.name, 0) + 1
            kernels[e.name] = kernels.get(e.name, 0) + kernels_under(e)
    total = sum(e.count for e in prof.key_averages()
                if e.device_type == cuda and e.key not in names)
    print(json.dumps({
        "steps": args.steps, "kernels_per_step": total / args.steps,
        "functions": {name: {"calls": calls[name],
                             "kernels_per_call": kernels[name] / calls[name],
                             "kernels_per_step": kernels[name] / args.steps}
                      for name in sorted(calls)},
        "card": cs.nvidia_smi()}))


if __name__ == "__main__":
    main()
