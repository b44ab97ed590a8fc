"""Command-line interface of the PyTorch / CUDA port (counterpart of
bnpc_tpu/cli.py; reference run_BnpC.py:13-196): the same flags, dests and
defaults, and the same output files.

    python run_bnpc_tpu_torch.py <DATA> [options]

The JAX package's ``tpu`` group becomes the ``device`` group: ``--device``
(cuda unless the caller asks for the CPU), ``--profile`` (a torch.profiler
trace of the sampling, with the job's spans from bnpc_tpu_torch/trace.py
merged in), and the capacity knobs with their meaning.

``--mesh CHAINS,MUTS`` (or ``auto``: every visible GPU on the chain axis)
runs the job on CHAINS x MUTS ranks, one process each
(bnpc_tpu_torch/parallel/): started here on localhost, rank r on
cuda:(r % device count), or found under torchrun. Rank 0 alone prints,
estimates and writes the output files; a failing rank fails the job.
Without ``--mesh`` the job is one process (bnpc_tpu would spread chains
over every visible device; the port does not start processes unasked).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import os
import socket
from datetime import datetime

import torch
import torch.distributed as dist

from bnpc_tpu_torch import io, trace
from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
from bnpc_tpu_torch.data import pack_data
from bnpc_tpu_torch.mcmc import MCMCRunner

def ratio(val):
    val = float(val)
    if val <= 0 or val >= 1:
        raise argparse.ArgumentTypeError(
            f"Invalid value: {val}. Values need to be 0 < x < 1"
        )
    return val


def percent(val):
    val = float(val)
    if val < 0 or val > 1:
        raise argparse.ArgumentTypeError(
            f"Invalid value: {val}. Values need to be 0 <= x <= 1"
        )
    return val


def psrf_cutoff(val):
    val = float(val)
    if val < 1 or val > 1.5:
        raise argparse.ArgumentTypeError(
            f"Invalid value: {val}. Values need to be 1 <= x <= 1.5"
        )
    return val


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="BnpC-TPU-torch",
        usage="python run_bnpc_tpu_torch.py <DATA> [options]",
        description="*** Clustering of single cell data based on a "
                    "Dirichlet process, on one CUDA GPU. ***",
    )
    parser.add_argument("--version", action="version", version="0.1.0-torch")
    parser.add_argument(
        "input",
        help="Path to the input n x m matrix (n = cells, m = mutations) of "
             "0|1 calls; 3 or empty = missing; 2 treated as 1.",
    )
    parser.add_argument(
        "-t", "--transpose", action="store_false",
        help="Transpose the input matrix. Default = True.",
    )
    parser.add_argument(
        "--debug", action="store_true", default=False,
        help="Run with block size 1: the trace is copied to the host after "
             "every step.",
    )

    model = parser.add_argument_group("model")
    model.add_argument("-FN", "--falseNegative", type=float, default=-1,
                       help="Fixed error rate for false negatives.")
    model.add_argument("-FP", "--falsePositive", type=float, default=-1,
                       help="Fixed error rate for false positives.")
    model.add_argument("-FN_m", "--falseNegative_mean", type=ratio,
                       default=0.2, help="Prior mean of the FN rate.")
    model.add_argument("-FN_sd", "--falseNegative_std", type=ratio,
                       default=0.1, help="Prior std dev of the FN rate.")
    model.add_argument("-FP_m", "--falsePositive_mean", type=ratio,
                       default=0.01, help="Prior mean of the FP rate.")
    model.add_argument("-FP_sd", "--falsePositive_std", type=ratio,
                       default=0.01, help="Prior std dev of the FP rate.")
    model.add_argument("-ap", "--DPa_prior", type=float, nargs=2,
                       default=[-1, -1],
                       help="Gamma(a, b) prior on the CRP concentration. "
                            "Default = (sqrt(#cells), 1).")
    model.add_argument("-pp", "--param_prior", type=float, nargs=2,
                       default=[0.25, 0.25],
                       help="Beta(a, b) parameter prior. Default = .25 .25.")
    model.add_argument("-fa", "--fixed_assignment", type=str, default="",
                       help="Cluster-assignment file; if set, the assignment "
                            "is fixed and only parameters are sampled.")

    mcmc = parser.add_argument_group("MCMC")
    mcmc.add_argument("-n", "--chains", type=int, default=1,
                      help="Number of chains, run one after another on "
                           "the device (or sharded by --mesh). "
                           "Default = 1.")
    mcmc.add_argument("-s", "--steps", type=int, default=5000,
                      help="Number of MCMC steps. Default = 5000.")
    mcmc.add_argument("-r", "--runtime", type=int, default=-1,
                      help="Runtime in minutes; overrides steps.")
    mcmc.add_argument("-ls", "--lugsail", type=psrf_cutoff, default=-1,
                      help="Terminate when the lugsail PSRF undercuts this "
                           "threshold (e.g. 1.05).")
    mcmc.add_argument("-b", "--burn_in", type=percent, default=0.33,
                      help="Ratio of steps discarded as burn-in.")
    mcmc.add_argument("-cup", "--conc_update_prob", type=percent,
                      default=0.25,
                      help="Probability of updating the CRP concentration.")
    mcmc.add_argument("-eup", "--error_update_prob", type=percent,
                      default=0.25,
                      help="Probability of updating the error rates.")
    mcmc.add_argument("-smp", "--split_merge_prob", type=percent,
                      default=0.33,
                      help="Probability of a split/merge step instead of a "
                           "Gibbs sweep.")
    mcmc.add_argument("-sms", "--split_merge_steps", type=int, default=3,
                      help="Restricted Gibbs scans per split-merge move.")
    mcmc.add_argument("-smr", "--split_merge_ratios", type=percent, nargs=2,
                      default=[0.75, 0.25], help="Split:merge ratio.")
    mcmc.add_argument("-e", "--estimator", type=str, default="posterior",
                      nargs="+", choices=["posterior", "ML", "MAP"],
                      help="Estimator(s) used for inference.")
    mcmc.add_argument("-sc", "--single_chains", action="store_true",
                      default=False,
                      help="Infer a result per chain individually.")
    mcmc.add_argument("--seed", type=int, default=-1,
                      help="Random seed. Default = random.")

    output = parser.add_argument_group("output")
    output.add_argument("-o", "--output", type=str, default="",
                        help="Output directory. "
                             "Default = <DATA_DIR>/<TIMESTAMP>.")
    output.add_argument("-v", "--verbosity", type=int, default=1,
                        choices=[0, 1, 2], help="Stdout verbosity.")
    output.add_argument("-np", "--no_plots", action="store_true",
                        default=False,
                        help="Skip result plots (they need matplotlib and "
                             "seaborn).")
    output.add_argument("-tr", "--tree", type=str, default="",
                        help="Path to the data-generating tree (.gv) for "
                             "cluster-colored rendering.")
    output.add_argument("-tc", "--true_clusters", type=str, default="",
                        help="Path to the true cluster assignment.")
    output.add_argument("-td", "--true_data", type=str, default="",
                        help="Path to the true/raw genotypes.")

    device = parser.add_argument_group("device")
    device.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; an error without a CUDA "
                             "device) or cpu.")
    device.add_argument("--max_clusters", type=int, default=-1,
                        help="Cluster-slot capacity k_max. Default = "
                             "min(n_cells, 256); n_cells reproduces the "
                             "reference exactly.")
    device.add_argument("--trace_clusters", type=int, default=-1,
                        help="Cluster rows kept per parameter-trace step. "
                             "Default = min(k_max, 128).")
    device.add_argument("--block_size", type=int, default=256,
                        help="MCMC steps between host copies of the trace.")
    device.add_argument("--profile", type=str, default="",
                        help="Write a torch.profiler trace of the sampling "
                             "run, with the job's program spans, to this "
                             "directory (chrome trace JSON).")
    device.add_argument("--checkpoint_dir", type=str, default="",
                        help="Directory for sampler checkpoints; a run "
                             "resumes from the checkpoint found there.")
    device.add_argument("--mesh", type=str, default="",
                        help="Rank-mesh shape as CHAINS,MUTS (e.g. '2,4' = "
                             "chains sharded over 2 groups of ranks, the "
                             "mutation axis split 4-ways inside each), or "
                             "'auto' for every visible GPU on the chain "
                             "axis. One process per rank. Default: one "
                             "process.")
    device.add_argument("--blocked_gibbs", type=int, default=0,
                        help="Approximate blocked Gibbs sweep with this "
                             "many cells a block (0 = the exact sweep).")
    device.add_argument("--coupled_moves", action="store_true",
                        default=False,
                        help="One move selection a step shared by all "
                             "chains; each chain's moves keep their own "
                             "draws. With several chains on a GPU the "
                             "chains run as one batch or one after another "
                             "as the runner's chain_exec 'auto' decides "
                             "(printed).")

    return parser.parse_args(argv)


def mesh_shape(args) -> tuple[int, int] | None:
    """--mesh CHAINS,MUTS | auto -> (C, M); None without --mesh. The checks
    and messages of bnpc_tpu's build_mesh (bnpc_tpu/cli.py:308-330); 'auto'
    is (GPU count, 1), or one process where that count does not divide
    -n (bnpc_tpu then leaves the chains unsharded)."""
    if not args.mesh:
        return None
    if args.mesh == "auto":
        c = torch.cuda.device_count() if args.device.startswith("cuda") \
            else 1
        return (c if c > 1 and args.chains % c == 0 else 1, 1)
    try:
        c, m = (int(x) for x in args.mesh.split(","))
        if c < 1 or m < 1:
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"error: --mesh must be CHAINS,MUTS or 'auto', got {args.mesh!r}"
        )
    if args.chains % c != 0:
        raise SystemExit(
            f"error: --mesh chain axis {c} must divide -n {args.chains}"
        )
    return c, m


def build_mesh(shape):
    """The process group's mesh of `shape` (None for one process)."""
    if shape is None or shape == (1, 1):
        return None
    from bnpc_tpu_torch.parallel import sharded

    try:
        return sharded.make_mesh(*shape)
    except ValueError as e:
        raise SystemExit(f"error: {e}")


def _rank_main(rank: int, args, world: int, port: int) -> None:
    """One rank of a job that launch() started."""
    from bnpc_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", world, rank,
                         device=args.device)
    try:
        main(args)
    finally:
        dist.destroy_process_group()


def launch(args, world: int) -> None:
    """Run the job on `world` ranks on this host (spawned processes) and
    wait for them; any rank that fails fails the job (the others are
    stopped)."""
    import torch.multiprocessing as mp

    if args.device.startswith("cuda"):
        # Built once here, not raced by the ranks.
        from bnpc_tpu_torch.ops import _build

        _build.load_library()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        mp.start_processes(_rank_main, args=(args, world, port),
                           nprocs=world, start_method="spawn")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise SystemExit(f"error: --mesh {args.mesh}: a rank failed: {e}")


def resolve_device(name: str) -> torch.device:
    """--device: the CPU only when asked for; cuda without a CUDA device
    is an error, never a silent run on the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if not name.startswith("cuda"):
        raise SystemExit(f"error: --device {name}: expected cuda or cpu")
    if not torch.cuda.is_available():
        raise SystemExit(
            f"error: --device {name}: no CUDA device is available "
            "(torch.cuda.is_available() is false); pass --device cpu to run "
            "on the CPU"
        )
    return torch.device(name)


def check_plotting() -> None:
    """Plots need matplotlib and seaborn: fail before sampling, not after."""
    for pkg in ("matplotlib", "seaborn"):
        try:
            importlib.import_module(pkg)
        except ImportError as e:
            raise SystemExit(
                f"error: plots need {pkg}, which does not import here "
                f"({e}); install it or pass -np/--no_plots"
            )


def build_model_config(args, n_cells: int, n_muts: int,
                       note: bool = True) -> ModelConfig:
    """Model selection: fixed errors iff both -FP and -FN are positive
    (run_BnpC.py:249-262). `note` prints the capacity note."""
    k_max = args.max_clusters if args.max_clusters > 0 else min(n_cells, 256)
    k_max = min(k_max, n_cells)
    if k_max < n_cells and args.max_clusters <= 0 and note:
        import sys

        print(
            f"NOTE: cluster capacity capped at k_max={k_max} < "
            f"{n_cells} cells (the reference can occupy up to one cluster "
            "per cell). The cap truncates the CRP prior's tail; posterior "
            "summaries are unaffected while the sampled cluster count stays "
            "well below it (typical K ~ alpha*log n). Raise it with "
            "--max_clusters if needed.",
            file=sys.stderr,
        )
    common = dict(
        n_cells=n_cells, n_muts=n_muts, k_max=k_max,
        p=args.param_prior[0], q=args.param_prior[1],
        dp_a_shape=args.DPa_prior[0], dp_a_loc=args.DPa_prior[1],
    )
    if args.falsePositive > 0 and args.falseNegative > 0:
        args.error_update_prob = 0
        return ModelConfig(
            fp=args.falsePositive, fn=args.falseNegative,
            learn_errors=False, **common,
        )
    return ModelConfig(
        fp=args.falsePositive_mean, fn=args.falseNegative_mean,
        fp_sd=args.falsePositive_std, fn_sd=args.falseNegative_std,
        learn_errors=True, **common,
    )


def build_mcmc_config(args) -> MCMCConfig:
    return MCMCConfig(
        sm_prob=args.split_merge_prob,
        dpa_prob=args.conc_update_prob,
        error_prob=args.error_update_prob,
        sm_split_ratio=args.split_merge_ratios[0],
        sm_steps=args.split_merge_steps,
        fix_assign=bool(args.fixed_assignment),
        trace_k=max(args.trace_clusters, 0),
        gibbs_block=max(args.blocked_gibbs, 0),
        coupled_moves=args.coupled_moves,
    )


def describe(cfg: ModelConfig, mcmc_cfg: MCMCConfig) -> str:
    if cfg.learn_errors:
        errors = (
            "\tlearning errors\n\n\tPriors:\n"
            f"\tparams.:\tBeta({cfg.p},{cfg.q})\n"
            f"\tCRP a_0:\tGamma({cfg.dp_a_shape:.2f},{cfg.dp_a_loc})\n"
            f"\tFP:\t\ttrunc norm({cfg.fp},{cfg.fp_sd})\n"
            f"\tFN:\t\ttrunc norm({cfg.fn},{cfg.fn_sd})\n"
        )
    else:
        errors = (
            f"\tFixed FN rate: {cfg.fn}\n\tFixed FP rate: {cfg.fp}\n"
            "\n\tPriors:\n"
            f"\tParams.:\tBeta({cfg.p},{cfg.q})\n"
            f"\tCRP a_0:\tGamma({cfg.dp_a_shape:.1f},{cfg.dp_a_loc})\n"
        )
    moves = (
        "Move probabilitites:\n"
        f"\tSplit/merge:\t{mcmc_cfg.sm_prob}\n"
        f"\t\tsplit/merge ratio:\t[{mcmc_cfg.sm_split_ratio}, "
        f"{1 - mcmc_cfg.sm_split_ratio:.2g}]\n"
        f"\t\tintermediate Gibbs:\t{mcmc_cfg.sm_steps}\n"
        f"\tCRP a_0 update:\t{mcmc_cfg.dpa_prob}\n"
        f"\tErrors update:\t{mcmc_cfg.error_prob}\n"
    )
    return (
        f"\nDPMM with:\n\t{cfg.n_cells} cells\n\t{cfg.n_muts} mutations\n"
        f"{errors}\n{moves}"
    )


def generate_output(args, results, data_raw, names) -> None:
    """Inference + all result artifacts (run_BnpC.py:203-239)."""
    out_dir = io.get_out_dir(args)
    with trace.span("cli.estimate"):
        inferred, psrf, steps = io.infer_results(args, results, data_raw,
                                                 device=args.device)
    # Recorded on args so show_mcmc_summary and args.txt see them (the
    # reference persists both, libs/dpmmIO.py:199-202).
    args.PSRF = psrf
    args.steps = steps

    if args.verbosity > 0:
        io.show_mcmc_summary(args, results)
        io.show_assignments(inferred, names[0])
        io.show_latents(inferred)
        print(f"\nWriting output to: {out_dir}\n")

    with trace.span("cli.write"):
        io.save_run(inferred, args, out_dir, names)

    if args.true_clusters:
        true_assign = io.load_assignment_txt(args.true_clusters)
        io.save_v_measure(inferred, true_assign, out_dir)
        io.save_ari(inferred, true_assign, out_dir)

    data_true = None
    if args.true_data:
        data_true = io.load_data(args.true_data, transpose=args.transpose)
        io.save_hamming_dist(inferred, data_true, out_dir)

    if args.no_plots:
        return

    from bnpc_tpu_torch import plotting

    plotting.save_trace_plots(results, out_dir)
    if args.tree:
        plotting.save_tree_plots(args.tree, inferred, out_dir, args.transpose)
    plotting.save_geno_plots(
        inferred, data_true if data_true is not None else data_raw,
        out_dir, names,
    )
    if data_raw.shape[0] < 300:
        plotting.save_similarity(args, inferred, results, out_dir)


def profile_context(args, device: torch.device):
    """--profile DIR: a torch.profiler trace of the sampling run, written
    to DIR/trace.json (chrome trace format); ``main`` merges the job's
    spans into it."""
    if not args.profile:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    trace = os.path.join(args.profile, "trace.json")
    return profile(activities=activities,
                   on_trace_ready=lambda p: p.export_chrome_trace(trace))


def main(args) -> None:
    """One job (``cli.main``, its stages spans of the tracer when it is
    on). ``--profile DIR`` turns the tracer on for the job, unless the
    caller has, and merges its spans into DIR/trace.json."""
    traced = bool(args.profile) and not trace.on
    if traced:
        trace.enable()
    try:
        if trace.on:
            trace.new_run()
        with trace.span("cli.main"):
            root = _job(args)
    finally:
        if traced:
            spans = trace.take()["spans"]
            trace.disable()
    if traced and root:
        trace.merge_chrome_trace(os.path.join(args.profile, "trace.json"),
                                 spans)


def _job(args) -> bool:
    """main's job; whether this process is the job's root (False where it
    only started the ranks)."""
    shape = mesh_shape(args)
    device = resolve_device(args.device)
    if not args.no_plots:
        check_plotting()
    if shape is not None and shape[0] * shape[1] > 1 \
            and not dist.is_initialized():
        from bnpc_tpu_torch.parallel import multihost

        # Under torchrun the group is in the environment; else start it.
        if not multihost.initialize(device=args.device):
            launch(args, shape[0] * shape[1])
            return False
    mesh = build_mesh(shape)
    root = mesh is None or mesh.is_root
    if not root:
        args.verbosity = 0
    io.process_sim_folder(args, suffix="")
    try:
        with trace.span("cli.load"):
            data, names = io.load_data(
                args.input, transpose=args.transpose, get_names=True
            )
    except FileNotFoundError:
        raise SystemExit(f"error: input file not found: {args.input}")
    if data.size == 0:
        raise SystemExit(f"error: could not read data from {args.input}")

    cfg = build_model_config(args, data.shape[0], data.shape[1], note=root)
    mcmc_cfg = build_mcmc_config(args)
    if device.type == "cuda":
        from bnpc_tpu_torch.ops.cuda_gibbs import stream_k_pad

        try:
            stream_k_pad(cfg.k_max)
        except ValueError as e:
            raise SystemExit(f"error: --max_clusters: {e}")

    args.time = [datetime.now()]
    run_var, run_str = io.get_mcmc_termination(args)

    if args.verbosity > 0:
        print(describe(cfg, mcmc_cfg))
        print(f"Run MCMC with ({args.chains} chains {run_str}):")

    if args.debug:
        # One chain, one step a block (bnpc_tpu/cli.py's --debug).
        args.chains = 1
        args.block_size = 1

    with trace.span("cli.pack"):
        packed = pack_data(data, device)
    with trace.span("cli.runner"):
        runner = MCMCRunner(cfg, mcmc_cfg, packed, device=device,
                            block_size=args.block_size,
                            checkpoint_dir=args.checkpoint_dir or None,
                            mesh=mesh)
    if args.verbosity > 0 and root and args.chains > 1:
        print(f"\tchain_exec: {runner.chain_exec}")
    assign = (
        io.load_assignment_txt(args.fixed_assignment)
        if args.fixed_assignment else None
    )
    with profile_context(args, device) if root else \
            contextlib.nullcontext(), trace.span("cli.sample"):
        chain_results = runner.run(
            run_var, args.seed, n_chains=args.chains, assign=assign,
            verbosity=args.verbosity,
        )
    if not root:
        return False
    args.chain_seeds = list(map(int, runner.seeds))
    results = [r.as_dict() for r in chain_results]
    args.time.append(datetime.now())

    generate_output(args, results, data, names)
    return True


def entry(argv=None) -> None:
    main(parse_args(argv))


if __name__ == "__main__":
    entry()
