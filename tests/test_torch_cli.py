"""The port's io, CLI and runner hand-over against bnpc_tpu's.

Every case of tests/test_io.py runs on the port's io (and of
tests/test_trees.py on its trees and plotting); the loader agrees
with bnpc_tpu's pandas path on malformed files where bnpc_tpu's fast path
does not (a " " cell); the writers give bnpc_tpu's bytes for the same
`inferred`. The CLI parses bnpc_tpu's flag table, refuses a bad --mesh
before anything runs, as bnpc_tpu does, runs --mesh on gloo CPU ranks, and
writes bnpc_tpu's files: both packages' generate_output on one set of port
results give byte-identical files.
No test runs bnpc_tpu's sampler (its compile takes minutes); the port
samples on the CPU at 60 x 30.
"""

import inspect
import os
import subprocess
import sys
import types
import warnings
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from bnpc_tpu import cli as jax_cli
from bnpc_tpu import io as jax_io
from bnpc_tpu import mcmc as jax_mcmc
from bnpc_tpu_torch import cli as port_cli
from bnpc_tpu_torch import estimators as port_est
from bnpc_tpu_torch import io as port_io
from bnpc_tpu_torch import mcmc as port_mcmc
from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
from bnpc_tpu_torch.data import pack_data
from tests import test_io, test_trees
from tests.torch_parity import make_problem

torch.set_num_threads(1)

N, M = 60, 30


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(
    name for name in dir(test_io) if name.startswith("test_")))
def test_io_case_on_port(case, tmp_path, monkeypatch):
    """tests/test_io.py's case with its `io` module swapped for the port's."""
    monkeypatch.setattr(test_io, "io", port_io)
    fn = getattr(test_io, case)
    fn(*[tmp_path] if "tmp_path" in inspect.signature(fn).parameters else [])


@pytest.mark.parametrize("case", [
    "test_newick_to_gv", "test_edges_from_newick",
    "test_edges_from_gv_and_collapse", "test_color_tree_nodes"])
def test_trees_case_on_port(case, tmp_path, monkeypatch):
    """tests/test_trees.py's case on the port's trees and plotting."""
    from bnpc_tpu_torch import plotting
    from bnpc_tpu_torch.utils import trees

    monkeypatch.setattr(test_trees, "trees", trees)
    monkeypatch.setattr(test_trees, "plotting", plotting)
    fn = getattr(test_trees, case)
    fn(*[tmp_path] if "tmp_path" in inspect.signature(fn).parameters else [])


def test_newick_edges_match_jax():
    from bnpc_tpu.utils import trees as jax_trees
    from bnpc_tpu_torch.utils import trees

    for case in ("((Acell1:0.1,Acell2:0.2):0.3,Acell3:0.4)",
                 "(((Xcell1:0.11,Xcell2:0.22):0.5,(Xcell3:0.1,Xcell4:0.3)"
                 ":0.7):0.2,(Xcell5:0.9,Xcell6:0.01):0.6)",
                 "(Bcell2:0.5,(Bcell1:0.25,Bcell3:0.75):0.125)"):
        assert trees.edges_from_newick(case) == \
            jax_trees.edges_from_newick(case)


def _load(mod, path):
    try:
        return mod.load_data(path, get_names=True)
    except Exception as e:  # noqa: BLE001 - the error is what is compared
        return type(e)


def _jax_pandas_path(path, monkeypatch):
    """bnpc_tpu.io.load_data with its fast parser disabled."""
    def no_fast(*args, **kwargs):
        raise ValueError("fast path disabled")

    with monkeypatch.context() as m:
        m.setattr(jax_io.np, "fromstring", no_fast)
        return _load(jax_io, path)


@pytest.mark.parametrize("text", [
    "0,1, ,1\n1,0,1,0\n1,1,0,3\n",     # a " " cell: -1.0 in the fast path
    "0\t1\t \t1\n1\t0\t1\t0\n",       # the same, tab-separated
    "1 0 1\n0 1\n1 1 0\n",             # ragged (short row)
    "1 0 1\n0 1 1 1\n1 1 0\n",         # ragged (long row)
    "1 0 1\n0 x 1\n1 1 0\n",           # non-numeric cell
    "1,0,1\n0,1,\n",                   # an empty cell: -1.0 as well
    "1 0 1\n0 NA 1\n",                 # NA: a partial parse in numpy
    "1 0 3\n0 1 2\n",                  # plain: the fast path itself
], ids=["space-cell", "space-cell-tab", "ragged-short", "ragged-long",
        "non-numeric", "empty-cell", "na-cell", "plain"])
def test_load_data_matches_pandas_path(text, tmp_path, monkeypatch):
    path = tmp_path / "d.csv"
    path.write_text(text)
    want = _jax_pandas_path(path, monkeypatch)
    got = _load(port_io, path)
    if isinstance(want, type):
        assert got is want
        return
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)


def test_fast_path_warning_is_a_fallback(tmp_path):
    """numpy signals a partial parse with a DeprecationWarning, not a
    ValueError: under warnings-as-errors bnpc_tpu's loader raises it, the
    port's takes the pandas path."""
    path = tmp_path / "d.csv"
    path.write_text("1 0 1\n0 NA 1\n")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with pytest.raises(DeprecationWarning):
            jax_io.load_data(path)
        got = port_io.load_data(path)
    np.testing.assert_array_equal(got, [[1, 0], [0, np.nan], [1, 1]])


def _inferred(est_list=("posterior", "ML", "MAP")):
    rng = np.random.default_rng(0)
    steps, n, m = 12, 9, 5
    base = rng.integers(0, 3, n)
    a = np.tile(base, (steps, 1))
    a[3, 0] = 2
    params = np.zeros((steps, 4, m))
    for s in range(steps):
        params[s, :np.unique(a[s]).size] = rng.random((np.unique(a[s]).size,
                                                       m))
    res = {"ML": rng.normal(size=steps), "MAP": rng.normal(size=steps),
           "DP_alpha": rng.random(steps), "FN": rng.random(steps),
           "FP": rng.random(steps) * 1e-3, "assignments": a,
           "params": params[2:], "burn_in": 2}
    data = rng.integers(0, 2, (n, m)).astype(float)
    inferred = {"mean": {}}
    for est in est_list:
        if est == "posterior":
            lat = port_est.latents_posterior([res], data, device="cpu")[0]
        else:
            lat = port_est.latents_point([res], est, data)[0]
        inferred["mean"][est] = lat
    # An integer genotype table: the branch that writes one file.
    inferred["mean"]["ML"]["genotypes"] = \
        inferred["mean"]["ML"]["genotypes"].round()
    return inferred, data, base


def _args():
    return types.SimpleNamespace(
        time=[datetime(2026, 1, 2, 3, 4, 5), datetime(2026, 1, 2, 3, 5, 6)],
        falseNegative=-1, falsePositive=0.001, falseNegative_mean=0.2,
        falseNegative_std=0.1, falsePositive_mean=0.01,
        falsePositive_std=0.01, steps=[12])


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_writers_byte_identical(tmp_path):
    inferred, data, truth = _inferred()
    names = (np.arange(data.shape[0]), np.array([f"m{j}" for j in
                                                 range(data.shape[1])]))
    for mod, sub in ((jax_io, "jax"), (port_io, "port")):
        out = tmp_path / sub
        out.mkdir()
        mod.save_run(inferred, _args(), str(out), names)
        mod.save_v_measure(inferred, truth, str(out))
        mod.save_ari(inferred, truth, str(out))
        mod.save_hamming_dist(inferred, data, str(out))
    jax_files, port_files = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert "genotypes_cont_posterior_mean.tsv" in port_files
    assert "genotypes_cont_ML_mean.tsv" not in port_files
    assert port_files == jax_files


@pytest.mark.parametrize("labels", ["ints", "quoted"])
def test_table_writer_is_to_csv(labels, tmp_path):
    """The genotype writer's bytes are pandas' to_csv's: -0.0 beside 0.0,
    NaN, exponents, wide ints, labels that need quoting."""
    import pandas as pd

    rng = np.random.default_rng(3)
    vals = rng.random((4, 7)).round(4)
    vals[0, :6] = [-0.0, 0.0, np.nan, 1e-5, 1e16, 123456789.0]
    index = (range(4) if labels == "ints"
             else ["a\tb", 'm"1', "", "x y"])
    for frame in (pd.DataFrame(vals, index=index),
                  pd.DataFrame(vals.astype(np.float32), index=index).T,
                  pd.DataFrame((vals[1:] * 1e6).round().astype(np.int64),
                               index=list(index)[1:])):
        frame.to_csv(tmp_path / "want.tsv", sep="\t")
        port_io._write_tsv(frame, tmp_path / "got.tsv")
        assert (tmp_path / "got.tsv").read_bytes() \
            == (tmp_path / "want.tsv").read_bytes()


# ---------------------------------------------------------------------------
# cli
# ---------------------------------------------------------------------------


def test_flag_table_matches_jax():
    """Every dest and default of bnpc_tpu's parser; the device group adds
    --device only. A full command line parses to the same values."""
    jax_args = vars(jax_cli.parse_args(["in.csv"]))
    port_args = vars(port_cli.parse_args(["in.csv"]))
    assert port_args.pop("device") == "cuda"
    assert port_args == jax_args
    argv = ["in.csv", "-t", "-FN", "0.1", "-FP", "0.001", "-FN_m", "0.3",
            "-ap", "2", "1", "-pp", "1", "1", "-s", "30", "-b", "0.2",
            "-cup", "0.5", "-eup", "0.1", "-smp", "0.4", "-sms", "5",
            "-smr", "0.6", "0.4", "-e", "ML", "MAP", "-sc", "--seed", "3",
            "-o", "out", "-v", "2", "-np", "-tc", "t.txt", "--max_clusters",
            "20", "--trace_clusters", "10", "--block_size", "8",
            "--profile", "prof", "--debug"]
    port_args = vars(port_cli.parse_args(argv))
    port_args.pop("device")
    assert port_args == vars(jax_cli.parse_args(argv))


@pytest.fixture(scope="module")
def planted_file(tmp_path_factory):
    """A 60-cell x 30-mutation planted input, mutations x cells, 3 missing."""
    data, truth = make_problem(n=N, m=M, k_clones=4, seed=2)
    path = tmp_path_factory.mktemp("input") / "data.csv"
    np.savetxt(path, np.where(np.isnan(data), 3, data).T, fmt="%d")
    return str(path), truth


@pytest.mark.parametrize("argv", [["--mesh", "2,1"], ["--mesh", "two"],
                                  ["-n", "3", "--mesh", "2,2"]])
def test_unported_flags_exit(argv, planted_file, tmp_path, monkeypatch):
    """A --mesh that bnpc_tpu refuses exits before anything runs, with
    bnpc_tpu's message (bnpc_tpu/cli.py::build_mesh)."""
    def never(*args, **kwargs):
        raise AssertionError("sampling started")

    monkeypatch.setattr(port_mcmc.MCMCRunner, "run", never)
    args = port_cli.parse_args([planted_file[0], "--device", "cpu", "-np",
                                "-o", str(tmp_path / "out")] + argv)
    with pytest.raises(SystemExit) as e:
        port_cli.main(args)
    with pytest.raises(SystemExit) as want:
        jax_cli.build_mesh(jax_cli.parse_args([planted_file[0]] + argv))
    assert e.value.code == want.value.code
    assert not (tmp_path / "out").exists()


def _mesh_run(planted, out, *argv):
    port_cli.main(port_cli.parse_args([
        planted, "--device", "cpu", "-s", "16", "--block_size", "8", "-np",
        "--seed", "1", "-n", "2", "-o", str(out), *argv]))


@pytest.mark.parametrize("mesh", ["1,2", "2,1"])
def test_mesh_cli_writes_once(mesh, planted_file, tmp_path, capfd,
                              monkeypatch):
    """--mesh on two gloo CPU ranks started by the CLI: rank 0 alone
    prints and writes bnpc_tpu's file set. Under 2,1 each chain is the
    one-process run's, so the files are the one-process job's (one CPU
    thread in the ranks, as here: a threaded CPU matmul may sum in
    another order)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _mesh_run(planted_file[0], tmp_path / "out", "--mesh", mesh)
    printed = capfd.readouterr().out
    assert printed.count("Writing output to") == 1
    assert "backend gloo" in printed
    files = set(os.listdir(tmp_path / "out"))
    assert {"args.txt", "assignment.txt", "errors.txt",
            "genotypes_posterior_mean.tsv"} <= files
    cfg = _args_txt(tmp_path / "out")
    assert len(cfg["chain_seeds"].strip("[]").split(",")) == 2
    if mesh == "2,1":
        _mesh_run(planted_file[0], tmp_path / "one")
        assert set(os.listdir(tmp_path / "one")) == files
        for name in ("assignment.txt", "genotypes_posterior_mean.tsv",
                     "errors.txt"):
            assert (tmp_path / "out" / name).read_bytes() == \
                (tmp_path / "one" / name).read_bytes()


def test_mesh_cli_failing_ranks_fail_the_job(planted_file, tmp_path):
    """Ranks that fail (here on a checkpoint that is not the port's) make
    the job exit non-zero, and nothing is written."""
    ck = tmp_path / "ck"
    ck.mkdir()
    np.savez(ck / "mcmc_state.npz", done=np.asarray(0))
    with pytest.raises(SystemExit) as e:
        _mesh_run(planted_file[0], tmp_path / "out", "--mesh", "1,2",
                  "--checkpoint_dir", str(ck))
    assert e.value.code not in (0, None) and "--mesh 1,2" in str(e.value)
    assert not (tmp_path / "out").exists()


def _args_txt(out_dir):
    with open(os.path.join(out_dir, "args.txt")) as fh:
        return dict(ln.rstrip("\n").split(": ", 1) for ln in fh
                    if ": " in ln)


@pytest.mark.parametrize("mode", ["chains", "lugsail", "checkpoint",
                                  "runtime", "coupled", "blocked"])
def test_mode_flag_runs(mode, planted_file, tmp_path, monkeypatch):
    """Each run-mode flag the CLI once refused runs cli.main on the CPU to
    the reference's files, with one property of its mode."""
    out = tmp_path / "out"
    argv = {"chains": ["-n", "2"], "lugsail": ["-ls", "1.5"],
            "checkpoint": ["--checkpoint_dir", str(tmp_path / "ck")],
            "runtime": ["-r", "1"], "coupled": ["-n", "2",
                                                "--coupled_moves"],
            "blocked": ["--blocked_gibbs", "16"]}[mode]
    seen = []
    if mode == "runtime":
        class Clock(datetime):
            """Seven seconds a reading: the minute ends in three blocks."""
            t = datetime.now()

            @classmethod
            def now(cls, tz=None):
                cls.t += timedelta(seconds=7)
                return cls.t

        monkeypatch.setattr(port_mcmc, "datetime", Clock)
    if mode == "coupled":
        make = port_mcmc.make_coupled_step_fn

        def counted(*args, **kwargs):
            step = make(*args, **kwargs)
            return lambda *a: seen.append(1) or step(*a)

        monkeypatch.setattr(port_mcmc, "make_coupled_step_fn", counted)
    if mode == "blocked":
        sweep = port_mcmc.gibbs_sweep
        monkeypatch.setattr(port_mcmc, "gibbs_sweep", lambda *a, **k: (
            seen.append(k["impl"]) or sweep(*a, **k)))
    port_cli.main(port_cli.parse_args([
        planted_file[0], "--device", "cpu", "-s", "16", "--block_size", "8",
        "-np", "--seed", "1", "-v", "0", "-o", str(out)] + argv))
    assert {"args.txt", "assignment.txt", "errors.txt",
            "genotypes_posterior_mean.tsv"} <= set(os.listdir(out))
    cfg = _args_txt(out)
    seeds = [int(x) for x in cfg["chain_seeds"].strip("[]").split(",")]
    steps = [int(x) for x in cfg["steps"].strip("[]").split(",")]
    assert len(seeds) == len(steps) == (2 if "-n" in argv else 1)
    if mode in ("chains", "coupled"):
        assert len(set(seeds)) == 2 and steps == [17, 17]
    if mode == "coupled":
        assert len(seen) == 16
    if mode == "lugsail":
        assert float(cfg["PSRF"]) <= 1.5 and steps[0] > 17
    if mode == "checkpoint":
        assert (tmp_path / "ck" / "mcmc_state.npz").exists()
    if mode == "runtime":
        # Three readings a block: the third block runs from 56 s to 63 s,
        # and the deadline at 60 s keeps int(8 * 4 / 7) = 4 of its rows.
        assert steps == [1 + 8 + 8 + 4]
    if mode == "blocked":
        assert "blocked" in seen


def test_cuda_without_a_card_exits(planted_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        port_cli.main(port_cli.parse_args([planted_file[0], "-np"]))
    assert "no CUDA device" in str(e.value.code)


def test_plots_without_seaborn_exit_before_sampling(planted_file,
                                                    monkeypatch):
    def never(*args, **kwargs):
        raise AssertionError("sampling started")

    monkeypatch.setattr(port_mcmc.MCMCRunner, "run", never)
    monkeypatch.setitem(sys.modules, "seaborn", None)
    with pytest.raises(SystemExit) as e:
        port_cli.main(port_cli.parse_args([planted_file[0], "--device",
                                           "cpu"]))
    assert "seaborn" in str(e.value.code)


def test_main_writes_jax_files(planted_file, tmp_path, monkeypatch):
    """The port's main at 60 x 30 on the CPU; then bnpc_tpu's
    generate_output on the same results: the same files, byte for byte
    (args.txt without its output directory)."""
    seen = {}
    port_generate = port_cli.generate_output

    def keep(args, results, data, names):
        seen.update(args=vars(args).copy(), results=results, data=data,
                    names=names)
        port_generate(args, results, data, names)

    monkeypatch.setattr(port_cli, "generate_output", keep)
    path, truth = planted_file
    port_out = tmp_path / "port"
    port_cli.main(port_cli.parse_args([
        path, "--device", "cpu", "-s", "40", "-np", "--seed", "1", "-v", "0",
        "-e", "posterior", "ML", "MAP", "-o", str(port_out)]))
    res = seen["results"][0]
    assert res["assignments"].shape == (41, N)
    assert res["params"].shape[0] == 41 - res["burn_in"]

    jax_out = tmp_path / "jax"
    jax_args = types.SimpleNamespace(**{**seen["args"],
                                        "output": str(jax_out)})
    jax_cli.generate_output(jax_args, seen["results"], seen["data"],
                            seen["names"])
    port_files, jax_files = _files(port_out), _files(jax_out)
    assert sorted(port_files) == sorted(jax_files) == [
        "args.txt", "assignment.txt", "errors.txt",
        "genotypes_MAP_mean.tsv", "genotypes_ML_mean.tsv",
        "genotypes_cont_MAP_mean.tsv", "genotypes_cont_ML_mean.tsv",
        "genotypes_cont_posterior_mean.tsv", "genotypes_posterior_mean.tsv"]
    for name in port_files:
        got, want = port_files[name], jax_files[name]
        if name == "args.txt":
            got, want = ([ln for ln in f.decode().splitlines()
                          if not ln.startswith("output:")]
                         for f in (got, want))
        assert got == want, name
    assert port_est.ari(port_io.load_assignment_txt(port_out /
                                                    "assignment.txt"),
                        truth) > 0.5


def test_import_keeps_jax_sklearn_matplotlib_out():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'bnpc_tpu', 'sklearn', 'matplotlib',"
        " 'seaborn'):\n"
        "    sys.modules[name] = None\n"
        "import bnpc_tpu_torch.cli, bnpc_tpu_torch.io\n"
        "import bnpc_tpu_torch.estimators, bnpc_tpu_torch.diagnostics\n"
        "import bnpc_tpu_torch.utils.trees\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "m.split('.')[0] in ('jax', 'jaxlib', 'bnpc_tpu', 'sklearn', "
        "'matplotlib', 'seaborn')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(__file__)))


# ---------------------------------------------------------------------------
# mcmc: what the CLI needs of the runner
# ---------------------------------------------------------------------------


def _runner(mcmc_cfg):
    data, _ = make_problem(n=20, m=8, k_clones=3, seed=4)
    cfg = ModelConfig(n_cells=20, n_muts=8, k_max=20, p=0.25, q=0.25,
                      fp=0.01, fn=0.2)
    return port_mcmc.MCMCRunner(cfg, mcmc_cfg, pack_data(data, "cpu"),
                                device="cpu", block_size=4)


def test_runner_hand_over(monkeypatch):
    """as_dict has bnpc_tpu's keys; seed -1 draws a seed and records it;
    BNPC_TPU_TRACE_F32=1 records f32 params; the same burn-in selects the
    same kept rows as bnpc_tpu's result (initial row first)."""
    runner = _runner(MCMCConfig())
    (res,) = runner.run((6, 2), seed=-1)
    jax_res = jax_mcmc.ChainResult(**{
        f: getattr(res, f) for f in ("ML", "MAP", "DP_alpha", "FN", "FP",
                                     "assignments", "params", "burn_in",
                                     "mh_counts")})
    assert res.as_dict().keys() == jax_res.as_dict().keys()
    assert runner.seeds.shape == (1,) and 0 <= runner.seeds[0] < 2**31 - 1
    (again,) = runner.run((6, 2), seed=int(runner.seeds[0]))
    np.testing.assert_array_equal(again.assignments, res.assignments)
    kept = res.as_dict()["assignments"][res.burn_in:]
    assert kept.shape[0] == res.params.shape[0] == 6 + 1 - 2

    (state,) = runner.init_chains(port_mcmc.TorchDraws(0, "cpu"))
    cfg, trace_k = runner.cfg, runner.trace_k
    assert port_mcmc.summarize(state, runner.data, cfg, trace_k) \
        .params.dtype == torch.float16
    monkeypatch.setenv("BNPC_TPU_TRACE_F32", "1")
    assert port_mcmc.summarize(state, runner.data, cfg, trace_k) \
        .params.dtype == torch.float32


def test_fixed_assignment_is_kept(capsys):
    runner = _runner(MCMCConfig(fix_assign=True))
    given = np.array([5, 5, 9, 2] * 5)
    (res,) = runner.run((5, 0), seed=0, assign=given, verbosity=2)
    _, compact = np.unique(given, return_inverse=True)
    assert (res.assignments == compact).all()
    assert "step:\t4 / 5" in capsys.readouterr().out
