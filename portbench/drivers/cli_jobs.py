"""Traffic kind ``cli_jobs``: whole BnpC jobs, one after another in one
process, each ``bnpc_tpu_torch.cli.main`` from the input file to the output
files, as a user runs ``run_bnpc_tpu_torch.py``.

Traffic parameters: ``steps`` (-s), ``estimators`` (-e) and ``chains``
(-n). The configuration's model and move settings are passed as the CLI's
own flags. Set-up writes the input
file once into TMPDIR and runs one untimed job; every job of the window
starts before the window closes and is timed from the call to its return.
Each job's files are parsed once the window has closed, then deleted.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import tempfile
import time

import numpy as np
import pandas as pd

from portbench.lib import datagen, devtrace
from portbench.lib.spans import STAGES, Spans
from portbench.reference import judge, model as ref

STATE_FIELDS = ("assignment", "params", "cluster_size", "dp_alpha", "fp",
                "fn")
# The move settings argv() passes as the CLI's flags.
PASSED_MOVES = {"sm_prob", "sm_steps", "sm_split_ratio", "dpa_prob",
                "error_prob"}


class Run:
    def __init__(self, cell: dict, seed: int, device, trace: bool):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg_file, self.tr = cell["config"], cell["traffic"]
        self.obs = {"kind": "cli_jobs"}
        self.jobs = []
        self.spans = Spans(device, timed=trace)
        self.stage_seconds = []
        self.seeds = iter(np.random.default_rng(self.seed).integers(
            0, 2**31 - 1, 1 << 16))

    def argv(self, out_dir: str, job_seed: int) -> list[str]:
        mdl, mv = self.cfg_file["model"], self.cfg_file["moves"]
        r = mv["sm_split_ratio"]
        words = [
            self.csv, "-s", self.tr["steps"], "-b", self.cfg_file["burn_in"],
            "-e", *self.tr["estimators"], "-n", self.tr["chains"], "-np",
            "--device", str(self.device), "-o", out_dir, "--seed", job_seed,
            "-FP_m", mdl["fp"], "-FP_sd", mdl["fp_sd"], "-FN_m", mdl["fn"],
            "-FN_sd", mdl["fn_sd"], "-pp", mdl["p"], mdl["q"],
            "--max_clusters", mdl["k_max"], "-smp", mv["sm_prob"],
            "-sms", mv["sm_steps"], "-smr", r, 1 - r, "-cup", mv["dpa_prob"],
            "-eup", mv["error_prob"]]
        return [str(w) for w in words]

    def setup(self) -> None:
        if not self.cfg_file["model"]["learn_errors"]:
            raise ValueError("cli_jobs passes learned-error priors only")
        unpassed = set(self.cfg_file["moves"]) - PASSED_MOVES
        if unpassed:
            raise ValueError(f"cli_jobs passes no flag for {sorted(unpassed)}")
        d = self.cfg_file["data"]
        self.x, _ = datagen.make_data(
            d["n_cells"], d["n_muts"], d["clones"], d["missing"],
            seed=self.seed, fp=d["fp"], fn=d["fn"])
        self.tmp = tempfile.mkdtemp(prefix="portbench-")
        self.csv = os.path.join(self.tmp, "data.csv")
        datagen.write_input(self.csv, self.x)
        self.spans.__enter__()
        self._job(keep=False)

    def _job(self, keep: bool = True, profiled: bool = False) -> float:
        """One job; with `profiled` its call runs under the profiler
        (obs["profile"])."""
        from bnpc_tpu_torch import cli

        out_dir = os.path.join(self.tmp, f"out{len(self.jobs)}")
        args = cli.parse_args(self.argv(out_dir, next(self.seeds)))

        def call():
            with open(os.devnull, "w") as sink, \
                    contextlib.redirect_stdout(sink):
                cli.main(args)
            self._sync()

        t0 = time.perf_counter()
        if profiled:
            self.obs["profile"] = devtrace.profile(call, self.device)
        else:
            call()
        seconds = time.perf_counter() - t0
        stages, kept = self.spans.take()
        if keep:
            self.jobs.append((self._take(kept), out_dir))
            self.stage_seconds.append(stages)
        else:
            shutil.rmtree(out_dir, ignore_errors=True)
        del kept
        gc.collect()
        return seconds

    def _sync(self) -> None:
        import torch

        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        job_s = []
        while time.perf_counter() - t0 < seconds:
            job_s.append(self._job())
        self.obs.update(job_seconds=job_s,
                        window_s=time.perf_counter() - t0)

    def traced(self) -> None:
        """One more job under the profiler; the stage spans (timed in a
        traced run) averaged over every job of the run."""
        self._job(profiled=True)
        self.obs["busy_segment"] = "job"
        self.obs["stage_s"] = {
            s: float(np.mean([j.get(s, 0.0) for j in self.stage_seconds]))
            for s in STAGES}

    def release(self) -> None:
        """Every job's files parsed; the folders deleted."""
        self.spans.__exit__(None, None, None)
        self.jobs = [self._parse(job, out_dir) for job, out_dir in self.jobs]
        shutil.rmtree(self.tmp, ignore_errors=True)

    def _take(self, kept: dict) -> dict:
        """What the check of one job reads from its process state, on the
        host."""
        res = kept["results"][0]
        state = kept["runner"].final_states[0]
        return {
            "loaded": kept["loaded"],
            "state": {f: getattr(state, f).cpu().numpy()
                      for f in STATE_FIELDS},
            "results": {k: res[k] for k in ("ML", "MAP", "DP_alpha", "FP",
                                             "FN", "assignments",
                                             "burn_in")},
            "last_params": res["params"][-1],
            "trace_k": res["params"].shape[1],
            "estimates": {},
        }

    def _parse(self, job: dict, out_dir: str) -> dict:
        """The job's written estimates (assignment.txt, errors.txt and the
        genotype tables of each estimator)."""
        res = job["results"]
        assign = pd.read_csv(os.path.join(out_dir, "assignment.txt"),
                             sep="\t", dtype={"Assignment": str})
        errors = pd.read_csv(os.path.join(out_dir, "errors.txt"), sep="\t")
        for est in self.tr["estimators"]:
            row = errors[errors["estimator"] == est].iloc[0]
            out = {
                "assignment": np.array(
                    assign[assign["estimator"] == est]["Assignment"]
                    .iloc[0].split(), dtype=np.int64),
                "geno": _table(out_dir, f"genotypes_{est}_mean.tsv"),
                "cont": _table(out_dir, f"genotypes_cont_{est}_mean.tsv"),
                "fn": _model_rate(row["FN_model"]),
                "fp": _model_rate(row["FP_model"]),
                "fn_data": float(row["FN_data"]),
                "fp_data": float(row["FP_data"]),
            }
            if est in ("ML", "MAP"):
                trace = res[est]
                bi = int(res["burn_in"])
                out["step"] = int(np.argmax(trace[bi:])) + bi
            job["estimates"][est] = out
        shutil.rmtree(out_dir, ignore_errors=True)
        return job

    def judge(self, verdict: judge.Verdict, control: bool = False) -> None:
        mdl = ref.Model(self.cfg_file)
        for job in self.jobs:
            verdict.answer(judge.job_numbers(mdl, self.x, job, control))


def _table(out_dir: str, name: str):
    """A genotypes_*.tsv as [loci, cells] numbers: a header of cell labels,
    then a locus label and one number a cell on each line."""
    path = os.path.join(out_dir, name)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        fh.readline()
        return np.array([line.rstrip("\n").split("\t")[1:] for line in fh],
                        dtype=np.float64)


def _model_rate(text) -> float:
    """A rate as errors.txt writes it: a number, or "mean+-sd"."""
    return float(str(text).split("+-")[0])


def make(cell: dict, seed: int, device, trace: bool = False) -> Run:
    return Run(cell, seed, device, trace)
