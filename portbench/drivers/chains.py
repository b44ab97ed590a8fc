"""Traffic kind ``chains``: MCMC chains in blocks, as a user's time-mode run
drives them (``MCMCRunner.run`` with ``-r``: ``run_chains`` a block at a
time, every block's trace rows on the host before the next).

Traffic parameters: ``chains`` (how many), ``chain_exec`` (the runner's
chain rule) and ``block`` (steps a block). The model and move settings are
the configuration's alone. The workload file gives the warm-up
(``warmup_steps``, whole blocks). Chain c starts as ``MCMCRunner.run``
starts it: one chain on the run's seed, several on seeds drawn from it.
The window also leaves ``ess`` and ``ess_steps`` (chain 0's log-likelihood
trace, lib/ess.py) in ``obs`` for a reader: ESS a second spread too widely
between seeds to be bounded at this window (PERF.md §7).
"""

from __future__ import annotations

import time

import numpy as np

from portbench.lib import datagen, devtrace, ess
from portbench.reference import judge, model as ref

STATE_FIELDS = ("assignment", "params", "cluster_size", "dp_alpha", "fp",
                "fn")


class Run:
    def __init__(self, cell: dict, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg_file, self.tr = cell["config"], cell["traffic"]
        self.block = int(self.tr["block"])
        self.obs = {"kind": "chains"}
        # Each block the window or the traced run produced: (states, rows).
        self.blocks = []

    def setup(self) -> None:
        import torch

        from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
        from bnpc_tpu_torch.data import pack_data
        from bnpc_tpu_torch.draws import TorchDraws
        from bnpc_tpu_torch.mcmc import MCMCRunner

        d = self.cfg_file["data"]
        self.x, _ = datagen.make_data(
            d["n_cells"], d["n_muts"], d["clones"], d["missing"],
            seed=self.seed, fp=d["fp"], fn=d["fn"])
        cfg = ModelConfig(n_cells=d["n_cells"], n_muts=d["n_muts"],
                          **self.cfg_file["model"])
        self.runner = MCMCRunner(cfg, MCMCConfig(**self.cfg_file["moves"]),
                                 pack_data(self.x, self.device), self.device,
                                 block_size=self.block,
                                 chain_exec=self.tr["chain_exec"])
        n = int(self.tr["chains"])
        seeds = [self.seed] if n == 1 else np.random.default_rng(
            self.seed).integers(0, 2**31 - 1, n)
        self.draws = [TorchDraws(int(s), self.device) for s in seeds]
        self.states = [self.runner.init_chains(dr, 1)[0]
                       for dr in self.draws]
        self.obs.update(cells=cfg.n_cells, k_max=cfg.k_max)
        done, rows = 0, None
        while done < int(self.cell["workload"]["warmup_steps"]):
            rows = self._block()
            done += self.block
        self.last_rows = rows
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize(self.device)

    def _block(self):
        self.states, rows, self.draws = self.runner.run_chains(
            self.states, self.draws, self.block)
        return rows

    def window(self, seconds: float) -> None:
        """Whole blocks until `seconds` have passed; the window ends with
        its last block's rows on the host."""
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            rows = self._block()
            self.blocks.append((self.states, rows))
            steps += rows["ml"].shape[0] * rows["ml"].shape[1]
        window_s = time.perf_counter() - t0
        ml = np.concatenate([r["ml"][0] for _, r in self.blocks])
        self.obs.update(chain_steps=steps, window_s=window_s,
                        ess=ess.effective_sample_size(ml), ess_steps=ml.size)

    def traced(self) -> None:
        """One whole block of every chain under the profiler, then one
        counted by the sync debug mode; both are checked as well."""
        box = []
        prof = devtrace.profile(lambda: box.append(self._block()),
                                self.device)
        rows = box[0]
        self.blocks.append((self.states, rows))
        sm = (rows["mh_counts"][:, :, 1:3].sum(axis=(2, 3)) > 0)
        self.obs.update(profile=prof, trace_steps=int(sm.size),
                        trace_sweeps=int((~sm).sum()),
                        busy_segment="sample")
        syncs = devtrace.count_syncs(
            lambda: box.append(self._block()), self.device)
        self.blocks.append((self.states, box[-1]))
        if syncs is not None:
            self.obs.update(syncs=syncs,
                            sync_steps=self.block * len(self.states))

    def release(self) -> None:
        """The checked states on the host; the program's state freed."""
        host = []
        for states, rows in self.blocks:
            host.append(([{f: getattr(st, f).cpu().numpy()
                           for f in STATE_FIELDS} for st in states], rows))
        self.blocks = host
        self.states = self.draws = self.runner = None

    def judge(self, verdict: judge.Verdict, control: bool = False) -> None:
        """Every block of every chain the run produced, as one answer."""
        mdl = ref.Model(self.cfg_file)
        ones, zeros = ref.planes(self.x)
        prev = [None if self.last_rows is None else
                {f: v[c, -1] for f, v in self.last_rows.items()}
                for c in range(int(self.tr["chains"]))]
        for states, rows in self.blocks:
            for c, st in enumerate(states):
                mine = {f: v[c] for f, v in rows.items()}
                last = {f: v[-1] for f, v in mine.items()}
                nums = judge.rows_numbers(mine, prev[c], mdl.m)
                at = judge.state_numbers(mdl, ones, zeros, st, last,
                                         mine["params"].shape[1], control)
                nums["mismatches"] += at.pop("mismatches")
                nums.update(at)
                verdict.answer(nums)
                prev[c] = last


def make(cell: dict, seed: int, device, trace: bool = False) -> Run:
    return Run(cell, seed, device)
