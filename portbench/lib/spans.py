"""The benchmark's spans around the calls that ``bnpc_tpu_torch.cli.main``
makes, a copy of ``chip_smoke.py::Stages`` that wraps only the stable entry
points: ``io.load_data`` and ``pack_data`` (input), ``MCMCRunner``'s
construction and ``run`` (sample, its captures included),
``io.infer_results`` (estimate) and ``io.save_run`` (write).

While active, every wrapper also keeps what the check of a job needs: the
matrix the load returned, the runner (its ``final_states``) and the chain
results handed to the estimators. With ``timed`` each call ends in a
device synchronization and its seconds add to its stage.
"""

from __future__ import annotations

import time

STAGES = ("input", "sample", "estimate", "write")


class Spans:
    def __init__(self, device, timed: bool):
        self.device = device
        self.timed = timed
        self.seconds = {}
        self.kept = {}

    def _sync(self):
        import torch

        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize(self.device)

    def _wrap(self, fn, stage, keep=None):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if self.timed:
                self._sync()
                self.seconds[stage] = (self.seconds.get(stage, 0.0)
                                       + time.perf_counter() - t0)
            if keep is not None:
                keep(args, out)
            return out

        return call

    def __enter__(self):
        from bnpc_tpu_torch import cli, io

        def keep_load(args, out):
            self.kept["loaded"] = out[0] if isinstance(out, tuple) else out

        def keep_results(args, out):
            self.kept["results"] = args[1]

        real_runner = cli.MCMCRunner
        make = self._wrap(real_runner, "sample")

        def runner(*args, **kwargs):
            r = make(*args, **kwargs)
            r.run = self._wrap(r.run, "sample")
            self.kept["runner"] = r
            return r

        self._saved = [(io, "load_data", io.load_data),
                       (cli, "pack_data", cli.pack_data),
                       (cli, "MCMCRunner", real_runner),
                       (io, "infer_results", io.infer_results),
                       (io, "save_run", io.save_run)]
        io.load_data = self._wrap(io.load_data, "input", keep_load)
        cli.pack_data = self._wrap(cli.pack_data, "input")
        cli.MCMCRunner = runner
        io.infer_results = self._wrap(io.infer_results, "estimate",
                                      keep_results)
        io.save_run = self._wrap(io.save_run, "write")
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)

    def take(self) -> tuple[dict, dict]:
        """(stage seconds, kept objects) since the last take."""
        seconds, kept = self.seconds, self.kept
        self.seconds, self.kept = {}, {}
        return seconds, kept
