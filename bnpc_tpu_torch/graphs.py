"""CUDA graphs of a step's device-only pieces (the port's counterpart of
bnpc_tpu's compiled block: ``make_block_fn``'s ``lax.scan`` and the jitted
one-chain pipe, bnpc_tpu/mcmc.py:345-353, 710-722).

A piece is a Python function that only launches device work: it reads and
writes tensors that outlive it (static buffers) and makes no host read. The
captured block and batch (mcmc.py::_CapturedBlock, _CapturedBatch, which
mcmc.py::_make_block, the one seam that decides how a block of chains
runs, makes on the card) run each piece through :class:`Pieces` under a
key that names what the host already knows about it (a move flag, whether
a birth round relaunches). A key's first run is eager
(it loads the kernels and makes the lazy initialisations that a capture may
not make); its second run captures it into a graph and replays that; every
later run replays it. So every run of a piece computes, with the same
kernels on the same buffers, what its eager run computes.

What a replay must carry over from an eager run:

  * random numbers: every graph registers the generators it draws from
    (``register_generator_state``; the one-chain block's own generator, or
    a batch's slot generators, mcmc.py::_CapturedBatch), so a replay draws
    from each generator's state at the replay and advances it by what the
    capture drew, as the eager run would;
  * the kernel wrappers' launch counters (ops/cuda_*.py): ``launches += 1``
    runs in Python, so only at capture. A capture notes how far each
    counter moved, sets it back, and each replay adds that.

With the tracer on (trace.py) every run is a span: ``graphs.eager``,
``graphs.capture`` or ``graphs.replay`` with its key and the key's family
(what the owner's ``family(key)`` names), the eager runs and replays timed
on the device too when the tracer's device spans are on.

A capture runs with Python's cyclic garbage collector off (collecting a
dead runner there would free its graphs' memory inside the capture and
invalidate it). A capture that fails raises; nothing falls back to eager
dispatch. All the
graphs of a block share one memory pool: it holds each piece's temporaries
only (what crosses pieces lives in the static buffers, allocated outside
any capture), so the graphs may replay in any order.
"""

from __future__ import annotations

import gc
import time

import torch

from bnpc_tpu_torch import trace
from bnpc_tpu_torch.ops import (cuda_beta, cuda_error_mh, cuda_gibbs,
                                cuda_mh, cuda_rg, cuda_rg_assign, cuda_row,
                                cuda_sm_accept, cuda_stream, cuda_sweep)

# The kernel wrappers a captured piece launches.
COUNTED = (cuda_gibbs, cuda_stream, cuda_rg, cuda_sweep, cuda_mh, cuda_beta,
           cuda_rg_assign, cuda_error_mh, cuda_row, cuda_sm_accept)

def read_counts() -> list:
    """The launch counters of COUNTED: (launches, chain_launches,
    chain_grids) a module."""
    return [(m.launches, m.chain_launches, dict(m.chain_grids))
            for m in COUNTED]


def set_counts(counts) -> None:
    for m, (one, chains, grids) in zip(COUNTED, counts):
        m.launches, m.chain_launches = one, chains
        m.chain_grids.clear()
        m.chain_grids.update(grids)


def _delta(after, before) -> list:
    return [(a[0] - b[0], a[1] - b[1],
             {g: v - b[2].get(g, 0) for g, v in a[2].items()})
            for a, b in zip(after, before)]


def add_counts(delta) -> None:
    for m, (one, chains, grids) in zip(COUNTED, delta):
        m.launches += one
        m.chain_launches += chains
        for g, v in grids.items():
            if v:
                m.chain_grids[g] = m.chain_grids.get(g, 0) + v


class CudaGraph:
    """One piece as a ``torch.cuda.CUDAGraph`` that draws from `generators`
    (one generator, or a tuple of them) and allocates from `pool`."""

    def __init__(self, generators, pool):
        self.graph = torch.cuda.CUDAGraph()
        for gen in (generators if isinstance(generators, tuple)
                    else (generators,)):
            self.graph.register_generator_state(gen)
        self.pool = pool

    def capture(self, fn) -> None:
        # No cyclic garbage collection inside a capture: collecting a dead
        # runner destroys its graphs and frees their pool's memory, which
        # invalidates the capture in progress.
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool):
                fn()
        finally:
            if enabled:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


class Pieces:
    """Runs pieces by key (module docstring). `graph_cls(generators, pool)`
    makes a graph that draws from `generators` (`generator`, or what
    ``run`` names); on the card CudaGraph. `family(key)` names a key's
    family for the tracer's spans. Keeps, for the record: the graphs by
    key with the launches each holds (``graphs``), how many replays
    (``replays``) and eager runs (``eager_runs``) it made, and the seconds
    its captures took (``capture_seconds``)."""

    def __init__(self, generator: torch.Generator | None, family,
                 graph_cls=CudaGraph):
        self.generator = generator
        self.family = family
        self.graph_cls = graph_cls
        self.pool = (torch.cuda.graph_pool_handle()
                     if graph_cls is CudaGraph else None)
        self.graphs: dict = {}
        self.seen: set = set()
        self.replays = 0
        self.eager_runs = 0
        self.capture_seconds = 0.0

    def run(self, key, fn, generators: tuple | None = None) -> None:
        """Run piece `fn` under `key`; its graph draws from `generators`
        (a tuple, the same for every run of the key), default the
        generator given at construction."""
        entry = self.graphs.get(key)
        if entry is None:
            if key not in self.seen:
                self.seen.add(key)
                self.eager_runs += 1
                if trace.on:
                    trace.piece("graphs.eager", key, self.family(key), fn)
                else:
                    fn()
                return
            entry = self.graphs[key] = self._capture(
                key, fn, self.generator if generators is None else generators)
        graph, delta = entry
        if trace.on:
            trace.piece("graphs.replay", key, self.family(key),
                        graph.replay)
        else:
            graph.replay()
        add_counts(delta)
        self.replays += 1

    def _capture(self, key, fn, generators):
        t0 = time.perf_counter_ns()
        before = read_counts()
        graph = self.graph_cls(generators, self.pool)
        try:
            graph.capture(fn)
        finally:
            delta = _delta(read_counts(), before)
            set_counts(before)
        t1 = time.perf_counter_ns()
        self.capture_seconds += (t1 - t0) * 1e-9
        if trace.on:
            trace.record("graphs.capture", t0, t1, key=key,
                         family=self.family(key))
        return graph, delta

    def pool_bytes(self) -> int | None:
        """Bytes of the device memory segments of the graphs' pool (None
        off the card)."""
        if self.pool is None:
            return None
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)
