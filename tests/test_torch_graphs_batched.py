"""The captured batch (bnpc_tpu_torch/mcmc.py::_CapturedBatch) on the CPU.

On the card a batch of chains (chain_exec="vmap", exact or coupled) runs
each step's device-only pieces as CUDA graphs (bnpc_tpu_torch/graphs.py),
keyed by how many chains take each branch, every chain drawing from its
own stream through the batch's slot generators. Here a stand-in takes the
graph's place, as in tests/test_torch_graphs.py: its capture runs the piece
and then puts back everything the piece wrote (the batch's static buffers,
the slot generators it registered, the launch counters), as a capture on
the card runs nothing; each replay runs the piece again on the same
buffers, with the launch counters put back (the batch adds what the
capture noted).

Whole blocks with births, splits and merges, on the lazy and the stream
sweeps (their kernels' plain twins), must give what ``_batch_block`` over
the eager batched step gives, bit for bit: every trace row, each chain's
state and each chain's generator state; exact and coupled. The runs must
hold steps whose chains split into a Gibbs and a split-merge sub-batch,
split-merge sub-batches with a split and a merge, birth rounds where only
some chains are born, and alpha and error sub-batches.

These tests hold the slice against bnpc_tpu through the eager batch:
tests/test_torch_batched.py holds that eager batch against bnpc_tpu's
``_pipe_vmap`` and ``_pipe_coupled`` on JaxDraws. Torch only; nothing of
bnpc_tpu.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from bnpc_tpu_torch import graphs
from bnpc_tpu_torch import mcmc as port_mcmc
from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
from bnpc_tpu_torch.data import pack_data
from bnpc_tpu_torch.draws import TorchDraws
from bnpc_tpu_torch.models import gibbs, splitmerge
from bnpc_tpu_torch.ops import cuda_gibbs, cuda_rg, cuda_stream

torch.set_num_threads(1)

N, M = 32, 10
CFG = ModelConfig(n_cells=N, n_muts=M, k_max=N, p=0.25, q=0.25, fp=0.01,
                  fn=0.2, learn_errors=True, fp_sd=0.01, fn_sd=0.1)
MIX = MCMCConfig(sm_prob=0.4, dpa_prob=0.3, error_prob=0.3, sm_steps=2,
                 sm_split_ratio=0.5)
COUPLED = MCMCConfig(sm_prob=0.4, dpa_prob=0.3, error_prob=0.3, sm_steps=2,
                     sm_split_ratio=0.5, coupled_moves=True)
BLOCKS = ((10, None), (10, None), (10, 6))  # (n_steps, keep) a block


def _data():
    rng = np.random.default_rng(4)
    geno = rng.integers(0, 2, size=(4, M))
    x = geno[rng.integers(0, 4, size=N)].astype(float)
    flip = rng.random((N, M)) < 0.05
    x[flip] = 1.0 - x[flip]
    x[rng.random((N, M)) < 0.1] = np.nan
    return pack_data(x, "cpu")


DATA = _data()
TRACE_K = port_mcmc.resolve_trace_k(CFG, MIX)


def stand_in(batch):
    """A graph class for `batch` (the module docstring)."""

    class StandIn:
        def __init__(self, generators, pool):
            self.gens, self.fn = generators, None

        def capture(self, fn):
            saved = [t.clone() for t in batch.statics()]
            gen_states = [g.get_state() for g in self.gens]
            fn()
            for t, v in zip(batch.statics(), saved):
                t.copy_(v)
            for g, v in zip(self.gens, gen_states):
                g.set_state(v)
            self.fn = fn

        def replay(self):
            counts = graphs.read_counts()
            self.fn()
            graphs.set_counts(counts)

    return StandIn


def _captured(impl, rows_cap=10, mix=MIX):
    batch = port_mcmc._CapturedBatch(CFG, mix, DATA, TRACE_K, impl, "cpu",
                                     rows_cap)
    batch.graph_cls = stand_in(batch)
    return batch


def _eager(impl, coupled=False, mix=MIX):
    """_batch_block's signature over the eager batched step."""
    step = (port_mcmc.make_coupled_step_fn(CFG, mix, DATA, TRACE_K, impl)
            if coupled else
            port_mcmc.make_step_fn(CFG, mix, DATA, TRACE_K,
                                   gibbs_impl=impl))

    def block(states, draws, n_steps, keep=None):
        return port_mcmc._batch_block(step, states, draws, n_steps, keep,
                                      coupled=coupled)

    return block


def _start(chains):
    return [port_mcmc.init_state(TorchDraws(3 + c, "cpu"), CFG, DATA, "cpu")
            for c in range(chains)]


def _draws(chains):
    return [TorchDraws(11 + c, "cpu") for c in range(chains)]


def _run(block, chains):
    """BLOCKS through `block` (_batch_block's signature) from _start()."""
    states, draws, out = _start(chains), _draws(chains), []
    for n_steps, keep in BLOCKS:
        states, rows, draws = block(states, draws, n_steps, keep)
        out.append(rows)
    return states, {f: np.concatenate([r[f] for r in out], axis=1)
                    for f in port_mcmc.TraceRow._fields}, draws


def assert_same_runs(got, want):
    (g_states, g_rows, g_draws), (w_states, w_rows, w_draws) = got, want
    for f in port_mcmc.TraceRow._fields:
        assert g_rows[f].dtype == w_rows[f].dtype, f
        np.testing.assert_array_equal(g_rows[f], w_rows[f], err_msg=f)
    assert len(g_states) == len(w_states)
    for g, w in zip(g_states, w_states):
        for f, x, y in zip(port_mcmc.CRPState._fields, g, w):
            assert x.shape == y.shape and torch.equal(x, y), f
    for g, w in zip(g_draws, w_draws):
        assert torch.equal(g.gen.get_state(), w.gen.get_state())


class RunLog:
    """Records every piece a batch runs: (key, chains), in order."""

    def __init__(self, batch):
        self.runs, run = [], batch._run

        def logged(key, draws, chains, fn):
            self.runs.append((key, tuple(chains)))
            return run(key, draws, chains, fn)

        batch._run = logged

    def steps(self):
        """The runs grouped by step (a step ends with its errors piece)."""
        out, step = [], []
        for key, chains in self.runs:
            step.append((key, chains))
            if key[0] == "errors":
                out.append(step)
                step = []
        return out


def _coverage(log, chains):
    """What the runs held: mixed sub-batches of every kind."""
    steps = log.steps()
    kinds = {
        "gibbs_and_sm": any(0 < len(ch) and k[1] not in (0, chains)
                            for s in steps for k, ch in s
                            if k[0] == "head"),
        "split_and_merge": any({"split", "merge"} <= {k[0] for k, _ in s}
                               for s in steps),
        "some_born": False,
        "alpha_sub": any(k[0] == "alpha" and k[1] < chains
                         for s in steps for k, _ in s),
        "errors_sub": any(k[0] == "errors" and 0 < k[1] < chains
                          for s in steps for k, _ in s),
    }
    for s in steps:
        head = next((k for k, _ in s if k[0] == "head"), None)
        kg = chains - head[1] if head else 0
        kinds["some_born"] |= any(k[0] == "birth" and k[1] < kg
                                  for k, _ in s)
    return kinds


@pytest.mark.parametrize("impl,chains,rows_cap", [
    ("lazy", 4, 10), ("stream", 4, 10), ("lazy", 3, 4), ("stream", 5, 4)])
def test_captured_batch_matches_eager(impl, chains, rows_cap):
    """Bit for bit against _batch_block over the eager batched step; with
    rows_cap 4 a block's rows reach the host in parts. The runs hold every
    kind of mixed sub-batch, and every piece kind was replayed."""
    batch = _captured(impl, rows_cap)
    batch._setup(port_mcmc.stack_states(_start(chains)))
    log = RunLog(batch)
    got = _run(batch.run, chains)
    want = _run(_eager(impl), chains)
    assert_same_runs(got, want)
    kinds = _coverage(log, chains)
    assert all(kinds.values()), kinds
    kinds_replayed = {k[0] for k in batch.pieces.graphs}
    assert {"head", "split", "merge", "tail", "alpha", "params",
            "errors"} <= kinds_replayed


@pytest.mark.parametrize("impl", ["lazy", "stream"])
def test_coupled_batch_matches_eager(impl):
    """The coupled batch (one shared move choice from chain 0's stream):
    bit for bit against _batch_block over the eager coupled step; only the
    split / merge sub-batches and the births vary there."""
    batch = _captured(impl, mix=COUPLED)
    batch._setup(port_mcmc.stack_states(_start(4)))
    log = RunLog(batch)
    got = _run(lambda *a: batch.run(*a, coupled=True), 4)
    want = _run(_eager(impl, coupled=True, mix=COUPLED), 4)
    assert_same_runs(got, want)
    for step in log.steps():
        for key, _ in step:
            if key[0] in ("head", "alpha", "errors"):
                assert key[1] in (0, 4), key
    assert any({"split", "merge"} <= {k[0] for k, _ in s}
               for s in log.steps())


def test_keys_name_counts_not_chains():
    """Two different subsets of chains of one size run one graph: a key
    names how many chains take the branch, never which."""
    batch = _captured("lazy")
    batch._setup(port_mcmc.stack_states(_start(4)))
    log = RunLog(batch)
    _run(batch.run, 4)
    subsets = {}
    for key, chains in log.runs:
        if chains:
            subsets.setdefault(key, set()).add(chains)
    shared = [k for k, sets in subsets.items()
              if len(sets) > 1 and k in batch.pieces.graphs]
    assert shared
    for key in batch.pieces.graphs:
        assert all(isinstance(x, (str, int)) for x in key)
    assert batch.pieces.replays > batch.pieces.eager_runs


def _counting(monkeypatch):
    """Wrappers that count their CPU calls as the card's wrappers count
    their launches."""
    def count(mod, name, owner):
        fn = getattr(mod, name)

        def counted(*args):
            c = args[0].shape[0]
            owner.chain_launches += 1
            owner.chain_grids[c] = owner.chain_grids.get(c, 0) + 1
            return fn(*args)

        monkeypatch.setattr(mod, name, counted)

    count(gibbs, "lazy_segment_chains", cuda_gibbs)
    count(gibbs, "lazy_segment_stream_chains", cuda_stream)
    count(splitmerge, "rg_scan_chains", cuda_rg)


def _zero_counts():
    graphs.set_counts([(0, 0, {}) for _ in graphs.COUNTED])


@pytest.mark.parametrize("impl", ["lazy", "stream"])
def test_replays_add_the_captured_launches(impl, monkeypatch):
    """The launch counters after a captured run equal the eager batch's:
    each replay adds what its capture noted, on the same chain grids."""
    _counting(monkeypatch)
    _zero_counts()
    _run(_captured(impl).run, 4)
    got = graphs.read_counts()
    _zero_counts()
    _run(_eager(impl), 4)
    want = graphs.read_counts()
    assert got == want
    sweep = cuda_stream if impl == "stream" else cuda_gibbs
    i = graphs.COUNTED.index(sweep)
    assert want[i][1] > 0 and len(want[i][2]) > 1
    assert want[graphs.COUNTED.index(cuda_rg)][1] > 0
    _zero_counts()


def test_refuses_other_draws():
    class OnHost(TorchDraws):
        pass

    batch = _captured("lazy")
    with pytest.raises(ValueError, match="TorchDraws"):
        batch.run(_start(2), [TorchDraws(1, "cpu"), OnHost(2, "cpu")], 4)


def test_cpu_runner_never_captures(monkeypatch):
    """A CPU runner batches its chains on the eager step: no captured
    batch, no graph."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU runner made a graph")

    monkeypatch.setattr(graphs.CudaGraph, "__init__", refuse)
    monkeypatch.setattr(port_mcmc._CapturedBatch, "__init__", refuse)
    for mix in (MIX, COUPLED):
        runner = port_mcmc.MCMCRunner(CFG, mix, DATA, device="cpu",
                                      block_size=6, chain_exec="vmap")
        res = runner.run((8, 2), seed=5, n_chains=3)
        assert runner._block.executors == {}
        assert len(res) == 3 and res[0].assignments.shape == (9, N)


def _assert_same_results(a, b):
    """Two runs' results: discrete fields exactly, floats to rtol 1e-6 (on
    the CPU the batch and the one-chain step may round an ulp apart:
    tests/test_torch_batched.py)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("assignments", "mh_counts"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f), f)
        for f in ("ML", "MAP", "DP_alpha", "FP", "FN", "params"):
            np.testing.assert_allclose(getattr(x, f), getattr(y, f),
                                       rtol=1e-6, err_msg=f)


def test_resume_under_sequential(tmp_path):
    """run() in steps mode through the captured batch, checkpointed and
    resumed under chain_exec="sequential", gives the uninterrupted
    captured run."""
    def runner(chain_exec, ckpt=None):
        r = port_mcmc.MCMCRunner(CFG, MIX, DATA, device="cpu", block_size=6,
                                 checkpoint_dir=ckpt, checkpoint_every=1,
                                 chain_exec=chain_exec)
        if chain_exec == "vmap":
            r._block = port_mcmc._make_block(
                CFG, MIX, DATA, TRACE_K, gibbs_impl="lazy",
                chain_exec=r.chain_exec, rows_cap=6, graphs_for=stand_in)
        return r

    want = runner("vmap").run((18, 6), seed=9, n_chains=3)
    ck = str(tmp_path / "ck")
    runner("vmap", ck).run((12, 6), seed=9, n_chains=3)
    got = runner("sequential", ck).run((18, 6), seed=9, n_chains=3)
    _assert_same_results(got, want)


def test_capture_runs_without_cyclic_gc(monkeypatch):
    """CudaGraph.capture turns Python's cyclic garbage collector off for
    the capture (a dead runner collected there would free its graphs'
    memory inside the capture) and back on after it, also when the piece
    raises. torch.cuda's graph classes are stood in for on the CPU."""
    seen = []

    class Graph:
        def register_generator_state(self, gen):
            seen.append(("gen", gen))

    @contextlib.contextmanager
    def capturing(graph, pool=None):
        seen.append(("capture", pool))
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capturing)
    gens = (object(), object())
    graph = graphs.CudaGraph(gens, "pool")
    graph.capture(lambda: seen.append(("gc", gc.isenabled())))
    assert seen == [("gen", gens[0]), ("gen", gens[1]), ("capture", "pool"),
                    ("gc", False)]
    assert gc.isenabled()

    def broken():
        raise RuntimeError("capture refused")

    with pytest.raises(RuntimeError, match="capture refused"):
        graph.capture(broken)
    assert gc.isenabled()


# resolve_chain_exec's answers for coupled chains: (chain_exec, device) ->
# the answer without a mesh (gibbs_block 0, 8), then under one (0, 8).
AUTO_COUPLED = {
    ("auto", "cpu"): ("sequential", "sequential", "sequential", "sequential"),
    ("auto", "cuda"): ("vmap", "vmap", "sequential", "sequential"),
    ("sequential", "cpu"): ("sequential", "sequential", "sequential",
                            "sequential"),
    ("sequential", "cuda"): ("sequential", "sequential", "sequential",
                             "sequential"),
    ("vmap", "cpu"): ("vmap", "vmap", "vmap", "vmap"),
    ("vmap", "cuda"): ("vmap", "vmap", "vmap", "vmap"),
}


def test_auto_rule_for_coupled_chains():
    """Coupled chains take AUTO_CUDA_COUPLED_CHAIN_EXEC on CUDA in the
    exact-chain rule's place, beside the mesh rule: resolve_chain_exec
    gives AUTO_COUPLED's answer on every row; the CPU stays sequential, and
    a CPU runner resolves "auto" so."""
    assert port_mcmc.AUTO_CUDA_COUPLED_CHAIN_EXEC == "vmap"
    for (chain_exec, device), want in AUTO_COUPLED.items():
        got = tuple(port_mcmc.resolve_chain_exec(
            chain_exec, device, mesh=mesh, gibbs_block=block, coupled=True)
            for mesh in (None, object()) for block in (0, 8))
        assert got == want, (chain_exec, device)
    runner = port_mcmc.MCMCRunner(CFG, COUPLED, DATA, device="cpu")
    assert runner.chain_exec == "sequential"
