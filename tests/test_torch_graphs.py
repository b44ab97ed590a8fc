"""The captured block (bnpc_tpu_torch/mcmc.py::_CapturedBlock) on the CPU.

On the card a one-chain block runs each step's device-only pieces as CUDA
graphs (bnpc_tpu_torch/graphs.py). Here a stand-in takes the graph's place:
its capture runs the piece and then puts back everything the piece wrote
(the block's static buffers, its generator, the launch counters), as a
capture on the card runs nothing; each replay runs the piece again on the
same buffers, with the launch counters put back (the block adds what the
capture noted). Whole blocks with births, splits and merges, on the lazy
and the stream sweeps (their kernels' plain twins), must give what
``_chain_block`` over the eager step gives, bit for bit: every trace row,
the state and the generator state. Torch only; nothing of bnpc_tpu.
"""

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
MIX = MCMCConfig(sm_prob=0.33, dpa_prob=0.25, error_prob=0.25, sm_steps=2)
BLOCKS = ((12, None), (12, None), (12, 7))  # (n_steps, keep) a block


def _data():
    rng = np.random.default_rng(4)
    geno = rng.integers(0, 2, size=(4, M))
    x = geno[rng.integers(0, 4, size=N)].astype(float)
    flip = rng.random((N, M)) < 0.05
    x[flip] = 1.0 - x[flip]
    x[rng.random((N, M)) < 0.1] = np.nan
    return pack_data(x, "cpu")


DATA = _data()


def _statics(block):
    return [*block.state, *block.work, block.split, block.sm_counts,
            block.t, *block.rows]


def stand_in(block):
    """A graph class for `block` (the module docstring)."""

    class StandIn:
        def __init__(self, generator, pool):
            self.gen, self.fn = generator, None

        def capture(self, fn):
            saved = [t.clone() for t in _statics(block)]
            gen_state = self.gen.get_state()
            fn()
            for t, v in zip(_statics(block), saved):
                t.copy_(v)
            self.gen.set_state(gen_state)
            self.fn = fn

        def replay(self):
            counts = graphs.read_counts()
            self.fn()
            graphs.set_counts(counts)

    return StandIn


def _captured(impl, rows_cap=12):
    trace_k = port_mcmc.resolve_trace_k(CFG, MIX)
    block = port_mcmc._CapturedBlock(CFG, MIX, DATA, trace_k, impl, "cpu",
                                     rows_cap)
    block.graph_cls = stand_in(block)
    return block


def _eager_step(impl):
    return port_mcmc.make_step_fn(CFG, MIX, DATA,
                                  port_mcmc.resolve_trace_k(CFG, MIX),
                                  gibbs_impl=impl)


def _start():
    return port_mcmc.init_state(TorchDraws(3, "cpu"), CFG, DATA, "cpu")


def _run(one, draws):
    """BLOCKS through `one` (_chain_block's signature) from _start()."""
    state, out = _start(), []
    for n_steps, keep in BLOCKS:
        state, rows, draws = one(state, draws, n_steps, keep)
        out.append(rows)
    return state, {f: np.concatenate([r[f] for r in out])
                   for f in port_mcmc.TraceRow._fields}, draws


class KeyLog:
    """Records every piece key a block runs, in order."""

    def __init__(self, pieces):
        self.keys, run = [], pieces.run

        def logged(key, fn):
            self.keys.append(key)
            return run(key, fn)

        pieces.run = logged


@pytest.mark.parametrize("impl", ["lazy", "stream"])
@pytest.mark.parametrize("rows_cap", [12, 5])
def test_captured_block_matches_eager(impl, rows_cap):
    """Bit for bit against _chain_block over the eager step; with
    rows_cap 5 a block's rows reach the host in parts."""
    block = _captured(impl, rows_cap)
    got_state, got, got_draws = _run(block.run, TorchDraws(11, "cpu"))
    step = _eager_step(impl)
    want_state, want, want_draws = _run(
        lambda *a: port_mcmc._chain_block(step, *a), TorchDraws(11, "cpu"))
    for f in port_mcmc.TraceRow._fields:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f, g, w in zip(port_mcmc.CRPState._fields, got_state, want_state):
        assert torch.equal(g, w), f
    assert torch.equal(got_draws.gen.get_state(), want_draws.gen.get_state())
    # Every move kind ran, and every piece was replayed.
    counts = want["mh_counts"]
    assert (counts[:, 1].sum(-1) > 0).any()
    assert (counts[:, 2].sum(-1) > 0).any()
    assert {("birth", True), ("sm_move", True), ("sm_move", False),
            ("sweep_head",)} <= set(block.pieces.graphs)


@pytest.mark.parametrize("impl", ["lazy", "stream"])
def test_pieces_follow_the_flags(impl):
    """Each step runs the pieces its flags name, in order; a key is
    captured at its second run and replayed from then on."""
    block = _captured(impl)
    block._setup(_start())
    log = KeyLog(block.pieces)
    _, rows, _ = _run(block.run, TorchDraws(11, "cpu"))
    steps, step = [], None
    for key in log.keys:
        if key[0] in ("sweep_head", "sm_head"):
            step = [key]
            steps.append(step)
        else:
            step.append(key)
    assert len(steps) == len(rows["ml"])
    for keys, counts in zip(steps, rows["mh_counts"]):
        split, merge = counts[1].sum() > 0, counts[2].sum() > 0
        if keys[0] == ("sm_head",):
            assert keys[1] == ("sm_move", bool(split)) and split != merge
        else:
            assert not (split or merge)
            births = keys[1:-2]
            assert all(k[0] == "birth" for k in births)
            assert all(k == ("birth", True) for k in births[:-1])
            assert keys[-2] == ("sweep_tail",)
        assert keys[-1][0] == "rest"
        # The error move ran iff its counts moved.
        assert keys[-1][2] == bool(counts[3:5].sum() > 0)
    runs = {k: log.keys.count(k) for k in set(log.keys)}
    assert set(block.pieces.graphs) == {k for k, c in runs.items() if c > 1}
    assert block.pieces.eager_runs == len(runs)
    assert block.pieces.replays == len(log.keys) - len(runs)


def _counting(monkeypatch):
    """Wrappers that count their CPU calls as the card's wrappers count
    their launches."""
    def count(mod, name, batched):
        fn = getattr(mod, name)

        def counted(*args):
            if batched:
                c = args[0].shape[0]
                owner.chain_launches += 1
                owner.chain_grids[c] = owner.chain_grids.get(c, 0) + 1
            else:
                owner.launches += 1
            return fn(*args)

        owner = {"lazy_segment_chains": cuda_gibbs,
                 "lazy_segment_stream_chains": cuda_stream,
                 "rg_scan": cuda_rg}[name]
        monkeypatch.setattr(mod, name, counted)

    count(gibbs, "lazy_segment_chains", True)
    count(gibbs, "lazy_segment_stream_chains", True)
    count(splitmerge, "rg_scan", False)


def _zero_counts():
    graphs.set_counts([(0, 0, {}) for _ in graphs.COUNTED])


@pytest.mark.parametrize("impl", ["lazy", "stream"])
def test_replays_add_the_captured_launches(impl, monkeypatch):
    """The launch counters after a captured run equal the eager run's:
    each replay adds what its capture noted."""
    _counting(monkeypatch)
    _zero_counts()
    _run(_captured(impl).run, TorchDraws(11, "cpu"))
    got = graphs.read_counts()
    _zero_counts()
    step = _eager_step(impl)
    _run(lambda *a: port_mcmc._chain_block(step, *a), TorchDraws(11, "cpu"))
    want = graphs.read_counts()
    assert got == want
    sweep = cuda_stream if impl == "stream" else cuda_gibbs
    i = graphs.COUNTED.index(sweep)
    assert want[i][1] > 0 and set(want[i][2]) == {1}
    assert want[graphs.COUNTED.index(cuda_rg)][0] > 0
    _zero_counts()


def test_capture_fault_raises():
    """A capture that fails raises out of the block, with the launch
    counters as they were; nothing runs the piece eagerly instead."""
    block = _captured("lazy")

    class Broken:
        def __init__(self, generator, pool):
            pass

        def capture(self, fn):
            cuda_rg.launches += 5
            raise RuntimeError("capture refused")

    block.graph_cls = Broken
    _zero_counts()
    state, draws = _start(), TorchDraws(11, "cpu")
    with pytest.raises(RuntimeError, match="capture refused"):
        block.run(state, draws, 12)
    assert cuda_rg.launches == 0
    assert block.pieces.graphs == {} and block.pieces.replays == 0


def test_refuses_other_draws():
    class OnHost(TorchDraws):
        pass

    block = _captured("lazy")
    with pytest.raises(ValueError, match="TorchDraws"):
        block.run(_start(), OnHost(1, "cpu"), 4)


def test_cpu_runner_never_captures(monkeypatch):
    """A CPU runner runs the eager step: no captured block, no graph."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU runner made a graph")

    monkeypatch.setattr(graphs.CudaGraph, "__init__", refuse)
    monkeypatch.setattr(port_mcmc._CapturedBlock, "__init__", refuse)
    runner = port_mcmc.MCMCRunner(CFG, MIX, DATA, device="cpu", block_size=6)
    assert runner._captured is None
    res = runner.run((8, 2), seed=5)
    assert res[0].assignments.shape == (9, N)


def test_runner_resumes_through_the_captured_block(tmp_path):
    """run() in steps mode through the captured block, checkpointed and
    resumed, gives the uninterrupted eager run bit for bit."""
    def runner(ckpt=None, captured=True):
        r = port_mcmc.MCMCRunner(CFG, MIX, DATA, device="cpu", block_size=6,
                                 checkpoint_dir=ckpt, checkpoint_every=1)
        if captured:
            block = port_mcmc._CapturedBlock(CFG, MIX, DATA, r.trace_k,
                                             "lazy", "cpu", 6)
            block.graph_cls = stand_in(block)
            r._one_block = block.run
            r._block = port_mcmc._make_block(r._step, r.chain_exec,
                                             block.run)
        else:
            r._step = _eager_step("lazy")
            r._one_block = lambda *a: port_mcmc._chain_block(r._step, *a)
            r._block = port_mcmc._make_block(r._step, r.chain_exec)
        return r

    want = runner(captured=False).run((18, 6), seed=9)[0]
    ck = str(tmp_path / "ck")
    runner(ck).run((12, 6), seed=9)
    got = runner(ck).run((18, 6), seed=9)[0]
    for f in ("ML", "MAP", "DP_alpha", "FP", "FN", "assignments", "params",
              "mh_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
