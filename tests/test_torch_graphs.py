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
    res = runner.run((8, 2), seed=5)
    assert runner._block.executors == {}
    assert res[0].assignments.shape == (9, N)


def test_runner_resumes_through_the_captured_block(tmp_path):
    """run() in steps mode through the captured block, checkpointed and
    resumed, gives the uninterrupted eager run bit for bit."""
    def runner(ckpt=None, captured=True):
        r = port_mcmc.MCMCRunner(CFG, MIX, DATA, device="cpu", block_size=6,
                                 checkpoint_dir=ckpt, checkpoint_every=1)
        r._block = port_mcmc._make_block(
            CFG, MIX, DATA, r.trace_k, gibbs_impl="lazy",
            chain_exec=r.chain_exec, rows_cap=6,
            graphs_for=stand_in if captured else None)
        return r

    want = runner(captured=False).run((18, 6), seed=9)[0]
    ck = str(tmp_path / "ck")
    runner(ck).run((12, 6), seed=9)
    resumed = runner(ck)
    got = resumed.run((18, 6), seed=9)[0]
    assert list(resumed._block.executors) == [(port_mcmc._CapturedBlock,
                                               "lazy")]
    for f in ("ML", "MAP", "DP_alpha", "FP", "FN", "assignments", "params",
              "mh_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


# The seam's table (mcmc.py::_make_block and its _form): the executor of a
# block by (device, mesh, sweep), the sweep "blocked" (gibbs_block 4 on the
# exact "lazy") or "scan"; each row lists chain_exec "sequential" then
# "vmap", each uncoupled then coupled, each for 1 and for 3 chains.
C = ("_chain_block", None, False)
B = ("_CapturedBlock", "blocked", False)
E = ("_batch_block", None, False)
EC = ("_batch_block", None, True)
CB = ("_CapturedBatch", "blocked", False)
CBC = ("_CapturedBatch", "lazy", True)
S = ("_coupled_chains", None, True)
SEAM = {
    ("cpu", None, "blocked"): (C, C, C, S, C, E, C, EC),
    ("cpu", None, "scan"): (C, C, C, S, C, E, C, EC),
    ("cpu", "unsharded", "blocked"): (C, C, C, S, C, E, C, EC),
    ("cpu", "unsharded", "scan"): (C, C, C, S, C, E, C, EC),
    ("cpu", "sharded", "blocked"): (C, C, C, C, C, E, C, E),
    ("cpu", "sharded", "scan"): (C, C, C, C, C, E, C, E),
    ("cuda", None, "blocked"): (B, B, B, S, B, CB, B, CBC),
    ("cuda", None, "scan"): (C, C, C, S, C, E, C, EC),
    ("cuda", "unsharded", "blocked"): (C, C, C, S, C, E, C, EC),
    ("cuda", "unsharded", "scan"): (C, C, C, S, C, E, C, EC),
    ("cuda", "sharded", "blocked"): (C, C, C, C, C, E, C, E),
    ("cuda", "sharded", "scan"): (C, C, C, C, C, E, C, E),
}
SEAM_ROWS = [pytest.param(*k, ex, coupled, n, want[4 * i + 2 * j + c],
                          id=f"{k[0]}-{k[1]}-{k[2]}-{ex}-"
                          f"{'coupled' if coupled else 'exact'}-{n}")
             for k, want in SEAM.items()
             for i, ex in enumerate(("sequential", "vmap"))
             for j, coupled in enumerate((False, True))
             for c, n in enumerate((1, 3))]


def _spy(monkeypatch, ran):
    """Each executor, recording (name, impl, coupled) into `ran`."""
    for name in ("_chain_block", "_batch_block", "_coupled_chains"):
        fn = getattr(port_mcmc, name)

        def eager(step, *a, _fn=fn, _name=name, **k):
            coupled = _name == "_coupled_chains" or a[4:5] == (True,)
            ran.append((_name, None, coupled))
            return _fn(step, *a, **k)

        monkeypatch.setattr(port_mcmc, name, eager)
    for cls in (port_mcmc._CapturedBlock, port_mcmc._CapturedBatch):
        def run(self, *a, _run=cls.run, _name=cls.__name__, **k):
            ran.append((_name, self.impl, k.get("coupled", False)))
            return _run(self, *a, **k)

        monkeypatch.setattr(cls, "run", run)


@pytest.mark.parametrize("device,mesh,sweep,chain_exec,coupled,chains,want",
                         SEAM_ROWS)
def test_seam_table(device, mesh, sweep, chain_exec, coupled, chains, want,
                    monkeypatch):
    """_form gives the row's executor; where a row runs here (no sharded
    axis: that needs a process group), _make_block's block runs it for one
    step, the card stood in for by the stand-in graph class."""
    from tests.test_torch_graphs_blocked import stand_in as any_stand_in

    impl, exact = ("blocked", "lazy") if sweep == "blocked" else ("scan",
                                                                   "scan")
    assert port_mcmc._form(device == "cuda", mesh is not None,
                           mesh == "sharded", impl, exact, chain_exec,
                           coupled, chains) == want
    if mesh == "sharded":
        return
    mix = MCMCConfig(sm_prob=0.33, dpa_prob=0.25, error_prob=0.25,
                     sm_steps=2, coupled_moves=coupled,
                     gibbs_block=4 if sweep == "blocked" else 0)
    ran = []
    _spy(monkeypatch, ran)
    block = port_mcmc._make_block(
        CFG, mix, DATA, port_mcmc.resolve_trace_k(CFG, mix),
        gibbs_impl="lazy" if sweep == "blocked" else "scan",
        chain_exec=chain_exec, mesh=mesh and object(),
        graphs_for=any_stand_in if device == "cuda" else None)
    states = [_start() for _ in range(chains)]
    draws = [TorchDraws(11 + c, "cpu") for c in range(chains)]
    out, rows, _ = block(states, draws, 1)
    assert len(out) == chains and rows["ml"].shape[:2] == (chains, 1)
    per_chain = want[0] in ("_chain_block", "_CapturedBlock")
    assert ran == [want] * (chains if per_chain else 1)


def test_positional_arguments_follow_bnpc_tpu():
    """gibbs_sweep and make_sharded_block take bnpc_tpu's argument order,
    so a positional call as bnpc_tpu makes it lands each argument where
    bnpc_tpu's does: the axis and impl of a sweep (a sharded axis refuses
    the eager sweep; the unsharded scan gives the keyword call's state),
    and chain_exec of a mesh block."""
    from bnpc_tpu_torch.parallel import sharded
    from bnpc_tpu_torch.parallel.axis import MutAxis

    state = _start()
    with pytest.raises(ValueError, match="sharded mutation axis"):
        gibbs.gibbs_sweep(TorchDraws(5, "cpu"), state, DATA, CFG,
                          MutAxis(group=object(), index=0, size=2), "eager")
    got = gibbs.gibbs_sweep(TorchDraws(5, "cpu"), state, DATA, CFG,
                            MutAxis(), "scan")
    want = gibbs.gibbs_sweep(TorchDraws(5, "cpu"), state, DATA, CFG,
                             impl="scan")
    for f, g, w in zip(port_mcmc.CRPState._fields, got, want):
        assert torch.equal(g, w), f
    mesh = sharded.Mesh(1, 1, 0, None, None)
    assert sharded.make_sharded_block(mesh, CFG, MIX, DATA,
                                      "vmap").chain_exec == "vmap"
