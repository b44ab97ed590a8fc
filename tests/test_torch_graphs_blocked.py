"""The captured blocked and eager sweeps (bnpc_tpu_torch/mcmc.py::
_CapturedBlock and _CapturedBatch with impl "blocked", _CapturedBlock with
impl "eager") on the CPU.

On the card a step's blocked sweep runs as graphs of its pieces
(models/gibbs.py::blocked_start and the first frozen pass, blocked_cell,
blocked_births, blocked_pass, blocked_finish) between its host reads (one
a pass, one a replayed cell), and the eager sweep as one graph. Here a
stand-in takes the graph's place, as in tests/test_torch_graphs.py and
tests/test_torch_graphs_batched.py: its capture runs the piece and then
puts back everything the piece wrote (the block's or batch's static
buffers, the generators it registered, the launch counters), as a capture
on the card runs nothing; each replay runs the piece again on the same
buffers, with the launch counters put back (the owner adds what the
capture noted).

Whole blocks must give what ``_chain_block`` / ``_batch_block`` over the
eager step give, bit for bit: every trace row, the state and the generator
state. The runs must hold births found by the first frozen pass and by
later ones, a partial final block and rows_cap crossed; batches whose
chains replay blocks at different places while one chain's sweep has
ended; the eager sweep with births. Torch only; nothing of bnpc_tpu
(tests/test_torch_blocked.py holds make_block_fn against bnpc_tpu's).
"""

import dataclasses

import numpy as np
import pytest
import torch

from bnpc_tpu_torch import graphs
from bnpc_tpu_torch import mcmc as port_mcmc
from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
from bnpc_tpu_torch.data import pack_data
from bnpc_tpu_torch.draws import TorchDraws
from bnpc_tpu_torch.models import gibbs, splitmerge
from bnpc_tpu_torch.ops import cuda_rg, cuda_sweep

torch.set_num_threads(1)

N, M = 32, 10
CFG = ModelConfig(n_cells=N, n_muts=M, k_max=N, p=0.25, q=0.25, fp=0.01,
                  fn=0.2, learn_errors=True, fp_sd=0.01, fn_sd=0.1)
MIX = MCMCConfig(sm_prob=0.33, dpa_prob=0.25, error_prob=0.25, sm_steps=2,
                 sm_split_ratio=0.5)
BLOCKED = dataclasses.replace(MIX, gibbs_block=4)
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


def stand_in(owner):
    """A graph class for `owner`, a _CapturedBlock or a _CapturedBatch
    (the module docstring)."""

    class StandIn:
        def __init__(self, generators, pool):
            self.gens = (generators if isinstance(generators, tuple)
                         else (generators,))
            self.fn = None

        def capture(self, fn):
            saved = [t.clone() for t in owner.statics()]
            gen_states = [g.get_state() for g in self.gens]
            fn()
            for t, v in zip(owner.statics(), saved):
                t.copy_(v)
            for g, v in zip(self.gens, gen_states):
                g.set_state(v)
            self.fn = fn

        def replay(self):
            counts = graphs.read_counts()
            self.fn()
            graphs.set_counts(counts)

    return StandIn


def _captured(impl, rows_cap=10, mix=BLOCKED):
    block = port_mcmc._CapturedBlock(CFG, mix, DATA, TRACE_K, impl, "cpu",
                                     rows_cap)
    block.graph_cls = stand_in(block)
    return block


def _captured_batch(rows_cap=10, mix=BLOCKED):
    batch = port_mcmc._CapturedBatch(CFG, mix, DATA, TRACE_K, "blocked",
                                     "cpu", rows_cap)
    batch.graph_cls = stand_in(batch)
    return batch


def _eager_one(mix=BLOCKED, impl="auto"):
    step = port_mcmc.make_step_fn(CFG, mix, DATA, TRACE_K, gibbs_impl=impl)
    return lambda *a: port_mcmc._chain_block(step, *a)


def _eager_batch(mix=BLOCKED):
    step = port_mcmc.make_step_fn(CFG, mix, DATA, TRACE_K)
    return lambda *a: port_mcmc._batch_block(step, *a)


def _start(chains=None):
    states = [port_mcmc.init_state(TorchDraws(3 + c, "cpu"), CFG, DATA,
                                   "cpu") for c in range(chains or 1)]
    return states if chains else states[0]


def _draws(chains=None):
    draws = [TorchDraws(11 + c, "cpu") for c in range(chains or 1)]
    return draws if chains else draws[0]


def _run(block, chains=None):
    """BLOCKS through `block` (_chain_block's signature, or _batch_block's
    with `chains`) from _start(); rows joined along the step axis."""
    state, draws, out = _start(chains), _draws(chains), []
    for n_steps, keep in BLOCKS:
        state, rows, draws = block(state, draws, n_steps, keep)
        out.append(rows)
    axis = 1 if chains else 0
    return state, {f: np.concatenate([r[f] for r in out], axis=axis)
                   for f in port_mcmc.TraceRow._fields}, draws


def assert_same_runs(got, want):
    (g_state, g_rows, g_draws), (w_state, w_rows, w_draws) = got, want
    for f in port_mcmc.TraceRow._fields:
        assert g_rows[f].dtype == w_rows[f].dtype, f
        np.testing.assert_array_equal(g_rows[f], w_rows[f], err_msg=f)
    g_states, w_states = (([g_state], [w_state])
                          if isinstance(w_state, port_mcmc.CRPState)
                          else (g_state, w_state))
    g_draws, w_draws = ((g_draws, w_draws) if isinstance(w_draws, list)
                        else ([g_draws], [w_draws]))
    assert len(g_states) == len(w_states)
    for g, w in zip(g_states, w_states):
        for f, x, y in zip(port_mcmc.CRPState._fields, g, w):
            assert x.shape == y.shape and torch.equal(x, y), f
    for g, w in zip(g_draws, w_draws):
        assert torch.equal(g.gen.get_state(), w.gen.get_state())


class KeyLog:
    """Records every piece key a captured block runs, in order."""

    def __init__(self, pieces):
        self.keys, run = [], pieces.run

        def logged(key, fn, generators=None):
            self.keys.append(key)
            return run(key, fn, generators)

        pieces.run = logged


class ReplayLog:
    """While installed, notes each chain's birth block (ws.first) at every
    replayed cell of the captured forms' blocked sweeps."""

    def __init__(self, monkeypatch):
        self.firsts, rounds = [], port_mcmc.blocked_rounds

        def logged(ws, first_h, cell_fn, births_fn, pass_fn):
            def cell():
                self.firsts.append(ws.first.tolist())
                cell_fn()

            return rounds(ws, first_h, cell, births_fn, pass_fn)

        monkeypatch.setattr(port_mcmc, "blocked_rounds", logged)


@pytest.mark.parametrize("rows_cap", [10, 4])
def test_captured_blocked_block_matches_eager(rows_cap):
    """One chain, the blocked sweep: bit for bit against _chain_block over
    the eager step; with rows_cap 4 a block's rows reach the host in
    parts. Birth blocks came from the first frozen pass and from later
    ones, and every piece kind was replayed."""
    block = _captured("blocked", rows_cap)
    block._setup(_start())
    log = KeyLog(block.pieces)
    got = _run(block.run)
    assert_same_runs(got, _run(_eager_one()))
    keys = log.keys
    after = {(a[0], b[0]) for a, b in zip(keys, keys[1:])}
    assert ("blocked_head", "blocked_cell") in after, "no first-pass birth"
    assert ("blocked_pass", "blocked_cell") in after, "no later-pass birth"
    assert {("blocked_head",), ("blocked_cell",), ("blocked_birth",),
            ("blocked_pass",), ("blocked_tail",), ("sm_move", True),
            ("sm_move", False)} <= set(block.pieces.graphs)
    assert all(k[0] != "sweep_head" for k in keys)


@pytest.mark.parametrize("chains,rows_cap", [(2, 10), (3, 4)])
def test_captured_blocked_batch_matches_eager(chains, rows_cap, monkeypatch):
    """A batch of chains, the blocked sweep: bit for bit against
    _batch_block over the eager batched step. Chains replayed birth blocks
    at different places of their sweeps, and some replayed while another's
    sweep had ended."""
    replays = ReplayLog(monkeypatch)
    batch = _captured_batch(rows_cap)
    got = _run(batch.run, chains)
    assert_same_runs(got, _run(_eager_batch(), chains))
    G = -(-N // BLOCKED.gibbs_block)
    rows = [f for f in replays.firsts if len(f) > 1]
    assert any(len({x for x in f if x < G}) > 1 for f in rows), \
        "no two chains replaying at different blocks"
    assert any(G in f and min(f) < G for f in rows), \
        "no chain left alone while another replayed"
    assert {"head", "bcell", "bbirth", "bpass", "btail"} <= {
        k[0] for k in batch.pieces.graphs}


def test_captured_eager_block_matches_eager(monkeypatch):
    """One chain, the eager sweep (kernel 4's twin) as one piece: bit for
    bit against _chain_block over the eager step; its sweeps gave births."""
    born = []
    sweep = gibbs.eager_sweep

    def noting(*args):
        out = sweep(*args)
        sizes_in, sizes_out = args[7], out[1]
        born.append(int(((sizes_in == 0) & (sizes_out > 0)).sum()))
        return out

    monkeypatch.setattr(gibbs, "eager_sweep", noting)
    block = _captured("eager", mix=MIX)
    block._setup(_start())
    log = KeyLog(block.pieces)
    got = _run(block.run)
    n_captured = len(born)
    assert_same_runs(got, _run(_eager_one(MIX, "eager")))
    assert sum(born[:n_captured]) > 0, "no birth in an eager sweep"
    assert ("eager_sweep",) in block.pieces.graphs
    # A Gibbs step is one piece between the move uniforms and the rest.
    assert all(k[0] in ("eager_sweep", "sm_head", "sm_move", "rest")
               for k in log.keys)


def test_blocked_batch_keys_name_counts_not_chains():
    """Two different subsets of chains of one size run one graph: a key of
    the blocked batch names how many chains take the branch, never which."""
    batch = _captured_batch()
    batch._setup(port_mcmc.stack_states(_start(3)))
    runs, run = [], batch._run

    def logged(key, draws, chains, fn):
        runs.append((key, tuple(chains)))
        return run(key, draws, chains, fn)

    batch._run = logged
    _run(batch.run, 3)
    subsets = {}
    for key, chains in runs:
        if chains:
            subsets.setdefault(key, set()).add(chains)
    assert any(len(sets) > 1 and key in batch.pieces.graphs
               for key, sets in subsets.items())
    assert any(k[0] == "bbirth" for k in batch.pieces.graphs)
    for key in batch.pieces.graphs:
        assert all(isinstance(x, (str, int)) for x in key)
    assert batch.pieces.replays > batch.pieces.eager_runs


def _counting(monkeypatch):
    """Wrappers that count their CPU calls as the card's wrappers count
    their launches (kernel 4 and kernel 2, one-chain and batched)."""
    def count(mod, name, owner, batched):
        fn = getattr(mod, name)

        def counted(*args):
            if batched:
                c = args[0].shape[0]
                owner.chain_launches += 1
                owner.chain_grids[c] = owner.chain_grids.get(c, 0) + 1
            else:
                owner.launches += 1
            return fn(*args)

        monkeypatch.setattr(mod, name, counted)

    count(gibbs, "eager_sweep", cuda_sweep, False)
    count(splitmerge, "rg_scan", cuda_rg, False)
    count(splitmerge, "rg_scan_chains", cuda_rg, True)


def _zero_counts():
    graphs.set_counts([(0, 0, {}) for _ in graphs.COUNTED])


@pytest.mark.parametrize("form", ["blocked", "blocked batch", "eager"])
def test_replays_add_the_captured_launches(form, monkeypatch):
    """The launch counters after a captured run equal the eager run's:
    each replay adds what its capture noted, kernel 4's launch included."""
    assert cuda_sweep in graphs.COUNTED
    _counting(monkeypatch)
    mix = MIX if form == "eager" else BLOCKED
    chains = 3 if form == "blocked batch" else None
    captured = (_captured_batch().run if chains
                else _captured(form, mix=mix).run)
    eager = (_eager_batch() if chains
             else _eager_one(mix, "eager" if form == "eager" else "auto"))
    _zero_counts()
    _run(captured, chains)
    got = graphs.read_counts()
    _zero_counts()
    _run(eager, chains)
    want = graphs.read_counts()
    assert got == want
    rg = want[graphs.COUNTED.index(cuda_rg)]
    assert rg[1 if chains else 0] > 0
    k4 = want[graphs.COUNTED.index(cuda_sweep)]
    assert (k4[0] > 0) == (form == "eager")
    _zero_counts()


@pytest.mark.parametrize("impl", ["blocked", "eager"])
def test_capture_fault_raises(impl):
    """A capture that fails raises out of the block; nothing runs the piece
    eagerly instead."""
    block = _captured(impl, mix=BLOCKED if impl == "blocked" else MIX)

    class Broken:
        def __init__(self, generators, pool):
            pass

        def capture(self, fn):
            raise RuntimeError("capture refused")

    block.graph_cls = Broken
    with pytest.raises(RuntimeError, match="capture refused"):
        block.run(_start(), _draws(), 10)
    assert block.pieces.graphs == {} and block.pieces.replays == 0


def test_make_block_fn_routes():
    """make_block_fn on the CPU is _chain_block over make_step_fn's step
    (bit for bit, blocked and eager); the captured forms refuse the scan
    and a coupled blocked batch."""
    for mix, impl in ((BLOCKED, "auto"), (MIX, "eager")):
        block = port_mcmc.make_block_fn(CFG, mix, DATA, TRACE_K,
                                        gibbs_impl=impl)
        assert_same_runs(_run(block), _run(_eager_one(mix, impl)))
    with pytest.raises(ValueError, match="captured block"):
        port_mcmc._CapturedBlock(CFG, MIX, DATA, TRACE_K, "scan", "cpu", 4)
    with pytest.raises(ValueError, match="exact sweep"):
        _captured_batch().run(_start(2), _draws(2), 4, coupled=True)


@pytest.mark.parametrize("chain_exec", ["sequential", "vmap"])
def test_runner_resumes_through_the_captured_blocked_forms(chain_exec,
                                                          tmp_path):
    """run() with gibbs_block > 0 in steps mode through the captured block
    (one chain) or the captured batch (2 chains under "vmap"),
    checkpointed and resumed, gives the uninterrupted eager run bit for
    bit."""
    chains = 1 if chain_exec == "sequential" else 2

    def runner(ckpt=None, captured=True):
        r = port_mcmc.MCMCRunner(CFG, BLOCKED, DATA, device="cpu",
                                 block_size=6, checkpoint_dir=ckpt,
                                 checkpoint_every=1, chain_exec=chain_exec)
        if captured:
            r._block = port_mcmc._make_block(
                CFG, BLOCKED, DATA, TRACE_K, chain_exec=r.chain_exec,
                rows_cap=6, graphs_for=stand_in)
        return r

    want = runner(captured=False).run((18, 6), seed=9, n_chains=chains)
    ck = str(tmp_path / "ck")
    runner(ck).run((12, 6), seed=9, n_chains=chains)
    got = runner(ck).run((18, 6), seed=9, n_chains=chains)
    for g, w in zip(got, want):
        for f in ("ML", "MAP", "DP_alpha", "FP", "FN", "assignments",
                  "params", "mh_counts"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
