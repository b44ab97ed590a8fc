"""The fused error-rate MH (ops/cuda_error_mh.py) and trace row
(ops/cuda_row.py) on the CPU: the six primitives the error MH's wrapper
draws, fed to the kernel's plain twin (models/updates.py::error_rates_on),
against update_error_rates' composition on a provider with the same seed,
bit for bit, with the generator left in the same state, for one chain and
a batch, each rate accepted and declined; the likelihood the error move
hands to the trace row against the row's own ML; the providers the
wrapper takes, its refusals and the wrappers' input checks. Torch only but
for the JaxDraws refusal: the kernels themselves run on the card
(chip_smoke.py's rest phase)."""

import dataclasses

import numpy as np
import pytest
import torch

from bnpc_tpu_torch import graphs
from bnpc_tpu_torch import mcmc
from bnpc_tpu_torch.config import TMAX, TMIN, MCMCConfig, ModelConfig
from bnpc_tpu_torch.data import pack_data
from bnpc_tpu_torch.draws import StackedDraws, TorchDraws
from bnpc_tpu_torch.models import updates
from bnpc_tpu_torch.ops import cuda_error_mh, cuda_row
from bnpc_tpu_torch.parallel.axis import ChainAxis, MutAxis
from bnpc_tpu_torch.state import CRPState, init_state, stack_states

torch.set_num_threads(1)

K, M, N = 16, 24, 200


def _cfg(uniform: bool = False) -> ModelConfig:
    p = 1.0 if uniform else 0.25
    return ModelConfig(n_cells=N, n_muts=M, k_max=K, p=p, q=p, fp=0.01,
                       fn=0.2, learn_errors=True, fp_sd=0.01, fn_sd=0.1)


def _state(seed, chains=0):
    """A state whose statistics a panel of N cells with FP 0.01 and FN 0.2
    would give: live and free slots, parameters inside (TMIN, TMAX), counts
    drawn from them, and one chain's (0-d) or `chains` chains' ([C])
    scalars. Returns (state, n1, n0)."""
    g = torch.Generator().manual_seed(seed)
    lead = (chains,) if chains else ()
    sizes = torch.randint(0, 30, lead + (K,), generator=g, dtype=torch.int32)
    sizes[..., -3:] = 0
    params = (torch.rand(lead + (K, M), generator=g) ** 4).clamp(TMIN, TMAX)
    flip = torch.rand(lead + (K, M), generator=g) < 0.5
    params = torch.where(flip, 1.0 - params, params).clamp(TMIN, TMAX)
    seen = (sizes[..., None].float() * 0.9).round()
    p1 = params * 0.8 + (1.0 - params) * 0.01
    n1 = torch.binomial(seen.expand_as(params), p1, generator=g)
    n0 = seen - n1

    def scalar(lo, hi):
        return lo + (hi - lo) * torch.rand(lead, generator=g)

    state = CRPState(
        assignment=torch.zeros(lead + (N,), dtype=torch.int32),
        params=params, cluster_size=sizes, dp_alpha=scalar(1.5, 30.0),
        fp=scalar(0.005, 0.015), fn=scalar(0.15, 0.25))
    return state, n1, n0


class Scripted(TorchDraws):
    """A TorchDraws whose uniforms are drawn as ever (the stream moves
    alike) and then, where its script says, replaced: the script's next
    entry for each call, None keeping the drawn values."""

    def __init__(self, seed, script):
        super().__init__(seed, "cpu")
        self.script = list(script)

    def uniform(self, shape):
        u = super().uniform(shape)
        v = self.script.pop(0) if self.script else None
        return u if v is None else torch.full_like(u, v)


# A rate's proposal uniform and acceptance uniform that force its outcome:
# any proposal with a uniform of 0 (log 0 = -inf) is accepted; a proposal
# in the far upper tail, against a uniform of 1, is declined.
ACCEPT, DECLINE, DRAWN = (None, 0.0), (1.0 - 1e-7, 1.0), (None, None)

# (id, chains, each chain's (FP, FN) forcing, expected flags or None)
CASES = [
    ("one_drawn", 0, [(DRAWN, DRAWN)], None),
    ("one_accept_both", 0, [(ACCEPT, ACCEPT)], [(True, True)]),
    ("one_decline_both", 0, [(DECLINE, DECLINE)], [(False, False)]),
    ("one_fp_accepted", 0, [(ACCEPT, DECLINE)], [(True, False)]),
    ("one_fn_accepted", 0, [(DECLINE, ACCEPT)], [(False, True)]),
    ("batch3_drawn", 3, [(DRAWN, DRAWN)] * 3, None),
    ("batch3_mixed", 3, [(ACCEPT, DECLINE), (DECLINE, ACCEPT),
                         (DECLINE, DECLINE)],
     [(True, False), (False, True), (False, False)]),
]


def _providers(seed, chains, forcing):
    """One Scripted provider a chain (its scripts from `forcing`), as one
    provider or a stack."""
    provs = [Scripted(seed + c, [*fp, *fn])
             for c, (fp, fn) in enumerate(forcing)]
    return StackedDraws(provs) if chains else provs[0], provs


def _on_card(stack):
    """A stack reporting a CUDA device (a device-type stub: its providers'
    generators stay on the CPU), so that the wrapper's primitives take it
    as the card's path does."""
    if isinstance(stack, StackedDraws):
        stack.device = torch.device("cuda")
    return stack


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), (got, want)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_twin_matches_composition(case):
    """The wrapper's six primitives, through the twin == update_error_rates'
    composition on the same seeds: the new rates, both flags and the
    likelihood at the new rates bit for bit, and every generator left in
    the same state."""
    _, chains, forcing, flags = case
    cfg = _cfg()
    state, n1, n0 = _state(3, chains)
    ax = ChainAxis(chains=chains) if chains else MutAxis()
    draws, ref_provs = _providers(40, chains, forcing)
    want_state, fp_acc, fn_acc, ll = updates.update_error_rates(
        draws, state, n1, n0, cfg, ax)
    twin_draws, provs = _providers(40, chains, forcing)
    prims = cuda_error_mh.primitives(_on_card(twin_draws), state.fp.shape)
    assert [p.dtype for p in prims] == [torch.int32, torch.float32,
                                        torch.float32] * 2
    got = updates.error_rates_on(state.params, n1, n0, state.fp, state.fn,
                                 prims, cfg, ax)
    for g, w in zip(got, (want_state.fp, want_state.fn, fp_acc, fn_acc,
                          ll)):
        _same(g, w)
    for p, r in zip(provs, ref_provs):
        assert torch.equal(p.gen.get_state(), r.gen.get_state())
    if flags is not None:
        assert torch.stack([fp_acc, fn_acc], -1).reshape(-1, 2).tolist() \
            == [list(f) for f in flags]


@pytest.mark.parametrize("chains", [0, 3])
@pytest.mark.parametrize("uniform", [False, True])
def test_move_likelihood_is_the_rows_ml(chains, uniform):
    """update_error_rates' likelihood at the new rates, handed to summarize,
    gives the row that summarize computes from the statistics: ML and MAP
    bit for bit, under a uniform and a Beta(0.25, 0.25) prior."""
    cfg = _cfg(uniform)
    state, n1, n0 = _state(5, chains)
    ax = ChainAxis(chains=chains) if chains else MutAxis()
    draws, _ = _providers(60, chains, [(DRAWN, DRAWN)] * max(chains, 1))
    state, _, _, ll = updates.update_error_rates(draws, state, n1, n0, cfg,
                                                 ax)
    data = None  # the statistics are given: summarize reads no data
    want = mcmc.summarize(state, data, cfg, K, stats=(n1, n0), ax=ax)
    got = mcmc.summarize(state, data, cfg, K,
                         stats=mcmc.StepStats(n1, n0, ll), ax=ax)
    _same(got.ml, want.ml)
    _same(got.map_, want.map_)


def _panel():
    rng = np.random.default_rng(2)
    geno = rng.integers(0, 2, size=(4, M))
    x = geno[rng.integers(0, 4, size=N)].astype(float)
    flip = rng.random((N, M)) < 0.05
    x[flip] = 1.0 - x[flip]
    x[rng.random((N, M)) < 0.1] = np.nan
    return pack_data(x, "cpu")


@pytest.mark.parametrize("chains", [0, 3])
def test_step_rows_reuse_the_move_likelihood(chains):
    """Steps whose every chain takes the error move (error_prob 1) hand
    its likelihood to the row: each row's ML and MAP equal what summarize
    computes afresh on the step's state, bit for bit."""
    cfg = _cfg()
    mc = MCMCConfig(sm_prob=0.33, dpa_prob=0.25, error_prob=1.0, sm_steps=2)
    data = _panel()
    step = mcmc.make_step_fn(cfg, mc, data, K)
    states = [init_state(TorchDraws(c, "cpu"), cfg, data, "cpu")
              for c in range(max(chains, 1))]
    provs = [TorchDraws(10 + c, "cpu") for c in range(max(chains, 1))]
    state = stack_states(states) if chains else states[0]
    draws = StackedDraws(provs) if chains else provs[0]
    ax = ChainAxis(chains=chains) if chains else MutAxis()
    for _ in range(4):
        state, row = step(state, draws)
        assert int(row.mh_counts[..., 3:5, :].sum()) == 2 * max(chains, 1)
        fresh = mcmc.summarize(state, data, cfg, K, ax=ax)
        _same(row.ml, fresh.ml)
        _same(row.map_, fresh.map_)


class _OwnTruncnorm(TorchDraws):
    """A provider with a truncnorm of its own."""

    def truncnorm(self, a, b, loc, scale):
        raise AssertionError("the kernel path must not call it")


@pytest.mark.parametrize("provider", ["own_truncnorm", "cpu_stack",
                                      "mixed_stack"])
def test_refuses_other_providers(provider):
    """A provider whose truncnorm the kernel cannot replay is refused
    before any draw."""
    own = _OwnTruncnorm(0, "cpu")
    draws = {"own_truncnorm": own,
             "cpu_stack": StackedDraws([TorchDraws(1, "cpu")] * 2),
             "mixed_stack": _on_card(StackedDraws([TorchDraws(1, "cpu"),
                                                   own]))}[provider]
    before = own.gen.get_state()
    with pytest.raises(ValueError, match="cannot replay"):
        cuda_error_mh.primitives(draws, (2,) if provider != "own_truncnorm"
                                 else ())
    assert torch.equal(own.gen.get_state(), before)


def test_refuses_jax_draws_before_any_draw():
    """A JaxDraws (its own truncnorm, no generator to replay) is refused
    before it splits or draws."""
    jax = pytest.importorskip("jax")
    from tests.torch_parity import JaxDraws

    class Untouched(JaxDraws):
        def split(self, n):
            raise AssertionError("split before the refusal")

        def uniform(self, shape):
            raise AssertionError("a draw before the refusal")

        def randint(self, shape, lo, hi):
            raise AssertionError("a draw before the refusal")

    with pytest.raises(ValueError, match="cannot replay"):
        cuda_error_mh.primitives(Untouched(jax.random.PRNGKey(0)), ())


@pytest.mark.parametrize("chains", [1, 2, 4])
def test_stacked_primitives_are_each_chains(chains):
    """A stack's primitives on the card's path: slice c is what chain c's
    one-chain draws give, and each chain's generator ends where its
    one-chain composition leaves it."""
    cfg = _cfg()
    stack = _on_card(StackedDraws([TorchDraws(20 + c, "cpu")
                                   for c in range(chains)]))
    prims = cuda_error_mh.primitives(stack, (chains,))
    state, n1, n0 = _state(7)
    for c in range(chains):
        ref = TorchDraws(20 + c, "cpu")
        updates.update_error_rates(ref, state, n1, n0, cfg)
        one = cuda_error_mh.primitives(TorchDraws(20 + c, "cpu"), ())
        for got, want in zip(prims, one):
            _same(got[c], want)
        assert torch.equal(stack.chains[c].gen.get_state(),
                           ref.gen.get_state())


def test_host_values_are_the_compositions():
    """The rates' host values: the proposal stds as the composition
    multiplies them, and the prior's log(sd) and mass as its CPU tensors
    give them."""
    from bnpc_tpu_torch.ops import truncnorm

    rate = cuda_error_mh.rate(0.01, 0.01)
    assert list(rate.sd) == (torch.tensor([0.5, 1.0, 1.5]) * 0.01).tolist()
    sd = torch.tensor(0.01, dtype=torch.float32)
    assert rate.prior.log_sd == torch.log(sd).item()
    assert rate.prior.mass == truncnorm._log_gauss_mass(
        torch.tensor(-1.0), torch.tensor(99.0)).item()
    assert rate.prior.inv_sd == (torch.tensor(1.0) / sd).item()
    assert rate.prior.mean == torch.tensor(0.01).item()


def _error_args(chains=0):
    state, n1, n0 = _state(9, chains)
    shape = tuple(state.fp.shape)
    prims = cuda_error_mh.primitives(TorchDraws(3, "cpu"), shape) \
        if not chains else cuda_error_mh.primitives(
            _on_card(StackedDraws([TorchDraws(c, "cpu")
                                   for c in range(chains)])), shape)
    return [state.params, n1, n0, state.fp, state.fn, prims]


@pytest.mark.parametrize("fault,err", [
    ("short_n1", ValueError), ("f64_params", TypeError),
    ("i64_idx", TypeError), ("rows_not_rates", ValueError),
    ("five_prims", ValueError), ("cpu", ValueError)])
def test_error_mh_checks_its_inputs(fault, err):
    """Wrong shapes, dtypes or devices raise before any launch (the last
    case is right in every way but the device)."""
    args = _error_args(3 if fault == "rows_not_rates" else 0)
    if fault == "short_n1":
        args[1] = args[1][:, :-1]
    elif fault == "f64_params":
        args[0] = args[0].double()
    elif fault == "i64_idx":
        args[5][0] = args[5][0].long()
    elif fault == "rows_not_rates":
        args[0], args[1], args[2] = (t[0] for t in args[:3])
    elif fault == "five_prims":
        args[5] = args[5][:5]
    before = cuda_error_mh.launches + cuda_error_mh.chain_launches
    with pytest.raises(err):
        cuda_error_mh.error_mh(*args, _cfg())
    assert cuda_error_mh.launches + cuda_error_mh.chain_launches == before


@pytest.mark.parametrize("fault,err", [
    ("short_n0", ValueError), ("i64_sizes", TypeError),
    ("f64_ml", TypeError), ("mask_width", ValueError), ("cpu", ValueError)])
def test_trace_row_checks_its_inputs(fault, err):
    """Wrong shapes, dtypes or devices raise before any launch."""
    state, n1, n0 = _state(11)
    ml, ax = None, MutAxis()
    if fault == "short_n0":
        n0 = n0[:-1]
    elif fault == "i64_sizes":
        state = state._replace(cluster_size=state.cluster_size.long())
    elif fault == "f64_ml":
        ml = torch.zeros((), dtype=torch.float64)
    elif fault == "mask_width":
        ax = MutAxis(mask=torch.ones(M - 1))
    before = cuda_row.launches + cuda_row.chain_launches
    with pytest.raises(err):
        cuda_row.ml_map(_cfg(), state, n1, n0, ml, ax)
    assert cuda_row.launches + cuda_row.chain_launches == before


@pytest.mark.parametrize("move", ["error_mh", "trace_row"])
def test_non_cpu_tensors_never_take_the_composition(move):
    """update_error_rates and summarize send every tensor off the CPU to
    the wrappers, which raise where they cannot launch (here meta
    tensors)."""
    state, n1, n0 = _state(13)
    state = CRPState(*(t.to("meta") for t in state))
    n1, n0 = n1.to("meta"), n0.to("meta")
    stub = TorchDraws(0, "cpu")
    with pytest.raises(ValueError):
        if move == "error_mh":
            updates.update_error_rates(stub, state, n1, n0, _cfg())
        else:
            mcmc.summarize(state, None, _cfg(), K, stats=(n1, n0))


@pytest.mark.parametrize("mod", [cuda_error_mh, cuda_row],
                         ids=["error_mh", "trace_row"])
def test_replays_count_the_kernels(mod):
    """Captured pieces add the wrappers' launches at each replay, as they
    do every kernel wrapper's (graphs.COUNTED)."""
    assert mod in graphs.COUNTED
    before = graphs.read_counts()
    i = graphs.COUNTED.index(mod)
    delta = [(0, 0, {}) for _ in graphs.COUNTED]
    delta[i] = (3, 2, {4: 2})
    graphs.add_counts(delta)
    try:
        assert mod.launches == before[i][0] + 3
        assert mod.chain_launches == before[i][1] + 2
        assert mod.chain_grids.get(4, 0) == before[i][2].get(4, 0) + 2
    finally:
        graphs.set_counts(before)


def test_batch_rows_are_each_chains():
    """The batched composition under a ChainAxis gives chain c what the
    one-chain move gives it: update_error_rates and summarize, bit for
    bit (the sums run chain by chain)."""
    cfg = dataclasses.replace(_cfg(), p=0.5, q=0.5)
    state, n1, n0 = _state(15, 3)
    draws, _ = _providers(80, 3, [(DRAWN, DRAWN)] * 3)
    batch = updates.update_error_rates(draws, state, n1, n0, cfg,
                                       ChainAxis(chains=3))
    row = mcmc.summarize(batch[0], None, cfg, K, stats=(n1, n0),
                         ax=ChainAxis(chains=3))
    for c in range(3):
        one = CRPState(*(t[c] for t in state))
        d, _ = _providers(80 + c, 0, [(DRAWN, DRAWN)])
        alone = updates.update_error_rates(d, one, n1[c], n0[c], cfg)
        for g, w in zip((batch[0].fp, batch[0].fn, *batch[1:]),
                        (alone[0].fp, alone[0].fn, *alone[1:])):
            _same(g[c], w)
        one_row = mcmc.summarize(alone[0], None, cfg, K,
                                 stats=(n1[c], n0[c]))
        _same(row.ml[c], one_row.ml)
        _same(row.map_[c], one_row.map_)


def test_captured_batch_hands_the_move_likelihood_over():
    """A captured batch whose every chain takes the error move at every
    step (error_prob 1: _CapturedBatch._errors hands the move's likelihood
    to the rows, put back in chain order) == _batch_block over the eager
    step, bit for bit (tests/test_torch_graphs_batched.py's CPU stand-in
    for the graphs)."""
    from tests import test_torch_graphs_batched as gb

    mix = dataclasses.replace(gb.MIX, error_prob=1.0)
    batch = gb._captured("lazy", mix=mix)
    batch._setup(mcmc.stack_states(gb._start(3)))
    log = gb.RunLog(batch)
    got = gb._run(batch.run, 3)
    gb.assert_same_runs(got, gb._run(gb._eager("lazy", mix=mix), 3))
    assert {k for k, _ in log.runs if k[0] == "errors"} == {("errors", 3)}
