"""The fused Beta posterior rows' wrapper (ops/cuda_beta.py): the 26
primitives it draws, fed to the kernel's plain twin
(state.py::beta_posterior_on, ops/randomx.py::beta_general_on), against the
composition (state.py::beta_posterior_params, randomx.beta_general) on a
provider with the same seed, bit for bit, with the generator left in the
same state: one chain, a stack's chains, and a split-merge launch's three
rows in one call against three calls; the layout the wrapper hands the
kernel; crafted primitives that reach every branch of the sampler; the
providers it takes; its refusals. Torch only: the kernel itself runs on the
card (chip_smoke.py's beta_post phase)."""

import pytest
import torch

import chip_smoke
from bnpc_tpu_torch import graphs
from bnpc_tpu_torch.config import TMAX, TMIN, ModelConfig
from bnpc_tpu_torch.data import pack_data
from bnpc_tpu_torch.draws import Draws, StackedDraws, TorchDraws
from bnpc_tpu_torch.models import splitmerge
from bnpc_tpu_torch.ops import cuda_beta, randomx
from bnpc_tpu_torch.state import (beta_posterior_on, beta_posterior_params,
                                  beta_posterior_rows, init_state)

torch.set_num_threads(1)

M = 200
CFG = ModelConfig(n_cells=60, n_muts=M, k_max=16, p=0.25, q=0.25)


def _counts(shape, seed):
    """Integer counts as a split-merge launch sees them (N1 small, N0
    large) in float32."""
    g = torch.Generator().manual_seed(seed)
    n1 = torch.randint(0, 40, shape, generator=g).to(torch.float32)
    n0 = torch.randint(0, 400, shape, generator=g).to(torch.float32)
    return n1, n0


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got - want).abs().max()


def _on_card(provider):
    """`provider` reporting a CUDA device (a device-type stub: its
    generators stay on the CPU; a stack that draws must be stubbed itself,
    not its chains, which would move their draws to the device)."""
    provider.device = torch.device("cuda")
    return provider


def test_primitive_count():
    assert randomx.BETA_PRIMITIVES == 26
    assert len(cuda_beta.primitives(TorchDraws(0, "cpu"), (3,))) == 26


@pytest.mark.parametrize("shape", [(M,), (2, M), (16, M), (1, 7)],
                         ids=["merge", "split", "k_max", "narrow"])
def test_twin_matches_composition(shape):
    """The wrapper's primitives from a CPU TorchDraws, through the twin ==
    beta_posterior_params on the same seed, bit for bit, and the generator
    left in the same state."""
    n1, n0 = _counts(shape, 3)
    ref = TorchDraws(11, "cpu")
    want = beta_posterior_params(ref, CFG, n1, n0)
    d = TorchDraws(11, "cpu")
    got = beta_posterior_on(cuda_beta.primitives(d, shape), CFG, n1, n0)
    _same(got, want)
    assert torch.equal(d.gen.get_state(), ref.gen.get_state())
    assert bool(((want >= TMIN) & (want <= TMAX)).all())


def test_twin_matches_randomx_beta_general():
    """randomx.beta_general_on on the primitives == randomx.beta_general on
    the same seed (no clamp, parameters below and above 1)."""
    a = torch.tensor([0.25, 0.7, 1.0, 3.5, 40.25, 1000.0])
    b = torch.flip(a, (0,))
    want = randomx.beta_general(TorchDraws(5, "cpu"), a, b)
    prims = cuda_beta.primitives(TorchDraws(5, "cpu"), a.shape)
    _same(randomx.beta_general_on(prims, a, b), want)


@pytest.mark.parametrize("chains", [1, 3])
def test_stacked_primitives_are_each_chains(chains):
    """A stack's primitives on the card's path (a StackedDraws reporting a
    CUDA device): slice c is what chain c's one-chain draws give, through
    the twin chain c's composition, and each chain's generator ends where
    its one-chain composition leaves it."""
    stack = _on_card(StackedDraws([TorchDraws(20 + c, "cpu")
                                   for c in range(chains)]))
    prims = cuda_beta.primitives(stack, (chains, 2, M))
    n1, n0 = _counts((chains, 2, M), 4)
    for c in range(chains):
        ref = TorchDraws(20 + c, "cpu")
        want = beta_posterior_params(ref, CFG, n1[c], n0[c])
        one = cuda_beta.primitives(TorchDraws(20 + c, "cpu"), (2, M))
        for got, w in zip(prims, one):
            _same(got[c], w)
        _same(beta_posterior_on([p[c] for p in prims], CFG, n1[c], n0[c]),
              want)
        assert torch.equal(stack.chains[c].gen.get_state(),
                           ref.gen.get_state())


def _three_calls(seed, n1, n0):
    """_rg_init's three rows as three beta_posterior_params calls, k_i, k_j
    then k_m, on one TorchDraws(seed): (split [2, m], merge [m], gen)."""
    d = TorchDraws(seed, "cpu")
    rows = [beta_posterior_params(d, CFG, n1[g], n0[g]) for g in range(3)]
    return torch.stack(rows[:2]), rows[2], d.gen.get_state()


def test_rg_init_rows_in_one_call():
    """The three rows' primitives drawn in one go (k_i, k_j, k_m), each
    through the twin, and beta_posterior_rows on the [3, m] counts, both ==
    three beta_posterior_params calls on the same seed, bit for bit, with
    the same generator state."""
    n1, n0 = _counts((3, M), 8)
    split, merge, state = _three_calls(13, n1, n0)
    d = TorchDraws(13, "cpu")
    prims = [cuda_beta.primitives(d, (M,)) for _ in range(3)]
    assert torch.equal(d.gen.get_state(), state)
    for g, want in enumerate([split[0], split[1], merge]):
        _same(beta_posterior_on(prims[g], CFG, n1[g], n0[g]), want)
    d = TorchDraws(13, "cpu")
    got = beta_posterior_rows((d, d, d), CFG, n1, n0)
    _same(got, torch.cat([split, merge[None]]))
    assert torch.equal(d.gen.get_state(), state)


def _cpu_kernel(calls):
    """A CPU stand-in for cuda_beta.beta_post that decodes the documented
    layout (a row's primitives at [..., 26, m] beside its [..., m] counts)
    and runs the twin on it; it notes each call's `chains`."""

    def beta_post(n1, n0, prims, cfg, chains=0):
        calls.append(chains)
        assert n1.is_contiguous() and prims.is_contiguous()
        assert prims.shape == n1.shape[:-1] + (randomx.BETA_PRIMITIVES,
                                               n1.shape[-1])
        return beta_posterior_on(prims.unbind(-2), cfg, n1, n0)

    return beta_post


def test_posterior_hands_the_kernel_its_layout(monkeypatch):
    """cuda_beta.posterior draws k_i, k_j, k_m in order and stacks every
    row's primitives where the kernel reads them: through a CPU stand-in of
    the kernel it gives the three calls' rows and generator state, counted
    as a one-chain launch; a stack of chains as a batched one."""
    calls = []
    monkeypatch.setattr(cuda_beta, "beta_post", _cpu_kernel(calls))
    n1, n0 = _counts((3, M), 9)
    split, merge, state = _three_calls(17, n1, n0)
    d = TorchDraws(17, "cpu")
    got = cuda_beta.posterior((d, d, d), n1, n0, CFG)
    _same(got, torch.cat([split, merge[None]]))
    assert torch.equal(d.gen.get_state(), state) and calls == [0]

    chains = 3
    n1, n0 = _counts((chains, 3, M), 10)
    stack = _on_card(StackedDraws([TorchDraws(30 + c, "cpu")
                                   for c in range(chains)]))
    got = cuda_beta.posterior((stack,) * 3, n1, n0, CFG)
    assert calls == [0, chains]
    for c in range(chains):
        split, merge, state = _three_calls(30 + c, n1[c], n0[c])
        _same(got[c], torch.cat([split, merge[None]]))
        assert torch.equal(stack.chains[c].gen.get_state(), state)


def test_rg_init_against_three_calls():
    """splitmerge._rg_init's rows == three beta_posterior_params calls on
    its launch sides' and its cells' counts, drawn from the same stream
    after the move's setup."""
    data_np, _ = chip_smoke.make_data(CFG.n_cells, M, 3, 0.1, seed=2)
    data = pack_data(data_np, "cpu")
    state = init_state(TorchDraws(1, "cpu"), CFG, data, "cpu")
    ctx = splitmerge._setup(TorchDraws(2, "cpu"), state, CFG, True)
    d = TorchDraws(3, "cpu")
    rgs = splitmerge._rg_init(d, ctx, state, data, CFG)

    side0, side1 = splitmerge._side_masks(ctx, rgs.rg)
    counts = [splitmerge._masked_counts(s, data)
              for s in (side0, side1, ctx.cells.to(torch.float32))]
    n1 = torch.stack([c[0] for c in counts])
    n0 = torch.stack([c[1] for c in counts])
    split, merge, gen = _three_calls(3, n1, n0)
    _same(rgs.params_split, split)
    _same(rgs.params_merge, merge)
    assert torch.equal(d.gen.get_state(), gen)


def test_crafted_cases():
    """chip_smoke's crafted primitives (the card holds the kernel to the
    twin on them) reach what they are named for, through the twin."""
    n1, n0, prims, names = chip_smoke.beta_crafted("cpu")
    assert len(prims) == randomx.BETA_PRIMITIVES
    assert len(set(names)) == len(names) == n1.shape[0]
    out = beta_posterior_on(prims, CFG, n1, n0)
    row = {name: r for r, name in enumerate(names)}
    a, b = CFG.p + n1, CFG.q + n0
    d_a, d_b = a + 1.0 - 1.0 / 3.0, b + 1.0 - 1.0 / 3.0
    boost = randomx.GAMMA_PRIMITIVES - 1

    def beta_of(ga, gb):
        return torch.clamp(ga / (ga + gb), TMIN, TMAX)

    # No round accepts (v <= 0 in each, or v > 0 and the uniform too
    # high): each gamma stays at d before its boost.
    for name in ("v_nonpositive", "all_reject"):
        r = row[name]
        ga = d_a[r] * prims[boost][r] ** (1.0 / a[r])
        gb = d_b[r] * prims[2 * boost + 1][r] ** (1.0 / b[r])
        _same(out[r], beta_of(ga, gb))
    # The first accepting round's d * v stays, whatever later rounds do.
    for name, first in (("first_round", 0), ("third_round", 2)):
        r = row[name]
        c = 1.0 / torch.sqrt(9.0 * d_a[r])
        v = (1.0 + c * prims[2 * first][r]) ** 3
        ga = d_a[r] * v * prims[boost][r] ** (1.0 / a[r])
        _, gb = _gammas(prims, r, a, b)
        _same(out[r], beta_of(ga, gb))
    assert bool((n1[row["no_counts"]] == 0).all())
    assert bool((n0[row["no_counts"]] == 0).all())
    _same(out[row["clamp_low"]], torch.full((n1.shape[-1],), TMIN))
    _same(out[row["clamp_high"]], torch.full((n1.shape[-1],), TMAX))
    _same(out[row["zero_denominator"]], torch.full((n1.shape[-1],), 0.5))


def _gammas(prims, r, a, b):
    """Row r's two boosted gammas through the twin's own helper."""
    k = randomx.GAMMA_PRIMITIVES
    return (randomx._boosted_on(a[r], [p[r] for p in prims[:k]]),
            randomx._boosted_on(b[r], [p[r] for p in prims[k:]]))


class _OwnBeta(TorchDraws):
    """A provider with a Beta of its own (as the tests' JaxDraws)."""

    def beta_general(self, a, b):
        raise AssertionError("the kernel path must not call it")


def test_takes_torch_draws_and_their_stacks():
    assert cuda_beta.takes(TorchDraws(0, "cpu"))
    assert cuda_beta.takes(chip_smoke.HostDraws(0, "cpu"))
    stack = StackedDraws([_on_card(TorchDraws(i, "cpu")) for i in range(3)])
    assert cuda_beta.takes(stack)
    # A CPU stack runs its composites per chain: not the kernel's replay.
    assert not cuda_beta.takes(StackedDraws([TorchDraws(0, "cpu")] * 2))
    assert not cuda_beta.takes(_OwnBeta(0, "cpu"))
    assert not cuda_beta.takes(StackedDraws(
        [_on_card(TorchDraws(0, "cpu")), _on_card(_OwnBeta(1, "cpu"))]))
    assert not cuda_beta.takes(Draws())


@pytest.mark.parametrize("provider", ["own_beta", "stack", "plain"])
def test_refuses_other_providers(provider):
    """A provider whose Beta the kernel cannot replay is refused before
    any draw."""
    own = _on_card(_OwnBeta(0, "cpu"))
    draws = {"own_beta": own, "stack": StackedDraws([own] * 2),
             "plain": Draws()}[provider]
    before = own.gen.get_state()
    with pytest.raises(ValueError, match="cannot replay"):
        cuda_beta.primitives(draws, (2, M))
    assert torch.equal(own.gen.get_state(), before)


def test_other_providers_keep_their_own_beta():
    """beta_posterior_rows sends a provider the kernel does not take to its
    own beta_general, row by row (the JAX parity tests' JaxDraws)."""
    seen = []

    class Own(TorchDraws):
        def beta_general(self, a, b):
            seen.append(tuple(a.shape))
            return TorchDraws.beta_general(self, a, b)

    n1, n0 = _counts((3, M), 6)
    beta_posterior_rows((Own(0, "cpu"),) * 3, CFG, n1, n0)
    assert seen == [(M,)] * 3


@pytest.mark.parametrize("provider", ["own_beta", "cpu_stack"])
def test_off_the_cpu_every_provider_goes_to_the_kernel(provider):
    """Counts off the CPU (here on the meta device, as a CUDA tensor would
    be) go to the kernel's path whatever the provider: one it cannot
    replay raises there, before any draw, and never falls back to its own
    beta_general."""
    own = _OwnBeta(0, "cpu")
    draws = {"own_beta": own,
             "cpu_stack": StackedDraws([TorchDraws(1, "cpu")] * 2)}[provider]
    n1 = torch.zeros((3, M), device="meta")
    before = own.gen.get_state()
    with pytest.raises(ValueError, match="cannot replay"):
        beta_posterior_rows((draws,) * 3, CFG, n1, n1)
    with pytest.raises(ValueError, match="cannot replay"):
        beta_posterior_params(draws, CFG, n1[0], n1[0])
    assert torch.equal(own.gen.get_state(), before)


def _post_args(shape=(3, M)):
    n1, n0 = _counts(shape, 2)
    prims = torch.rand(shape[:-1] + (randomx.BETA_PRIMITIVES, shape[-1]))
    return [n1, n0, prims]


@pytest.mark.parametrize("fault,err", [
    ("short_n0", ValueError), ("f64_prims", TypeError),
    ("prims_count", ValueError), ("strided_n1", ValueError),
    ("no_axis", ValueError), ("int_n1", TypeError),
    ("prims_rows", ValueError), ("cpu", ValueError)])
def test_beta_post_checks_its_inputs(fault, err):
    """Wrong shapes, dtypes, layouts or devices raise before any launch
    (the last case is right in every way but the device)."""
    args = _post_args()
    if fault == "short_n0":
        args[1] = args[1][:, :-1]
    elif fault == "f64_prims":
        args[2] = args[2].double()
    elif fault == "prims_count":
        args[2] = args[2][:, :-1]
    elif fault == "strided_n1":
        args[0] = torch.rand(M, 3).mT
    elif fault == "no_axis":
        args = [t[0, 0] for t in args]
    elif fault == "int_n1":
        args[0] = args[0].to(torch.int32)
    elif fault == "prims_rows":
        args[2] = args[2][:-1]
    before = (cuda_beta.launches, cuda_beta.chain_launches)
    with pytest.raises(err):
        cuda_beta.beta_post(*args, CFG)
    assert (cuda_beta.launches, cuda_beta.chain_launches) == before


def test_replays_count_the_kernel():
    """Captured pieces add the wrapper's launches at each replay, as they
    do every kernel wrapper's (graphs.COUNTED)."""
    assert cuda_beta in graphs.COUNTED
    before = graphs.read_counts()
    i = graphs.COUNTED.index(cuda_beta)
    delta = [(0, 0, {}) for _ in graphs.COUNTED]
    delta[i] = (2, 1, {4: 1})
    graphs.add_counts(delta)
    try:
        assert cuda_beta.launches == before[i][0] + 2
        assert cuda_beta.chain_launches == before[i][1] + 1
        assert cuda_beta.chain_grids.get(4, 0) == before[i][2].get(4, 0) + 1
    finally:
        graphs.set_counts(before)

