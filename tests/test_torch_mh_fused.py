"""The fused MH sweep's wrapper (ops/cuda_mh.py): the three primitives it
draws, fed to the kernel's plain twin (ops/mh.py::sweep_on), against
ops/mh.py's composition on a provider with the same seed, bit for bit, with
the generator left in the same state; a stack's primitives as each chain's
own; the providers it takes; its refusals. Torch only: the kernel itself
runs on the card (chip_smoke.py's MH-sweep phase)."""

import pytest
import torch

from bnpc_tpu_torch import graphs
from bnpc_tpu_torch.config import TMAX, TMIN, ModelConfig
from bnpc_tpu_torch.draws import Draws, StackedDraws, TorchDraws
from bnpc_tpu_torch.ops import cuda_mh
from bnpc_tpu_torch.ops import mh
from bnpc_tpu_torch.parallel.axis import MutAxis

torch.set_num_threads(1)

M = 200


def _cfg(uniform: bool) -> ModelConfig:
    p = 1.0 if uniform else 0.25
    return ModelConfig(n_cells=500, n_muts=M, k_max=256, p=p, q=p)


def _rows(shape, chains, seed):
    """Parameter rows inside (TMIN, TMAX), integer counts, and one chain's
    (0-d) or `chains` chains' ([C]) error rates."""
    g = torch.Generator().manual_seed(seed)
    params = torch.rand(shape, generator=g).clamp(TMIN, TMAX)
    n1 = torch.randint(0, 40, shape, generator=g).to(torch.float32)
    n0 = torch.randint(0, 400, shape, generator=g).to(torch.float32)
    rate_shape = (chains,) if chains else ()
    fp = 0.001 + 0.02 * torch.rand(rate_shape, generator=g)
    fn = 0.1 + 0.2 * torch.rand(rate_shape, generator=g)
    return params, n1, n0, fp, fn


def _mask(padded: bool):
    if not padded:
        return None
    mask = torch.ones(M)
    mask[-3:] = 0.0
    return mask


N_STD = len(mh.PARAM_PROPOSAL_SD)


def _primitives(seed, shape):
    """The wrapper's three primitives from TorchDraws(seed)."""
    return cuda_mh.primitives(TorchDraws(seed, "cpu"), shape, N_STD)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got - want).abs().max()


# (id, row shape, chains, trans_prob, uniform prior, padded mask)
SWEEPS = [
    ("k256", (256, M), 0, False, True, False),
    ("k256_trans_beta", (256, M), 0, True, False, False),
    ("split", (2, M), 0, True, False, False),
    ("split_uniform", (2, M), 0, True, True, False),
    ("merge", (M,), 0, True, False, False),
    ("merge_no_trans", (M,), 0, False, False, False),
    ("batch3", (3, 256, M), 3, False, False, False),
    ("batch3_trans", (3, 256, M), 3, True, True, False),
    ("k256_masked", (256, M), 0, True, False, True),
    ("split_masked", (2, M), 0, False, True, True),
]
# (id, one chain's row shape, chains)
STACKS = [
    ("stack_k256", (256, M), 3),
    ("stack_split", (2, M), 2),
    ("stack_merge", (M,), 3),
    ("stack_one", (2, M), 1),
]


@pytest.mark.parametrize("case", SWEEPS, ids=[c[0] for c in SWEEPS])
def test_twin_matches_composition(case):
    """The wrapper's primitives from a CPU TorchDraws, through the twin ==
    ops/mh.py on the same seed: new params, per-row declined counts and
    transition sums bit for bit, and the generator left in the same
    state."""
    _, shape, chains, trans, uniform, padded = case
    cfg, mask = _cfg(uniform), _mask(padded)
    params, n1, n0, fp, fn = _rows(shape, chains, 7)
    ax = MutAxis(mask=mask)
    ref = TorchDraws(11, "cpu")
    want = mh.mh_cluster_params(ref, params, n1, n0, fp, fn, cfg,
                                trans_prob=trans, ax=ax)
    d = TorchDraws(11, "cpu")
    prims = cuda_mh.primitives(d, shape, N_STD)
    assert prims[0].dtype == torch.int32
    got = mh.sweep_on(params, n1, n0, fp, fn, *prims, cfg, trans, ax)
    for g, w in zip(got, want):
        _same(g, w)
    assert want.declined.shape == shape[:-1]
    assert torch.equal(d.gen.get_state(), ref.gen.get_state())


@pytest.mark.parametrize("case", STACKS, ids=[c[0] for c in STACKS])
def test_stacked_primitives_are_each_chains(case):
    """A stack's primitives on the card's path (a StackedDraws reporting a
    CUDA device): slice c is what chain c's one-chain draws give, and each
    chain's generator ends where its one-chain composition leaves it."""
    _, shape, chains = case
    stack = StackedDraws([TorchDraws(20 + c, "cpu") for c in range(chains)])
    stack.device = torch.device("cuda")
    prims = cuda_mh.primitives(stack, (chains,) + shape, N_STD)
    params, n1, n0, fp, fn = _rows(shape, 0, 5)
    for c in range(chains):
        ref = TorchDraws(20 + c, "cpu")
        mh.mh_cluster_params(ref, params, n1, n0, fp, fn, _cfg(False), True)
        one = _primitives(20 + c, shape)
        for got, want in zip(prims, one):
            _same(got[c], want)
        assert torch.equal(stack.chains[c].gen.get_state(),
                           ref.gen.get_state())


@pytest.mark.parametrize("padded", [False, True])
def test_accepted_sweep_is_its_realized_move(padded):
    """A sweep that accepts every coordinate (acceptance uniforms at 0)
    sums, with trans_prob, what the realized mode sums for the move it
    made: the kernel's two modes share their log-acceptance and row sums."""
    cfg, mask = _cfg(False), _mask(padded)
    params, n1, n0, fp, fn = _rows((2, M), 0, 3)
    std_idx, u_prop, _ = _primitives(5, (2, M))
    ax = MutAxis(mask=mask)
    res = mh.sweep_on(params, n1, n0, fp, fn, std_idx, u_prop,
                      torch.zeros(2, M), cfg, True, ax)
    assert int(res.declined.sum()) == 0
    std = mh.choose(std_idx, mh.PARAM_PROPOSAL_SD)
    a, b = (TMIN - params) / std, (TMAX - params) / std
    _same(res.trans_logprob,
          mh.realized_sum(res.params, params, n1, n0, a, b, std, fp, fn, cfg,
                          ax))


class _OwnTruncnorm(TorchDraws):
    """A provider with a truncnorm of its own (as the tests' JaxDraws)."""

    def truncnorm(self, a, b, loc, scale):
        raise AssertionError("the kernel path must not call it")


def _on_card(provider):
    """`provider` reporting a CUDA device (a device-type stub: its
    generator stays on the CPU)."""
    provider.device = torch.device("cuda")
    return provider


def test_takes_torch_draws_and_their_stacks():
    assert cuda_mh.takes(TorchDraws(0, "cpu"))
    assert cuda_mh.takes(_on_card(TorchDraws(0, "cpu")))
    stack = StackedDraws([_on_card(TorchDraws(i, "cpu")) for i in range(3)])
    assert cuda_mh.takes(stack)
    # A CPU stack runs its composites per chain: not the kernel's replay.
    assert not cuda_mh.takes(StackedDraws([TorchDraws(0, "cpu")] * 2))
    assert not cuda_mh.takes(_OwnTruncnorm(0, "cpu"))
    assert not cuda_mh.takes(StackedDraws(
        [_on_card(TorchDraws(0, "cpu")), _on_card(_OwnTruncnorm(1, "cpu"))]))
    assert not cuda_mh.takes(Draws())


@pytest.mark.parametrize("provider", ["own_truncnorm", "stack", "plain"])
def test_refuses_other_providers(provider):
    """On the card a provider whose truncnorm the kernel cannot replay is
    refused before any draw: nothing falls back to the composition."""
    own = _on_card(_OwnTruncnorm(0, "cpu"))
    draws = {"own_truncnorm": own, "stack": StackedDraws([own] * 2),
             "plain": Draws()}[provider]
    before = own.gen.get_state()
    with pytest.raises(ValueError, match="cannot replay"):
        cuda_mh.primitives(draws, (2, M), N_STD)
    assert torch.equal(own.gen.get_state(), before)


def test_non_cpu_tensors_never_take_the_composition():
    """ops/mh.py sends every tensor off the CPU to the wrapper, which raises
    where it cannot launch (here a meta tensor)."""
    params, n1, n0, fp, fn = (t.to("meta") for t in _rows((2, M), 0, 1))
    with pytest.raises(ValueError):
        mh.mh_cluster_params(TorchDraws(0, "cpu"), params, n1, n0, fp, fn,
                             _cfg(True))
    with pytest.raises(ValueError):
        mh.realized_trans_logprob(params, params, n1, n0, params, params,
                                  params, fp, fn, _cfg(True))


def _sweep_args(shape=(2, M), chains=0):
    params, n1, n0, fp, fn = _rows(shape, chains, 2)
    return [params, n1, n0, fp, fn, *_primitives(3, shape)]


@pytest.mark.parametrize("fault,err", [
    ("short_n1", ValueError), ("f64_u", TypeError), ("i64_std", TypeError),
    ("strided_params", ValueError), ("fp_per_row", ValueError),
    ("mask_width", ValueError), ("cpu", ValueError)])
def test_sweep_checks_its_inputs(fault, err):
    """Wrong shapes, dtypes, layouts or devices raise before any launch
    (the last case is right in every way but the device)."""
    args, mask = _sweep_args(), None
    if fault == "short_n1":
        args[1] = args[1][:, :-1]
    elif fault == "f64_u":
        args[7] = args[7].double()
    elif fault == "i64_std":
        args[5] = args[5].long()
    elif fault == "strided_params":
        args[0] = torch.rand(M, 2).mT
    elif fault == "fp_per_row":
        args[3], args[4] = torch.full((2,), 0.01), torch.full((2,), 0.2)
        args[3] = args[3][:, None].expand(2, M)
    elif fault == "mask_width":
        mask = torch.ones(M - 1)
    before = cuda_mh.launches
    with pytest.raises(err):
        cuda_mh.mh_sweep(*args, _cfg(True), True, mask)
    assert cuda_mh.launches == before


@pytest.mark.parametrize("fault", ["short_std", "chains_mismatch", "cpu"])
def test_realized_checks_its_inputs(fault):
    params, n1, n0, fp, fn = _rows((2, M), 0, 4)
    args = [params, params, n1, n0, params, params, params, fp, fn]
    if fault == "short_std":
        args[6] = params[:, 1:]
    elif fault == "chains_mismatch":
        args[7], args[8] = torch.full((3,), 0.01), torch.full((3,), 0.2)
    with pytest.raises(ValueError):
        cuda_mh.realized(*args, _cfg(False))


def test_replays_count_the_kernel():
    """Captured pieces add the wrapper's launches at each replay, as they
    do every kernel wrapper's (graphs.COUNTED)."""
    assert cuda_mh in graphs.COUNTED
    before = graphs.read_counts()
    i = graphs.COUNTED.index(cuda_mh)
    delta = [(0, 0, {}) for _ in graphs.COUNTED]
    delta[i] = (3, 1, {4: 1})
    graphs.add_counts(delta)
    try:
        assert cuda_mh.launches == before[i][0] + 3
        assert cuda_mh.chain_launches == before[i][1] + 1
        assert cuda_mh.chain_grids.get(4, 0) == before[i][2].get(4, 0) + 1
    finally:
        graphs.set_counts(before)
