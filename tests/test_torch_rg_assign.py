"""A split-merge launch scan's fused per-cell work (kernel 9,
ops/cuda_rg_assign.py): the kernel's plain twin against the torch
composition of models/splitmerge.py::_rg_scan_assign (the visit order,
kernel 2's twin, the merge and scatter, the side masks, the replay's
per-position terms), bit for bit; the move's route to the kernel, run on
the CPU with the twin in the kernel's place, against the composition on
the same draws; the providers the wrapper takes; its refusals; the route
by device and n; the launch counters. Torch only: the kernel itself runs
on the card (chip_smoke.py's rg_assign phase)."""

import pytest
import torch

import chip_smoke
from bnpc_tpu_torch import graphs
from bnpc_tpu_torch.config import ModelConfig
from bnpc_tpu_torch.data import pack_data
from bnpc_tpu_torch.draws import StackedDraws, TorchDraws, gumbel_of
from bnpc_tpu_torch.models import splitmerge as sm
from bnpc_tpu_torch.ops import cuda_rg_assign
from bnpc_tpu_torch.parallel.axis import ChainAxis
from bnpc_tpu_torch.state import init_state, stack_states, unstack_states

torch.set_num_threads(1)

N = 96


def _same(got, want):
    """Bit for bit, NaN payloads included."""
    chip_smoke.same_bits("test", got, want)


def _chain(seed, s_count, **kw):
    return chip_smoke.rg_assign_case(seed, N, s_count, **kw)


# Named launch scans; "batch3" is 3 chains of different s_counts.
CASES = {
    "s_count_0": lambda: _chain(1, 0),
    "s_count_1": lambda: _chain(2, 1),
    "s_count_n_minus_2": lambda: _chain(3, N - 2),
    "equal_keys": lambda: _chain(4, 50, ties=6),
    "launch_all_0": lambda: _chain(5, 60, launch="zeros"),
    "launch_all_1": lambda: _chain(6, 60, launch="ones"),
    # n_move below the move's cells: dtab's +inf (side 0 would empty) is
    # reached, and the replay takes logs of counts <= 0.
    "dtab_inf_reached": lambda: _chain(7, 70, n_move=30),
    "batch3": lambda: chip_smoke.rg_assign_batch(
        [_chain(8, 0), _chain(9, 17), _chain(10, N - 2)]),
}


def _twin(x, trans_prob):
    return cuda_rg_assign.rg_assign_ref(
        *chip_smoke.rg_assign_args(x, trans_prob))


@pytest.mark.parametrize("trans_prob", [False, True], ids=["scan", "trans"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_composition(case, trans_prob):
    """The twin (S alone sorted by (key, cell), block-style counts) == the
    composition in the new sides, the side masks and the per-position
    chosen terms, bit for bit."""
    x = CASES[case]()
    got = _twin(x, trans_prob)
    want = chip_smoke.rg_assign_composed(x, trans_prob)
    _same(got[0], want[0])
    _same(got[1], want[1])
    if trans_prob:
        _same(got[2], want[2])
        lead = x["s_mask"].shape[:-1]
        s_count = x["s_mask"].sum(-1)
        pos = torch.arange(N)
        assert bool((got[2][pos >= s_count[..., None]] == 0).all())
        assert got[2].shape == lead + (N,)
    else:
        assert got[2] is None


def test_cases_reach_what_they_are_named_for():
    """The equal keys sit in S and the lower cell goes first; the +inf of
    the table is met; both launch sides' extremes change sides."""
    x = CASES["equal_keys"]()
    s = torch.nonzero(x["s_mask"]).flatten()
    key = x["bits"][0, s] * 2**32 + x["bits"][1, s]
    assert int(torch.unique(key).numel()) < int(s.numel())
    order = cuda_rg_assign._s_order(x["bits"], x["s_mask"])[:s.numel()]
    tied = [int(c) for c in order
            if int((key == key[s == c]).sum()) > 1]
    assert tied == sorted(tied) and len(tied) > 1
    x = CASES["dtab_inf_reached"]()
    count1 = int(torch.where(x["s_mask"], x["rg"], 0).sum())
    assert count1 + int(x["s_mask"].sum()) - 1 >= float(x["n_move"]) - 2
    for case in ("launch_all_0", "launch_all_1"):
        x = CASES[case]()
        rg_new = _twin(x, False)[0]
        assert bool((rg_new[x["s_mask"]] != x["rg"][x["s_mask"]]).any())


def _move_inputs(seed, chains=0):
    """A launch scan's context and launch state at 60 x 40 (a split), one
    chain or a stack of `chains`."""
    return chip_smoke.rg_move_inputs("cpu", 60, 40, 16, 3, seed, chains)


class _CardStack(StackedDraws):
    """A CPU stack that runs each TorchDraws composite once on stacked
    primitives, as a stack on the card does (``StackedDraws._batched``),
    and so do its splits and folds."""

    def _batched(self, name):
        return all(isinstance(p, TorchDraws)
                   and getattr(type(p), name) is getattr(TorchDraws, name)
                   for p in self.chains)

    def split(self, n):
        return [_CardStack(s.chains) for s in super().split(n)]

    def fold_in(self, i):
        return _CardStack(super().fold_in(i).chains)

    def fold_axis(self, i):
        return _CardStack(super().fold_axis(i).chains)

    def take(self, idx):
        return _CardStack(super().take(idx).chains)


def _routed(monkeypatch, calls):
    """Send _rg_scan_assign to the kernel's route, with the twin in the
    kernel's place; `calls` notes each launch's cell count."""
    def kernel(noise, *args):
        calls.append(noise.shape[-2])
        return cuda_rg_assign.rg_assign_ref(noise, *args)

    monkeypatch.setattr(cuda_rg_assign, "fits", lambda device, n: True)
    monkeypatch.setattr(cuda_rg_assign, "rg_assign", kernel)


PROVIDERS = {
    "torch": (0, lambda s: TorchDraws(s, "cpu")),
    "stack_on_card": (3, lambda s: _CardStack(
        [TorchDraws(s + c, "cpu") for c in range(3)])),
}


@pytest.mark.parametrize("trans_prob", [False, True], ids=["scan", "trans"])
@pytest.mark.parametrize("provider", sorted(PROVIDERS))
def test_route_matches_composition(provider, trans_prob, monkeypatch):
    """_rg_scan_assign on the kernel's route (the twin in the kernel's
    place) == its composition on the same seed: the new sides, the
    transition sum and the side masks bit for bit, the generators left in
    the same state."""
    chains, make = PROVIDERS[provider]
    cfg, data, state, ctx, rgs = _move_inputs(5, chains)
    ax = ChainAxis(chains=chains) if chains else sm._NO_AXIS

    def run(draws):
        out = sm._rg_scan_assign(draws, ctx, rgs.rg, rgs.params_split,
                                 state, data, cfg, trans_prob, ax)
        gens = [d.gen.get_state() for d in getattr(draws, "chains",
                                                   [draws])]
        return out, gens

    want, want_gens = run(make(90))
    calls = []
    _routed(monkeypatch, calls)
    got, got_gens = run(make(90))
    assert calls == [cfg.n_cells]
    _same(got[0], want[0])
    _same(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        _same(g, w)
    assert all(torch.equal(g, w) for g, w in zip(got_gens, want_gens))


@pytest.mark.parametrize("chains", [0, 3], ids=["one_chain", "batch3"])
def test_split_merge_route_matches_composition(chains, monkeypatch):
    """Whole split-merge moves (splits and merges, their launch scans and
    the split branch's final scan) on the kernel's route == the
    composition, state and counts bit for bit."""
    cfg = ModelConfig(n_cells=60, n_muts=40, k_max=16, p=0.25, q=0.25)
    data_np, planted = chip_smoke.make_data(60, 40, 3, 0.1, seed=3)
    data = pack_data(data_np, "cpu")
    states = [init_state(TorchDraws(s, "cpu"), cfg, data, "cpu",
                         assign=planted) for s in range(max(chains, 1))]

    def moves(routed):
        if routed:
            _routed(monkeypatch, [])
        sts, out = list(states), []
        for step in range(6):
            keys = [TorchDraws(100 * step + c, "cpu")
                    for c in range(len(sts))]
            if chains:
                st, counts = sm.split_merge(
                    _CardStack(keys), stack_states(sts), data, cfg, 0.5,
                    2, ax=ChainAxis(chains=chains))
                sts = unstack_states(st)
            else:
                st, counts = sm.split_merge(keys[0], sts[0], data, cfg, 0.5,
                                            2)
                sts = [st]
            out.append((sts, counts))
        return out

    want = moves(False)
    got = moves(True)
    kinds = set()
    for (g_sts, g_counts), (w_sts, w_counts) in zip(got, want):
        _same(g_counts, w_counts)
        kinds |= {int(k) for k in torch.nonzero(
            w_counts.reshape(-1, 2, 2).sum(-1))[:, 1]}
        for g, w in zip(g_sts, w_sts):
            for a, b in zip(g, w):
                _same(a, b)
    assert kinds == {0, 1}  # splits and merges both ran


@pytest.mark.parametrize("fault,err,match", [
    ("cpu", ValueError, "unsupported device"), ("int_ll2", TypeError, "ll2"),
    ("noise_shape", ValueError, "noise"), ("bits_int32", TypeError, "bits"),
    ("anchor_shape", ValueError, "anchor_i"),
    ("too_many_cells", ValueError, "cells")])
def test_wrapper_refuses(fault, err, match):
    """The wrapper raises for a wrong dtype, shape, device or cell count
    before any launch: the counters stay."""
    x = _chain(11, 20)
    if fault == "int_ll2":
        x["ll2"] = x["ll2"].to(torch.int32)
    elif fault == "noise_shape":
        x["noise"] = x["noise"][:, 0].contiguous()
    elif fault == "bits_int32":
        x["bits"] = x["bits"].to(torch.int32)
    elif fault == "anchor_shape":
        x["anchor_i"] = x["anchor_i"][None]
    elif fault == "too_many_cells":
        x = chip_smoke.rg_assign_case(11, cuda_rg_assign.MAX_CELLS + 1, 20)
    before = (cuda_rg_assign.launches, cuda_rg_assign.chain_launches)
    with pytest.raises(err, match=match):
        cuda_rg_assign.rg_assign(*chip_smoke.rg_assign_args(x, True))
    assert (cuda_rg_assign.launches, cuda_rg_assign.chain_launches) == before


@pytest.mark.parametrize("device,n,kernel", [
    ("cpu", 5000, False), ("meta", 5000, False), ("cuda", 5000, True),
    ("cuda", 1, True), ("cuda", cuda_rg_assign.MAX_CELLS, True),
    ("cuda", cuda_rg_assign.MAX_CELLS + 1, False), ("cuda", 131072, False)])
def test_route_by_device_and_n(device, n, kernel):
    """The route is the device and n alone: a CUDA tensor of up to
    MAX_CELLS cells goes to the kernel; the CPU, any other device and a
    larger n keep the composition."""
    assert cuda_rg_assign.fits(torch.device(device), n) is kernel


def test_providers_taken():
    """The kernel takes the uniforms of TorchDraws' own Gumbel transform,
    one chain's or a stack's run once on the card: gumbel_of turns them
    into what the provider's gumbel draws, from the same stream."""
    got = cuda_rg_assign.noise(TorchDraws(4, "cpu"), (5, 2))
    _same(gumbel_of(got), TorchDraws(4, "cpu").gumbel((5, 2)))
    stack = _CardStack([TorchDraws(c, "cpu") for c in range(2)])
    got = cuda_rg_assign.noise(stack, (2, 5, 2))
    _same(gumbel_of(got), torch.stack(
        [TorchDraws(c, "cpu").gumbel((5, 2)) for c in range(2)]))


class _OwnGumbel(TorchDraws):
    def gumbel(self, shape):
        return super().gumbel(shape) * 1.0


REFUSED = {
    "own_gumbel": lambda: _OwnGumbel(0, "cpu"),
    "stack_on_cpu": lambda: StackedDraws(
        [TorchDraws(c, "cpu") for c in range(2)]),
    "stack_of_own": lambda: _CardStack(
        [_OwnGumbel(c, "cpu") for c in range(2)]),
}


@pytest.mark.parametrize("provider", sorted(REFUSED))
def test_noise_refuses_what_the_kernel_cannot_replay(provider):
    """A provider whose Gumbel noise the kernel cannot replay raises
    "cannot replay" before any draw, as the Beta rows' kernel does for
    its own."""
    draws = REFUSED[provider]()
    gens = [d.gen.get_state() for d in getattr(draws, "chains", [draws])]
    with pytest.raises(ValueError, match="cannot replay"):
        cuda_rg_assign.noise(draws, (2, 5, 2))
    assert all(torch.equal(d.gen.get_state(), g) for d, g in zip(
        getattr(draws, "chains", [draws]), gens))


def test_replays_count_the_kernel():
    """Captured pieces add the wrapper's launches at each replay, as they
    do every kernel wrapper's (graphs.COUNTED)."""
    assert cuda_rg_assign in graphs.COUNTED
    before = graphs.read_counts()
    i = graphs.COUNTED.index(cuda_rg_assign)
    delta = [(0, 0, {}) for _ in graphs.COUNTED]
    delta[i] = (3, 1, {2: 1})
    graphs.add_counts(delta)
    try:
        assert cuda_rg_assign.launches == before[i][0] + 3
        assert cuda_rg_assign.chain_launches == before[i][1] + 1
        assert cuda_rg_assign.chain_grids.get(2, 0) == \
            before[i][2].get(2, 0) + 1
    finally:
        graphs.set_counts(before)
