"""The split-merge acceptance (ops/cuda_sm_accept.py): kernel 12 on the
card, its plain twin on the CPU behind one interface. Here, at 200 x 24,
k_max 16, on seeded launch states: a batch of 3 against its chains alone
bit for bit (state, MH counts, generators), splits and merges, outcomes
drawn and forced each way, Beta and uniform priors; the application's
invariants for each forced outcome; the counts the move carries against
fresh products; the draws and the providers the wrapper takes; its
checks; the route by device; the launch counters. The twin's ratio is
held to bnpc_tpu in tests/test_torch_splitmerge.py; the kernel to the
twin on the card (chip_smoke.py's sm_accept phase)."""

import dataclasses
import functools
import types

import pytest
import torch

import chip_smoke
from bnpc_tpu_torch import graphs
from bnpc_tpu_torch.draws import StackedDraws, TorchDraws
from bnpc_tpu_torch.models import splitmerge as sm
from bnpc_tpu_torch.ops import cuda_sm_accept as ka
from bnpc_tpu_torch.parallel.axis import ChainAxis
from tests.test_torch_rg_assign import _CardStack

torch.set_num_threads(1)

N, M, K = 200, 24, 16
PRIORS = {"beta": {}, "uniform": {"p": 1.0, "q": 1.0}}


def _same(got, want, tag="test"):
    """Bit for bit, NaN payloads included."""
    chip_smoke.same_bits(tag, got, want)


@functools.lru_cache(maxsize=None)
def _case(split, chains, seed):
    """A move's context and launch state (_rg_init's) at N x M: (cfg,
    data, state, ctx, rgs), one chain or a stack of `chains`."""
    return chip_smoke.rg_move_inputs("cpu", N, M, K, 3, seed, chains, split)


def _draws(seed, chains):
    provs = [TorchDraws(seed + c, "cpu") for c in range(max(chains, 1))]
    return (_CardStack(provs) if chains else provs[0]), provs


def _ax(chains):
    return ChainAxis(chains=chains) if chains else sm._NO_AXIS


def _check(got, want):
    for g, w in zip(got[0], want[0]):
        _same(g, w)
    _same(got[1], want[1])


def _gens(provs):
    return [p.gen.get_state() for p in provs]


# How each case forces its outcome on the tail after the final scan: the
# final scan's transition sum moved far down (the ratio up) or up, or
# every movable cell put on side 0 (a degenerate split, declined at any
# uniform).
OUTCOMES = {"drawn": (0.0, False), "accepted": (-1e4, False),
            "declined": (1e4, False), "degenerate": (-1e4, True)}


def _forced(split, chains, outcome):
    cfg, data, state, ctx, rgs = _case(split, chains, 7)
    draws, _ = _draws(30, chains)
    scan = sm._rg_scan_split if split else sm._rg_scan_merge
    rgs2, gs = scan(draws, ctx, rgs, state, data, cfg, True, _ax(chains))
    shift, degenerate = OUTCOMES[outcome]
    if degenerate:
        rgs2 = rgs2._replace(rg=torch.zeros_like(rgs2.rg))
    return cfg, data, state, ctx, rgs2, gs + shift


def _tail(split, k_f2, k_acc, ctx, rgs2, gs, state, data, cfg, ax):
    if split:
        return sm._split_accept(k_f2, k_acc, ctx, rgs2, gs, state, cfg, ax)
    return sm._merge_accept(k_f2, k_acc, ctx, rgs2, gs, state, data, cfg,
                            ax)


def _chain(t, c):
    """Chain c of a batch's tuple of tensors (other fields as they are)."""
    return type(t)(*(v[c] if isinstance(v, torch.Tensor) else v for v in t))


@pytest.mark.parametrize("outcome", ["drawn", "accepted", "declined"])
@pytest.mark.parametrize("prior", sorted(PRIORS))
@pytest.mark.parametrize("split", [True, False], ids=["split", "merge"])
def test_batch_matches_its_chains(split, prior, outcome):
    """The acceptance after the final scan of a batch of 3 == each chain's
    alone from its own provider: the new state and the MH counts bit for
    bit, every generator left in the same state."""
    cfg0, data, state, ctx, rgs2, gs = _forced(split, 3, outcome)
    cfg = dataclasses.replace(cfg0, **PRIORS[prior])
    draws, provs = _draws(60, 3)
    k_f2, k_acc = draws.split(2)
    got = _tail(split, k_f2, k_acc, ctx, rgs2, gs, state, data, cfg, _ax(3))
    got_gens = _gens(provs)
    for c in range(3):
        one = TorchDraws(60 + c, "cpu")
        k_f2, k_acc = one.split(2)
        want = _tail(split, k_f2, k_acc, _chain(ctx, c), _chain(rgs2, c),
                     gs[c], _chain(state, c), data, cfg, sm._NO_AXIS)
        _check((_chain(got[0], c), got[1][c]), want)
        assert torch.equal(got_gens[c], one.gen.get_state())


def _applied(split, ctx, rgs2, state, new, counts):
    """The application, chain by chain, from its MH counts' flag: a
    declined move leaves the state as it was; an accepted split moves
    side 1 (its anchor included) to the first empty slot with the split
    pair's rows, an accepted merge moves cluster b into a with the merged
    row; the sizes count the new assignment. Returns the flags."""
    flags = []
    row = 0 if split else 1
    by_chain = counts.reshape(-1, 2, 2)
    for c in range(by_chain.shape[0]):
        old, cur, cx, rg = ((_chain(t, c) for t in (state, new, ctx, rgs2))
                            if ctx.n_move.dim() else (state, new, ctx, rgs2))
        cnt = by_chain[c]
        assert int(cnt.sum()) == 1 and int(cnt[1 - row].sum()) == 0
        accepted = bool(cnt[row, 0])
        k = old.cluster_size.shape[-1]
        assert torch.equal(torch.bincount(old.assignment.long(),
                                          minlength=k).to(torch.int32),
                           old.cluster_size)
        if not accepted:
            for g, w in zip(cur, old):
                _same(g, w)
            flags.append(False)
            continue
        assign, params = old.assignment.clone(), old.params.clone()
        a = int(cx.cl_a)
        if split:
            slot = int(torch.nonzero(old.cluster_size == 0)[0])
            side1 = cx.s_mask & (rg.rg == 1)
            side1[int(cx.anchor_j)] = True
            assign[side1] = slot
            params[a], params[slot] = rg.params_split[0], rg.params_split[1]
        else:
            assign[old.assignment == int(cx.cl_b)] = a
            params[a] = rg.params_merge
        _same(cur.assignment, assign)
        _same(cur.params, params)
        _same(cur.cluster_size, torch.bincount(
            assign.long(), minlength=k).to(torch.int32))
        flags.append(True)
    return flags


@pytest.mark.parametrize("chains", [0, 3], ids=["one_chain", "batch3"])
@pytest.mark.parametrize("split,outcome", [
    (True, "drawn"), (True, "accepted"), (True, "declined"),
    (True, "degenerate"), (False, "drawn"), (False, "accepted"),
    (False, "declined")])
def test_tail_outcomes(split, outcome, chains):
    """The acceptance after the final scan, its outcome drawn or forced
    each way: the flags as forced (a split whose final sides hold every
    movable cell on one side is declined at any ratio) and the state
    applied as they say."""
    cfg, data, state, ctx, rgs2, gs = _forced(split, chains, outcome)
    draws, _ = _draws(60, chains)
    k_f2, k_acc = draws.split(2)
    new, counts = _tail(split, k_f2, k_acc, ctx, rgs2, gs, state, data, cfg,
                        _ax(chains))
    flags = torch.tensor(_applied(split, ctx, rgs2, state, new, counts))
    if outcome != "drawn":
        count = torch.where(ctx.s_mask, rgs2.rg, 0).sum(-1).reshape(-1)
        s_count = (ctx.n_move - 2.0).reshape(-1)
        stuck = split & ((s_count > 0) & ((count == 0) | (count == s_count)))
        want = (outcome == "accepted") & ~stuck
        assert torch.equal(flags, want)
        assert bool(want.any()) == (outcome == "accepted")


@pytest.mark.parametrize("chains", [0, 3], ids=["one_chain", "batch3"])
@pytest.mark.parametrize("when", ["init", "scans"])
def test_carried_counts_equal_fresh_products(when, chains):
    """The counts the move carries (_RGState) == fresh products of its side
    masks and its cells: after _rg_init, and after launch scans."""
    cfg, data, state, ctx, rgs = _case(True, chains, 9)
    if when == "scans":
        draws, _ = _draws(40, chains)
        for kk in draws.split(2):
            k1, k2 = kk.split(2)
            rgs, _ = sm._rg_scan_split(k1, ctx, rgs, state, data, cfg,
                                       False, _ax(chains))
            rgs, _ = sm._rg_scan_merge(k2, ctx, rgs, state, data, cfg,
                                       False, _ax(chains))
    sides = torch.stack(sm._side_masks(ctx, rgs.rg), dim=-2)
    n1, n0 = sm._masked_counts(sides, data)
    c1, c0 = sm._masked_counts(ctx.cells.to(torch.float32), data)
    for got, want in ((rgs.n1_sides, n1), (rgs.n0_sides, n0),
                      (rgs.n1_cells, c1), (rgs.n0_cells, c0)):
        _same(got, want)


@pytest.mark.parametrize("merge", [False, True], ids=["split", "merge"])
def test_primitives_are_the_compositions_draws(merge):
    """The wrapper's std index and uniform == the reference's draws in its
    order (the std index from the stream, a merge's from its first split,
    then the uniform), leaving the stream where they leave it."""
    shape = (2, M) if merge else (M,)
    got_d = TorchDraws(3, "cpu")
    idx, u = ka.primitives(got_d, got_d, shape, (), merge, "cpu")
    want_d = TorchDraws(3, "cpu")
    k_std = want_d.split(2)[0] if merge else want_d
    want_idx = k_std.randint(shape, 0, 3)
    _same(idx, want_idx)
    _same(u, want_d.uniform(()))
    assert torch.equal(got_d.gen.get_state(), want_d.gen.get_state())


class _OwnUniform(TorchDraws):
    def uniform(self, shape):
        return super().uniform(shape) * 1.0


REFUSED = {
    "own_uniform": lambda: _OwnUniform(0, "cpu"),
    "stack_on_cpu": lambda: StackedDraws(
        [TorchDraws(c, "cpu") for c in range(2)]),
    "stack_of_own": lambda: _CardStack(
        [_OwnUniform(c, "cpu") for c in range(2)]),
}


@pytest.mark.parametrize("provider", sorted(REFUSED))
def test_refuses_what_it_cannot_replay(provider):
    """On the card, a provider other than TorchDraws or a stack of them
    raises "cannot replay" before any draw, as either provider."""
    for at in (0, 1):
        draws = REFUSED[provider]()
        provs = getattr(draws, "chains", [draws])
        gens = _gens(provs)
        args = [TorchDraws(9, "cpu"), TorchDraws(9, "cpu")]
        args[at] = draws
        with pytest.raises(ValueError, match="cannot replay"):
            ka.primitives(*args, (2, M), (2,), True, "cuda")
        assert all(torch.equal(g, w) for g, w in zip(_gens(provs), gens))


@pytest.mark.parametrize("provider", sorted(REFUSED))
def test_cpu_takes_any_provider(provider):
    """On the CPU (the twin's route) the providers the card refuses are
    taken: the std index, then the uniform, as the provider draws them."""
    got_d = REFUSED[provider]()
    lead = (2,) if hasattr(got_d, "chains") else ()
    shape = lead + (2, M)
    idx, u = ka.primitives(got_d, got_d, shape, lead, True, "cpu")
    want_d = REFUSED[provider]()
    _same(idx, want_d.split(2)[0].randint(shape, 0, 3))
    _same(u, want_d.uniform(lead))


def test_refuses_jax_draws_before_any_draw():
    """On the card a JaxDraws is refused before it splits or draws."""
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
        ka.primitives(Untouched(jax.random.PRNGKey(0)), TorchDraws(0, "cpu"),
                      (2, M), (), True, "cuda")


@pytest.mark.parametrize("fault,err,match", [
    ("cpu", ValueError, "unsupported device"), ("rg_dtype", TypeError, "rg"),
    ("std_shape", ValueError, "std_idx"), ("u_shape", ValueError, "u"),
    ("params_rows", ValueError, "neither"),
    ("gs_shape", ValueError, "gs_fwd")])
def test_wrapper_checks_its_inputs(fault, err, match):
    """The wrapper raises for a wrong dtype or shape before any stage, and
    the kernel's stages for a CPU tensor before any launch: the counters
    stay."""
    cfg, data, state, ctx, rgs = _case(True, 0, 11)
    prims = list(ka.primitives(TorchDraws(1, "cpu"), TorchDraws(2, "cpu"),
                               (M,), (), False, "cpu"))
    gs = torch.zeros(())
    if fault == "rg_dtype":
        rgs = rgs._replace(rg=rgs.rg.to(torch.int64))
    elif fault == "std_shape":
        prims[0] = prims[0][:-1].contiguous()
    elif fault == "u_shape":
        prims[1] = prims[1][None]
    elif fault == "params_rows":
        state = state._replace(params=state.params[None])
    elif fault == "gs_shape":
        gs = gs[None]
    before = (ka.launches, ka.chain_launches)
    with pytest.raises(err, match=match):
        ka.split(prims, ctx, rgs, gs, state, cfg,
                 stages=ka.KERNEL if fault == "cpu" else None)
    assert (ka.launches, ka.chain_launches) == before


class _Routed(Exception):
    pass


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("split", [True, False], ids=["split", "merge"])
def test_non_cpu_tensors_never_take_the_composition(split, device,
                                                    monkeypatch):
    """The route is the device alone: a tensor off the CPU (here meta)
    goes to the kernel's stages, the CPU takes the twin's."""
    cfg, data, state, ctx, rgs = _case(split, 0, 13)
    draws, _ = _draws(1, 0)
    scan = sm._rg_scan_split if split else sm._rg_scan_merge
    rgs2, gs = scan(draws, ctx, rgs, state, data, cfg, True, sm._NO_AXIS)

    def routed(*args, **kw):
        raise _Routed

    monkeypatch.setattr(ka, "KERNEL", types.SimpleNamespace(
        split_terms=routed, merge_terms=routed))
    drawn = ka.primitives
    monkeypatch.setattr(ka, "primitives", lambda *a: tuple(
        t.to(device) for t in drawn(*a)))
    if device != "cpu":
        ctx, rgs2, state = (type(t)(*(
            v.to(device) if isinstance(v, torch.Tensor) else v for v in t))
            for t in (ctx, rgs2, state))
        gs = gs.to(device)
    assert ka.fits(state.assignment.device) is (device != "cpu")

    def tail():
        k_f2, k_acc = TorchDraws(3, "cpu").split(2)
        if split:
            return sm._split_accept(k_f2, k_acc, ctx, rgs2, gs, state, cfg,
                                    sm._NO_AXIS)
        return sm._merge_accept(k_f2, k_acc, ctx, rgs2, gs, state, data,
                                cfg, sm._NO_AXIS)

    if device == "cpu":
        tail()
    else:
        with pytest.raises(_Routed):
            tail()


def test_replays_count_the_kernel():
    """Captured pieces add the wrapper's launches at each replay, as they
    do every kernel wrapper's (graphs.COUNTED)."""
    assert ka in graphs.COUNTED
    before = graphs.read_counts()
    i = graphs.COUNTED.index(ka)
    delta = [(0, 0, {}) for _ in graphs.COUNTED]
    delta[i] = (3, 2, {4: 2})
    graphs.add_counts(delta)
    try:
        assert ka.launches == before[i][0] + 3
        assert ka.chain_launches == before[i][1] + 2
        assert ka.chain_grids.get(4, 0) == before[i][2].get(4, 0) + 2
    finally:
        graphs.set_counts(before)
