"""Kernel 1's bound and verify (csrc/lazy_segment.cu), modelled on the CPU.

The segment kernel settles most cells without a search of every slot: a
parallel pass bounds each position's logits at the launch's sizes
(``lazy_bounds_ref``), and the serial walk takes a cell's launch-time best
slot when a float32 check proves that no other slot can reach it since,
running the full pick otherwise (``lazy_segment_verified_ref``, which counts
the full picks). These tests hold that model of the kernel's arithmetic to
the definition, ``lazy_segment_ref``, in targets, sizes and info: on planted
clones (no full pick), random rows (many), crafted near ties one and two
floats apart, exact ties, rows of -inf, a singleton's slot emptied, a
birth, a veto, relaunches from i0 > 0 and a batch of chains; and check that
the check's tolerance is needed (without it a crafted near tie goes to the
wrong slot). ``chip_smoke.py`` holds the kernel to the same cases on the
card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from bnpc_tpu_torch.ops.cuda_gibbs import (lazy_bounds_ref,
                                           lazy_segment_chains_ref,
                                           lazy_segment_ref,
                                           lazy_segment_verified_ref,
                                           segment_chains_ref)

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _sweep(fn, case, **kw):
    """`fn` over the case's sweep from its i0, relaunched after every birth
    as the sweep's host loop does (without its z patch): (tgt, sizes,
    infos, full picks)."""
    n = case["n"]
    z, aux, assign, perm = (_t(case[f]) for f in ("z", "aux", "assign",
                                                  "perm"))
    ld = torch.tensor(case.get("log_denom", 0.0), dtype=torch.float32)
    sizes = _t(case["sizes"]).clone()
    tgt = torch.full((n,), -7, dtype=torch.int32)
    infos, full, i = [], 0, case["i0"]
    while i < n:
        info = torch.zeros((4,), dtype=torch.int32)
        full += fn(z, aux, assign, perm, sizes, tgt, info, i, ld, **kw) or 0
        infos.append(info.tolist())
        i = infos[-1][0]
    return tgt, sizes, infos, full


def _check(case, **kw):
    """The verified walk against the twin; returns (twin, full picks)."""
    twin = _sweep(lazy_segment_ref, case)
    tgt, sizes, infos, full = _sweep(lazy_segment_verified_ref, case, **kw)
    assert infos == twin[2]
    assert torch.equal(tgt, twin[0])
    assert torch.equal(sizes, twin[1])
    return twin, full


def _planted(seed, n=300, m=64, clones=6, k_pad=64):
    """The sweep input at a planted assignment: each slot's log-likelihood
    of every cell under its clone's parameters (FN 0.1, FP 0.001) with
    Gumbel noise folded in, as models/gibbs.py::_sweep_inputs builds Z."""
    rng = np.random.default_rng(seed)
    geno = rng.random((k_pad, m)) < 0.3
    clone = rng.integers(0, clones, n)
    x = geno[clone]
    x = np.where(x, rng.random((n, m)) >= 0.1, rng.random((n, m)) < 0.001)
    theta = np.where(geno, 0.95, 0.02)
    p1 = theta * 0.9 + (1.0 - theta) * 0.001
    ll = x @ np.log(p1).T + (~x) @ np.log(1.0 - p1).T

    def gumbel(*shape):
        return -np.log(-np.log(rng.random(shape)))

    z = (ll + gumbel(n, k_pad)).astype(np.float32)
    aux = (ll[:, -1] - np.log(n) + gumbel(n)).astype(np.float32)
    sizes = np.bincount(clone, minlength=k_pad).astype(np.float32)
    sizes[k_pad - 4:] = -1.0
    return dict(z=z, aux=aux, assign=clone.astype(np.int32),
                perm=rng.permutation(n).astype(np.int32), sizes=sizes, n=n,
                i0=0, log_denom=np.float32(np.log(n - 1.0 + 1.0)))


def _random(seed, n=96, k_pad=64, k_max=40, live=30, hot=0.1, i0=0):
    """Random rows: births (hot cells), deaths and, once the free slots run
    out, vetoes; most cells' margins are below what the check asks."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, live, n).astype(np.int32)
    aux = np.full(n, -1e30, np.float32)
    aux[rng.random(n) < hot] = 1e30
    sizes = np.bincount(assign, minlength=k_pad).astype(np.float32)
    sizes[k_max:] = -1.0
    return dict(z=(rng.standard_normal((n, k_pad)) * 3.0).astype(np.float32),
                aux=aux, assign=assign,
                perm=rng.permutation(n).astype(np.int32), sizes=sizes, n=n,
                i0=i0, log_denom=np.float32(np.log(n + 2.0)))


@pytest.mark.parametrize("seed", range(2))
def test_planted_clones_settle_every_cell(seed):
    _, full = _check(_planted(seed))
    assert full == 0


@pytest.mark.parametrize("seed,i0", [(0, 0), (1, 0), (2, 37)])
def test_random_rows_fall_back(seed, i0):
    twin, full = _check(_random(seed, i0=i0))
    assert len(twin[2]) > 1, "no birth exercised"
    assert full > (96 - i0) // 4


@pytest.mark.parametrize("k_pad", [32, 64, 256])
def test_near_ties(k_pad):
    """Top two logits 0, 1 and 2 floats apart at the visit, either one the
    better, across lanes and within one: each goes to the full pick and to
    the twin's slot."""
    case = chip_smoke.near_tie_case(k_pad)
    twin, full = _check(case)
    got = twin[0].tolist()
    assert {p: got[p] for p in case["want"]} == case["want"]
    assert full >= len(case["want"]) - 1  # all but the gain cell


@pytest.mark.parametrize("k_pad", [32, 64])
def test_tolerance_is_needed(k_pad):
    """The mutation check: with tol = 0 the crafted rounding case settles
    on the launch's best slot, where the twin takes slot 0."""
    case = chip_smoke.near_tie_case(k_pad)
    twin = _sweep(lazy_segment_ref, case)
    tgt = _sweep(lazy_segment_verified_ref, case, tol_scale=0.0)[0]
    bad = (tgt != twin[0]).nonzero().flatten().tolist()
    assert bad and all(twin[0][p] == 0 for p in bad)


@pytest.mark.parametrize("k_pad", [32, 64])
def test_crafted_ties_minus_inf_death_birth(k_pad):
    """chip_smoke's crafted sweep: exact ties across and within lanes, -0.0
    against +0.0, a row of -inf, a death and a birth into the freed slot,
    from position 37 and relaunched after the birth."""
    case = chip_smoke.crafted_case(k_pad, k_pad - 3)
    twin, _ = _check(case)
    got = twin[0].tolist()
    assert {p: got[p] for p in case["want"]} == case["want"]
    assert len(twin[2]) == 2


@pytest.mark.parametrize("aux_hot", [False, True])
def test_singleton_slot_emptied(aux_hot):
    """A cell alone in slot 7, its best slot at the launch: at its visit
    that slot is empty (logit -inf), so the bound settles nothing and the
    full pick takes slot 2, or, when its new-cluster option wins, a birth
    into slot 7, the first free one."""
    rng = np.random.default_rng(5)
    n, k_pad = 40, 32
    assign = rng.integers(0, 7, n).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    c = perm[11]
    assign[c] = 7
    z = (rng.standard_normal((n, k_pad)) - 60.0).astype(np.float32)
    z[np.arange(n), assign] = 0.0
    z[c, 2] = -5.0
    aux = np.full(n, -1e30, np.float32)
    aux[c] = 1e30 if aux_hot else -1e30
    sizes = np.bincount(assign, minlength=k_pad).astype(np.float32)
    case = dict(z=z, aux=aux, assign=assign, perm=perm, sizes=sizes, n=n,
                i0=3, log_denom=np.float32(3.0))
    twin, full = _check(case)
    assert twin[0][11] == (7 if aux_hot else 2)
    assert full == 1


def test_veto():
    """Every slot live (three phantom cells each): hot cells' new-cluster
    option wins with no free slot, which the full pick vetoes."""
    case = _random(3, n=80, k_pad=32, k_max=32, live=32, hot=0.2)
    case["sizes"] = case["sizes"] + 3.0
    twin, _ = _check(case)
    assert twin[2][-1][3] == 1 and len(twin[2]) == 1


def test_bounds_are_first_best_and_runner_up():
    """The bound pass on rows with ties, -0.0 / +0.0 and -inf: b the first
    slot of the best logit at the launch's weights, vb its z, s2 the best
    of the others (-inf for a row with one finite logit)."""
    rng = np.random.default_rng(7)
    n, k_pad = 64, 32
    z = np.round(rng.standard_normal((n, k_pad)), 1).astype(np.float32)
    z[3] = -np.inf
    z[4, 9] = 0.0
    z[5, :] = -np.inf
    z[5, 20] = -0.0
    z[5, 21] = 0.0
    z[6, :] = -np.inf
    z[6, 30] = 1.0
    sizes = np.full(k_pad, 2.0, np.float32)
    sizes[[1, 8]] = 0.0
    ld = torch.tensor(0.5)
    perm = _t(rng.permutation(n).astype(np.int32))
    out = lazy_bounds_ref(_t(z), perm, _t(sizes), 10, ld)
    assert (out[:, :10] == 0).all()
    w = torch.log(torch.clamp(_t(sizes), min=0.0)) - ld
    for i in range(10, n):
        logit = _t(z)[perm[i]] + w
        best = logit.max()
        b = int((logit == best).nonzero()[0])
        rest = torch.cat([logit[:b], logit[b + 1:]]).max()
        assert out[0, i] == b and out[1, i] == z[perm[i], b]
        assert out[2, i] == rest
        assert out[2, i] != 0 or not out[2, i].signbit()


def test_batch_of_three():
    """The verified walk chain by chain against the batched twin: chains
    from positions 0, 9 and n (done)."""
    cases = [_random(s, n=64, k_pad=32, k_max=28, live=20, hot=0.05)
             for s in range(3)]
    z, aux, assign, perm = (torch.stack([_t(c[f]) for c in cases])
                            for f in ("z", "aux", "assign", "perm"))
    ld = torch.tensor([c["log_denom"] for c in cases])
    i0s = [0, 9, 64]
    outs = []
    for run in (lambda *a: segment_chains_ref(
            lazy_segment_verified_ref, a[:4], *a[4:]),
            lazy_segment_chains_ref):
        sizes = torch.stack([_t(c["sizes"]) for c in cases])
        tgt = torch.full((3, 64), -7, dtype=torch.int32)
        info = torch.zeros((3, 4), dtype=torch.int32)
        starts = torch.tensor(i0s, dtype=torch.int32)
        rounds = []
        while (starts < 64).any():
            run(z, aux, assign, perm, sizes, tgt, info, starts, ld)
            rounds.append(info.clone())
        outs.append((tgt, sizes, rounds))
    (vt, vs, vr), (rt, rs, rr) = outs
    assert torch.equal(vt, rt) and torch.equal(vs, rs)
    assert all(torch.equal(a, b) for a, b in zip(vr, rr))
    assert len(rr) > 1
