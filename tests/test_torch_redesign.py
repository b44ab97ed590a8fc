"""The designs of the restricted-scan and eager-sweep CUDA kernels, modelled
on the CPU and held against their plain twins.

The kernels (bnpc_tpu_torch/csrc/rg_scan.cu, csrc/sweep.cu) run only on a
card; what can be checked here is that the way they rearrange the work
computes the twins' function.

* The restricted scan does not load ``dtab[s1]`` on its serial chain. Where
  the table range the scan can reach is non-decreasing and NaN-free, every
  cell's comparison ``dz[i] + dtab[s] > 0`` is false below a threshold
  ``t_i`` and true from it on; the thresholds are binary searches on the
  float32 predicate, done ahead, and the chain is integers:
  ``count1' = count1 - lau[i] + (count1 >= t_i + lau[i])``, carried as
  ``y = count1 + (launch sides of the chunk so far)`` so that a link is
  ``y' = y + (y >= U_i)``. Any other table takes the recurrence as written.
  `threshold_scan` models that, chunks, neutral padding and all.
* The eager sweep keeps rows ``z[perm[i + 1 .. i + kRing - 1]]`` copied
  ahead. A birth patches a column of z under them, so the loop leaves, the
  column is patched and every row of the ring is copied anew before the
  loop starts again at the next position. `ring_sweep` models the ring;
  without that refresh it must differ from the twin.
"""

import numpy as np
import pytest
import torch

from bnpc_tpu_torch.ops.cuda_gibbs import pick_ref
from bnpc_tpu_torch.ops.cuda_rg import rg_scan_ref
from bnpc_tpu_torch.ops.cuda_sweep import eager_sweep_ref

torch.set_num_threads(1)

F32 = np.float32
CHUNK, TURN = 992, 32  # csrc/rg_scan.cu: kChunk, 2 * kGroup
K_RING = 8             # csrc/gibbs_common.cuh: kRing


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# (a), (b): the threshold scan
# ---------------------------------------------------------------------------


def build_dtab(n, n_move):
    """The count log-table as models/splitmerge.py::_rg_scan_assign builds
    it."""
    s1r = torch.arange(n + 2, dtype=torch.float32)
    n_move = torch.tensor(float(n_move))
    return (torch.log(s1r + 1.0)
            - torch.log(torch.clamp(n_move - s1r - 2.0, min=0.0))).numpy()


def table_is_monotone(tab) -> bool:
    """The kernel's check: every entry <= its successor (the last against
    itself), which a NaN on either side fails."""
    tab = np.asarray(tab, F32)
    if tab.size == 0:
        return False
    nxt = np.append(tab[1:], tab[-1:])
    with np.errstate(invalid="ignore"):
        return bool(np.all(tab <= nxt))


def threshold(tab, x):
    """Count of leading positions where x + tab[s] > 0 is false, by the
    kernel's fixed-step search (float32 predicate, never rearranged)."""
    n = tab.shape[0]
    step = 1
    while step * 2 <= n:
        step *= 2
    pos = 0
    with np.errstate(invalid="ignore"):
        while step > 0:
            idx = pos + step - 1
            if idx < n and not (F32(x) + tab[idx] > F32(0.0)):
                pos += step
            step >>= 1
    return pos


def threshold_scan(dz, lau, dtab, s_count, count1):
    """The kernel's arithmetic: (sides [n] with -7 where nothing is
    written, the route taken)."""
    n = dz.shape[0]
    out = np.full(n, -7, np.int32)
    s_count = min(int(s_count), n)
    c1 = int(count1)
    if s_count <= 0:
        return out, "empty"
    lo, hi = max(c1 - s_count, 0), min(c1 + s_count - 1, n + 1)
    tab = dtab[lo:hi + 1] if hi >= lo else dtab[:0]
    if not table_is_monotone(tab):
        with np.errstate(invalid="ignore"):
            for i in range(s_count):
                s1 = c1 - int(lau[i])
                side = int(F32(dz[i]) + dtab[s1] > F32(0.0))
                out[i] = side
                c1 = s1 + side
        return out, "serial"
    for base in range(0, s_count, CHUNK):
        # Producers: U = threshold + own launch side + the launch sides of
        # the chunk before it; neutral entries from s_count on.
        u = np.full(CHUNK, 0x3FFFFFFF + 1, np.int64)
        cnt = min(CHUNK, s_count - base)
        before = 0
        for j in range(cnt):
            la = int(lau[base + j])
            u[j] = lo + threshold(tab, dz[base + j]) + la + before
            before += la
        # The chain, in whole turns, on y = count1 + launch sides so far;
        # it keeps the y each cell met.
        seen = np.zeros(CHUNK, np.int64)
        y = c1
        for j in range(-(-cnt // TURN) * TURN):
            seen[j] = y
            # y >= U taken as the sign bit of (U - 1) - y in 32 bits
            y += int(np.int32(u[j] - 1 - y) < 0)
        c1 = y - before
        # Writers: the side again, from y and the entry.
        out[base:base + cnt] = seen[:cnt] >= u[:cnt]
    return out, "thresholds"


def _twin(dz, lau, dtab, s_count, count1):
    with np.errstate(invalid="ignore"):
        return rg_scan_ref(_t(dz), _t(lau), _t(dtab),
                           torch.tensor(s_count, dtype=torch.int32),
                           torch.tensor(count1, dtype=torch.int32)).numpy()


def _scan_inputs(seed, n, s_count, n_move=None):
    rng = np.random.default_rng(seed)
    dz = (rng.standard_normal(n) * 3.0).astype(F32)
    lau = rng.integers(0, 2, n).astype(np.int32)
    dtab = build_dtab(n, s_count + 2 if n_move is None else n_move)
    return dz, lau, dtab, int(lau[:s_count].sum())


def _assert_scan(dz, lau, dtab, s_count, count1, route):
    got, took = threshold_scan(dz, lau, dtab, s_count, count1)
    want = _twin(dz, lau, dtab, s_count, count1)
    k = min(s_count, dz.shape[0])
    assert took == route
    np.testing.assert_array_equal(got[:k], want[:k])
    assert (got[k:] == -7).all()  # nothing written from s_count on
    return got[:k]


@pytest.mark.parametrize("n", [64, 200, 512])
@pytest.mark.parametrize("s_count", [0, 1, 37, None])
def test_threshold_scan_equals_twin(n, s_count):
    s_count = n if s_count is None else s_count
    dz, lau, dtab, c1 = _scan_inputs(n + s_count, n, s_count)
    _assert_scan(dz, lau, dtab, s_count, c1,
                 "thresholds" if s_count else "empty")


def test_threshold_scan_spans_chunks():
    """More positions than one chunk, not a multiple of it or of a turn."""
    n = 2 * CHUNK + 45
    dz, lau, dtab, c1 = _scan_inputs(5, n, n)
    sides = _assert_scan(dz, lau, dtab, n, c1, "thresholds")
    assert 0 < sides.sum() < n


def _s1_path(dz, lau, dtab, s_count, c1):
    path = []
    for i in range(s_count):
        s1 = c1 - int(lau[i])
        path.append(s1)
        c1 = s1 + int(F32(dz[i]) + dtab[s1] > 0)
    return path


def test_threshold_scan_tie_is_side_zero():
    """dz == -dtab[s1] at the s1 the scan really meets: the sum is exactly
    0, and the strict > sends the cell to side 0."""
    n = 200
    dz, lau, dtab, c1 = _scan_inputs(11, n, n)
    hit = 0
    for i in (5, 60, 150):
        s1 = _s1_path(dz, lau, dtab, n, c1)[i]
        if np.isfinite(dtab[s1]):
            dz[i] = -dtab[s1]
            hit += 1
    assert hit >= 2
    sides = _assert_scan(dz, lau, dtab, n, c1, "thresholds")
    path = _s1_path(dz, lau, dtab, n, c1)
    ties = [i for i in (5, 60, 150) if dz[i] + dtab[path[i]] == 0]
    assert len(ties) >= 2 and all(sides[i] == 0 for i in ties)


@pytest.mark.parametrize("n_move", [None, 30])
def test_threshold_scan_non_finite_dz(n_move):
    """+inf, -inf and NaN margins make the predicate constant or a step in
    s, also where the table's +inf tail is reached (n_move 30: side 0 would
    empty from s1 = 28 on)."""
    n = 128
    dz, lau, dtab, c1 = _scan_inputs(3, n, n, n_move)
    dz[[4, 40, 90]] = np.inf
    dz[[9, 41, 100]] = -np.inf
    dz[[10, 42, 110]] = np.nan
    if n_move is not None:
        assert np.isinf(dtab[28:]).all()
    sides = _assert_scan(dz, lau, dtab, n, c1, "thresholds")
    assert sides[[9, 41, 100, 10, 42, 110]].sum() == 0


def test_threshold_scan_reaches_inf_tail():
    """A small n_move and a start in the middle: the count climbs into the
    table's +inf entries, where every finite margin goes to side 1."""
    n = 96
    dz, lau, dtab, _ = _scan_inputs(8, n, n, n_move=40)
    dz[:] = np.abs(dz) + F32(5.0)  # every cell wants side 1
    sides = _assert_scan(dz, lau, dtab, n, 30, "thresholds")
    path = _s1_path(dz, lau, dtab, n, 30)
    assert max(path) >= 38 and sides.sum() > n // 2


@pytest.mark.parametrize("count1", [0, 17, 64])
def test_threshold_scan_start_in_the_middle(count1):
    n, s_count = 128, 50
    dz, lau, dtab, _ = _scan_inputs(21, n, s_count, n_move=n)
    lau[:s_count] = 0 if count1 == 0 else lau[:s_count]
    _assert_scan(dz, lau, dtab, s_count, count1, "thresholds")


@pytest.mark.parametrize("fault", ["swap", "nan"])
def test_non_monotone_table_takes_the_serial_route(fault):
    n = 150
    dz, lau, dtab, c1 = _scan_inputs(13, n, n)
    dz[:] = dz * F32(0.1)  # margins small against the table's steps
    k = c1  # inside the reachable range
    if fault == "swap":
        dtab[[k, k + 3]] = dtab[[k + 3, k]]
    else:
        dtab[k] = np.nan
    _assert_scan(dz, lau, dtab, n, c1, "serial")


def test_serial_route_is_needed():
    """On a table that goes down and up again the thresholds give another
    answer than the recurrence: the check is what keeps the kernel right."""
    n = 64
    dz = np.full(n, 0.5, F32)
    lau = np.zeros(n, np.int32)
    dtab = np.full(n + 2, -1.0, F32)
    dtab[0] = 1.0  # true at s1 = 0, false after it
    want = _twin(dz, lau, dtab, n, 0)
    assert want[0] == 1 and want[1:].sum() == 0
    got, took = threshold_scan(dz, lau, dtab, n, 0)
    assert took == "serial"
    np.testing.assert_array_equal(got, want)
    assert threshold(dtab[:n], dz[0]) != 0  # a threshold would miss s1 = 0


@pytest.mark.parametrize("n,n_move", [(5, 5), (64, 64), (64, 20), (512, 300),
                                      (5000, 5000), (5000, 2),
                                      (131072, 131072), (131072, 6553)])
def test_split_merge_table_is_monotone(n, n_move):
    dtab = build_dtab(n, n_move)
    assert table_is_monotone(dtab)
    assert np.isinf(dtab[max(n_move - 2, 0):]).all()


@pytest.mark.parametrize("fault", ["swap", "nan", "nan_last", "empty"])
def test_monotone_check_finds_faults(fault):
    dtab = build_dtab(256, 200)
    if fault == "swap":
        dtab[[40, 41]] = dtab[[41, 40]]
    elif fault == "nan":
        dtab[77] = np.nan
    elif fault == "nan_last":
        dtab = dtab[:100].copy()
        dtab[-1] = np.nan
    else:
        dtab = dtab[:0]
    assert not table_is_monotone(dtab)


# ---------------------------------------------------------------------------
# (c): the row ring and its refresh at a birth
# ---------------------------------------------------------------------------


def ring_sweep(z, gum, lf, fresh, aux, assign, perm, sizes, params,
               log_denom, refresh=True):
    """eager_sweep_ref's interface with the rows read as csrc/sweep.cu
    reads them: copied from z into a ring K_RING - 1 positions ahead (a
    position past n copies cell 0's row), position i + 1's row taken out
    of the ring before position i's step, and after a birth's patch the
    rows of the next K_RING - 1 positions copied anew (the kernel's loop
    starts again there)."""
    z, sizes, params = z.clone(), sizes.clone(), params.clone()
    n, k_pad = z.shape
    perm_h, assign_h = perm.tolist(), assign.tolist()
    out = torch.empty_like(assign)

    def cell_at(pos):
        return perm_h[pos] if pos < n else 0

    ring = [None] * K_RING
    for r in range(K_RING - 1):
        ring[r] = z[cell_at(r)].clone()
    v = ring[0].clone()
    for i in range(n):
        r = i + K_RING - 1
        ring[r % K_RING] = z[cell_at(r)].clone()
        v_n = ring[(i + 1) % K_RING].clone()
        cell = perm_h[i]
        sizes[assign_h[cell]] -= 1.0
        cand, free, idx = pick_ref(v, sizes, aux[cell], log_denom)
        is_new = bool(cand) and free < k_pad
        t = free if is_new else idx
        if is_new:
            z[:, t] = lf[:, cell] + gum[:, t]
            params[t] = fresh[cell]
            if refresh:
                for d in range(1, K_RING):
                    ring[(i + d) % K_RING] = z[cell_at(i + d)].clone()
                v_n = ring[(i + 1) % K_RING].clone()
        sizes[t] += 1.0
        out[cell] = t
        v = v_n
    return out, sizes, params


def _sweep_case(births, free_slots, seed=0, n=48, k_pad=64, k_max=40, m=5):
    """A sweep with births forced at the visit positions `births` (aux
    +1e30) into `free_slots`, lowest first. Every newborn column of lf is
    large, so the cells visited after a birth follow it only if the row
    they read holds the patch."""
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((n, k_pad)) * 3.0).astype(F32)
    gum = rng.gumbel(size=(n, k_pad)).astype(F32)
    lf = (rng.standard_normal((n, n)) * 3.0).astype(F32)
    fresh = rng.uniform(0.01, 0.99, (n, m)).astype(F32)
    params = rng.uniform(0.01, 0.99, (k_max, m)).astype(F32)
    perm = rng.permutation(n).astype(np.int32)
    live = [s for s in range(k_max) if s not in free_slots]
    assign = rng.choice(live[:6], n).astype(np.int32)
    sizes = np.full(k_pad, 2.0, F32)  # phantom cells keep the others live
    sizes[live[:6]] = np.bincount(assign, minlength=k_pad)[live[:6]] + 2.0
    sizes[list(free_slots)] = 0.0
    sizes[k_max:] = -1.0
    aux = np.full(n, -1e30, F32)
    aux[perm[list(births)]] = 1e30
    lf[:, perm[list(births)]] = 30.0
    log_denom = torch.tensor(np.log(n - 1.0 + 3.0), dtype=torch.float32)
    return tuple(_t(x) for x in (z, gum, lf, fresh, aux, assign, perm, sizes,
                                 params)) + (log_denom,)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


RING_CASES = {
    "apart_1": ((20, 21), (30, 31, 32)),
    "apart_3": ((20, 23), (30, 31, 32)),
    "apart_ring": ((20, 20 + K_RING), (30, 31, 32)),
    "three_in_reach": ((10, 12, 16), (3, 30, 31)),
    "first_position": ((0, 5), (30, 31)),
    "last_position": ((40, 47), (30, 31)),
    # k_pad 64 is two slots a lane: slots 32-63 are the last lane row.
    "last_lane_row": ((20, 22), (35, 36, 37)),
}


@pytest.mark.parametrize("name", RING_CASES)
def test_ring_with_refresh_equals_twin(name):
    births, free = RING_CASES[name]
    args = _sweep_case(births, free, seed=len(name))
    want = eager_sweep_ref(*args)
    assert _same(ring_sweep(*args), want)
    # Every forced birth happened, lowest free slot first.
    perm, sizes0, out = args[6], args[7], want[0]
    born = [int(out[perm[p]]) for p in births]
    assert born == sorted(free)[:len(births)]
    assert int(((sizes0 == 0) & (want[1] > 0)).sum()) == len(births)


@pytest.mark.parametrize("name", ["apart_1", "apart_3", "first_position",
                                  "last_lane_row"])
def test_ring_without_refresh_differs(name):
    """The test above can fail: rows copied before a birth miss its patch."""
    births, free = RING_CASES[name]
    args = _sweep_case(births, free, seed=len(name))
    want = eager_sweep_ref(*args)
    assert not _same(ring_sweep(*args, refresh=False), want)


@pytest.mark.parametrize("seed", range(4))
def test_ring_equals_twin_random_births(seed):
    """Random hot cells (15%), few free slots: births close together, then
    vetoes once the free slots are used up."""
    rng = np.random.default_rng(100 + seed)
    n = 64
    births = np.flatnonzero(rng.random(n) < 0.15)
    args = _sweep_case(births, (4, 9, 33, 34, 38), seed=seed, n=n)
    want = eager_sweep_ref(*args)
    assert _same(ring_sweep(*args), want)
    assert int(((args[7] == 0) & (want[1] > 0)).sum()) >= 3
